"""The distributed layer: process groups, the hash exchange, and the
distributed join and group-by."""

from . import distributed, mesh, shuffle
from .distributed import distributed_group_by, distributed_hash_join
from .mesh import Group, normalize_batch, process_group, run
from .shuffle import exchange, partition_ids

__all__ = ["distributed", "mesh", "shuffle", "distributed_group_by",
           "distributed_hash_join", "Group", "normalize_batch",
           "process_group", "run", "exchange", "partition_ids"]
