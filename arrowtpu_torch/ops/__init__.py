"""Compute operators on columns and record batches."""

from .boolean import and_kleene
from .cmp import eq, gt
from .concat import concat, concat_batches
from .filter import apply_plan, build_plan, filter_, filter_record_batch
from .groupby import group_by
from .join import hash_join
from .numeric import rem
from . import sort as sortmod
from .sort import (lexsort_to_indices, partition, partition_ranges, rank,
                   sort, sort_batch, sort_to_indices)
from .take import take, take_record_batch

__all__ = ["and_kleene", "eq", "gt", "concat", "concat_batches",
           "apply_plan", "build_plan", "filter_", "filter_record_batch",
           "group_by", "hash_join", "rem", "take", "take_record_batch",
           "lexsort_to_indices", "partition", "partition_ranges", "rank",
           "sort", "sort_batch", "sort_to_indices", "sortmod"]
