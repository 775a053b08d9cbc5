"""Hash-partition exchange: the distributed shuffle operator.

Counterpart of `arrowtpu/parallel/shuffle.py`, ragged strategy
(`shuffle.py:110-129`).  A row goes to rank `hash % world_size`, with the
JAX package's key hash (rowformat/hashing.py), so a row lands on the same
rank in both packages.

  * plan: rows are stably sorted by destination once (dead rows last), the
    per-destination counts are exchanged with one `all_to_all_single`,
    and both split lists are read back once (the exchange's one
    read-back);
  * every plane then moves with one `all_to_all_single` of exactly the
    live rows, split by those counts.  Received rows are ordered by source
    rank, then by the sender's stable destination sort: the order of the
    JAX package's capped-bucket path, which its CPU tests run.

Every column moves its validity (the batch is normalized first, so all
ranks move the same planes); bool values and validity move as bytes.  A
dictionary column moves its keys and keeps its dictionary, which every
rank holds.  String views wait for the byte matrix of `ops/strings`.  The
output's length is the number of rows received and its capacity that
rounded up to the capacity granule.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch
import torch.distributed as dist

from .. import schema as st
from ..config import round_up
from ..core import batch as bt
from ..core import bitmap as bm
from ..core import column as col
from ..rowformat import encode as rf
from ..rowformat import hashing as hsh
from .mesh import Group, normalize_batch

_PARTITION_SEED = 0x5157  # the JAX package's partition hash seed


def partition_ids(batch: bt.RecordBatch, key_names: Sequence[str],
                  num_partitions: int) -> torch.Tensor:
    """(capacity,) int64 destination partition of each row."""
    planes = rf.hash_planes_of([batch[k] for k in key_names])
    return hsh.hash_planes(planes, seed=_PARTITION_SEED) % num_partitions


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """Destination sort and split sizes, computed once per batch and shared
    by every column."""

    order: torch.Tensor     # (live rows,) row ids sorted by destination
    send: List[int]         # rows to each rank
    recv: List[int]         # rows from each rank

    @property
    def total(self) -> int:
        return sum(self.recv)

    @property
    def out_capacity(self) -> int:
        return round_up(max(self.total, 1))


def build_exchange_plan(batch: bt.RecordBatch, key_names: Sequence[str],
                        group: Group) -> ExchangePlan:
    ndev = group.world_size
    live = bm.row_mask_bool(batch.capacity, batch.length, batch.device)
    dest = torch.where(live, partition_ids(batch, key_names, ndev), ndev)
    order = torch.sort(dest, stable=True).indices[:batch.length]
    counts = torch.bincount(dest, minlength=ndev + 1)[:ndev]
    recv = torch.empty_like(counts)
    dist.all_to_all_single(recv, counts)
    sizes = torch.cat([counts, recv]).tolist()  # read-back
    return ExchangePlan(order, sizes[:ndev], sizes[ndev:])


def _move_plane(values: torch.Tensor, plan: ExchangePlan) -> torch.Tensor:
    """Exchange one (capacity,) plane -> (out_capacity,), zero past the
    rows received."""
    out = torch.zeros(plan.out_capacity, dtype=values.dtype,
                      device=values.device)
    dist.all_to_all_single(out[:plan.total], values[plan.order],
                           output_split_sizes=plan.recv,
                           input_split_sizes=plan.send)
    return out


def _move_bool(values: torch.Tensor, plan: ExchangePlan) -> torch.Tensor:
    return _move_plane(values.to(torch.uint8), plan) != 0


def exchange_column(c: col.Column, plan: ExchangePlan) -> col.Column:
    total = plan.total
    if isinstance(c, col.NullColumn):
        return col.NullColumn(total, plan.out_capacity, c.device)
    if isinstance(c, col.DictionaryColumn):
        # every rank holds the dictionary; only the keys move
        return dataclasses.replace(c, keys=exchange_column(c.keys, plan))
    ok = bm.pack(_move_bool(bm.unpack(c.validity), plan))
    if isinstance(c, col.BooleanColumn):
        return col.BooleanColumn(bm.pack(_move_bool(c.values_bool(), plan)),
                                 ok, total)
    if isinstance(c, col.PrimitiveColumn):
        return col.PrimitiveColumn(_move_plane(c.values, plan), ok, total,
                                   c.dtype)
    raise st.ComputeError(f"exchange: unsupported column {type(c).__name__}")


def exchange(batch: bt.RecordBatch, key_names: Sequence[str],
             group: Group) -> bt.RecordBatch:
    """Shuffle rows so that rows with equal keys land on the same rank.
    Every rank of the group calls it, with batches of one schema."""
    batch = normalize_batch(batch)
    plan = build_exchange_plan(batch, key_names, group)
    return bt.RecordBatch(batch.schema, tuple(exchange_column(c, plan)
                                              for c in batch.columns))
