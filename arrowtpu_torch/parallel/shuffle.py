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
ranks move the same planes); bool values and validity move as bytes, a
multi-word primitive (decimal, interval, fixed-size binary) as (n, W)
rows.  A dictionary column moves its keys and keeps its dictionary, which
every rank holds.  A string view moves as its byte matrix (ops/strings.py)
at the width of the ranks' longest string, (n, L / 4) int32 rows and an
int32 length plane, as the JAX package moves it, and is rebuilt on the
receiving rank (`from_byte_matrix`) with `len_bound` the ranks' largest:
one all_reduce(MAX) for every string column of the batch, read back once.
A string key is hashed at that width (or at the one its caller gives, so
that two batches partition alike), so a string lands on the same rank
whatever rank holds it.  The output's length is the number of rows
received and its capacity that rounded up to the capacity granule.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .. import schema as st
from ..config import round_up
from ..core import batch as bt
from ..core import bitmap as bm
from ..core import column as col
from ..ops import strings as ps
from ..ops.take import gather_rows
from ..rowformat import encode as rf
from ..rowformat import hashing as hsh
from .mesh import Group, normalize_batch

_PARTITION_SEED = 0x5157  # the JAX package's partition hash seed


def partition_ids(batch: bt.RecordBatch, key_names: Sequence[str],
                  num_partitions: int,
                  widths: Optional[Sequence[Optional[int]]] = None
                  ) -> torch.Tensor:
    """(capacity,) int64 destination partition of each row; `widths`
    (parallel to `key_names`) sets string keys' byte-matrix widths, which
    every rank must share (`shared_bounds`)."""
    planes = rf.hash_planes_of([batch[k] for k in key_names], widths)
    return hsh.hash_planes(planes, seed=_PARTITION_SEED) % num_partitions


def shared_bounds(columns: Sequence[col.Column]) -> List[Optional[int]]:
    """Per column: for a string view, the longest string any rank of the
    default group holds (the largest `len_bound`, or the valid rows'
    longest where a rank has none), else None.  One all_reduce(MAX) and
    one read-back for all the string columns; none when there are none
    (every rank holds the same schema)."""
    views = [i for i, c in enumerate(columns)
             if isinstance(c, col.StringViewColumn)]
    out: List[Optional[int]] = [None] * len(columns)
    if not views:
        return out
    local = torch.stack([ps.byte_bound(columns[i]) for i in views])
    dist.all_reduce(local, op=dist.ReduceOp.MAX)
    for i, b in zip(views, local.tolist()):  # read-back
        out[i] = b
    return out


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
                        group: Group,
                        widths: Optional[Sequence[Optional[int]]] = None
                        ) -> ExchangePlan:
    ndev = group.world_size
    live = bm.row_mask_bool(batch.capacity, batch.length, batch.device)
    dest = torch.where(live, partition_ids(batch, key_names, ndev, widths),
                       ndev)
    order = torch.sort(dest, stable=True).indices[:batch.length]
    counts = torch.bincount(dest, minlength=ndev + 1)[:ndev]
    recv = torch.empty_like(counts)
    dist.all_to_all_single(recv, counts)
    sizes = torch.cat([counts, recv]).tolist()  # read-back
    return ExchangePlan(order, sizes[:ndev], sizes[ndev:])


def _move_plane(values: torch.Tensor, plan: ExchangePlan) -> torch.Tensor:
    """Exchange one (capacity, ...) plane -> (out_capacity, ...), zero past
    the rows received."""
    out = torch.zeros((plan.out_capacity,) + values.shape[1:],
                      dtype=values.dtype, device=values.device)
    dist.all_to_all_single(out[:plan.total], gather_rows(values, plan.order),
                           output_split_sizes=plan.recv,
                           input_split_sizes=plan.send)
    return out


def _move_bool(values: torch.Tensor, plan: ExchangePlan) -> torch.Tensor:
    return _move_plane(values.to(torch.uint8), plan) != 0


def _move_strings(c: col.StringViewColumn, plan: ExchangePlan, bound: int,
                  validity: torch.Tensor) -> col.StringViewColumn:
    """A string view through its byte matrix, `bound` the ranks' longest
    string: (n, L / 4) int32 rows and the lengths, rebuilt on arrival."""
    L = ps.matrix_width(bound)
    mat, lens = ps.byte_matrix(c, L)
    words = _move_plane(mat.view(torch.int32), plan)
    out = ps.from_byte_matrix(words.view(torch.uint8),
                              _move_plane(lens, plan), validity, plan.total,
                              c.dtype)
    return dataclasses.replace(out, len_bound=bound)


def exchange_column(c: col.Column, plan: ExchangePlan,
                    bound: Optional[int] = None) -> col.Column:
    """One column through the exchange; a string view needs `bound`, the
    ranks' longest string (`shared_bounds`)."""
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
    if isinstance(c, col.StringViewColumn):
        return _move_strings(c, plan, bound, ok)
    raise st.ComputeError(f"exchange: unsupported column {type(c).__name__}")


def exchange(batch: bt.RecordBatch, key_names: Sequence[str],
             group: Group,
             widths: Optional[Sequence[Optional[int]]] = None
             ) -> bt.RecordBatch:
    """Shuffle rows so that rows with equal keys land on the same rank.
    Every rank of the group calls it, with batches of one schema.  A
    string key hashes at `widths` (parallel to `key_names`; callers that
    partition two batches alike give one) or else at its own column's
    width over the ranks."""
    batch = normalize_batch(batch)
    bounds = shared_bounds(batch.columns)
    if widths is None:
        names = batch.schema.names
        widths = [None if bounds[names.index(k)] is None
                  else ps.matrix_width(bounds[names.index(k)])
                  for k in key_names]
    plan = build_exchange_plan(batch, key_names, group, widths)
    return bt.RecordBatch(batch.schema, tuple(
        exchange_column(c, plan, b) for c, b in zip(batch.columns, bounds)))
