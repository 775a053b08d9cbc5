"""Sort, lexsort, rank, partition.

Counterpart of `arrowtpu/ops/sort.py`, with its results: each key column
encodes to order-preserving int64 planes (rowformat/encode.py) and the rows
are stably sorted by them (rowformat/pack.py), live rows first, so the
first `length` entries of an index column are the sorted permutation of
the live rows, ties in row order.  Index columns are int32, and rows past
their length are 0 (the port's padding contract).  String-view sort keys
and the grouped string sort are not ported yet; they raise ComputeError.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .. import schema as st
from ..config import SortOptions, round_up
from ..core import batch as bt
from ..core import bitmap as bm
from ..core import column as col
from ..rowformat import encode as rf
from ..rowformat import pack as rp
from .take import take, take_record_batch


def _index_column(perm: torch.Tensor, length: int, capacity: int,
                  limit: Optional[int]) -> col.PrimitiveColumn:
    """The int32 index column of a sort: `limit` (if given) cuts its length
    and its capacity (to the limit rounded up to the granule)."""
    idx = perm.to(torch.int32)
    out_len = length if limit is None else min(int(limit), length)
    if limit is not None:
        idx = idx[:round_up(min(int(limit), capacity))]
    idx[out_len:] = 0
    return col.PrimitiveColumn(idx, None, out_len, st.int32)


def _sorted_perm(columns, options, capacity: int, length: int
                 ) -> torch.Tensor:
    """The sort permutation of the key columns: one packed sort, or the
    grouped sort when a long string key splits the planes into groups
    (rowformat/encode.py encode_columns_grouped)."""
    groups = rf.encode_columns_grouped(list(columns), options)
    if len(groups) == 1:
        return rp.sort_permutation(groups[0], capacity, length)
    return rp.sort_by_plane_groups(groups, capacity, length)


def sort_to_indices(c: col.Column, options: SortOptions = SortOptions(),
                    limit: Optional[int] = None) -> col.PrimitiveColumn:
    """The int32 index column whose first `length` (or `limit`) entries
    sort `c` per `options`."""
    perm = _sorted_perm([c], [options], c.capacity, c.length)
    return _index_column(perm, c.length, c.capacity, limit)


def sort(c: col.Column, options: SortOptions = SortOptions(),
         limit: Optional[int] = None) -> col.Column:
    return take(c, sort_to_indices(c, options, limit))


def lexsort_to_indices(columns: Sequence[col.Column],
                       options: Optional[Sequence[SortOptions]] = None,
                       limit: Optional[int] = None) -> col.PrimitiveColumn:
    """Multi-column lexicographic sort; column 0 is most significant."""
    if not columns:
        raise st.ComputeError("lexsort: no sort columns")
    caps = {c.capacity for c in columns}
    if len(caps) != 1:
        raise st.ComputeError(f"lexsort: capacity mismatch {caps}")
    first = columns[0]
    perm = _sorted_perm(columns, None if options is None else list(options),
                        first.capacity, first.length)
    return _index_column(perm, first.length, first.capacity, limit)


def sort_batch(batch: bt.RecordBatch, by: Sequence[str],
               options: Optional[Sequence[SortOptions]] = None,
               limit: Optional[int] = None) -> bt.RecordBatch:
    return take_record_batch(
        batch, lexsort_to_indices([batch[n] for n in by], options, limit))


def _differs_from_next(planes: List[torch.Tensor]) -> torch.Tensor:
    """(capacity,) bool: the row differs from the next on some plane (the
    last row always does)."""
    out = torch.zeros(planes[0].shape[0], dtype=torch.bool,
                      device=planes[0].device)
    out[-1] = True
    for p in planes:
        out[:-1] |= p[:-1] != p[1:]
    return out


def rank(c: col.Column, options: SortOptions = SortOptions()
         ) -> col.PrimitiveColumn:
    """1-based 'max' rank: ties share the rank of their last member (the
    ranks of [1, 2, 2, 3] are [1, 3, 3, 4]).  Int32, with c's validity."""
    cap, n = c.capacity, c.length
    planes = rf.encode_column(c, options)
    perm = rp.sort_permutation(planes, cap, n)
    pos = torch.arange(cap, device=c.device)
    # a group of equal rows ends where the next sorted row differs, and
    # at the last live row
    ends = _differs_from_next([p[perm] for p in planes]) | (pos == n - 1)
    end = torch.where(ends, pos + 1, torch.iinfo(torch.int32).max)
    # each sorted position takes the nearest group end at or after it
    group_end = torch.flip(torch.cummin(torch.flip(end, [0]), 0).values, [0])
    ranks = torch.zeros(cap, dtype=torch.int32, device=c.device)
    ranks[perm] = group_end.to(torch.int32)
    ranks[n:] = 0
    return col.PrimitiveColumn(ranks, c.validity, n, st.int32)


def partition(columns: Sequence[col.Column],
              options: Optional[Sequence[SortOptions]] = None
              ) -> col.BooleanColumn:
    """Given columns already sorted, mark the rows that start a new group
    of equal keys (row 0 always does)."""
    first = columns[0]
    planes = rf.encode_columns(list(columns),
                               None if options is None else list(options))
    starts = torch.zeros(first.capacity, dtype=torch.bool,
                         device=first.device)
    starts[0] = True
    for p in planes:
        starts[1:] |= p[1:] != p[:-1]
    starts &= bm.row_mask_bool(first.capacity, first.length, first.device)
    return col.BooleanColumn(bm.pack(starts), None, first.length)


def partition_ranges(boundaries: col.BooleanColumn) -> List[Tuple[int, int]]:
    """The [start, end) row ranges of partition's groups, on the host."""
    n = boundaries.length
    starts = torch.nonzero(boundaries.values_bool()[:n]).flatten().tolist()
    return list(zip(starts, starts[1:] + [n]))
