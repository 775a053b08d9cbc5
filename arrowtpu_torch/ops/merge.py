"""k-way sorted merge: the merge index of k sorted sources, and the rows.

Counterpart of `arrowtpu/ops/merge.py` (the reference's arrow-select
merge.rs: `merge_n`, `MergeIndex`).  As there, the merge index comes from
the engine's own stable sort, not a heap walk: the sources' key columns are
concatenated (their live rows, source after source), encoded once
(rowformat/encode.py, so a string key has one width and a dictionary one
set of ranks) and stably sorted, so equal keys keep their source order and
earlier sources win ties.  Each sorted position maps back to its (source,
row) pair through the sources' cumulative lengths.  The pairs are defined
over live rows only, so they equal the JAX package's, whose concatenation
keeps each source's padding in place.  `merge_n` materializes the rows by
`interleave` (ops/concat.py); `merge_batches` concatenates the batches
once and takes the whole batch by the sorted positions, one gather a
column, over the classes `interleave` takes (others raise, as there).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .. import schema as st
from ..config import SortOptions, round_up
from ..core import batch as bt
from ..core import column as col
from ..rowformat import encode as rf
from ..rowformat import pack as rp
from .concat import (check_interleaved, concat, concat_batches,
                     interleave)
from .take import take_record_batch


def _sorted_positions(keys: Sequence[col.Column], total: int,
                      options: Optional[Sequence[SortOptions]]
                      ) -> torch.Tensor:
    """(total,) int64: the concatenated key columns' live rows in sorted
    order, ties by position."""
    return rp.sort_permutation(rf.encode_columns(
        keys, None if options is None else list(options)),
        keys[0].capacity, total)[:total]


def _int_column(values: torch.Tensor, dtype) -> col.PrimitiveColumn:
    n = values.shape[0]
    out = torch.zeros(round_up(max(n, 1)), dtype=values.dtype,
                      device=values.device)
    out[:n] = values
    return col.PrimitiveColumn(out, None, n, dtype)


def merge_indices(columns_per_source: Sequence[Sequence[col.Column]],
                  options: Optional[Sequence[SortOptions]] = None
                  ) -> Tuple[col.PrimitiveColumn, col.PrimitiveColumn]:
    """-> (source, row) int32 columns ordering the rows of k sources, each
    already sorted on its key columns, stably (earlier sources win ties).
    Their length is the sources' total length, their capacity that
    rounded up to the granule."""
    if not columns_per_source:
        raise st.ComputeError("merge: no sources")
    lengths = [cs[0].length for cs in columns_per_source]
    keys = [concat([cs[j] for cs in columns_per_source])
            for j in range(len(columns_per_source[0]))]
    pos = _sorted_positions(keys, sum(lengths), options)
    del keys
    lens = torch.tensor(lengths, dtype=torch.int64, device=pos.device)
    ends = lens.cumsum(0)
    src = torch.searchsorted(ends, pos, right=True)
    row = pos - (ends - lens)[src]
    return (_int_column(src.to(torch.int32), st.int32),
            _int_column(row.to(torch.int32), st.int32))


def merge_n(sources: Sequence[col.Column], source_idx: col.PrimitiveColumn,
            row_idx: col.PrimitiveColumn) -> col.Column:
    """The merge index's rows of `sources` (merge.rs merge_n)."""
    return interleave(list(sources), source_idx, row_idx)


def merge_batches(batches: Sequence[bt.RecordBatch], by: Sequence[str],
                  options: Optional[Sequence[SortOptions]] = None
                  ) -> bt.RecordBatch:
    """k batches, each sorted on `by`, merged into one sorted batch (the
    run-merging step of an external sort): the rows of `merge_n` under
    `merge_indices`, earlier batches winning ties."""
    if not batches:
        raise st.ComputeError("merge: no sources")
    for c in batches[0].columns:
        check_interleaved(c)
    whole = concat_batches(batches)
    pos = _sorted_positions([whole[n] for n in by], whole.length, options)
    return take_record_batch(whole, _int_column(pos, st.int64))
