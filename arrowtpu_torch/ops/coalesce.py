"""Slice and the streaming batch coalescer.

Counterpart of `arrowtpu/ops/coalesce.py`:

  * `slice_(c, offset, length)`: rows [offset, offset + length) of `c`
    (the length cut to the rows that exist), moved to the front of a column
    whose capacity is that length rounded up to the granule (the JAX
    package keeps the input's capacity).  Validity stays None where the
    input has none; a string view shares its arena, a dictionary its
    values.  It takes the classes the JAX package's slice and `_shrink_col`
    take: primitive, boolean, null, string view and dictionary columns;
    others raise ComputeError;
  * `BatchCoalescer` (the reference's coalesce.rs): pushed batches
    (`push_batch`, or `push_batch_with_filter` through
    `filter_record_batch`) are concatenated and cut into batches of
    `target_batch_size` rows (`next_completed_batch`); `finish` returns
    the remainder.  The host drives the loop; each push is device work.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from .. import schema as st
from ..config import round_up
from ..core import batch as bt
from ..core import bitmap as bm
from ..core import column as col
from . import concat as concat_mod
from . import filter as filter_mod


def _rows(t: torch.Tensor, offset: int, n: int, cap: int) -> torch.Tensor:
    out = torch.zeros((cap,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    out[:n] = t[offset:offset + n]
    return out


def slice_(c: col.Column, offset: int, length: int) -> col.Column:
    """Rows [offset, offset + length) of `c` (module docstring)."""
    offset = max(int(offset), 0)
    n = max(min(int(length), c.length - offset), 0)
    cap = round_up(max(n, 1))
    if isinstance(c, col.NullColumn):
        return col.NullColumn(n, cap, c.device)
    if isinstance(c, col.DictionaryColumn):
        return dataclasses.replace(c, keys=slice_(c.keys, offset, n))
    validity = None
    if c.validity is not None:
        validity = bm.pack(_rows(c.valid_bool(), offset, n, cap))
    if isinstance(c, col.BooleanColumn):
        return col.BooleanColumn(
            bm.pack(_rows(c.values_bool(), offset, n, cap)), validity, n)
    if isinstance(c, col.StringViewColumn):
        return col.StringViewColumn(_rows(c.views, offset, n, cap), c.arena,
                                    validity, n, c.dtype, c.len_bound)
    if isinstance(c, col.PrimitiveColumn):
        return col.PrimitiveColumn(_rows(c.values, offset, n, cap), validity,
                                   n, c.dtype)
    raise st.ComputeError(f"slice: unsupported column {type(c).__name__}")


def slice_batch(batch: bt.RecordBatch, offset: int,
                length: int) -> bt.RecordBatch:
    return bt.RecordBatch(batch.schema, tuple(
        slice_(c, offset, length) for c in batch.columns))


class BatchCoalescer:
    """Re-batches pushed batches into batches of `target_batch_size` rows
    (the reference's coalesce.rs BatchCoalescer)."""

    def __init__(self, schema: st.Schema, target_batch_size: int = 8192):
        self.schema = schema
        self.target = int(target_batch_size)
        self._buffer: Optional[bt.RecordBatch] = None
        self._ready: List[bt.RecordBatch] = []

    def push_batch(self, batch: bt.RecordBatch) -> None:
        if batch.schema.names != self.schema.names:
            raise st.SchemaError("coalesce: schema mismatch")
        self._buffer = (batch if self._buffer is None else
                        concat_mod.concat_batches([self._buffer, batch]))
        while self._buffer is not None and self._buffer.length >= self.target:
            self._ready.append(slice_batch(self._buffer, 0, self.target))
            rest = self._buffer.length - self.target
            self._buffer = (slice_batch(self._buffer, self.target, rest)
                            if rest else None)

    def push_batch_with_filter(self, batch: bt.RecordBatch,
                               mask: col.BooleanColumn) -> None:
        """The rows of `batch` under `mask` (filter_record_batch), pushed."""
        self.push_batch(filter_mod.filter_record_batch(batch, mask))

    def next_completed_batch(self) -> Optional[bt.RecordBatch]:
        return self._ready.pop(0) if self._ready else None

    def finish(self) -> Optional[bt.RecordBatch]:
        """The rows still buffered, as one batch of a tight capacity, or
        None."""
        out, self._buffer = self._buffer, None
        if out is None or out.capacity == round_up(max(out.length, 1)):
            return out
        return slice_batch(out, 0, out.length)
