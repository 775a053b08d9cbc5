"""Take: gather rows by an index column.

Counterpart of `arrowtpu/ops/take.py` over every column class but run-end
and union (which raise, as in the JAX package).  A null or out-of-bounds
index (outside [0, length) of the source) gives a null output row.  As in
the JAX package, every output row below the length takes the value at its
index clipped into the source's capacity, so the values under a null row
are the same in both packages; rows past the length are zero (the port's
padding contract).  The output has the index column's length and
capacity, and always a validity bitmap (a dictionary's on its keys).

Per class: a dictionary takes its keys and shares its values; a string
view gathers its 16-byte views and shares its arena; a list view gathers
its (start, size) pairs and shares its child; a struct takes each child
(a child row is valid where the child's row and the index are); a
fixed-size list takes its child at index * size + j.

With `TakeOptions(check_bounds=True)` the result comes with a Python bool
that is true when a valid index falls outside [0, length) (one read-back);
the JAX package returns the same flag as a traced scalar.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import schema as st
from ..config import TakeOptions
from ..core import batch as bt
from ..core import bitmap as bm
from ..core import column as col


def take(c: col.Column, indices: col.PrimitiveColumn,
         options: TakeOptions = TakeOptions()):
    """`c`'s rows at `indices`; with options.check_bounds, (column, the
    out-of-bounds flag)."""
    raw, valid_idx, in_bounds = _index_rows(indices, c.length)
    # as the JAX package: the index's low 32 bits read as int32, clipped
    # (the even int32 words of little-endian int64s)
    idx = raw.contiguous().view(torch.int32)[0::2].clamp(
        0, max(c.capacity - 1, 0)).to(torch.int64)
    out = _take_values(c, idx, valid_idx & in_bounds, indices.length)
    if options.check_bounds:
        return out, _out_of_bounds(valid_idx, in_bounds)
    return out


def _index_rows(indices: col.PrimitiveColumn, length: int):
    """-> (the indices as int64, the index row is live and valid, the
    index is in [0, length)), each over the index column's capacity."""
    if not (isinstance(indices, col.PrimitiveColumn)
            and isinstance(indices.dtype, st.Int)
            and indices.values.dim() == 1):
        raise st.ComputeError("take: indices must be an integer column")
    live = bm.row_mask_bool(indices.capacity, indices.length, indices.device)
    raw = indices.values.to(torch.int64)
    valid_idx = live if indices.validity is None \
        else live & bm.unpack(indices.validity)
    return raw, valid_idx, (raw >= 0) & (raw < length)


def _out_of_bounds(valid_idx: torch.Tensor, in_bounds: torch.Tensor) -> bool:
    """A valid index outside [0, length) (one read-back)."""
    return bool((valid_idx & ~in_bounds).any())


_ROW_ELEMENT = {8: torch.int64, 16: torch.complex128}


def gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[idx] along dim 0.  A contiguous 2-D tensor whose row is 8 or 16
    bytes (a Decimal64 or Decimal128, a string view) is gathered as one
    int64 or complex128 element a row: PyTorch indexes (n, 4) int32 rows
    far slower than 16-byte elements (TPC-H Q1's five 59M-row limb
    gathers on an H100: `chip_smoke.py` phase 15 times both).  The copy
    moves the bits unchanged."""
    if t.dim() != 2 or not t.is_contiguous():
        return t[idx]
    element = _ROW_ELEMENT.get(t.shape[1] * t.element_size())
    if element is None:
        return t[idx]
    return t.view(element).reshape(-1)[idx].view(t.dtype).reshape(
        -1, t.shape[1])


def _zero_tail(t: torch.Tensor, n: int) -> torch.Tensor:
    if n < t.shape[0]:
        t[n:] = 0
    return t


def _take_values(c: col.Column, idx: torch.Tensor, ok: torch.Tensor,
                 n: int) -> col.Column:
    """Gather `c` at the clipped indices `idx` ((capacity,) int64); `ok`:
    the output row's index is valid and in bounds; `n`: the output
    length."""
    if isinstance(c, col.NullColumn):
        return col.NullColumn(n, idx.shape[0], c.device)
    if isinstance(c, col.DictionaryColumn):  # the keys; values are shared
        return dataclasses.replace(c, keys=_take_values(c.keys, idx, ok, n))
    if isinstance(c, (col.RunEndColumn, col.UnionColumn)):
        raise st.ComputeError(f"take: unsupported column {type(c).__name__}")
    # an in-bounds index of a column without a bitmap selects a valid row
    validity = bm.pack(ok if c.validity is None
                       else bm.unpack(c.validity)[idx] & ok)
    if isinstance(c, col.BooleanColumn):
        live = bm.row_mask_bool(idx.shape[0], n, idx.device)
        return col.BooleanColumn(bm.pack(c.values_bool()[idx] & live),
                                 validity, n)
    if isinstance(c, col.StringViewColumn):
        return col.StringViewColumn(_zero_tail(gather_rows(c.views, idx), n),
                                    c.arena,
                                    validity, n, c.dtype, c.len_bound)
    if isinstance(c, col.PrimitiveColumn):
        return col.PrimitiveColumn(_zero_tail(gather_rows(c.values, idx), n),
                                   validity, n, c.dtype)
    if isinstance(c, col.ListViewColumn):
        return col.ListViewColumn(_zero_tail(c.starts[idx], n),
                                  _zero_tail(c.sizes[idx], n), c.child,
                                  validity, n, c.dtype)
    if isinstance(c, col.StructColumn):
        return col.StructColumn(
            tuple(_take_values(ch, idx, ok, n) for ch in c.children),
            validity, n, c.dtype)
    if isinstance(c, col.FixedSizeListColumn):
        size = c.dtype.size
        child_idx = (idx[:, None] * size + torch.arange(
            size, dtype=idx.dtype, device=idx.device)).reshape(-1)
        child = _take_values(c.child, child_idx, ok.repeat_interleave(size),
                             n * size)
        return col.FixedSizeListColumn(child, validity, n, c.dtype)
    raise st.ComputeError(f"take: unsupported column {type(c).__name__}")


def take_record_batch(batch: bt.RecordBatch, indices: col.PrimitiveColumn,
                      options: TakeOptions = TakeOptions()):
    """Every column at `indices`; with options.check_bounds, (batch, the
    out-of-bounds flag)."""
    out = bt.RecordBatch(batch.schema, tuple(
        take(c, indices) for c in batch.columns))
    if options.check_bounds:
        return out, _out_of_bounds(*_index_rows(indices, batch.length)[1:])
    return out
