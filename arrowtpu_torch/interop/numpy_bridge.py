"""Columns to and from numpy: how state crosses between this package and
the host (and, in the parity tests, the JAX package).

A column crosses as (values, valid_bools, length): `values` in the column's
numpy dtype (values under nulls included), `valid_bools` as one bool per row
or None for all valid.  Bitmap layouts never cross, so the JAX package's
sublane-major bitmaps and limb pairs and this package's LSB bitmaps and
native int64 meet only as plain arrays.  Decimals, intervals and fixed-size
binary cross as (n, W) uint32 words (a decimal's little-endian limbs), the
temporal types as their integers, uint64 as numpy uint64 (the port holds
its bits in int64), float16 as numpy float16.

`string_view_from_numpy` builds a string view column from a byte buffer
and each string's start and length, vectorized (a Python list per row is
far too slow at tens of millions of rows): the buffer is the arena as it
stands.  `resolve_views` turns views back into a byte matrix.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import schema as st
from ..core import batch as bt
from ..core import bitmap as bm
from ..config import resolve_device, round_up
from ..core import column as col


def column_from_numpy(values: np.ndarray, valid_bools: Optional[np.ndarray],
                      length: int = None, dtype: st.DataType = None,
                      device=None) -> col.Column:
    values = np.asarray(values)
    length = len(values) if length is None else int(length)
    if dtype is None:
        dtype = st.from_torch(torch.from_numpy(values[:0]).dtype)
    if isinstance(dtype, st.Null):
        return col.null_column(length, device)
    if isinstance(dtype, st.Boolean):
        return col.boolean(values.astype(bool), validity=valid_bools,
                           length=length, device=device)
    if st.words_per_row(dtype) is not None:
        values = np.ascontiguousarray(values).astype(np.uint32)
    return col.primitive(values, dtype, validity=valid_bools, length=length,
                         device=device)


def batch_from_numpy(arrays: Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]],
                     device=None) -> bt.RecordBatch:
    """{name: (values, valid_bools or None)} -> RecordBatch; each column's
    type follows its numpy dtype."""
    return bt.record_batch({
        name: column_from_numpy(v, ok, device=device)
        for name, (v, ok) in arrays.items()})


def column_to_numpy(c: col.Column) -> Tuple[np.ndarray, np.ndarray, int]:
    """-> (values[:length], valid bools[:length], length)."""
    n = c.length
    valid = c.valid_bool()[:n].cpu().numpy()
    if isinstance(c, col.NullColumn):
        return np.zeros(n, np.int8), valid, n
    if isinstance(c, col.BooleanColumn):
        return bm.to_numpy_bools(c.values, n), valid, n
    vals = c.values[:n].cpu().numpy()
    if vals.ndim == 2:
        vals = vals.view(np.uint32)
    elif st.is_u64(c.dtype):
        vals = vals.view(np.uint64)
    return vals, valid, n


def string_view_from_numpy(data: np.ndarray, starts: np.ndarray,
                           lengths: np.ndarray, valid: np.ndarray = None,
                           dtype: st.DataType = st.utf8,
                           device=None) -> col.StringViewColumn:
    """A string view column whose row i is data[starts[i] : starts[i] +
    lengths[i]] (`valid` False: a null, its view zero).  The views follow
    the Arrow layout the JAX package uses (length; first 4 bytes; a string
    of at most 12 bytes inline, else buffer 0 and its offset), and `data`
    itself is the arena, so a long string's offset is its start.  The
    inputs move to `device` first and the views are built there."""
    device = resolve_device(device)
    n = len(starts)
    cap = round_up(max(n, 1))
    arena = torch.zeros(round_up(max(len(data), 1)) + 64, dtype=torch.uint8,
                        device=device)
    arena[:len(data)] = torch.from_numpy(
        np.require(data, np.uint8, ["C", "W"])).to(device)
    st_ = torch.from_numpy(np.asarray(starts, dtype=np.int64)).to(device)
    ln = torch.from_numpy(np.asarray(lengths, dtype=np.int32)).to(device)
    if valid is not None:
        ok = torch.from_numpy(np.asarray(valid, dtype=bool)).to(device)
        ln = torch.where(ok, ln, 0)
    raw = torch.zeros((cap, 16), dtype=torch.uint8, device=device)
    views = raw.view(torch.int32)
    if n:  # an empty tensor has no byte view
        raw[:n, :4] = ln.view(torch.uint8).reshape(n, 4)
        long = ln > 12
        # untrusted starts (an IPC file's offsets) read the zero byte at
        # len(data) where they fall outside the data, as the JAX reader's
        # clamp does; validation then flags the view, never the gather
        end = len(data)
        src = torch.where(st_ < 0, end, st_)
        for j in range(12):
            keep = (ln > j) & (~long if j >= 4 else True)
            raw[:n, 4 + j] = torch.where(
                keep, arena[(src + j).clamp_(max=end)], 0)
        views[:n, 3] = torch.where(long, st_.to(torch.int32), views[:n, 3])
    validity = (None if valid is None or np.asarray(valid).all()
                else bm.from_numpy_bools(np.asarray(valid, bool), cap,
                                         device))
    return col.StringViewColumn(views, arena[:round_up(max(len(data), 1))],
                                validity, n, dtype,
                                int(ln.max()) if n else 0)


def decimal_from_int64(values: np.ndarray, dtype: st.DataType,
                       valid: np.ndarray = None, device=None
                       ) -> col.PrimitiveColumn:
    """A decimal column from int64 unscaled values (cents of a
    Decimal128(15, 2), say), its limbs sign-extended on `device`."""
    device = resolve_device(device)
    nl = st.decimal_limbs(dtype)
    v = torch.from_numpy(np.ascontiguousarray(values, dtype=np.int64)).to(
        device)
    words = v.view(torch.int32).reshape(-1, 2)
    if nl <= 2:
        limbs = words[:, :nl]
    else:
        ext = torch.where(v < 0, -1, 0).to(torch.int32)[:, None]
        limbs = torch.cat([words, ext.expand(-1, nl - 2)], dim=1)
    return col.primitive(limbs, dtype, validity=valid, device=device)


def resolve_views(views: np.ndarray, arena: np.ndarray, width: int):
    """(n, 4) views (int32 or uint32) and their arena -> ((n, width) uint8
    bytes, zero past each string's length; (n,) lengths), vectorized;
    `width` bounds the lengths."""
    v = np.ascontiguousarray(views).view(np.uint32)
    n = v.shape[0]
    lengths = v[:, 0].astype(np.int64)
    if (lengths > width).any():
        raise ValueError("a string is longer than the width")
    out = np.zeros((n, width), np.uint8)
    inline = v[:, 1:].copy().view(np.uint8).reshape(n, 12)
    long = lengths > 12
    offs = v[:, 3].astype(np.int64)
    padded = np.zeros(arena.shape[0] + width, np.uint8)
    padded[:arena.shape[0]] = arena
    for j in range(width):
        short = inline[:, j] if j < 12 else np.zeros(n, np.uint8)
        byte = np.where(long, padded[np.where(long, offs, 0) + j], short)
        out[:, j] = np.where(j < lengths, byte, 0)
    return out, lengths
