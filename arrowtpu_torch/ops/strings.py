"""String kernels: the byte matrix and the lengths.

Counterpart of the part of `arrowtpu/ops/strings.py` that string sort and
group keys need: `max_byte_length`, `byte_matrix`, `from_byte_matrix` and
`octet_length` / `bit_length` / `length`, with its results.

The byte matrix is a (capacity, L) uint8 expansion of a view column, L the
longest string rounded up to a 16-byte granule, each row the string's
bytes and zeros past its length.  A string of at most 12 bytes is read from
its view's last 12 bytes; a longer one is gathered from the arena at its
offset, a block of columns at a time.  The TPU's fetch of two u32 words
around each unaligned chunk (XLA gathers bytes through a one-hot matmul
there) has no counterpart: torch gathers bytes directly.  A column whose
`len_bound` is at most 12 holds no arena string and skips the gather.

LIKE, regular expressions, substring, case mapping and `concat_elements`
are not ported yet.
"""

from __future__ import annotations

import torch

from .. import schema as st
from ..core import column as col

_GRANULE = 16
_GATHER_BLOCK = 16  # byte columns gathered from the arena at a time


def max_byte_length(c: col.StringViewColumn) -> int:
    """The longest string's byte length rounded up to the granule (at
    least one granule): `len_bound` when the column has one, else one
    read-back of the valid rows' lengths."""
    if c.len_bound is not None:
        m = c.len_bound
    else:
        m = int(torch.where(c.valid_bool(), c.views[:, 0], 0).max()) \
            if c.capacity else 0
    return max(_GRANULE, -(-m // _GRANULE) * _GRANULE)


def byte_matrix(c: col.StringViewColumn, L: int):
    """-> ((capacity, L) uint8 bytes, zero past each string's length;
    (capacity,) int32 lengths)."""
    views = c.views
    cap = views.shape[0]
    lens = views[:, 0]
    mat = torch.zeros((cap, L), dtype=torch.uint8, device=views.device)
    head = views[:, 1:].contiguous().view(torch.uint8)  # (cap, 12)
    k = min(L, 12)
    mat[:, :k] = head[:, :k]
    arena = c.arena
    if (c.len_bound is None or c.len_bound > 12) and arena.numel():
        long = (lens > 12)[:, None]
        offs = (views[:, 3].to(torch.int64) & 0xFFFFFFFF)[:, None]
        last = arena.shape[0] - 1
        for j in range(0, L, _GATHER_BLOCK):
            cols = torch.arange(j, min(j + _GATHER_BLOCK, L),
                                device=views.device)
            got = arena[(offs + cols).clamp_(max=last)]
            mat[:, j:j + cols.shape[0]] = torch.where(
                long, got, mat[:, j:j + cols.shape[0]])
    live = torch.arange(L, device=views.device)[None, :] < lens[:, None]
    return mat * live, lens


def from_byte_matrix(mat: torch.Tensor, lens: torch.Tensor, validity,
                     length: int, dtype: st.DataType
                     ) -> col.StringViewColumn:
    """A view column from a (capacity, L) byte matrix: the arena is the
    flattened matrix (row i's bytes at offset i * L), so a long string's
    view points at its own row; the bytes between strings are dead."""
    cap, L = mat.shape
    lens = lens.to(torch.int32)
    live = torch.arange(L, device=mat.device)[None, :] < lens[:, None]
    mat = mat * live
    long = lens > 12
    offsets = torch.arange(cap, dtype=torch.int64, device=mat.device) * L
    first12 = torch.zeros((cap, 12), dtype=torch.uint8, device=mat.device)
    first12[:, :min(12, L)] = mat[:, :min(12, L)]
    w = first12.view(torch.int32)  # (cap, 3) little-endian words
    views = torch.stack([
        lens, w[:, 0], torch.where(long, 0, w[:, 1]),
        torch.where(long, offsets.to(torch.int32), w[:, 2])], dim=1)
    return col.StringViewColumn(views, mat.reshape(-1), validity, length,
                                dtype, L)


def _as_view(c) -> col.StringViewColumn:
    if isinstance(c, col.StringViewColumn):
        return c
    raise st.ComputeError(
        f"string kernel needs a string column, got {type(c).__name__}")


def _dict_gather(c: col.DictionaryColumn, per_value: col.PrimitiveColumn
                 ) -> col.PrimitiveColumn:
    """A per-dictionary-value result gathered by key, with the keys'
    validity; rows past the length are zero."""
    vals = per_value.values
    keys = c.keys.values.to(torch.int64).clamp(0, vals.shape[0] - 1)
    out = vals[keys]
    out[c.length:] = 0
    return col.PrimitiveColumn(out, c.validity, c.length, per_value.dtype)


def octet_length(c) -> col.PrimitiveColumn:
    """Byte length per row (int32)."""
    c = _as_view(c)
    return col.PrimitiveColumn(c.views[:, 0].clone(), c.validity, c.length,
                               st.int32)


def bit_length(c) -> col.PrimitiveColumn:
    c = _as_view(c)
    return col.PrimitiveColumn(c.views[:, 0] * 8, c.validity, c.length,
                               st.int32)


def length(c) -> col.PrimitiveColumn:
    """Characters per row for utf8 (the bytes that are not UTF-8
    continuation bytes), bytes for binary; a dictionary's by key."""
    if isinstance(c, col.DictionaryColumn):
        return _dict_gather(c, length(c.values))
    c = _as_view(c)
    if not isinstance(c.dtype, st.Utf8):
        return octet_length(c)
    L = max_byte_length(c)
    mat, lens = byte_matrix(c, L)
    live = torch.arange(L, device=mat.device)[None, :] < lens[:, None]
    chars = (((mat & 0xC0) != 0x80) & live).sum(dim=1, dtype=torch.int32)
    return col.PrimitiveColumn(chars, c.validity, c.length, st.int32)
