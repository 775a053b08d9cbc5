"""String kernels: the byte matrix, lengths, the LIKE family, regular
expressions, substring, concat_elements and case mapping.

Counterpart of `arrowtpu/ops/strings.py`.  The workhorse is the byte
matrix, a (capacity, L) uint8 expansion of a view column, L the longest
string rounded up to a 16-byte granule, each row the string's bytes and
zeros past its length.  A string of at most 12 bytes is read from its
view's last 12 bytes; a longer one is gathered from the arena at its
offset, a block of columns at a time.  The TPU's fetch of two u32 words
around each unaligned chunk (XLA gathers bytes through a one-hot matmul
there) has no counterpart: torch gathers bytes directly.  A column whose
`len_bound` is at most 12 holds no arena string and skips the gather.
`matrix_width` and `byte_bound` let callers agree on one width across
columns and ranks.

LIKE patterns compile as the JAX package compiles them (`compile_like`:
eq, starts, ends, contains, else an anchored regex), and the first four
run as dense compares on the matrix: `starts` and `eq` on its first
columns only, `contains` and `ends` on the windows of every start
position, built from static column shifts (`_window_hits`).  `ilike`
lowers ASCII letters on the matrix and in the pattern.  A dictionary
column evaluates the predicate once per dictionary value, then gathers
the result by key.  `substring`, `concat_elements`, `lower` and `upper`
build their output with `from_byte_matrix`, so its `len_bound` is the
matrix width, as in the JAX package.

Two paths run on the host, as the JAX package runs them: the regex kind
of a LIKE pattern and `regexp_is_match` (Python's `re`), and case
mapping of a column that holds a non-ASCII byte.  Their result goes back
to the column's device.  A null row's regex result is false (negated:
true), and `regexp_is_match` searches (unanchored) where LIKE's regex
matches the whole string.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from .. import schema as st
from ..core import bitmap as bm
from ..core import column as col

_GRANULE = 16
_GATHER_BLOCK = 16  # byte columns gathered from the arena at a time


def matrix_width(bound: int) -> int:
    """The byte-matrix width for strings of at most `bound` bytes: `bound`
    rounded up to the granule, at least one granule."""
    return max(_GRANULE, -(-bound // _GRANULE) * _GRANULE)


def byte_bound(c: col.StringViewColumn) -> torch.Tensor:
    """0-d int64 on the device: `len_bound` when the column has one, else
    the valid rows' longest byte length (no read-back)."""
    if c.len_bound is not None or not c.capacity:
        return torch.tensor(c.len_bound or 0, dtype=torch.int64,
                            device=c.device)
    return torch.where(c.valid_bool(), c.views[:, 0], 0).max().to(
        torch.int64)


def max_byte_length(c: col.StringViewColumn) -> int:
    """The longest string's byte length rounded up to the granule (at
    least one granule): `len_bound` when the column has one, else one
    read-back of the valid rows' lengths."""
    if c.len_bound is not None:
        return matrix_width(c.len_bound)
    return matrix_width(int(byte_bound(c)))


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


# ---------------------------------------------------------------------------
# LIKE compilation (the reference's predicate.rs:28-59)
# ---------------------------------------------------------------------------


class _Compiled:
    """A LIKE pattern compiled to a specialized matcher."""

    def __init__(self, kind: str, payload: str):
        self.kind = kind  # eq | starts | ends | contains | regex
        self.payload = payload


def compile_like(pattern: str) -> _Compiled:
    """LIKE -> eq / starts / ends / contains on the literal text, else an
    anchored regex (% -> .*, _ -> ., a backslash escapes)."""
    special = set("%_\\")
    body = pattern
    if not any(ch in special for ch in body):
        return _Compiled("eq", body)
    if (body.endswith("%") and not body.endswith("\\%")
            and not any(ch in special for ch in body[:-1])):
        return _Compiled("starts", body[:-1])
    if body.startswith("%") and not any(ch in special for ch in body[1:]):
        return _Compiled("ends", body[1:])
    if (len(body) >= 2 and body.startswith("%") and body.endswith("%")
            and not body.endswith("\\%")
            and not any(ch in special for ch in body[1:-1])):
        return _Compiled("contains", body[1:-1])
    out = []
    i = 0
    while i < len(body):
        ch = body[i]
        if ch == "\\" and i + 1 < len(body):
            out.append(re.escape(body[i + 1]))
            i += 2
            continue
        out.append(".*" if ch == "%" else "." if ch == "_" else re.escape(ch))
        i += 1
    return _Compiled("regex", "(?s)^" + "".join(out) + "$")


# ---------------------------------------------------------------------------
# matrix matchers
# ---------------------------------------------------------------------------


def _pattern_bytes(pat, lower: bool) -> bytes:
    """The pattern's bytes, held on the host: the matchers compare the
    matrix's columns with them as Python ints, so no pattern is copied to
    the card (a copy would wait for the card's queue)."""
    raw = pat.encode("utf-8") if isinstance(pat, str) else bytes(pat)
    return raw.lower() if lower else raw


def _lower_ascii(mat: torch.Tensor) -> torch.Tensor:
    upper = (mat >= ord("A")) & (mat <= ord("Z"))
    return torch.where(upper, mat + 32, mat)


def _ones(mat: torch.Tensor) -> torch.Tensor:
    return torch.ones(mat.shape[0], dtype=torch.bool, device=mat.device)


def _starts_with_mat(mat, lens, pat: bytes):
    P = len(pat)
    if P == 0:
        return _ones(mat)
    acc = lens >= P
    for j, b in enumerate(pat):
        acc &= mat[:, j] == b
    return acc


def _window_hits(mat, pat: bytes):
    """(n, L - P + 1) bool: the pattern matches at byte position s; P
    compares of static column shifts, no per-row gather."""
    P = len(pat)
    windows = mat.shape[1] - P + 1
    acc = mat[:, :windows] == pat[0]
    for j in range(1, P):
        acc &= mat[:, j:j + windows] == pat[j]
    return acc


def _ends_with_mat(mat, lens, pat: bytes):
    n, L = mat.shape
    P = len(pat)
    if P == 0:
        return _ones(mat)
    if L - P + 1 <= 0:
        return torch.zeros(n, dtype=torch.bool, device=mat.device)
    hits = _window_hits(mat, pat)
    # the suffix window starts at len - P: one pick a row
    at = (lens.to(torch.int64) - P).clamp(0, hits.shape[1] - 1)
    return hits.gather(1, at[:, None])[:, 0] & (lens >= P)


def _contains_mat(mat, lens, pat: bytes):
    n, L = mat.shape
    P = len(pat)
    if P == 0:
        return _ones(mat)
    windows = L - P + 1
    if windows <= 0:
        return torch.zeros(n, dtype=torch.bool, device=mat.device)
    hits = _window_hits(mat, pat)
    start = torch.arange(windows, device=mat.device)
    hits &= (start + P)[None, :] <= lens[:, None]
    return hits.any(dim=1)


def _eq_mat(mat, lens, pat: bytes):
    return _starts_with_mat(mat, lens, pat) & (lens == len(pat))


_MATCHERS = {"eq": _eq_mat, "starts": _starts_with_mat,
             "ends": _ends_with_mat, "contains": _contains_mat}
# the matchers that read only the first P bytes of a row
_PREFIX = ("eq", "starts")


def like_width(c: col.StringViewColumn, compiled: _Compiled) -> int:
    """The byte-matrix width a compiled LIKE pattern is matched at: the
    pattern's granule for `eq` and `starts` (they read the first P bytes),
    else the column's width, at least the pattern's granule."""
    P = len(compiled.payload.encode("utf-8"))
    if compiled.kind in _PREFIX:
        return matrix_width(P)
    return max(max_byte_length(c), matrix_width(max(P, 1)))


# ---------------------------------------------------------------------------
# predicates (the reference's like.rs:83-211)
# ---------------------------------------------------------------------------


def _bool_column(bits: torch.Tensor, validity, length: int):
    bits[length:] = False
    return col.BooleanColumn(bm.pack(bits), validity, length)


def _dict_gather_bool(c: col.DictionaryColumn, value_bits: col.BooleanColumn
                      ) -> col.BooleanColumn:
    """A per-dictionary-value predicate gathered by key (the reference's
    dictionary fast path)."""
    bits = value_bits.values_bool()
    keys = c.keys.values.to(torch.int64).clamp(0, bits.shape[0] - 1)
    return _bool_column(bits[keys], c.validity, c.length)


def _host_bits(c: col.StringViewColumn, test, fill: bool) -> torch.Tensor:
    """(capacity,) bool on c's device: `test(s)` of each live string, `fill`
    at its null rows, False past the length (the host path)."""
    bits = np.zeros(c.capacity, bool)
    bits[:c.length] = [fill if v is None else test(v) for v in c.to_pylist()]
    return torch.from_numpy(bits).to(c.device)


def _scalar_predicate(c, compiled: _Compiled, lower: bool, negate: bool):
    if isinstance(c, col.DictionaryColumn):
        inner = _scalar_predicate(c.values, compiled, lower, negate)
        return _dict_gather_bool(c, inner)
    c = _as_view(c)
    if compiled.kind == "regex":
        rx = re.compile(compiled.payload, re.IGNORECASE if lower else 0)
        bits = _host_bits(c, lambda v: bool(rx.match(v)) ^ negate, negate)
        return _bool_column(bits, c.validity, c.length)
    pat = _pattern_bytes(compiled.payload, lower)
    mat, lens = byte_matrix(c, like_width(c, compiled))
    if lower:
        mat = _lower_ascii(mat)
    bits = _MATCHERS[compiled.kind](mat, lens, pat)
    if negate:
        bits = ~bits
    return _bool_column(bits, c.validity, c.length)


def like(c, pattern: str):
    return _scalar_predicate(c, compile_like(pattern), False, False)


def nlike(c, pattern: str):
    return _scalar_predicate(c, compile_like(pattern), False, True)


def ilike(c, pattern: str):
    return _scalar_predicate(c, compile_like(pattern.lower()), True, False)


def nilike(c, pattern: str):
    return _scalar_predicate(c, compile_like(pattern.lower()), True, True)


def starts_with(c, prefix: str):
    return _scalar_predicate(c, _Compiled("starts", prefix), False, False)


def ends_with(c, suffix: str):
    return _scalar_predicate(c, _Compiled("ends", suffix), False, False)


def contains(c, needle: str):
    return _scalar_predicate(c, _Compiled("contains", needle), False, False)


def regexp_is_match(c, pattern: str, flags: str = ""):
    """Python's `re.search` of each string, on the host (the reference
    runs its regex crate on the CPU too); "i" in `flags` ignores case."""
    rx = re.compile(pattern, re.IGNORECASE if "i" in flags else 0)
    return _regex_search(c, rx)


def _regex_search(c, rx):
    if isinstance(c, col.DictionaryColumn):
        return _dict_gather_bool(c, _regex_search(c.values, rx))
    c = _as_view(c)
    bits = _host_bits(c, lambda v: rx.search(v) is not None, False)
    return _bool_column(bits, c.validity, c.length)


# ---------------------------------------------------------------------------
# substring, concat, case (the reference's substring.rs:72,
# concat_elements.rs)
# ---------------------------------------------------------------------------


def substring(c, start: int, length_: int = None) -> col.StringViewColumn:
    """Byte-offset substring: a negative `start` counts from the end,
    `length_` None runs to the end."""
    c = _as_view(c)
    L = max_byte_length(c)
    mat, lens = byte_matrix(c, L)
    lens = lens.to(torch.int64)
    s = (lens + start).clamp(min=0) if start < 0 else lens.clamp(max=start)
    remaining = lens - s
    ln = remaining if length_ is None else remaining.clamp(max=length_)
    idx = (s[:, None] + torch.arange(L, device=mat.device)).clamp(max=L - 1)
    return from_byte_matrix(mat.gather(1, idx), ln, c.validity, c.length,
                            c.dtype)


def concat_elements(a, b) -> col.StringViewColumn:
    """Row-wise concatenation a || b; null where either is null."""
    a, b = _as_view(a), _as_view(b)
    if a.capacity != b.capacity:
        raise st.ComputeError("concat_elements: capacity mismatch")
    La, Lb = max_byte_length(a), max_byte_length(b)
    ma, la = byte_matrix(a, La)
    mb, lb = byte_matrix(b, Lb)
    j = torch.arange(La + Lb, device=ma.device)[None, :]
    la = la.to(torch.int64)[:, None]
    from_a = ma.gather(1, j.clamp(max=La - 1).expand(ma.shape[0], -1))
    from_b = mb.gather(1, (j - la).clamp(0, Lb - 1))
    out = torch.where(j < la, from_a, from_b)
    return from_byte_matrix(out, la[:, 0] + lb, bm.union(a.validity,
                                                         b.validity),
                            a.length, a.dtype)


def lower(c):
    """ASCII lowering on the card; a column with a non-ASCII byte maps on
    the host (full Unicode, as the reference's case.rs)."""
    return _case_map(c, True)


def upper(c):
    return _case_map(c, False)


def _case_map(c, to_lower: bool):
    if isinstance(c, col.DictionaryColumn):
        return dataclasses.replace(c, values=_case_map(c.values, to_lower),
                                   value_ranks=None)
    c = _as_view(c)
    L = max_byte_length(c)
    mat, lens = byte_matrix(c, L)
    if bool((mat >= 0x80).any()):
        out = [None if v is None else (v.lower() if to_lower else v.upper())
               for v in c.to_pylist()]
        return col.string_view(out, c.dtype, c.device)
    if to_lower:
        mat = _lower_ascii(mat)
    else:
        low = (mat >= ord("a")) & (mat <= ord("z"))
        mat = torch.where(low, mat - 32, mat)
    return from_byte_matrix(mat, lens, c.validity, c.length, c.dtype)
