"""Windowed accessors and iterators over columns.

Counterpart of `arrowtpu/core/accessor.py`: element access and lazy
iteration without bringing a whole column to the host.  An accessor
fetches a window of rows at a time (each buffer's rows of the window in
one `.cpu()`, a string view's arena only as far as the window's long
strings reach) and serves Python values from it, so `iter_column` over a
100M-row column holds one window on the host, where `to_pylist` holds
them all.  Values equal `to_pylist`'s.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional

import numpy as np

from .. import schema as st
from . import column as col

DEFAULT_WINDOW = 8192


class ArrayAccessor:
    """Windowed element access over any column: `value(i)` is None at a
    null."""

    def __init__(self, c: col.Column, window: int = DEFAULT_WINDOW):
        self._c = c
        self._n = c.length
        self._window = max(int(window), 1)
        self._lo = 0
        self._cache: Optional[list] = None

    def __len__(self) -> int:
        return self._n

    def value(self, i: int) -> Any:
        if not 0 <= i < self._n:
            raise IndexError(f"accessor index {i} out of range {self._n}")
        if self._cache is None or not (
                self._lo <= i < self._lo + len(self._cache)):
            self._lo = (i // self._window) * self._window
            self._cache = _window_values(
                self._c, self._lo, min(self._lo + self._window, self._n))
        return self._cache[i - self._lo]

    def __iter__(self) -> Iterator[Any]:
        for lo in range(0, self._n, self._window):
            yield from _window_values(self._c, lo,
                                      min(lo + self._window, self._n))


def _bits(bitmap, lo: int, hi: int) -> np.ndarray:
    """Rows [lo, hi) of a packed bitmap as bools: only its bytes there
    cross to the host."""
    raw = bitmap[lo // 8:(hi + 7) // 8].cpu().numpy()
    return np.unpackbits(raw, bitorder="little")[lo % 8:lo % 8 + hi - lo
                                                 ].astype(bool)


def _valid(c: col.Column, lo: int, hi: int) -> np.ndarray:
    if c.validity is None:
        return np.ones(hi - lo, bool)
    return _bits(c.validity, lo, hi)


def _window_values(c: col.Column, lo: int, hi: int) -> list:
    """Python values of rows [lo, hi)."""
    n = hi - lo
    if isinstance(c, col.NullColumn):
        return [None] * n
    if isinstance(c, col.DictionaryColumn):
        values = c.values.to_pylist()
        return [None if k is None else values[k]
                for k in _window_values(c.keys, lo, hi)]
    if isinstance(c, (col.RunEndColumn, col.UnionColumn)):
        return c.to_pylist()[lo:hi]
    ok = _valid(c, lo, hi)
    if isinstance(c, col.BooleanColumn):
        vals = _bits(c.values, lo, hi).tolist()
    elif isinstance(c, col.PrimitiveColumn):
        window = col.PrimitiveColumn(c.values[lo:hi], None, n, c.dtype)
        vals = window.to_pylist()
    elif isinstance(c, col.StringViewColumn):
        vals = _strings(c, lo, hi, ok)
    elif isinstance(c, col.StructColumn):
        names = [f.name for f in c.dtype.fields]
        kids = [_window_values(ch, lo, hi) for ch in c.children]
        vals = [dict(zip(names, row)) for row in zip(*kids)] if kids \
            else [{}] * n
    elif isinstance(c, col.ListViewColumn):
        vals = _lists(c, lo, hi, ok)
    else:
        vals = c.to_pylist()[lo:hi]
    return [v if k else None for v, k in zip(vals, ok)]


def _strings(c: col.StringViewColumn, lo: int, hi: int, ok) -> list:
    views = c.views[lo:hi].cpu().numpy().view(np.uint32)
    lens = views[:, 0].astype(np.int64)
    long = ok & (lens > 12)
    base, arena = 0, np.zeros(0, np.uint8)
    if long.any():
        offs = views[long, 3].astype(np.int64)
        base = int(offs.min())
        arena = c.arena[base:int((offs + lens[long]).max())].cpu().numpy()
    out = []
    for i in range(hi - lo):
        ln = int(lens[i])
        if not ok[i]:
            out.append(None)
            continue
        if ln <= 12:
            raw = views[i, 1:].astype("<u4").tobytes()[:ln]
        else:
            off = int(views[i, 3]) - base
            raw = arena[off:off + ln].tobytes()
        out.append(raw.decode("utf-8") if isinstance(c.dtype, st.Utf8)
                   else raw)
    return out


def _lists(c: col.ListViewColumn, lo: int, hi: int, ok) -> list:
    starts = c.starts[lo:hi].cpu().numpy()
    sizes = c.sizes[lo:hi].cpu().numpy()
    items = ArrayAccessor(c.child)
    is_map = isinstance(c.dtype, st.Map)
    out = []
    for i in range(hi - lo):
        if not ok[i]:
            out.append(None)
            continue
        row = [items.value(int(starts[i]) + j) for j in range(int(sizes[i]))]
        out.append([(d["key"], d["value"]) for d in row] if is_map else row)
    return out


def iter_column(c: col.Column,
                window: int = DEFAULT_WINDOW) -> Iterator[Any]:
    """Lazy element iterator: Python values, None for a null, one window
    fetched at a time."""
    return iter(ArrayAccessor(c, window))


def iter_rows(batch, window: int = DEFAULT_WINDOW) -> Iterator[dict]:
    """Lazy row iterator over a RecordBatch: one dict a row."""
    names = list(batch.schema.names)
    for vals in zip(*(iter_column(c, window) for c in batch.columns)):
        yield dict(zip(names, vals))
