"""Typed columns: capacity-padded tensors with an LSB validity bitmap.

Counterpart of `arrowtpu/core/column.py`, keeping its contract:

  * a column holds `values` padded to a static `capacity`
    (config.round_up of its length), an optional packed validity bitmap
    (None means all valid) and its `length`;
  * rows in [length, capacity) have value 0 and validity bit 0 (padding
    contract): code may compute on padding but never lets it reach rows
    below the length, and every constructor and operator writes zeros
    there;
  * values under a null are unspecified but are carried through unchanged.

Differences from the JAX package, by design: 64-bit integers are native
`torch.int64` (not u32 limb pairs), bitmaps are Arrow LSB order, and
`length` is a Python int (PyTorch runs eagerly; an operator whose output
length depends on the data reads it back from the device once).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import schema as st
from ..config import resolve_device, round_up
from . import bitmap as bm


class Column:
    """Abstract base; the concrete columns are the dataclasses below."""

    dtype: st.DataType
    validity: Optional[torch.Tensor]
    length: int

    @property
    def capacity(self) -> int:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    def null_count(self) -> int:
        if self.validity is None:
            return 0
        return self.length - int(bm.count_set_bits(self.validity))

    def valid_bool(self) -> torch.Tensor:
        """(capacity,) bool: row is valid AND not padding."""
        if self.validity is None:
            return bm.row_mask_bool(self.capacity, self.length, self.device)
        return bm.unpack(bm.clip(self.validity, self.length))

    def _valid_list(self, n):
        if self.validity is None:
            return None
        return bm.to_numpy_bools(self.validity, n)

    def to_pylist(self):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class PrimitiveColumn(Column):
    values: torch.Tensor  # (capacity,) native dtype
    validity: Optional[torch.Tensor]  # (capacity/8,) uint8 or None
    length: int
    dtype: st.DataType

    @property
    def capacity(self) -> int:
        return self.values.shape[0]

    @property
    def device(self) -> torch.device:
        return self.values.device

    def to_pylist(self):
        n = self.length
        vals = self.values[:n].cpu().tolist()
        valid = self._valid_list(n)
        if valid is None:
            return vals
        return [v if ok else None for v, ok in zip(vals, valid)]


@dataclasses.dataclass(frozen=True)
class BooleanColumn(Column):
    values: torch.Tensor  # packed uint8 (capacity/8,)
    validity: Optional[torch.Tensor]
    length: int

    dtype = st.bool_

    @property
    def capacity(self) -> int:
        return bm.capacity_of(self.values)

    @property
    def device(self) -> torch.device:
        return self.values.device

    def values_bool(self) -> torch.Tensor:
        return bm.unpack(self.values)

    def to_pylist(self):
        n = self.length
        vals = bm.to_numpy_bools(self.values, n).tolist()
        valid = self._valid_list(n)
        if valid is None:
            return vals
        return [v if ok else None for v, ok in zip(vals, valid)]


@dataclasses.dataclass(frozen=True)
class NullColumn(Column):
    """All-null column."""

    length: int
    _capacity: int
    _device: torch.device

    dtype = st.null
    validity = None

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def device(self) -> torch.device:
        return self._device

    def null_count(self) -> int:
        return self.length

    def valid_bool(self) -> torch.Tensor:
        return torch.zeros(self._capacity, dtype=torch.bool,
                           device=self._device)

    def to_pylist(self):
        return [None] * self.length


@dataclasses.dataclass(frozen=True)
class StringViewColumn(Column):
    """Utf8 / Binary in the Arrow view layout, as the JAX package holds it:
    views[i] = [byte length, first 4 bytes (little-endian), buffer index
    (always 0: one arena), arena offset]; a string of at most 12 bytes is
    inline, its bytes 4..12 in the last two words.  The words are the JAX
    package's u32 bits held as int32.  `len_bound` bounds the byte length."""

    views: torch.Tensor  # (capacity, 4) int32
    arena: torch.Tensor  # (arena capacity,) uint8
    validity: Optional[torch.Tensor]
    length: int
    dtype: st.DataType  # Utf8 or Binary
    len_bound: Optional[int] = None

    @property
    def capacity(self) -> int:
        return self.views.shape[0]

    @property
    def device(self) -> torch.device:
        return self.views.device

    def to_pylist(self):
        n = self.length
        views = self.views[:n].cpu().numpy()
        arena = self.arena.cpu().numpy()
        valid = self._valid_list(n)
        out = []
        for i in range(n):
            if valid is not None and not valid[i]:
                out.append(None)
                continue
            ln = int(views[i, 0])
            if ln <= 12:
                raw = views[i, 1:].astype("<u4").tobytes()[:ln]
            else:
                off = int(views[i, 3])
                raw = arena[off:off + ln].tobytes()
            out.append(raw.decode("utf-8") if isinstance(self.dtype, st.Utf8)
                       else raw)
        return out


@dataclasses.dataclass(frozen=True)
class DictionaryColumn(Column):
    """Integer keys into a value column; validity and length live on the
    keys.  `value_ranks` ((values.capacity,) int32, or None) is each
    value's rank in the values' ascending order, which sorting a dictionary
    column sorts its keys by."""

    keys: PrimitiveColumn
    values: Column
    value_ranks: Optional[torch.Tensor]
    dtype: st.Dictionary

    @property
    def capacity(self) -> int:
        return self.keys.capacity

    @property
    def device(self) -> torch.device:
        return self.keys.device

    @property
    def validity(self):  # type: ignore[override]
        return self.keys.validity

    @property
    def length(self):  # type: ignore[override]
        return self.keys.length

    def to_pylist(self):
        vals = self.values.to_pylist()
        return [None if k is None else vals[k] for k in self.keys.to_pylist()]


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------


def _tensor(values, device) -> torch.Tensor:
    """A host or device array as a tensor on `device` (None: the tensor's
    own device, or the card for host data)."""
    if isinstance(values, torch.Tensor):
        return values if device is None else values.to(device)
    return torch.as_tensor(np.asarray(values), device=resolve_device(device))


def _length(length, n: int) -> int:
    """The column length: `n` values by default, at most `n`."""
    if length is None:
        return n
    if not 0 <= int(length) <= n:
        raise st.InvalidArgumentError(f"length {length} outside [0, {n}]")
    return int(length)


def _pad(t: torch.Tensor, capacity: int) -> torch.Tensor:
    n = t.shape[0]
    if capacity < n:
        raise st.InvalidArgumentError(f"capacity {capacity} < data length {n}")
    if capacity == n:
        return t.contiguous()
    out = torch.zeros(capacity, dtype=t.dtype, device=t.device)
    out[:n] = t
    return out


def _bitmap(validity, capacity: int, device) -> Optional[torch.Tensor]:
    """Validity given as bools (any length <= capacity) or as a packed
    uint8 bitmap of the capacity -> packed bitmap on `device`."""
    if validity is None:
        return None
    v = _tensor(validity, device)
    if v.dtype == torch.bool:
        return bm.pack(_pad(v, capacity))
    if v.dtype != torch.uint8 or v.shape[0] != bm.num_bytes(capacity):
        raise st.InvalidArgumentError(
            "validity must be bools or a packed uint8 bitmap of the capacity")
    return v.contiguous()


def primitive(values, dtype: st.DataType = None, validity=None, length=None,
              device=None) -> PrimitiveColumn:
    """A PrimitiveColumn from a tensor or host array, zero-padded to the
    capacity (the number of values rounded up to the granule).  `length`
    defaults to the number of values; rows past it are zeroed."""
    t = _tensor(values, device)
    if dtype is None:
        dtype = st.from_torch(t.dtype)
    t = t.to(dtype.to_torch())
    n = _length(length, t.shape[0])
    cap = round_up(max(t.shape[0], 1))
    t = _pad(t, cap)
    if n < t.shape[0]:
        t[n:] = 0
    valid = _bitmap(validity, cap, t.device)
    if valid is not None:
        valid = bm.clip(valid, n)
    return PrimitiveColumn(t, valid, n, dtype)


def boolean(values, validity=None, length=None,
            device=None) -> BooleanColumn:
    """A BooleanColumn from bools (packed here) or a packed bitmap."""
    t = _tensor(values, device)
    if t.dtype == torch.bool:
        n = _length(length, t.shape[0])
        cap = round_up(max(t.shape[0], 1))
        bools = _pad(t, cap) & bm.row_mask_bool(cap, n, t.device)
        words = bm.pack(bools)
    else:
        words = t.to(torch.uint8)
        cap = bm.capacity_of(words)
        n = _length(length, cap)
        words = bm.clip(words, n)
    valid = _bitmap(validity, cap, words.device)
    if valid is not None:
        valid = bm.clip(valid, n)
    return BooleanColumn(words, valid, n)


def null_column(n: int, device=None) -> NullColumn:
    return NullColumn(n, round_up(max(n, 1)), resolve_device(device))


def string_view(data, dtype: st.DataType = st.utf8,
                device=None) -> StringViewColumn:
    """A StringViewColumn from host strings or bytes (None for a null), laid
    out as the JAX package's `string_view` builds it."""
    n = len(data)
    cap = round_up(max(n, 1))
    views = np.zeros((cap, 4), dtype=np.uint32)
    valid = np.zeros(cap, dtype=bool)
    arena = bytearray()
    for i, s in enumerate(data):
        if s is None:
            continue
        valid[i] = True
        raw = s.encode("utf-8") if isinstance(s, str) else bytes(s)
        ln = len(raw)
        views[i, 0] = ln
        views[i, 1] = np.frombuffer(raw[:4].ljust(4, b"\0"), dtype="<u4")[0]
        if ln <= 12:
            views[i, 2:4] = np.frombuffer(raw[4:12].ljust(8, b"\0"),
                                          dtype="<u4")
        else:
            views[i, 3] = len(arena)
            arena.extend(raw)
    arena_np = np.zeros(round_up(max(len(arena), 1)), dtype=np.uint8)
    arena_np[:len(arena)] = np.frombuffer(bytes(arena), dtype=np.uint8)
    device = resolve_device(device)
    validity = (None if valid[:n].all()
                else bm.from_numpy_bools(valid[:n], cap, device))
    return StringViewColumn(torch.from_numpy(views.view(np.int32)).to(device),
                            torch.from_numpy(arena_np).to(device), validity, n,
                            dtype, int(views[:, 0].max()) if n else 0)


def dictionary_encode_host(data, dtype: st.Dictionary = None,
                           device=None) -> DictionaryColumn:
    """A DictionaryColumn interning host values (None for a null key) in
    first-seen order, with each value's rank under Python's ascending order
    of the values (a stable argsort, as the JAX package computes it)."""
    if dtype is None:
        dtype = st.Dictionary(st.int32, st.utf8)
    interned: dict = {}
    keys = []
    for x in data:
        if x is not None and x not in interned:
            interned[x] = len(interned)
        keys.append(0 if x is None else interned[x])
    values_list = list(interned)
    valid = np.array([x is not None for x in data], dtype=bool)
    keys_col = primitive(np.asarray(keys, dtype=np.int64), dtype.key,
                         validity=None if valid.all() else valid,
                         device=device)
    if isinstance(dtype.value, (st.Utf8, st.Binary)):
        values_col = string_view(values_list, dtype.value, device=device)
    else:
        values_col = primitive(np.asarray(values_list), dtype.value,
                               device=device)
    order = np.argsort(np.asarray(values_list, dtype=object), kind="stable")
    ranks = np.zeros(values_col.capacity, dtype=np.int32)
    ranks[:len(values_list)][order] = np.arange(len(values_list),
                                                dtype=np.int32)
    return DictionaryColumn(keys_col, values_col,
                            torch.from_numpy(ranks).to(keys_col.device), dtype)
