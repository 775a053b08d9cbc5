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

Decimals, intervals and fixed-size binary are PrimitiveColumns whose
values are (capacity, W) int32 words (`schema.words_per_row`), the JAX
package's u32 words bit for bit.  The nested classes (list view, struct,
fixed-size list, run-end, union) hold child columns; a fixed-size list's
child has `size` rows per row, its length `length * size`.  Every class
takes an explicit device (None: the card).
"""

from __future__ import annotations

import dataclasses
import decimal as _pydec
from typing import Optional, Tuple

import numpy as np
import torch

from .. import schema as st
from ..config import resolve_device, round_up
from . import bitmap as bm
from . import limbs as lb


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
        if self.values.dim() == 2:
            vals = _words_to_py(self.values[:n].cpu().numpy(), self.dtype)
        elif st.is_u64(self.dtype):
            vals = self.values[:n].cpu().numpy().view(np.uint64).tolist()
        else:
            vals = self.values[:n].cpu().tolist()
        valid = self._valid_list(n)
        if valid is None:
            return vals
        return [v if ok else None for v, ok in zip(vals, valid)]


def _words_to_py(words: np.ndarray, dtype: st.DataType) -> list:
    """(n, W) int32 words -> Python values: Decimal (under an 80-digit
    context: the default 28 digits would round Decimal128/256), bytes of a
    fixed-size binary, or an interval's int / tuple."""
    u = words.astype(np.uint32)
    if st.decimal_limbs(dtype) is not None:
        with _pydec.localcontext(_pydec.Context(prec=80)):
            return [_pydec.Decimal(v).scaleb(-dtype.scale)
                    for v in lb.join_ints(u)]
    if isinstance(dtype, st.FixedSizeBinary):
        raw = u.astype("<u4").tobytes()
        row = u.shape[1] * 4
        return [raw[i * row: i * row + dtype.byte_width]
                for i in range(u.shape[0])]
    i32 = u.view(np.int32)
    if dtype.unit == "year_month":
        return [int(x) for x in i32[:, 0]]
    if dtype.unit == "day_time":
        return [(int(a), int(b)) for a, b in i32[:, :2]]
    nanos = np.ascontiguousarray(u[:, 2:4]).view(np.int64)[:, 0]
    return [(int(m), int(d), int(x))
            for m, d, x in zip(i32[:, 0], i32[:, 1], nanos)]


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


@dataclasses.dataclass(frozen=True)
class ListViewColumn(Column):
    """List (or Map) as a list view: row i is child rows [starts[i],
    starts[i] + sizes[i]) of a shared child, so filter and take move only
    the (start, size) pairs.  A Map's child is its (key, value) struct."""

    starts: torch.Tensor  # (capacity,) int32 into child rows
    sizes: torch.Tensor  # (capacity,) int32
    child: Column
    validity: Optional[torch.Tensor]
    length: int
    dtype: st.DataType  # st.List | st.Map

    @property
    def capacity(self) -> int:
        return self.starts.shape[0]

    @property
    def device(self) -> torch.device:
        return self.starts.device

    def to_pylist(self):
        n = self.length
        starts = self.starts[:n].cpu().tolist()
        sizes = self.sizes[:n].cpu().tolist()
        valid = self._valid_list(n)
        items = self.child.to_pylist()
        is_map = isinstance(self.dtype, st.Map)
        out = []
        for i in range(n):
            if valid is not None and not valid[i]:
                out.append(None)
                continue
            row = items[starts[i]:starts[i] + sizes[i]]
            out.append([(d["key"], d["value"]) for d in row] if is_map
                       else row)
        return out


@dataclasses.dataclass(frozen=True)
class StructColumn(Column):
    """Parallel children of the struct's capacity and length, plus the
    struct's own validity."""

    children: Tuple[Column, ...]
    validity: Optional[torch.Tensor]
    length: int
    dtype: st.Struct

    @property
    def capacity(self) -> int:
        return self.children[0].capacity if self.children else 0

    @property
    def device(self) -> torch.device:
        return self.children[0].device

    def field(self, name: str) -> Column:
        for f, c in zip(self.dtype.fields, self.children):
            if f.name == name:
                return c
        raise st.SchemaError(f"struct has no field {name!r}")

    def to_pylist(self):
        n = self.length
        valid = self._valid_list(n)
        cols = [c.to_pylist() for c in self.children]
        names = [f.name for f in self.dtype.fields]
        rows = zip(*cols) if cols else [()] * n
        return [dict(zip(names, vals)) if valid is None or valid[i] else None
                for i, vals in enumerate(rows)]


@dataclasses.dataclass(frozen=True)
class FixedSizeListColumn(Column):
    """Row i's items are child rows [i * size, (i + 1) * size); the child
    has capacity * size rows and length * size live ones."""

    child: Column
    validity: Optional[torch.Tensor]
    length: int
    dtype: st.FixedSizeList

    @property
    def capacity(self) -> int:
        return self.child.capacity // self.dtype.size

    @property
    def device(self) -> torch.device:
        return self.child.device

    def to_pylist(self):
        n, size = self.length, self.dtype.size
        valid = self._valid_list(n)
        items = self.child.to_pylist()
        return [items[i * size:(i + 1) * size]
                if valid is None or valid[i] else None for i in range(n)]


@dataclasses.dataclass(frozen=True)
class RunEndColumn(Column):
    """Run-end encoded: run_ends[j] is the cumulative logical end of
    physical run j, and logical row i lives in the first run whose end
    exceeds i.  Runs occupy rows [0, n_runs); the padding run ends hold the
    logical length (at least 1), as in the JAX package, so a search never
    lands on them.  Nulls live on the values; there is no validity of its
    own."""

    run_ends: torch.Tensor  # (run capacity,) int32
    values: Column  # one row per run
    length: int  # logical rows
    dtype: st.RunEndEncoded

    validity = None

    @property
    def capacity(self) -> int:
        return self.run_ends.shape[0]

    @property
    def device(self) -> torch.device:
        return self.run_ends.device

    @property
    def n_runs(self) -> int:
        return self.values.length

    def physical_index(self, logical_idx: torch.Tensor) -> torch.Tensor:
        """Logical row index -> physical run index."""
        return torch.searchsorted(self.run_ends, logical_idx.to(torch.int32),
                                  right=True).to(torch.int32)

    def to_pylist(self):
        ends = self.run_ends.cpu().tolist()
        vals = self.values.to_pylist()
        out, run = [], 0
        for i in range(self.length):
            while run < len(ends) and i >= ends[run]:
                run += 1
            out.append(vals[run] if run < len(vals) else None)
        return out


@dataclasses.dataclass(frozen=True)
class UnionColumn(Column):
    """Sparse or dense union: a type code a row (int8 codes held as
    int32), offsets into the children iff dense; no validity of its own
    (nulls live in the children)."""

    type_id_arr: torch.Tensor  # (capacity,) int32
    offsets: Optional[torch.Tensor]  # (capacity,) int32 iff dense
    children: Tuple[Column, ...]
    length: int
    dtype: st.Union

    validity = None

    @property
    def capacity(self) -> int:
        return self.type_id_arr.shape[0]

    @property
    def device(self) -> torch.device:
        return self.type_id_arr.device

    @property
    def is_dense(self) -> bool:
        return self.dtype.mode == "dense"

    def child_by_type_id(self, type_id: int) -> Column:
        return self.children[self.dtype.child_index(type_id)]

    def to_pylist(self):
        n = self.length
        tids = self.type_id_arr[:n].cpu().tolist()
        offs = (self.offsets[:n].cpu().tolist() if self.offsets is not None
                else range(n))
        kids = [c.to_pylist() for c in self.children]
        codes = self.dtype.type_ids or tuple(range(len(self.children)))
        child_of = {t: i for i, t in enumerate(codes)}
        return [kids[child_of[t]][o] for t, o in zip(tids, offs)]


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
    out = torch.zeros((capacity,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
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


def _unscaled(v, scale: int) -> int:
    """A decimal's Python value (int, Decimal or None) as its unscaled
    integer, rounded half up under an 80-digit context."""
    if v is None:
        return 0
    if isinstance(v, _pydec.Decimal):
        with _pydec.localcontext(_pydec.Context(prec=80)):
            return int(v.scaleb(scale).to_integral_value(
                rounding=_pydec.ROUND_HALF_UP))
    return int(v)


def _host_words(values, dtype: st.DataType, nw: int) -> np.ndarray:
    """Python values of a decimal, interval or fixed-size binary type ->
    (n, nw) uint32 words, laid out as the JAX package lays them out."""
    nl = st.decimal_limbs(dtype)
    if nl is not None:
        return lb.split_ints([_unscaled(v, dtype.scale) for v in values], nl)
    buf = np.zeros((len(values), nw), np.uint32)
    if isinstance(dtype, st.FixedSizeBinary):
        raw = np.zeros((len(values), nw * 4), np.uint8)
        for i, v in enumerate(values):
            if v is None:
                continue
            b = bytes(v)
            if len(b) != dtype.byte_width:
                raise st.InvalidArgumentError(
                    f"fixed_size_binary[{dtype.byte_width}]: value {i} has "
                    f"{len(b)} bytes")
            raw[i, :len(b)] = np.frombuffer(b, np.uint8)
        return raw.view("<u4").reshape(len(values), nw).astype(np.uint32)
    for i, v in enumerate(values):
        if v is None:
            continue
        parts = v if isinstance(v, tuple) else (v,)
        if dtype.unit == "month_day_nano":
            m, d, nanos = parts
            nv = np.int64(nanos).view(np.uint64)
            buf[i] = [np.int32(m).view(np.uint32), np.int32(d).view(np.uint32),
                      nv & np.uint64(_M32), nv >> np.uint64(32)]
        else:
            buf[i, :nw] = [np.int32(x).view(np.uint32) for x in parts[:nw]]
    return buf


_M32 = 0xFFFFFFFF


def _words(values, dtype: st.DataType, device) -> torch.Tensor:
    """A decimal, interval or fixed-size binary column's values -> (n, W)
    int32 words on `device`: a (n, W) tensor or uint32 / int32 array is
    taken as the words themselves, anything else as Python values."""
    nw = st.words_per_row(dtype)
    if isinstance(values, torch.Tensor) or (
            isinstance(values, np.ndarray) and values.ndim == 2
            and values.dtype in (np.uint32, np.int32)):
        t = _tensor(values, device)
        if t.dim() != 2 or t.shape[1] != nw:
            raise st.InvalidArgumentError(
                f"{dtype} values must be (n, {nw}) 32-bit words")
        if t.dtype == torch.uint32:
            t = t.view(torch.int32)
        return t.to(torch.int32)
    host = _host_words(list(values), dtype, nw)
    return torch.from_numpy(host.view(np.int32)).to(resolve_device(device))


def numpy_dtype(dtype: st.DataType) -> np.dtype:
    """The numpy dtype that holds a one-dtype type's values on the host
    (uint64's values, not the int64 bits its tensor holds)."""
    if st.is_u64(dtype):
        return np.dtype(np.uint64)
    return torch.empty(0, dtype=dtype.to_torch()).numpy().dtype


def _as_u64_bits(values):
    """uint64 host or torch values -> their bits as int64 (None when the
    values are not uint64)."""
    if isinstance(values, np.ndarray) and values.dtype == np.uint64:
        return values.view(np.int64)
    if isinstance(values, torch.Tensor) and values.dtype == torch.uint64:
        return values.view(torch.int64)
    return None


def primitive(values, dtype: st.DataType = None, validity=None, length=None,
              device=None) -> PrimitiveColumn:
    """A PrimitiveColumn from a tensor or host array, zero-padded to the
    capacity (the number of values rounded up to the granule).  `length`
    defaults to the number of values; rows past it are zeroed.  Decimal,
    interval and fixed-size binary values are (n, W) 32-bit words or
    Python values (ints or Decimals, tuples, bytes; None for 0).  uint64
    values (numpy or torch) are kept as their bits in int64."""
    bits = _as_u64_bits(values)
    if bits is not None:
        values, dtype = bits, dtype or st.uint64
    if dtype is not None and st.words_per_row(dtype) is not None:
        t = _words(values, dtype, device)
    else:
        t = _tensor(values, device)
    if dtype is None:
        dtype = st.from_torch(t.dtype)
    if t.dim() == 1:
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
    values_col = from_pylist(values_list, dtype.value, device=device)
    order = np.argsort(np.asarray(values_list, dtype=object), kind="stable")
    ranks = np.zeros(values_col.capacity, dtype=np.int32)
    ranks[:len(values_list)][order] = np.arange(len(values_list),
                                                dtype=np.int32)
    return DictionaryColumn(keys_col, values_col,
                            torch.from_numpy(ranks).to(keys_col.device), dtype)


def _set_length(c: Column, n: int) -> Column:
    """`c` cut to length n <= its length: rows past n were built as nulls
    (zeros), so only the length changes, and a bitmap goes when rows
    [0, n) are all valid."""
    if isinstance(c, DictionaryColumn):
        return dataclasses.replace(c, keys=_set_length(c.keys, n))
    if isinstance(c, (NullColumn, RunEndColumn, UnionColumn)):
        return dataclasses.replace(c, length=n)
    validity = c.validity
    if validity is not None:
        validity = bm.clip(validity, n)
        if int(bm.count_set_bits(validity)) == n:
            validity = None
    return dataclasses.replace(c, validity=validity, length=n)


def _host_validity(valid: np.ndarray, cap: int, device):
    return None if valid.all() else bm.from_numpy_bools(valid, cap, device)


def from_pylist(data, dtype: st.DataType = None, device=None) -> Column:
    """A column from a Python list, None for a null (the dtype inferred
    from the first value when not given)."""
    device = resolve_device(device)
    n = len(data)
    valid = np.array([x is not None for x in data], dtype=bool)
    if dtype is None:
        probe = next((x for x in data if x is not None), None)
        if probe is None:
            return null_column(n, device)
        dtype = _infer_dtype(probe)
    if isinstance(dtype, st.Null):
        return null_column(n, device)
    if isinstance(dtype, (st.List, st.Map)):
        return list_view(data, dtype, device)
    if isinstance(dtype, st.Struct):
        return struct_column(data, dtype, device)
    if isinstance(dtype, st.FixedSizeList):
        return fixed_size_list(data, dtype, device)
    if isinstance(dtype, st.Boolean):
        vals = np.array([bool(x) if x is not None else False for x in data],
                        bool)
        return boolean(vals, validity=None if valid.all() else valid,
                       device=device)
    if isinstance(dtype, (st.Utf8, st.Binary)):
        return string_view(data, dtype, device)
    if isinstance(dtype, st.Dictionary):
        return dictionary_encode_host(data, dtype, device)
    if st.words_per_row(dtype) is not None:
        return primitive(list(data), dtype,
                         validity=None if valid.all() else valid,
                         length=n, device=device)
    vals = np.array([x if x is not None else 0 for x in data],
                    dtype=numpy_dtype(dtype))
    return primitive(vals, dtype, validity=None if valid.all() else valid,
                     device=device)


def _infer_dtype(probe) -> st.DataType:
    if isinstance(probe, bool):
        return st.bool_
    if isinstance(probe, int):
        return st.int64
    if isinstance(probe, float):
        return st.float64
    if isinstance(probe, str):
        return st.utf8
    if isinstance(probe, bytes):
        return st.binary
    if isinstance(probe, dict):
        return st.Struct(tuple(st.Field(k, _infer_dtype(v))
                               for k, v in probe.items()))
    if isinstance(probe, (list, tuple)):
        inner = next((x for x in probe if x is not None), None)
        return st.List(_infer_dtype(inner) if inner is not None else st.int64)
    raise st.InvalidArgumentError(f"cannot infer dtype from {type(probe)}")


def list_view(data, dtype: st.DataType = None, device=None) -> ListViewColumn:
    """A list view from Python lists (None for a null row); a Map's rows
    are lists of (key, value) pairs or dicts."""
    device = resolve_device(device)
    n = len(data)
    cap = round_up(max(n, 1))
    starts = np.zeros(cap, dtype=np.int32)
    sizes = np.zeros(cap, dtype=np.int32)
    valid = np.zeros(n, dtype=bool)
    flat = []
    is_map = isinstance(dtype, st.Map)
    for i, row in enumerate(data):
        if row is None:
            continue
        valid[i] = True
        starts[i] = len(flat)
        if is_map:
            pairs = row.items() if isinstance(row, dict) else row
            items = [{"key": k, "value": v} for k, v in pairs]
        else:
            items = list(row)
        sizes[i] = len(items)
        flat.extend(items)
    if dtype is None:
        probe = next((x for x in flat if x is not None), None)
        dtype = st.List(_infer_dtype(probe) if probe is not None
                        else st.int64)
    child = from_pylist(flat, dtype.entry_struct if is_map else dtype.value,
                        device)
    return ListViewColumn(torch.from_numpy(starts).to(device),
                          torch.from_numpy(sizes).to(device), child,
                          _host_validity(valid, cap, device), n, dtype)


def struct_column(data, dtype: st.Struct = None, device=None) -> StructColumn:
    """A struct from Python dicts (None for a null row, whose children get
    null rows)."""
    device = resolve_device(device)
    n = len(data)
    cap = round_up(max(n, 1))
    valid = np.array([x is not None for x in data], bool)
    if dtype is None:
        probe = next((x for x in data if x is not None), {})
        dtype = st.Struct(tuple(
            st.Field(k, _infer_dtype(v) if v is not None else st.int64)
            for k, v in probe.items()))
    children = tuple(
        from_pylist([None if row is None else row.get(f.name)
                     for row in data], f.dtype, device)
        for f in dtype.fields)
    return StructColumn(children, _host_validity(valid, cap, device), n,
                        dtype)


def fixed_size_list(data, dtype: st.FixedSizeList = None,
                    device=None) -> FixedSizeListColumn:
    """A fixed-size list from Python lists of `size` items (None for a null
    row, whose items are null)."""
    device = resolve_device(device)
    n = len(data)
    cap = round_up(max(n, 1))
    if dtype is None:
        probe = next((x for x in data if x is not None), None)
        dtype = st.FixedSizeList(_infer_dtype(probe[0]) if probe
                                 else st.int64, len(probe) if probe else 1)
    size = dtype.size
    valid = np.array([x is not None for x in data], bool)
    flat = []
    for row in data:
        if row is None:
            flat.extend([None] * size)
            continue
        if len(row) != size:
            raise st.InvalidArgumentError(
                f"fixed_size_list: row has {len(row)} items, expected {size}")
        flat.extend(row)
    # the child's capacity is the list's times size: its rows past
    # length * size are built as nulls, then cut off by the length
    child = from_pylist(flat + [None] * ((cap - n) * size), dtype.value,
                        device)
    return FixedSizeListColumn(_set_length(child, n * size),
                               _host_validity(valid, cap, device), n, dtype)


def run_end_encoded(run_ends, values: Column, length=None,
                    dtype: st.RunEndEncoded = None) -> RunEndColumn:
    """A run-end column from cumulative run ends (positive, strictly
    increasing; the last is the logical length) and one value a run, on
    the values' device."""
    ends = np.asarray(run_ends, dtype=np.int32)
    n_runs = ends.shape[0]
    if n_runs and (np.any(np.diff(ends) <= 0) or ends[0] <= 0):
        raise st.InvalidArgumentError(
            "run_ends must be positive and strictly increasing")
    logical_n = int(ends[-1]) if n_runs else 0
    cap = round_up(max(n_runs, 1))
    padded = np.full(cap, max(logical_n, 1), dtype=np.int32)
    padded[:n_runs] = ends
    if dtype is None:
        dtype = st.RunEndEncoded(st.int32, values.dtype)
    return RunEndColumn(torch.from_numpy(padded).to(values.device), values,
                        logical_n if length is None else int(length), dtype)


def run_end_from_pylist(data, value_dtype: st.DataType = None,
                        device=None) -> RunEndColumn:
    """Run-length compress a Python list."""
    ends, vals = [], []
    for i, x in enumerate(data):
        if vals and x == vals[-1] and (x is None) == (vals[-1] is None):
            ends[-1] = i + 1
        else:
            vals.append(x)
            ends.append(i + 1)
    return run_end_encoded(np.asarray(ends, np.int32),
                           from_pylist(vals, value_dtype, device))


def union_column(type_id_arr, children, dtype: st.Union, offsets=None,
                 length=None, device=None) -> UnionColumn:
    """A union from a type code a row, its children and (dense mode only)
    an offset a row into its child."""
    device = resolve_device(device)
    tids = np.asarray(type_id_arr, dtype=np.int32)
    n = tids.shape[0]
    cap = round_up(max(n, 1))
    tids = np.pad(tids, (0, cap - n))
    offs = None
    if dtype.mode == "dense":
        if offsets is None:
            raise st.InvalidArgumentError("dense union requires offsets")
        o = np.asarray(offsets, dtype=np.int32)
        offs = torch.from_numpy(np.pad(o, (0, cap - o.shape[0]))).to(device)
    elif offsets is not None:
        raise st.InvalidArgumentError("sparse union must not have offsets")
    return UnionColumn(torch.from_numpy(tids).to(device), offs,
                       tuple(children), n if length is None else int(length),
                       dtype)
