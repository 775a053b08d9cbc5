"""Host bridge to pyarrow.

Counterpart of `arrowtpu/interop/pyarrow_bridge.py`: types and schemas
both ways (`dtype_to_pa`, `dtype_from_pa`, `schema_to_pa`,
`schema_from_pa`) and columns and batches both ways (`to_pyarrow`,
`from_pyarrow`), buffer at a time in numpy, no Python loop over rows
(but a dictionary's value ranks, computed on the host as in the JAX
package).  The port's bitmaps are Arrow's LSB order, so validity and
boolean buffers cross as bytes; string views become offset-encoded
utf8 / binary (large_ past 2**31 - 1 bytes) through
`formats/layout.string_offsets64`, list views become offset lists.

pyarrow is imported on first use (`_require_pa`), never when this module
is imported: the port and its card runs need no pyarrow.  `from_pyarrow`
builds columns on the device it is given (None: the card).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import schema as st
from ..config import resolve_device, round_up
from ..core import batch as rb
from ..core import column as col
from ..formats.layout import (bitmap, bits_buf, grow, list_flat_indices,
                              string_offsets64, strings_from_offsets,
                              valid_bools, validity_buf)

pa = None


def _require_pa():
    global pa
    if pa is None:
        try:
            import pyarrow
        except ImportError as e:
            raise st.ArrowTpuError(
                "pyarrow is not available in this environment") from e
        pa = pyarrow
    return pa


# ---------------------------------------------------------------------------
# Type conversion
# ---------------------------------------------------------------------------


def dtype_to_pa(dt: st.DataType):
    _require_pa()
    if isinstance(dt, st.Null):
        return pa.null()
    if isinstance(dt, st.Boolean):
        return pa.bool_()
    if isinstance(dt, st.Int):
        return getattr(pa, f"{'' if dt.signed else 'u'}int{dt.bits}")()
    if isinstance(dt, st.Float):
        return {16: pa.float16(), 32: pa.float32(), 64: pa.float64()}[dt.bits]
    if isinstance(dt, st.Timestamp):
        return pa.timestamp(dt.unit, dt.tz)
    if isinstance(dt, st.Date32):
        return pa.date32()
    if isinstance(dt, st.Date64):
        return pa.date64()
    if isinstance(dt, st.Time32):
        return pa.time32(dt.unit)
    if isinstance(dt, st.Time64):
        return pa.time64(dt.unit)
    if isinstance(dt, st.Duration):
        return pa.duration(dt.unit)
    if isinstance(dt, st.Utf8):
        return pa.utf8()
    if isinstance(dt, st.Binary):
        return pa.binary()
    if isinstance(dt, st.Dictionary):
        return pa.dictionary(dtype_to_pa(dt.key), dtype_to_pa(dt.value))
    if isinstance(dt, st.Decimal128):
        return pa.decimal128(dt.precision, dt.scale)
    if isinstance(dt, st.Decimal256):
        return pa.decimal256(dt.precision, dt.scale)
    if isinstance(dt, (st.Decimal32, st.Decimal64)):
        narrow = "decimal32" if isinstance(dt, st.Decimal32) else "decimal64"
        return getattr(pa, narrow, pa.decimal128)(dt.precision, dt.scale)
    if isinstance(dt, st.FixedSizeBinary):
        return pa.binary(dt.byte_width)
    if isinstance(dt, st.Interval):
        if dt.unit == "month_day_nano":
            return pa.month_day_nano_interval()
        if dt.unit == "day_time":  # not in every pyarrow
            return pa.day_time_interval()
        return pa.month_interval()
    if isinstance(dt, st.List):
        return pa.list_(dtype_to_pa(dt.value))
    if isinstance(dt, st.FixedSizeList):
        return pa.list_(dtype_to_pa(dt.value), dt.size)
    if isinstance(dt, st.Map):
        return pa.map_(dtype_to_pa(dt.key), dtype_to_pa(dt.item))
    if isinstance(dt, st.Struct):
        return pa.struct([pa.field(f.name, dtype_to_pa(f.dtype),
                                   nullable=f.nullable) for f in dt.fields])
    raise st.SchemaError(f"no pyarrow mapping for {dt}")


def _is(t, name: str) -> bool:
    """pa.types.is_<name>(t), False where this pyarrow lacks the check."""
    check = getattr(pa.types, f"is_{name}", None)
    return check is not None and check(t)


def dtype_from_pa(t) -> st.DataType:
    _require_pa()
    if _is(t, "null"):
        return st.null
    if _is(t, "boolean"):
        return st.bool_
    if _is(t, "integer"):
        return st.Int(t.bit_width, signed=_is(t, "signed_integer"))
    if _is(t, "floating"):
        return st.Float(t.bit_width)
    if _is(t, "timestamp"):
        return st.Timestamp(t.unit, t.tz)
    if _is(t, "date32"):
        return st.Date32()
    if _is(t, "date64"):
        return st.Date64()
    if _is(t, "time32"):
        return st.Time32(t.unit)
    if _is(t, "time64"):
        return st.Time64(t.unit)
    if _is(t, "duration"):
        return st.Duration(t.unit)
    if _is(t, "string") or _is(t, "large_string") or _is(t, "string_view"):
        return st.utf8
    if _is(t, "binary") or _is(t, "large_binary") or _is(t, "binary_view"):
        return st.binary
    if _is(t, "fixed_size_binary"):
        return st.FixedSizeBinary(t.byte_width)
    if _is(t, "interval"):
        if t == pa.month_day_nano_interval():
            return st.Interval("month_day_nano")
        if t == pa.day_time_interval():
            return st.Interval("day_time")
        return st.Interval("year_month")
    if _is(t, "decimal"):
        return st.decimal_for_limbs(t.bit_width // 32, t.precision, t.scale)
    if _is(t, "dictionary"):
        return st.Dictionary(dtype_from_pa(t.index_type),
                             dtype_from_pa(t.value_type))
    if _is(t, "map"):
        return st.Map(dtype_from_pa(t.key_type), dtype_from_pa(t.item_type))
    if _is(t, "fixed_size_list"):
        return st.FixedSizeList(dtype_from_pa(t.value_type), t.list_size)
    if _is(t, "list") or _is(t, "large_list") or _is(t, "list_view"):
        return st.List(dtype_from_pa(t.value_type))
    if _is(t, "struct"):
        return st.Struct(tuple(st.Field(f.name, dtype_from_pa(f.type),
                                        f.nullable) for f in t))
    raise st.SchemaError(f"unsupported pyarrow type {t}")


def schema_to_pa(s: st.Schema):
    _require_pa()
    return pa.schema(
        [pa.field(f.name, dtype_to_pa(f.dtype), nullable=f.nullable)
         for f in s.fields],
        metadata=dict(s.metadata) or None)


def _text(x) -> str:
    return x.decode() if isinstance(x, bytes) else x


def schema_from_pa(s) -> st.Schema:
    return st.Schema(
        tuple(st.Field(f.name, dtype_from_pa(f.type), f.nullable) for f in s),
        tuple((_text(k), _text(v)) for k, v in (s.metadata or {}).items()))


# ---------------------------------------------------------------------------
# port -> pyarrow
# ---------------------------------------------------------------------------


def _validity_to_pa_buffer(c: col.Column):
    """-> (Arrow validity buffer or None, null count): the bitmap's bytes
    as they are (the same bit order)."""
    buf, nulls = validity_buf(c, c.length)
    return (pa.py_buffer(buf.tobytes()) if nulls else None), nulls


def _primitive_to_pa(c: col.PrimitiveColumn):
    n = c.length
    patype = dtype_to_pa(c.dtype)
    vals = np.ascontiguousarray(c.values[:n].cpu().numpy())
    nlimb = st.decimal_limbs(c.dtype)
    if nlimb is not None:
        # little-endian u32 limbs are Arrow's decimal bytes; a pyarrow
        # without decimal32 / 64 takes them sign-extended to 4 limbs
        want = patype.byte_width // 4
        if want > nlimb:
            ext = np.where(vals[:, -1:] < 0, np.int32(-1), np.int32(0))
            vals = np.ascontiguousarray(np.concatenate(
                [vals, np.broadcast_to(ext, (n, want - nlimb))], axis=1))
    elif isinstance(c.dtype, st.FixedSizeBinary):
        w = c.dtype.byte_width
        vals = np.ascontiguousarray(vals.view(np.uint8).reshape(n, -1)[:, :w])
    validity, nulls = _validity_to_pa_buffer(c)
    return pa.Array.from_buffers(patype, n,
                                 [validity, pa.py_buffer(vals.tobytes())],
                                 null_count=nulls)


def _boolean_to_pa(c: col.BooleanColumn):
    n = c.length
    vals = bits_buf(c.values, n)
    validity, nulls = _validity_to_pa_buffer(c)
    return pa.Array.from_buffers(pa.bool_(), n,
                                 [validity, pa.py_buffer(vals.tobytes())],
                                 null_count=nulls)


def _string_view_to_pa(c: col.StringViewColumn):
    n = c.length
    offsets, data = string_offsets64(c)
    utf8 = isinstance(c.dtype, st.Utf8)
    if offsets[-1] <= np.iinfo(np.int32).max:
        patype = pa.utf8() if utf8 else pa.binary()
        offsets = offsets.astype(np.int32)
    else:
        patype = pa.large_utf8() if utf8 else pa.large_binary()
    validity, nulls = _validity_to_pa_buffer(c)
    return pa.Array.from_buffers(
        patype, n, [validity, pa.py_buffer(offsets.tobytes()),
                    pa.py_buffer(data.tobytes())], null_count=nulls)


def _dictionary_to_pa(c: col.DictionaryColumn):
    return pa.DictionaryArray.from_arrays(_primitive_to_pa(c.keys),
                                          column_to_pa(c.values))


def _list_view_to_pa(c: col.ListViewColumn):
    """(start, size) views -> an offset list: one take of the child by
    the items in row order."""
    n = c.length
    offsets, idx = list_flat_indices(c)
    child = column_to_pa(c.child)
    flat = child.take(pa.array(idx, type=pa.int64())) if len(idx) \
        else child.slice(0, 0)
    valid = valid_bools(c)
    mask = pa.array(~valid) if not valid.all() else None
    if isinstance(c.dtype, st.Map):
        return pa.MapArray.from_arrays(pa.array(offsets), flat.field("key"),
                                       flat.field("value"), mask=mask)
    return pa.ListArray.from_arrays(pa.array(offsets), flat, mask=mask)


def _struct_to_pa(c: col.StructColumn):
    return pa.StructArray.from_arrays(
        [column_to_pa(ch) for ch in c.children],
        names=[f.name for f in c.dtype.fields],
        mask=None if c.validity is None else pa.array(~valid_bools(c)))


def _fixed_size_list_to_pa(c: col.FixedSizeListColumn):
    n, size = c.length, c.dtype.size
    child = column_to_pa(c.child)
    arr = pa.FixedSizeListArray.from_arrays(child, size)
    if c.validity is None:
        return arr
    valid = valid_bools(c)
    buf = pa.py_buffer(np.packbits(valid, bitorder="little").tobytes())
    return pa.Array.from_buffers(arr.type, n, [buf],
                                 null_count=int((~valid).sum()),
                                 children=[child])


def column_to_pa(c: col.Column):
    _require_pa()
    if isinstance(c, col.PrimitiveColumn):
        return _primitive_to_pa(c)
    if isinstance(c, col.BooleanColumn):
        return _boolean_to_pa(c)
    if isinstance(c, col.StringViewColumn):
        return _string_view_to_pa(c)
    if isinstance(c, col.DictionaryColumn):
        return _dictionary_to_pa(c)
    if isinstance(c, col.ListViewColumn):
        return _list_view_to_pa(c)
    if isinstance(c, col.StructColumn):
        return _struct_to_pa(c)
    if isinstance(c, col.FixedSizeListColumn):
        return _fixed_size_list_to_pa(c)
    if isinstance(c, col.NullColumn):
        return pa.nulls(c.length)
    raise st.SchemaError(f"cannot convert {type(c).__name__} to pyarrow")


def to_pyarrow(x):
    """Column -> pa.Array; RecordBatch -> pa.RecordBatch."""
    _require_pa()
    if isinstance(x, rb.RecordBatch):
        return pa.RecordBatch.from_arrays([column_to_pa(c) for c in x.columns],
                                          schema=schema_to_pa(x.schema))
    return column_to_pa(x)


# ---------------------------------------------------------------------------
# pyarrow -> port
# ---------------------------------------------------------------------------


def _normalize(a):
    """Chunks combined and a non-zero offset taken away, so buffer math is
    direct."""
    if isinstance(a, pa.ChunkedArray):
        a = a.combine_chunks()
    if a.offset != 0:
        a = a.take(pa.array(np.arange(len(a), dtype=np.int64)))
    return a


def _pa_valid(a):
    """The array's valid rows as bools, or None when it has no nulls."""
    if a.null_count == 0:
        return None
    n = len(a)
    raw = np.frombuffer(a.buffers()[0], dtype=np.uint8, count=(n + 7) // 8)
    return np.unpackbits(raw, bitorder="little")[:n].astype(bool)


def _raw(a, nbytes: int) -> np.ndarray:
    """The first `nbytes` of the values buffer."""
    if not nbytes:
        return np.zeros(0, np.uint8)
    return np.frombuffer(a.buffers()[1], dtype=np.uint8, count=nbytes)


def _primitive_from_pa(a, dt: st.DataType, device) -> col.PrimitiveColumn:
    n = len(a)
    ok = _pa_valid(a)
    if isinstance(dt, (st.FixedSizeBinary, st.Interval)):
        itemsize = (a.type.byte_width if isinstance(dt, st.FixedSizeBinary)
                    else a.type.bit_width // 8)
        nw = st.words_per_row(dt)
        by = _raw(a, n * itemsize).reshape(n, itemsize)
        if itemsize < nw * 4:
            by = np.concatenate(
                [by, np.zeros((n, nw * 4 - itemsize), np.uint8)], axis=1)
        words = np.ascontiguousarray(by).view("<u4").reshape(n, nw)
        return col.primitive(words.astype(np.uint32), dt, validity=ok,
                             length=n, device=device)
    itemsize = a.type.bit_width // 8
    nlimb = st.decimal_limbs(dt)
    if nlimb is not None:
        limbs = _raw(a, n * itemsize).view(np.uint32).reshape(n, nlimb).copy()
        if ok is not None:
            limbs[~ok] = 0
        return col.primitive(limbs, dt, validity=ok, device=device)
    npdt = col.numpy_dtype(dt)
    vals = _raw(a, n * itemsize).view(npdt)[:n]
    vals = vals.copy() if ok is None else np.where(ok, vals,
                                                   np.zeros(1, npdt))
    return col.primitive(vals, dt, validity=ok, device=device)


def _boolean_from_pa(a, device) -> col.BooleanColumn:
    n = len(a)
    bits = np.unpackbits(_raw(a, (n + 7) // 8), bitorder="little")[:n]
    ok = _pa_valid(a)
    vals = bits.astype(bool)
    return col.boolean(vals if ok is None else vals & ok, validity=ok,
                       device=device)


def _string_from_pa(a, dt: st.DataType, device) -> col.StringViewColumn:
    n = len(a)
    large = _is(a.type, "large_string") or _is(a.type, "large_binary")
    offsets = np.frombuffer(a.buffers()[1], dtype=np.int64 if large
                            else np.int32, count=n + 1).astype(np.int64)
    buf = a.buffers()[2]
    data = (np.frombuffer(buf, dtype=np.uint8, count=int(offsets[-1]))
            if buf is not None and offsets[-1] else np.zeros(0, np.uint8))
    return strings_from_offsets(offsets, data, _pa_valid(a), dt, device)


def _dictionary_from_pa(a, dt: st.Dictionary, device) -> col.DictionaryColumn:
    keys = _primitive_from_pa(_normalize(a.indices), dt.key, device)
    values = column_from_pa(_normalize(a.dictionary), device)
    # each value's rank in the values' ascending order, nulls last
    pylist = values.to_pylist()
    order = sorted(range(len(pylist)),
                   key=lambda i: (pylist[i] is None, pylist[i]))
    ranks = np.zeros(values.capacity, dtype=np.int32)
    ranks[order] = np.arange(len(order), dtype=np.int32)
    return col.DictionaryColumn(keys, values,
                                torch.from_numpy(ranks).to(device), dt)


def _list_from_pa(a, dt, device) -> col.ListViewColumn:
    n = len(a)
    cap = round_up(max(n, 1))
    if _is(a.type, "map"):
        offsets = np.asarray(a.offsets).astype(np.int64)
        child = column_from_pa(pa.StructArray.from_arrays(
            [_normalize(a.keys), _normalize(a.items)],
            names=["key", "value"]), device)
    else:
        offsets = np.frombuffer(
            a.buffers()[1], dtype=np.int64 if _is(a.type, "large_list")
            else np.int32, count=n + 1).astype(np.int64)
        child = column_from_pa(_normalize(a.values), device)
    ok = _pa_valid(a)
    live = np.ones(n, bool) if ok is None else ok
    starts = np.zeros(cap, np.int32)
    sizes = np.zeros(cap, np.int32)
    starts[:n] = np.where(live, offsets[:-1], 0)
    sizes[:n] = np.where(live, np.diff(offsets), 0)
    return col.ListViewColumn(torch.from_numpy(starts).to(device),
                              torch.from_numpy(sizes).to(device), child,
                              bitmap(ok, cap, device), n, dt)


def _struct_from_pa(a, dt: st.Struct, device) -> col.StructColumn:
    n = len(a)
    cap = round_up(max(n, 1))
    children = tuple(grow(column_from_pa(_normalize(a.field(i)), device), cap)
                     for i in range(len(dt.fields)))
    return col.StructColumn(children, bitmap(_pa_valid(a), cap, device), n,
                            dt)


def _fixed_size_list_from_pa(a, dt: st.FixedSizeList, device
                             ) -> col.FixedSizeListColumn:
    n = len(a)
    cap = round_up(max(n, 1))
    child = grow(column_from_pa(_normalize(a.values), device), cap * dt.size)
    return col.FixedSizeListColumn(child, bitmap(_pa_valid(a), cap, device),
                                   n, dt)


def column_from_pa(a, device=None) -> col.Column:
    _require_pa()
    device = resolve_device(device)
    a = _normalize(a)
    t = a.type
    if _is(t, "string_view") or _is(t, "binary_view"):
        a = a.cast(pa.utf8() if _is(t, "string_view") else pa.binary())
        t = a.type
    if _is(t, "list_view"):
        a = a.cast(pa.list_(t.value_type))
        t = a.type
    dt = dtype_from_pa(t)
    if isinstance(dt, st.Null):
        return col.null_column(len(a), device)
    if isinstance(dt, st.Boolean):
        return _boolean_from_pa(a, device)
    if isinstance(dt, st.Dictionary):
        return _dictionary_from_pa(a, dt, device)
    if isinstance(dt, (st.Utf8, st.Binary)):
        return _string_from_pa(a, dt, device)
    if isinstance(dt, (st.List, st.Map)):
        return _list_from_pa(a, dt, device)
    if isinstance(dt, st.Struct):
        return _struct_from_pa(a, dt, device)
    if isinstance(dt, st.FixedSizeList):
        return _fixed_size_list_from_pa(a, dt, device)
    return _primitive_from_pa(a, dt, device)


def from_pyarrow(x, device=None):
    """pa.Array / ChunkedArray -> Column; pa.RecordBatch / Table ->
    RecordBatch (its columns grown to one capacity), on `device`."""
    _require_pa()
    device = resolve_device(device)
    if isinstance(x, pa.Table):
        x = x.combine_chunks()
    if isinstance(x, (pa.Table, pa.RecordBatch)):
        cols = [column_from_pa(c, device) for c in x.columns]
        cap = max((c.capacity for c in cols), default=0)
        return rb.RecordBatch(schema_from_pa(x.schema),
                              tuple(grow(c, cap) for c in cols))
    return column_from_pa(x, device)
