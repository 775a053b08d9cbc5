"""Arrow C Data Interface: ArrowSchema / ArrowArray in ctypes.

Counterpart of `arrowtpu/interop/cdata.py`, with its formats
(`_format_for` / `_parse_format`, `tss:<zone>` included) and its one
requirement on import (offset 0).  Export reads a column's Arrow buffers
to the host (formats/layout.py `column_to_layout`), pins them and hands
out the two structs; each struct's release callback drops its own pin,
once, and clears itself.  Import copies the producer's buffers into numpy,
builds the column on the device the caller names (None: the card),
moving every buffer there, and then calls the producer's release
callbacks.  Neither side needs pyarrow; `export_to_pyarrow` and
`import_from_pyarrow` import it when called.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import schema as st
from ..core import column as col
from ..formats.layout import Node, column_to_layout, layout_to_column


class ArrowSchema(ctypes.Structure):
    pass


class ArrowArray(ctypes.Structure):
    pass


_SCHEMA_RELEASE = ctypes.CFUNCTYPE(None, ctypes.POINTER(ArrowSchema))
_ARRAY_RELEASE = ctypes.CFUNCTYPE(None, ctypes.POINTER(ArrowArray))

ArrowSchema._fields_ = [
    ("format", ctypes.c_char_p),
    ("name", ctypes.c_char_p),
    ("metadata", ctypes.c_char_p),
    ("flags", ctypes.c_int64),
    ("n_children", ctypes.c_int64),
    ("children", ctypes.POINTER(ctypes.POINTER(ArrowSchema))),
    ("dictionary", ctypes.POINTER(ArrowSchema)),
    ("release", _SCHEMA_RELEASE),
    ("private_data", ctypes.c_void_p),
]
ArrowArray._fields_ = [
    ("length", ctypes.c_int64),
    ("null_count", ctypes.c_int64),
    ("offset", ctypes.c_int64),
    ("n_buffers", ctypes.c_int64),
    ("n_children", ctypes.c_int64),
    ("buffers", ctypes.POINTER(ctypes.c_void_p)),
    ("children", ctypes.POINTER(ctypes.POINTER(ArrowArray))),
    ("dictionary", ctypes.POINTER(ArrowArray)),
    ("release", _ARRAY_RELEASE),
    ("private_data", ctypes.c_void_p),
]

ARROW_FLAG_NULLABLE = 2

_INT_FORMATS = {(True, 8): "c", (True, 16): "s", (True, 32): "i",
                (True, 64): "l", (False, 8): "C", (False, 16): "S",
                (False, 32): "I", (False, 64): "L"}
_TS_UNITS = {"s": "s", "ms": "m", "us": "u", "ns": "n"}


def _format_for(dt: st.DataType) -> str:
    """The Arrow format string (Arrow's CDataInterface.md)."""
    if isinstance(dt, st.Null):
        return "n"
    if isinstance(dt, st.Boolean):
        return "b"
    if isinstance(dt, st.Int):
        return _INT_FORMATS[(dt.signed, dt.bits)]
    if isinstance(dt, st.Float):
        return {16: "e", 32: "f", 64: "g"}[dt.bits]
    if isinstance(dt, st.Utf8):
        return "u"
    if isinstance(dt, st.Binary):
        return "z"
    if isinstance(dt, st.Date32):
        return "tdD"
    if isinstance(dt, st.Timestamp):
        return f"ts{_TS_UNITS[dt.unit]}:{dt.tz or ''}"
    if isinstance(dt, st.List):
        return "+l"
    if isinstance(dt, st.Struct):
        return "+s"
    if isinstance(dt, st.Map):
        return "+m"
    if isinstance(dt, st.FixedSizeList):
        return f"+w:{dt.size}"
    if isinstance(dt, st.Dictionary):
        return _format_for(dt.key)
    raise st.SchemaError(f"cdata: no format for {dt}")


_SIMPLE = {"n": st.null, "b": st.bool_, "c": st.int8, "s": st.int16,
           "i": st.int32, "l": st.int64, "C": st.uint8, "S": st.uint16,
           "I": st.uint32, "L": st.uint64, "e": st.float16, "f": st.float32,
           "g": st.float64, "u": st.utf8, "z": st.binary, "U": st.utf8,
           "Z": st.binary, "tdD": st.Date32()}


def _parse_format(fmt: str) -> st.DataType:
    if fmt in _SIMPLE:
        return _SIMPLE[fmt]
    if fmt.startswith("ts"):
        unit = {"s": "s", "m": "ms", "u": "us", "n": "ns"}[fmt[2]]
        return st.Timestamp(unit, fmt[4:] or None)
    raise st.SchemaError(f"cdata: unsupported format {fmt!r}")


# keepalive registry: private_data -> what a struct's buffers live in
_EXPORTS: Dict[int, object] = {}
_NEXT = [1]


@_SCHEMA_RELEASE
def _release_schema(ptr):
    s = ptr.contents
    _EXPORTS.pop(int(s.private_data or 0), None)
    s.release = _SCHEMA_RELEASE()


@_ARRAY_RELEASE
def _release_array(ptr):
    a = ptr.contents
    _EXPORTS.pop(int(a.private_data or 0), None)
    a.release = _ARRAY_RELEASE()


def _pin(obj) -> int:
    key = _NEXT[0]
    _NEXT[0] += 1
    _EXPORTS[key] = obj
    return key


def _child_fields(dt: st.DataType) -> List[Tuple[str, st.DataType, bool]]:
    if isinstance(dt, (st.List, st.FixedSizeList)):
        return [("item", dt.value, True)]
    if isinstance(dt, st.Map):
        return [("entries", dt.entry_struct, False)]
    if isinstance(dt, st.Struct):
        return [(f.name, f.dtype, f.nullable) for f in dt.fields]
    return []


def _schema_struct(name: str, dt: st.DataType, nullable: bool,
                   keep: list) -> ArrowSchema:
    s = ArrowSchema()
    fmt, nm = _format_for(dt).encode(), name.encode()
    keep += [fmt, nm]
    s.format, s.name, s.metadata = fmt, nm, None
    s.flags = ARROW_FLAG_NULLABLE if nullable else 0
    children = _child_fields(dt)
    s.n_children = len(children)
    if children:
        arr = (ctypes.POINTER(ArrowSchema) * len(children))()
        for i, (cn, cdt, cnull) in enumerate(children):
            ch = _schema_struct(cn, cdt, cnull, keep)
            keep.append(ch)
            arr[i] = ctypes.pointer(ch)
        keep.append(arr)
        s.children = arr
    if isinstance(dt, st.Dictionary):
        d = _schema_struct("", dt.value, True, keep)
        keep.append(d)
        s.dictionary = ctypes.pointer(d)
    s.release = _release_schema
    s.private_data = None
    return s


def _array_struct(node: Node, dt: st.DataType, keep: list) -> ArrowArray:
    a = ArrowArray()
    a.length, a.null_count, a.offset = node.length, node.null_count, 0
    bufs: List[Optional[np.ndarray]] = []
    for i, b in enumerate(node.buffers):
        if i == 0 and node.null_count == 0:
            bufs.append(None)  # all valid: a NULL validity pointer
        else:
            b = np.ascontiguousarray(b)
            keep.append(b)
            bufs.append(b)
    a.n_buffers = len(bufs)
    parr = (ctypes.c_void_p * max(len(bufs), 1))()
    for i, b in enumerate(bufs):
        parr[i] = None if b is None or b.size == 0 else b.ctypes.data
    keep.append(parr)
    a.buffers = parr
    a.n_children = len(node.children)
    if node.children:
        carr = (ctypes.POINTER(ArrowArray) * len(node.children))()
        for i, (chn, (_, chdt, _)) in enumerate(zip(node.children,
                                                    _child_fields(dt))):
            ch = _array_struct(chn, chdt, keep)
            keep.append(ch)
            carr[i] = ctypes.pointer(ch)
        keep.append(carr)
        a.children = carr
    if node.dictionary is not None:
        d = _array_struct(column_to_layout(node.dictionary), dt.value, keep)
        keep.append(d)
        a.dictionary = ctypes.pointer(d)
    a.release = _release_array
    a.private_data = None
    return a


def export_column(c: col.Column, name: str = "",
                  nullable: bool = True) -> Tuple[ArrowSchema, ArrowArray]:
    """Column -> (ArrowSchema, ArrowArray).  Each struct's buffers stay
    pinned until the consumer calls that struct's release callback."""
    schema_keep: list = []
    schema = _schema_struct(name, c.dtype, nullable, schema_keep)
    schema.private_data = _pin(schema_keep)
    array_keep: list = []
    array = _array_struct(column_to_layout(c), c.dtype, array_keep)
    array.private_data = _pin(array_keep)
    return schema, array


def export_to_pyarrow(c: col.Column, name: str = ""):
    """Hand a column to pyarrow through the C interface."""
    import pyarrow as pa

    schema, array = export_column(c, name)
    return pa.Array._import_from_c(ctypes.addressof(array),
                                   ctypes.addressof(schema))


# ---------------------------------------------------------------------------
# import
# ---------------------------------------------------------------------------


def _buf_copy(ptr, nbytes: int) -> np.ndarray:
    """The producer's buffer copied into numpy (it may be released next)."""
    if not ptr or nbytes == 0:
        return np.zeros(0, np.uint8)
    return np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
        shape=(nbytes,)).copy()


def _schema_to_field(s: ArrowSchema) -> st.Field:
    fmt = s.format.decode() if s.format else ""
    name = s.name.decode() if s.name else ""
    nullable = bool(s.flags & ARROW_FLAG_NULLABLE)
    if fmt in ("+l", "+L"):
        item = _schema_to_field(s.children[0].contents)
        return st.Field(name, st.List(item.dtype), nullable)
    if fmt.startswith("+w:"):
        item = _schema_to_field(s.children[0].contents)
        return st.Field(name, st.FixedSizeList(item.dtype, int(fmt[3:])),
                        nullable)
    if fmt == "+s":
        return st.Field(name, st.Struct(tuple(
            _schema_to_field(s.children[i].contents)
            for i in range(s.n_children))), nullable)
    if fmt == "+m":
        kf, vf = _schema_to_field(s.children[0].contents).dtype.fields
        return st.Field(name, st.Map(kf.dtype, vf.dtype), nullable)
    dt = _parse_format(fmt)
    if s.dictionary:
        dt = st.Dictionary(dt, _schema_to_field(s.dictionary.contents).dtype)
    return st.Field(name, dt, nullable)


def _itemsize(dt: st.DataType) -> int:
    if isinstance(dt, (st.Int, st.Float)):
        return dt.bits // 8
    if isinstance(dt, (st.Date32, st.Time32)):
        return 4
    if isinstance(dt, (st.Timestamp, st.Date64, st.Time64, st.Duration)):
        return 8
    raise st.SchemaError(f"cdata: no itemsize for {dt}")


def _array_to_node(a: ArrowArray, dt: st.DataType, device) -> Node:
    if a.offset != 0:
        raise st.ArrowTpuError(
            "cdata import: non-zero offset unsupported (re-slice first)")
    n = int(a.length)
    vbytes = (n + 7) // 8
    ptrs = [a.buffers[i] for i in range(int(a.n_buffers))]

    def vbuf():
        return _buf_copy(ptrs[0], vbytes) if ptrs else np.zeros(0, np.uint8)

    nulls = int(a.null_count)
    if nulls < 0:  # unknown: counted from the bitmap, if there is one
        bits = vbuf()
        nulls = n - int(np.unpackbits(bits, bitorder="little")[:n].sum()) \
            if bits.size else 0
    if isinstance(dt, st.Null):
        return Node(n, n, [], [])
    if isinstance(dt, st.Boolean):
        return Node(n, nulls, [vbuf(), _buf_copy(ptrs[1], vbytes)], [])
    if isinstance(dt, st.Dictionary):
        node = Node(n, nulls, [vbuf(), _buf_copy(ptrs[1],
                                                 n * _itemsize(dt.key))], [])
        node.dictionary = layout_to_column(
            _array_to_node(a.dictionary.contents, dt.value, device),
            dt.value, device)
        return node
    if isinstance(dt, (st.Utf8, st.Binary)):
        offsets = _buf_copy(ptrs[1], (n + 1) * 4)
        data_len = int(offsets.view(np.int32)[-1]) if n else 0
        return Node(n, nulls, [vbuf(), offsets, _buf_copy(ptrs[2], data_len)],
                    [])
    if isinstance(dt, (st.List, st.Map)):
        child_dt = dt.entry_struct if isinstance(dt, st.Map) else dt.value
        return Node(n, nulls, [vbuf(), _buf_copy(ptrs[1], (n + 1) * 4)],
                    [_array_to_node(a.children[0].contents, child_dt,
                                    device)])
    if isinstance(dt, st.Struct):
        return Node(n, nulls, [vbuf()], [
            _array_to_node(a.children[i].contents, f.dtype, device)
            for i, f in enumerate(dt.fields)])
    if isinstance(dt, st.FixedSizeList):
        return Node(n, nulls, [vbuf()], [
            _array_to_node(a.children[0].contents, dt.value, device)])
    return Node(n, nulls, [vbuf(), _buf_copy(ptrs[1], n * _itemsize(dt))], [])


def import_column(array_ptr: int, schema_ptr: int, device=None
                  ) -> Tuple[col.Column, st.Field]:
    """(ArrowArray*, ArrowSchema*) addresses -> (column on `device`, None:
    the card; field).  Calls the producer's release callbacks once the
    column is built."""
    s = ctypes.cast(schema_ptr, ctypes.POINTER(ArrowSchema)).contents
    a = ctypes.cast(array_ptr, ctypes.POINTER(ArrowArray)).contents
    field = _schema_to_field(s)
    out = layout_to_column(_array_to_node(a, field.dtype, device),
                           field.dtype, device)
    if a.release:
        a.release(ctypes.pointer(a))
    if s.release:
        s.release(ctypes.pointer(s))
    return out, field


def import_from_pyarrow(pa_array, device=None) -> col.Column:
    """A pyarrow array -> column through the C interface."""
    schema, array = ArrowSchema(), ArrowArray()
    pa_array._export_to_c(ctypes.addressof(array), ctypes.addressof(schema))
    return import_column(ctypes.addressof(array), ctypes.addressof(schema),
                         device)[0]
