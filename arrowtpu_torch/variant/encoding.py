"""Variant binary encoding (parquet-format VariantEncoding.md).

Counterpart of `arrowtpu/variant/encoding.py`, the same bytes (arrow-rs's
parquet-variant crate: variant.rs `Variant`; decoder.rs basic types and
primitive type ids; the metadata header variant/metadata.rs, the object
header variant/object.rs, the list header variant/list.rs).  The byte
format is row-wise and of variable length, so encode and decode run on the
host, as in both packages and arrow-rs; the device holds the SHREDDED
form (typed columns, variant/shred.py), where columnar compute happens.

Python value mapping (decode_value returns these; encode accepts them):
  None          <-> Null
  bool          <-> BooleanTrue/False
  int           <-> Int8/16/32/64 (smallest width on encode)
  float         <-> Double
  str           <-> ShortString (< 64 bytes) / String
  bytes         <-> Binary
  decimal.Decimal      <-> Decimal4/8/16 (smallest width on encode)
  datetime.date        <-> Date
  datetime.datetime    <-> TimestampMicros (tzinfo=UTC) /
                           TimestampNtzMicros (naive)
  VariantTsNanos       <-> TimestampNanos / TimestampNtzNanos
  datetime.time        <-> Time (micros)
  uuid.UUID            <-> Uuid
  VariantFloat         <-> Float (f32; plain float encodes Double)
  dict          <-> Object (field names interned in the metadata dict)
  list          <-> Array
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import decimal as _dec
import struct
import uuid as _uuid
from typing import Any, Dict, List, Optional, Tuple

from .. import schema as st

# basic types (decoder.rs:35)
BASIC_PRIMITIVE = 0
BASIC_SHORT_STRING = 1
BASIC_OBJECT = 2
BASIC_ARRAY = 3

# primitive type ids (decoder.rs:49)
P_NULL = 0
P_TRUE = 1
P_FALSE = 2
P_INT8 = 3
P_INT16 = 4
P_INT32 = 5
P_INT64 = 6
P_DOUBLE = 7
P_DECIMAL4 = 8
P_DECIMAL8 = 9
P_DECIMAL16 = 10
P_DATE = 11
P_TS_MICROS = 12
P_TS_NTZ_MICROS = 13
P_FLOAT = 14
P_BINARY = 15
P_STRING = 16
P_TIME = 17
P_TS_NANOS = 18
P_TS_NTZ_NANOS = 19
P_UUID = 20

_EPOCH_DATE = _dt.date(1970, 1, 1)
_UTC = _dt.timezone.utc


class VariantNull:
    """Sentinel for an explicit Variant::Null VALUE (distinct from a
    null ROW at the column level — JSON `null` text maps here)."""

    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "VARIANT_NULL"


VARIANT_NULL = VariantNull()


@dataclasses.dataclass(frozen=True)
class VariantFloat:
    """A value that must encode as FLOAT (f32) rather than DOUBLE."""

    value: float


@dataclasses.dataclass(frozen=True)
class VariantTsNanos:
    """TIMESTAMP(NANOS): int64 nanoseconds since epoch; utc=False is the
    NTZ (local, not adjusted to UTC) flavor."""

    nanos: int
    utc: bool = True


def _unscaled_width(unscaled: int) -> int:
    """Smallest decimal width (4/8/16 bytes) holding the unscaled value
    at arrow-rs's precision bounds (variant/decimal.rs)."""
    if -(10**9) < unscaled < 10**9:
        return 4
    if -(10**18) < unscaled < 10**18:
        return 8
    if -(10**38) < unscaled < 10**38:
        return 16
    raise st.ArrowTpuError(f"variant: decimal out of range: {unscaled}")


def _offset_size_for(max_value: int) -> int:
    for w in (1, 2, 3):
        if max_value < (1 << (8 * w)):
            return w
    return 4


def _pack_uint(v: int, width: int) -> bytes:
    return int(v).to_bytes(width, "little")


# ---------------------------------------------------------------------------
# metadata (dictionary)
# ---------------------------------------------------------------------------


def build_metadata(field_names: List[str], sorted_strings: bool = True) -> bytes:
    """Metadata buffer: header | dict_size | offsets | utf8 bytes
    (metadata.rs:55 header layout).  When sorted_strings, names must be
    unique and are stored sorted (callers pass the sorted interned
    list)."""
    raws = [n.encode("utf-8") for n in field_names]
    total = sum(len(r) for r in raws)
    off_w = _offset_size_for(max(total, len(raws)))
    header = 0x01 | ((0x10 if sorted_strings else 0)) | ((off_w - 1) << 6)
    out = bytearray([header])
    out += _pack_uint(len(raws), off_w)
    pos = 0
    for r in raws:
        out += _pack_uint(pos, off_w)
        pos += len(r)
    out += _pack_uint(pos, off_w)
    for r in raws:
        out += r
    return bytes(out)


def parse_metadata(buf: bytes) -> Tuple[List[str], bool]:
    """-> (dictionary strings, is_sorted).  Raises on bad version."""
    if not buf:
        raise st.ArrowTpuError("variant: empty metadata")
    header = buf[0]
    version = header & 0x0F
    if version != 1:
        raise st.ArrowTpuError(f"variant: metadata version {version} != 1")
    is_sorted = bool(header & 0x10)
    off_w = (header >> 6) + 1
    p = 1
    n = int.from_bytes(buf[p:p + off_w], "little")
    p += off_w
    offs = [int.from_bytes(buf[p + i * off_w:p + (i + 1) * off_w], "little")
            for i in range(n + 1)]
    p += (n + 1) * off_w
    names = []
    for i in range(n):
        raw = buf[p + offs[i]:p + offs[i + 1]]
        names.append(raw.decode("utf-8"))
    return names, is_sorted


EMPTY_METADATA = build_metadata([])


# ---------------------------------------------------------------------------
# value encode
# ---------------------------------------------------------------------------


def _prim(ptype: int, payload: bytes = b"") -> bytes:
    return bytes([(ptype << 2) | BASIC_PRIMITIVE]) + payload


def encode_value(v: Any, field_id: Dict[str, int]) -> bytes:
    """Encode one Python value; object field names resolve through
    field_id (the metadata dictionary's name -> id map)."""
    if v is None or isinstance(v, VariantNull):
        return _prim(P_NULL)
    if isinstance(v, bool):
        return _prim(P_TRUE if v else P_FALSE)
    if isinstance(v, int):
        for ptype, fmt, lo, hi in ((P_INT8, "<b", -2**7, 2**7),
                                   (P_INT16, "<h", -2**15, 2**15),
                                   (P_INT32, "<i", -2**31, 2**31),
                                   (P_INT64, "<q", -2**63, 2**63)):
            if lo <= v < hi:
                return _prim(ptype, struct.pack(fmt, v))
        raise st.ArrowTpuError(f"variant: int out of i64 range: {v}")
    if isinstance(v, VariantFloat):
        return _prim(P_FLOAT, struct.pack("<f", v.value))
    if isinstance(v, float):
        return _prim(P_DOUBLE, struct.pack("<d", v))
    if isinstance(v, _dec.Decimal):
        sign, digits, exp = v.as_tuple()
        if not isinstance(exp, int):
            raise st.ArrowTpuError(f"variant: non-finite decimal {v}")
        unscaled = int("".join(map(str, digits))) * (-1 if sign else 1)
        scale = -exp
        if scale < 0:  # normalize 1E+2 -> unscaled 100, scale 0
            unscaled *= 10 ** (-scale)
            scale = 0
        w = _unscaled_width(unscaled)
        ptype = {4: P_DECIMAL4, 8: P_DECIMAL8, 16: P_DECIMAL16}[w]
        return _prim(ptype, bytes([scale])
                     + int(unscaled).to_bytes(w, "little", signed=True))
    if isinstance(v, _dt.datetime):
        us = _ts_micros(v)
        if v.tzinfo is None:
            return _prim(P_TS_NTZ_MICROS, struct.pack("<q", us))
        return _prim(P_TS_MICROS, struct.pack("<q", us))
    if isinstance(v, VariantTsNanos):
        return _prim(P_TS_NANOS if v.utc else P_TS_NTZ_NANOS,
                     struct.pack("<q", v.nanos))
    if isinstance(v, _dt.date):
        return _prim(P_DATE, struct.pack("<i", (v - _EPOCH_DATE).days))
    if isinstance(v, _dt.time):
        us = ((v.hour * 60 + v.minute) * 60 + v.second) * 10**6 + v.microsecond
        return _prim(P_TIME, struct.pack("<q", us))
    if isinstance(v, _uuid.UUID):
        return _prim(P_UUID, v.bytes)
    if isinstance(v, str):
        raw = v.encode("utf-8")
        if len(raw) < 64:
            return bytes([(len(raw) << 2) | BASIC_SHORT_STRING]) + raw
        return _prim(P_STRING, struct.pack("<I", len(raw)) + raw)
    if isinstance(v, (bytes, bytearray)):
        raw = bytes(v)
        return _prim(P_BINARY, struct.pack("<I", len(raw)) + raw)
    if isinstance(v, dict):
        return _encode_object(v, field_id)
    if isinstance(v, (list, tuple)):
        return _encode_array(list(v), field_id)
    raise st.ArrowTpuError(f"variant: unsupported value {type(v).__name__}")


def _ts_micros(v: _dt.datetime) -> int:
    if v.tzinfo is None:
        base = v.replace(tzinfo=_UTC)
    else:
        base = v
    delta = base - _dt.datetime(1970, 1, 1, tzinfo=_UTC)
    return (delta.days * 86400 + delta.seconds) * 10**6 + delta.microseconds


def _encode_object(obj: Dict[str, Any], field_id: Dict[str, int]) -> bytes:
    # spec: field ids sorted lexicographically by field NAME
    # (object.rs:401-402)
    items = sorted(obj.items(), key=lambda kv: kv[0])
    vals = [encode_value(v, field_id) for _, v in items]
    ids = [field_id[k] for k, _ in items]
    n = len(items)
    total = sum(len(b) for b in vals)
    id_w = _offset_size_for(max(ids, default=0))
    off_w = _offset_size_for(total)
    is_large = n > 255
    vh = (off_w - 1) | ((id_w - 1) << 2) | (0x10 if is_large else 0)
    out = bytearray([(vh << 2) | BASIC_OBJECT])
    out += _pack_uint(n, 4 if is_large else 1)
    for i in ids:
        out += _pack_uint(i, id_w)
    pos = 0
    for b in vals:
        out += _pack_uint(pos, off_w)
        pos += len(b)
    out += _pack_uint(pos, off_w)
    for b in vals:
        out += b
    return bytes(out)


def _encode_array(arr: List[Any], field_id: Dict[str, int]) -> bytes:
    vals = [encode_value(v, field_id) for v in arr]
    n = len(vals)
    total = sum(len(b) for b in vals)
    off_w = _offset_size_for(total)
    is_large = n > 255
    vh = (off_w - 1) | (0x04 if is_large else 0)
    out = bytearray([(vh << 2) | BASIC_ARRAY])
    out += _pack_uint(n, 4 if is_large else 1)
    pos = 0
    for b in vals:
        out += _pack_uint(pos, off_w)
        pos += len(b)
    out += _pack_uint(pos, off_w)
    for b in vals:
        out += b
    return bytes(out)


def collect_field_names(v: Any, into: set) -> None:
    """All object keys reachable from v (for metadata construction)."""
    if isinstance(v, dict):
        for k, sub in v.items():
            into.add(k)
            collect_field_names(sub, into)
    elif isinstance(v, (list, tuple)):
        for sub in v:
            collect_field_names(sub, into)


def encode_variant(v: Any) -> Tuple[bytes, bytes]:
    """One-shot: (metadata, value) for a single Python value."""
    names: set = set()
    collect_field_names(v, names)
    ordered = sorted(names)
    fid = {n: i for i, n in enumerate(ordered)}
    return build_metadata(ordered), encode_value(v, fid)


# ---------------------------------------------------------------------------
# value decode
# ---------------------------------------------------------------------------


def decode_value(buf: bytes, names: List[str], pos: int = 0) -> Any:
    v, _end = _decode_at(buf, names, pos)
    return v


def _decode_at(buf: bytes, names: List[str], p: int) -> Tuple[Any, int]:
    if p >= len(buf):
        raise st.ArrowTpuError("variant: truncated value")
    header = buf[p]
    basic = header & 0x03
    vh = header >> 2
    if basic == BASIC_SHORT_STRING:
        ln = vh
        raw = buf[p + 1:p + 1 + ln]
        if len(raw) != ln:
            raise st.ArrowTpuError("variant: truncated short string")
        return raw.decode("utf-8"), p + 1 + ln
    if basic == BASIC_PRIMITIVE:
        return _decode_primitive(buf, vh, p + 1)
    if basic == BASIC_OBJECT:
        off_w = (vh & 0x03) + 1
        id_w = ((vh >> 2) & 0x03) + 1
        large = bool(vh & 0x10)
        q = p + 1
        nw = 4 if large else 1
        n = int.from_bytes(buf[q:q + nw], "little")
        q += nw
        ids = [int.from_bytes(buf[q + i * id_w:q + (i + 1) * id_w], "little")
               for i in range(n)]
        q += n * id_w
        offs = [int.from_bytes(buf[q + i * off_w:q + (i + 1) * off_w],
                               "little") for i in range(n + 1)]
        q += (n + 1) * off_w
        out = {}
        for i in range(n):
            if ids[i] >= len(names):
                raise st.ArrowTpuError(
                    f"variant: field id {ids[i]} outside dictionary")
            val, _ = _decode_at(buf, names, q + offs[i])
            out[names[ids[i]]] = val
        return out, q + offs[n]
    # BASIC_ARRAY
    off_w = (vh & 0x03) + 1
    large = bool(vh & 0x04)
    q = p + 1
    nw = 4 if large else 1
    n = int.from_bytes(buf[q:q + nw], "little")
    q += nw
    offs = [int.from_bytes(buf[q + i * off_w:q + (i + 1) * off_w], "little")
            for i in range(n + 1)]
    q += (n + 1) * off_w
    out_l = []
    for i in range(n):
        val, _ = _decode_at(buf, names, q + offs[i])
        out_l.append(val)
    return out_l, q + offs[n]


def _decode_primitive(buf: bytes, ptype: int, q: int) -> Tuple[Any, int]:
    def take(n):
        raw = buf[q:q + n]
        if len(raw) != n:
            raise st.ArrowTpuError("variant: truncated primitive")
        return raw

    if ptype == P_NULL:
        return None, q
    if ptype == P_TRUE:
        return True, q
    if ptype == P_FALSE:
        return False, q
    if ptype == P_INT8:
        return struct.unpack("<b", take(1))[0], q + 1
    if ptype == P_INT16:
        return struct.unpack("<h", take(2))[0], q + 2
    if ptype == P_INT32:
        return struct.unpack("<i", take(4))[0], q + 4
    if ptype == P_INT64:
        return struct.unpack("<q", take(8))[0], q + 8
    if ptype == P_DOUBLE:
        return struct.unpack("<d", take(8))[0], q + 8
    if ptype == P_FLOAT:
        return VariantFloat(struct.unpack("<f", take(4))[0]), q + 4
    if ptype in (P_DECIMAL4, P_DECIMAL8, P_DECIMAL16):
        w = {P_DECIMAL4: 4, P_DECIMAL8: 8, P_DECIMAL16: 16}[ptype]
        raw = take(1 + w)
        scale = raw[0]
        unscaled = int.from_bytes(raw[1:], "little", signed=True)
        return _dec.Decimal(unscaled).scaleb(-scale), q + 1 + w
    if ptype == P_DATE:
        days = struct.unpack("<i", take(4))[0]
        return _EPOCH_DATE + _dt.timedelta(days=days), q + 4
    if ptype in (P_TS_MICROS, P_TS_NTZ_MICROS):
        us = struct.unpack("<q", take(8))[0]
        base = _dt.datetime(1970, 1, 1, tzinfo=_UTC) + _dt.timedelta(
            microseconds=us)
        if ptype == P_TS_NTZ_MICROS:
            base = base.replace(tzinfo=None)
        return base, q + 8
    if ptype in (P_TS_NANOS, P_TS_NTZ_NANOS):
        ns = struct.unpack("<q", take(8))[0]
        return VariantTsNanos(ns, utc=(ptype == P_TS_NANOS)), q + 8
    if ptype == P_TIME:
        us = struct.unpack("<q", take(8))[0]
        sec, micro = divmod(us, 10**6)
        mins, s = divmod(sec, 60)
        h, m = divmod(mins, 60)
        return _dt.time(int(h), int(m), int(s), int(micro)), q + 8
    if ptype == P_UUID:
        return _uuid.UUID(bytes=bytes(take(16))), q + 16
    if ptype == P_STRING:
        n = struct.unpack("<I", take(4))[0]
        raw = buf[q + 4:q + 4 + n]
        if len(raw) != n:
            raise st.ArrowTpuError("variant: truncated string")
        return raw.decode("utf-8"), q + 4 + n
    if ptype == P_BINARY:
        n = struct.unpack("<I", take(4))[0]
        raw = buf[q + 4:q + 4 + n]
        if len(raw) != n:
            raise st.ArrowTpuError("variant: truncated binary")
        return bytes(raw), q + 4 + n
    raise st.ArrowTpuError(f"variant: unknown primitive type {ptype}")


class VariantBuilder:
    """Incremental builder sharing one metadata dictionary across rows
    (arrow-rs builder.rs VariantBuilder + VariantArrayBuilder): append
    Python values, then finish() -> (metadata bytes, [value bytes])."""

    def __init__(self):
        self._rows: List[Any] = []
        self._names: set = set()

    def append(self, v: Any) -> None:
        collect_field_names(v, self._names)
        self._rows.append(v)

    def finish(self) -> Tuple[bytes, List[Optional[bytes]]]:
        ordered = sorted(self._names)
        fid = {n: i for i, n in enumerate(ordered)}
        meta = build_metadata(ordered)
        return meta, [encode_value(v, fid) for v in self._rows]
