"""Avro: Object Container Files, the single-object and Confluent framings,
schema JSON, the binary encoding and reader-schema resolution.

Counterpart of `arrowtpu/formats/avro.py`, after arrow-rs's arrow-avro
crate (lib.rs:57-67 names the three framings; reader/record.rs decodes
and resolves; schema.rs, codec.rs and compression.rs):

  * types: null, boolean, int, long, float, double, bytes, string,
    record, array, map, union(["null", T]), fixed, enum (a dictionary)
    and the logical types date, timestamp-millis / -micros and decimal;
  * codecs: null, deflate, snappy (with its CRC32), bzip2, xz, and
    zstandard where the `zstandard` module is installed (imported inside
    the calls that need it, like snappy);
  * an OCF's blocks decode natively, flat records by
    `native/src/avroblock.cpp` and nested ones by `avronest.cpp`, built
    with g++ at their first use (`native.load`; a failed build raises
    `native.NativeBuildError`, where the JAX package falls back to its
    per-row Python decoder).  Schemas those decoders do not take (a
    decimal, a general union) and reader-schema resolution go through
    the per-row decoder, as in the JAX package;
  * the single-object encoding (C3 01 and the CRC-64-AVRO fingerprint of
    the schema's Parsing Canonical Form) and Confluent's wire format.

Decoding is host work; each decoded column reaches its device (the card
unless the caller passes `device="cpu"`) with one copy a buffer.  Every
column of a read has the rows' capacity, so a batch needs no regrowth.

One departure from the JAX package (ROADMAP C.3, fault 19): a uint64
value of 2**63 or more is written as its int64 bits, as a uint32 value
already is as its int32 bits, so it reads back as the long those bits
are; the JAX writer zigzags the unsigned value and reads back another
number.  Every other value is written to the same bytes.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import schema as st
from ..config import resolve_device, round_up
from ..core import batch as bt
from ..core import bitmap as bm
from ..core import column as col

MAGIC = b"Obj\x01"
SINGLE_OBJECT_MAGIC = b"\xc3\x01"
_U64 = 1 << 64


# ---------------------------------------------------------------------------
# binary primitives (the spec's zigzag varint longs, little-endian floats)
# ---------------------------------------------------------------------------


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _unzigzag(u: int) -> int:
    return (u >> 1) ^ -(u & 1)


def write_long(out: bytearray, n: int) -> None:
    n = int(n)
    if n >= 1 << 63:  # a uint64 value: its int64 bits (fault 19)
        n -= _U64
    u = _zigzag(n) & (_U64 - 1)
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def read_long(buf, pos: int) -> Tuple[int, int]:
    shift = 0
    acc = 0
    while True:
        b = buf[pos]
        pos += 1
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            return _unzigzag(acc), pos
        shift += 7


def write_bytes(out: bytearray, b: bytes) -> None:
    write_long(out, len(b))
    out.extend(b)


def read_bytes(buf, pos: int) -> Tuple[bytes, int]:
    n, pos = read_long(buf, pos)
    return bytes(buf[pos:pos + n]), pos + n


# ---------------------------------------------------------------------------
# Arrow <-> Avro schemas
# ---------------------------------------------------------------------------


def dtype_to_avro(dt: st.DataType) -> Any:
    if isinstance(dt, st.Null):
        return "null"
    if isinstance(dt, st.Boolean):
        return "boolean"
    if isinstance(dt, st.Int):
        return "long" if dt.bits > 32 else "int"
    if isinstance(dt, st.Float):
        return "double" if dt.bits == 64 else "float"
    if isinstance(dt, st.Utf8):
        return "string"
    if isinstance(dt, st.Binary):
        return "bytes"
    if isinstance(dt, st.Date32):
        return {"type": "int", "logicalType": "date"}
    if isinstance(dt, st.Timestamp):
        lt = "timestamp-millis" if dt.unit == "ms" else "timestamp-micros"
        return {"type": "long", "logicalType": lt}
    if st.decimal_limbs(dt) is not None:
        return {"type": "bytes", "logicalType": "decimal",
                "precision": dt.precision, "scale": dt.scale}
    if isinstance(dt, st.List):
        return {"type": "array", "items": dtype_to_avro(dt.value)}
    if isinstance(dt, st.Dictionary):
        return dtype_to_avro(dt.value)
    if isinstance(dt, st.Struct):
        return {"type": "record", "name": "rec" + str(abs(hash(dt)) % 9999),
                "fields": [{"name": f.name, "type": _nullable(f)}
                           for f in dt.fields]}
    raise st.SchemaError(f"avro: unsupported type {dt}")


def _nullable(f: st.Field) -> Any:
    t = dtype_to_avro(f.dtype)
    return ["null", t] if f.nullable else t


def schema_to_avro_json(schema: st.Schema,
                        name: str = "topLevelRecord") -> str:
    return json.dumps({"type": "record", "name": name,
                       "fields": [{"name": f.name, "type": _nullable(f)}
                                  for f in schema.fields]})


def avro_to_dtype(s: Any) -> Tuple[st.DataType, bool]:
    """An Avro schema node -> (dtype, nullable)."""
    if isinstance(s, list):  # a union
        others = [x for x in s if x != "null"]
        if len(others) != 1:
            raise st.SchemaError(f"avro: general unions unsupported: {s}")
        dt, _ = avro_to_dtype(others[0])
        return dt, True
    if isinstance(s, dict):
        lt = s.get("logicalType")
        t = s.get("type")
        if lt == "date":
            return st.Date32(), False
        if lt == "timestamp-millis":
            return st.Timestamp("ms"), False
        if lt == "timestamp-micros":
            return st.Timestamp("us"), False
        if lt == "decimal":
            prec = s.get("precision", 38)
            scale = s.get("scale", 0)
            for nl in (1, 2, 4, 8):
                if prec <= st.MAX_DECIMAL_PRECISION[nl]:
                    return st.decimal_for_limbs(nl, prec, scale), False
        if t == "array":
            dt, _ = avro_to_dtype(s["items"])
            return st.List(dt), False
        if t == "enum":
            return st.Dictionary(st.int32, st.utf8), False
        if t == "fixed":
            return st.binary, False
        if t == "record":
            fields = []
            for f in s["fields"]:
                dt, nullable = avro_to_dtype(f["type"])
                fields.append(st.Field(f["name"], dt, nullable))
            return st.Struct(tuple(fields)), False
        if t == "map":
            vdt, _ = avro_to_dtype(s["values"])
            return st.Map(st.utf8, vdt), False
        return avro_to_dtype(t)
    prim = {"null": st.null, "boolean": st.bool_, "int": st.int32,
            "long": st.int64, "float": st.float32, "double": st.float64,
            "bytes": st.binary, "string": st.utf8}
    if s in prim:
        return prim[s], False
    raise st.SchemaError(f"avro: unsupported schema {s!r}")


def avro_schema_to_arrow(s: Any) -> st.Schema:
    if not (isinstance(s, dict) and s.get("type") == "record"):
        raise st.SchemaError("avro: top-level schema must be a record")
    fields = []
    for f in s["fields"]:
        dt, nullable = avro_to_dtype(f["type"])
        fields.append(st.Field(f["name"], dt, nullable))
    return st.Schema(tuple(fields))


# ---------------------------------------------------------------------------
# values, a row at a time
# ---------------------------------------------------------------------------


def _encode_value(out: bytearray, s: Any, v: Any) -> None:
    if isinstance(s, list):
        if v is None:
            write_long(out, s.index("null"))
            return
        idx = next(i for i, x in enumerate(s) if x != "null")
        write_long(out, idx)
        _encode_value(out, s[idx], v)
        return
    if isinstance(s, dict):
        t = s.get("type")
        if s.get("logicalType") == "decimal":
            import decimal as _d

            with _d.localcontext(_d.Context(prec=80)):
                unscaled = int(_d.Decimal(v).scaleb(s.get("scale", 0))
                               .to_integral_value(rounding=_d.ROUND_HALF_UP))
            blen = max((unscaled.bit_length() + 8) // 8, 1)
            write_bytes(out, unscaled.to_bytes(blen, "big", signed=True))
            return
        if t == "array":
            if v:
                write_long(out, len(v))
                for item in v:
                    _encode_value(out, s["items"], item)
            write_long(out, 0)
            return
        if t == "map":
            if v:
                write_long(out, len(v))
                for k, item in v.items():
                    write_bytes(out, k.encode())
                    _encode_value(out, s["values"], item)
            write_long(out, 0)
            return
        if t == "record":
            for f in s["fields"]:
                _encode_value(out, f["type"], v[f["name"]])
            return
        if t == "enum":
            write_long(out, s["symbols"].index(v))
            return
        if t == "fixed":
            out.extend(v)
            return
        _encode_value(out, t, v)
        return
    if s == "null":
        return
    if s == "boolean":
        out.append(1 if v else 0)
    elif s in ("int", "long"):
        write_long(out, int(v))
    elif s == "float":
        out.extend(struct.pack("<f", float(v)))
    elif s == "double":
        out.extend(struct.pack("<d", float(v)))
    elif s == "bytes":
        write_bytes(out, bytes(v))
    elif s == "string":
        write_bytes(out, v.encode() if isinstance(v, str) else bytes(v))
    else:
        raise st.SchemaError(f"avro: cannot encode {s!r}")


def _read_blocks_of(buf, pos: int, item):
    """An array's or a map's blocks: `item(pos) -> pos` for every item."""
    while True:
        n, pos = read_long(buf, pos)
        if n == 0:
            return pos
        if n < 0:  # a block with its byte size first
            _, pos = read_long(buf, pos)
            n = -n
        for _ in range(n):
            pos = item(pos)


def _decode_value(buf, pos: int, s: Any) -> Tuple[Any, int]:
    if isinstance(s, list):
        idx, pos = read_long(buf, pos)
        branch = s[idx]
        if branch == "null":
            return None, pos
        return _decode_value(buf, pos, branch)
    if isinstance(s, dict):
        t = s.get("type")
        if s.get("logicalType") == "decimal":
            import decimal as _d

            raw, pos = read_bytes(buf, pos)
            unscaled = int.from_bytes(raw, "big", signed=True)
            with _d.localcontext(_d.Context(prec=80)):
                return _d.Decimal(unscaled).scaleb(-s.get("scale", 0)), pos
        if t == "array":
            items = []

            def item(p):
                v, p = _decode_value(buf, p, s["items"])
                items.append(v)
                return p

            return items, _read_blocks_of(buf, pos, item)
        if t == "map":
            entries = {}

            def entry(p):
                k, p = read_bytes(buf, p)
                entries[k.decode()], p = _decode_value(buf, p, s["values"])
                return p

            return entries, _read_blocks_of(buf, pos, entry)
        if t == "record":
            out = {}
            for f in s["fields"]:
                out[f["name"]], pos = _decode_value(buf, pos, f["type"])
            return out, pos
        if t == "enum":
            idx, pos = read_long(buf, pos)
            return s["symbols"][idx], pos
        if t == "fixed":
            n = s["size"]
            return bytes(buf[pos:pos + n]), pos + n
        return _decode_value(buf, pos, t)
    if s == "null":
        return None, pos
    if s == "boolean":
        return buf[pos] != 0, pos + 1
    if s in ("int", "long"):
        return read_long(buf, pos)
    if s == "float":
        return struct.unpack_from("<f", buf, pos)[0], pos + 4
    if s == "double":
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if s == "bytes":
        return read_bytes(buf, pos)
    if s == "string":
        b, pos = read_bytes(buf, pos)
        return b.decode("utf-8"), pos
    raise st.SchemaError(f"avro: cannot decode {s!r}")


def _encode_row(out: bytearray, s: dict, row: dict) -> None:
    for f in s["fields"]:
        _encode_value(out, f["type"], row[f["name"]])


def _decode_row(buf, pos: int, s: dict) -> Tuple[dict, int]:
    row = {}
    for f in s["fields"]:
        row[f["name"]], pos = _decode_value(buf, pos, f["type"])
    return row, pos


# ---------------------------------------------------------------------------
# schema resolution (reader against writer; reader/record.rs)
# ---------------------------------------------------------------------------

_PROMOTIONS = {
    ("int", "long"), ("int", "float"), ("int", "double"),
    ("long", "float"), ("long", "double"), ("float", "double"),
    ("string", "bytes"), ("bytes", "string"),
}


def _base(s):
    return s.get("type") if isinstance(s, dict) else s


def _promote(v, rt: str):
    if v is None:
        return None
    if rt in ("long", "int"):
        return int(v)
    if rt in ("float", "double"):
        return float(v)
    if rt == "string":
        return v.decode("utf-8") if isinstance(v, (bytes, bytearray)) else v
    if rt == "bytes":
        return v.encode() if isinstance(v, str) else v
    return v


def _strip_union(s):
    if isinstance(s, list):
        others = [x for x in s if x != "null"]
        return others[0] if others else "null"
    return s


def resolve_record(writer: dict, reader: dict, row: dict) -> dict:
    """One decoded writer row under the reader's schema."""
    out = {}
    wfields = {f["name"]: f for f in writer["fields"]}
    for rf in reader["fields"]:
        name = rf["name"]
        wf = wfields.get(name)
        if wf is None:
            if "default" in rf:
                out[name] = rf["default"]
                continue
            rtypes = rf["type"] if isinstance(rf["type"], list) \
                else [rf["type"]]
            if "null" in rtypes:
                out[name] = None
                continue
            raise st.SchemaError(
                f"avro: reader field {name} missing and has no default")
        wt = _base(_strip_union(wf["type"]))
        rt = _base(_strip_union(rf["type"]))
        if wt != rt and (wt, rt) not in _PROMOTIONS:
            raise st.SchemaError(f"avro: cannot resolve {wt} -> {rt} "
                                 f"for {name}")
        out[name] = _promote(row[name], rt) if wt != rt else row[name]
    return out


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------


def _compress(codec: str, data: bytes) -> bytes:
    if codec == "null":
        return data
    if codec == "deflate":  # raw deflate, no zlib header (the spec)
        c = zlib.compressobj(9, zlib.DEFLATED, -15)
        return c.compress(data) + c.flush()
    if codec == "zstandard":
        import zstandard

        return zstandard.ZstdCompressor().compress(data)
    if codec == "snappy":
        # a snappy block and the big-endian CRC32 of the uncompressed data
        from . import snappy

        return snappy.compress(data) + zlib.crc32(data).to_bytes(4, "big")
    if codec == "bzip2":
        import bz2

        return bz2.compress(data)
    if codec == "xz":
        import lzma

        return lzma.compress(data, format=lzma.FORMAT_XZ)
    raise st.ArrowTpuError(f"avro: unsupported codec {codec}")


def _decompress(codec: str, data: bytes) -> bytes:
    if codec == "null":
        return data
    if codec == "deflate":
        return zlib.decompress(data, -15)
    if codec == "zstandard":
        import zstandard

        return zstandard.ZstdDecompressor().decompress(data)
    if codec == "snappy":
        from . import snappy

        raw = snappy.decompress(data[:-4])
        if zlib.crc32(raw) & 0xFFFFFFFF != int.from_bytes(data[-4:], "big"):
            raise st.ArrowTpuError("avro: snappy block CRC mismatch")
        return raw
    if codec == "bzip2":
        import bz2

        return bz2.decompress(data)
    if codec == "xz":
        import lzma

        return lzma.decompress(data)
    raise st.ArrowTpuError(f"avro: unsupported codec {codec}")


def supported_codecs() -> List[str]:
    out = ["null", "deflate", "snappy", "bzip2", "xz"]
    try:
        import zstandard  # noqa: F401

        out.append("zstandard")
    except ImportError:
        pass
    return out


# ---------------------------------------------------------------------------
# the OCF writer (writer/mod.rs)
# ---------------------------------------------------------------------------


def ocf_header(schema_json: str, codec: str, sync: bytes) -> bytes:
    """The magic, the metadata map (avro.schema, avro.codec) and the sync
    marker."""
    meta = bytearray(MAGIC)
    write_long(meta, 2)
    write_bytes(meta, b"avro.schema")
    write_bytes(meta, schema_json.encode())
    write_bytes(meta, b"avro.codec")
    write_bytes(meta, codec.encode())
    write_long(meta, 0)
    return bytes(meta) + sync


def write_avro(batches, sink=None, *, codec: str = "null",
               block_rows: int = 64 * 1024) -> Optional[bytes]:
    """RecordBatches as an Object Container File, a block every
    `block_rows` rows of a batch, each row encoded in Python; -> the
    bytes, or None when written to `sink`."""
    if isinstance(batches, bt.RecordBatch):
        batches = [batches]
    own = sink is None
    sink = sink or io.BytesIO()
    sjson = schema_to_avro_json(batches[0].schema)
    savro = json.loads(sjson)
    sync = os.urandom(16)
    sink.write(ocf_header(sjson, codec, sync))
    for batch in batches:
        d = batch.to_pydict()
        names = list(d)
        rows = ([dict(zip(names, vals)) for vals in zip(*d.values())]
                if names else [])
        for start in range(0, len(rows), block_rows):
            chunk = rows[start:start + block_rows]
            body = bytearray()
            for row in chunk:
                _encode_row(body, savro, row)
            payload = _compress(codec, bytes(body))
            blk = bytearray()
            write_long(blk, len(chunk))
            write_long(blk, len(payload))
            sink.write(bytes(blk))
            sink.write(payload)
            sink.write(sync)
    return sink.getvalue() if own else None


# ---------------------------------------------------------------------------
# columns from the native decoders' buffers
# ---------------------------------------------------------------------------


def _validity(ok: np.ndarray):
    return None if ok.all() else ok


def _views_from_arena(arena, offs, lens, ok, n, dtype, device
                      ) -> col.StringViewColumn:
    """A string view column from a shared byte arena and each row's
    (offset, length), vectorized: a row of at most 12 bytes is inline, a
    longer one keeps its first 4 bytes and its arena offset."""
    cap = round_up(max(n, 1))
    views = np.zeros((cap, 4), np.uint32)
    lens = np.where(ok, lens, 0).astype(np.int64)
    if n:
        offs = offs.astype(np.int64)
        views[:n, 0] = lens
        pad_arena = np.concatenate([arena, np.zeros(12, np.uint8)])
        idx = np.clip(offs[:, None] + np.arange(12), 0, len(pad_arena) - 1)
        first12 = np.where(np.arange(12)[None, :] < lens[:, None],
                           pad_arena[idx], 0).astype(np.uint8)
        words = np.ascontiguousarray(first12).view("<u4").reshape(n, 3)
        inline = lens <= 12
        views[:n, 1] = words[:, 0]
        views[:n, 2] = np.where(inline, words[:, 1], 0)
        views[:n, 3] = np.where(inline, words[:, 2], offs)
    return _string_column(views, arena, ok, n, dtype, device,
                          int(lens.max()) if n else 0)


def _string_column(views, arena, ok, n, dtype, device, len_bound
                   ) -> col.StringViewColumn:
    """(cap, 4) uint32 views over `arena` -> a column on `device`, the
    arena padded to its capacity; the length bound at least 1, as the
    JAX reader keeps it."""
    arena_np = np.zeros(round_up(max(len(arena), 1)), np.uint8)
    arena_np[:len(arena)] = arena
    cap = views.shape[0]
    validity = (None if ok.all() else
                bm.from_numpy_bools(ok, cap, device))
    return col.StringViewColumn(
        torch.from_numpy(views.view(np.int32)).to(device),
        torch.from_numpy(arena_np).to(device), validity, n, dtype,
        max(len_bound, 1))


def _leaf(code: int, dtype, vals, views, ok, arena, n, device
          ) -> col.Column:
    """One primitive column from native buffers (the flat and the nested
    paths); `views` are the native (n, 4) views, with their arena offsets
    already rebased."""
    valid = _validity(ok)
    if code == 0:
        return col.null_column(n, device)
    if code == 1:
        return col.boolean(vals != 0, validity=valid, length=n,
                           device=device)
    if code in (2, 3, 12):
        return col.primitive(
            np.where(ok, vals, 0).astype(col.numpy_dtype(dtype)), dtype,
            validity=valid, length=n, device=device)
    if code == 4:
        fv = vals.astype(np.uint32).view(np.float32)
        return col.primitive(np.where(ok, fv, 0).astype(np.float32), dtype,
                             validity=valid, length=n, device=device)
    if code == 5:
        fv = vals.astype(np.uint64).view(np.float64)
        return col.primitive(np.where(ok, fv, 0.0), dtype, validity=valid,
                             length=n, device=device)
    vmat = np.zeros((round_up(max(n, 1)), 4), np.uint32)
    if n:
        vmat[:n] = np.where(ok[:, None], views, 0)
    return _string_column(vmat, arena, ok, n, dtype, device,
                          int(vals.max()) if n else 0)


_CODES = {"null": 0, "boolean": 1, "int": 2, "long": 3, "float": 4,
          "double": 5, "bytes": 6, "string": 7}
_VAR = (6, 7, 8)  # bytes, string, fixed: the codes with arena bytes


@dataclasses.dataclass
class FlatBlocks:
    """The native flat decoder's output over every block of a file: the
    field descriptors, vals / lens / valid (rows, fields) and one arena,
    the arena offsets of later blocks rebased."""

    fdesc: np.ndarray
    vals: np.ndarray
    lens: np.ndarray
    valid: np.ndarray
    arena: np.ndarray

    @property
    def rows(self) -> int:
        return self.vals.shape[0]


def decode_flat(f: "AvroFile") -> Optional[FlatBlocks]:
    """The host half of a flat read: every block through
    `native.avro_decode_block`; None when the schema is not flat."""
    from .. import native

    fdesc = f._native_fdesc()
    if fdesc is None:
        return None
    nf = fdesc.shape[0]
    var = np.isin(fdesc[:, 0], _VAR)
    parts, arenas, off = [], [], 0
    for count, body in f.iter_blocks():
        vals, lens, valid, arena, _, _ = native.avro_decode_block(
            bytes(body), count, fdesc, len(body))
        if off:  # the offsets of a later block's bytes into the one arena
            vals[:, var] += off
        parts.append((vals, lens, valid))
        arenas.append(arena)
        off += len(arena)
    if parts:
        vals, lens, valid = (np.concatenate([p[k] for p in parts])
                             for k in range(3))
        arena = np.concatenate(arenas)
    else:
        vals = lens = np.zeros((0, nf), np.int64)
        valid = np.zeros((0, nf), np.uint8)
        arena = np.zeros(0, np.uint8)
    return FlatBlocks(fdesc, vals, lens, valid.astype(bool), arena)


def upload_flat(f: "AvroFile", blocks: FlatBlocks, device
                ) -> bt.RecordBatch:
    """The device half of a flat read: one column a field, each buffer
    one host-to-device copy."""
    n = blocks.rows
    cols = []
    for j, field in enumerate(f.schema.fields):
        code = int(blocks.fdesc[j, 0])
        ok = blocks.valid[:, j]
        if code in _VAR:
            cols.append(_views_from_arena(blocks.arena, blocks.vals[:, j],
                                          blocks.lens[:, j], ok, n,
                                          field.dtype, device))
        else:
            cols.append(_leaf(code, field.dtype, blocks.vals[:, j], None,
                              ok, blocks.arena, n, device))
    return bt.RecordBatch(f.schema, tuple(cols))


# ---------------------------------------------------------------------------
# the OCF reader (reader/mod.rs)
# ---------------------------------------------------------------------------


class AvroFile:
    """A parsed OCF: its metadata, sync marker and writer schema; `read`
    decodes it onto `device` (None: the card)."""

    def __init__(self, source, device=None):
        buf = source.read() if hasattr(source, "read") else source
        if isinstance(buf, str):
            with open(buf, "rb") as fh:
                buf = fh.read()
        if buf[:4] != MAGIC:
            raise st.ArrowTpuError("not an avro OCF (bad magic)")
        self.device = resolve_device(device)
        pos = 4
        self.metadata: Dict[str, bytes] = {}
        while True:
            n, pos = read_long(buf, pos)
            if n == 0:
                break
            if n < 0:
                _, pos = read_long(buf, pos)
                n = -n
            for _ in range(n):
                k, pos = read_bytes(buf, pos)
                v, pos = read_bytes(buf, pos)
                self.metadata[k.decode()] = v
        self.sync = bytes(buf[pos:pos + 16])
        self.buf = buf
        self._blocks_start = pos + 16
        self.writer_schema = json.loads(self.metadata["avro.schema"])
        self.codec = self.metadata.get("avro.codec", b"null").decode()
        self.schema = avro_schema_to_arrow(self.writer_schema)

    def iter_blocks(self):
        """(row count, decompressed body) a block, each block's sync
        marker checked."""
        buf = self.buf
        pos = self._blocks_start
        while pos < len(buf):
            count, pos = read_long(buf, pos)
            size, pos = read_long(buf, pos)
            payload = buf[pos:pos + size]
            pos += size
            if buf[pos:pos + 16] != self.sync:
                raise st.ArrowTpuError(
                    "avro: bad sync marker (corrupt block)")
            pos += 16
            yield count, _decompress(self.codec, payload)

    def _native_fdesc(self):
        """(fields, 4) int32 [code, nullable, null branch, fixed size] for
        the flat decoder, or None when a field is not a nullable-or-not
        primitive (the nested or the per-row path)."""
        descs = []
        for f in self.writer_schema.get("fields", []):
            t = f["type"]
            nullable, null_branch = 0, 0
            if isinstance(t, list):
                if len(t) != 2 or "null" not in t:
                    return None
                null_branch = t.index("null")
                t = t[1 - null_branch]
                nullable = 1
            fixed_size = 0
            if isinstance(t, dict):
                if t.get("logicalType") == "decimal":
                    return None
                if t.get("type") == "fixed":
                    fixed_size = int(t["size"])
                    t = "fixed"
                else:
                    t = t.get("type")
            if t == "fixed":
                code = 8
            elif t in _CODES:
                code = _CODES[t]
            else:
                return None
            descs.append((code, nullable, null_branch, fixed_size))
        if not descs:
            return None
        return np.asarray(descs, np.int32)

    def _nested_desc(self):
        """The nested decoder's preorder node table (avronest.cpp) ->
        (desc int32 (nodes, 7), child index int32, info a node: its dtype,
        kind and children or enum symbols), or None when the schema needs
        the per-row decoder (a decimal, a general union)."""
        rows: list = []
        info: list = []
        child_idx: list = []

        def node(s, nullable=0, null_branch=0):
            if isinstance(s, list):
                if len(s) != 2 or "null" not in s:
                    raise ValueError("general union")
                nb = s.index("null")
                return node(s[1 - nb], 1, nb)
            idx = len(rows)
            rows.append(None)
            info.append(None)
            dt, _ = avro_to_dtype(s)
            if isinstance(s, dict):
                t = s.get("type")
                if s.get("logicalType") == "decimal":
                    raise ValueError("decimal")
                if t == "record":
                    kids = [node(f["type"]) for f in s["fields"]]
                    rows[idx] = (9, nullable, null_branch, 0, len(kids),
                                 len(child_idx), 0)
                    child_idx.extend(kids)
                    info[idx] = {"dtype": dt, "kind": "record",
                                 "children": kids}
                    return idx
                if t == "array":
                    k = node(s["items"])
                    rows[idx] = (10, nullable, null_branch, 0, 1,
                                 len(child_idx), 0)
                    child_idx.append(k)
                    info[idx] = {"dtype": dt, "kind": "array",
                                 "children": [k]}
                    return idx
                if t == "map":
                    kk = len(rows)
                    rows.append((7, 0, 0, 0, 0, 0, 0))  # the key: a string
                    info.append({"dtype": st.utf8, "kind": "leaf",
                                 "code": 7})
                    kv = node(s["values"])
                    rows[idx] = (11, nullable, null_branch, 0, 2,
                                 len(child_idx), 0)
                    child_idx.extend([kk, kv])
                    info[idx] = {"dtype": dt, "kind": "map",
                                 "children": [kk, kv]}
                    return idx
                if t == "enum":
                    rows[idx] = (12, nullable, null_branch, 0, 0, 0, 0)
                    info[idx] = {"dtype": dt, "kind": "enum",
                                 "symbols": list(s["symbols"])}
                    return idx
                if t == "fixed":
                    rows[idx] = (8, nullable, null_branch, int(s["size"]),
                                 0, 0, 0)
                    info[idx] = {"dtype": dt, "kind": "leaf", "code": 8}
                    return idx
                s = t  # a primitive with a logical type
            if s not in _CODES:
                raise ValueError(f"unsupported {s}")
            rows[idx] = (_CODES[s], nullable, null_branch, 0, 0, 0, 0)
            info[idx] = {"dtype": dt, "kind": "leaf", "code": _CODES[s]}
            return idx

        try:
            node(self.writer_schema)
        except ValueError:
            return None
        return (np.asarray(rows, np.int32),
                np.asarray(child_idx or [0], np.int32), info)

    def _read_columnar_nested(self) -> Optional[bt.RecordBatch]:
        """Every block through the nested native decoder, the nodes'
        buffers joined across blocks (the views of later blocks' long
        strings rebased into one arena), then one column a node."""
        from .. import native

        built = self._nested_desc()
        if built is None:
            return None
        desc, child_idx, info = built
        if info[0]["kind"] != "record":
            return None
        nn = desc.shape[0]
        merged = [{"vals": [], "views": [], "valid": [], "lens": []}
                  for _ in range(nn)]
        arenas = []
        arena_off = 0
        var_nodes = set(np.flatnonzero(np.isin(desc[:, 0], _VAR)).tolist())
        for count, body in self.iter_blocks():
            nodes, arena, _ = native.avro_decode_nested(
                bytes(body), count, desc, child_idx, len(body))
            for i in range(nn):
                nd = nodes[i]
                views = nd["views"]
                if arena_off and i in var_nodes and views.size:
                    views = views.copy()
                    views[:, 3] = np.where(nd["vals"] > 12,
                                           views[:, 3] + np.uint32(arena_off),
                                           views[:, 3])
                for k in ("vals", "valid", "lens"):
                    merged[i][k].append(nd[k])
                merged[i]["views"].append(views)
            arenas.append(arena)
            arena_off += len(arena)
        arena = np.concatenate(arenas) if arenas else np.zeros(0, np.uint8)
        empty = {"vals": np.zeros(0, np.int64),
                 "views": np.zeros((0, 4), np.uint32),
                 "valid": np.zeros(0, bool), "lens": np.zeros(0, np.int32)}
        for m in merged:
            for k in m:
                m[k] = np.concatenate(m[k]) if m[k] else empty[k]
        dev = self.device

        def build(i) -> col.Column:
            m, inf = merged[i], info[i]
            n = m["valid"].shape[0]
            ok = m["valid"]
            kind = inf["kind"]
            if kind == "record":
                kids = tuple(build(k) for k in inf["children"])
                return col.StructColumn(
                    kids, col._host_validity(ok, round_up(max(n, 1)), dev),
                    n, inf["dtype"])
            if kind in ("array", "map"):
                sizes = np.where(ok, m["lens"], 0).astype(np.int32)
                starts = np.zeros(n, np.int32)
                if n:
                    starts[1:] = np.cumsum(sizes[:-1])
                if kind == "array":
                    child = build(inf["children"][0])
                else:
                    keys, values = (build(k) for k in inf["children"])
                    child = col.StructColumn(
                        (keys, values), None, keys.length,
                        inf["dtype"].entry_struct)
                cap = round_up(max(n, 1))
                return col.ListViewColumn(
                    torch.from_numpy(np.pad(starts, (0, cap - n))).to(dev),
                    torch.from_numpy(np.pad(sizes, (0, cap - n))).to(dev),
                    child, col._host_validity(ok, cap, dev), n,
                    inf["dtype"])
            if kind == "enum":
                keys = col.primitive(
                    np.where(ok, m["vals"], 0).astype(np.int32), st.int32,
                    validity=_validity(ok), length=n, device=dev)
                return col.DictionaryColumn(
                    keys, col.string_view(inf["symbols"], st.utf8, dev),
                    None, inf["dtype"])
            return _leaf(inf["code"], inf["dtype"], m["vals"], m["views"],
                         ok, arena, n, dev)

        return bt.RecordBatch(self.schema, tuple(
            build(k) for k in info[0]["children"]))

    def read_rows(self, reader_schema: Optional[dict] = None) -> List[dict]:
        """Every row as a dict, decoded in Python (resolved against
        `reader_schema` when given)."""
        rows = []
        ws = self.writer_schema
        for count, body in self.iter_blocks():
            pos = 0
            for _ in range(count):
                row, pos = _decode_row(body, pos, ws)
                if reader_schema is not None:
                    row = resolve_record(ws, reader_schema, row)
                rows.append(row)
        return rows

    def read(self, reader_schema: Optional[dict] = None) -> bt.RecordBatch:
        if reader_schema is None:
            blocks = decode_flat(self)
            if blocks is not None:
                return upload_flat(self, blocks, self.device)
            out = self._read_columnar_nested()
            if out is not None:
                return out
            schema = self.schema
        else:
            schema = avro_schema_to_arrow(reader_schema)
        rows = self.read_rows(reader_schema)
        return bt.RecordBatch(schema, tuple(
            col.from_pylist([r[f.name] for r in rows], f.dtype, self.device)
            for f in schema.fields))


def read_avro(source, reader_schema: Optional[dict] = None,
              device=None) -> bt.RecordBatch:
    return AvroFile(source, device).read(reader_schema)


# ---------------------------------------------------------------------------
# the single-object and Confluent framings (lib.rs:57-67)
# ---------------------------------------------------------------------------

_CRC64_AVRO_POLY = 0xC15D213AA4D7A795


def _crc64_table():
    tbl = []
    for i in range(256):
        fp = i
        for _ in range(8):
            fp = (fp >> 1) ^ (_CRC64_AVRO_POLY & -(fp & 1))
        tbl.append(fp)
    return tbl


_TBL = _crc64_table()


def rabin_fingerprint(schema_json: str) -> int:
    """The CRC-64-AVRO fingerprint of the schema's canonical form."""
    fp = _CRC64_AVRO_POLY  # the spec's EMPTY
    for b in _parsing_canonical_form(schema_json).encode():
        fp = (fp >> 8) ^ _TBL[(fp ^ b) & 0xFF]
    return fp


_PCF_PRIMITIVES = frozenset(
    ("null", "boolean", "int", "long", "float", "double", "bytes", "string"))
_NAMED = ("record", "enum", "fixed", "error")


def _pcf_fullname(name: str, namespace, enclosing: str) -> str:
    """A dotted name is full; else the schema's own namespace, then the
    enclosing one, qualifies it."""
    if "." in name:
        return name
    ns = namespace if namespace is not None else enclosing
    return f"{ns}.{name}" if ns else name


def _parsing_canonical_form(schema_json: str) -> str:
    """The spec's Parsing Canonical Form: [PRIMITIVES] bare primitives,
    [FULLNAMES] names and name references resolved with their namespaces
    (namespace attributes dropped), [STRIP] only name / type / fields /
    symbols / items / values / size, [ORDER] in that order."""

    def canon(s, enclosing: str):
        if isinstance(s, str):
            return s if s in _PCF_PRIMITIVES else _pcf_fullname(
                s, None, enclosing)
        if isinstance(s, list):
            return [canon(x, enclosing) for x in s]
        t = s.get("type")
        if "logicalType" in s and t in ("int", "long", "bytes", "string"):
            return canon(t, enclosing)
        out = {}
        inner_ns = enclosing
        if t in _NAMED:
            fn = _pcf_fullname(s["name"], s.get("namespace"), enclosing)
            out["name"] = fn
            inner_ns = fn.rsplit(".", 1)[0] if "." in fn else ""
        out["type"] = canon(t, inner_ns) if not isinstance(t, str) or (
            t not in _NAMED + ("array", "map")
            and t not in _PCF_PRIMITIVES) else t
        if "fields" in s:
            out["fields"] = [{"name": f["name"],
                              "type": canon(f["type"], inner_ns)}
                             for f in s["fields"]]
        if "symbols" in s:
            out["symbols"] = s["symbols"]
        for k in ("items", "values"):
            if k in s:
                out[k] = canon(s[k], inner_ns)
        if "size" in s:
            out["size"] = int(s["size"])
        if set(out) == {"type"} and isinstance(out["type"], str) \
                and out["type"] in _PCF_PRIMITIVES:
            return out["type"]
        return out

    return json.dumps(canon(json.loads(schema_json), ""),
                      separators=(",", ":"))


def encode_single_object(row: dict, schema_json: str) -> bytes:
    out = bytearray(SINGLE_OBJECT_MAGIC)
    out.extend(struct.pack("<Q", rabin_fingerprint(schema_json)))
    _encode_row(out, json.loads(schema_json), row)
    return bytes(out)


def decode_single_object(buf: bytes, schema_json: str) -> dict:
    if buf[:2] != SINGLE_OBJECT_MAGIC:
        raise st.ArrowTpuError("avro: bad single-object magic")
    (fp,) = struct.unpack_from("<Q", buf, 2)
    if fp != rabin_fingerprint(schema_json):
        raise st.ArrowTpuError("avro: schema fingerprint mismatch")
    return _decode_row(buf, 10, json.loads(schema_json))[0]


def encode_confluent(row: dict, schema_json: str, schema_id: int) -> bytes:
    out = bytearray(b"\x00")
    out.extend(struct.pack(">I", schema_id))
    _encode_row(out, json.loads(schema_json), row)
    return bytes(out)


def decode_confluent(buf: bytes, schema_json: str) -> Tuple[int, dict]:
    if buf[0] != 0:
        raise st.ArrowTpuError("avro: bad confluent magic")
    (sid,) = struct.unpack_from(">I", buf, 1)
    return sid, _decode_row(buf, 5, json.loads(schema_json))[0]
