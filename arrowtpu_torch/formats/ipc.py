"""Arrow IPC stream and file formats, implemented from the spec.

Counterpart of `arrowtpu/formats/ipc.py`: the same bytes, written from the
port's columns and read back onto a device (None: the card; "cpu" on
request), after arrow-rs's arrow-ipc crate:

  * framing: an encapsulated message is the 0xFFFFFFFF continuation, an
    i32 metadata length, the Message flatbuffer and an 8-aligned body
    (arrow-ipc/src/lib.rs:73, writer.rs:151-152); a stream ends with an
    explicit end-of-stream marker (writer.rs:1733);
  * the file format is the ARROW1 magic, the stream, the Footer
    flatbuffer, its i32 length and the magic (FileWriter, writer.rs:1593;
    FileReader, reader.rs:1339): `FileReader.get_batch` reads any batch
    by the footer's blocks;
  * dictionaries go as DictionaryBatch messages before the first record
    batch that uses them; a dictionary that grows by appending ships only
    the new values as a delta, any other change a replacement
    (DictionaryTracker, writer.rs:1330-1362);
  * compression "lz4" (formats/lz4.py) or "zstd" (the `zstandard` module,
    imported at first use: `import arrowtpu_torch.formats.ipc` needs it
    not) frames every non-empty buffer as its 8-byte LE uncompressed
    length and the compressed bytes, or -1 and the raw bytes when they do
    not shrink (compression.rs:142);
  * the unframed message API of Flight's data plane (`encode_*_message`,
    `MessageDecoder`, arrow-flight encode.rs:269 / decode.rs);
  * the metadata through the hand-rolled flatbuffers of formats/flatbuf.py
    against format/*.fbs, with the type-union ordinals of arrow-rs's
    generated code (gen/Schema.rs:796-823).

Columns cross through `formats/layout.py`: a writer reads each buffer to
the host once (cut to the live rows) and writes it to the sink as it is; a
reader takes the buffers as views of its source (a memoryview, no copy),
builds each column on the device and grows a batch's columns to one
capacity.  `read_stream` / `read_file` with `validate=True` run
`core/validate.check_batch` on every batch (arrow-rs's IPC reader
validates its input unless told to skip it, reader.rs).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import schema as st
from ..config import resolve_device
from ..core import batch as bt
from ..core import column as col
from . import flatbuf as fb
from .layout import Node, column_to_layout, grow, layout_to_column

CONTINUATION = 0xFFFFFFFF
MAGIC = b"ARROW1"

# Type union ordinals (arrow-rs gen/Schema.rs:796)
T_NULL, T_INT, T_FLOAT, T_BINARY, T_UTF8, T_BOOL = 1, 2, 3, 4, 5, 6
T_DECIMAL, T_DATE, T_TIME, T_TIMESTAMP = 7, 8, 9, 10
T_LIST, T_STRUCT, T_UNION, T_FSB, T_FSL, T_MAP, T_DURATION = (
    12, 13, 14, 15, 16, 17, 18)
T_LARGEBIN, T_LARGEUTF8, T_LARGELIST = 19, 20, 21
# Message header union (gen/Message.rs): Schema=1, DictionaryBatch=2,
# RecordBatch=3
H_SCHEMA, H_DICT, H_BATCH = 1, 2, 3

_TIME_UNITS = ("s", "ms", "us", "ns")  # gen/Schema.rs TimeUnit


# ---------------------------------------------------------------------------
# schema flatbuffer
# ---------------------------------------------------------------------------


def _write_type(b: fb.Builder, dt: st.DataType) -> Tuple[int, int]:
    """Returns (type_type, type_offset)."""
    if isinstance(dt, st.Null):
        b.start_table()
        return T_NULL, b.end_table()
    if isinstance(dt, st.Boolean):
        b.start_table()
        return T_BOOL, b.end_table()
    if isinstance(dt, st.Int):
        b.start_table()
        b.slot_scalar(0, "i", dt.bits, 0)
        b.slot_scalar(1, "?", dt.signed, False)
        return T_INT, b.end_table()
    if isinstance(dt, st.Float):
        b.start_table()
        b.slot_scalar(0, "h", {16: 0, 32: 1, 64: 2}[dt.bits], 0)
        return T_FLOAT, b.end_table()
    if isinstance(dt, st.Utf8):
        b.start_table()
        return T_UTF8, b.end_table()
    if isinstance(dt, st.Binary):
        b.start_table()
        return T_BINARY, b.end_table()
    if isinstance(dt, st.Timestamp):
        tz = b.string(dt.tz) if dt.tz else None
        b.start_table()
        b.slot_scalar(0, "h", _TIME_UNITS.index(dt.unit), 0)
        b.slot_offset(1, tz)
        return T_TIMESTAMP, b.end_table()
    if isinstance(dt, st.Date32):
        b.start_table()
        b.slot_scalar(0, "h", 0, -1)  # DAY
        return T_DATE, b.end_table()
    if isinstance(dt, st.Date64):
        b.start_table()
        b.slot_scalar(0, "h", 1, -1)  # MILLISECOND
        return T_DATE, b.end_table()
    if isinstance(dt, (st.Time32, st.Time64)):
        bits = 32 if isinstance(dt, st.Time32) else 64
        b.start_table()
        b.slot_scalar(0, "h", _TIME_UNITS.index(dt.unit), 0)
        b.slot_scalar(1, "i", bits, 32)
        return T_TIME, b.end_table()
    if isinstance(dt, st.Duration):
        b.start_table()
        b.slot_scalar(0, "h", _TIME_UNITS.index(dt.unit), 0)
        return T_DURATION, b.end_table()
    if isinstance(dt, st.List):
        b.start_table()
        return T_LIST, b.end_table()
    if isinstance(dt, st.Struct):
        b.start_table()
        return T_STRUCT, b.end_table()
    if isinstance(dt, st.FixedSizeList):
        b.start_table()
        b.slot_scalar(0, "i", dt.size, 0)
        return T_FSL, b.end_table()
    if isinstance(dt, st.Map):
        b.start_table()
        return T_MAP, b.end_table()
    if isinstance(dt, st.Union):
        ids = dt.type_ids or tuple(range(len(dt.fields)))
        packed = b"".join(struct.pack("<i", t) for t in ids)
        idvec = b.vector_of_structs(packed, len(ids), align=4)
        b.start_table()
        b.slot_scalar(0, "h", 0 if dt.mode == "sparse" else 1, 0)
        b.slot_offset(1, idvec)
        return T_UNION, b.end_table()
    if isinstance(dt, st.Dictionary):
        return _write_type(b, dt.value)  # field type is the VALUE type
    nl = st.decimal_limbs(dt)
    if nl is not None:
        b.start_table()
        b.slot_scalar(0, "i", dt.precision, 0)
        b.slot_scalar(1, "i", dt.scale, 0)
        b.slot_scalar(2, "i", nl * 32, 128)  # bitWidth
        return T_DECIMAL, b.end_table()
    raise st.SchemaError(f"IPC: unsupported type {dt}")


def _write_field(b: fb.Builder, field: st.Field, dict_ids: Dict[str, int],
                 path: str) -> int:
    dt = field.dtype
    children: List[int] = []
    if isinstance(dt, (st.List, st.FixedSizeList)):
        children = [_write_field(b, st.Field("item", dt.value), dict_ids,
                                 path + ".item")]
    elif isinstance(dt, st.Map):
        entries = st.Field("entries", dt.entry_struct, False)
        children = [_write_field(b, entries, dict_ids, path + ".entries")]
    elif isinstance(dt, (st.Struct, st.Union)):
        children = [_write_field(b, f, dict_ids, path + "." + f.name)
                    for f in dt.fields]
    dictionary = None
    if isinstance(dt, st.Dictionary):
        did = dict_ids.setdefault(path, len(dict_ids))
        b.start_table()
        b.slot_scalar(0, "i", dt.key.bits, 0)
        b.slot_scalar(1, "?", dt.key.signed, False)
        index_type = b.end_table()
        b.start_table()
        b.slot_scalar(0, "q", did, 0)
        b.slot_offset(1, index_type)
        dictionary = b.end_table()
        if isinstance(dt.value, st.List):  # children follow the value type
            children = [_write_field(b, st.Field("item", dt.value.value),
                                     dict_ids, path + ".item")]
    name_off = b.string(field.name)
    type_type, type_off = _write_type(b, dt)
    child_vec = b.vector_of_offsets(children) if children else None
    b.start_table()
    b.slot_offset(0, name_off)
    b.slot_scalar(1, "?", field.nullable, False)
    b.slot_scalar(2, "B", type_type, 0)
    b.slot_offset(3, type_off)
    b.slot_offset(4, dictionary)
    b.slot_offset(5, child_vec)
    return b.end_table()


def _write_schema_fb(b: fb.Builder, schema: st.Schema,
                     dict_ids: Dict[str, int]) -> int:
    fields = [
        _write_field(b, f, dict_ids, f.name) for f in schema.fields
    ]
    fvec = b.vector_of_offsets(fields)
    b.start_table()
    b.slot_scalar(0, "h", 0, 0)  # endianness: little
    b.slot_offset(1, fvec)
    return b.end_table()


def _read_type(f: fb.Table) -> st.DataType:
    tt = f.scalar(2, "B", 0)
    t = f.table(3)
    if tt == T_NULL:
        return st.null
    if tt == T_BOOL:
        return st.bool_
    if tt == T_INT:
        return st.Int(t.scalar(0, "i", 0), bool(t.scalar(1, "B", 0)))
    if tt == T_FLOAT:
        return {0: st.float16, 1: st.float32,
                2: st.float64}[t.scalar(0, "h", 0)]
    if tt == T_UTF8 or tt == T_LARGEUTF8:
        return st.utf8
    if tt == T_BINARY or tt == T_LARGEBIN:
        return st.binary
    if tt == T_TIMESTAMP:
        return st.Timestamp(_TIME_UNITS[t.scalar(0, "h", 0)], t.string(1))
    if tt == T_DATE:
        return st.Date32() if t.scalar(0, "h", 0) == 0 else st.Date64()
    if tt == T_TIME:
        unit = _TIME_UNITS[t.scalar(0, "h", 0)]
        if t.scalar(1, "i", 32) == 32:
            return st.Time32(unit)
        return st.Time64(unit)
    if tt == T_DURATION:
        return st.Duration(_TIME_UNITS[t.scalar(0, "h", 0)])
    if tt in (T_LIST, T_LARGELIST):
        child = _read_field(f.vector_tables(5)[0])
        return st.List(child.dtype)
    if tt == T_STRUCT:
        return st.Struct(tuple(_read_field(cf) for cf in f.vector_tables(5)))
    if tt == T_UNION:
        fields = tuple(_read_field(cf) for cf in f.vector_tables(5))
        ids = tuple(t.vector_scalars(1, "i")) or tuple(range(len(fields)))
        mode = "sparse" if t.scalar(0, "h", 0) == 0 else "dense"
        return st.Union(fields, ids, mode)
    if tt == T_FSL:
        child = _read_field(f.vector_tables(5)[0])
        return st.FixedSizeList(child.dtype, t.scalar(0, "i", 0))
    if tt == T_MAP:
        entries = _read_field(f.vector_tables(5)[0])
        kd = entries.dtype.fields[0].dtype
        vd = entries.dtype.fields[1].dtype
        return st.Map(kd, vd)
    if tt == T_DECIMAL:
        bits = t.scalar(2, "i", 128)
        return st.decimal_for_limbs(
            bits // 32, t.scalar(0, "i", 38), t.scalar(1, "i", 0))
    raise st.SchemaError(f"IPC: unsupported type id {tt}")


def _read_field(f: fb.Table) -> st.Field:
    name = f.string(0) or ""
    nullable = bool(f.scalar(1, "B", 0))
    dt = _read_type(f)
    d = f.table(4)  # DictionaryEncoding
    if d is not None:
        idx = d.table(1)
        key = (st.Int(idx.scalar(0, "i", 32), bool(idx.scalar(1, "B", 1)))
               if idx else st.int32)
        dt = st.Dictionary(key, dt)
    return st.Field(name, dt, nullable)


def _read_schema_fb(t: fb.Table) -> st.Schema:
    return st.Schema(tuple(_read_field(f) for f in t.vector_tables(1)))


# ---------------------------------------------------------------------------
# message framing
# ---------------------------------------------------------------------------


def build_message_meta(header_type: int, build_header, body_len: int) -> bytes:
    """The Message flatbuffer alone (8-padded, unframed): the form Flight
    ships in FlightData.data_header (arrow-flight encode.rs)."""
    b = fb.Builder()
    header = build_header(b)
    b.start_table()
    b.slot_scalar(0, "h", 4, 0)  # MetadataVersion V5
    b.slot_scalar(1, "B", header_type, 0)
    b.slot_offset(2, header)
    b.slot_scalar(3, "q", body_len, 0)
    msg = b.finish(b.end_table())
    return msg + b"\0" * ((-len(msg)) % 8)


class _Body:
    """A message body as its pieces (buffers and their padding), written
    to a sink one by one; `bytes()` joins them."""

    def __init__(self):
        self.pieces: List = []
        self.size = 0

    def add(self, piece) -> int:
        """Append a piece and its padding to 8 bytes -> its offset."""
        off = self.size
        n = len(piece)
        pad = (-n) % 8
        self.pieces.append(piece)
        if pad:
            self.pieces.append(b"\0" * pad)
        self.size += n + pad
        return off

    def __bytes__(self) -> bytes:
        return b"".join(bytes(p) for p in self.pieces)


def _write_message(sink, header_type: int, build_header, body: _Body
                   ) -> Tuple[int, int]:
    """Frame one message onto the sink -> (its bytes before the body, the
    body's)."""
    meta = build_message_meta(header_type, build_header, body.size)
    sink.write(struct.pack("<Ii", CONTINUATION, len(meta)) + meta)
    for piece in body.pieces:
        sink.write(piece)
    return 8 + len(meta), body.size


def _frame(raw: np.ndarray, compression: Optional[str]):
    """One buffer as it goes into a body: the raw bytes, or (compressed)
    its 8-byte LE uncompressed length and the codec's bytes, -1 and the
    raw bytes when they do not shrink."""
    if compression is None or len(raw) == 0:
        return memoryview(np.ascontiguousarray(raw))
    data = raw.tobytes()
    if compression == "lz4":
        from . import lz4

        comp = lz4.compress(data)
    else:
        import zstandard

        comp = zstandard.ZstdCompressor().compress(data)
    if len(comp) >= len(data):
        return struct.pack("<q", -1) + data
    return struct.pack("<q", len(data)) + comp


def _batch_body_and_header(node_list: List[Node],
                           compression: Optional[str] = None):
    """Flatten nodes in preorder -> (field nodes, buffers as (offset,
    length), the body)."""
    field_nodes: List[Tuple[int, int]] = []
    buffers: List[Tuple[int, int]] = []
    body = _Body()

    def walk(n: Node):
        field_nodes.append((n.length, n.null_count))
        for buf in n.buffers:
            piece = _frame(buf, compression)
            buffers.append((body.add(piece), len(piece)))
        for ch in n.children:
            walk(ch)

    for n in node_list:
        walk(n)
    return field_nodes, buffers, body


_COMPRESSION_CODECS = {"lz4": 0, "zstd": 1}  # Schema.fbs CompressionType


def _record_batch_header(b: fb.Builder, length: int, field_nodes, buffers,
                         compression: Optional[str] = None) -> int:
    nodes_packed = b"".join(struct.pack("<qq", ln, nc)
                            for ln, nc in field_nodes)
    nodes_vec = b.vector_of_structs(nodes_packed, len(field_nodes), align=8)
    bufs_packed = b"".join(struct.pack("<qq", o, ln) for o, ln in buffers)
    bufs_vec = b.vector_of_structs(bufs_packed, len(buffers), align=8)
    bc = None
    if compression is not None:
        b.start_table()
        b.slot_scalar(0, "b", _COMPRESSION_CODECS[compression], 0)
        b.slot_scalar(1, "b", 0, 0)  # method BUFFER
        bc = b.end_table()
    b.start_table()
    b.slot_scalar(0, "q", length, 0)
    b.slot_offset(1, nodes_vec)
    b.slot_offset(2, bufs_vec)
    if bc is not None:
        b.slot_offset(3, bc)
    return b.end_table()


def _dictionary_message(did: int, values: col.Column, is_delta: bool,
                        compression: Optional[str]):
    """-> (build_header, body) of one DictionaryBatch."""
    field_nodes, buffers, body = _batch_body_and_header(
        [column_to_layout(values)], compression)

    def build(bb: fb.Builder) -> int:
        rb = _record_batch_header(bb, values.length, field_nodes, buffers,
                                  compression)
        bb.start_table()
        bb.slot_scalar(0, "q", did, 0)
        bb.slot_offset(1, rb)
        if is_delta:
            bb.slot_scalar(2, "b", 1, 0)
        return bb.end_table()

    return build, body


def _batch_message(batch: bt.RecordBatch, compression: Optional[str]):
    """-> (build_header, body) of one RecordBatch."""
    field_nodes, buffers, body = _batch_body_and_header(
        [column_to_layout(c) for c in batch.columns], compression)
    n = int(batch.length)

    def build(bb: fb.Builder) -> int:
        return _record_batch_header(bb, n, field_nodes, buffers, compression)

    return build, body


def _walk_dictionaries(batch: bt.RecordBatch, visit) -> None:
    """visit(path, dictionary column) for each dictionary column of the
    batch, nested ones included, in field order."""
    def walk(path: str, c: col.Column):
        if isinstance(c, col.DictionaryColumn):
            visit(path, c)
        elif isinstance(c, col.StructColumn):
            for f, ch in zip(c.dtype.fields, c.children):
                walk(path + "." + f.name, ch)
        elif isinstance(c, (col.ListViewColumn, col.FixedSizeListColumn)):
            walk(path + ".item", c.child)

    for f, c in zip(batch.schema.fields, batch.columns):
        walk(f.name, c)


class StreamWriter:
    """arrow-rs StreamWriter (arrow-ipc/src/writer.rs)."""

    def __init__(self, sink, schema: st.Schema, compression: str = None):
        if compression not in (None, "zstd", "lz4"):
            raise st.ArrowTpuError(
                f"IPC: unsupported compression {compression!r}")
        self.sink = sink
        self.schema = schema
        self.compression = compression
        self.dict_ids: Dict[str, int] = {}
        self._wrote_schema = False
        self._sent_values: Dict[int, list] = {}  # id -> values already sent
        self._dict_blocks: List[Tuple[int, int, int]] = []
        self._blocks: List[Tuple[int, int, int]] = []
        self._pos = 0

    def _message(self, header_type: int, build_header, body: _Body,
                 blocks: Optional[list] = None) -> None:
        meta_len, body_len = _write_message(self.sink, header_type,
                                            build_header, body)
        if blocks is not None:
            blocks.append((self._pos, meta_len, body_len))
        self._pos += meta_len + body_len

    def _ensure_schema(self):
        if self._wrote_schema:
            return
        self._message(H_SCHEMA, lambda bb: _write_schema_fb(
            bb, self.schema, self.dict_ids), _Body())
        self._wrote_schema = True

    def _write_dictionary(self, path: str, c: col.DictionaryColumn):
        did = self.dict_ids.get(path)
        if did is None:
            return
        values = c.values
        cur = values.to_pylist()
        is_delta = False
        if did in self._sent_values:
            prev = self._sent_values[did]
            if cur == prev:
                return
            if len(cur) > len(prev) and cur[:len(prev)] == prev:
                values = col.from_pylist(cur[len(prev):],
                                         self.schema_value_dtype(path),
                                         device=values.device)
                is_delta = True
        self._sent_values[did] = cur
        build, body = _dictionary_message(did, values, is_delta,
                                          self.compression)
        self._message(H_DICT, build, body, self._dict_blocks)

    def schema_value_dtype(self, path: str) -> st.DataType:
        for p, vdt in _dict_paths(self.schema).values():
            if p == path:
                return vdt
        raise st.ArrowTpuError(f"IPC: unknown dictionary path {path}")

    def write(self, batch: bt.RecordBatch):
        self._ensure_schema()
        _walk_dictionaries(batch, self._write_dictionary)
        build, body = _batch_message(batch, self.compression)
        self._message(H_BATCH, build, body, self._blocks)

    def finish(self):
        self._ensure_schema()
        self.sink.write(struct.pack("<Ii", CONTINUATION, 0))  # EOS
        self._pos += 8


class FileWriter(StreamWriter):
    """arrow-rs FileWriter (writer.rs:1593): the magic, the stream, then
    the footer with every dictionary's and batch's block."""

    def __init__(self, sink, schema: st.Schema, compression: str = None):
        super().__init__(sink, schema, compression)
        sink.write(MAGIC + b"\0\0")
        self._pos = 8

    def finish(self):
        super().finish()
        b = fb.Builder()
        schema_off = _write_schema_fb(b, self.schema, dict(self.dict_ids))

        def blocks_vec(blocks):
            packed = b"".join(struct.pack("<qi4xq", off, ml, bl)
                              for off, ml, bl in blocks)
            return b.vector_of_structs(packed, len(blocks), align=8)

        dict_vec = blocks_vec(self._dict_blocks)
        batch_vec = blocks_vec(self._blocks)
        b.start_table()
        b.slot_scalar(0, "h", 4, 0)  # version V5
        b.slot_offset(1, schema_off)
        b.slot_offset(2, dict_vec)
        b.slot_offset(3, batch_vec)
        footer = b.finish(b.end_table())
        self.sink.write(footer)
        self.sink.write(struct.pack("<i", len(footer)))
        self.sink.write(MAGIC)


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------


def _source_view(source) -> memoryview:
    """A file-like object's bytes, or bytes / bytearray / memoryview, as a
    memoryview (no copy of an in-memory source)."""
    buf = source.read() if hasattr(source, "read") else source
    return memoryview(buf).cast("B")


def _parse_message(buf, pos: int):
    """-> (header_type, header Table, body_start, body_len, next_pos), or
    None at the end-of-stream marker."""
    if pos + 8 > len(buf):
        return None
    (cont,) = struct.unpack_from("<I", buf, pos)
    if cont != CONTINUATION:  # the legacy framing, with no continuation
        (meta_len,) = struct.unpack_from("<i", buf, pos)
        meta_start = pos + 4
    else:
        (meta_len,) = struct.unpack_from("<i", buf, pos + 4)
        meta_start = pos + 8
    if meta_len == 0:
        return None
    msg = fb.Table.root(buf[meta_start:meta_start + meta_len])
    header_type = msg.scalar(1, "B", 0)
    body_len = msg.scalar(3, "q", 0)
    header_off = msg.offset(2)
    header = fb.Table(msg.buf, header_off) if header_off is not None else None
    body_start = meta_start + meta_len
    return header_type, header, body_start, body_len, body_start + body_len


def _read_batch_columns(header: fb.Table, body, schema: st.Schema,
                        dictionaries, device) -> bt.RecordBatch:
    field_nodes = [struct.unpack("<qq", s)
                   for s in header.vector_structs(1, 16)]
    buffers = [struct.unpack("<qq", s) for s in header.vector_structs(2, 16)]
    bc = header.table(3)
    codec = bc.scalar(0, "b", 0) if bc is not None else None
    state = {"node": 0, "buf": 0}

    def take_node():
        n = field_nodes[state["node"]]
        state["node"] += 1
        return n

    def take_buf():
        off, ln = buffers[state["buf"]]
        state["buf"] += 1
        if codec is None or ln == 0:
            return np.frombuffer(body, np.uint8, count=ln, offset=off)
        # framed: 8-byte LE uncompressed length (-1 = raw), then the bytes
        (ulen,) = struct.unpack_from("<q", body, off)
        payload = body[off + 8:off + ln]
        if ulen == -1:
            return np.frombuffer(payload, np.uint8)
        if codec == 1:  # ZSTD
            import zstandard

            raw = zstandard.ZstdDecompressor().decompress(
                payload, max_output_size=ulen)
        elif codec == 0:  # LZ4_FRAME
            from . import lz4

            raw = lz4.decompress(bytes(payload), expected_size=ulen)
        else:
            raise st.ArrowTpuError(f"IPC: unknown compression codec {codec}")
        return np.frombuffer(raw, np.uint8)

    def read_node(dt: st.DataType, path: str) -> Node:
        length, null_count = take_node()
        if isinstance(dt, st.Null):
            return Node(length, null_count, [], [])
        if isinstance(dt, st.Union):
            # no validity buffer: [type ids] (+ [offsets] when dense), then
            # each child in field order
            bufs = [take_buf()]
            if dt.mode == "dense":
                bufs.append(take_buf())
            children = [read_node(f.dtype, path + "." + f.name)
                        for f in dt.fields]
            return Node(length, null_count, bufs, children)
        bufs = [take_buf()]  # validity
        if isinstance(dt, st.Boolean):
            bufs.append(take_buf())
            return Node(length, null_count, bufs, [])
        if isinstance(dt, st.Dictionary):
            bufs.append(take_buf())
            return Node(length, null_count, bufs, [],
                        dictionary=dictionaries[path])
        if isinstance(dt, (st.Utf8, st.Binary)):
            bufs.append(take_buf())
            bufs.append(take_buf())
            return Node(length, null_count, bufs, [])
        if isinstance(dt, (st.List, st.Map)):
            bufs.append(take_buf())
            if isinstance(dt, st.Map):
                child = read_node(dt.entry_struct, path + ".entries")
            else:
                child = read_node(dt.value, path + ".item")
            return Node(length, null_count, bufs, [child])
        if isinstance(dt, st.Struct):
            children = [read_node(f.dtype, path + "." + f.name)
                        for f in dt.fields]
            return Node(length, null_count, bufs, children)
        if isinstance(dt, st.FixedSizeList):
            return Node(length, null_count, bufs,
                        [read_node(dt.value, path + ".item")])
        bufs.append(take_buf())  # primitives
        return Node(length, null_count, bufs, [])

    cols = [layout_to_column(read_node(f.dtype, f.name), f.dtype, device)
            for f in schema.fields]
    cap = max((c.capacity for c in cols), default=0)
    return bt.RecordBatch(schema, tuple(grow(c, cap) for c in cols))


def _dict_paths(schema: st.Schema) -> Dict[int, Tuple[str, st.DataType]]:
    """dictionary id -> (path, value dtype), ids assigned in field order
    as the writer assigns them."""
    ids: Dict[int, Tuple[str, st.DataType]] = {}

    def walk(f: st.Field, path: str):
        dt = f.dtype
        if isinstance(dt, st.Dictionary):
            ids[len(ids)] = (path, dt.value)
        elif isinstance(dt, st.Struct):
            for sf in dt.fields:
                walk(sf, path + "." + sf.name)
        elif isinstance(dt, (st.List, st.FixedSizeList)):
            walk(st.Field("item", dt.value), path + ".item")

    for f in schema.fields:
        walk(f, f.name)
    return ids


class _Dictionaries:
    """The dictionaries read so far, by path: a DictionaryBatch replaces
    its path's dictionary, or appends to it when it is a delta."""

    def __init__(self, schema: st.Schema, device):
        self.info = _dict_paths(schema)
        self.by_path: Dict[str, col.Column] = {}
        self.device = device

    def read(self, header: fb.Table, body) -> None:
        did = header.scalar(0, "q", 0)
        is_delta = bool(header.scalar(2, "b", 0))
        path, vdt = self.info[did]
        vschema = st.Schema((st.Field("values", vdt),))
        values = _read_batch_columns(header.table(1), body, vschema, {},
                                     self.device).columns[0]
        if is_delta and path in self.by_path:
            from ..ops.concat import concat

            values = concat([self.by_path[path], values])
        self.by_path[path] = values


class StreamReader:
    """arrow-rs StreamReader (reader.rs:1516): the batches of a stream, in
    order, on `device`."""

    def __init__(self, source, device=None):
        self.buf = _source_view(source)
        self.device = resolve_device(device)
        m = _parse_message(self.buf, 0)
        if m is None or m[0] != H_SCHEMA:
            raise st.ArrowTpuError("IPC stream: expected schema message")
        self.schema = _read_schema_fb(m[1])
        self.pos = m[4]
        self._dicts = _Dictionaries(self.schema, self.device)

    @property
    def dictionaries(self) -> Dict[str, col.Column]:
        return self._dicts.by_path

    def __iter__(self):
        return self

    def __next__(self) -> bt.RecordBatch:
        while True:
            m = _parse_message(self.buf, self.pos)
            if m is None:
                raise StopIteration
            header_type, header, body_start, body_len, self.pos = m
            body = self.buf[body_start:body_start + body_len]
            if header_type == H_DICT:
                self._dicts.read(header, body)
                continue
            if header_type == H_BATCH:
                return _read_batch_columns(header, body, self.schema,
                                           self.dictionaries, self.device)
            raise st.ArrowTpuError(
                f"IPC: unexpected message type {header_type}")


class FileReader:
    """arrow-rs FileReader (reader.rs:1339): the footer read first, every
    dictionary at once, then any batch by its block (`get_batch`)."""

    def __init__(self, source, device=None):
        buf = _source_view(source)
        if buf[:6] != MAGIC or buf[-6:] != MAGIC:
            raise st.ArrowTpuError("not an Arrow IPC file (bad magic)")
        self.device = resolve_device(device)
        (footer_len,) = struct.unpack_from("<i", buf, len(buf) - 10)
        footer = fb.Table.root(buf[len(buf) - 10 - footer_len:len(buf) - 10])
        self.schema = _read_schema_fb(footer.table(1))
        self.buf = buf
        self._blocks = [struct.unpack("<qi4xq", s)
                        for s in footer.vector_structs(3, 24)]
        self._dicts = _Dictionaries(self.schema, self.device)
        for s in footer.vector_structs(2, 24):
            _, header, body_start, body_len, _ = _parse_message(
                buf, struct.unpack("<qi4xq", s)[0])
            self._dicts.read(header, buf[body_start:body_start + body_len])

    @property
    def dictionaries(self) -> Dict[str, col.Column]:
        return self._dicts.by_path

    @property
    def num_batches(self) -> int:
        return len(self._blocks)

    def get_batch(self, i: int) -> bt.RecordBatch:
        _, header, body_start, body_len, _ = _parse_message(
            self.buf, self._blocks[i][0])
        return _read_batch_columns(
            header, self.buf[body_start:body_start + body_len], self.schema,
            self.dictionaries, self.device)

    def __iter__(self):
        return (self.get_batch(i) for i in range(self.num_batches))


# ---------------------------------------------------------------------------
# convenience
# ---------------------------------------------------------------------------


class Pieces(list):
    """A sink that keeps every piece written (no copy) and joins them
    once: `bytes(sink)`, or `bytearray().join(sink)` for a writable
    buffer.  A file-like sink copies each piece and regrows its buffer."""

    write = list.append

    def __bytes__(self) -> bytes:
        return b"".join(self)


def _write_all(writer_cls, batches, schema, sink, compression):
    if isinstance(batches, bt.RecordBatch):
        batches = [batches]
    if schema is None:
        schema = batches[0].schema
    own = sink is None
    if own:
        sink = Pieces()
    w = writer_cls(sink, schema, compression)
    for b in batches:
        w.write(b)
    w.finish()
    return bytes(sink) if own else None


def write_stream(batches, schema: st.Schema = None, sink=None, *,
                 compression: str = None) -> Optional[bytes]:
    """The batches as an IPC stream: bytes, or written to `sink`."""
    return _write_all(StreamWriter, batches, schema, sink, compression)


def write_file(batches, schema: st.Schema = None, sink=None, *,
               compression: str = None) -> Optional[bytes]:
    """The batches as an IPC file: bytes, or written to `sink`."""
    return _write_all(FileWriter, batches, schema, sink, compression)


def _validated(batches, validate: bool) -> List[bt.RecordBatch]:
    """The batches in a list, each checked as it is read when `validate`
    (so a bad batch raises before the rest are read)."""
    from ..core.validate import check_batch

    out = []
    for b in batches:
        if validate:
            check_batch(b)
        out.append(b)
    return out


def read_stream(source, *, validate: bool = False, device=None
                ) -> List[bt.RecordBatch]:
    """Every batch of a stream on `device`; validate=True runs the checks
    of core/validate.py on each (ValidationError names the flags set)."""
    return _validated(StreamReader(source, device), validate)


def read_file(source, *, validate: bool = False, device=None
              ) -> List[bt.RecordBatch]:
    """Every batch of a file on `device`; `validate` as `read_stream`."""
    return _validated(FileReader(source, device), validate)


# ---------------------------------------------------------------------------
# the unframed message API (Flight's data plane: header and body travel in
# separate protobuf fields, arrow-flight/src/encode.rs:269)
# ---------------------------------------------------------------------------


def encode_schema_message(schema: st.Schema, dict_ids: Dict[str, int]
                          ) -> bytes:
    return build_message_meta(
        H_SCHEMA, lambda b: _write_schema_fb(b, schema, dict_ids), 0)


def encode_batch_messages(batch: bt.RecordBatch, dict_ids: Dict[str, int],
                          sent_dicts: set) -> List[Tuple[bytes, bytes]]:
    """[(meta, body)] of the batch's dictionaries not sent yet, then of
    the record batch."""
    out: List[Tuple[bytes, bytes]] = []

    def visit(path: str, c: col.DictionaryColumn):
        did = dict_ids.get(path)
        if did is None or did in sent_dicts:
            return
        build, body = _dictionary_message(did, c.values, False, None)
        out.append((build_message_meta(H_DICT, build, body.size),
                    bytes(body)))
        sent_dicts.add(did)

    _walk_dictionaries(batch, visit)
    build, body = _batch_message(batch, None)
    out.append((build_message_meta(H_BATCH, build, body.size), bytes(body)))
    return out


class MessageDecoder:
    """Decoder over unframed (meta, body) pairs (arrow-flight decode.rs
    FlightDataDecoder), its batches on `device`."""

    def __init__(self, device=None):
        self.schema: Optional[st.Schema] = None
        self.device = resolve_device(device)
        self._dicts: Optional[_Dictionaries] = None

    @property
    def dictionaries(self) -> Dict[str, col.Column]:
        return {} if self._dicts is None else self._dicts.by_path

    def decode(self, meta: bytes, body: bytes) -> Optional[bt.RecordBatch]:
        msg = fb.Table.root(meta)
        header_type = msg.scalar(1, "B", 0)
        header_off = msg.offset(2)
        header = None if header_off is None else fb.Table(msg.buf, header_off)
        body = memoryview(body).cast("B")
        if header_type == H_SCHEMA:
            self.schema = _read_schema_fb(header)
            self._dicts = _Dictionaries(self.schema, self.device)
            return None
        if header_type == H_DICT:
            self._dicts.read(header, body)
            return None
        if header_type == H_BATCH:
            return _read_batch_columns(header, body, self.schema,
                                       self.dictionaries, self.device)
        raise st.ArrowTpuError(f"IPC: unexpected message type {header_type}")
