"""arrowtpu_torch's Arrow IPC (formats/ipc.py, flatbuf.py) and its host
codecs (lz4.py with the g++-built block matcher, thrift.py, snappy.py)
against the JAX package's on the same pyarrow / numpy inputs, and against
pyarrow itself.

Tolerance: exact.  The bytes a writer produces equal the JAX writer's, for
streams and files, uncompressed and with lz4 and zstd, over the JAX
package's IPC cases (tests/test_formats.py, tests/test_lz4.py): mixed
primitives, strings and booleans; dictionaries and delta dictionaries;
nested (list, struct, fixed-size list, map) and temporal types; empty and
several batches.  Each package reads the other's bytes to the same values,
pyarrow reads the port's and the port reads pyarrow's.  The codecs' bytes
equal the JAX package's; lz4 and snappy round trips and pyarrow's lz4
frames decode to their input.
"""

import io
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest

import ipc_spans
import arrowtpu as at
from arrowtpu.formats import ipc as jipc
from arrowtpu.formats import lz4 as jlz4
from arrowtpu.formats import snappy as jsnappy
from arrowtpu.formats import thrift as jthrift
from arrowtpu.interop import pyarrow_bridge as jpb

from arrowtpu_torch import native
from arrowtpu_torch import schema as ps
from arrowtpu_torch.core import batch as pbt
from arrowtpu_torch.core import column as pcol
from arrowtpu_torch.formats import ipc as pipc
from arrowtpu_torch.formats import lz4 as plz4
from arrowtpu_torch.formats import snappy as psnappy
from arrowtpu_torch.formats import thrift as pthrift
from arrowtpu_torch.interop import pyarrow_bridge as ppb

TABLES = {
    "mixed": lambda: pa.table({
        "i": pa.array([1, None, 3, -(2**40)], pa.int64()),
        "f": pa.array([1.5, 2.0, None, -0.0], pa.float64()),
        "s": pa.array(["a", None, "a very long string into the arena", ""]),
        "b": pa.array([True, False, None, True]),
        "i32": pa.array([1, 2, 3, None], pa.int32()),
        "u8": pa.array([0, 255, None, 7], pa.uint8()),
        "dec": pa.array([1, -2, None, 10**17], pa.decimal128(20, 2))}),
    "dictionary": lambda: pa.table({
        "d": pa.array(["a", "b", "a", None, "c"]).dictionary_encode(),
        "x": pa.array([1, 2, 3, 4, 5], pa.int16())}),
    "nested": lambda: pa.table({
        "l": pa.array([[1, 2], None, [3]], pa.list_(pa.int64())),
        "st": pa.array([{"x": 1, "y": "a"}, None, {"x": 2, "y": "b"}]),
        "fl": pa.array([[1, 2], [3, 4], None], pa.list_(pa.int64(), 2)),
        "m": pa.array([[("k", 1)], None, []],
                      pa.map_(pa.utf8(), pa.int64()))}),
    "temporal": lambda: pa.table({
        "ts": pa.array([1, None, 10**15], pa.timestamp("ns", "UTC")),
        "d": pa.array([10, None, -5], pa.date32()),
        "dur": pa.array([100, None, 0], pa.duration("ms")),
        "t": pa.array([1, 2, None], pa.time32("ms")),
        "d64": pa.array([86_400_000, None, 0], pa.date64())}),
    "repetitive": lambda: pa.table({
        "a": pa.array(np.repeat(np.arange(50), 40), pa.int64()),
        "s": pa.array(["word%d" % (i % 7) for i in range(2000)])}),
}


def _pair(name):
    """The same pyarrow record batch in both packages, and itself."""
    rb = TABLES[name]().combine_chunks().to_batches()[0]
    return jpb.from_pyarrow(rb), ppb.from_pyarrow(rb, device="cpu"), rb


def _slices(rb, cuts):
    """pyarrow slices of rb at `cuts`, an empty one included."""
    edges = [0, *cuts, rb.num_rows]
    return [rb.slice(a, b - a) for a, b in zip(edges, edges[1:])]


WRITERS = ["write_stream", "write_file"]
CODECS = [None, "lz4", "zstd"]


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("name", list(TABLES))
def test_bytes_equal_the_jax_writer(name, writer, codec):
    """The same batches (two of them, the second the first again) give the
    same bytes."""
    jb, pb, _ = _pair(name)
    assert getattr(pipc, writer)([pb, pb], compression=codec) == getattr(
        jipc, writer)([jb, jb], compression=codec)


def _reader(writer):
    return "read_stream" if writer == "write_stream" else "read_file"


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("writer", WRITERS)
def test_each_package_reads_the_other(writer, codec):
    for name in TABLES:
        jb, pb, _ = _pair(name)
        for b in getattr(pipc, _reader(writer))(
                getattr(jipc, writer)([jb], compression=codec),
                validate=True, device="cpu"):
            assert b.to_pydict() == pb.to_pydict(), name
        for b in getattr(jipc, _reader(writer))(
                getattr(pipc, writer)([pb], compression=codec),
                validate=True):
            assert b.to_pydict() == jb.to_pydict(), name


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("stream", [True, False])
def test_pyarrow_reads_the_port_and_the_port_reads_pyarrow(stream, codec):
    opts = pa.ipc.IpcWriteOptions(compression=codec)
    for name in TABLES:
        _, pb, rb = _pair(name)
        data = (pipc.write_stream if stream else pipc.write_file)(
            [pb], compression=codec)
        opened = (pa.ipc.open_stream if stream else pa.ipc.open_file)(data)
        assert opened.read_all().to_batches()[0].equals(rb), name
        sink = io.BytesIO()
        new = pa.ipc.new_stream if stream else pa.ipc.new_file
        with new(sink, rb.schema, options=opts) as w:
            for part in _slices(rb, [1, 1]):
                w.write_batch(part)
        got = (pipc.read_stream if stream else pipc.read_file)(
            sink.getvalue(), validate=True, device="cpu")
        assert [b.to_pydict() for b in got] == [
            ppb.from_pyarrow(p, device="cpu").to_pydict()
            for p in _slices(rb, [1, 1])], name


def test_empty_and_multiple_batches_match_jax():
    """Batches of 2, 0 and 1 rows: the same bytes, read back in order."""
    _, _, rb = _pair("mixed")
    parts = _slices(rb, [2, 2])
    jbs = [jpb.from_pyarrow(p) for p in parts]
    pbs = [ppb.from_pyarrow(p, device="cpu") for p in parts]
    for writer in WRITERS:
        data = getattr(pipc, writer)(pbs)
        assert data == getattr(jipc, writer)(jbs)
        got = getattr(pipc, _reader(writer))(data, device="cpu")
        assert [b.length for b in got] == [2, 0, 2]
        assert [b.to_pydict() for b in got] == [b.to_pydict() for b in pbs]


def _delta_batches(mod, dictionary_encode_host):
    """Three batches of one dictionary column: the first's words, an
    appended word (a delta), then other words (a replacement)."""
    rows = [["a", "b", "a"], ["a", "b", "c", "c"], ["z", None, "y"]]
    return [mod.record_batch({"d": dictionary_encode_host(r)}) for r in rows]


def test_delta_dictionaries_match_jax_and_pyarrow():
    jbs = _delta_batches(at, at.dictionary_encode_host)
    pbs = _delta_batches(pbt, lambda r: pcol.dictionary_encode_host(
        r, device="cpu"))
    for writer, cls in ((pipc.StreamWriter, jipc.StreamWriter),
                        (pipc.FileWriter, jipc.FileWriter)):
        out = []
        for w_cls, batches in ((writer, pbs), (cls, jbs)):
            sink = io.BytesIO()
            w = w_cls(sink, batches[0].schema)
            for b in batches:
                w.write(b)
            w.finish()
            out.append(sink.getvalue())
        assert out[0] == out[1], writer.__name__
    data = pipc.write_stream(pbs)
    want = [["a", "b", "a"], ["a", "b", "c", "c"], ["z", None, "y"]]
    assert [b.to_pydict()["d"] for b in pipc.read_stream(
        data, device="cpu")] == want
    rdr = pa.ipc.open_stream(data)
    assert [rdr.read_next_batch().column("d").to_pylist()
            for _ in range(3)] == want


def test_file_reader_reads_any_batch():
    _, _, rb = _pair("repetitive")
    parts = _slices(rb, [700, 1500])
    data = pipc.write_file([ppb.from_pyarrow(p, device="cpu")
                            for p in parts])
    r = pipc.FileReader(data, device="cpu")
    assert r.num_batches == 3
    for k in (2, 0, 1):
        assert r.get_batch(k).to_pydict() == ppb.from_pyarrow(
            parts[k], device="cpu").to_pydict()


def test_message_decoder_over_encoded_messages():
    """The unframed messages equal the JAX package's, and the decoder
    rebuilds the batches from them (the dictionary sent once)."""
    jb, pb, rb = _pair("dictionary")
    jids, pids = {}, {}
    jmeta = jipc.encode_schema_message(jb.schema, jids)
    pmeta = pipc.encode_schema_message(pb.schema, pids)
    assert pmeta == jmeta and pids == jids
    dec = pipc.MessageDecoder(device="cpu")
    assert dec.decode(pmeta, b"") is None and dec.schema == pb.schema
    jsent, psent = set(), set()
    for _ in range(2):
        pmsgs = pipc.encode_batch_messages(pb, pids, psent)
        assert pmsgs == jipc.encode_batch_messages(jb, jids, jsent)
        out = [dec.decode(m, body) for m, body in pmsgs]
        assert out[:-1] == [None] * (len(pmsgs) - 1)
        assert out[-1].to_pydict() == pb.to_pydict()
    assert psent == jsent == {0}


def test_batch_buffers_point_at_each_columns_bytes():
    _, pb, rb = _pair("mixed")
    data = pipc.write_file([pb])
    (spans,) = ipc_spans.batch_buffers(data)
    assert list(spans) == rb.schema.names
    off, ln = spans["i32"][1]
    assert np.frombuffer(data[off:off + ln], np.int32)[:3].tolist() == [
        1, 2, 3]
    off, ln = spans["s"][2]
    assert data[off:off + ln] == b"aa very long string into the arena"


def test_import_needs_neither_pyarrow_nor_zstandard():
    code = """
import sys
sys.modules["pyarrow"] = None
sys.modules["zstandard"] = None
import arrowtpu_torch
from arrowtpu_torch.core import batch, column
from arrowtpu_torch.formats import ipc
b = batch.record_batch({"x": column.from_pylist([1, None, 3], device="cpu")})
for codec in (None, "lz4"):
    [back] = ipc.read_stream(ipc.write_stream(b, compression=codec),
                             device="cpu")
    assert back.to_pydict() == {"x": [1, None, 3]}
try:
    ipc.write_stream(b, compression="zstd")
except ImportError:
    print("zstd needs zstandard")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "zstd needs zstandard"


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------


def _payloads():
    rng = np.random.default_rng(2)
    return [b"", b"a", b"abcdabcdabcdabcd" * 100 + b"tail",
            np.repeat(rng.integers(0, 1000, 5_000), 5).astype(
                np.int64).tobytes(),
            rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes()]


def test_xxh32_matches_jax_and_the_spec():
    assert plz4.xxh32(b"") == 0x02CC5D05
    assert plz4.xxh32(b"Hello World") == 0xB1FD16EE
    for data in _payloads():
        for seed in (0, 1, 2**32 - 1):
            assert plz4.xxh32(data, seed) == jlz4.xxh32(data, seed)


def test_lz4_frames_match_jax_and_pyarrow():
    """compress gives the JAX package's frame (real compression on
    repetitive data, stored blocks on random bytes, small blocks too);
    each package and pyarrow decode the other's frames."""
    codec = pa.Codec("lz4")
    for data in _payloads():
        for block in (4 * 1024 * 1024, 1024):
            frame = plz4.compress(data, block)
            assert frame == jlz4.compress(data, block)
            assert plz4.decompress(frame) == data
            assert bytes(codec.decompress(frame, len(data))) == data
        theirs = codec.compress(data, asbytes=True)
        assert plz4.decompress(theirs) == data == jlz4.decompress(theirs)
    assert len(plz4.compress(_payloads()[3])) < len(_payloads()[3]) // 2


def test_lz4_linked_blocks_from_pyarrow():
    """pyarrow writes block-linked multi-block frames for large buffers:
    matches reach into earlier blocks."""
    arr = np.repeat(np.random.default_rng(4).integers(0, 1000, 400_000), 3)
    t = pa.table({"x": pa.array(arr, pa.int64())})
    sink = io.BytesIO()
    opts = pa.ipc.IpcWriteOptions(compression="lz4")
    with pa.ipc.new_stream(sink, t.schema, options=opts) as w:
        w.write_table(t)
    [b] = pipc.read_stream(sink.getvalue(), device="cpu")
    np.testing.assert_array_equal(b["x"].values[:b.length].numpy(), arr)


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """No quiet fallback: a source g++ rejects raises at the first
    compress."""
    (tmp_path / "lz4block.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", tmp_path)
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(native.NativeBuildError):
        plz4.compress(b"abcd" * 100)


def test_snappy_matches_jax():
    for data in _payloads():
        comp = psnappy.compress(data)
        assert comp == jsnappy.compress(data)
        assert psnappy.decompress(comp) == data == jsnappy.decompress(comp)
    with pytest.raises(ps.ArrowTpuError):
        psnappy.decompress(b"\x80")


def _thrift_struct(mod):
    """One struct of every compact type the Parquet metadata uses: field
    id deltas of 1-15 and a long jump, scalars, binary, a nested struct
    and lists of each element kind (20 elements: the long list header)."""
    w = mod.Writer()
    w.struct_begin()
    w.field_i16(1, -7)
    w.field_i32(2, -(2**31))
    w.field_i64(3, 2**40 + 3)
    w.field_binary(4, b"\x00\xffbytes")
    w.field_string(20, "naïve")
    w.field_bool(21, True)
    w.field_bool(22, False)
    w.field_double(23, -2.5)
    w.field_struct(24)
    w.struct_begin()
    w.field_i32(1, 99)
    w.struct_end()
    for fid, ctype, elem, values in (
            (25, mod.CT_I32, w.elem_i32, [1, -2, 3]),
            (26, mod.CT_I64, w.elem_i64, list(range(-10, 10))),
            (27, mod.CT_BINARY, w.elem_string, ["x", "yz"]),
            (28, mod.CT_TRUE, w.elem_bool, [True, False, True])):
        w.field_list(fid, ctype, len(values))
        for v in values:
            elem(v)
    w.struct_end()
    return w.bytes()


def test_thrift_matches_jax():
    data = _thrift_struct(pthrift)
    assert data == _thrift_struct(jthrift)
    assert pthrift.Reader(data).read_struct() == \
        jthrift.Reader(data).read_struct()
