"""arrowtpu_torch's Avro (formats/avro.py and the native block decoders
native/src/avroblock.cpp, avronest.cpp) against the JAX package's on the
same numpy-made inputs.

Tolerance: exact.  The binary primitives and an OCF's bytes equal the
JAX writer's for every codec both have (the 16-byte sync marker, drawn
from os.urandom by each writer, put in place before the comparison);
each package reads the other's files to the same columns (values on
valid rows, validity as bools, string views' words, list views, structs,
dictionaries); the port's flat and nested native decoders give the JAX
package's decoders' buffers on the same blocks; the per-row path (a
decimal, an enum, a nullable union), reader-schema resolution, the
single-object and Confluent frames and the Rabin fingerprints equal the
JAX package's.  ROADMAP C.3 fault 19: the JAX package reads a uint64 of
2**63 or more back as another number; the port writes it as its int64
bits, so it reads back as numpy's `.view(np.int64)` of the values.
"""

import decimal
import json

import numpy as np
import pyarrow as pa
import pytest

import arrowtpu as at
from arrowtpu import native as jnative
from arrowtpu import schema as js
from arrowtpu.formats import avro as javro
from arrowtpu.interop import pyarrow_bridge as jpb

import arrowtpu_torch as pt
from arrowtpu_torch import native as pnative
from arrowtpu_torch import schema as ps
from arrowtpu_torch.formats import avro as pavro
from arrowtpu_torch.interop import pyarrow_bridge as ppb
from test_avro_nested import SCHEMA as NESTED, make_ocf, sample_rows
from torch_parity import assert_batch_equal, release_jax_caches  # noqa: F401

N = 3000
CODECS = [c for c in javro.supported_codecs()
          if c in pavro.supported_codecs()]


def _pair(table):
    rb = table.combine_chunks().to_batches()[0]
    return jpb.from_pyarrow(rb), ppb.from_pyarrow(rb, device="cpu")


def _flat_table(seed=0, n=N):
    """The flat decoder's types with nulls, made from `seed`."""
    rng = np.random.default_rng(seed)

    def nulls(p=0.1):
        return rng.random(n) < p

    words = np.array(["", "a", "twelve bytes", "thirteen byte",
                      "a string well past twelve bytes", "ünï"], object)
    return pa.table({
        "i": pa.array(rng.integers(-2**63, 2**63 - 1, n), pa.int64(),
                      mask=nulls()),
        "i32": pa.array(rng.integers(-2**31, 2**31, n).astype(np.int32),
                        pa.int32()),
        "f32": pa.array(rng.normal(0, 1, n).astype(np.float32),
                        pa.float32(), mask=nulls()),
        "f": pa.array(rng.normal(0, 1e6, n), pa.float64(), mask=nulls()),
        "s": pa.array(words[rng.integers(0, len(words), n)], pa.utf8(),
                      mask=nulls()),
        "bin": pa.array([bytes(rng.integers(0, 256, k).astype(np.uint8))
                         for k in rng.integers(0, 30, n)], pa.binary()),
        "b": pa.array(rng.random(n) < 0.5, pa.bool_(), mask=nulls()),
        "d": pa.array(rng.integers(-20000, 30000, n).astype(np.int32),
                      pa.date32(), mask=nulls()),
        "ts": pa.array(rng.integers(0, 2**50, n), pa.timestamp("ms")),
    })


@pytest.fixture(scope="module")
def flat():
    return _pair(_flat_table())


def _with_sync(data: bytes, other: bytes) -> bytes:
    """`data` with its sync marker replaced by `other`'s."""
    return data.replace(javro.AvroFile(data).sync,
                        javro.AvroFile(other).sync)


def test_binary_primitives_equal():
    rng = np.random.default_rng(1)
    values = [0, -1, 1, -64, 64, 8192, 2**31, -2**31 - 1, 2**63 - 1,
              -2**63] + rng.integers(-2**63, 2**63 - 1, 200).tolist()
    jout, pout = bytearray(), bytearray()
    for v in values:
        javro.write_long(jout, v)
        pavro.write_long(pout, v)
    assert pout == jout
    pos = 0
    for v in values:
        got, pos = pavro.read_long(pout, pos)
        assert got == v
    for m in (javro, pavro):
        out = bytearray()
        m._encode_value(out, "string", "foo")
        assert bytes(out) == b"\x06foo"


@pytest.mark.parametrize("codec", CODECS)
def test_ocf_bytes_equal_and_read_both_ways(flat, codec):
    jb, pb = flat
    jdata = javro.write_avro(jb, codec=codec, block_rows=1000)
    pdata = pavro.write_avro(pb, codec=codec, block_rows=1000)
    assert _with_sync(pdata, jdata) == jdata
    want = javro.read_avro(pdata)
    assert_batch_equal(want, pavro.read_avro(jdata, device="cpu"))
    assert_batch_equal(want, pavro.read_avro(pdata, device="cpu"))


def test_flat_decoder_held_to_jax(flat):
    """Every block of a file through both packages' avroblock.cpp: every
    output buffer equal."""
    _, pb = flat
    f = pavro.AvroFile(pavro.write_avro(pb, block_rows=700), device="cpu")
    fdesc = f._native_fdesc()
    assert fdesc is not None
    for count, body in f.iter_blocks():
        got = pnative.avro_decode_block(bytes(body), count, fdesc, len(body))
        want = jnative.avro_decode_block(bytes(body), count, fdesc,
                                         len(body))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_lists_structs_and_decimals_both_ways():
    """A list, a struct and a decimal column (the per-row decoder, since
    a decimal needs it): the port's bytes and reads against the JAX
    package's."""
    rng = np.random.default_rng(2)
    n = 400
    table = pa.table({
        "l": pa.array([None if k < 0 else rng.integers(-9, 9, k).tolist()
                       for k in rng.integers(-1, 4, n)],
                      pa.list_(pa.int64())),
        "st": pa.array([{"x": int(x), "y": f"y{x}"} for x in
                        rng.integers(0, 50, n)]),
        "dec": pa.array([decimal.Decimal(int(v)).scaleb(-2) for v in
                         rng.integers(-10**12, 10**12, n)],
                        pa.decimal128(20, 2)),
    })
    jb, pb = _pair(table)
    jdata = javro.write_avro(jb, block_rows=150)
    pdata = pavro.write_avro(pb, block_rows=150)
    assert _with_sync(pdata, jdata) == jdata
    want = javro.read_avro(pdata)
    assert_batch_equal(want, pavro.read_avro(jdata, device="cpu"))
    # without the decimal: the nested native decoder
    jdata = javro.write_avro(jb.project(["l", "st"]))
    pdata = pavro.write_avro(pb.project(["l", "st"]))
    assert _with_sync(pdata, jdata) == jdata
    assert_batch_equal(javro.read_avro(jdata),
                       pavro.read_avro(pdata, device="cpu"))


@pytest.fixture(scope="module")
def nested_file():
    """NESTED (records, arrays, maps, an enum, a fixed, arrays of arrays)
    at 300 rows in blocks of 37, so later blocks' long strings rebase."""
    rows = sample_rows(300)
    jdata = make_ocf(NESTED, rows, block_rows=37)
    pdata = bytearray(pavro.ocf_header(json.dumps(NESTED), "null",
                                       b"S" * 16))
    for start in range(0, len(rows), 37):
        body = bytearray()
        for row in rows[start:start + 37]:
            pavro._encode_row(body, NESTED, row)
        blk = bytearray()
        pavro.write_long(blk, len(rows[start:start + 37]))
        pavro.write_long(blk, len(body))
        pdata += blk + body + b"S" * 16
    assert bytes(pdata) == jdata
    return jdata, rows


def test_nested_decoder_held_to_jax(nested_file):
    data, _ = nested_file
    f = pavro.AvroFile(data, device="cpu")
    desc, child_idx, _ = f._nested_desc()
    jdesc, jchild, _ = javro.AvroFile(data)._nested_desc()
    np.testing.assert_array_equal(desc, jdesc)
    np.testing.assert_array_equal(child_idx, jchild)
    for count, body in f.iter_blocks():
        got = pnative.avro_decode_nested(bytes(body), count, desc,
                                         child_idx, len(body))
        want = jnative.avro_decode_nested(bytes(body), count, desc,
                                          child_idx, len(body))
        for g, w in zip(got[0], want[0]):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


def test_nested_read_equals_jax(nested_file):
    data, rows = nested_file
    got = pavro.read_avro(data, device="cpu")
    assert_batch_equal(javro.AvroFile(data)._read_columnar_nested(), got)
    assert got["tags"].to_pylist() == [r["tags"] for r in rows]
    assert got["sub"].to_pylist() == [r["sub"] for r in rows]


def test_per_row_path_decimal_enum_union():
    """A decimal sends a file down the per-row decoder: with an enum, a
    nullable union both ways round ([T, "null"] too), a fixed and a
    long, the port's columns equal the JAX package's."""
    schema = {"type": "record", "name": "P", "fields": [
        {"name": "dec", "type": {"type": "bytes", "logicalType": "decimal",
                                 "precision": 12, "scale": 3}},
        {"name": "color", "type": {"type": "enum", "name": "C",
                                   "symbols": ["RED", "GREEN", "BLUE"]}},
        {"name": "u", "type": ["null", "string"]},
        {"name": "v", "type": ["long", "null"]},
        {"name": "fx", "type": {"type": "fixed", "name": "F4", "size": 4}},
    ]}
    rng = np.random.default_rng(3)
    rows = [{"dec": decimal.Decimal(int(d)).scaleb(-3),
             "color": ["RED", "GREEN", "BLUE"][int(c)],
             "u": None if i % 4 == 0 else f"text {i}" * (i % 3),
             "v": None if i % 5 == 0 else int(v),
             "fx": bytes(rng.integers(0, 256, 4).astype(np.uint8))}
            for i, (d, c, v) in enumerate(zip(
                rng.integers(-10**11, 10**11, 500), rng.integers(0, 3, 500),
                rng.integers(-2**40, 2**40, 500)))]
    data = make_ocf(schema, rows, block_rows=128)
    f = pavro.AvroFile(data, device="cpu")
    assert f._native_fdesc() is None and f._nested_desc() is None
    got = f.read()
    assert_batch_equal(javro.read_avro(data), got)
    assert f.read_rows() == javro.AvroFile(data).read_rows()


def test_reader_schema_resolution():
    jb = at.record_batch({"x": at.from_pylist([1, 2, None], js.int32),
                          "y": at.from_pylist(["a", "b", "c"], js.utf8),
                          "w": at.from_pylist([b"p", b"q", b"r"],
                                              js.binary)})
    data = javro.write_avro(jb)
    reader = {"type": "record", "name": "r", "fields": [
        {"name": "x", "type": ["null", "double"]},  # int -> double
        {"name": "w", "type": "string"},            # bytes -> string
        {"name": "y", "type": "bytes"},             # string -> bytes
        {"name": "z", "type": "long", "default": 7},
        {"name": "q", "type": ["null", "int"]}]}
    got = pavro.read_avro(data, reader_schema=reader, device="cpu")
    assert_batch_equal(javro.read_avro(data, reader_schema=reader), got)
    assert got.to_pydict()["z"] == [7, 7, 7]
    bad = {"type": "record", "name": "r",
           "fields": [{"name": "y", "type": "long"}]}
    for m, s in ((javro, js), (pavro, ps)):
        with pytest.raises(s.SchemaError):
            m.AvroFile(data).read_rows(bad) if m is javro else \
                m.read_avro(data, reader_schema=bad, device="cpu")


PCF_SCHEMA = json.dumps({
    "type": "record", "name": "Rec", "namespace": "org.example", "doc": "x",
    "fields": [
        {"name": "a", "type": "int", "default": 0},
        {"name": "b", "type": {"type": "record", "name": "Inner",
                               "fields": [{"name": "c", "type": "long"}]}},
        {"name": "d", "type": "Inner"},
        {"name": "e", "type": {"type": "fixed", "name": "F16", "size": 16}},
        {"name": "f", "type": {"type": "int", "logicalType": "date"}},
        {"name": "g", "type": ["null", "string"]},
    ]})


def test_single_object_confluent_and_fingerprints():
    simple = json.dumps({"type": "record", "name": "r", "fields": [
        {"name": "a", "type": "long"}, {"name": "b", "type": "string"}]})
    row = {"a": -42, "b": "hi"}
    for sj in (simple, PCF_SCHEMA, json.dumps("int"),
               json.dumps(NESTED)):
        assert pavro._parsing_canonical_form(sj) == \
            javro._parsing_canonical_form(sj)
        assert pavro.rabin_fingerprint(sj) == javro.rabin_fingerprint(sj)
    assert pavro.rabin_fingerprint(json.dumps("int")) == 0x7275D51A3F395C8F
    frame = pavro.encode_single_object(row, simple)
    assert frame == javro.encode_single_object(row, simple)
    assert pavro.decode_single_object(frame, simple) == row
    with pytest.raises(ps.ArrowTpuError):
        pavro.decode_single_object(frame, simple.replace('"r"', '"q"'))
    frame = pavro.encode_confluent(row, simple, 123)
    assert frame == javro.encode_confluent(row, simple, 123)
    assert pavro.decode_confluent(frame, simple) == (123, row)
    nested_row = sample_rows(12)[11]
    assert pavro.encode_single_object(nested_row, json.dumps(NESTED)) == \
        javro.encode_single_object(nested_row, json.dumps(NESTED))


def test_corrupt_sync_raises(flat):
    _, pb = flat
    data = bytearray(pavro.write_avro(pb.project(["i"]), block_rows=1000))
    data[-1] ^= 0xFF
    with pytest.raises(ps.ArrowTpuError):
        pavro.read_avro(bytes(data), device="cpu")


def test_failed_native_build_raises(flat, monkeypatch):
    """Where the JAX package falls back to its per-row decoder, the port
    raises NativeBuildError."""
    _, pb = flat
    data = pavro.write_avro(pb.project(["i"]))
    monkeypatch.setattr(pnative, "_libs", {})
    monkeypatch.setattr(pnative, "CXX_FLAGS",
                        pnative.CXX_FLAGS + ["-fno-such-flag"])
    with pytest.raises(pnative.NativeBuildError):
        pavro.read_avro(data, device="cpu")


U64 = np.array([2**64 - 5, 2**63 + 1, 2**63, 2**63 - 1, 0, 7], np.uint64)


def test_jax_uint64_fault_19():
    """The JAX writer zigzags a uint64 of 2**63 or more as an unsigned
    number: 2**64 - 5 reads back as -9,223,372,036,854,775,804 and
    2**63 + 1 as -2."""
    jb = at.record_batch({"u": at.primitive(U64, js.uint64)})
    got = javro.read_avro(javro.write_avro(jb)).to_pydict()["u"]
    assert got[:2] == [-9_223_372_036_854_775_804, -2]
    assert got[3:] == [2**63 - 1, 0, 7]


def test_port_uint64_as_int64_bits():
    """The port writes a uint64 as its int64 bits (a uint32 as its int32
    bits already was), so the long it reads back is numpy's view."""
    pb = pt.record_batch({
        "u": pt.column_from_numpy(U64, None, device="cpu"),
        "u32": pt.column_from_numpy(np.array([2**32 - 5, 2**31, 3, 0, 1, 2],
                                             np.uint32), None,
                                    device="cpu")})
    got = pavro.read_avro(pavro.write_avro(pb), device="cpu")
    np.testing.assert_array_equal(pt.column_to_numpy(got["u"])[0],
                                  U64.view(np.int64))
    np.testing.assert_array_equal(
        pt.column_to_numpy(got["u32"])[0],
        np.array([2**32 - 5, 2**31, 3, 0, 1, 2], np.uint32).view(np.int32))
