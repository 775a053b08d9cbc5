"""arrowtpu_torch.variant against arrowtpu.variant, and JSONBench's queries
over a shredded Variant column against their oracle.

Tolerance: exact.  Both packages encode the same Python values (every
primitive, short and long strings, nested objects and arrays, decimals,
dates, timestamps with and without a zone, UUID, binary) to the same
metadata and value bytes; shred and unshred to the same columns (typed
values, residual bytes, validity: `torch_parity.assert_column_equal`,
string views word for word) for primitive, partial-object and
nested-struct targets; give the same `variant_get` results on the
columnar path, the residual path, an index path and with `as_dtype`; the
same JSON text (decimals aside: ROADMAP C.3 fault 21, held to Python's
decimal formatting); and read each other's Parquet files of variant columns
(the cases of tests/test_variant_parquet.py).  The columnar path must
read no metadata or value byte.  JSONBench's five queries over 2,000
documents drawn from a seed are held to `entry.jsonbench_oracle` (Python's
json), and the shredded column of those documents to the JAX package's.
"""

import datetime as dt
import decimal
import io
import uuid

import pytest

import torch_parity as tp
from torch_parity import release_jax_caches  # noqa: F401
from arrowtpu import schema as js
from arrowtpu import variant as JV
from arrowtpu.core import batch as jbt
from arrowtpu.formats import parquet as jpq

from arrowtpu_torch import entry as pe
from arrowtpu_torch import schema as ps
from arrowtpu_torch import variant as PV
from arrowtpu_torch.core import batch as pbt
from arrowtpu_torch.formats import parquet as ppq
from arrowtpu_torch.variant import get as pget

CPU = "cpu"


def samples(V):
    """tests/test_variant.py's SAMPLES, with the package's own
    VariantFloat / VariantTsNanos."""
    return [
        None, True, False, 0, -1, 127, -128, 32767, -(2**31), 2**31 - 1,
        2**62, -(2**63), 3.5, -0.0, float("inf"), "", "short", "x" * 63,
        "y" * 64, "unicode: héllo ☃", b"\x00\x01\xff",
        decimal.Decimal("12.34"), decimal.Decimal("-0.000001"),
        decimal.Decimal("123456789012345678.90"), dt.date(2024, 2, 29),
        dt.datetime(2024, 6, 1, 12, 30, 45, 123456),
        dt.datetime(2024, 6, 1, 12, 30, 45, 123456, tzinfo=dt.timezone.utc),
        dt.time(23, 59, 59, 999999),
        uuid.UUID("12345678-1234-5678-1234-567812345678"),
        V.VariantFloat(1.5), V.VariantTsNanos(1_717_243_845_123_456_789),
        V.VariantTsNanos(77, utc=False), {}, {"a": 1, "b": "two"},
        {"nested": {"x": [1, 2, {"deep": None}]}, "z": 4.0}, [],
        [1, "a", None, True, {"k": []}], list(range(300)),
        {f"f{i:04d}": i for i in range(300)},
        decimal.Decimal(10) ** 30,
    ]


def test_exports_match():
    def public(mod):
        return {n for n in vars(mod) if not n.startswith("_")}

    assert public(PV) == public(JV)


def test_encode_variant_bytes_equal():
    for i, (jv, pv) in enumerate(zip(samples(JV), samples(PV))):
        assert PV.encode_variant(pv) == JV.encode_variant(jv), i
        meta, val = PV.encode_variant(pv)
        assert PV.decode_value(val, PV.parse_metadata(meta)[0]) == pv, i


def test_builder_and_errors_match():
    jb, pb = JV.VariantBuilder(), PV.VariantBuilder()
    for jv, pv in zip(samples(JV), samples(PV)):
        jb.append(jv)
        pb.append(pv)
    assert pb.finish() == jb.finish()
    meta, val = PV.encode_variant({"a": [1, 2, 3]})
    with pytest.raises(ps.ArrowTpuError):
        PV.decode_value(val[:-2], PV.parse_metadata(meta)[0])
    with pytest.raises(ps.ArrowTpuError):
        PV.parse_metadata(b"\x02\x00")


ROWS = [
    {"a": 1, "b": "x"},
    {"a": 2, "b": "y", "extra": [1, 2]},
    {"b": "z"},
    {"a": "wrong type", "b": "w"},
    "not an object",
    None,
    {"a": 3, "b": "a string longer than twelve bytes", "o": {"x": 5}},
    {"o": {"x": 2, "y": 3}, "a": 2**40},
    {"o": "no"},
    1,
    2,
    "three",
    3.5,
    dt.date(2020, 1, 1),
    dt.datetime(2021, 2, 3, 4, 5, 6),
]


def _targets(s):
    return {
        "int": s.int64,
        "utf8": s.utf8,
        "date": s.Date32(),
        "partial": s.Struct((s.Field("a", s.int64), s.Field("b", s.utf8))),
        "nested": s.Struct((s.Field("o", s.Struct((s.Field("x", s.int64),))),
                            s.Field("a", s.int64))),
    }


@pytest.mark.parametrize("target", sorted(_targets(ps)))
def test_shred_unshred_columns_equal(target):
    jvc, pvc = JV.variant_array(ROWS), PV.variant_array(ROWS, CPU)
    tp.assert_column_equal(jvc.inner, pvc.inner, "variant_array")
    jsh = JV.shred_variant(jvc, _targets(js)[target])
    psh = PV.shred_variant(pvc, _targets(ps)[target])
    tp.assert_column_equal(jsh.inner, psh.inner, f"shred {target}")
    jun, pun = JV.unshred_variant(jsh), PV.unshred_variant(psh)
    tp.assert_column_equal(jun.inner, pun.inner, f"unshred {target}")
    assert pun.to_pylist() == psh.to_pylist() == ROWS


GETS = [
    (("a",), None),
    (("a",), "int64"),
    (("b",), "utf8"),
    (("o", "x"), "int64"),
    (("o", "x"), None),
    (("extra", 1), None),
    (("extra", 0), "int64"),
    ((0,), None),
    (("missing",), "int64"),
]


@pytest.mark.parametrize("target", ["none", "partial", "nested"])
def test_variant_get_equal(target):
    jvc, pvc = JV.variant_array(ROWS), PV.variant_array(ROWS, CPU)
    if target != "none":
        jvc = JV.shred_variant(jvc, _targets(js)[target])
        pvc = PV.shred_variant(pvc, _targets(ps)[target])
    for path, dtype in GETS:
        jout = JV.variant_get(jvc, list(path),
                              getattr(js, dtype) if dtype else None)
        pout = PV.variant_get(pvc, list(path),
                              getattr(ps, dtype) if dtype else None)
        if dtype is None:
            tp.assert_column_equal(jout.inner, pout.inner, f"{path}")
            assert pout.to_pylist() == jout.to_pylist()
        else:
            tp.assert_column_equal(jout, pout, f"{path} as {dtype}")


def test_variant_get_columnar_path_reads_no_bytes(monkeypatch):
    """A path shredded all the way to a primitive typed_value whose
    residual is all null is the typed column itself: no metadata read, no
    row decoded (the metadata reader fails the test if made)."""
    vals = [{"a": i, "s": f"v{i}"} for i in range(50)]
    target = ps.Struct((ps.Field("a", ps.int64), ps.Field("s", ps.utf8)))
    sh = PV.shred_variant(PV.variant_array(vals, CPU), target)

    def no_reads(*args):
        raise AssertionError("variant_get read the metadata")

    monkeypatch.setattr(pget, "MetadataNames", no_reads)
    for name, dtype in (("a", ps.int64), ("s", ps.utf8)):
        out = PV.variant_get(sh, [name], as_dtype=dtype)
        assert out is sh.typed_value.field(name).field("typed_value")
    with pytest.raises(AssertionError, match="read the metadata"):
        PV.variant_get(sh, ["a"], as_dtype=ps.int32)
    # a null row: the validity ANDed, the values' storage shared
    withnull = PV.from_parts(sh.metadata, sh.value, sh.typed_value,
                             validity=[i % 3 > 0 for i in range(50)])
    out = PV.variant_get(withnull, ["a"], as_dtype=ps.int64)
    typed = sh.typed_value.field("a").field("typed_value")
    assert out.values is typed.values
    assert out.to_pylist() == [i if i % 3 else None for i in range(50)]


def test_json_text_equal():
    texts = ['{"a":[1,2,{"b":null}],"c":"x"}', "3.25", "null",
             "[true,false]", None, '{"z":1,"a":{"y":"\\u00e9"}}', "-7",
             '"a string longer than sixty-four bytes, so it is not short ..."']
    jvc = JV.batch_json_to_variant(texts)
    pvc = PV.batch_json_to_variant(texts, CPU)
    tp.assert_column_equal(jvc.inner, pvc.inner, "json_to_variant")
    assert PV.batch_variant_to_json(pvc) == JV.batch_variant_to_json(jvc)
    vals = [{"a": 1, "t": dt.date(2024, 1, 2)}, [1.5, None, "x"], b"\x01\x02",
            None, uuid.UUID(int=7), decimal.Decimal("1.50"),
            dt.datetime(2024, 1, 2, 3, 4, 5, tzinfo=dt.timezone.utc)]
    assert PV.batch_variant_to_json(PV.variant_array(vals, CPU)) == \
        JV.batch_variant_to_json(JV.variant_array(vals))
    for jv, pv in zip(samples(JV), samples(PV)):
        if isinstance(pv, decimal.Decimal):
            continue  # test_json_decimals_fault_21
        assert PV.variant_to_json(pv) == JV.variant_to_json(jv)


def test_json_decimals_fault_21():
    """ROADMAP C.3 fault 21: the JAX package writes a decimal that is not
    integral as float(v), which rounds past 17 digits and writes an
    exponent.  The port writes its exact digits; the oracle is Python's
    format(d.normalize(), "f") (an integral decimal: int(d), as both
    write it)."""
    exact = [decimal.Decimal("12.34"), decimal.Decimal("1.50"),
             decimal.Decimal(10) ** 30, decimal.Decimal("-7")]
    faulty = [decimal.Decimal("-0.000001"),
              decimal.Decimal("123456789012345678.90"),
              decimal.Decimal("1E-20")]
    for d in exact + faulty:
        want = (str(int(d)) if d == d.to_integral_value()
                else format(d.normalize(), "f"))
        assert PV.variant_to_json(d) == want
        assert PV.variant_to_json({"x": [d]}) == '{"x":[%s]}' % want
        assert (JV.variant_to_json(d) == want) == (d in exact)
    vc = PV.variant_array([{"d": d} for d in faulty], CPU)
    assert PV.batch_variant_to_json(vc) == [
        '{"d":-0.000001}', '{"d":123456789012345678.9}',
        '{"d":0.00000000000000000001}']


# the cases of tests/test_variant_parquet.py, each package reading the
# other's file
PQ_VALS = [
    {"a": 1, "b": "x"},
    {"a": 2, "b": "y", "extra": [1, 2, {"d": None}]},
    "plain string",
    None,
    42,
    {"a": None, "b": "w"},
]


def _files(target):
    """-> (JAX file, port file, JAX column, port column)."""
    jvc, pvc = JV.variant_array(PQ_VALS), PV.variant_array(PQ_VALS, CPU)
    if target is not None:
        jvc = JV.shred_variant(jvc, target(js))
        pvc = PV.shred_variant(pvc, target(ps))
    out = []
    for V, s, bt, pq, vc in ((JV, js, jbt, jpq, jvc), (PV, ps, pbt, ppq, pvc)):
        tv = vc.typed_value.dtype if vc.typed_value is not None else None
        batch = bt.RecordBatch(s.Schema((V.variant_field("v", tv),)),
                               (vc.inner,))
        out.append(pq.write_parquet(batch))
    return out[0], out[1], jvc, pvc


def _read_both(data):
    return (JV.VariantColumn(jpq.read_parquet(data)["v"]),
            PV.VariantColumn(ppq.read_parquet(data, device=CPU)["v"]))


def test_parquet_unshredded_roundtrip():
    jdata, pdata, _, _ = _files(None)
    assert pdata == jdata
    from arrowtpu_torch.extension import EXTENSION_NAME_KEY

    f = ppq.ParquetFile(jdata, device=CPU).schema.fields[0]
    assert dict(f.metadata)[EXTENSION_NAME_KEY] == PV.VARIANT_EXT_NAME
    for data in (jdata, pdata):
        jback, pback = _read_both(data)
        assert pback.to_pylist() == jback.to_pylist() == PQ_VALS


def test_parquet_shredded_roundtrip():
    def target(s):
        return s.Struct((s.Field("a", s.int64), s.Field("b", s.utf8)))

    jdata, pdata, _, _ = _files(target)
    assert pdata == jdata
    for data in (jdata, pdata):
        jback, pback = _read_both(data)
        assert pback.typed_value is not None
        tp.assert_column_equal(jback.typed_value, pback.typed_value, "tv")
        assert PV.unshred_variant(pback).to_pylist() == PQ_VALS
        assert pback.to_pylist() == jback.to_pylist() == PQ_VALS


def test_parquet_pyarrow_reads_the_struct():
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    _, pdata, _, pvc = _files(None)
    rows = pq.read_table(io.BytesIO(pdata)).column("v").to_pylist()
    metas, vals = pvc.metadata_bytes(), pvc.value_bytes()
    assert pa is not None
    for i, r in enumerate(rows):
        if PQ_VALS[i] is None:
            assert r is None or r["value"] is None
        else:
            assert (r["metadata"], r["value"]) == (metas[i], vals[i])


def test_parquet_variant_get_after_scan():
    def target(s):
        return s.Struct((s.Field("a", s.int64),))

    jdata, pdata, _, _ = _files(target)
    for data in (jdata, pdata):
        jback, pback = _read_both(data)
        jout = JV.variant_get(jback, ["a"], as_dtype=js.int64)
        pout = PV.variant_get(pback, ["a"], as_dtype=ps.int64)
        assert pout.to_pylist() == jout.to_pylist() == [1, 2, None, None,
                                                        None, None]


@pytest.fixture(scope="module")
def bluesky():
    texts = pe.example_bluesky_docs(2_000)
    return texts, pe.bluesky_variant(texts, CPU)


def test_bluesky_shredded_column_equals_jax(bluesky):
    texts, psh = bluesky
    target = js.Struct((
        js.Field("kind", js.utf8), js.Field("did", js.utf8),
        js.Field("time_us", js.int64),
        js.Field("commit", js.Struct((js.Field("operation", js.utf8),
                                      js.Field("collection", js.utf8))))))
    jsh = JV.shred_variant(JV.batch_json_to_variant(texts), target)
    tp.assert_column_equal(jsh.inner, psh.inner, "bluesky")


@pytest.mark.parametrize("q", sorted(pe.JSONBENCH_QUERIES))
def test_jsonbench_queries_against_oracle(bluesky, q):
    texts, sh = bluesky
    batch = pe.bluesky_batch(sh)
    for name, (path, dtype) in pe.JSONBENCH_COLUMNS.items():
        assert batch[name].dtype == dtype
        assert batch[name] is PV.variant_get(sh, list(path), as_dtype=dtype)
    pe.check_jsonbench(pe.jsonbench_step(batch, q),
                       pe.jsonbench_oracle(texts, q), q)
