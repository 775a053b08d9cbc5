"""arrowtpu_torch's CSV and JSON formats (formats/csv.py, json.py) against
the JAX package's on the same numpy-made inputs, and against pyarrow.

Tolerance: exact.  The text each writer produces equals the JAX writer's
(CSV with and without a header, tab-delimited, a null marker; NDJSON and
the JSON array format, with and without explicit nulls), but for CSV
Date32 and Timestamp columns, which the port writes as ISO dates and
times (ROADMAP C.3, fault 20: the JAX writer's numbers do not read back
as dates or times).  Each package
reads the other's text to the same columns (values on valid rows,
validity as bools, the string views' words), inferred and under a
declared schema, in one batch and in several; pyarrow reads the port's
text to the port's values.  ClickBench's `hits` columns in ClickHouse's
types (a uint64 of 2**63 or more among them) cross as TSV and NDJSON.
"""

import io

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.json as pajson
import pytest

from arrowtpu import schema as js
from arrowtpu.formats import csv as jcsv
from arrowtpu.formats import json as jjson
from arrowtpu.interop import pyarrow_bridge as jpb

import arrowtpu_torch as pt
from arrowtpu_torch import entry as pe
from arrowtpu_torch import schema as ps
from arrowtpu_torch.formats import csv as pcsv
from arrowtpu_torch.formats import json as pjson
from arrowtpu_torch.interop import pyarrow_bridge as ppb
from torch_parity import assert_batch_equal, release_jax_caches  # noqa: F401

N = 2000


def _table(seed=0, n=N):
    """Mixed columns with nulls, made from `seed`: int64, float64 (no
    NaN: CSV and JSON have none), utf8 inline and long, bool, int32,
    date32 and a microsecond timestamp."""
    rng = np.random.default_rng(seed)

    def nulls(p=0.1):
        return rng.random(n) < p

    words = np.array(["a", "bb", "ccc", "a string longer than twelve",
                      "x,y", 'q"uote', "ünïcode"], dtype=object)
    return pa.table({
        "i": pa.array(rng.integers(-2**62, 2**62, n), pa.int64(),
                      mask=nulls()),
        "f": pa.array(np.round(rng.normal(0, 1e3, n), 3), pa.float64(),
                      mask=nulls()),
        "s": pa.array(words[rng.integers(0, len(words), n)], pa.utf8(),
                      mask=nulls()),
        "b": pa.array(rng.random(n) < 0.5, pa.bool_(), mask=nulls()),
        "i32": pa.array(rng.integers(-2**31, 2**31, n), pa.int32(),
                        mask=nulls()),
        "d": pa.array(rng.integers(-20000, 30000, n).astype(np.int32),
                      pa.date32(), mask=nulls()),
        "ts": pa.array(rng.integers(0, 2**50, n), pa.timestamp("us"),
                       mask=nulls())})


def _pair(table):
    rb = table.combine_chunks().to_batches()[0]
    return jpb.from_pyarrow(rb), ppb.from_pyarrow(rb, device="cpu")


@pytest.fixture(scope="module")
def mixed():
    return _pair(_table())


@pytest.fixture(scope="module")
def hits():
    """The first rows of `entry.example_hits_arrays` in ClickHouse's
    types, with a uint64 value of 2**63 or more on about half the rows."""
    arrays = pe.example_hits_arrays(N)
    assert (arrays["UserID"] >= 2**63).any()
    table = pa.table({n: pa.array(arrays[n]) for n in pe.HITS_COLUMNS})
    table = table.set_column(4, "EventDate",
                             pa.array(arrays["EventDate"], pa.date32()))
    jb, pb = _pair(table)
    jschema = js.Schema(tuple(js.Field(f.name, f.dtype, False)
                              for f in jb.schema.fields))
    pschema = ps.Schema(tuple(ps.Field(n, pe.HITS_TYPES[n], False)
                              for n in pe.HITS_COLUMNS))
    return jb, pb, jschema, pschema, arrays


# ------------------------------- CSV ---------------------------------------

CSV_OPTIONS = [{}, {"delimiter": "\t", "has_header": False},
               {"null_value": "NA"}]


NOT_DATE = ["i", "f", "s", "b", "i32"]


@pytest.mark.parametrize("opts", CSV_OPTIONS, ids=["default", "tsv", "NA"])
def test_csv_text_equals_jax_writer(mixed, opts):
    jb, pb = mixed
    assert (pcsv.write_csv(pb.project(NOT_DATE), **opts)
            == jcsv.write_csv(jb.project(NOT_DATE), **opts))


def test_csv_dates_fault_20(mixed):
    """The JAX writer writes Date32 and Timestamp columns as numbers,
    which its own reader cannot parse under their fields; the port writes
    numpy's datetime64 text of them, which both readers parse back
    exactly (microseconds here)."""
    jb, pb = mixed
    names = ["d", "ts"]
    jschema = js.schema([("d", js.Date32()), ("ts", js.Timestamp("us"))])
    pschema = ps.schema([("d", ps.Date32()), ("ts", ps.Timestamp("us"))])
    with pytest.raises(ValueError):
        jcsv.read_csv(jcsv.write_csv(jb.project(names)), schema=jschema)
    ptext = pcsv.write_csv(pb.project(names))
    cols = []
    for name, unit in (("d", "D"), ("ts", "us")):
        values, valid, _ = pt.column_to_numpy(pb[name])
        iso = np.datetime_as_string(values.astype(f"datetime64[{unit}]"))
        cols.append([t if ok else "" for t, ok in zip(iso.tolist(), valid)])
    assert ptext.splitlines() == ["d,ts"] + [",".join(r)
                                             for r in zip(*cols)]
    back = pcsv.read_csv(ptext, schema=pschema, device="cpu")
    assert_batch_equal(jb.project(names), back)
    assert_batch_equal(jcsv.read_csv(ptext, schema=jschema), back)


def test_csv_reads_equal_both_ways(mixed):
    """Each package reads the other's text (inferred schema) to the same
    columns; the port in batches of 700 rows (concatenated on read) as
    well as in one."""
    jb, pb = mixed
    for text in (jcsv.write_csv(jb), pcsv.write_csv(pb)):
        want = jcsv.read_csv(text)
        assert_batch_equal(want, pcsv.read_csv(text, device="cpu"))
        assert_batch_equal(want, pcsv.read_csv(text, batch_size=700,
                                               device="cpu"))


def test_csv_reader_options(mixed):
    """A declared schema, a projection, batches and no header: the
    reader's batches against the JAX reader's, batch for batch."""
    jb, pb = mixed
    text = pcsv.write_csv(pb, has_header=False, delimiter="|")
    jschema = js.schema([("i", js.int64), ("f", js.float64),
                         ("s", js.utf8), ("b", js.boolean),
                         ("i32", js.int32), ("d", js.Date32()),
                         ("ts", js.Timestamp("us"))])
    pschema = ps.schema([("i", ps.int64), ("f", ps.float64),
                         ("s", ps.utf8), ("b", ps.bool_),
                         ("i32", ps.int32), ("d", ps.Date32()),
                         ("ts", ps.Timestamp("us"))])
    opts = dict(has_header=False, delimiter="|", batch_size=900,
                projection=["s", "i32", "d"])
    jr = list(jcsv.ReaderBuilder(schema=jschema, **opts).build(text))
    pr = list(pcsv.ReaderBuilder(schema=pschema, device="cpu",
                                 **opts).build(io.BytesIO(text.encode())))
    assert [b.length for b in pr] == [900, 900, 200]
    for j, p in zip(jr, pr):
        assert_batch_equal(j, p)


def test_csv_inference_matches():
    text = ("a,b,c,d,e,f\n1,1.5,true,x,2020-01-01,2020-01-01T00:00:01\n"
            "2,,false,y,,2021-03-04 05:06:07.5\n,-.5e3,TRUE,,1999-12-31,\n")
    jr, pr = (m.ReaderBuilder().build(text) for m in (jcsv, pcsv))
    assert [str(f.dtype) for f in pr.schema.fields] == [
        str(f.dtype) for f in jr.schema.fields]
    assert_batch_equal(jcsv.read_csv(text), pcsv.read_csv(text,
                                                          device="cpu"))
    assert pcsv.read_csv("c\n", has_header=False,
                         device="cpu").to_pydict() == {"column_1": ["c"]}


def test_csv_decimal_raises_as_in_jax():
    for m, s in ((jcsv, js), (pcsv, ps)):
        schema = s.schema([("x", s.Decimal128(10, 2))])
        with pytest.raises(s.CastError):
            kw = {} if m is jcsv else {"device": "cpu"}
            m.read_csv("x\n1.25\n", schema=schema, **kw)


def test_pyarrow_reads_port_csv(mixed):
    _, pb = mixed
    got = pacsv.read_csv(io.BytesIO(pcsv.write_csv(pb).encode()))
    want = pb.to_pydict()
    for name in ("i", "f", "b", "i32"):
        assert got[name].to_pylist() == want[name], name
    # "" reads back as a null in both packages and as "" in pyarrow
    assert [v or None for v in got["s"].to_pylist()] == want["s"]


def test_hits_as_tsv(hits):
    """`hits` as ClickBench's hits.tsv lays it out (tab-delimited, no
    header), written by the port and read back under the hits schema in
    batches: the port equals the JAX reader and the arrays themselves."""
    jb, pb, jschema, pschema, arrays = hits
    opts = dict(delimiter="\t", has_header=False)
    text = pcsv.write_csv(pb, **opts)
    not_date = pe.HITS_COLUMNS[:4]
    assert (pcsv.write_csv(pb.project(not_date), **opts)
            == jcsv.write_csv(jb.project(not_date), **opts))
    back = pcsv.read_csv(text, schema=pschema, batch_size=512, device="cpu",
                         **opts)
    assert_batch_equal(jcsv.read_csv(text, schema=jschema, **opts), back)
    _same_as_arrays(back, arrays)


def _same_as_arrays(batch, arrays):
    for name in pe.HITS_COLUMNS:
        values, valid, _ = pt.column_to_numpy(batch[name])
        assert valid.all(), name
        np.testing.assert_array_equal(values, arrays[name], err_msg=name)


# ------------------------------- JSON --------------------------------------

JSON_OPTIONS = [{}, {"format": "array"}, {"explicit_nulls": True}]


@pytest.mark.parametrize("opts", JSON_OPTIONS,
                         ids=["ld", "array", "explicit_nulls"])
def test_json_text_equals_jax_writer(mixed, opts):
    jb, pb = mixed
    assert pjson.write_json(pb, **opts) == jjson.write_json(jb, **opts)


def test_json_reads_equal_both_ways(mixed):
    jb, pb = mixed
    jtext, ptext = jjson.write_json(jb), pjson.write_json(pb)
    want = jjson.read_json(ptext)
    assert_batch_equal(want, pjson.read_json(jtext, device="cpu"))
    assert_batch_equal(want, pjson.read_json(jtext, batch_size=700,
                                             device="cpu"))
    arr = pjson.write_json(pb, format="array")
    assert_batch_equal(want, pjson.read_json(arr.encode(), device="cpu"))


def test_json_nested_and_unified():
    """Inference unifies int with float, structs by field and lists by
    item; nested columns read equal, and write back to the same text."""
    text = ('{"a": {"x": 1}, "l": [1, 2], "n": 1}\n'
            '{"a": {"x": 2, "y": "s"}, "l": [], "n": 2.5}\n'
            '{"a": null, "l": null, "n": null, "z": [1.5, 2]}\n'
            '{"a": {"x": 3}, "l": [4], "n": 3, "z": {"w": 1}}\n')
    jb, pb = jjson.read_json(text), pjson.read_json(text, device="cpu")
    assert [str(f.dtype) for f in pb.schema.fields] == [
        str(f.dtype) for f in jb.schema.fields]
    assert_batch_equal(jb, pb)
    assert pjson.write_json(pb) == jjson.write_json(jb)


def test_pyarrow_reads_port_ndjson(mixed):
    _, pb = mixed
    got = pajson.read_json(io.BytesIO(pjson.write_json(pb).encode()))
    want = pb.to_pydict()
    for name in ("i", "f", "s", "b", "i32"):
        assert got[name].to_pylist() == want[name], name


def test_hits_as_ndjson(hits):
    jb, pb, jschema, pschema, arrays = hits
    text = pjson.write_json(pb)
    assert text == jjson.write_json(jb)
    back = pjson.read_json(text, schema=pschema, batch_size=512,
                           device="cpu")
    assert_batch_equal(jjson.read_json(text, schema=jschema), back)
    _same_as_arrays(back, arrays)
