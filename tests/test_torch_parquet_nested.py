"""arrowtpu_torch.formats.parquet_nested (Dremel levels) against
arrowtpu.formats.parquet_nested and pyarrow.

Tolerance: exact.  For each nested shape of tests/test_parquet_nested.py
(lists of ints and strings, structs, lists of structs, structs of lists,
lists of lists, maps, fixed-size lists) plus a flat column beside them,
the port's writer gives the JAX writer's bytes; both packages read those
bytes and pyarrow's file of the same table (maps aside) to the same
columns (list-view starts and sizes, children, validity as bools, zero
padding); pyarrow reads the bytes to the source values.  The fuzzed
lists are drawn from a seed with numpy.
"""

import io

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

import torch_parity as tp
from torch_parity import release_jax_caches  # noqa: F401
import arrowtpu as at
from arrowtpu import schema as js
from arrowtpu.formats import parquet as jpq

import arrowtpu_torch as pt
from arrowtpu_torch import schema as ps
from arrowtpu_torch.formats import parquet as ppq
from arrowtpu_torch.formats import parquet_nested as pnest


def _fuzzed_lists(n=200):
    rng = np.random.default_rng(8)
    data = []
    for _ in range(n):
        roll = rng.random()
        if roll < 0.1:
            data.append(None)
        elif roll < 0.2:
            data.append([])
        else:
            data.append([None if rng.random() < 0.15 else int(x)
                         for x in rng.integers(-100, 100,
                                               rng.integers(1, 8))])
    return data


def _dt(mod, kind):
    s = mod
    return {
        "list_int": s.List(s.int64),
        "list_str": s.List(s.utf8),
        "struct": s.Struct((s.Field("x", s.int64), s.Field("y", s.utf8))),
        "list_struct": s.List(s.Struct((s.Field("a", s.int64),
                                        s.Field("b", s.utf8)))),
        "struct_list": s.Struct((s.Field("v", s.List(s.int64)),
                                 s.Field("n", s.int32))),
        "list_list": s.List(s.List(s.int64)),
        "map": s.Map(s.utf8, s.int64),
        "fixed_list": s.FixedSizeList(s.int64, 2),
    }[kind]


SHAPES = {
    "list_int": _fuzzed_lists(),
    "list_str": [["a", "bb"], None, [], ["ccc", None,
                                         "a-long-string-over-twelve"]],
    "struct": [{"x": 1, "y": "a"}, None, {"x": None, "y": "b"},
               {"x": 3, "y": None}],
    "list_struct": [[{"a": 1, "b": "x"}, {"a": None, "b": "y"}], None, [],
                    [{"a": 3, "b": None}]],
    "struct_list": [{"v": [1, 2], "n": 5}, None, {"v": None, "n": 7},
                    {"v": [], "n": None}],
    "list_list": [[[1], [2, 3]], None, [[]], [], [[None, 4], None]],
    "map": [[("k1", 1), ("k2", 2)], None, [], [("k3", None)]],
    "fixed_list": [[1, 2], None, [3, None], [5, 6]],
}


def _batches(kind):
    data = SHAPES[kind]
    n = len(data)
    flat = [None if i % 3 == 1 else i * 7 for i in range(n)]
    jb = at.record_batch({"i": at.from_pylist(flat, js.int64),
                          "c": at.from_pylist(data, _dt(js, kind))})
    pb = pt.record_batch({"i": pt.from_pylist(flat, ps.int64, device="cpu"),
                          "c": pt.from_pylist(data, _dt(ps, kind),
                                              device="cpu")})
    return jb, pb, data


@pytest.mark.parametrize("kind", list(SHAPES))
def test_nested_bytes_and_reads_equal_jax(kind):
    jb, pb, data = _batches(kind)
    buf = ppq.write_parquet([pb])
    assert buf == jpq.write_parquet([jb])
    jr = jpq.read_parquet(buf)
    pr = ppq.read_parquet(buf, device="cpu")
    tp.assert_batch_equal(jr, pr)
    assert pr["c"].to_pylist() == data
    assert papq.read_table(io.BytesIO(buf)).column("c").to_pylist() == data
    proj = ppq.read_parquet(buf, columns=["c"], device="cpu")
    assert proj.schema.names == ["c"] and proj["c"].to_pylist() == data


@pytest.mark.parametrize("kind", ["list_int", "struct", "list_struct",
                                  "list_list"])
def test_reads_pyarrow_nested(kind):
    """pyarrow's nested file: both packages read the same columns.  (Not
    maps: pyarrow annotates the group MAP, which neither package's schema
    reader takes for a map, as tests/test_parquet_nested.py does not.)"""
    data = SHAPES[kind]
    pa_type = {"list_int": pa.list_(pa.int64()),
               "struct": pa.struct([("x", pa.int64()), ("y", pa.string())]),
               "list_struct": pa.list_(pa.struct([("a", pa.int64()),
                                                  ("b", pa.string())])),
               "list_list": pa.list_(pa.list_(pa.int64()))}[kind]
    sink = io.BytesIO()
    papq.write_table(pa.table({"c": pa.array(data, pa_type)}), sink,
                     compression="NONE", use_dictionary=False)
    jr = jpq.read_parquet(sink.getvalue())
    pr = ppq.read_parquet(sink.getvalue(), device="cpu")
    tp.assert_batch_equal(jr, pr)
    assert pr["c"].to_pylist() == data


def test_shred_levels_equal_jax():
    """The leaf streams (paths, levels, values) of a list of structs."""
    from arrowtpu.formats import parquet_nested as jnest

    jb, pb, _ = _batches("list_struct")
    jl = jnest.shred_column("c", jb["c"], True)
    pl = pnest.shred_column("c", pb["c"], True)
    assert [x.path for x in pl] == [x.path for x in jl]
    for a, b in zip(jl, pl):
        assert (a.max_def, a.max_rep, a.num_entries) == (
            b.max_def, b.max_rep, b.num_entries)
        np.testing.assert_array_equal(a.def_levels, b.def_levels)
        np.testing.assert_array_equal(a.rep_levels, b.rep_levels)
        if isinstance(a.values, list):
            assert [bytes(v) for v in a.values] == [bytes(v)
                                                    for v in b.values]
        else:
            np.testing.assert_array_equal(np.asarray(a.values),
                                          np.asarray(b.values))
