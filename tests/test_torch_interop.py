"""The host boundary of arrowtpu_torch against the JAX package's, every
column class each one takes, built from the same Python rows in both:

  * formats/layout: `column_to_layout`'s Node byte for byte against
    arrowtpu.formats.layout's (length, null count, every buffer over the
    live rows, children, a dictionary's values), and `layout_to_column`
    back to the column's rows;
  * interop/cdata: the port's export imported by the port (on the CPU)
    and by the JAX package, the JAX package's export imported by the
    port, the format strings (`tss:<zone>` included) and each struct's
    pin dropped once by its release;
  * interop/pyarrow_bridge: `to_pyarrow` equal to the JAX package's
    pa.Array, `from_pyarrow` equal to its column (`assert_column_equal`),
    the type and schema maps both ways, batches and tables;
  * utils/datagen: the same values for one seed.

Tolerance: exact.
"""

import ctypes
import decimal
import functools

import numpy as np
import pyarrow as pa
import pytest

import arrowtpu.schema as js
from arrowtpu.core import batch as jbt
from arrowtpu.core import column as jcol
from arrowtpu.formats import layout as jlayout
from arrowtpu.interop import cdata as jcdata
from arrowtpu.interop import pyarrow_bridge as jpb
from arrowtpu.utils import datagen as jgen

import torch_parity as tp
from torch_parity import release_jax_caches  # noqa: F401
import arrowtpu_torch.schema as ps
from arrowtpu_torch.core import batch as pbt
from arrowtpu_torch.core import column as pcol
from arrowtpu_torch.formats import layout as playout
from arrowtpu_torch.interop import cdata as pcdata
from arrowtpu_torch.interop import pyarrow_bridge as ppb
from arrowtpu_torch.utils import datagen as pgen

D = decimal.Decimal


def _ints(lo, hi, n=70, seed=1):
    rng = np.random.default_rng(seed)
    return [None if rng.random() < 0.15 else int(x)
            for x in rng.integers(lo, hi, n)]


WORDS = ["", "a", "twelve bytes", "thirteen byte", "a longer string here",
         None, "ü-umlaut"]
ROWS = {
    "bool": ("boolean", "boolean", [True, None, False, True] * 17 + [False]),
    "int8": ("int8", "int8", _ints(-128, 128)),
    "int16": ("int16", "int16", _ints(-2**15, 2**15)),
    "int32": ("int32", "int32", _ints(-2**31, 2**31)),
    "int64": ("int64", "int64", _ints(-2**62, 2**62)),
    "uint8": ("uint8", "uint8", _ints(0, 256)),
    "uint16": ("uint16", "uint16", _ints(0, 2**16)),
    "uint32": ("uint32", "uint32", _ints(0, 2**32)),
    "uint64": ("uint64", "uint64", _ints(0, 2**63) + [2**64 - 1]),
    "float32": ("float32", "float32", [1.5, None, -0.0, 2.25] * 10),
    "float64": ("float64", "float64", [1e300, None, -0.0, 2.5] * 10),
    "date32": (("Date32",), ("Date32",), _ints(-10**5, 10**5)),
    "ts_moscow": (("Timestamp", "s", "Europe/Moscow"),
                  ("Timestamp", "s", "Europe/Moscow"), _ints(-2**40, 2**40)),
    "ts_us": (("Timestamp", "us"), ("Timestamp", "us"), _ints(-2**60, 2**60)),
    "decimal128": (("Decimal128", 20, 2), ("Decimal128", 20, 2),
                   [D("1.25"), None, D("-99999999999999999.99"), D(0)] * 5),
    "utf8": ("utf8", "utf8", WORDS * 9),
    "binary": ("binary", "binary",
               [None if w is None else w.encode() for w in WORDS] * 3),
    "dict": (("Dictionary",), ("Dictionary",), ["x", None, "yy", "x"] * 6),
    "list": (("List", "int64"), ("List", "int64"),
             [[1, 2], None, [], [None, 5]] * 6),
    "map": (("Map", "utf8", "int64"), ("Map", "utf8", "int64"),
            [[("a", 1)], None, [], [("b", None), ("c", 3)]] * 5),
    "struct": (("Struct",), ("Struct",),
               [{"a": 1, "b": "q"}, None, {"a": None, "b": "a long one, "
                                                      "past 12"}] * 7),
    "fsl": (("FixedSizeList", "float32", 2),
            ("FixedSizeList", "float32", 2),
            [[1.0, 2.0], None, [None, 4.0]] * 7),
    "null": ("null", "null", [None] * 9),
}


def _dtype(mod, spec):
    if spec == "boolean" and mod is ps:
        return ps.bool_
    if isinstance(spec, str):
        return getattr(mod, spec)
    name, *args = spec
    if name == "Dictionary":
        return mod.Dictionary(mod.int32, mod.utf8)
    if name == "List":
        return mod.List(getattr(mod, args[0]))
    if name == "Map":
        return mod.Map(getattr(mod, args[0]), getattr(mod, args[1]))
    if name == "FixedSizeList":
        return mod.FixedSizeList(getattr(mod, args[0]), args[1])
    if name == "Struct":
        return mod.Struct((mod.Field("a", mod.int32), mod.Field("b", mod.utf8)))
    return getattr(mod, name)(*args)


@functools.lru_cache(maxsize=None)
def _columns(name, n=None):
    """(JAX column, port column, rows) of ROWS[name][:n], built once: the
    JAX package's from_pylist costs a fraction of a second a column."""
    jspec, pspec, rows = ROWS[name]
    rows = rows[:n]
    if name == "null":  # the JAX package's from_pylist takes no Null type
        return jcol.null_column(len(rows)), pcol.null_column(
            len(rows), "cpu"), rows
    return (jcol.from_pylist(rows, _dtype(js, jspec)),
            pcol.from_pylist(rows, _dtype(ps, pspec), device="cpu"), rows)


def _assert_node_equal(jn, pn, where):
    assert (pn.length, pn.null_count) == (jn.length, jn.null_count), where
    assert len(pn.buffers) == len(jn.buffers), where
    for i, (jb, pb) in enumerate(zip(jn.buffers, pn.buffers)):
        # the JAX package keeps a decimal's buffer as (n, 16) bytes
        assert pb.dtype == np.uint8 and pb.ndim == 1, where
        np.testing.assert_array_equal(pb, np.asarray(jb).reshape(-1),
                                      err_msg=f"{where} buffer {i}")
    assert len(pn.children) == len(jn.children), where
    for i, (jc, pc) in enumerate(zip(jn.children, pn.children)):
        _assert_node_equal(jc, pc, f"{where}.{i}")
    assert (jn.dictionary is None) == (pn.dictionary is None), where
    if pn.dictionary is not None:
        assert pn.dictionary.to_pylist() == jn.dictionary.to_pylist(), where


@pytest.mark.parametrize("name", list(ROWS))
def test_layout_matches_jax_and_rebuilds(name):
    jc, pc, rows = _columns(name)
    node = playout.column_to_layout(pc)
    _assert_node_equal(jlayout.column_to_layout(jc), node, name)
    back = playout.layout_to_column(node, pc.dtype, device="cpu")
    assert back.dtype == pc.dtype and back.to_pylist() == pc.to_pylist()
    tp.assert_zero_padding(back)


def test_union_layout_matches_jax():
    for mode, offsets in (("sparse", None), ("dense", [0, 0, 1, 1, 2])):
        tids = [0, 1, 0, 1, 0]
        n_kids = 5 if mode == "sparse" else 3
        kids = {"j": [jcol.from_pylist(list(range(n_kids)), js.int32),
                      jcol.from_pylist(["a", None, "c", "d", "e"][:n_kids],
                                       js.utf8)],
                "p": [pcol.from_pylist(list(range(n_kids)), ps.int32,
                                       device="cpu"),
                      pcol.from_pylist(["a", None, "c", "d", "e"][:n_kids],
                                       ps.utf8, device="cpu")]}
        jdt = js.Union((js.Field("i", js.int32), js.Field("s", js.utf8)),
                       (0, 1), mode)
        pdt = ps.Union((ps.Field("i", ps.int32), ps.Field("s", ps.utf8)),
                       (0, 1), mode)
        jc = jcol.union_column(tids, kids["j"], jdt, offsets=offsets)
        pc = pcol.union_column(tids, kids["p"], pdt, offsets=offsets,
                               device="cpu")
        node = playout.column_to_layout(pc)
        _assert_node_equal(jlayout.column_to_layout(jc), node, mode)
        back = playout.layout_to_column(node, pdt, device="cpu")
        assert back.to_pylist() == pc.to_pylist() == jc.to_pylist()


def test_string_offsets_and_list_indices_match_jax():
    jc, pc, _ = _columns("utf8")
    for j, p in zip(jlayout.string_offsets_data(jc),
                    playout.string_offsets_data(pc)):
        np.testing.assert_array_equal(p, j)
    jc, pc, _ = _columns("list")
    for j, p in zip(jlayout.list_flat_indices(jc),
                    playout.list_flat_indices(pc)):
        np.testing.assert_array_equal(p, j)


CDATA = ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
         "uint32", "uint64", "float32", "float64", "date32", "ts_moscow",
         "ts_us", "utf8", "binary", "dict", "list", "struct", "fsl", "null"]


def _addr(s, a):
    return ctypes.addressof(a), ctypes.addressof(s)


@pytest.mark.parametrize("name", CDATA)
def test_cdata_round_trips_and_crosses_packages(name):
    jc, pc, rows = _columns(name)
    pins = len(pcdata._EXPORTS)
    s, a = pcdata.export_column(pc, "col")
    js_, ja = jcdata.export_column(jc, "col")
    assert s.format == js_.format and s.name == b"col"
    assert len(pcdata._EXPORTS) == pins + 2
    back, field = pcdata.import_column(*_addr(s, a), device="cpu")
    assert len(pcdata._EXPORTS) == pins and not a.release and not s.release
    assert field.dtype == pc.dtype and field.name == "col"
    assert back.to_pylist() == rows
    tp.assert_zero_padding(back)
    # the port's export read by the JAX package, and the other way
    s, a = pcdata.export_column(pc)
    got, _ = jcdata.import_column(*_addr(s, a))
    assert got.to_pylist() == rows and str(got.dtype) == str(pc.dtype)
    got, _ = pcdata.import_column(*_addr(js_, ja), device="cpu")
    assert got.to_pylist() == rows and got.dtype == pc.dtype


def test_cdata_through_pyarrow():
    _, pc, rows = _columns("ts_moscow")
    arr = pcdata.export_to_pyarrow(pc, "t")
    assert arr.type == pa.timestamp("s", "Europe/Moscow")
    assert arr.cast(pa.int64()).to_pylist() == rows
    back = pcdata.import_from_pyarrow(arr, device="cpu")
    assert back.dtype == pc.dtype and back.to_pylist() == rows


def test_cdata_rejects_an_offset():
    _, pc, _ = _columns("int32")
    s, a = pcdata.export_column(pc)
    a.offset = 1
    with pytest.raises(ps.ArrowTpuError):
        pcdata.import_column(*_addr(s, a), device="cpu")
    a.release(ctypes.pointer(a))
    s.release(ctypes.pointer(s))


BRIDGE = [n for n in ROWS if n != "null"] + ["null"]


@pytest.mark.parametrize("name", BRIDGE)
def test_pyarrow_both_ways_match_jax(name):
    jc, pc, rows = _columns(name)
    arr = ppb.to_pyarrow(pc)
    want = jpb.to_pyarrow(jc)
    assert arr.type == want.type and arr.equals(want), name
    tp.assert_column_equal(jpb.from_pyarrow(want),
                           ppb.from_pyarrow(want, device="cpu"), name)
    sliced = want.slice(3)
    tp.assert_column_equal(jpb.from_pyarrow(sliced),
                           ppb.from_pyarrow(sliced, device="cpu"),
                           f"{name} sliced")


def test_types_and_schemas_both_ways_match_jax():
    specs = [spec for spec, _, _ in ROWS.values()] + [
        "float16", ("Date64",), ("Time32", "ms"), ("Time64", "ns"),
        ("Duration", "us"), ("Decimal256", 60, 5), ("Decimal32", 9, 2),
        ("Decimal64", 18, 3), ("FixedSizeBinary", 5),
        ("Interval", "month_day_nano")]
    for spec in specs:
        pdt = _dtype(ps, spec)
        t = ppb.dtype_to_pa(pdt)
        assert t == jpb.dtype_to_pa(_dtype(js, spec)), spec
        assert ppb.dtype_from_pa(t) == pdt
        assert str(ppb.dtype_from_pa(t)) == str(jpb.dtype_from_pa(t))
    for t in (pa.large_string(), pa.large_binary(), pa.string_view(),
              pa.large_list(pa.int8()), pa.list_view(pa.int8())):
        assert str(ppb.dtype_from_pa(t)) == str(jpb.dtype_from_pa(t))
    s = ps.Schema((ps.Field("a", ps.int32, False), ps.Field("b", ps.utf8)),
                  (("k", "v"),))
    pas = ppb.schema_to_pa(s)
    assert pas == jpb.schema_to_pa(js.Schema(
        (js.Field("a", js.int32, False), js.Field("b", js.utf8)),
        (("k", "v"),)))
    assert ppb.schema_from_pa(pas) == s


def test_batches_and_tables_match_jax():
    names = ["int64", "utf8", "list", "struct", "bool"]
    pb = pbt.record_batch({n: _columns(n, 20)[1] for n in names})
    jb = jbt.record_batch({n: _columns(n, 20)[0] for n in names})
    rb = ppb.to_pyarrow(pb)
    assert rb.equals(jpb.to_pyarrow(jb))
    tp.assert_batch_equal(jpb.from_pyarrow(rb), ppb.from_pyarrow(rb, "cpu"))
    table = pa.Table.from_batches([rb.slice(0, 7), rb.slice(7)])
    tp.assert_batch_equal(jpb.from_pyarrow(table),
                          ppb.from_pyarrow(table, "cpu"))


def test_datagen_draws_the_jax_values():
    for seed in (0, 5):
        tp.assert_batch_equal(
            jgen.create_random_batch(90, 0.2, jgen.seedable_rng(seed)),
            pgen.create_random_batch(90, 0.2, pgen.seedable_rng(seed), "cpu"))
    for dt in ("int8", "uint64", "float32", "boolean"):
        j = jgen.create_primitive_column(40, 0.1, getattr(js, dt),
                                         jgen.seedable_rng(3))
        p = pgen.create_primitive_column(
            40, 0.1, ps.bool_ if dt == "boolean" else getattr(ps, dt),
            pgen.seedable_rng(3), "cpu")
        tp.assert_column_equal(j, p, dt)
    tp.assert_column_equal(jgen.create_string_column(30, 0.2),
                           pgen.create_string_column(30, 0.2, device="cpu"))
    tp.assert_column_equal(jgen.create_dict_column(30, 4, 0.2),
                           pgen.create_dict_column(30, 4, 0.2, device="cpu"))
