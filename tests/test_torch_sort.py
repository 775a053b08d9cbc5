"""arrowtpu_torch.ops.sort against arrowtpu.ops.sort on the same numpy
inputs: sort_to_indices, sort, lexsort_to_indices (with limit),
sort_batch, rank, partition and partition_ranges, over int8-int64, bool,
float32 and float64 keys (with +-0, +-inf, NaNs of both signs and nulls)
and a dictionary column with unsorted values and null keys; then
BASELINE config 3's columns at 4096 rows.

Tolerance: exact.  Index columns are compared over their first `length`
entries (the packages pad to different capacities), ranks as values plus
validity bools, sorted floats by their bits.  Every case has N rows, so
the JAX side compiles few shapes.
"""

import numpy as np
import pytest
import torch

import arrowtpu as at
from arrowtpu import config as jconfig
from arrowtpu import schema as jst
from arrowtpu.core import bitmap as jbm
from arrowtpu.core import column as jcol
from arrowtpu.ops import sortmod as jsort

import torch_parity as tp
import arrowtpu_torch as pt
from arrowtpu_torch import config as pconfig
from arrowtpu_torch import entry as pe
from arrowtpu_torch import schema as pst
from arrowtpu_torch.core import column as pcol
from arrowtpu_torch.ops import sortmod as psort
from arrowtpu_torch.rowformat import encode as prf

N = 256
ORDERS = [(False, True), (False, False), (True, True), (True, False)]
F64_SPECIAL = np.array([0x0000000000000000, 0x8000000000000000,  # +0, -0
                        0x7FF0000000000000, 0xFFF0000000000000,  # +-inf
                        0x7FF8000000000000, 0xFFF8000000000000,  # +-NaN
                        0x7FF0000000000001, 0x0000000000000001],  # sNaN, min
                       np.uint64).view(np.float64)
F32_SPECIAL = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000,
                        0x7FC00000, 0xFFC00000, 0x7F800001, 0x00000001],
                       np.uint32).view(np.float32)


def _values(rng, dtype):
    if dtype == "bool":
        return rng.random(N) < 0.5
    if dtype.startswith("float"):
        v = np.round(rng.standard_normal(N), 1).astype(dtype)
        special = F64_SPECIAL if dtype == "float64" else F32_SPECIAL
        v[rng.choice(N, 3 * len(special), replace=False)] = np.tile(special, 3)
        return v
    info = np.iinfo(dtype)
    v = rng.integers(-20, 20, N).astype(dtype)
    v[:2] = [info.min, info.max]
    return v


def _pair(values, valid, dtype):
    return tp.jax_column(values, valid, dtype), tp.port_column(values, valid,
                                                               dtype)


def _opts(d, nf):
    return jconfig.SortOptions(d, nf), pconfig.SortOptions(d, nf)


def _dictionary(rng):
    """A dictionary of 12 unsorted words over N keys, 10 % of them null."""
    words = [f"w{i:02d}" for i in rng.permutation(12)]
    keys = rng.integers(0, 12, N, dtype=np.int32)
    valid = rng.random(N) > 0.1
    jdt, pdt = (jst.Dictionary(jst.int32, jst.utf8),
                pst.Dictionary(pst.int32, pst.utf8))
    jproto = jcol.dictionary_encode_host(words, jdt)
    pproto = pcol.dictionary_encode_host(words, pdt, device="cpu")
    jc = jcol.DictionaryColumn(
        at.primitive(keys, at.schema.int32,
                     validity=jbm.from_numpy_bools(valid), length=N),
        jproto.values, jproto.value_ranks, jdt)
    pc = pcol.DictionaryColumn(
        pt.primitive(keys, pst.int32, validity=valid, device="cpu"),
        pproto.values, pproto.value_ranks, pdt)
    return jc, pc


def _indices(jidx, pidx):
    n = int(jidx.length)
    assert pidx.length == n and str(pidx.dtype) == str(jidx.dtype) == "int32"
    assert not pidx.values[n:].any()
    return np.asarray(jidx.values)[:n], pidx.values[:n].numpy()


def _bits(v):
    return v.view(np.uint64 if v.itemsize == 8 else np.uint32) \
        if v.dtype.kind == "f" else v


DTYPES = ["int8", "int16", "int32", "int64", "bool", "float32", "float64"]


@pytest.mark.parametrize("descending,nulls_first", ORDERS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_sort_to_indices_matches_jax(dtype, descending, nulls_first):
    rng = np.random.default_rng(DTYPES.index(dtype))
    jc, pc = _pair(_values(rng, dtype), rng.random(N) > 0.15, dtype)
    jo, po = _opts(descending, nulls_first)
    want, got = _indices(jsort.sort_to_indices(jc, jo),
                         psort.sort_to_indices(pc, po))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["int64", "float64"])
def test_sort_matches_jax(dtype):
    rng = np.random.default_rng(40)
    jc, pc = _pair(_values(rng, dtype), rng.random(N) > 0.15, dtype)
    jo, po = _opts(True, False)
    jv, jok, jn = tp.jax_to_numpy(jsort.sort(jc, jo))
    pv, pok, pn = pt.column_to_numpy(psort.sort(pc, po))
    assert pn == jn
    np.testing.assert_array_equal(pok, jok)
    np.testing.assert_array_equal(_bits(pv), _bits(jv))


@pytest.mark.parametrize("limit", [None, 10, 1000])
def test_lexsort_matches_jax(limit):
    rng = np.random.default_rng(50)
    cols = [_pair(_values(rng, "int32"), rng.random(N) > 0.3, "int32"),
            _pair(_values(rng, "float64"), rng.random(N) > 0.1, "float64"),
            _dictionary(rng)]
    opts = [_opts(*o) for o in ORDERS[1:]]
    jcols, pcols = zip(*cols)
    jopts, popts = zip(*opts)
    jidx = jsort.lexsort_to_indices(list(jcols), list(jopts), limit)
    pidx = psort.lexsort_to_indices(list(pcols), list(popts), limit)
    want, got = _indices(jidx, pidx)
    np.testing.assert_array_equal(got, want)
    if limit is not None:
        assert pidx.capacity == pt.config.round_up(min(limit, N))


@pytest.mark.parametrize("descending,nulls_first", ORDERS)
def test_dictionary_sort_matches_jax(descending, nulls_first):
    jc, pc = _dictionary(np.random.default_rng(60))
    jo, po = _opts(descending, nulls_first)
    want, got = _indices(jsort.sort_to_indices(jc, jo),
                         psort.sort_to_indices(pc, po))
    np.testing.assert_array_equal(got, want)
    assert psort.sort(pc, po).to_pylist() == jsort.sort(jc, jo).to_pylist()


def test_sort_batch_matches_jax():
    rng = np.random.default_rng(70)
    names = ["a", "f", "b"]
    pairs = [_pair(_values(rng, "int8"), rng.random(N) > 0.2, "int8"),
             _pair(_values(rng, "float32"), None, "float32"),
             _pair(_values(rng, "bool"), rng.random(N) > 0.2, "bool")]
    jb = at.record_batch({n: j for n, (j, _) in zip(names, pairs)})
    pb = pt.record_batch({n: p for n, (_, p) in zip(names, pairs)})
    jo, po = zip(_opts(False, False), _opts(True, True))
    jout = jsort.sort_batch(jb, ["a", "f"], list(jo), limit=100)
    pout = psort.sort_batch(pb, ["a", "f"], list(po), limit=100)
    for name in names:
        jv, jok, jn = tp.jax_to_numpy(jout[name])
        pv, pok, pn = pt.column_to_numpy(pout[name])
        assert pn == jn == 100
        np.testing.assert_array_equal(pok, jok)
        np.testing.assert_array_equal(_bits(pv), _bits(jv))


@pytest.mark.parametrize("descending,nulls_first", ORDERS[::3])
@pytest.mark.parametrize("dtype", ["int32", "bool", "float64", "dict"])
def test_rank_matches_jax(dtype, descending, nulls_first):
    rng = np.random.default_rng(80)
    if dtype == "dict":
        jc, pc = _dictionary(rng)
    else:
        jc, pc = _pair(_values(rng, dtype), rng.random(N) > 0.15, dtype)
    jo, po = _opts(descending, nulls_first)
    jr, pr = jsort.rank(jc, jo), psort.rank(pc, po)
    jv, jok, jn = tp.jax_to_numpy(jr)
    pv, pok, pn = pt.column_to_numpy(pr)
    assert pn == jn and str(pr.dtype) == str(jr.dtype)
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pok, jok)
    tp.assert_zero_padding(pr)


def test_partition_matches_jax():
    """Partition of a batch sorted by (int16, float64) with ties, NaNs and
    nulls, as boundaries and as host ranges."""
    rng = np.random.default_rng(90)
    a = np.sort(rng.integers(0, 5, N)).astype(np.int16)
    f = np.tile(F64_SPECIAL[[1, 0, 0, 4, 4, 5, 2, 2]], N // 8)
    valid = rng.random(N) > 0.1
    cols = [_pair(a, None, "int16"), _pair(f, valid, "float64")]
    jcols, pcols = zip(*cols)
    jp = jsort.partition(list(jcols))
    pp = psort.partition(list(pcols))
    np.testing.assert_array_equal(pt.column_to_numpy(pp)[0],
                                  tp.jax_to_numpy(jp)[0])
    assert psort.partition_ranges(pp) == jsort.partition_ranges(jp)


def test_config3_shape_matches_jax():
    """BASELINE config 3's columns (bench.py config3_lexsort's draw) at
    4096 rows: the port's index equals the JAX package's and np.lexsort's
    over the total-order key, and passes the host check."""
    n = 4096
    i32, f64, keys, words = pe.example_lexsort_arrays(n)
    jdt = jst.Dictionary(jst.int32, jst.utf8)
    proto = jcol.dictionary_encode_host(words, jdt)
    jcols = [at.primitive(i32, at.schema.int32, length=n),
             at.primitive(f64, at.schema.float64, length=n),
             jcol.DictionaryColumn(at.primitive(keys, at.schema.int32,
                                                length=n),
                                   proto.values, proto.value_ranks, jdt)]
    pcols = pe.example_lexsort_columns(n, device="cpu")
    want, got = _indices(jsort.lexsort_to_indices(jcols),
                         pe.lexsort_step(pcols))
    np.testing.assert_array_equal(got, want)
    sort_keys = pe.lexsort_keys(i32, f64, keys, words)
    np.testing.assert_array_equal(got, np.lexsort(sort_keys[::-1]))
    pe.check_lexsort(got, sort_keys)
    swapped = got.copy()
    swapped[[0, 1]] = swapped[[1, 0]]
    with pytest.raises(AssertionError):
        pe.check_lexsort(swapped, sort_keys)


def test_dictionary_and_string_columns_match_jax():
    words = ["pear", None, "apple", "a much longer string", "pear", "", "b"]
    jd = jcol.dictionary_encode_host(words)
    pd = pcol.dictionary_encode_host(words, device="cpu")
    assert pd.to_pylist() == jd.to_pylist() == words
    n_values = int(jd.values.length)
    np.testing.assert_array_equal(pd.value_ranks[:n_values].numpy(),
                                  np.asarray(jd.value_ranks)[:n_values])
    js, ps = jcol.string_view(words), pcol.string_view(words, device="cpu")
    assert ps.to_pylist() == js.to_pylist() == words
    assert ps.len_bound == js.len_bound
    np.testing.assert_array_equal(ps.views.numpy().view(np.uint32),
                                  np.asarray(js.views)[:ps.capacity])


def test_float_columns_cross_numpy_with_validity():
    for values in (F64_SPECIAL, F32_SPECIAL):
        valid = np.array([True, False] * 4)
        c = pt.column_from_numpy(values, valid, device="cpu")
        assert str(c.dtype) == f"float{values.itemsize * 8}"
        v, ok, n = pt.column_to_numpy(c)
        np.testing.assert_array_equal(_bits(v), _bits(values))
        np.testing.assert_array_equal(ok, valid)
        jv, jok, _ = tp.jax_to_numpy(tp.jax_column(values, valid,
                                                   str(values.dtype)))
        np.testing.assert_array_equal(_bits(jv), _bits(values))


def test_float_key_is_total_order():
    """float_key's signed order is the total order: the special values in
    their total order, then any two floats ordered by numpy's < where both
    are numbers and differ."""
    order = [0xFFF8000000000000, 0xFFF0000000000000, 0xBFF0000000000000,
             0x8000000000000000, 0x0000000000000000, 0x3FF0000000000000,
             0x7FF0000000000000, 0x7FF0000000000001, 0x7FF8000000000000]
    x = torch.from_numpy(np.array(order, np.uint64).view(np.float64))
    keys = prf.float_key(x)
    assert torch.all(keys[1:] > keys[:-1])
    y = torch.from_numpy(np.random.default_rng(3).standard_normal(1000))
    k = prf.float_key(y)
    assert torch.equal(torch.argsort(k, stable=True),
                       torch.argsort(y, stable=True))
    k32 = prf.float_key(y.to(torch.float32))
    assert torch.equal(torch.argsort(k32, stable=True),
                       torch.argsort(y.to(torch.float32), stable=True))


def test_errors():
    c = pt.primitive(np.arange(10), device="cpu")
    with pytest.raises(pst.ComputeError):
        psort.lexsort_to_indices([])
    with pytest.raises(pst.ComputeError):
        psort.lexsort_to_indices([c, pt.primitive(np.arange(100),
                                                  device="cpu")])
    with pytest.raises(pst.ComputeError):  # a list of non-primitives
        psort.sort_to_indices(pcol.from_pylist(
            [[{"a": 1}], [{"a": 2}]],
            pst.List(pst.Struct((pst.Field("a", pst.int64),))),
            device="cpu"))
