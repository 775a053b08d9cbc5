"""Parity of arrowtpu_torch's group_by with arrowtpu.ops.groupby on the
same numpy inputs: an int64 key takes the sort pipeline in both packages,
an int32 key without nulls the dense-range engine; float, dictionary and
boolean keys and float and boolean values take the sort pipeline.
Tolerance: exact (keys, sums, counts, mins, maxes, group order, validity as
bools, length, zero padding; float keys, mins and maxes by their bits).
Integer values stay far inside int64, so no sum wraps; the mean is an exact
int64 sum over an exact count, one division.

Float sums and means are the reference's prefix difference of an f64
cumsum.  JAX's cumsum on the CPU does not add in sequence (most prefixes of
a random f64 vector differ from numpy's and torch's in the last bits), so
a float sum is held bit-exact on values that are small multiples of 1/8,
where every prefix is exact, and otherwise within 2**-40 x the sum of |v|
over the column (a bound on any prefix's rounding at 2**-52 a step over a
few thousand rows), the mean within that over the count."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

import arrowtpu as at
import torch_parity as tp
from torch_parity import release_jax_caches  # noqa: F401
from arrowtpu import schema as jst
from arrowtpu.core import batch as jbt
from arrowtpu.core import bitmap as jbm
from arrowtpu.core import column as jcol
from arrowtpu.ops import groupby as jgb
from arrowtpu_torch import schema as pst
from arrowtpu_torch.core import batch as pbt
from arrowtpu_torch.core import column as pcol
from arrowtpu_torch.interop.numpy_bridge import column_to_numpy
from arrowtpu_torch.ops import groupby as pgb


def _batches(spec, n, seed, length=None, jax_bitmaps=False):
    """spec: [(name, dtype, lo, hi, null_density)] -> (JAX batch, port
    batch) of n rows, `length` of them live (default all).  With
    `jax_bitmaps` every JAX column gets a validity bitmap (all valid where
    the spec has no nulls), so that cases with and without nulls share one
    compiled JAX program; the port's columns keep none."""
    rng = np.random.default_rng(seed)
    jcols, pcols = {}, {}
    for name, dt, lo, hi, nulls in spec:
        vals = rng.integers(lo, hi, n)
        valid = rng.random(n) > nulls if nulls else None
        jvalid = np.ones(n, bool) if valid is None and jax_bitmaps else valid
        jcols[name] = tp.jax_column(vals, jvalid, dt)
        pcols[name] = tp.port_column(vals, valid, dt)
        if length is not None:
            jcols[name] = jcols[name].with_length(length)
            pcols[name] = pcol._set_length(pcols[name], length)
    return jbt.record_batch(jcols), pbt.record_batch(pcols)


def _check(spec, keys, aggs, n=2000, seed=0):
    jb, pb = _batches(spec, n, seed)
    tp.assert_batch_equal(jgb.group_by(jb, keys, aggs),
                          pgb.group_by(pb, keys, aggs))


ALL = [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max"),
       ("v", "mean")]


@pytest.mark.parametrize("key_nulls,value_nulls", [(0.0, 0.0), (0.1, 0.1),
                                                   (0.3, 0.5)])
def test_int64_key_sort_path(key_nulls, value_nulls):
    spec = [("k", "int64", -40, 40, key_nulls),
            ("v", "int64", -10**6, 10**6, value_nulls)]
    _check(spec, ["k"], ALL)


def test_int64_high_cardinality_with_second_minmax_column():
    """w's min/max are not the value-ordered tie-break column, so they take
    the segmented reduction instead of a compaction."""
    spec = [("k", "int64", 0, 1500, 0.1), ("v", "int64", -100, 100, 0.1),
            ("w", "int64", -10**9, 10**9, 0.2)]
    _check(spec, ["k"], [("v", "min"), ("w", "max"), ("w", "min"),
                         ("v", "count"), ("w", "sum")], seed=1)


@functools.partial(tp.jit, static_argnums=(1, 2))
def _jax_dense_group_by(batch, keys, aggs):
    """The JAX package's dense engine alone, the branch its `group_by`
    takes for a key range below its bucket count: its dispatch compiles a
    cond over both engines (about 20 s here)."""
    kc = batch[keys[0]]
    ok = kc.valid_bool() & jbm.row_mask_bool(batch.capacity, batch.length)
    kmin = jnp.min(jnp.where(ok, kc.values, jnp.iinfo(kc.values.dtype).max))
    return jbt.RecordBatch(jgb._dense_out_schema(batch, keys, aggs),
                           jgb._dense_group_by(batch, keys, aggs, kmin))


@pytest.mark.parametrize("value_nulls", [0.0, 0.2])
def test_int32_key_dense_path(value_nulls):
    """The dense-range engine in both packages (key range below the
    bucket count; the JAX package's rule checked on the host).  The JAX
    values carry bitmaps in both cases (all valid at 0.0), so the two
    share one compiled JAX program; the port's have none at 0.0."""
    spec = [("k", "int32", 0, 20, 0.0),
            ("v", "int32", -1000, 1000, value_nulls),
            ("w", "int64", -50, 50, value_nulls)]
    aggs = (("v", "sum"), ("v", "count"), ("v", "min"), ("w", "max"),
            ("w", "sum"), ("v", "mean"))
    jb, pb = _batches(spec, 2000, 2, jax_bitmaps=True)
    assert jgb._dense_eligible(jb, ("k",), aggs)
    k = tp.jax_to_numpy(jb["k"])[0]
    assert k.max() - k.min() < jgb.DENSE_BUCKETS - 1  # off 1: a bitmap
    plan = pgb.plan_group_by(pb, ["k"], aggs)
    assert plan.engine == "dense"
    tp.assert_batch_equal(_jax_dense_group_by(jb, ("k",), aggs),
                          pgb.group_by(pb, ["k"], aggs))


def test_two_keys_with_bool():
    spec = [("k", "int64", 0, 6, 0.1), ("flag", "bool", 0, 2, 0.1),
            ("v", "int64", -500, 500, 0.1)]
    _check(spec, ["k", "flag"], [("v", "sum"), ("v", "min"),
                                 ("v", "count")], seed=3)


def test_no_live_rows():
    """2000 rows of capacity, none live (the int64 sort path's schema and
    capacity, so the JAX program is the one compiled there)."""
    spec = [("k", "int64", 0, 6, 0.0), ("v", "int64", -5, 5, 0.0)]
    jb, pb = _batches(spec, 2000, 4, length=0)
    tp.assert_batch_equal(jgb.group_by(jb, ["k"], ALL),
                          pgb.group_by(pb, ["k"], ALL))


def test_unsupported_raises():
    import arrowtpu_torch as pt

    _, pb = _batches([("k", "int64", 0, 6, 0.0), ("v", "int64", 0, 5, 0.0)],
                     64, 5)
    with pytest.raises(pt.schema.ComputeError):
        pgb.group_by(pb, ["k"], [("v", "median")])


def test_string_values_raise():
    import arrowtpu_torch as pt

    pb = pbt.record_batch({"k": tp.port_column(np.arange(3), None, "int64"),
                           "s": pcol.string_view(["a", None, "b"],
                                                 device="cpu")})
    with pytest.raises(pt.schema.ComputeError):
        pgb.group_by(pb, ["k"], [("s", "count")])


# ---------------------------------------------------------------------------
# float, dictionary and boolean columns (the sort pipeline)
# ---------------------------------------------------------------------------

N = 2048
_UINT = {4: np.uint32, 8: np.uint64}
# +0, -0, +-inf, NaNs of three payloads (one negative), 1.5, -2.25
_SPECIAL_BITS = {
    np.float64: [0x0, 0x8000000000000000, 0x7FF0000000000000,
                 0xFFF0000000000000, 0x7FF8000000000000, 0x7FF8000000000001,
                 0xFFF8000000000000, 0x3FF8000000000000, 0xC002000000000000],
    np.float32: [0x0, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000,
                 0x7FC00001, 0xFFC00000, 0x3FC00000, 0xC0100000]}


def _special_floats(rng, dt, n):
    bits = np.asarray(_SPECIAL_BITS[dt], _UINT[np.dtype(dt).itemsize])
    return bits[rng.integers(0, len(bits), n)].view(dt)


def _bits(v):
    return v.view(_UINT[v.itemsize]) if v.dtype.kind == "f" else v


def _assert_bits_equal(jb, pb, names):
    """The named columns' values (under nulls too) bit for bit."""
    for name in names:
        jv, _, n = tp.jax_to_numpy(jb[name])
        pv, _, _ = column_to_numpy(pb[name])
        np.testing.assert_array_equal(_bits(pv), _bits(jv[:n]), name)


def _pair_batch(cols):
    """{name: (values, valid or None, dtype name)} -> (JAX, port)."""
    return (jbt.record_batch({k: tp.jax_column(*c) for k, c in cols.items()}),
            pbt.record_batch({k: tp.port_column(*c)
                              for k, c in cols.items()}))


@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_float_keys(dt):
    """-0.0 and +0.0, and NaNs of other payloads, are groups of their own
    (the total order's encoding), as in the reference.

    The reference's float32 key output is not its input: its group
    extraction casts each carried key to uint32 by value (-inf and NaN
    become 0, 1.5 becomes 1).  So a float32 key is held to the reference
    run on the same keys widened to float64 (widening keeps the total
    order and gives each of these bit patterns its own), its keys narrowed
    back bit for bit."""
    rng = np.random.default_rng(7)
    k = _special_floats(rng, np.dtype(dt).type, N)
    k_ok = rng.random(N) > 0.1
    v = (rng.integers(-1000, 1000, N), rng.random(N) > 0.2, "int64")
    jb = jbt.record_batch({"k": tp.jax_column(k.astype(np.float64), k_ok,
                                              "float64"),
                           "v": tp.jax_column(*v)})
    pb = pbt.record_batch({"k": tp.port_column(k, k_ok, dt),
                           "v": tp.port_column(*v)})
    aggs = [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max")]
    want, got = jgb.group_by(jb, ["k"], aggs), pgb.group_by(pb, ["k"], aggs)
    for name in ("sum_v", "count_v", "min_v", "max_v"):
        tp.assert_column_equal(want[name], got[name], name)
    jk, jok, n = tp.jax_to_numpy(want["k"])
    pk, pok, pn = column_to_numpy(got["k"])
    assert pn == n == 10  # nine bit patterns and the null group
    assert str(got["k"].dtype) == dt
    np.testing.assert_array_equal(pok, jok)
    np.testing.assert_array_equal(_bits(pk), _bits(jk[:n].astype(dt)))
    tp.assert_zero_padding(got["k"])


def test_dictionary_key_with_int_key():
    """A dictionary key groups by its values' rank; the output keeps the
    dictionary and each group's first key index (under nulls too)."""
    rng = np.random.default_rng(8)
    words = [f"w{i:02d}" for i in rng.permutation(12)]
    keys = rng.integers(0, 12, N, dtype=np.int32)
    valid = rng.random(N) > 0.1
    jproto = jcol.dictionary_encode_host(words, jst.Dictionary(jst.int32,
                                                               jst.utf8))
    pproto = pcol.dictionary_encode_host(
        words, pst.Dictionary(pst.int32, pst.utf8), device="cpu")
    jd = jcol.DictionaryColumn(
        at.primitive(keys, at.schema.int32,
                     validity=jbm.from_numpy_bools(valid), length=N),
        jproto.values, jproto.value_ranks, jproto.dtype)
    pd = pcol.DictionaryColumn(
        pcol.primitive(keys, pst.int32, validity=valid, device="cpu"),
        pproto.values, pproto.value_ranks, pproto.dtype)
    j2, v = rng.integers(0, 3, N), rng.integers(-50, 50, N)
    jb = jbt.record_batch({"d": jd, "j": tp.jax_column(j2, None, "int64"),
                           "v": tp.jax_column(v, None, "int64")})
    pb = pbt.record_batch({"d": pd, "j": tp.port_column(j2, None, "int64"),
                           "v": tp.port_column(v, None, "int64")})
    aggs = [("v", "sum"), ("v", "min"), ("v", "count")]
    want, got = (jgb.group_by(jb, ["d", "j"], aggs),
                 pgb.group_by(pb, ["d", "j"], aggs))
    for name in ("j", "sum_v", "min_v", "count_v"):
        tp.assert_column_equal(want[name], got[name], name)
    tp.assert_column_equal(want["d"].keys, got["d"].keys, "d keys")
    assert got["d"].values is pd.values
    assert got.length == 13 * 3


@pytest.mark.parametrize("dt,values", [
    ("float32", "eighths"), ("float64", "eighths"), ("float64", "special"),
    ("float64", "normal")])
def test_float_values(dt, values):
    """sum / mean by the prefix difference; min / max of the value-ordered
    column (v) and of a second column (w, the segmented reduction), in the
    total order."""
    rng = np.random.default_rng(9)
    npdt = np.dtype(dt).type

    def draw():
        if values == "eighths":
            return (rng.integers(-800, 800, N) / 8).astype(npdt)
        if values == "special":
            x = (rng.integers(-80, 80, N) / 8).astype(npdt)
            pick = rng.random(N) < 0.01
            x[pick] = _special_floats(rng, npdt, int(pick.sum()))
            return x
        return rng.standard_normal(N).astype(npdt) * 1e3

    v, w = draw(), draw()
    cols = {"k": (rng.integers(0, 40, N), rng.random(N) > 0.05, "int64"),
            "v": (v, rng.random(N) > 0.2, dt),
            "w": (w, rng.random(N) > 0.9, dt)}  # many groups all null
    jb, pb = _pair_batch(cols)
    aggs = [("v", "sum"), ("v", "mean"), ("v", "min"), ("v", "max"),
            ("v", "count"), ("w", "max"), ("w", "min"), ("w", "sum")]
    want, got = jgb.group_by(jb, ["k"], aggs), pgb.group_by(pb, ["k"], aggs)
    exact = ["k", "min_v", "max_v", "count_v", "max_w", "min_w"]
    sums = ["sum_v", "mean_v", "sum_w"]
    for name in exact + sums:
        assert str(want[name].dtype) == str(got[name].dtype), name
    if values != "normal":
        tp.assert_batch_equal(want, got)
        # a NaN out of arithmetic carries no defined payload, so sums over
        # NaNs are held as values (NaN equal to NaN), the rest by bits
        _assert_bits_equal(want, got,
                           exact + (sums if values == "eighths" else []))
        return
    for name in exact:
        tp.assert_column_equal(want[name], got[name], name)
    _assert_bits_equal(want, got, exact)
    counts = column_to_numpy(got["count_v"])[0].astype(np.float64)
    for name, col_ in (("sum_v", v), ("mean_v", v), ("sum_w", w)):
        jv, jok, n = tp.jax_to_numpy(want[name])
        pv, pok, pn = column_to_numpy(got[name])
        assert pn == n
        np.testing.assert_array_equal(pok, jok, name)
        tol = 2.0**-40 * np.abs(col_.astype(np.float64)).sum()
        if name == "mean_v":
            tol = tol / np.maximum(counts, 1)
        assert (np.abs(pv - jv[:n]) <= tol).all(), name
        tp.assert_zero_padding(got[name])


def test_bool_values():
    """Booleans aggregate as int32: sum, min and max give Int32 columns;
    b is the value-ordered column, c takes the segmented reduction."""
    rng = np.random.default_rng(10)
    cols = {"k": (rng.integers(0, 50, N), rng.random(N) > 0.1, "int64"),
            "b": (rng.random(N) > 0.5, rng.random(N) > 0.2, "bool"),
            "c": (rng.random(N) > 0.7, rng.random(N) > 0.8, "bool")}
    jb, pb = _pair_batch(cols)
    aggs = [("b", "min"), ("b", "sum"), ("b", "max"), ("b", "mean"),
            ("c", "max"), ("c", "min"), ("c", "sum"), ("c", "count")]
    want, got = jgb.group_by(jb, ["k"], aggs), pgb.group_by(pb, ["k"], aggs)
    tp.assert_batch_equal(want, got)
    assert str(got["sum_b"].dtype) == str(got["max_c"].dtype) == "int32"
