"""arrowtpu_torch's decimal arithmetic, its group-by over string, decimal
and fixed-size binary keys with decimal aggregates, and TPC-H Q1, against
the JAX package on the same inputs and against Q1's numpy oracle.

Decimal add / sub (columns and scalars, overflow to null), neg, abs_,
rescale, the casts and min_max; group_by with nulls in keys and values;
q1_step over a small `lineitem` (sf 0.0007, 4,204 rows) against the JAX
pipeline (`cmp.lt_eq` -> `filter_record_batch` -> the decimal prices ->
`group_by` -> `sort_batch`) and against `q1_oracle`.  Tolerance: exact
(limbs and validity bit for bit, means as float64 bits).
"""

import decimal

import numpy as np
import pytest

import torch_parity as tp
from torch_parity import release_jax_caches  # noqa: F401
import arrowtpu as at
import arrowtpu.schema as js
from arrowtpu import ops as jops
from arrowtpu.core import batch as jbt
from arrowtpu.core import column as jcol
from arrowtpu.core import limbs as jl
from arrowtpu.ops import cmp as jcmp
from arrowtpu.ops import decimal as jdec
from arrowtpu.ops import groupby as jgb
from arrowtpu.ops import sortmod as jsort

import arrowtpu_torch.schema as ps
from arrowtpu_torch import entry as pe
from arrowtpu_torch.core import batch as pbt
from arrowtpu_torch.core import column as pcol
from arrowtpu_torch.core import limbs as pl
from arrowtpu_torch.ops import decimal as pdec
from arrowtpu_torch.ops import groupby as pgb

D = decimal.Decimal
N = 4204  # the rows of Q1's lineitem at sf 0.0007: its JAX shapes are shared
_CLS = {1: "Decimal32", 2: "Decimal64", 4: "Decimal128", 8: "Decimal256"}


def _decimals(seed, n_limbs, prec, scale, lo, hi, nulls=0.1):
    """A decimal column in both packages from the same unscaled ints."""
    rng = np.random.default_rng(seed)
    ints = [lo + int(x * (hi - lo)) for x in rng.random(N)]
    ints[:2] = [hi - 1, lo]
    valid = rng.random(N) > nulls
    limbs = jl.split_ints(ints, n_limbs)
    jc = at.primitive(limbs, getattr(js, _CLS[n_limbs])(prec, scale),
                      validity=tp.jbm.from_numpy_bools(valid))
    pc = pcol.primitive(limbs, getattr(ps, _CLS[n_limbs])(prec, scale),
                        validity=valid, device="cpu")
    return jc, pc


# ---------------------------------------------------------------------------
# TPC-H Q1
# ---------------------------------------------------------------------------


def test_q1_step_matches_oracle_and_jax():
    from test_torch_decimal import _jax_lineitem

    arrays = pe.example_lineitem_arrays(sf=0.0007, seed=6)
    n = len(arrays["l_orderkey"])
    assert n == 4204
    out = pe.q1_step(pe.lineitem_batch(arrays, device="cpu"))
    want = pe.q1_oracle(arrays)
    assert pe.check_q1(out, arrays, want) == 4162
    assert want["keys"] == [(b"A", b"F"), (b"N", b"F"), (b"N", b"O"),
                            (b"R", b"F")]
    # the JAX package's pipeline on the same columns
    jb = _jax_lineitem(arrays)
    jb = jbt.record_batch({k: jb[k] for k in pe.Q1_READS + ("l_shipdate",)})
    kept = jops.filter_record_batch(
        jb, jcmp.lt_eq(jb["l_shipdate"], pe.q1_date()))
    disc_price = jdec.mul(kept["l_extendedprice"],
                          jdec.neg(jdec.sub(kept["l_discount"], 1)))
    charge = jdec.mul(disc_price, jdec.add(kept["l_tax"], 1))
    assert [str(c.dtype) for c in (disc_price, charge)] == \
        ["decimal128(32,4)", "decimal128(38,6)"]
    grouped = jgb.group_by(
        jbt.record_batch({**{k: kept[k] for k in pe.Q1_READS},
                          "disc_price": disc_price, "charge": charge}),
        pe.Q1_KEYS, [agg for _, agg in pe.Q1_AGGS])
    jout = jsort.sort_batch(grouped, pe.Q1_KEYS)
    for f, c in zip(jout.schema.fields, out.columns):
        tp.assert_column_equal(jout[f.name], c, f.name)
    # every sum_charge is the exact sum of ext * (100 - disc) * (100 + tax)
    assert pl.join_ints(out["sum_charge"].values[:4].numpy()) == \
        want["sum_charge"]


# (op, a: (limbs, precision, scale, lo, hi), b: the same or a scalar)
ADDSUB = {
    "add_128_64": ("add", (4, 20, 2, -10**12, 10**12),
                   (2, 18, 4, -10**15, 10**15)),
    "sub_scalar": ("sub", (4, 15, 2, -10**6, 10**6), D("1")),
    "add_scalar_left_scale": ("add", (2, 12, 3, -10**9, 10**9), D("0.5")),
    "add_overflow_32": ("add", (1, 9, 0, 4 * 10**8, 6 * 10**8),
                        (1, 9, 0, 4 * 10**8, 6 * 10**8)),
    "sub_overflow_128": ("sub", (4, 38, 0, -10**18, 10**18), D(10**38 - 5)),
}


@pytest.mark.parametrize("case", sorted(ADDSUB))
def test_decimal_add_sub_match_jax(case):
    op, a, b = ADDSUB[case]
    ja, pa = _decimals(1, *a)
    if isinstance(b, tuple):
        jb, pb = _decimals(2, *b)
    else:
        jb = pb = b
    j, p = getattr(jdec, op)(ja, jb), getattr(pdec, op)(pa, pb)
    tp.assert_column_equal(j, p, case)
    if "overflow" in case:  # some rows overflow the result's precision
        assert 0 < p.null_count() < N


def test_decimal_unary_and_rescale_match_jax():
    ja, pa = _decimals(3, 4, 20, 3, -10**15, 10**15)
    for fn in ("neg", "abs_"):
        tp.assert_column_equal(getattr(jdec, fn)(ja), getattr(pdec, fn)(pa),
                               fn)
    # up a scale, down (truncating toward zero), into a narrower width
    # where large values overflow to null, and into Decimal256
    for name in ("Decimal128(25, 5)", "Decimal128(20, 1)",
                 "Decimal64(12, 3)", "Decimal256(40, 6)"):
        cls, args = name.split("(")
        p_, s_ = (int(x) for x in args.rstrip(")").split(","))
        j = jdec.rescale(ja, getattr(js, cls)(p_, s_))
        p = pdec.rescale(pa, getattr(ps, cls)(p_, s_))
        tp.assert_column_equal(j, p, name)
    narrow = pdec.rescale(pa, ps.Decimal64(12, 3))
    assert narrow.null_count() > pa.null_count()
    unsafe_j = jdec.rescale(ja, js.Decimal64(12, 3), safe=False)
    unsafe_p = pdec.rescale(pa, ps.Decimal64(12, 3), safe=False)
    tp.assert_column_equal(unsafe_j, unsafe_p, "unsafe")


def test_decimal_casts_match_jax():
    ja, pa = _decimals(4, 4, 30, 2, -10**14, 10**14)
    tp.assert_column_equal(jdec.to_int(ja, js.int64),
                           pdec.to_int(pa, ps.int64), "to_int")
    big_j, big_p = _decimals(4, 4, 38, 0, -10**18, 10**18)
    big_j = jdec.mul(big_j, 10**6)
    big_p = pdec.mul(big_p, 10**6)
    tp.assert_column_equal(jdec.to_int(big_j, js.int64),
                           pdec.to_int(big_p, ps.int64), "to_int overflow")
    tp.assert_column_equal(jdec.to_float(ja), pdec.to_float(pa), "to_float")
    rng = np.random.default_rng(4)
    for dt in ("int32", "int64"):
        ints, ok = rng.integers(-10**9, 10**9, N), rng.random(N) > 0.1
        ji, pi = tp.jax_column(ints, ok, dt), tp.port_column(ints, ok, dt)
        tp.assert_column_equal(jdec.from_int(ji, js.Decimal128(30, 4)),
                               pdec.from_int(pi, ps.Decimal128(30, 4)),
                               f"from_int {dt}")
    floats = np.round(rng.standard_normal(N) * 1000, 4)
    jf, pf = (tp.jax_column(floats, None, "float64"),
              tp.port_column(floats, None, "float64"))
    tp.assert_column_equal(jdec.from_float(jf, js.Decimal128(20, 3)),
                           pdec.from_float(pf, ps.Decimal128(20, 3)),
                           "from_float")


def test_decimal_strings_round_trip_like_jax():
    ja, pa = _decimals(5, 2, 12, 3, -10**9, 10**9)
    assert pdec.to_string(pa).to_pylist() == jdec.to_string(ja).to_pylist()
    texts = ["1.25", "-0.0005", None, "abc", "12345.6789"] * (N // 5)
    j = jdec.from_string(jcol.string_view(texts), js.Decimal64(12, 3))
    p = pdec.from_string(pcol.string_view(texts, device="cpu"),
                         ps.Decimal64(12, 3))
    tp.assert_column_equal(j, p, "from_string")


def test_decimal_min_max_match_jax():
    """Decimal128 min and max of 16 rows (the JAX package's halving tree
    compiles once a round), and of an all-null column."""
    ja, pa = _decimals(6, 4, 38, 2, -10**30, 10**30)
    none_j, none_p = _decimals(6, 4, 38, 2, 0, 9, nulls=1.0)
    for jc, pc in ((ja, pa), (none_j, none_p)):
        for is_min in (True, False):
            jv, jany = jdec.min_max(_head(jc), is_min)
            pv, pany = pdec.min_max(_head(pc), is_min)
            np.testing.assert_array_equal(pv.numpy(),
                                          np.asarray(jv).view(np.int32))
            assert bool(pany) == bool(jany)


def _head(c, n=16):
    """The first n rows of a decimal column of either package."""
    if isinstance(c, pcol.PrimitiveColumn):
        return pcol.primitive(c.values[:n], c.dtype,
                              validity=c.valid_bool()[:n], device="cpu")
    valid = tp.jax_to_numpy(c)[1][:n]
    return at.primitive(np.asarray(c.values)[:n], c.dtype,
                        validity=tp.jbm.from_numpy_bools(valid))


# ---------------------------------------------------------------------------
# group-by over string, decimal and fixed-size binary keys
# ---------------------------------------------------------------------------

WORDS = ["", "a", "a\0", "b", "twelve bytes", "thirteen byte",
         "sixteen bytes!!!"]
# v is the value-ordered column (its min and max are group ends); x's max
# is a segmented extreme; w is a Decimal256 (the decimal mean is Q1's)
AGGS = [("v", "sum"), ("v", "min"), ("v", "max"), ("v", "count"),
        ("x", "max"), ("w", "sum")]


def _group_batches(seed):
    rng = np.random.default_rng(seed)
    words = [None if rng.random() < 0.1 else WORDS[i]
             for i in rng.integers(0, len(WORDS), N)]
    fsb = [None if rng.random() < 0.1 else bytes([int(x), 0, 1])
           for x in rng.integers(0, 3, N)]
    jd, pd = _decimals(seed, 2, 10, 1, -3, 3, nulls=0.1)
    jv, pv = _decimals(seed + 1, 4, 30, 2, -10**12, 10**12, nulls=0.15)
    jw, pw = _decimals(seed + 2, 8, 60, 4, -10**20, 10**20, nulls=0.1)
    jx, px = _decimals(seed + 3, 2, 18, 3, -10**15, 10**15, nulls=0.1)
    ints = rng.integers(-100, 100, N)
    jb = jbt.record_batch({
        "s": jcol.string_view(words), "d": jd,
        "f": jcol.from_pylist(fsb, js.FixedSizeBinary(3)), "v": jv, "w": jw,
        "x": jx, "i": tp.jax_column(ints, None, "int64")})
    pb = pbt.record_batch({
        "s": pcol.string_view(words, device="cpu"), "d": pd,
        "f": pcol.from_pylist(fsb, ps.FixedSizeBinary(3), device="cpu"),
        "v": pv, "w": pw, "x": px, "i": tp.port_column(ints, None, "int64")})
    return jb, pb


def test_group_by_string_and_decimal_keys_match_jax():
    keys = ("s", "d")
    jb, pb = _group_batches(7)
    want = jgb.group_by(jb, list(keys), AGGS)
    got = pgb.group_by(pb, list(keys), AGGS)
    tp.assert_batch_equal(want, got)
    assert str(got["sum_v"].dtype) == "decimal128(38,2)"
    assert str(got["sum_w"].dtype) == "decimal256(76,4)"
    # a plan takes the sort pipeline, as the reference's does
    plan = pgb.plan_group_by(pb, list(keys), AGGS)
    assert plan.engine == "sort"
    tp.assert_batch_equal(want, plan(pb))


def test_group_by_fixed_size_binary_key():
    """A fixed-size binary key groups by its bytes (nulls one group,
    first), each group's rows counted, as a dictionary of the bytes
    groups them."""
    _, pb = _group_batches(7)
    got = pgb.group_by(pb, ["f"], [("i", "count"), ("i", "sum")])
    fsb = pb["f"].to_pylist()
    ints = pb["i"].to_pylist()
    keys = sorted(set(fsb), key=lambda b: (b is not None, b or b""))
    assert got["f"].to_pylist() == keys
    assert got["count_i"].to_pylist() == [fsb.count(k) for k in keys]
    assert got["sum_i"].to_pylist() == [
        sum(i for b, i in zip(fsb, ints) if b == k) for k in keys]


def test_decimal_values_under_an_int_key_take_the_sort_pipeline():
    jb, pb = _group_batches(8)
    rng = np.random.default_rng(8)
    k = rng.integers(0, 4, N)
    jb = jbt.record_batch({"k": tp.jax_column(k, None, "int32"),
                           "v": jb["v"]})
    pb = pbt.record_batch({"k": tp.port_column(k, None, "int32"),
                           "v": pb["v"]})
    aggs = [("v", "sum"), ("v", "mean"), ("v", "min")]
    assert pgb.plan_group_by(pb, ["k"], aggs).engine == "sort"
    tp.assert_batch_equal(jgb.group_by(jb, ["k"], aggs),
                          pgb.group_by(pb, ["k"], aggs))


@pytest.mark.parametrize("agg", ["min", "max"])
def test_string_value_aggregates_raise_like_jax(agg):
    jb, pb = _group_batches(9)
    with pytest.raises(js.ComputeError):
        jgb.group_by(jb, ["i"], [("s", agg)])
    with pytest.raises(ps.ComputeError):
        pgb.group_by(pb, ["i"], [("s", agg)])
