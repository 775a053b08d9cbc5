"""arrowtpu_torch's comparisons and decimal kernels against the JAX package
on the same inputs, and TPC-H Q6 over a small `lineitem` against its numpy
oracle and against the JAX package's filter of the same columns.
Tolerance: exact (booleans, limbs bit for bit, the revenue as an integer
in units of 1e-4)."""

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

import arrowtpu_torch.schema as ps
from arrowtpu_torch import entry as pe
from arrowtpu_torch.core import column as pcol
from arrowtpu_torch.core import limbs as pl
from arrowtpu_torch.ops import cmp as pcmp
from arrowtpu_torch.ops import decimal as pdec

D = decimal.Decimal
N = 120
OPS = ["eq", "neq", "lt", "lt_eq", "gt", "gt_eq"]


def _decimals(seed, n_limbs, scale, lo=-2000, hi=2000, nulls=0.1):
    """A decimal column in both packages from the same unscaled ints."""
    rng = np.random.default_rng(seed)
    ints = rng.integers(lo, hi, N)
    valid = rng.random(N) > nulls
    limbs = jl.split_ints([int(x) for x in ints], n_limbs)
    cls = {1: "Decimal32", 2: "Decimal64", 4: "Decimal128",
           8: "Decimal256"}[n_limbs]
    prec = {1: 9, 2: 18, 4: 15, 8: 40}[n_limbs]
    jc = at.primitive(limbs, getattr(js, cls)(prec, scale),
                      validity=tp.jbm.from_numpy_bools(valid))
    pc = pcol.primitive(limbs, getattr(ps, cls)(prec, scale), validity=valid,
                        device="cpu")
    return jc, pc


@pytest.mark.parametrize("side", ["column", "scalar_right", "scalar_left"])
@pytest.mark.parametrize("op", OPS)
def test_decimal_cmp_matches_jax(op, side):
    ja, pa = _decimals(1, 4, 2)
    if side == "column":  # another scale and width: aligned to scale 4
        jb, pb = _decimals(2, 2, 4, -200_000, 200_000)
        args_j, args_p = (ja, jb), (pa, pb)
    elif side == "scalar_right":
        args_j, args_p = (ja, D("0.06")), (pa, D("0.06"))
    else:
        args_j, args_p = (7, ja), (7, pa)
    tp.assert_column_equal(getattr(jcmp, op)(*args_j), getattr(pcmp, op)(*args_p),
                f"{op} {side}")


def _native(kind, seed):
    rng = np.random.default_rng(seed)
    valid = rng.random(N) > 0.1
    if kind == "float64":
        vals = rng.integers(-5, 5, N).astype(np.float64)
        vals[::7] = np.nan
        vals[::11] = -0.0
        return (tp.jax_column(vals, valid, "float64"),
                tp.port_column(vals, valid, "float64"), 0.0)
    if kind == "int32":
        vals = rng.integers(-5, 5, N)
        return (tp.jax_column(vals, valid, "int32"),
                tp.port_column(vals, valid, "int32"), 2)
    jdt, pdt = {"date32": (js.Date32(), ps.Date32()),
                "timestamp": (js.Timestamp("ms"), ps.Timestamp("ms"))}[kind]
    vals = [None if not ok else int(v)
            for v, ok in zip(rng.integers(-5, 5, N), valid)]
    return jcol.from_pylist(vals, jdt), pcol.from_pylist(vals, pdt,
                                                         device="cpu"), 1


@pytest.mark.parametrize("kind", ["int32", "float64", "date32", "timestamp"])
@pytest.mark.parametrize("op", OPS + ["distinct", "not_distinct"])
def test_cmp_matches_jax(op, kind):
    ja, pa, scalar = _native(kind, 3)
    jb, pb, _ = _native(kind, 4)
    tp.assert_column_equal(getattr(jcmp, op)(ja, jb), getattr(pcmp, op)(pa, pb),
                f"{op} {kind} columns")
    tp.assert_column_equal(getattr(jcmp, op)(ja, scalar), getattr(pcmp, op)(pa, scalar),
                f"{op} {kind} scalar")


@pytest.mark.parametrize("case", ["128x128", "64x128", "128xint", "32x32",
                                  "256x128"])
def test_decimal_mul_matches_jax(case):
    a_limbs, b = {"128x128": (4, 4), "64x128": (2, 4), "128xint": (4, None),
                  "32x32": (1, 1), "256x128": (8, 4)}[case]
    ja, pa = _decimals(5, a_limbs, 2, -10**8, 10**8)
    if b is None:
        jb = pb = -37
    else:
        jb, pb = _decimals(6, b, 3, -10**8, 10**8)
    tp.assert_column_equal(jdec.mul(ja, jb), pdec.mul(pa, pb), case)


@pytest.mark.parametrize("case", ["128", "32_wrapping", "64_wrapping",
                                  "256", "all_null"])
def test_decimal_sum_matches_jax(case):
    n_limbs = {"128": 4, "32_wrapping": 1, "64_wrapping": 2, "256": 8,
               "all_null": 4}[case]
    lo, hi = (-10**12, 10**12)
    if case.endswith("wrapping"):  # the sum wraps at the limb count
        lo, hi = (2**30, 2**31 - 1) if n_limbs == 1 else (2**62, 2**63 - 1)
    ja, pa = _decimals(7, n_limbs, 2, lo, hi,
                       nulls=1.0 if case == "all_null" else 0.1)
    js_, jcount = jdec.sum_(ja)
    ps_, pcount = pdec.sum_(pa)
    np.testing.assert_array_equal(ps_.numpy(),
                                  np.asarray(js_).view(np.int32))
    assert int(pcount) == int(jcount)


def test_decimal_sum_wraps_like_the_tree():
    """A wrapping case checked against Python's exact sum modulo 2^(32 N)."""
    ja, pa = _decimals(8, 1, 0, 2**30, 2**31 - 1, nulls=0.0)
    total = sum(pl.join_ints(pa.values[:N].numpy()))
    got = pl.join_ints(pdec.sum_(pa)[0].reshape(1, -1).numpy())[0]
    want = (total + 2**31) % 2**32 - 2**31
    assert got == want and total != want
    np.testing.assert_array_equal(pdec.sum_(pa)[0].numpy(),
                                  np.asarray(jdec.sum_(ja)[0]).view(np.int32))


# ---------------------------------------------------------------------------
# TPC-H Q6
# ---------------------------------------------------------------------------


def _jax_lineitem(arrays):
    """The same lineitem columns as JAX-package columns."""
    cols = {}
    for name in pe.LINEITEM_COLUMNS:
        a = arrays[name]
        if name in pe.LINEITEM_DECIMALS:
            cols[name] = at.primitive(pl.split_int64(a, 4),
                                      js.Decimal128(15, 2))
        elif name in pe.LINEITEM_DATES:
            cols[name] = at.primitive(a, js.Date32())
        elif name in pe.LINEITEM_FLAGS:
            alphabet = pe.LINEITEM_FLAGS[name].decode()
            cols[name] = jcol.string_view([alphabet[i] for i in a])
        elif name in ("l_shipinstruct", "l_shipmode"):
            words = (pe.SHIPINSTRUCT if name == "l_shipinstruct"
                     else pe.SHIPMODE)
            order = np.argsort(np.asarray(words, dtype=object), kind="stable")
            ranks = np.zeros(128, np.int32)
            ranks[:len(words)][order] = np.arange(len(words))
            cols[name] = jcol.DictionaryColumn(
                at.primitive(a, js.int32), jcol.string_view(words),
                np.asarray(ranks), js.Dictionary(js.int32, js.utf8))
        elif name == "l_comment":
            pool, starts, lengths = a
            cols[name] = jcol.string_view(
                [pool[s:s + n].tobytes().decode()
                 for s, n in zip(starts, lengths)])
        else:
            cols[name] = at.primitive(a, js.from_jnp(a.dtype))
    return jbt.record_batch(cols)


def test_q6_step_matches_oracle_and_jax():
    arrays = pe.example_lineitem_arrays(sf=0.0007, seed=6)
    n = len(arrays["l_orderkey"])
    assert 3000 < n < 5000
    batch = pe.lineitem_batch(arrays, device="cpu")
    out = pe.q6_step(batch)
    want = pe.q6_oracle(arrays)
    kept = pe.check_q6(out, arrays, want)
    assert 0.01 < kept / n < 0.03  # Q6 keeps about 1.9 % of the rows
    # the JAX package's predicate and filter_record_batch on the same
    # columns
    jb = _jax_lineitem(arrays)
    ship, disc = jb["l_shipdate"], jb["l_discount"]
    jm = jops.and_kleene(jcmp.gt_eq(ship, pe._days("1994-01-01")),
                         jcmp.lt(ship, pe._days("1995-01-01")))
    jm = jops.and_kleene(jm, jcmp.gt_eq(disc, D("0.05")))
    jm = jops.and_kleene(jm, jcmp.lt_eq(disc, D("0.07")))
    jm = jops.and_kleene(jm, jcmp.lt(jb["l_quantity"], 24))
    jf = jops.filter_record_batch(jb, jm)
    tp.assert_batch_equal(jf, out[0])
    # the products by the JAX package's decimal kernel (its sum_ is held
    # to the port's above), summed exactly on the host
    product = jdec.mul(jf["l_extendedprice"], jf["l_discount"])
    assert sum(jl.join_ints(np.asarray(product.values)[:kept])) == \
        want["revenue"]
    assert out[1] == D(want["revenue"]).scaleb(-4)
    assert str(out[0].schema.field("l_quantity").dtype) == "decimal128(15,2)"
