"""Parity of arrowtpu_torch's predicate ops (gt, eq, rem, and_kleene) with
arrowtpu.ops on the same numpy inputs.  Tolerance: exact (integer and
boolean results; values, validity as bools, length, zero padding)."""

import numpy as np
import pytest

import torch_parity as tp
from torch_parity import release_jax_caches  # noqa: F401
from arrowtpu import ops as jops
from arrowtpu_torch import ops as pops

N = 3000  # ragged: the port pads to 3008 rows, the JAX package to 3072


def _pair(rng, dtype, lo, hi, null_density, n=N):
    vals = rng.integers(lo, hi, n).astype(dtype)
    valid = rng.random(n) > null_density if null_density else None
    name = np.dtype(dtype).name
    return (tp.jax_column(vals, valid, name), tp.port_column(vals, valid, name))


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
@pytest.mark.parametrize("nulls", [0.0, 0.1])
def test_gt_eq_columns(dtype, nulls):
    rng = np.random.default_rng(1)
    ja, pa = _pair(rng, dtype, -50, 50, nulls)
    jb, pb = _pair(rng, dtype, -50, 50, nulls / 2)
    tp.assert_column_equal(jops.gt(ja, jb), pops.gt(pa, pb), "gt")
    tp.assert_column_equal(jops.eq(ja, jb), pops.eq(pa, pb), "eq")


def test_cmp_scalar():
    rng = np.random.default_rng(2)
    ja, pa = _pair(rng, np.int64, -10, 10, 0.1)
    tp.assert_column_equal(jops.gt(ja, 0), pops.gt(pa, 0), "gt scalar")
    tp.assert_column_equal(jops.eq(ja, 3), pops.eq(pa, 3), "eq scalar")


@pytest.mark.parametrize("divisor", [7, -7, 1, 0])
def test_rem_scalar_truncates(divisor):
    """C truncation: the remainder takes the dividend's sign; a zero
    divisor gives 0."""
    rng = np.random.default_rng(3)
    ja, pa = _pair(rng, np.int64, -10**6, 10**6, 0.05)
    tp.assert_column_equal(jops.rem(ja, divisor), pops.rem(pa, divisor),
                           "rem")


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_rem_columns_with_zero_and_minus_one(dtype):
    rng = np.random.default_rng(4)
    x = rng.integers(-1000, 1000, N).astype(dtype)
    y = rng.integers(-5, 6, N).astype(dtype)  # includes 0 and -1
    x[:3] = np.iinfo(dtype).min
    y[:3] = [-1, 0, 7]
    valid = rng.random(N) > 0.1
    name = np.dtype(dtype).name
    jr = jops.rem(tp.jax_column(x, valid, name), tp.jax_column(y, None, name))
    pr = pops.rem(tp.port_column(x, valid, name), tp.port_column(y, None, name))
    tp.assert_column_equal(jr, pr, "rem columns")


@pytest.mark.parametrize("a_nulls,b_nulls", [(0.0, 0.0), (0.2, 0.0),
                                             (0.0, 0.2), (0.2, 0.3)])
def test_and_kleene(a_nulls, b_nulls):
    rng = np.random.default_rng(5)
    a = rng.random(N) < 0.5
    b = rng.random(N) < 0.5
    av = rng.random(N) > a_nulls if a_nulls else None
    bv = rng.random(N) > b_nulls if b_nulls else None
    jr = jops.and_kleene(tp.jax_column(a, av, "bool"),
                         tp.jax_column(b, bv, "bool"))
    pr = pops.and_kleene(tp.port_column(a, av, "bool"),
                         tp.port_column(b, bv, "bool"))
    tp.assert_column_equal(jr, pr, "and_kleene")
    assert (pr.validity is None) == (av is None and bv is None)


def test_flagship_predicate():
    """(a > b) AND (c % 7 == 0) with BASELINE's null densities."""
    rng = np.random.default_rng(6)
    ja, pa = _pair(rng, np.int64, -1000, 1000, 0.1)
    jb, pb = _pair(rng, np.int64, -1000, 1000, 0.1)
    jc, pc = _pair(rng, np.int64, 0, 10**6, 0.05)
    jm = jops.and_kleene(jops.gt(ja, jb), jops.eq(jops.rem(jc, 7), 0))
    pm = pops.and_kleene(pops.gt(pa, pb), pops.eq(pops.rem(pc, 7), 0))
    tp.assert_column_equal(jm, pm, "predicate")
