"""arrowtpu_torch's elementwise layer (ops/arity, numeric, boolean,
bitwise, zip) against arrowtpu.ops on the same numpy inputs.

Tolerance: exact.  Values (those under nulls included), validity as
bools, length and zero padding through `torch_parity.assert_column_equal`;
float results also bit for bit (-0.0 apart from +0.0), where neither side
is a NaN.  Every column has N rows, so the JAX side compiles one shape a
dtype.

Where the JAX package is at fault, the port is held to a Python oracle,
and the test names the fault (ROADMAP C.3):
  1. `sub(1, d)` of a decimal column is uint32 limbs with no decimal type;
  2. `neg(d)` raises, and `div(d, 2)` has no decimal division;
  3. `zip_` raises on decimal values;
  4. `mul_checked` / `div_checked` miss INT_MIN * -1 and INT_MIN / -1;
  5. int64 shifts take the amount mod 64 (the port follows; a negative
     scalar amount raises in the JAX package) and drop the amount's nulls;
  6. a narrow `div` or `rem` by a Python scalar raises, and a narrow
     shift by one gives an int64 column: those cases go through a column
     of the scalar;
  7. (a result-type trap) int32 + 1.5 is float64, and uint32 + int32
     int64: the JAX package's type is right, but its column holds native
     64-bit values under a limb-pair type, which read back wrong;
  8. an int64 column beside a float scalar keeps int64, the scalar cut
     to an integer (int64 + 1.5 is int64 + 1), and an integer column
     beside a float64 column is read as float bits.
"""

import decimal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from torch_parity import release_jax_caches  # noqa: F401
from arrowtpu import ops as jops
from arrowtpu import schema as jst
from arrowtpu.core import column as jcol
from arrowtpu.ops import arity as jarity
from arrowtpu.ops import numeric as jnum

from arrowtpu_torch import ops as pops
from arrowtpu_torch import schema as pst
from arrowtpu_torch.core import column as pcol
from arrowtpu_torch.ops import arity as parity
from arrowtpu_torch.ops import numeric as pnum

N = 120  # the JAX package pads to 128 rows, the port to 128
DTYPES = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
          "float32", "float64"]
INTS = DTYPES[:7]
OPS = ["add", "sub", "mul", "div", "rem"]


def _corners(name):
    dt = np.dtype(name)
    if dt.kind == "f":
        big = 1e30 if dt == np.float32 else 1e300  # no subnormal quotient
        return np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5, -2.5, big,
                         -big, 3e-3, 7.0, -7.0], dt)
    info = np.iinfo(dt)
    if dt.kind == "u":
        return np.array([0, 1, info.max, info.max - 1, 2, 7], dt)
    return np.array([info.min, info.min + 1, -1, 0, 1, info.max, -2, 2, 7,
                     -7], dt)


def _values(name, seed):
    """N values of dtype `name`: its corners in every pairing with the
    other operand's (the first len(corners) ** 2 rows), then random."""
    rng = np.random.default_rng(seed)
    dt = np.dtype(name)
    c = _corners(name)
    if dt.kind == "f":
        rest = (rng.standard_normal(N) * 1000).astype(dt)
    else:
        info = np.iinfo(dt)
        rest = rng.integers(info.min, info.max, N, endpoint=True,
                            dtype=np.int64 if dt != np.uint32 else np.uint64
                            ).astype(dt)
    k = len(c)
    grid = np.repeat(c, k) if seed % 2 else np.tile(c, k)
    rest[:min(N, k * k)] = grid[:N]
    return rest


def _valid(nulls, seed):
    if not nulls:
        return None
    return np.random.default_rng(seed + 100).random(N) > nulls


def _pair(vals, valid, name):
    return tp.jax_column(vals, valid, name), tp.port_column(vals, valid,
                                                           name)


def _same(jc, pc, where):
    tp.assert_column_equal(jc, pc, where)
    jv, _, _ = tp.jax_to_numpy(jc)
    pv, _, _ = pt_numpy(pc)
    if pv.dtype.kind == "f":
        both = np.isnan(jv) & np.isnan(pv)
        np.testing.assert_array_equal(
            np.where(both, 0, pv).view(f"u{pv.itemsize}"),
            np.where(both, 0, jv).astype(pv.dtype).view(f"u{pv.itemsize}"),
            err_msg=f"{where}: float bits")


def pt_numpy(c):
    import arrowtpu_torch as pt

    return pt.column_to_numpy(c)


def _column_of(scalar, name, valid=None):
    return _pair(np.full(N, scalar, np.dtype(name)), valid, name)


# ---------------------------------------------------------------------------
# result types
# ---------------------------------------------------------------------------


def test_result_dtype_matches_jnp_result_type():
    """Every pair of column dtypes, and each dtype with a Python int, a
    Python float and a Python bool on either side."""
    for a in DTYPES:
        pa = tp.port_column(np.zeros(4, a), None, a)
        for b in DTYPES:
            pb = tp.port_column(np.zeros(4, b), None, b)
            want = str(jnp.result_type(np.dtype(a), np.dtype(b)))
            assert str(parity.result_dtype(pa, pb)).split(".")[1] == want, \
                (a, b)
        for s in (3, 1.5, True):
            want = str(jnp.result_type(np.dtype(a), s))
            for got in (parity.result_dtype(pa, s),
                        parity.result_dtype(s, pa)):
                assert str(got).split(".")[1] == want, (a, s)


# ---------------------------------------------------------------------------
# numeric
# ---------------------------------------------------------------------------


def _scalars(name):
    """(right scalar, left scalar) of a dtype's cases."""
    if np.dtype(name).kind == "f":
        return 2.5, 1.5
    return 7, 100


@pytest.mark.parametrize("name", DTYPES)
def test_numeric_ops_match_jax(name):
    """add, sub, mul, div, rem (and the wrapping aliases) column with
    column, with a scalar on the right and on the left, and neg, at 0 %
    and 10 % nulls (the no-null case against the JAX result's values, all
    valid); the corners pair with each other.  The JAX side of a
    scalar case is the op with a column of the scalar: its own scalar path
    raises for a narrow div or rem (fault 6) and for an int64 dividend
    scalar (its limb loop's carry takes the scalar's shape), and at int64
    and float64 it compiles every limb op again for the scalar's shape."""
    right, left = _scalars(name)
    jr, jl = _column_of(right, name)[0], _column_of(left, name)[0]
    ja, pa = _pair(_values(name, 1), _valid(0.1, 1), name)
    jb, pb = _pair(_values(name, 2), _valid(0.05, 2), name)
    # the same values without nulls: the JAX result's values, all valid
    pa0, pb0 = (tp.port_column(v, None, name) for v in (_values(name, 1),
                                                         _values(name, 2)))
    for op in OPS:
        jf, pf = getattr(jnum, op), getattr(pnum, op)
        for form, jx, px, px0, jy, py, py0 in (
                ("col-col", ja, pa, pa0, jb, pb, pb0),
                ("col-scalar", ja, pa, pa0, jr, right, right),
                ("scalar-col", jl, left, left, jb, pb, pb0)):
            want = jf(jx, jy)
            _same(want, pf(px, py), f"{name} {op} {form}")
            _same(want.with_validity(None), pf(px0, py0),
                  f"{name} {op} {form}, no nulls")
    _same(jnum.neg(ja), pnum.neg(pa), f"{name} neg")
    _same(jnum.neg(ja).with_validity(None), pnum.neg(pa0), f"{name} neg")
    for alias in ("add", "sub", "mul"):
        assert getattr(pnum, f"{alias}_wrapping") is getattr(pnum, alias)


@pytest.mark.parametrize("name", ["int8", "int64", "uint32"])
@pytest.mark.parametrize("divisor", [0, -1])
def test_zero_and_minus_one_divisors_match_jax(name, divisor):
    """A zero divisor gives the dividend at narrow widths and 0 at int64
    (`div`), 0 (`rem`); -1 negates, wrapping (INT_MIN / -1 = INT_MIN)."""
    x = _values(name, 3)
    dv = np.full(N, divisor, np.int64).astype(np.dtype(name))
    ja, pa = _pair(x, _valid(0.1, 3), name)
    jb, pb = _pair(dv, None, name)
    for op in ("div", "rem"):
        want = getattr(jnum, op)(ja, jb)
        _same(want, getattr(pnum, op)(pa, pb), f"{name} {op} by {divisor}")
        _same(want, getattr(pnum, op)(pa, divisor),
              f"{name} {op} by the scalar {divisor}")


@pytest.mark.parametrize("name", ["float32", "float64"])
def test_subnormal_results_follow_ieee(name):
    """Results below the smallest normal number are IEEE's subnormals, as
    numpy computes them.  The JAX package on XLA's CPU backend flushes
    them to zero, so these are held to numpy, not to it."""
    dt = np.dtype(name)
    tiny = np.finfo(dt).tiny
    x = np.array([tiny, -tiny, tiny * 3, tiny], dt)
    y = np.array([7.0, 3.0, -5.0, 1.5], dt)
    pa, pb = (tp.port_column(v, None, name) for v in (x, y))
    with np.errstate(all="ignore"):
        for op, want in (("div", x / y), ("sub", x - x * dt.type(0.75)),
                         ("mul", x * dt.type(0.25)),
                         ("rem", x - np.trunc(x / y) * y)):
            other = pb if op in ("div", "rem") else (
                pa if op == "sub" else 0.25)
            if op == "sub":
                got = pnum.sub(pa, pnum.mul(pa, 0.75))
            else:
                got = getattr(pnum, op)(pa, other)
            np.testing.assert_array_equal(
                got.values[:4].numpy().view(f"u{dt.itemsize}"),
                want.astype(dt).view(f"u{dt.itemsize}"), err_msg=op)
    assert (pnum.div(pa, pb).values[:4].numpy() != 0).all()


def _flag(f):
    return bool(np.asarray(f)) if not isinstance(f, torch.Tensor) else \
        bool(f)


def _checked_cases(name):
    """Safe (x, y) values of a dtype, and each op's (x, y) of a row that
    overflows it (or divides by zero)."""
    dt = np.dtype(name)
    if dt.kind == "f":
        hi, lo = np.finfo(dt).max, -np.finfo(dt).max
    else:
        hi, lo = np.iinfo(dt).max, np.iinfo(dt).min
    x = np.full(N, 3, dt)
    y = np.full(N, 2, dt)
    bad = {"add": (hi, 1), "sub": (lo, 1), "mul": (hi, 2), "div": (5, 0),
           "rem": (5, 0)}
    return x, y, bad


@pytest.mark.parametrize("name", DTYPES)
def test_checked_ops_match_jax(name):
    """Each checked op's column and flag: one overflowing (or
    zero-divisor) row, valid; the same row null, the rest safe."""
    x, y, bad = _checked_cases(name)
    for op in OPS:
        jf, pf = getattr(jnum, f"{op}_checked"), getattr(pnum, f"{op}_checked")
        # "bad under a null": every valid row safe, so the flag is clear;
        # a float flag is never set, so its null case adds nothing
        cases = ("bad",) + (
            ("bad under a null",) if np.dtype(name).kind != "f" else ())
        for case in cases:
            xs, ys = x.copy(), y.copy()
            valid = None
            xs[5], ys[5] = bad[op]
            if case == "bad under a null":
                valid = np.ones(N, bool)
                valid[5] = False
            ja, pa = _pair(xs, valid, name)
            jb, pb = _pair(ys, None, name)
            jout, jflag = jf(ja, jb)
            pout, pflag = pf(pa, pb)
            _same(jout, pout, f"{name} {op}_checked {case}")
            assert pflag.dtype == torch.bool and pflag.dim() == 0
            assert _flag(pflag) == _flag(jflag), (name, op, case)
            if case == "bad" and np.dtype(name).kind != "f":
                assert _flag(pflag), (name, op)
                with pytest.raises(pst.ComputeError):
                    pnum.raise_if(pflag)
    pnum.raise_if(pnum.add_checked(tp.port_column(x, None, name), 1)[1])


@pytest.mark.parametrize("name", ["int32", "int64"])
def test_fault4_int_min_times_and_over_minus_one_are_flagged(name):
    """Fault 4: the JAX package's mul_checked and div_checked do not flag
    INT_MIN * -1 or INT_MIN / -1; both overflow (arrow-arith's checked
    kernels error), so the port flags them."""
    mn = np.iinfo(np.dtype(name)).min
    a = tp.port_column(np.array([mn, 3], name), None, name)
    b = tp.port_column(np.array([-1, 2], name), None, name)
    out, flag = pnum.mul_checked(a, b)
    assert bool(flag) and out.to_pylist() == [mn, 6]
    out, flag = pnum.div_checked(a, b)
    assert bool(flag) and out.to_pylist() == [mn, 1]
    assert not bool(pnum.rem_checked(a, b)[1])
    _, jflag = jnum.mul_checked(tp.jax_column(np.array([mn, 3], name), None,
                                              name),
                                tp.jax_column(np.array([-1, 2], name), None,
                                              name))
    assert not bool(jflag)  # the reference's fault, reproduced


def test_fault7_and_fault8_int_columns_with_float_scalars():
    """Fault 7: int32 + 1.5 is float64 in the JAX package (torch gives
    float32), but its column holds native float64 values under a
    limb-pair type; fault 8: the JAX package keeps an
    int64 column + 1.5 as int64 (the scalar cut to 1), and reads an
    integer column beside a float64 column as float bits.  The port gives
    the float type, the values of numpy's arithmetic in it."""
    for name in ("int32", "int64", "uint32", "int8"):
        x = _values(name, 4)
        pa = tp.port_column(x, None, name)
        for op, f in (("add", np.add), ("sub", np.subtract),
                      ("mul", np.multiply), ("div", np.divide)):
            with np.errstate(all="ignore"):
                want = f(x.astype(np.float64), 1.5)
            got = getattr(pnum, op)(pa, 1.5)
            assert got.dtype == pst.float64, (name, op)
            np.testing.assert_array_equal(got.values[:N].numpy(), want)
    ja = tp.jax_column(np.array([1, 2], np.int32), None, "int32")
    assert str(jnum.add(ja, 1.5).dtype) == "float64"
    # an integer column beside a float column: the float's type (int64
    # with float32 is float32, as jnp.result_type says), both operands
    # cast to it
    for iname, fname in (("int32", "float64"), ("int64", "float64"),
                         ("int64", "float32"), ("uint16", "float32")):
        x, y = _values(iname, 5), _values(fname, 6)
        pa, pb = (tp.port_column(v, None, n) for v, n in ((x, iname),
                                                         (y, fname)))
        for op, f in (("add", np.add), ("mul", np.multiply),
                      ("div", np.divide)):
            got = getattr(pnum, op)(pa, pb)
            assert str(got.dtype) == fname
            with np.errstate(all="ignore"):
                want = f(x.astype(fname), y)
            np.testing.assert_array_equal(got.values[:N].numpy(), want)


def test_uint_and_int_mixed_and_weak_scalars_match_jax():
    """uint32 with int32 is int64 (fault 7: the JAX package's column holds
    native int64 values under its limb-pair type, so the port is held to
    numpy's int64 arithmetic); int8 + 300 wraps the scalar into int8;
    uint8 with int8 meets at int16."""
    x, y = _values("uint32", 5), _values("int32", 6)
    pa = tp.port_column(x, None, "uint32")
    pb = tp.port_column(y, _valid(0.1, 6), "int32")
    for op, f in (("add", np.add), ("sub", np.subtract),
                  ("mul", np.multiply)):
        got = getattr(pnum, op)(pa, pb)
        assert got.dtype == pst.int64
        with np.errstate(all="ignore"):
            want = f(x.astype(np.int64), y.astype(np.int64))
        np.testing.assert_array_equal(got.values[:N].numpy(), want)
    j8, p8 = _pair(_values("int8", 7), None, "int8")
    _same(jnum.add(j8, 300), pnum.add(p8, 300), "int8 + 300")
    ju, pu = _pair(_values("uint8", 8), None, "uint8")
    _same(jnum.mul(ju, j8), pnum.mul(pu, p8), "uint8 * int8")


def _decimals(seed, valid=True):
    rng = np.random.default_rng(seed)
    cents = rng.integers(-10**6, 10**6, N)
    vals = [decimal.Decimal(int(c)).scaleb(-2) for c in cents]
    ok = rng.random(N) > 0.1 if valid else np.ones(N, bool)
    data = [v if o else None for v, o in zip(vals, ok)]
    return (jcol.primitive_from_pylist(data, jst.Decimal128(15, 2))
            if hasattr(jcol, "primitive_from_pylist") else
            jcol.from_pylist(data, jst.Decimal128(15, 2)),
            pcol.from_pylist(data, pst.Decimal128(15, 2), device="cpu"),
            data)


def test_decimal_operands_route_to_decimal_ops():
    """A decimal on either side goes to ops/decimal, as in the JAX package
    where it does (add and mul on both sides, sub with the decimal on the
    left)."""
    ja, pa, _ = _decimals(1)
    jb, pb, _ = _decimals(2)
    for op in ("add", "sub", "mul"):
        _same(getattr(jnum, op)(ja, jb), getattr(pnum, op)(pa, pb),
              f"decimal {op}")
        _same(getattr(jnum, op)(ja, 3), getattr(pnum, op)(pa, 3),
              f"decimal {op} scalar")
    _same(jnum.add(3, ja), pnum.add(3, pa), "scalar add decimal")
    _same(jnum.mul(3, ja), pnum.mul(3, pa), "scalar mul decimal")


def test_fault1_and_fault2_decimal_sub_neg_div():
    """Fault 1: `sub(1, d)` in the JAX package gives uint32 limb rows with
    no decimal type; fault 2: `neg(d)` raises there and `div(d, 2)` has no
    decimal division.  The port: 1 - d and -d exactly (Decimal
    arithmetic), div and rem raise ComputeError."""
    _, pa, data = _decimals(3)
    got = pnum.sub(1, pa)
    assert got.dtype == pst.Decimal128(16, 2)
    assert got.to_pylist() == [None if v is None else 1 - v for v in data]
    got = pnum.neg(pa)
    assert got.dtype == pst.Decimal128(15, 2)
    assert got.to_pylist() == [None if v is None else -v for v in data]
    for op in ("div", "rem"):
        with pytest.raises(pst.ComputeError):
            getattr(pnum, op)(pa, 2)
    jd = _decimals(3)[0]
    assert str(jnum.sub(1, jd).dtype) != "decimal128(16,2)"  # the fault


# ---------------------------------------------------------------------------
# arity
# ---------------------------------------------------------------------------


def test_unary_and_binary_out_dtype_match_jax():
    """unary with an out dtype, on a column and on a dictionary (its values
    mapped, their ranks dropped); binary with an explicit out dtype (the
    op in the operands' type, then the cast)."""
    ja, pa = _pair(_values("int32", 9), _valid(0.1, 9), "int32")
    _same(jarity.unary(ja, jnp.negative, jst.float32),
          parity.unary(pa, torch.neg, pst.float32), "unary out float32")
    jb, pb = _pair(_values("int32", 10), None, "int32")
    _same(jarity.binary(ja, jb, jnp.add, jst.int16),
          parity.binary(pa, pb, torch.add, pst.int16), "binary out int16")
    data = [3, None, -4, 3, 7] * (N // 5)
    jd = jcol.dictionary_encode_host(data, jst.Dictionary(jst.int32,
                                                          jst.int32))
    pd = pcol.dictionary_encode_host(data, pst.Dictionary(pst.int32,
                                                          pst.int32),
                                     device="cpu")
    jr = jarity.unary(jd, jnp.negative)
    pr = parity.unary(pd, torch.neg)
    assert pr.value_ranks is None and jr.value_ranks is None
    tp.assert_column_equal(jr, pr, "unary dictionary")


# ---------------------------------------------------------------------------
# boolean
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("a_nulls,b_nulls", [(0.0, 0.0), (0.2, 0.0),
                                             (0.0, 0.2), (0.2, 0.3)])
def test_boolean_ops_match_jax(a_nulls, b_nulls):
    rng = np.random.default_rng(11)
    a, b = rng.random(N) < 0.5, rng.random(N) < 0.5
    ja, pa = _pair(a, _valid(a_nulls, 1), "bool")
    jb, pb = _pair(b, _valid(b_nulls, 2), "bool")
    for op in ("and_", "or_", "xor", "and_not", "and_kleene", "or_kleene"):
        tp.assert_column_equal(getattr(jops, op)(ja, jb),
                               getattr(pops, op)(pa, pb), op)
    tp.assert_column_equal(jops.not_(ja), pops.not_(pa), "not_")
    for op in ("is_null", "is_not_null"):
        got = getattr(pops, op)(pa)
        assert got.validity is None
        tp.assert_column_equal(getattr(jops, op)(ja), got, op)
    ji, pi = _pair(_values("int64", 12), _valid(a_nulls, 12), "int64")
    tp.assert_column_equal(jops.is_null(ji), pops.is_null(pi), "is_null")
    tp.assert_column_equal(jops.is_not_null(ji), pops.is_not_null(pi),
                           "is_not_null")


# ---------------------------------------------------------------------------
# bitwise
# ---------------------------------------------------------------------------


def _amounts(name):
    """Shift amounts of a dtype: in range, at and past the width, and
    negative where the type has them."""
    dt = np.dtype(name)
    bits = dt.itemsize * 8
    rng = np.random.default_rng(bits)
    lo = -3 if dt.kind == "i" else 0
    hi = min(bits + 80, np.iinfo(dt).max)
    return rng.integers(lo, hi, N).astype(dt)


@pytest.mark.parametrize("name", INTS)
def test_bitwise_ops_match_jax(name):
    """and / or / xor column with column and with scalars on both sides,
    not, and both shifts by a column of amounts (oversized and negative
    included: 8-32 bits give 0 or the sign fill, int64 takes the amount
    mod 64) and by scalar amounts.  The JAX side of a scalar case is a
    column of the scalar (fault 6: a narrow shift by a scalar gives an
    int64 column there), and int64's amounts carry no nulls (fault 5)."""
    wide = name == "int64"
    for nulls in (0.0, 0.1):
        ja, pa = _pair(_values(name, 1), _valid(nulls, 1), name)
        jb, pb = _pair(_values(name, 2), _valid(nulls, 2), name)
        j7 = _column_of(7, name)[0]
        for op in ("bit_and", "bit_or", "bit_xor"):
            jf, pf = getattr(jops, op), getattr(pops, op)
            _same(jf(ja, jb), pf(pa, pb), f"{name} {op}")
            _same(jf(ja, j7), pf(pa, 7), f"{name} {op} scalar")
            _same(jf(j7, ja), pf(7, pa), f"{name} {op} scalar left")
        _same(jops.bit_not(ja), pops.bit_not(pa), f"{name} bit_not")
        jk, pk = _pair(_amounts(name), None if wide else _valid(nulls, 3),
                       name)
        for op in ("shift_left", "shift_right"):
            jf, pf = getattr(jops, op), getattr(pops, op)
            _same(jf(ja, jk), pf(pa, pk), f"{name} {op}")
            for k in (0, 3, np.dtype(name).itemsize * 8, 70):
                if k > np.iinfo(np.dtype(name)).max:
                    continue
                _same(jf(ja, _column_of(k, name)[0]), pf(pa, k),
                      f"{name} {op} by {k}")
            _same(jf(j7, jk), pf(7, pk), f"{name} 7 {op} by a column")


def test_fault5_int64_shifts_take_the_amount_mod_64():
    """Fault 5: at int64 the JAX package takes the shift amount mod 64
    (and raises on a negative scalar amount), where narrow widths give 0;
    the port follows each width, a negative scalar included.  Its int64
    shift also drops the amount column's nulls (the narrow widths keep
    them): in the port a null amount gives a null at every width."""
    a = tp.port_column(np.array([5, -5], np.int64), None, "int64")
    assert pops.shift_left(a, 70).to_pylist() == [320, -320]
    assert pops.shift_left(a, -1).to_pylist() == [-2**63, -2**63]
    assert pops.shift_right(a, 65).to_pylist() == [2, -3]
    n = tp.port_column(np.array([5, -5], np.int32), None, "int32")
    assert pops.shift_left(n, 70).to_pylist() == [0, 0]
    assert pops.shift_right(n, -1).to_pylist() == [0, -1]
    k = tp.port_column(np.array([1, 2], np.int64), np.array([True, False]),
                       "int64")
    assert pops.shift_left(a, k).to_pylist() == [10, None]


def test_bitwise_and_numeric_raise_on_unsupported():
    f = tp.port_column(np.ones(4, np.float64), None, "float64")
    for op in ("bit_and", "shift_left"):
        with pytest.raises(pst.ComputeError):
            getattr(pops, op)(f, 1)
    with pytest.raises(pst.ComputeError):
        pops.bit_not(f)
    s = pcol.string_view(["a", "b"], device="cpu")
    with pytest.raises(pst.ComputeError):
        pops.add(s, 1)


# ---------------------------------------------------------------------------
# zip, nullif, shift
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["int32", "int64", "float64", "uint16"])
def test_zip_nullif_shift_match_jax(name):
    rng = np.random.default_rng(13)
    for mask_nulls in (0.0, 0.2):
        jm, pm = _pair(rng.random(N) < 0.5, _valid(mask_nulls, 4), "bool")
        ja, pa = _pair(_values(name, 1), _valid(0.1, 1), name)
        jb, pb = _pair(_values(name, 2), None, name)
        _same(jops.zip_(jm, ja, jb), pops.zip_(pm, pa, pb), f"{name} zip")
        _same(jops.zip_(jm, ja, 0), pops.zip_(pm, pa, 0), f"{name} zip 0")
        _same(jops.zip_(jm, 7, jb), pops.zip_(pm, 7, pb), f"{name} zip 7")
        _same(jops.nullif(ja, jm), pops.nullif(pa, pm), f"{name} nullif")
    for offset in (3, -5, 0):
        _same(jops.shift(ja, offset), pops.shift(pa, offset),
              f"{name} shift {offset}")


def test_fault3_zip_over_decimals():
    """Fault 3: the JAX package's zip_ raises on decimal values (the mask
    is not broadcast over the limbs).  The port picks whole rows: held to
    the Decimal values, with a column, an int and a Decimal scalar, a
    null mask row giving a null."""
    _, pa, da = _decimals(4)
    _, pb, db = _decimals(5)
    rng = np.random.default_rng(14)
    mask = rng.random(N) < 0.5
    mvalid = rng.random(N) > 0.1
    pm = tp.port_column(mask, mvalid, "bool")
    for falsy, fvals in ((pb, db), (0, [decimal.Decimal("0.00")] * N),
                         (decimal.Decimal("9.99"),
                          [decimal.Decimal("9.99")] * N)):
        got = pops.zip_(pm, pa, falsy)
        want = [None if not ok else (t if m else f)
                for m, ok, t, f in zip(mask, mvalid, da, fvals)]
        assert got.dtype == pst.Decimal128(15, 2)
        assert got.to_pylist() == want
        tp.assert_zero_padding(got)
    jd = _decimals(4)[0]
    jm = tp.jax_column(mask, mvalid, "bool")
    with pytest.raises(ValueError):  # the reference's fault, reproduced
        jops.zip_(jm, jd, 0)
