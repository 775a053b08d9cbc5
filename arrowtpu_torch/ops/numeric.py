"""Numeric arithmetic with Arrow null semantics.

Counterpart of `arrowtpu/ops/numeric.py` over int8 / 16 / 32 / 64, uint8 /
16 / 32 / 64, float16, float32 and float64.  Operands are columns or
Python scalars; the result's type is the JAX package's
(`arity.result_dtype`: uint64 + int64 is int64, its limb rule), and the
operands are cast to it before the op.

  * the plain ops wrap (they are also the `_wrapping` aliases); uint16 and
    uint32 compute in int64 and keep the low bits; uint64 computes on its
    int64 bits (`core/u64.py`), so add, sub, mul and neg wrap mod 2**64,
    and `div` and `rem` are unsigned and exact (a zero divisor gives 0);
    float16 computes in float16;
  * integer `div` and `rem` truncate toward zero (C and Rust).  A zero
    divisor gives what the JAX package gives at that width: for `div` the
    dividend at 8, 16 and 32 bits and 0 at int64, for `rem` 0.  A divisor
    of -1 is a wrapping negation (`div`) or 0 (`rem`): INT_MIN / -1 is
    never evaluated, since it traps on the host;
  * a float `rem` is x - trunc(x / y) * y, as the JAX package computes it
    (not `fmod`); the multiply and the subtraction are separate ops, so
    they never contract into an FMA.  A float divides by a one-element
    tensor on its device, never by a host scalar (which PyTorch's CUDA
    division turns into a multiply by the reciprocal);
  * a decimal operand, on either side, goes to `ops/decimal`: `add(1, d)`
    is `dec.add(d, 1)`, `sub(1, d)` is `dec.neg(dec.sub(d, 1))`, `neg(d)`
    is `dec.neg(d)`; `div` and `rem` of a decimal raise ComputeError, as
    the JAX package has no decimal division;
  * the checked ops return (column, flag): the flag is a 0-d bool tensor
    on the column's device, true when a live, valid row overflowed;
    `raise_if` is their one read-back.  The flags are the JAX package's
    (signed add / sub by the operands' and the result's signs, unsigned
    by a wrap; mul by dividing back; div and rem by a zero divisor;
    floats never), and INT_MIN * -1 and INT_MIN / -1 are flagged too; a
    uint64 add or sub is flagged by an unsigned wrap, a mul by dividing
    back unsigned.
"""

from __future__ import annotations

import torch

from .. import schema as st
from ..core import column as col
from ..core import u64
from . import arity


def _is_decimal(x) -> bool:
    return (isinstance(x, col.PrimitiveColumn)
            and st.decimal_limbs(x.dtype) is not None)


_NUMERIC = (st.Int, st.Float)


def _check(*xs) -> None:
    """Columns must be integer or float primitives."""
    for x in xs:
        if isinstance(x, col.Column) and not (
                isinstance(x, col.PrimitiveColumn)
                and type(x.dtype) in _NUMERIC):
            raise st.ComputeError(
                f"numeric op on an unsupported column {x.dtype}")


def _binary(a, b, fn) -> col.PrimitiveColumn:
    """fn(x, y, result dtype) over the operands cast to the result's
    compute dtype."""
    _check(a, b)
    dt = arity.result_dtype(a, b)
    return arity.binary(a, b, lambda x, y: fn(x, y, dt))


def _trunc_div(x, y):
    if x.is_floating_point():
        return x / y
    return torch.div(x, y, rounding_mode="trunc")


def _minus_one(y, dt):
    """(n,) bool: y is -1 (never, for an unsigned type)."""
    if arity._int_info(dt)[1]:
        return y == -1
    return torch.zeros_like(y, dtype=torch.bool)


def _int_div(x, y, dt):
    """Truncating integer division with the JAX package's zero-divisor
    results; a -1 divisor negates (wrapping)."""
    neg = _minus_one(y, dt)
    q = _trunc_div(x, torch.where((y == 0) | neg, 1, y))
    q = torch.where(neg, -x, q)
    zero_gives = 0 if dt == torch.int64 else x
    return torch.where(y == 0, zero_gives, q)


def _div(x, y, dt):
    if dt.is_floating_point:
        return x / y
    if dt == torch.uint64:
        return u64.divmod_(x, y)[0]
    return _int_div(x, y, dt)


def _rem(x, y, dt):
    if dt.is_floating_point:
        return x - torch.trunc(x / y) * y
    if dt == torch.uint64:
        return u64.divmod_(x, y)[1]
    bad = (y == 0) | _minus_one(y, dt)
    return torch.where(bad, 0, torch.fmod(x, torch.where(bad, 1, y)))


def _decimal_or_none(a, b, op):
    """The decimal result of `op` when an operand is a decimal, else None."""
    if not (_is_decimal(a) or _is_decimal(b)):
        return None
    from . import decimal as dec

    if op == "add":
        return dec.add(a, b) if _is_decimal(a) else dec.add(b, a)
    if op == "mul":
        return dec.mul(a, b) if _is_decimal(a) else dec.mul(b, a)
    if op == "sub":
        return dec.sub(a, b) if _is_decimal(a) else dec.neg(dec.sub(b, a))
    raise st.ComputeError(f"{op} of a decimal is not supported")


def add(a, b):
    out = _decimal_or_none(a, b, "add")
    return out if out is not None else _binary(
        a, b, lambda x, y, dt: x + y)


def sub(a, b):
    out = _decimal_or_none(a, b, "sub")
    return out if out is not None else _binary(
        a, b, lambda x, y, dt: x - y)


def mul(a, b):
    out = _decimal_or_none(a, b, "mul")
    return out if out is not None else _binary(
        a, b, lambda x, y, dt: x * y)


def _host_divisor(a, b):
    """b wrapped into the result type when a is an integer column and b a
    Python int other than 0 and -1, which needs no per-row handling (the
    flagship's `c % 7`); else None."""
    if (not isinstance(a, col.PrimitiveColumn) or isinstance(b, bool)
            or not isinstance(b, int)):
        return None
    _check(a)
    dt = arity.result_dtype(a, b)
    if dt.is_floating_point or dt == torch.uint64:
        return None
    w = arity._wrap_int(b, dt)
    return None if w in (0, -1) else w


def div(a, b):
    """a / b: floats by IEEE division, integers truncating (see the
    module docstring for zero and -1 divisors)."""
    _decimal_or_none(a, b, "div")
    w = _host_divisor(a, b)
    if w is not None:
        return arity.unary(a, lambda x: _trunc_div(x, w))
    return _binary(a, b, _div)


def rem(a, b):
    """a % b: integers with C truncation (the sign follows the dividend;
    a zero or -1 divisor gives 0), floats as x - trunc(x / y) * y."""
    _decimal_or_none(a, b, "rem")
    w = _host_divisor(a, b)
    if w is not None:
        return arity.unary(a, lambda x: torch.fmod(x, w))
    return _binary(a, b, _rem)


def neg(a):
    if _is_decimal(a):
        from . import decimal as dec

        return dec.neg(a)
    if not isinstance(a, col.DictionaryColumn):
        _check(a)
    return arity.unary(a, torch.neg)


# wrapping aliases (the reference's add_wrapping etc.)
add_wrapping = add
sub_wrapping = sub
mul_wrapping = mul


def _checked(a, b, op, bad_rows):
    """(op(a, b), 0-d bool: bad_rows(x, y, result, dtype) holds at some
    live, valid row), x and y the operands as the op saw them."""
    if _is_decimal(a) or _is_decimal(b):
        raise st.ComputeError(
            f"{op.__name__}_checked of a decimal is not supported")
    out = op(a, b)
    dt = arity._dtype_of(out)
    if dt.is_floating_point:
        return out, torch.zeros((), dtype=torch.bool, device=out.device)
    x, y, r = (arity.operand(v, dt, out.device) for v in (a, b, out))
    bad = torch.broadcast_to(bad_rows(x, y, r, dt), (out.capacity,))
    return out, (bad & out.valid_bool()).any()


def _lt(x, y, dt):
    return u64.lt(x, y) if dt == torch.uint64 else x < y


def _add_bad(x, y, r, dt):
    if arity._int_info(dt)[1]:
        return ((x >= 0) == (y >= 0)) & ((r >= 0) != (x >= 0))
    return _lt(r, x, dt)


def _sub_bad(x, y, r, dt):
    if arity._int_info(dt)[1]:
        return ((x >= 0) != (y >= 0)) & ((r >= 0) != (x >= 0))
    return _lt(x, y, dt)


def _mul_bad(x, y, r, dt):
    """Divide the wrapped product back; the JAX package's check, plus
    INT_MIN * -1 (whose quotient wraps back to INT_MIN)."""
    minus_one = _minus_one(y, dt)
    skip = (y == 0) | minus_one
    safe = torch.where(skip, 1, y)
    back = (u64.divmod_(r, safe)[0] if dt == torch.uint64
            else _trunc_div(r, safe))
    bad = ~skip & (back != x)
    return bad | (minus_one & (x == torch.iinfo(dt).min))


def _div_bad(x, y, r, dt):
    return (y == 0) | (_minus_one(y, dt) & (x == torch.iinfo(dt).min))


def _rem_bad(x, y, r, dt):
    return y == 0


def add_checked(a, b):
    return _checked(a, b, add, _add_bad)


def sub_checked(a, b):
    return _checked(a, b, sub, _sub_bad)


def mul_checked(a, b):
    return _checked(a, b, mul, _mul_bad)


def div_checked(a, b):
    return _checked(a, b, div, _div_bad)


def rem_checked(a, b):
    return _checked(a, b, rem, _rem_bad)


def raise_if(flag, message: str = "arithmetic overflow"):
    """The host read-back of a checked op's flag: ComputeError when set."""
    if bool(flag):
        raise st.ComputeError(message)
