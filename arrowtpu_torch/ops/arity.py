"""Elementwise ops with Arrow null semantics.

Counterpart of `arrowtpu/ops/arity.py`: the result's validity is the AND
of the operands' validities (None stays None, and a single bitmap is passed
through as the same object, which lets the filter recognise it), and the op
computes on every slot, nulls included; values under nulls are unspecified.
A Python scalar operand broadcasts as an all-valid column.  Rows past the
length are zeroed, as the padding contract requires.

`result_dtype` gives the JAX package's result type of two operands
(`jnp.result_type` with 64-bit types on), a Python scalar counting as
weakly typed: an int scalar takes the column's type, a float scalar a
float column's type and float64 beside an integer column; two integer
columns of mixed signedness meet at the narrowest signed type that holds
both (uint32 with int32 is int64); an integer column beside a float column
takes the float's type.  torch's own promotion differs (int32 + 1.5 is
float32 there), so `binary` casts its operands to that type first.

torch's uint16 and uint32 lack arithmetic: an op whose result has one of
those types computes in int64 (`compute_dtype`) and keeps the result's low
bits (`narrow_to`), which is the wrapping result.

uint64 columns hold their bits in int64 (schema.py); here their dtype is
`torch.uint64`, a name only: they compute in int64, which wraps as uint64
does.  Two integer columns of which one is 64-bit follow the JAX
package's rule for its limb pairs (`arrowtpu/ops/numeric.py` `_operands`):
the result takes the type of the last 64-bit operand, so uint64 + int64
is int64 and int64 + uint64 uint64, and uint64 with a narrower integer is
uint64 (`jnp.result_type` would give float64).  Beside a float, a uint64
operand is converted by value (`core/u64.to_float`).  float16 computes
in float16.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import schema as st
from ..core import bitmap as bm
from ..core import column as col
from ..core import u64

# the unsigned types torch stores but cannot compute on, with their masks
_WIDENED = {torch.uint16: 0xFFFF, torch.uint32: 0xFFFFFFFF}


def is_scalar(x) -> bool:
    return not isinstance(x, col.Column)


def _vals(x):
    if isinstance(x, col.BooleanColumn):
        return x.values_bool()
    if isinstance(x, col.PrimitiveColumn):
        return x.values
    raise st.ComputeError(f"unsupported operand {type(x).__name__}")


def _int_info(dt: torch.dtype):
    """-> (bits, signed) of an integer torch dtype."""
    info = torch.iinfo(dt)
    return info.bits, info.min < 0


def _signed_of(bits: int) -> torch.dtype:
    return {8: torch.int8, 16: torch.int16, 32: torch.int32,
            64: torch.int64}[bits]


def _join(x: torch.dtype, y: torch.dtype) -> torch.dtype:
    """The promotion of two column dtypes (JAX's lattice; the limb rule
    for 64-bit integers, see the module docstring)."""
    if x == y:
        return x
    if x == torch.bool:
        return y
    if y == torch.bool:
        return x
    fx, fy = x.is_floating_point, y.is_floating_point
    if fx and fy:
        return torch.float64 if torch.float64 in (x, y) else torch.float32
    if fx or fy:
        return x if fx else y
    (bx, sx), (by, sy) = _int_info(x), _int_info(y)
    if 64 in (bx, by):
        return y if by == 64 else x
    if sx == sy:
        return x if bx >= by else y
    (bs, bu) = (bx, by) if sx else (by, bx)
    if bs > bu:
        return x if sx else y
    return _signed_of(2 * bu)


def _dtype_of(x) -> torch.dtype:
    if isinstance(x, col.BooleanColumn):
        return torch.bool
    if isinstance(x, col.PrimitiveColumn) and x.values.dim() == 1:
        return torch.uint64 if st.is_u64(x.dtype) else x.values.dtype
    raise st.ComputeError(f"no elementwise dtype for {type(x).__name__} "
                          f"{getattr(x, 'dtype', '')}")


def result_dtype(a, b) -> torch.dtype:
    """The JAX package's result dtype of a binary op on `a` and `b`
    (columns or Python scalars, at least one a column)."""
    a_col, b_col = not is_scalar(a), not is_scalar(b)
    if a_col and b_col:
        return _join(_dtype_of(a), _dtype_of(b))
    if not (a_col or b_col):
        raise st.ComputeError("binary op: need at least one column operand")
    dt, s = (_dtype_of(a), b) if a_col else (_dtype_of(b), a)
    if isinstance(s, float) and not dt.is_floating_point:
        return torch.float64
    return dt


def compute_dtype(dt: torch.dtype) -> torch.dtype:
    """The dtype an op with result `dt` computes in."""
    return torch.int64 if dt in _WIDENED or dt == torch.uint64 else dt


def narrow_to(values: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Values computed in `compute_dtype(dt)` -> `dt`, wrapping (uint64
    stays in its int64 bits)."""
    if dt == torch.uint64:
        return values
    if dt in _WIDENED:
        return (values & _WIDENED[dt]).to(dt)
    return values if values.dtype == dt else values.to(dt)


def _wrap_int(v: int, dt: torch.dtype) -> int:
    bits, signed = _int_info(dt)
    v &= (1 << bits) - 1
    return v - (1 << bits) if signed and v >> (bits - 1) else v


def operand(x, dt: torch.dtype, device) -> torch.Tensor:
    """A column's values, or a Python scalar as a one-element tensor on
    `device`, in the compute dtype of a result of dtype `dt`.  An integer
    scalar wraps into `dt`'s range, as the JAX package's weak scalar
    does; a one-element tensor (not a host scalar) keeps the card's float
    division correctly rounded."""
    cdt = compute_dtype(dt)
    if not is_scalar(x):
        v = _vals(x)
        if cdt.is_floating_point and st.is_u64(x.dtype):
            return u64.to_float(v).to(cdt)
        return v if v.dtype == cdt else v.to(cdt)
    if not dt.is_floating_point and dt != torch.bool:
        x = u64.wrap(int(x)) if dt == torch.uint64 else _wrap_int(int(x), dt)
    return torch.full((1,), x, dtype=cdt, device=device)


def _operands(a, b):
    """-> (a values, b values, validity, base column) of a binary op whose
    operands are columns or Python scalars (at least one column)."""
    a_col = isinstance(a, col.Column)
    b_col = isinstance(b, col.Column)
    if not (a_col or b_col):
        raise st.ComputeError("binary op: need at least one column operand")
    if a_col and b_col and a.capacity != b.capacity:
        raise st.ComputeError(
            f"binary op: capacity mismatch {a.capacity} vs {b.capacity}")
    base = a if a_col else b
    validity = bm.union(a.validity if a_col else None,
                        b.validity if b_col else None)
    av = _vals(a) if a_col else a
    bv = _vals(b) if b_col else b
    return av, bv, validity, base


def _zero_padding(values: torch.Tensor, base: col.Column) -> torch.Tensor:
    """`values` (an op's fresh output) with the rows past the length
    zeroed in place: a write of the tail alone."""
    if base.length < base.capacity:
        values[base.length:] = 0
    return values


def _full(values: torch.Tensor, capacity: int) -> torch.Tensor:
    """An op's output broadcast to the capacity, as a fresh tensor."""
    if values.shape[0] == capacity:
        return values
    return values.expand(capacity).clone()


def _cast(values: torch.Tensor, out_dtype) -> torch.Tensor:
    if out_dtype is None or values.dtype == out_dtype.to_torch():
        return values
    return values.to(out_dtype.to_torch())


def unary(c, fn, out_dtype: st.DataType = None) -> col.Column:
    """fn over a column's values, then cast to `out_dtype` (by default
    the column's type); a dictionary maps its values (and drops their
    ranks, which `fn` may not keep)."""
    if isinstance(c, col.DictionaryColumn):
        values = unary(c.values, fn, out_dtype)
        return dataclasses.replace(
            c, values=values, value_ranks=None,
            dtype=st.Dictionary(c.dtype.key, values.dtype))
    if not isinstance(c, col.PrimitiveColumn) or c.values.dim() != 1:
        raise st.ComputeError(f"unary: unsupported column {type(c).__name__}")
    dt = c.values.dtype
    x = c.values.to(compute_dtype(dt))
    values = fn(x)
    if values is x or values is c.values:
        values = values.clone()
    values = _zero_padding(values, c)
    if values.dtype == compute_dtype(dt):
        values = narrow_to(values, dt)
    return col.PrimitiveColumn(_cast(values, out_dtype or c.dtype),
                               c.validity, c.length, out_dtype or c.dtype)


def binary(a, b, fn, out_dtype: st.DataType = None) -> col.PrimitiveColumn:
    """fn over two operands cast to their result type (`result_dtype`;
    uint16 / uint32 compute in int64 and wrap), then cast to `out_dtype`
    when given, as the JAX package casts fn's result."""
    _, _, validity, base = _operands(a, b)
    dt = result_dtype(a, b)
    av, bv = operand(a, dt, base.device), operand(b, dt, base.device)
    values = _full(fn(av, bv), base.capacity)
    if values is av or values is bv:
        values = values.clone()
    # the padding is zeroed before the narrowing: torch computes on uint16
    # and uint32 only in int64
    values = _cast(narrow_to(_zero_padding(values, base), dt), out_dtype)
    if out_dtype is None:
        out_dtype = st.from_torch(dt if values.dtype == compute_dtype(dt)
                                  else values.dtype)
    return col.PrimitiveColumn(values, validity, base.length, out_dtype)


def binary_boolean_out(a, b, fn) -> col.BooleanColumn:
    av, bv, validity, base = _operands(a, b)
    bools = _zero_padding(fn(av, bv), base)
    return col.BooleanColumn(bm.pack(bools), validity, base.length)
