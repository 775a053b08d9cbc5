"""Whole-column aggregates: sum, product, min, max, bool_and, bool_or,
count.

Counterpart of `arrowtpu/ops/aggregate.py`.  Nulls are skipped; each
aggregate returns `(value, has_value)`, both 0-d tensors left on the
column's device, and `finalize` turns the pair into a Python value or None
(Arrow's Option) with the one read-back of `bool(has)`.

Result types are the JAX package's:

  * sum and product of an integer: int64 for the signed ones and booleans,
    uint64 for the unsigned ones (a 0-d `torch.uint64` tensor, its int64
    bits reinterpreted), wrapping mod 2**64; of a float, its own type;
  * min and max keep the column's type (a Date32 column's int32 values);
    a float16 or float32 min or max propagates NaN (`jnp.min`), a float64
    one orders by Rust's `total_cmp` (NaN greatest, -0.0 below +0.0), as
    the JAX package's limb planes do; uint64 orders unsigned;
  * a decimal goes through `ops/decimal` (`sum_` wrapping at its limb
    count, `min_max`): its value is the (N,) limbs, and `finalize` needs
    the column's type to read them;
  * `count` is the number of valid live rows (int64 here, int32 there).

With no valid row the value is the reduction's identity and `has` is
false.  A float sum's order of additions is torch's, not XLA's: the
result can differ in the last bits (tests hold it within a relative
tolerance); every integer result is exact.
"""

from __future__ import annotations

import torch

from .. import schema as st
from ..core import column as col
from ..core import u64
from ..rowformat import encode as rf


def _is_decimal(c) -> bool:
    return (isinstance(c, col.PrimitiveColumn)
            and st.decimal_limbs(c.dtype) is not None)


def _masked(c: col.Column):
    """-> (the live rows' values, their validity, or None when every live
    row is valid): booleans as bools, uint16 / uint32 widened to int64
    (torch reduces neither)."""
    n = c.length
    if isinstance(c, col.BooleanColumn):
        vals = c.values_bool()[:n]
    elif isinstance(c, col.PrimitiveColumn) and c.values.dim() == 1:
        vals = c.values[:n]
        if vals.dtype in (torch.uint16, torch.uint32):
            vals = vals.to(torch.int64)
    else:
        raise st.ComputeError(
            f"aggregate: unsupported column {type(c).__name__} {c.dtype}")
    return vals, None if c.validity is None else c.valid_bool()[:n]


def _filled(vals: torch.Tensor, ok, ident) -> torch.Tensor:
    """The values with `ident` under nulls (one row of it when there are
    none: a reduction of no rows gives the identity)."""
    if not vals.shape[0]:
        return torch.full((1,), ident, dtype=vals.dtype, device=vals.device)
    return vals if ok is None else torch.where(ok, vals, ident)


def _has(vals: torch.Tensor, ok) -> torch.Tensor:
    """0-d bool on the device: some row is valid."""
    if ok is not None:
        return ok.any()
    return torch.full((), vals.shape[0] > 0, dtype=torch.bool,
                      device=vals.device)


def _unsigned(c) -> bool:
    return isinstance(c.dtype, st.Int) and not c.dtype.signed


def _int_result(v: torch.Tensor, c) -> torch.Tensor:
    """A 0-d int64 sum or product typed as the JAX package types it."""
    return v.view(torch.uint64) if _unsigned(c) else v


def sum_(c: col.Column):
    """The wrapping sum of the valid rows."""
    if _is_decimal(c):
        from . import decimal as dec

        s, cnt = dec.sum_(c)
        return s, cnt > 0
    vals, ok = _masked(c)
    if vals.is_floating_point():
        return _filled(vals, ok, 0).sum(), _has(vals, ok)
    total = _filled(vals, ok, 0).sum(dtype=torch.int64)
    return _int_result(total, c), _has(vals, ok)


def product(c: col.Column):
    """The wrapping product of the valid rows."""
    vals, ok = _masked(c)
    if vals.is_floating_point():
        return _filled(vals, ok, 1).prod(), _has(vals, ok)
    total = _filled(vals, ok, 1).prod(dtype=torch.int64)
    return _int_result(total, c), _has(vals, ok)


def _extreme(c: col.Column, is_min: bool):
    if _is_decimal(c):
        from . import decimal as dec

        return dec.min_max(c, is_min)
    vals, ok = _masked(c)
    if vals.dtype == torch.bool:
        best = (_filled(vals, ok, True).all() if is_min
                else _filled(vals, ok, False).any())
        return best, _has(vals, ok)
    if vals.dtype == torch.float64 or st.is_u64(c.dtype):
        # the JAX package's limb planes: unsigned or total order
        key = (rf.float_key(vals) if vals.is_floating_point()
               else u64.order_key(vals))
        big = torch.iinfo(torch.int64)
        key = _filled(key, ok, big.max if is_min else big.min)
        k = key.min() if is_min else key.max()
        if vals.is_floating_point():
            best = rf.float_from_key(k, torch.float64)
        else:
            best = u64.order_key(k).view(torch.uint64)
        return best, _has(vals, ok)
    if vals.is_floating_point():
        ident = float("inf") if is_min else float("-inf")
    else:
        info = torch.iinfo(c.values.dtype)
        ident = info.max if is_min else info.min
    v = _filled(vals, ok, ident)
    best = v.min() if is_min else v.max()
    return best.to(c.values.dtype), _has(vals, ok)


def min_(c: col.Column):
    return _extreme(c, True)


def max_(c: col.Column):
    return _extreme(c, False)


def bool_and(c: col.BooleanColumn):
    """AND over the valid values (true when there are none)."""
    vals, ok = _masked(c)
    return _filled(vals, ok, True).all(), _has(vals, ok)


def bool_or(c: col.BooleanColumn):
    vals, ok = _masked(c)
    return _filled(vals, ok, False).any(), _has(vals, ok)


def count(c: col.Column) -> torch.Tensor:
    """The number of valid live rows, a 0-d int64 tensor on the device."""
    if c.validity is None and not isinstance(c, col.NullColumn):
        return torch.full((), c.length, dtype=torch.int64, device=c.device)
    return c.valid_bool().sum()


def finalize(pair, dtype: st.DataType = None):
    """(value, has) -> a Python value, or None when no row was valid.  A
    decimal's limbs need `dtype` to be read; a uint64 value reads itself
    (its tensor is torch.uint64)."""
    value, has = pair
    if not bool(has):
        return None
    if dtype is not None and st.decimal_limbs(dtype) is not None:
        from .decimal import to_decimal

        return to_decimal(value, dtype.scale)
    if value.dtype == torch.uint64:  # read as its int64 bits
        return u64.to_python(value.view(torch.int64).item())
    v = value.item()
    if dtype is not None and st.is_u64(dtype) and v < 0:
        return u64.to_python(v)
    return v


__all__ = ["sum_", "product", "min_", "max_", "bool_and", "bool_or",
           "count", "finalize"]
