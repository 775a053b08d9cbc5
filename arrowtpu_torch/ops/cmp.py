"""Comparisons -> BooleanColumn.

Counterpart of `arrowtpu/ops/cmp.py`: `eq`, `neq`, `lt`, `lt_eq`, `gt`,
`gt_eq`, `distinct` and `not_distinct` on integer, float, boolean,
temporal and decimal columns, either side a column or a Python scalar.
Native dtypes compare natively (float `neq` is true on NaN, as IEEE and
the JAX package's limb compare have it); uint16 and uint32 compare in
int64 and uint64 its bits with the top bit flipped (`core/u64.order_key`),
at the operands' result type (`arity.result_dtype`); float16 natively.
A decimal goes through `ops/decimal.cmp`, with the operands' order
flipped when the decimal is on the right.  The result's validity is the operands' AND; rows past the
length are zero.

`distinct` (IS DISTINCT FROM) is never null: true where exactly one side
is null, or both are valid and differ.  64-bit columns (int64, float64,
the 64-bit temporal types) differ by their bits there, as the JAX
package's limb pairs do (so NaN is not distinct from the same NaN, and
-0.0 is distinct from +0.0); narrower floats by value.
"""

from __future__ import annotations

import operator

import torch

from .. import schema as st
from ..core import bitmap as bm
from ..core import column as col
from ..core import u64
from . import arity

_OPS = {"eq": operator.eq, "neq": operator.ne, "lt": operator.lt,
        "lt_eq": operator.le, "gt": operator.gt, "gt_eq": operator.ge}
_FLIP = {"lt": "gt", "gt": "lt", "lt_eq": "gt_eq", "gt_eq": "lt_eq"}


def _is_decimal(x) -> bool:
    return (isinstance(x, col.PrimitiveColumn)
            and st.decimal_limbs(x.dtype) is not None)


def _cmp(a, b, op: str) -> col.BooleanColumn:
    from . import decimal as dec

    if _is_decimal(a):
        return dec.cmp(a, b, op)
    if _is_decimal(b):
        return dec.cmp(b, a, _FLIP.get(op, op))
    for x in (a, b):
        if isinstance(x, col.DictionaryColumn):
            raise st.ComputeError(
                "cmp on dictionary: decode or compare keys explicitly")
    if _has_unsigned_wide(a, b):
        dt = arity.result_dtype(a, b)
        dev = (a if isinstance(a, col.Column) else b).device
        x, y = arity.operand(a, dt, dev), arity.operand(b, dt, dev)
        if dt == torch.uint64:
            x, y = u64.order_key(x), u64.order_key(y)
        return arity.binary_boolean_out(a, b, lambda *_: _OPS[op](x, y))
    return arity.binary_boolean_out(a, b, _OPS[op])


def _has_unsigned_wide(*xs) -> bool:
    """A uint16, uint32 or uint64 column: torch compares none of them
    natively, so they compare at the operands' compute type (uint64 by
    its order key)."""
    return any(isinstance(x, col.PrimitiveColumn) and isinstance(
        x.dtype, st.Int) and not x.dtype.signed and x.dtype.bits >= 16
        for x in xs)


def eq(a, b):
    return _cmp(a, b, "eq")


def neq(a, b):
    return _cmp(a, b, "neq")


def lt(a, b):
    return _cmp(a, b, "lt")


def lt_eq(a, b):
    return _cmp(a, b, "lt_eq")


def gt(a, b):
    return _cmp(a, b, "gt")


def gt_eq(a, b):
    return _cmp(a, b, "gt_eq")


def _valid_bits(x, capacity, device):
    if isinstance(x, col.Column) and x.validity is not None:
        return x.validity
    return bm.all_valid(capacity, device)


_BITWISE = (st.Timestamp, st.Date64, st.Time64, st.Duration)


def _bits_differ(a, b) -> torch.Tensor:
    """(capacity,) bool: the 64-bit operands' bits differ."""
    base = a if isinstance(a, col.Column) else b

    def bits(x):
        if isinstance(x, col.Column):
            return x.values.view(torch.int64)
        if st.is_u64(base.dtype):
            x = u64.wrap(int(x))
        return torch.tensor(x, dtype=base.values.dtype,
                            device=base.device).view(torch.int64)
    return bits(a) != bits(b)


def distinct(a, b) -> col.BooleanColumn:
    """SQL IS DISTINCT FROM: never null."""
    base = a if isinstance(a, col.Column) else b
    cap, dev = base.capacity, base.device
    av = _valid_bits(a, cap, dev)
    bv = _valid_bits(b, cap, dev)
    if (isinstance(base, col.PrimitiveColumn) and base.values.dim() == 1
            and base.values.element_size() == 8
            and (isinstance(base.dtype, (st.Int, st.Float) + _BITWISE))):
        ne_bits = bm.pack(_bits_differ(a, b))
    else:
        ne_bits = neq(a, b).values
    result = (av ^ bv) | (av & bv & ne_bits)
    return col.BooleanColumn(bm.clip(result, base.length), None, base.length)


def not_distinct(a, b) -> col.BooleanColumn:
    """SQL IS NOT DISTINCT FROM."""
    d = distinct(a, b)
    return col.BooleanColumn(bm.clip(~d.values, d.length), None, d.length)
