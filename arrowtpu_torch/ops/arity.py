"""Elementwise ops with Arrow null semantics.

Counterpart of `arrowtpu/ops/arity.py`: the result's validity is the AND
of the operands' validities (None stays None, and a single bitmap is passed
through as the same object, which lets the filter recognise it), and the op
computes on every slot, nulls included; values under nulls are unspecified.
A Python scalar operand broadcasts as an all-valid column.  Rows past the
length are zeroed, as the padding contract requires.
"""

from __future__ import annotations

import torch

from .. import schema as st
from ..core import bitmap as bm
from ..core import column as col


def _vals(x):
    if isinstance(x, col.BooleanColumn):
        return x.values_bool()
    if isinstance(x, col.PrimitiveColumn):
        return x.values
    raise st.ComputeError(f"unsupported operand {type(x).__name__}")


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


def binary(a, b, fn) -> col.PrimitiveColumn:
    av, bv, validity, base = _operands(a, b)
    values = _zero_padding(fn(av, bv), base)
    return col.PrimitiveColumn(values, validity, base.length,
                               st.from_torch(values.dtype))


def binary_boolean_out(a, b, fn) -> col.BooleanColumn:
    av, bv, validity, base = _operands(a, b)
    bools = _zero_padding(fn(av, bv), base)
    return col.BooleanColumn(bm.pack(bools), validity, base.length)
