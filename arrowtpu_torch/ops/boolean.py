"""Boolean logic on packed bitmaps, SQL Kleene logic included.

Counterpart of `arrowtpu/ops/boolean.py`: `and_`, `or_`, `xor`, `not_`,
`and_not` (the non-Kleene ops: null where an operand is null),
`and_kleene`, `or_kleene`, `is_null` and `is_not_null`.  Byte-wise ops on
the LSB bitmaps, 8 rows per byte, no unpacking; bits past the length stay
0 (`not_` clears them).

  false AND NULL = false;  NULL AND NULL = NULL;  true AND NULL = NULL
  true  OR  NULL = true;   NULL OR  NULL = NULL;  false OR NULL = NULL

`is_null` and `is_not_null` are never null.
"""

from __future__ import annotations

import torch

from .. import schema as st
from ..core import bitmap as bm
from ..core import column as col


def _check(a, b, name: str) -> None:
    if not (isinstance(a, col.BooleanColumn)
            and isinstance(b, col.BooleanColumn)):
        raise st.ComputeError(f"{name} requires BooleanColumn inputs")
    if a.capacity != b.capacity:
        raise st.ComputeError(f"{name}: capacity mismatch")


def _plain(a, b, name: str, values) -> col.BooleanColumn:
    _check(a, b, name)
    return col.BooleanColumn(values, bm.union(a.validity, b.validity),
                             a.length)


def and_(a: col.BooleanColumn, b: col.BooleanColumn) -> col.BooleanColumn:
    return _plain(a, b, "and_", a.values & b.values)


def or_(a: col.BooleanColumn, b: col.BooleanColumn) -> col.BooleanColumn:
    return _plain(a, b, "or_", a.values | b.values)


def xor(a: col.BooleanColumn, b: col.BooleanColumn) -> col.BooleanColumn:
    return _plain(a, b, "xor", a.values ^ b.values)


def and_not(a: col.BooleanColumn, b: col.BooleanColumn) -> col.BooleanColumn:
    """a AND NOT b."""
    return _plain(a, b, "and_not", a.values & ~b.values)


def not_(a: col.BooleanColumn) -> col.BooleanColumn:
    if not isinstance(a, col.BooleanColumn):
        raise st.ComputeError("not_ requires a BooleanColumn")
    return col.BooleanColumn(bm.clip(~a.values, a.length), a.validity,
                             a.length)


def _kleene(a, b, name: str, value, valid_if):
    """Kleene `value` of a and b: valid where both are valid or where one
    side alone decides (`valid_if(v, bits)`: the valid rows of one side
    whose bits decide)."""
    _check(a, b, name)
    if a.validity is None and b.validity is None:
        return col.BooleanColumn(value, None, a.length)
    av = a.validity if a.validity is not None else bm.all_valid(
        a.capacity, a.device)
    bv = b.validity if b.validity is not None else bm.all_valid(
        b.capacity, b.device)
    validity = (av & bv) | valid_if(av, a.values) | valid_if(bv, b.values)
    return col.BooleanColumn(value, bm.clip(validity, a.length), a.length)


def and_kleene(a: col.BooleanColumn, b: col.BooleanColumn) -> col.BooleanColumn:
    # valid iff both valid, or either side is a valid false
    return _kleene(a, b, "and_kleene", a.values & b.values,
                   lambda v, bits: v & ~bits)


def or_kleene(a: col.BooleanColumn, b: col.BooleanColumn) -> col.BooleanColumn:
    # valid iff both valid, or either side is a valid true
    return _kleene(a, b, "or_kleene", a.values | b.values,
                   lambda v, bits: v & bits)


def is_null(a: col.Column) -> col.BooleanColumn:
    """True at the live null rows; never null."""
    if isinstance(a, col.NullColumn):
        bits = bm.row_mask(a.capacity, a.length, a.device)
    elif a.validity is None:
        bits = torch.zeros(bm.num_bytes(a.capacity), dtype=torch.uint8,
                           device=a.device)
    else:
        bits = bm.clip(~a.validity, a.length)
    return col.BooleanColumn(bits, None, a.length)


def is_not_null(a: col.Column) -> col.BooleanColumn:
    """True at the live valid rows; never null."""
    if isinstance(a, col.NullColumn):
        bits = torch.zeros(bm.num_bytes(a.capacity), dtype=torch.uint8,
                           device=a.device)
    elif a.validity is None:
        bits = bm.row_mask(a.capacity, a.length, a.device)
    else:
        bits = bm.clip(a.validity, a.length)
    return col.BooleanColumn(bits, None, a.length)
