"""Decimal kernels: comparison, product and sum on N-limb columns.

Counterpart of the part of `arrowtpu/ops/decimal.py` that TPC-H Q6 needs:
`cmp` (all six ops, against a decimal column or a Python Decimal / int),
`mul` and `sum_`.  A decimal column's values are (capacity, N) int32 limbs
(core/limbs.py), so every result is the JAX package's bit for bit:

  * operands are aligned to a common scale and to enough limbs that the
    10^k scale-up cannot wrap (`_align`), then compared as signed limbs;
  * `mul`'s result has scale s1 + s2 and precision p1 + p2 + 1, capped at
    the limb count's maximum (the reference's rule), and wraps at N limbs;
  * `sum_` sums each limb of the valid rows in int64 and carries once at
    the end: the same wrapping N-limb sum as the JAX package's pairwise
    tree, in one pass.

The rest (`add`, `sub`, `rescale`, casts, `min_max`) waits for the
decimal slice.
"""

from __future__ import annotations

import decimal as _pydec
import math

import numpy as np
import torch

from .. import schema as st
from ..core import bitmap as bm
from ..core import column as col
from ..core import limbs as lb


def _dec_info(c):
    nl = st.decimal_limbs(c.dtype)
    if nl is None:
        raise st.ComputeError(f"not a decimal column: {c.dtype}")
    return nl, c.dtype.precision, c.dtype.scale


def _pow10_limbs(nl: int, k: int) -> int:
    """Limb count that holds an nl-limb value scaled by 10**k exactly."""
    extra_bits = math.ceil(k * math.log2(10)) if k else 0
    return nl + (extra_bits + 31) // 32


def _scalar_limbs(u: int, nl: int, like: col.PrimitiveColumn) -> torch.Tensor:
    """An unscaled integer as a (1, nl) row of limbs on `like`'s device: the
    limb ops broadcast it over the rows, so work on the scalar's side (its
    sign flips, its scale-up) is done once, not once a row."""
    limbs = torch.from_numpy(lb.from_scalar(u, nl).view(np.int32).copy())
    return limbs.to(like.device)[None]


def _align(a: col.PrimitiveColumn, b) -> tuple:
    """Bring two decimal operands (a column, or a Python Decimal / int) to
    a common (limb count, scale) -> (limbs a, limbs b, limb count, scale)."""
    nl_a, _, s_a = _dec_info(a)
    if isinstance(b, col.PrimitiveColumn):
        nl_b, _, s_b = _dec_info(b)
        vb = b.values
    else:
        s_b, nl_b = s_a, nl_a
        if isinstance(b, _pydec.Decimal):
            with _pydec.localcontext(_pydec.Context(prec=80)):
                u = int(b.scaleb(s_a).to_integral_value(
                    rounding=_pydec.ROUND_HALF_UP))
        else:
            u = int(b) * 10 ** s_a
        vb = _scalar_limbs(u, nl_a, a)
    nl = max(nl_a, nl_b)
    s = max(s_a, s_b)
    # enough limbs that the 10^k scale-up cannot wrap
    k = max(s - s_a, s - s_b, 0)
    nl_w = _pow10_limbs(nl, k)
    va = lb.widen(a.values, nl_w)
    vb = lb.widen(vb, nl_w)
    if s > s_a:
        va = lb.mul_pow10(va, s - s_a)
    if s > s_b:
        vb = lb.mul_pow10(vb, s - s_b)
    return va, vb, nl_w, s


def _union_validity(a, b):
    return bm.union(a.validity if isinstance(a, col.Column) else None,
                    b.validity if isinstance(b, col.Column) else None)


def _cmp_bools(a, b, op):
    va, vb, _, _ = _align(a, b)
    if op == "eq":
        return lb.eq(va, vb)
    if op == "lt":
        return lb.lt_signed(va, vb)
    if op == "gt":
        return lb.lt_signed(vb, va)
    if op == "neq":
        return ~lb.eq(va, vb)
    if op == "lt_eq":
        return ~lb.lt_signed(vb, va)
    return ~lb.lt_signed(va, vb)  # gt_eq


def cmp(a, b, op: str) -> col.BooleanColumn:
    """a <op> b for a decimal column `a`; rows past the length are zero."""
    bools = _cmp_bools(a, b, op)
    bools[a.length:] = False
    return col.BooleanColumn(bm.pack(bools), _union_validity(a, b), a.length)


def mul(a, b) -> col.PrimitiveColumn:
    """The product; scale s_a + s_b, precision p_a + p_b + 1 capped."""
    nl_a, p_a, s_a = _dec_info(a)
    if isinstance(b, col.PrimitiveColumn):
        nl_b, p_b, s_b = _dec_info(b)
        vb = b.values
    else:
        nl_b, p_b, s_b = nl_a, p_a, 0
        vb = _scalar_limbs(int(b), nl_a, a)
    nl = max(nl_a, nl_b)
    prec = min(st.MAX_DECIMAL_PRECISION[nl], p_a + p_b + 1)
    values = lb.mul_lo(lb.widen(a.values, nl), lb.widen(vb, nl))
    return col.PrimitiveColumn(values, _union_validity(a, b), a.length,
                               st.decimal_for_limbs(nl, prec, s_a + s_b))


def sum_(c: col.PrimitiveColumn):
    """Whole-column sum of the valid rows -> ((N,) int32 limbs, the valid
    row count as a 0-d int64 tensor), wrapping at N limbs: each limb's
    sum in int64 (exact below 2^31 rows), then one carry pass."""
    nl, _, _ = _dec_info(c)
    ok = c.valid_bool()
    if c.capacity >= 1 << 31:
        raise st.ComputeError("decimal sum_: 2^31 rows or more")
    limbs = c.values.to(torch.int64) & 0xFFFFFFFF
    sums = torch.where(ok[:, None], limbs, 0).sum(dim=0)
    out, carry = [], 0
    for j in range(nl):
        t = sums[j] + carry
        out.append(t & 0xFFFFFFFF)
        carry = t >> 32
    return lb.stack_u32(out), ok.sum()


def to_decimal(limbs: torch.Tensor, scale: int) -> _pydec.Decimal:
    """One value's limbs -> a Python Decimal (an 80-digit context)."""
    v = lb.join_ints(limbs.reshape(1, -1).cpu().numpy())[0]
    with _pydec.localcontext(_pydec.Context(prec=80)):
        return _pydec.Decimal(v).scaleb(-scale)
