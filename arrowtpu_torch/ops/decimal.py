"""Decimal kernels: arithmetic, comparison, rescale, casts, aggregation.

Counterpart of `arrowtpu/ops/decimal.py`.  A decimal column's values are
(capacity, N) int32 limbs (core/limbs.py), so every result is the JAX
package's bit for bit:

  * operands are aligned to a common scale and to enough limbs that the
    10^k scale-up cannot wrap (`_align`), then compared as signed limbs;
  * `add` / `sub` compute exactly in the aligned width; the result has
    the wider input's limb count, scale max(s1, s2) and precision
    max(p1 - s1, p2 - s2) + s + 1, capped; a row that overflows it is
    null (`_addsub_result`, the reference's rule);
  * `mul`'s result has scale s1 + s2 and precision p1 + p2 + 1, capped at
    the limb count's maximum (the reference's rule), and wraps at N limbs;
  * `rescale` (decimal -> decimal), `to_int` (truncating) and the other
    casts null a row out of the target's range when `safe`;
  * `sum_` sums each limb of the valid rows in int64 and carries once at
    the end: the same wrapping N-limb sum as the JAX package's pairwise
    tree, in one pass; `min_max` reduces the sign-flipped limbs.

A scalar operand (a Python Decimal or int) is one row of limbs that the
limb ops broadcast.  Rows past the length stay zero, and their validity
bits clear.
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


def _with_ok(validity, ok: torch.Tensor, length: int) -> torch.Tensor:
    """`validity` AND the (capacity,) bool `ok`, the rows past the length
    cleared (the JAX package's union with pack(ok))."""
    ok = ok.clone()
    ok[length:] = False
    return bm.union(validity, bm.pack(ok))


def _out(base, values: torch.Tensor, validity, dtype) -> col.PrimitiveColumn:
    """A result column of `base`'s length, its rows past the length
    zeroed (a scalar operand broadcast over them leaves them non-zero)."""
    values[base.length:] = 0
    return col.PrimitiveColumn(values, validity, base.length, dtype)


def _in_precision(v: torch.Tensor, nl_out: int, nl_w: int, precision: int,
                  like) -> torch.Tensor:
    """(capacity,) bool: the nl_w-limb value fits nl_out limbs and its
    magnitude is below 10**precision."""
    ok = (lb.fits_in(v, nl_out) if nl_out < nl_w else
          torch.ones(v.shape[:-1], dtype=torch.bool, device=v.device))
    bound = _scalar_limbs(10 ** precision, nl_w, like)
    mag = torch.where(lb.is_negative(v)[..., None], lb.neg(v), v)
    return ok & lb.lt_unsigned(mag, bound)


def _addsub_result(a, b, raw: torch.Tensor, nl_w: int, s: int):
    nl_a, p_a, s_a = _dec_info(a)
    if isinstance(b, col.PrimitiveColumn):
        nl_b, p_b, s_b = _dec_info(b)
    else:
        nl_b, p_b, s_b = nl_a, p_a, s_a
    nl = max(nl_a, nl_b)
    prec = min(st.MAX_DECIMAL_PRECISION[nl], max(p_a - s_a, p_b - s_b) + s + 1)
    ok = _in_precision(raw, nl, nl_w, prec, a)
    return _out(a, lb.narrow(raw, nl).contiguous(),
                _with_ok(_union_validity(a, b), ok, a.length),
                st.decimal_for_limbs(nl, prec, s))


def add(a, b) -> col.PrimitiveColumn:
    """a + b for a decimal column `a` and a decimal column or scalar."""
    va, vb, nl_w, s = _align(a, b)
    return _addsub_result(a, b, lb.add(va, vb), nl_w, s)


def sub(a, b) -> col.PrimitiveColumn:
    """a - b for a decimal column `a` and a decimal column or scalar."""
    va, vb, nl_w, s = _align(a, b)
    return _addsub_result(a, b, lb.sub(va, vb), nl_w, s)


def neg(a) -> col.PrimitiveColumn:
    return col.PrimitiveColumn(lb.neg(a.values), a.validity, a.length,
                               a.dtype)


def abs_(a) -> col.PrimitiveColumn:
    v = torch.where(lb.is_negative(a.values)[..., None], lb.neg(a.values),
                    a.values)
    return col.PrimitiveColumn(v, a.validity, a.length, a.dtype)


def rescale(a, dtype: st.DataType, safe: bool = True) -> col.PrimitiveColumn:
    """decimal -> decimal cast to `dtype`'s width, precision and scale
    (a lower scale truncates toward zero); a row out of the target
    precision is null when `safe`, else keeps its wrapped value."""
    nl_in, _, s_in = _dec_info(a)
    nl_out = st.decimal_limbs(dtype)
    s_out = dtype.scale
    nl_w = _pow10_limbs(max(nl_in, nl_out), max(s_out - s_in, 0))
    v = lb.widen(a.values, nl_w)
    if s_out > s_in:
        v = lb.mul_pow10(v, s_out - s_in)
    elif s_out < s_in:
        v, _ = lb.divmod_pow10(v, s_in - s_out)
    out = (lb.narrow(v, nl_out) if nl_out <= nl_w
           else lb.widen(v, nl_out)).contiguous()
    validity = a.validity
    if safe:
        validity = _with_ok(validity, _in_precision(v, nl_out, nl_w,
                                                    dtype.precision, a),
                            a.length)
    return col.PrimitiveColumn(out, validity, a.length, dtype)


def from_int(c: col.PrimitiveColumn, dtype: st.DataType
             ) -> col.PrimitiveColumn:
    """Integer column -> decimal at `dtype`'s scale (wrapping, as the JAX
    package's: a 32-bit value is its int32 bits sign-extended, an int64
    its two limbs)."""
    nl = st.decimal_limbs(dtype)
    x = c.values.to(torch.int64)
    if c.values.element_size() == 8:
        v = lb.widen(x.view(torch.int32).reshape(-1, 2), nl)
    else:
        v = lb.widen(lb.stack_u32([x & 0xFFFFFFFF]), nl)
    return col.PrimitiveColumn(lb.mul_pow10(v, dtype.scale).contiguous(),
                               c.validity, c.length, dtype)


def to_int(c: col.PrimitiveColumn, dtype: st.DataType = st.int64,
           safe: bool = True) -> col.PrimitiveColumn:
    """decimal -> int64, truncating toward zero; a value outside int64 is
    null when `safe`, else wraps."""
    nl, _, s = _dec_info(c)
    v, _ = lb.divmod_pow10(c.values, s)
    ok = (lb.fits_in(v, 2) if nl > 2 else
          torch.ones(v.shape[:-1], dtype=torch.bool, device=v.device))
    pair = (lb.widen(v, 2) if nl < 2 else lb.narrow(v, 2)).contiguous()
    validity = _with_ok(c.validity, ok, c.length) if safe else c.validity
    return col.PrimitiveColumn(pair.view(torch.int64).reshape(-1), validity,
                               c.length, dtype)


def to_float(c: col.PrimitiveColumn) -> col.PrimitiveColumn:
    """decimal -> float64: the limbs' value (`limbs.to_float`) over
    10**scale."""
    _, _, s = _dec_info(c)
    return col.PrimitiveColumn(lb.over_pow10(lb.to_float(c.values), s),
                               c.validity, c.length, st.float64)


def from_float(c: col.PrimitiveColumn, dtype: st.DataType
               ) -> col.PrimitiveColumn:
    """float -> decimal, rounding half away from zero (the JAX package's
    rule), the magnitude split into 32-bit limbs by repeated fmod and
    floor division (exact below 2^96)."""
    nl = st.decimal_limbs(dtype)
    scaled = c.values.to(torch.float64) * float(10 ** dtype.scale)
    r = torch.where(scaled >= 0, torch.floor(scaled + 0.5),
                    torch.ceil(scaled - 0.5))
    mag = r.abs()
    limbs = []
    for _ in range(nl):
        limbs.append(torch.fmod(mag, float(1 << 32)).to(torch.int64))
        mag = torch.floor(mag / float(1 << 32))
    v = lb.stack_u32(limbs)
    v = torch.where((r < 0)[:, None], lb.neg(v), v)
    return col.PrimitiveColumn(v, c.validity, c.length, dtype)


def to_string(c: col.PrimitiveColumn) -> col.StringViewColumn:
    """decimal -> utf8, formatted on the host."""
    return col.string_view([None if v is None else str(v)
                            for v in c.to_pylist()], device=c.device)


def from_string(c: col.StringViewColumn, dtype: st.DataType
                ) -> col.PrimitiveColumn:
    """utf8 -> decimal, parsed on the host (round half up); an
    unparsable string is null."""
    out, valid = [], []
    for t in c.to_pylist():
        try:
            out.append(None if t is None else col._unscaled(
                _pydec.Decimal(t), dtype.scale))
        except _pydec.InvalidOperation:
            out.append(None)
        valid.append(out[-1] is not None)
    return col.primitive(lb.split_ints(out, st.decimal_limbs(dtype)), dtype,
                         validity=np.asarray(valid, bool), device=c.device)


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


def min_max(c: col.PrimitiveColumn, is_min: bool):
    """Whole-column min (or max) of the valid rows -> ((N,) int32 limbs,
    0-d bool: some row is valid).  With no valid row the limbs are the
    identity the JAX package's reduction leaves (the largest value for
    min, the smallest for max)."""
    nl, _, _ = _dec_info(c)
    ok = c.valid_bool()
    planes = lb.order_planes(c.values)
    ident = 0xFFFFFFFF if is_min else 0
    cand = ok
    best = []
    for p in planes:  # the lexicographic extreme, plane by plane
        v = torch.where(cand, p, ident)
        b = v.min() if is_min else v.max()
        best.append(b)
        cand = cand & (p == b)
    return lb.from_order_planes(best), ok.any()


def to_decimal(limbs: torch.Tensor, scale: int) -> _pydec.Decimal:
    """One value's limbs -> a Python Decimal (an 80-digit context)."""
    v = lb.join_ints(limbs.reshape(1, -1).cpu().numpy())[0]
    with _pydec.localcontext(_pydec.Context(prec=80)):
        return _pydec.Decimal(v).scaleb(-scale)
