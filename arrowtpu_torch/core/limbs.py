"""N-limb two's-complement integers: the decimals' arithmetic.

Counterpart of `arrowtpu/core/limbs.py`.  torch has no int128 and its
uint32 lacks comparisons, so an N-limb value is a (..., N) int32 tensor:
the JAX package's little-endian u32 limbs, bit for bit, held as int32 (as
string views hold their words).  A Decimal128 row is then 16 contiguous
bytes, the bytes of a native i128.

The arithmetic follows the JAX package's algorithms one to one, each
limb widened to int64 (`& 0xFFFFFFFF`) and stored back as int32 bits, so
results are bit-exact by construction.  A 32 x 32-bit product is formed
from 16-bit halves, so no int64 product overflows.  Multiplies and adds
stay separate operations (no fused multiply-add reaches `to_float`).
All ops are elementwise over the leading axes; the sign is bit 31 of the
top limb.
"""

from __future__ import annotations

import numpy as np
import torch

_M = 0xFFFFFFFF
_SIGN = -(1 << 31)  # int32 with only bit 31 set


# ---------------------------------------------------------------------------
# host <-> limb conversion (exact, via Python ints)
# ---------------------------------------------------------------------------


def split_ints(values, n_limbs: int) -> np.ndarray:
    """Python ints (or None -> 0) -> (n, n_limbs) uint32, two's complement
    little-endian."""
    out = np.zeros((len(values), n_limbs), np.uint32)
    mask_bits = (1 << (32 * n_limbs)) - 1
    for i, v in enumerate(values):
        u = (int(v) if v is not None else 0) & mask_bits
        for j in range(n_limbs):
            out[i, j] = (u >> (32 * j)) & _M
    return out


def join_ints(limbs: np.ndarray) -> list:
    """(n, N) uint32 (or int32 bits) -> list of signed Python ints."""
    limbs = np.asarray(limbs).astype(np.uint32)
    n, nl = limbs.shape
    half = 1 << (32 * nl - 1)
    full = 1 << (32 * nl)
    out = []
    for i in range(n):
        u = 0
        for j in range(nl - 1, -1, -1):
            u = (u << 32) | int(limbs[i, j])
        out.append(u - full if u >= half else u)
    return out


def from_scalar(v: int, n_limbs: int) -> np.ndarray:
    return split_ints([v], n_limbs)[0]


def split_int64(values: np.ndarray, n_limbs: int) -> np.ndarray:
    """int64 array -> (n, n_limbs) uint32 limbs, sign-extended; vectorized
    (a decimal column of cents built in bulk)."""
    v = np.ascontiguousarray(values, dtype=np.int64)
    words = v.view(np.uint32).reshape(-1, 2)
    out = np.empty((v.shape[0], n_limbs), np.uint32)
    out[:, : min(n_limbs, 2)] = words[:, : min(n_limbs, 2)]
    if n_limbs > 2:
        out[:, 2:] = np.where(v < 0, np.uint32(_M), np.uint32(0))[:, None]
    return out


# ---------------------------------------------------------------------------
# limb helpers
# ---------------------------------------------------------------------------


def _u(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> their unsigned value in int64."""
    return x.to(torch.int64) & _M


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> its low 32 bits as int32 (the low words of the
    little-endian int64s)."""
    flat = x.contiguous().reshape(-1)
    return flat.view(torch.int32)[0::2].reshape(x.shape)


def stack_u32(limbs) -> torch.Tensor:
    """int64 limb values in [0, 2^32) -> their (..., N) int32 bits."""
    return torch.stack([_i32(x) for x in limbs], dim=-1)


def _mul32(a: torch.Tensor, b: torch.Tensor):
    """Unsigned 32 x 32 -> (lo, hi), each in [0, 2^32) as int64, from the
    16-bit halves of `a` (each partial product < 2^48)."""
    x = (a & 0xFFFF) * b
    y = (a >> 16) * b
    low = x + ((y & 0xFFFF) << 16)
    return low & _M, (y >> 16) + (low >> 32)


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N) + (..., N), wrapping two's complement."""
    outs, carry = [], None
    for j in range(a.shape[-1]):
        s = _u(a[..., j]) + _u(b[..., j])
        if carry is not None:
            s = s + carry
        outs.append(s & _M)
        carry = s >> 32
    return stack_u32(outs)


def neg(a: torch.Tensor) -> torch.Tensor:
    """Two's-complement negate."""
    one = torch.zeros_like(a)
    one[..., 0] = 1
    return add(~a, one)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return add(a, neg(b))


def is_negative(a: torch.Tensor) -> torch.Tensor:
    return a[..., -1] < 0


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=-1)


def _lt_limb(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Unsigned < of int32 bits: flip bit 31, compare signed."""
    return (x ^ _SIGN) < (y ^ _SIGN)


def lt_unsigned(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned <, comparing limbs high -> low."""
    lt = _lt_limb(a[..., 0], b[..., 0])
    for j in range(1, a.shape[-1]):
        lt = torch.where(a[..., j] == b[..., j], lt,
                         _lt_limb(a[..., j], b[..., j]))
    return lt


def lt_signed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Signed <: the top limb compares signed, the others unsigned (the
    JAX package's sign-bit flip of the top limb, then unsigned order)."""
    top = a.shape[-1] - 1
    if top == 0:
        return a[..., 0] < b[..., 0]
    lt = lt_unsigned(a[..., :top], b[..., :top])
    return torch.where(a[..., top] == b[..., top], lt,
                       a[..., top] < b[..., top])


def mul_lo(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The low N limbs of the product (wrapping), schoolbook on 32 x 32 ->
    64-bit partials."""
    nl = a.shape[-1]
    ua = [_u(a[..., j]) for j in range(nl)]
    acc = [torch.zeros_like(ua[0]) for _ in range(nl)]
    for i in range(nl):
        bi = _u(b[..., i])
        carry = None
        for j in range(nl - i):
            lo, hi = _mul32(ua[j], bi)
            s = acc[i + j] + lo
            if carry is not None:
                s = s + carry
            acc[i + j] = s & _M
            carry = hi + (s >> 32)
    return stack_u32(acc)


def mul_small(a: torch.Tensor, m: int) -> torch.Tensor:
    """Multiply by a u32 constant (wrapping)."""
    outs, carry = [], None
    for j in range(a.shape[-1]):
        lo, hi = _mul32(_u(a[..., j]), m)
        s = lo if carry is None else lo + carry
        outs.append(s & _M)
        carry = hi + (s >> 32)
    return stack_u32(outs)


def divmod_small_unsigned(a: torch.Tensor, d: int):
    """(a // d, a % d) of the unsigned value, for 0 < d < 2^16 (the JAX
    package's bound); long division high -> low.  The remainder is int64."""
    assert 0 < d < (1 << 16), "divmod_small_unsigned requires d < 2^16"
    nl = a.shape[-1]
    rem = torch.zeros(a.shape[:-1], dtype=torch.int64, device=a.device)
    qs = [None] * nl
    for j in range(nl - 1, -1, -1):
        cur = (rem << 32) | _u(a[..., j])
        q = torch.div(cur, d, rounding_mode="floor")
        rem = cur - q * d
        qs[j] = q
    return stack_u32(qs), rem


def divmod_pow10(a: torch.Tensor, k: int):
    """Signed divide by 10**k, truncating toward zero -> (q, r): r is the
    magnitude's remainder composed over steps of at most 10^4, wrapped to
    32 bits as the JAX package's u32 is (exact for k <= 9)."""
    if k == 0:
        return a, torch.zeros(a.shape[:-1], dtype=torch.int64,
                              device=a.device)
    negm = is_negative(a)[..., None]
    mag = torch.where(negm, neg(a), a)
    rem_total = torch.zeros(a.shape[:-1], dtype=torch.int64, device=a.device)
    mult, kk = 1, k
    while kk > 0:
        step = min(kk, 4)
        d = 10 ** step
        mag, r = divmod_small_unsigned(mag, d)
        rem_total = (rem_total + r * (mult & _M)) & _M
        mult *= d
        kk -= step
    return torch.where(negm, neg(mag), mag), rem_total


def mul_pow10(a: torch.Tensor, k: int) -> torch.Tensor:
    """Multiply by 10**k (wrapping)."""
    out, kk = a, k
    while kk > 0:
        step = min(kk, 9)
        out = mul_small(out, 10 ** step)
        kk -= step
    return out


# ---------------------------------------------------------------------------
# width conversion
# ---------------------------------------------------------------------------


def widen(a: torch.Tensor, n_limbs: int) -> torch.Tensor:
    """Sign-extend (..., M) -> (..., n_limbs)."""
    m = a.shape[-1]
    if m == n_limbs:
        return a
    assert m < n_limbs
    ext = torch.where(is_negative(a), -1, 0).to(torch.int32)
    pads = ext[..., None].expand(*a.shape[:-1], n_limbs - m)
    return torch.cat([a, pads], dim=-1)


def narrow(a: torch.Tensor, n_limbs: int) -> torch.Tensor:
    """The low n_limbs limbs (wrapping)."""
    return a[..., :n_limbs]


def fits_in(a: torch.Tensor, n_limbs: int) -> torch.Tensor:
    """True where the signed value is representable in n_limbs limbs."""
    want = torch.where(a[..., n_limbs - 1] < 0, -1, 0).to(torch.int32)
    return (a[..., n_limbs:] == want[..., None]).all(dim=-1)


def to_float(a: torch.Tensor) -> torch.Tensor:
    """Signed N-limb value -> float64: |a|'s limbs scaled by 2^(32 j) and
    summed low to high, the sign applied last (each scaling is exact, and
    the multiply and the add are separate operations)."""
    negm = is_negative(a)
    mag = torch.where(negm[..., None], neg(a), a)
    acc = torch.zeros(a.shape[:-1], dtype=torch.float64, device=a.device)
    for j in range(a.shape[-1]):
        term = _u(mag[..., j]).to(torch.float64) * float(2 ** (32 * j))
        acc = acc + term
    return torch.where(negm, -acc, acc)


def sort_planes(a: torch.Tensor) -> list:
    """Order-preserving u32 planes (int32 bits, most significant first) of
    the signed value: the top limb's sign bit flipped."""
    nl = a.shape[-1]
    return [a[..., nl - 1] ^ _SIGN] + [a[..., j] for j in range(nl - 2, -1, -1)]
