"""uint64 arithmetic on int64 tensors holding the bits.

torch's own uint64 lacks comparisons, addition, division and reductions on
the CPU, so a uint64 column holds its 64 bits in an int64 tensor
(schema.py).  Addition, subtraction, multiplication, negation and the
bitwise ops are the same bits either way; what differs is here:

  * `order_key`: the bits with the top bit flipped, whose signed order is
    the unsigned order (compare, min, max, sort);
  * `lt`: unsigned less-than;
  * `shift_right`: a logical shift (torch's `>>` on int64 is arithmetic);
  * `divmod_`: exact unsigned division with no float: a divisor of 2**63 or
    more gives a quotient of 0 or 1; any other halves the dividend, divides
    and corrects by one;
  * `to_float`: `hi * 2**32 + lo` in float64, one correctly rounded
    addition (the JAX package's `wide.u64_to_float`);
  * `wrap`: a Python int as the int64 with its low 64 bits.
"""

from __future__ import annotations

import torch

MIN = -(1 << 63)
_LOW63 = (1 << 63) - 1
_U32 = 0xFFFFFFFF


def wrap(v: int) -> int:
    """A Python int -> the int64 whose bits are v mod 2**64."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def to_python(v: int) -> int:
    """An int64 holding uint64 bits -> the unsigned value."""
    return v + (1 << 64) if v < 0 else v


def order_key(x: torch.Tensor) -> torch.Tensor:
    """int64 whose signed order is the unsigned order of the bits."""
    return x ^ MIN


def lt(x: torch.Tensor, y) -> torch.Tensor:
    """x < y, both read as unsigned."""
    return (x ^ MIN) < (y ^ MIN)


def shift_right(x: torch.Tensor, k) -> torch.Tensor:
    """x >> k, logical, for k in [0, 63]."""
    first = (x >> 1) & _LOW63
    if isinstance(k, int):
        return x if k == 0 else first >> (k - 1)
    return torch.where(k == 0, x, first >> (k - 1).clamp(min=0))


def divmod_(x: torch.Tensor, d):
    """(x // d, x % d) of the unsigned values; a zero divisor gives 0 and
    0 (what the JAX package's limb division gives)."""
    if isinstance(d, int):
        d = torch.full((1,), wrap(d), dtype=torch.int64, device=x.device)
    zero = d == 0
    big = d < 0  # 2**63 or more
    safe = torch.where(zero | big, 1, d)
    q = ((x >> 1) & _LOW63).div(safe, rounding_mode="floor") << 1
    r = x - q * safe
    q = torch.where(lt(r, safe), q, q + 1)
    q = torch.where(big, (~lt(x, d)).to(torch.int64), q)
    q = torch.where(zero, 0, q)
    r = torch.where(zero, 0, x - q * d)
    return q, r


def to_float(x: torch.Tensor) -> torch.Tensor:
    """The unsigned values as float64: hi * 2**32 + lo, each half exact,
    the sum rounded once."""
    hi = ((x >> 32) & _U32).to(torch.float64)
    lo = (x & _U32).to(torch.float64)
    return hi * 4294967296.0 + lo


def from_float(v: torch.Tensor) -> torch.Tensor:
    """Non-negative integral float64 values below 2**64 -> uint64 bits
    (the JAX package's split: hi = floor(v / 2**32), lo = v - hi *
    2**32, both exact)."""
    hi = torch.floor(v / 4294967296.0)
    lo = v - hi * 4294967296.0
    return (hi.to(torch.int64) << 32) | lo.to(torch.int64)
