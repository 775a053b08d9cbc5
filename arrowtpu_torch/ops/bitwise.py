"""Bitwise integer ops.

Counterpart of `arrowtpu/ops/bitwise.py`: `bit_and`, `bit_or`,
`bit_xor`, `bit_not`, `shift_left` and `shift_right`, column with column
or with a Python scalar, in the JAX package's result type
(`arity.result_dtype`).  `shift_right` is arithmetic for signed types and
logical for unsigned ones.  Floats raise ComputeError.

The shift amount follows the JAX package's rule at each width, made
explicit so that the CPU and the card agree (torch leaves an oversized
shift to the hardware):

  * 8, 16 and 32 bits (XLA's shifts): an amount outside [0, bits) gives 0,
    or the sign fill for a signed `shift_right`;
  * int64 and uint64 (the JAX package's limb shifts): the amount is taken
    mod 64, so shift_left(5, 70) is 320 and shift_left(5, -1) is
    INT64_MIN; a uint64 `shift_right` is logical on its int64 bits
    (`core/u64.shift_right`), where torch's `>>` is arithmetic.
"""

from __future__ import annotations

import torch

from .. import schema as st
from ..core import column as col
from ..core import u64
from . import arity


def _check(*xs) -> None:
    for x in xs:
        if isinstance(x, col.Column) and not (
                isinstance(x, col.PrimitiveColumn)
                and isinstance(x.dtype, st.Int)):
            raise st.ComputeError("bitwise ops require integer columns")
        if isinstance(x, float):
            raise st.ComputeError("bitwise ops require integer operands")


def _binary(a, b, fn):
    _check(a, b)
    return arity.binary(a, b, fn)


def bit_and(a, b):
    return _binary(a, b, torch.bitwise_and)


def bit_or(a, b):
    return _binary(a, b, torch.bitwise_or)


def bit_xor(a, b):
    return _binary(a, b, torch.bitwise_xor)


def bit_not(a):
    if not isinstance(a, col.DictionaryColumn):
        _check(a)
    return arity.unary(a, torch.bitwise_not)


def _shift(a, b, left: bool):
    _check(a, b)
    bits, signed = arity._int_info(arity.result_dtype(a, b))

    def fn(x, k):
        if bits == 64:
            k = k & 63
            if left:
                return x << k
            return x >> k if signed else u64.shift_right(x, k)
        ok = (k >= 0) & (k < bits)
        k = torch.where(ok, k, 0)
        if left:
            return torch.where(ok, x << k, 0)
        fill = torch.where(x < 0, -1, 0) if signed else 0
        return torch.where(ok, x >> k, fill)
    return arity.binary(a, b, fn)


def shift_left(a, b):
    return _shift(a, b, True)


def shift_right(a, b):
    return _shift(a, b, False)
