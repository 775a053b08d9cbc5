"""Vectorized key hashing over u32 row-format planes.

Counterpart of `arrowtpu/rowformat/hashing.py`, bit-exact with it: a
murmur3-style combine per plane and the fmix32 finalizer.  The planes are
the JAX package's u32 key planes (`rowformat/encode.hash_planes_of`), so a
key hashes to the same value in both packages, and a hash partition
(`hash % ndev`, parallel/shuffle.py) sends a row to the same rank.

torch's uint32 arithmetic is incomplete, so the words live in int64
tensors holding values in [0, 2**32).  Every product is split so that no
intermediate leaves the int64 range (a 32 x 32-bit product would), and
every result is masked back to 32 bits.
"""

from __future__ import annotations

from typing import Sequence

import torch

_MASK = 0xFFFFFFFF


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32) and a 32-bit constant c: the
    product in two 16-bit halves of c, each below 2**48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_planes(planes: Sequence[torch.Tensor], seed: int = 0) -> torch.Tensor:
    """(capacity,) int64 hash in [0, 2**32) of each row's u32 key planes
    (int64 tensors holding values in [0, 2**32))."""
    h = torch.full(planes[0].shape, (seed ^ 0x9E3779B9) & _MASK,
                   dtype=torch.int64, device=planes[0].device)
    for p in planes:
        k = _mul(p.to(torch.int64) & _MASK, 0xCC9E2D51)
        k = _mul(_rotl(k, 15), 0x1B873593)
        h = h ^ k
        h = (_mul(_rotl(h, 13), 5) + 0xE6546B64) & _MASK
    return _fmix32(h)
