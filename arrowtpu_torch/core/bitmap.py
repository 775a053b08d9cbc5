"""Arrow LSB-packed bitmaps as uint8 byte tensors.

Counterpart of `arrowtpu/core/bitmap.py` with Arrow's own bit order: bit b
of byte i is row 8*i + b, so a bitmap is byte-for-byte an Arrow validity
buffer.  (The JAX package stores a sublane-major order chosen for the TPU;
the two agree only when compared as bools.)  Capacities are multiples of
config.CAPACITY_GRANULE, so a bitmap is always a whole number of bytes and
word-wise ops need no edge masking.  Bits beyond a column's length are 0.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_W = 8


def num_bytes(capacity: int) -> int:
    if capacity % _W:
        raise ValueError(f"capacity {capacity} not a multiple of {_W}")
    return capacity // _W


def capacity_of(bitmap: torch.Tensor) -> int:
    return bitmap.shape[0] * _W


@functools.lru_cache(maxsize=None)
def _shifts(device: torch.device) -> torch.Tensor:
    """The bit positions 0..7, made once per device (a read-only constant
    that saves a launch in every pack and unpack)."""
    return torch.arange(_W, dtype=torch.uint8, device=device)


def pack(bools: torch.Tensor) -> torch.Tensor:
    """bool (capacity,) -> uint8 (capacity/8,), LSB first."""
    rows = bools.to(torch.uint8).reshape(num_bytes(bools.shape[0]), _W)
    return (rows << _shifts(bools.device)).sum(dim=1, dtype=torch.uint8)


def unpack(bitmap: torch.Tensor) -> torch.Tensor:
    """uint8 (capacity/8,) -> bool (capacity,)."""
    bits = (bitmap[:, None] >> _shifts(bitmap.device)) & 1
    return bits.reshape(-1).bool()


def count_set_bits(bitmap: torch.Tensor) -> torch.Tensor:
    """Total popcount as a 0-d int64 tensor (stays on the device)."""
    return unpack(bitmap).sum()


def row_mask_bool(capacity: int, length: int, device) -> torch.Tensor:
    """(capacity,) bool: row is real data, not padding."""
    return torch.arange(capacity, device=device) < length


def row_mask(capacity: int, length: int, device) -> torch.Tensor:
    """Packed mask with rows [0, length) set."""
    return pack(row_mask_bool(capacity, length, device))


def clip(bitmap: torch.Tensor, length: int) -> torch.Tensor:
    """`bitmap` with the bits of rows >= length cleared (no work when the
    length is the whole capacity): a copy whose tail bytes are written,
    not a mask of the whole capacity."""
    capacity = capacity_of(bitmap)
    if length >= capacity:
        return bitmap
    out = bitmap.clone()
    out[-(-length // _W):] = 0
    if length % _W:
        out[length // _W] &= (1 << (length % _W)) - 1
    return out


def all_valid(capacity: int, device) -> torch.Tensor:
    return torch.full((num_bytes(capacity),), 0xFF, dtype=torch.uint8,
                      device=device)


def union(a, b):
    """AND-merge of two optional validity bitmaps; None means all valid."""
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def from_numpy_bools(bools: np.ndarray, capacity: int, device) -> torch.Tensor:
    padded = np.zeros(capacity, dtype=bool)
    padded[: len(bools)] = bools
    return torch.from_numpy(np.packbits(padded, bitorder="little")).to(device)


def to_numpy_bools(bitmap: torch.Tensor, length: int) -> np.ndarray:
    raw = bitmap.cpu().numpy()
    return np.unpackbits(raw, bitorder="little")[:length].astype(bool)
