"""Engine-wide constants, option dataclasses and the device policy.

Counterpart of `arrowtpu/config.py` without the JAX x64 switch: PyTorch has
native 64-bit integers, so nothing needs turning on at import.

Capacity policy: a column's physical capacity is its length rounded up to a
multiple of CAPACITY_GRANULE rows.  64 rows keeps every LSB validity bitmap a
whole number of 8-byte words and nothing more; the CUDA compaction kernels
take any row count, so no tile-sized padding exists (the JAX package pads to
128 / 16384 / 65536 rows for its TPU tiles, which is not part of the
contract).
"""

from __future__ import annotations

import dataclasses
import os

import torch

CAPACITY_GRANULE = 64

# Bucket count of the dense-range GROUP BY engine (ops/groupby.py): the
# JAX package's own setting, read from the same environment variable with
# the same default (its CPU test mesh sets 32; the card runs 256).
DENSE_GROUPBY_BUCKETS = int(
    os.environ.get("ARROWTPU_DENSE_GROUPBY_BUCKETS", "256"))


# Elements of a list sort key that take part in the order (the JAX
# package's own bound): lists equal on their first LIST_SORT_BOUND elements
# compare by their lengths (rowformat/encode.py).
LIST_SORT_BOUND = 8


def round_up(n: int, m: int = CAPACITY_GRANULE) -> int:
    return -(-n // m) * m


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    `None` means the card: it raises when there is none, so a caller that
    did not ask for the CPU never silently runs there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "arrowtpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run on the host")
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class SortOptions:
    """Ordering options (ascending, nulls first by default)."""

    descending: bool = False
    nulls_first: bool = True


@dataclasses.dataclass(frozen=True)
class TakeOptions:
    """check_bounds: take also reports whether a valid index falls outside
    the source (ops/take.py)."""

    check_bounds: bool = False


@dataclasses.dataclass(frozen=True)
class CastOptions:
    """safe=True turns a value the target cannot hold into a null;
    safe=False raises ComputeError (ops/cast.py)."""

    safe: bool = True
