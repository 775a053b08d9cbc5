"""The yardstick of the kernels: the card's peak, and a share of it.

A share of the roofline is the least time the bytes an operation itself
needs could take at the HBM's peak, over the device time its calls took.
Each kernel's byte count lives with its metric (`metrics/<kernel>_roofline
.py`), counted from the operation, whatever implements it, so no
implementation can beat the count.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB: HBM3 at 3.35 TB/s (NVIDIA's data sheet), at its
# 700 W power limit
HBM_BYTES_PER_S = 3.35e12


def share(nbytes: int, device_ms: float):
    """Percent of the roofline, or None where there is no device time."""
    if not device_ms or device_ms <= 0:
        return None
    return 100.0 * (nbytes / HBM_BYTES_PER_S * 1e3) / device_ms
