"""K1's calls (`arrowtpu_torch.kernels.compact3.compact_planes`): the least
time the bytes they need could take at the HBM's peak, over the device time
of the compaction kernels they launched, in %.

The bytes are the operation's own, whatever implements it, so no
implementation can beat the count: the keep mask of n rows as Arrow's
packed bits, n / 8 bytes, read once; each kept word of the P planes of
w-byte words read once and written once, 2 x kept x P x w bytes; unkept
words count nothing."""

import torch

from portbench.roofline import share

ENTRY = "arrowtpu_torch.kernels.compact3:compact_planes"
KERNELS = ("tile_compact_kernel", "compact16_kernel")


def k1_bytes(n: int, planes: int, word_bytes: int, kept: int) -> int:
    return -(-n // 8) + 2 * kept * planes * word_bytes


def call_bytes(planes, keep, *args, **kwargs):
    """-> the call's bytes, as a function read after the query (the kept
    count is on the device)."""
    plist = list(planes.unbind(0)) if isinstance(
        planes, torch.Tensor) else list(planes)
    word = plist[0].element_size() * (
        plist[0].shape[1] if plist[0].dim() == 2 else 1)
    return lambda: k1_bytes(keep.shape[0], len(plist), word,
                            int((keep != 0).sum()))


def read(t):
    k = t.meters["k1_roofline"]
    return share(k.bytes, k.ms) if k.calls else None
