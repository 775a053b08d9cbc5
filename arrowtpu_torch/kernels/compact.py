"""K2: compaction of byte (u8 / bool) and 4-byte planes, in CUDA.

Counterpart of `arrowtpu/pallas/compact.py` (`compact_planes_info`,
`compact_words`, `compact_bytes`, `tile_info` -> `_compact_call` ->
`_compact_kernel`).  Its u8 mode compacts the filter's bool planes and
validity.  The kernel is K1's, `tile_compact_kernel`
(`csrc/tile_rank.cuh`, launched from `csrc/compact.cu`), instantiated for
uint8 (u8 mode) and uint32 (u32 mode, K1's instantiation) words; the
design and its bound on the card are in those files' headers.  Given
`info` (the filter's plan) each tile reads its output offset there and the
count is `info[-1]`; without it the tiles find their offsets by a
decoupled look-back inside one launch (after a scratch memset, with no
count pass and no cumsum), and the last tile writes the count to a device
word that is returned as it is, never read on the host.

Contract, as in the JAX package: the kept words first in row order, zeros
from `count` on, and `count` returned beside the planes (a 0-d int64
tensor, left on the device).  Any n; `out_rows` (default n, at least the
count) sets the output length as in kernels/compact3.py.

A CPU tensor takes the plain PyTorch version beside the kernel; a CUDA
tensor launches the kernel or raises.  `launches` counts the kernel
launches.
"""

from __future__ import annotations

import torch

from . import _build

WORD_BYTES = (1, 4)

launches = 0

# (ceil(n / TILE_ROWS) + 1,) int64 exclusive prefix of the kept counts per
# tile; shareable across every plane compacted by the same mask.
tile_info = _build.tile_offsets


def compact_planes_info_plain(planes, keep: torch.Tensor,
                              out_rows: int = None):
    """The plain version: boolean indexing into a zero-filled output."""
    plist = _build.check_operands(planes, keep, WORD_BYTES)
    rows = _build.out_rows_of(keep, out_rows)
    result, outs = _build.empty_outputs(planes, plist, rows)
    sel = keep.bool()
    for p, out in zip(plist, outs):
        kept = p[sel]
        out.zero_()
        out[: kept.shape[0]] = kept
    return result, sel.sum()


def compact_planes_info(planes, keep: torch.Tensor, info: torch.Tensor = None,
                        out_rows: int = None):
    """Compact (P, n) byte or 4-byte planes (a tensor, or a sequence of
    (n,) tensors; the result takes the same form) by `keep`.
    Returns (planes, count); `info` is `tile_info(keep)` when the caller
    already has it."""
    global launches
    if keep.device.type == "cpu":
        return compact_planes_info_plain(planes, keep, out_rows)
    _build.require_cuda(keep, "compact.compact_planes_info")
    plist = _build.check_operands(planes, keep, WORD_BYTES)
    rows = _build.out_rows_of(keep, out_rows)
    result, outs = _build.empty_outputs(planes, plist, rows)
    if keep.shape[0] == 0:
        return result, torch.zeros((), dtype=torch.int64, device=keep.device)
    if info is None:  # the tiles look back; the last writes the count
        scratch = _build.lookback_scratch(keep)
        count = torch.empty((), dtype=torch.int64, device=keep.device)
    else:
        scratch, count = None, info[-1]
    step = _build.MAX_PLANES
    for i in range(0, len(plist), step):
        _build.tiles_cuda(plist[i:i + step], outs[i:i + step], keep, info,
                          scratch, count if info is None else None)
        launches += 1
    return result, count


def compact_words(plane: torch.Tensor, keep: torch.Tensor):
    """Compact one (n,) 4-byte plane; -> (plane, count)."""
    out, count = compact_planes_info([plane], keep)
    return out[0], count


def compact_bytes(plane: torch.Tensor, keep: torch.Tensor):
    """Compact one (n,) uint8 or bool plane; -> (plane, count)."""
    out, count = compact_planes_info([plane], keep)
    return out[0], count
