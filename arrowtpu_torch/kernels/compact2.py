"""K3: single-pass compaction of u32 planes, in CUDA.

Counterpart of `arrowtpu/pallas/compact2.py` (`compact_planes` ->
`_compact2_call` -> `_compact2_kernel`).  The kernel is
`tile_compact_kernel` (`csrc/tile_rank.cuh`, launched from
`csrc/compact2.cu`) in its look-back frame: one pass, with the output
offset carried from tile to tile by a decoupled look-back instead of a
count pass and a prefix sum.  Its design and its bound on the card are in
those files' headers.

Contract, as in the JAX package: (P, n) planes of 4-byte words (a tensor,
or a sequence of (n,) tensors; the result takes the same form) and an
(n,) uint8 0/1 (or bool) keep mask -> (P, n) planes whose first `count`
words are the kept words in row order and whose other words are 0.  The
count is not returned.  Any n; more than 16 planes take one launch per 16,
sharing the mask, as the JAX entry point splits wide stacks.

A CPU tensor takes `compact_planes_plain`, the plain PyTorch version; a
CUDA tensor launches the kernel or raises.  `launches` counts the kernel
launches.
"""

from __future__ import annotations

import torch

from . import _build

WORD_BYTES = (4,)

launches = 0


def compact_planes_plain(planes, keep: torch.Tensor):
    """The plain version: boolean indexing into a zero-filled output (the
    words as int32, so any 4-byte dtype takes it)."""
    plist = _build.check_operands(planes, keep, WORD_BYTES)
    result, outs = _build.empty_outputs(planes, plist, keep.shape[0])
    sel = keep.bool()
    for p, out in zip(plist, outs):
        words = out.view(torch.int32)
        kept = p.view(torch.int32)[sel]
        words.zero_()
        words[: kept.shape[0]] = kept
    return result


def compact_planes(planes, keep: torch.Tensor):
    """Compact (P, n) 4-byte planes by `keep`; -> (P, n) planes."""
    global launches
    if keep.device.type == "cpu":
        return compact_planes_plain(planes, keep)
    _build.require_cuda(keep, "compact2.compact_planes")
    plist = _build.check_operands(planes, keep, WORD_BYTES)
    result, outs = _build.empty_outputs(planes, plist, keep.shape[0])
    if keep.shape[0] == 0:
        return result
    scratch = _build.lookback_scratch(keep)
    step = _build.MAX_PLANES
    for i in range(0, len(plist), step):
        _build.compact2_cuda(plist[i:i + step], outs[i:i + step], keep,
                             scratch)
        launches += 1
    return result
