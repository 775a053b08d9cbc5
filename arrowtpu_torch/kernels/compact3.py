"""K1: compaction of 4-, 8- and 16-byte planes by one keep mask, in CUDA.

Counterpart of `arrowtpu/pallas/compact3.py` (`compact_planes` ->
`_compact3_call` -> `_compact3_kernel`).  The kernel is
`tile_compact_kernel` (`csrc/tile_rank.cuh`, launched from
`csrc/compact.cu`), instantiated for uint32, uint64 and 16-byte (uint4)
words, so int64 columns move as whole 8-byte words and a row of four
int32 words (a Decimal128, an interval month_day_nano, a string view) as
one 16-byte word, where the JAX package transposes it into four u32
planes; 16-byte words without tile offsets run `compact16_kernel`
(`csrc/compact16.cuh`: no shared staging, a sparse tile's kept words
loaded into registers, more blocks an SM for the look-back's chain).
Their designs and bounds on the card are in those files' headers: at
1.9 % kept a 16-byte compaction is held by its kept words' random 32-byte
sectors.

Contract: (P, n) planes of one dtype and an (n,) uint8 0/1 (or bool) keep
mask -> (P, out_rows) planes whose first `count` words are the kept words
in row order and whose other words are 0.  A word is a plane's element,
or the whole row of an (n, k) plane (`_build.word_bytes`): (P, n, 4) int32
planes are 16-byte words, (P, n, 2) int32 planes 8-byte words.  `out_rows` defaults to n (the
JAX package's contract); a caller that knows the count may ask for fewer
rows, down to the count.  Any n: there are no tile multiples.

A caller that holds `offs = tile_offsets(keep)` (the filter's plan) passes
it and each tile reads its output offset there; without it the tiles find
their offsets by a decoupled look-back inside the one launch (after a
scratch memset), with no count pass and no cumsum.

A CPU tensor takes `compact_planes_plain`, the plain PyTorch version of
the same function; a CUDA tensor launches the kernel or raises.  `launches`
counts the kernel launches.
"""

from __future__ import annotations

import torch

from . import _build

WORD_BYTES = (4, 8, 16)

launches = 0

# Exclusive prefix of the kept counts per tile of TILE_ROWS rows,
# (ceil(n / TILE_ROWS) + 1,) int64; the last entry is the count.  It can be
# shared by every compaction with the same mask.
tile_offsets = _build.tile_offsets


def compact_planes_plain(planes, keep: torch.Tensor, out_rows: int = None):
    """The plain version: boolean indexing into a zero-filled output."""
    plist = _build.check_operands(planes, keep, WORD_BYTES)
    rows = _build.out_rows_of(keep, out_rows)
    result, outs = _build.empty_outputs(planes, plist, rows)
    sel = keep.bool()
    for p, out in zip(plist, outs):
        kept = p[sel]
        out.zero_()
        out[: kept.shape[0]] = kept
    return result


def compact_planes(planes, keep: torch.Tensor, offs: torch.Tensor = None,
                   out_rows: int = None):
    """Compact (P, n) planes (a tensor, or a sequence of (n,) tensors; the
    result takes the same form) of 4-, 8- or 16-byte words by `keep`.  `offs`
    is `tile_offsets(keep)` when the caller already has it."""
    global launches
    if keep.device.type == "cpu":
        return compact_planes_plain(planes, keep, out_rows)
    _build.require_cuda(keep, "compact3.compact_planes")
    plist = _build.check_operands(planes, keep, WORD_BYTES)
    rows = _build.out_rows_of(keep, out_rows)
    result, outs = _build.empty_outputs(planes, plist, rows)
    if keep.shape[0] == 0:
        return result
    scratch = _build.lookback_scratch(keep) if offs is None else None
    step = _build.MAX_PLANES
    for i in range(0, len(plist), step):
        _build.tiles_cuda(plist[i:i + step], outs[i:i + step], keep, offs,
                          scratch)
        launches += 1
    return result
