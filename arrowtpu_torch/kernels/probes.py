"""The probe kernels and the compaction kernels' stage variants, in CUDA.

Counterparts of the TPU micro-probes `scripts/prof_*.py` (P1-P8).  The
kernels are in `csrc/probes.cu` (`stream`, `lane_roll`, `tile_gather`) and,
for `compaction_stages`, the Stage-templated `tile_compact_kernel` of
`csrc/tile_rank.cuh` as K1 launches it (`csrc/compact.cu`, tile offsets
from its count pass and cumsum) and as K3 does (`csrc/compact2.cu`,
look-back), and at 16-byte words `compact16_kernel` (`csrc/compact16.cuh`,
K1's look-back frame) beside `tile_compact_kernel<uint4>` (K1's offs
frame), both with tile offsets.  Each file's header gives the design and
the bound on the card.

  stream(planes, keep=None)        (P, n) 4-byte words: planes + keep[i], or
                                   a copy (P4, and the copies of P1-P3)
  lane_roll(x, k, nsel, mask)      k rolls of each 128-word row, the first
                                   nsel of them selects (P1, P7)
  tile_gather(x, pattern, idx)     the in-tile gathers of P1, P2, P3, P5, P7
                                   (the sublane gather staged in shared
                                   memory; P3's round trip one launch)
  compaction_stages(planes, keep, stage, kernel)
                                   K3 or K1 cut after one of its stages
                                   (P7's K3 ablation, P8; K1's two
                                   16-byte kernels)

Each has a plain PyTorch version beside it (`*_plain`).  A CPU tensor takes
the plain version; a CUDA tensor launches the kernel or raises.
`launches[name]` counts each kernel's launches (`stages_k3` and
`stages_k1` those of compaction_stages, K1's at every word size).  Words
are any 4-byte dtype: sums wrap at 32 bits, comparisons are of the
unsigned words.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

TILE_ROWS = 512  # T: rows of a gather tile, the TPU probes' block
ROW_WORDS = 128  # words of a rolled row
# same numbers as `Pattern` in csrc/probes.cu
PATTERNS = {"lanes": 0, "sublanes": 1, "table": 2, "chained": 3,
            "rowmove": 4, "deinterleave": 5, "reinterleave": 6, "pairs": 7,
            "roundtrip": 8}
# same numbers as `Stage` in csrc/tile_rank.cuh; K1 has no look-back
STAGES = {"copy": 0, "rank": 1, "lookback": 2, "kept": 3, "full": 4}

launches = {"stream": 0, "lane_roll": 0, "tile_gather": 0, "stages_k3": 0,
            "stages_k1": 0}


def _words(t: torch.Tensor, dims: int, what: str) -> torch.Tensor:
    if t.dim() != dims or t.element_size() != 4 or t.is_floating_point():
        raise ValueError(f"{what}: a {dims}-D tensor of 4-byte integer words "
                         f"is needed, got {tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: the tensor must be contiguous")
    return t


def _aligned(*ts) -> None:
    for t in ts:
        if t is not None and t.data_ptr() % 16:
            raise ValueError("tile_gather: tensors must be 16-byte aligned")


def _unsigned(t: torch.Tensor) -> torch.Tensor:
    """4-byte words as int64 values in [0, 2**32)."""
    return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# stream
# ---------------------------------------------------------------------------


def _keep_bytes(keep: torch.Tensor, n: int) -> torch.Tensor:
    if keep.dim() != 1 or keep.shape[0] != n or keep.dtype not in (
            torch.uint8, torch.bool) or not keep.is_contiguous():
        raise ValueError(f"keep must be a contiguous ({n},) uint8 or bool "
                         "tensor")
    return keep


def stream_plain(planes: torch.Tensor, keep: torch.Tensor = None):
    _words(planes, 2, "stream")
    if keep is None:
        return planes.clone()
    _keep_bytes(keep, planes.shape[1])
    out = planes.view(torch.int32) + keep.to(torch.int32)
    return out.view(planes.dtype)


def stream(planes: torch.Tensor, keep: torch.Tensor = None):
    """(P, n) words -> (P, n) words: planes[p, i] + keep[i] (a copy when
    keep is None)."""
    if planes.device.type == "cpu":
        return stream_plain(planes, keep)
    _build.require_cuda(planes, "probes.stream")
    _words(planes, 2, "stream")
    P, n = planes.shape
    if keep is not None:
        _keep_bytes(keep, n)
        if keep.device != planes.device:
            raise ValueError("keep must be on the planes' device")
    out = torch.empty_like(planes)
    if n:
        with torch.cuda.device(planes.device):
            _build._check(_build.library().arrowtpu_stream(
                planes.data_ptr(), out.data_ptr(),
                None if keep is None else keep.data_ptr(), P, n,
                _build._stream(planes)), "stream_kernel")
        launches["stream"] += 1
    return out


# ---------------------------------------------------------------------------
# lane_roll
# ---------------------------------------------------------------------------


def _roll_operands(x, k, nsel, mask):
    _words(x, 2, "lane_roll")
    if x.shape[1] != ROW_WORDS:
        raise ValueError(f"lane_roll: rows of {ROW_WORDS} words, got "
                         f"{tuple(x.shape)}")
    if not 0 <= nsel <= k:
        raise ValueError(f"lane_roll: need 0 <= nsel <= k, got {nsel}, {k}")
    if mask is not None:
        _words(mask, 2, "lane_roll mask")
        if mask.shape != x.shape or mask.device != x.device:
            raise ValueError("lane_roll: mask must match x")


def lane_roll_plain(x: torch.Tensor, k: int, nsel: int,
                    mask: torch.Tensor = None):
    _roll_operands(x, k, nsel, mask)
    m = _unsigned(mask) > 2**30 if mask is not None else _unsigned(x) > 7
    v = x.view(torch.int32)
    for j in range(k):
        y = torch.roll(v, 1 + j % 7, dims=1)
        v = torch.where(m, y, v) if j < nsel else y
    return v.clone().view(x.dtype)


def lane_roll(x: torch.Tensor, k: int, nsel: int, mask: torch.Tensor = None):
    """(rows, 128) words: k rolls of every row, roll j by 1 + j % 7 words in
    np.roll's direction (out[l] = v[(l - s) mod 128]); the first nsel of
    them keep the rolled word only where m holds, m being mask > 2**30, or
    x > 7 of the original x when no mask is given."""
    if x.device.type == "cpu":
        return lane_roll_plain(x, k, nsel, mask)
    _build.require_cuda(x, "probes.lane_roll")
    _roll_operands(x, k, nsel, mask)
    out = torch.empty_like(x)
    if x.shape[0]:
        with torch.cuda.device(x.device):
            _build._check(_build.library().arrowtpu_lane_roll(
                x.data_ptr(), None if mask is None else mask.data_ptr(),
                out.data_ptr(), x.shape[0], k, nsel, _build._stream(x)),
                "lane_roll_kernel")
        launches["lane_roll"] += 1
    return out


# ---------------------------------------------------------------------------
# tile_gather
# ---------------------------------------------------------------------------


def _gather_operands(x, pattern, idx) -> Tuple[int, int]:
    """Check a tile_gather call; -> (rows, W)."""
    if pattern not in PATTERNS:
        raise ValueError(f"tile_gather: unknown pattern {pattern!r}")
    if pattern == "reinterleave":
        _words(x, 3, "tile_gather")
        if x.shape[0] != 2 or x.shape[2] != 128:
            raise ValueError("reinterleave takes (2, rows, 128) planes")
        rows, width = x.shape[1], 256
    else:
        _words(x, 2, "tile_gather")
        rows, width = x.shape
    if width not in (128, 256):
        raise ValueError(f"tile_gather: rows of 128 or 256 words, got {width}")
    if pattern in ("deinterleave", "pairs", "roundtrip") and width != 256:
        raise ValueError(f"{pattern} takes (rows, 256) words: 128 pairs")
    if pattern in ("sublanes", "table", "rowmove") and rows % TILE_ROWS:
        raise ValueError(f"{pattern}: rows must be a multiple of {TILE_ROWS}")
    want = {"lanes": (rows, width), "sublanes": (rows, width),
            "table": (rows, width), "chained": (rows, width),
            "pairs": (rows, 128)}.get(pattern)
    if want is None:
        if idx is not None:
            raise ValueError(f"{pattern} is static and takes no index")
    elif idx is None or idx.dtype != torch.int32 or tuple(idx.shape) != want \
            or not idx.is_contiguous() or idx.device != x.device:
        raise ValueError(f"{pattern} takes a contiguous int32 index of shape "
                         f"{want} on x's device")
    return rows, width


def tile_gather_plain(x: torch.Tensor, pattern: str,
                      idx: torch.Tensor = None):
    rows, W = _gather_operands(x, pattern, idx)
    xi = x.view(torch.int32)
    t = rows // TILE_ROWS
    ii = None if idx is None else idx.to(torch.int64)
    if pattern == "lanes":
        out = torch.gather(xi, 1, ii & (W - 1))
    elif pattern == "sublanes":
        out = torch.gather(xi.view(t, TILE_ROWS, W), 1,
                           (ii & (TILE_ROWS - 1)).view(t, TILE_ROWS, W))
    elif pattern == "table":
        table = xi.view(t, TILE_ROWS, W)[:, :1, :].expand(t, TILE_ROWS, W)
        out = torch.gather(table, 2, (ii & (W - 1)).view(t, TILE_ROWS, W))
    elif pattern == "chained":
        a = torch.gather(xi, 1, ii & (W - 1))
        out = torch.gather(a, 1, (ii ^ 63) & (W - 1))
    elif pattern == "rowmove":
        out = torch.zeros_like(xi).view(t, TILE_ROWS, W)
        out[:, 1:] = xi.view(t, TILE_ROWS, W)[:, :-1]
    elif pattern == "deinterleave":
        out = xi.view(rows, 128, 2).permute(2, 0, 1)
    elif pattern == "reinterleave":
        out = torch.stack([xi[0], xi[1]], dim=-1)
    elif pattern == "roundtrip":
        out = tile_gather_plain(tile_gather_plain(x, "deinterleave"),
                                "reinterleave")
    else:  # pairs
        sel = (ii & 127)[..., None].expand(rows, 128, 2)
        out = torch.gather(xi.view(rows, 128, 2), 1, sel)
    shape = {"deinterleave": (2, rows, 128)}.get(pattern, (rows, W))
    return out.reshape(shape).contiguous().view(x.dtype)


def tile_gather(x: torch.Tensor, pattern: str, idx: torch.Tensor = None):
    """In-tile gathers of (rows, W) words, W in {128, 256}, in tiles of
    TILE_ROWS rows; indices (int32) are taken modulo the extent they index:

      lanes         out[r, l] = x[r, idx[r, l]]
      sublanes      out[r, l] = x[(r // T) T + idx[r, l], l]
      table         out[r, l] = x[(r // T) T, idx[r, l]]
      chained       a = lanes(x, idx); out[r, l] = a[r, idx[r, l] ^ 63]
      rowmove       out[r] = x[r - 1] within a tile; row 0 of a tile is 0
      deinterleave  (rows, 256) pairs -> (2, rows, 128): out[c, r, j] =
                    x[r, 2j + c]
      reinterleave  (2, rows, 128) -> (rows, 256): out[r, 2j + c] = x[c, r, j]
      roundtrip     (rows, 256) -> (rows, 256): deinterleave, then
                    reinterleave (the identity), in one launch
      pairs         (rows, 256) pairs, idx (rows, 128): out pair (r, j) =
                    x pair (r, idx[r, j])"""
    if x.device.type == "cpu":
        return tile_gather_plain(x, pattern, idx)
    _build.require_cuda(x, "probes.tile_gather")
    rows, W = _gather_operands(x, pattern, idx)
    shape = {"deinterleave": (2, rows, 128)}.get(pattern, (rows, W))
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    _aligned(x, idx, out)
    if rows:
        with torch.cuda.device(x.device):
            _build._check(_build.library().arrowtpu_tile_gather(
                PATTERNS[pattern], W, x.data_ptr(),
                None if idx is None else idx.data_ptr(), out.data_ptr(),
                rows, _build._stream(x)), "tile_gather_kernel")
        launches["tile_gather"] += 1
    return out


# ---------------------------------------------------------------------------
# compaction_stages
# ---------------------------------------------------------------------------

KERNELS = ("k3", "k1")
# at 16-byte words ((P, n, 4) int32 planes): compact16_kernel ("k1") and
# tile_compact_kernel<uint4> ("k1_tile"), three stages
KERNELS16 = ("k1", "k1_tile")
STAGES16 = ("rank", "kept", "full")
_BODIES16 = {"k1": 0, "k1_tile": 1}


def _stage_operands(planes, keep, stage, kernel, out_rows=None) -> int:
    """Check a compaction_stages call; -> the word bytes (4 or 16)."""
    if not isinstance(planes, torch.Tensor) or planes.dim() not in (2, 3):
        raise ValueError("compaction_stages takes a (P, n) or (P, n, 4) "
                         "tensor")
    w = planes.element_size() * (planes.shape[2] if planes.dim() == 3
                                 else 1)
    if w == 16:
        if kernel not in KERNELS16 or stage not in STAGES16:
            raise ValueError(f"16-byte words: kernel in {KERNELS16}, stage "
                             f"in {STAGES16}, got {kernel!r}, {stage!r}")
    else:
        if kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}, got "
                             f"{kernel!r}")
        if stage not in STAGES or (kernel == "k1" and stage == "lookback"):
            raise ValueError(f"no stage {stage!r} for {kernel}: K1's "
                             "look-back is its count pass and cumsum")
    if out_rows is not None and w != 16:
        raise ValueError("out_rows is taken at 16-byte words only")
    _build.check_operands(planes, keep, (4, 16))
    _build.out_rows_of(keep, out_rows)
    return w


def compaction_stages_plain(planes: torch.Tensor, keep: torch.Tensor,
                            stage: str, kernel: str = "k3",
                            out_rows: int = None):
    """What each stage of compaction_stages computes:
      copy, rank, lookback   the planes unchanged (at 16-byte words rank
                             writes no plane: None); rank's aux is the kept
                             count of each 4096-row tile, lookback's the
                             tile's exclusive prefix of those counts;
      kept                   the kept words at [0, count) (the kernel
                             leaves the words past the count unwritten;
                             here they are 0);
      full                   the compaction, zero tail included.
    At 16-byte words kept and full write out_rows rows (n by default)."""
    w = _stage_operands(planes, keep, stage, kernel, out_rows)
    aux = None
    if stage in ("copy", "rank", "lookback"):
        out = None if w == 16 else planes.clone()
        if stage != "copy":
            counts = _build.tile_counts_plain(keep)
            aux = counts if stage == "rank" else torch.cumsum(counts, 0) - \
                counts
        return out, aux
    if w == 16:
        from . import compact3 as k1
        return k1.compact_planes_plain(planes, keep, out_rows), None
    from . import compact2 as k3
    return k3.compact_planes_plain(planes, keep), None


def compaction_stages(planes: torch.Tensor, keep: torch.Tensor, stage: str,
                      kernel: str = "k3", out_rows: int = None,
                      offs: torch.Tensor = None
                      ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """K3 (`kernel="k3"`, csrc/compact2.cu) or K1 with tile offsets
    (`kernel="k1"`, csrc/compact.cu, after its count pass and cumsum for
    kept and full) cut after `stage`, on (P, n) 4-byte planes (STAGES; K1
    has no "lookback") or (P, n, 4) int32 planes of 16-byte words
    (STAGES16; "k1" is compact16_kernel, "k1_tile" the tile body at 16-byte
    words) -> (planes, aux): the (P, n) or (P, n, 4)
    output (None for rank at 16-byte words; out_rows rows at 16-byte
    words, n by default), and aux, the per-tile int64 result that keeps the
    rank / lookback work live, else None.  K1's kept and full stages take
    `offs`, the tile offsets, when the caller has them; else they run the
    count pass and cumsum first, as the filter does.  See
    compaction_stages_plain for what each stage computes."""
    if keep.device.type == "cpu":
        return compaction_stages_plain(planes, keep, stage, kernel, out_rows)
    _build.require_cuda(keep, "probes.compaction_stages")
    w = _stage_operands(planes, keep, stage, kernel, out_rows)
    P, n = planes.shape[:2]
    rows = _build.out_rows_of(keep, out_rows)
    out = None if (w, stage) == (16, "rank") else torch.empty(
        (P, rows) + tuple(planes.shape[2:]), dtype=planes.dtype,
        device=planes.device)
    tiles = -(-n // _build.TILE_ROWS)
    aux = torch.empty(max(tiles, 1), dtype=torch.int64, device=keep.device)
    if n == 0:
        return out, (aux[:0] if stage in ("rank", "lookback") else None)
    lib = _build.library()
    code = STAGES[stage]
    if kernel == "k3":
        scratch = _build.lookback_scratch(keep)
    elif code < STAGES["kept"]:
        offs = aux
    elif offs is None:
        offs = _build.tile_offsets(keep)
    else:
        _build._check_offs(offs, keep)
    step = _build.MAX_PLANES
    with torch.cuda.device(keep.device):
        for i in range(0, P, step):
            ins = _build.plane_ptrs(planes[i:i + step])
            # rank at 16-byte words writes no plane: its inputs stand in
            outs = _build.plane_ptrs((planes if out is None else out)
                                     [i:i + step])
            count = min(step, P - i)
            if kernel == "k3":
                err = lib.arrowtpu_compact2_stage(
                    code, keep.data_ptr(), n, count, ins, outs,
                    scratch.data_ptr(), aux.data_ptr(), _build._stream(keep))
            else:
                err = lib.arrowtpu_compact_tiles_stage(
                    code, w, _BODIES16.get(kernel, 0) if w == 16 else 0,
                    keep.data_ptr(), n, offs.data_ptr(), count, ins, outs,
                    rows, aux.data_ptr(), _build._stream(keep))
            _build._check(err, f"{kernel} stage {stage}")
            launches["stages_k3" if kernel == "k3" else "stages_k1"] += 1
    if stage == "rank" or stage == "lookback":
        return out, aux
    return out, None
