"""The TPU micro-probes' questions asked of the card: `run_probes()`.

The JAX package's probes (`scripts/prof_*.py`, P1-P8) timed Pallas kernel
bodies on a TPU to price a copy, a lane roll, each in-tile gather and each
stage of the compaction.  `run_probes` runs their H100 counterparts
(`kernels/probes.py`) at the probes' own shapes and labels and prints one
line per H100 function, led by every probe body it answers:

    P<i> <label>: <ms> (warm <ms>); bound <ms> (<share> of 3.35 TB/s,
    <share> of the measured copy floor); plain <ms>; library <ms or ->;
    err <max |kernel - plain|>; <shape>

A body whose function is the same call on the card as another's (the
u32 and i32 lane gathers, the three pair gathers of P2 and P3, P5's flat
and (n, 2) consumers and P6) shares that call's line.  Times are CUDA
events on the card (`cold_ms`: the median call after an L2 flush, with
the host's launch time hidden; `warm_ms`: back-to-back calls).  Every
line's kernel is held bit for bit to its plain version at the shape it is
timed at; a difference raises.  The bound is the function's bytes (each
input word read once, each output word written once) over 3.35 TB/s; the
second share divides the same bytes by the measured copy floor, the rate
of `stream` copying (16, 8,060,928) words, which `run_probes` times
first.  A lane_roll line also gives its issue bounds
(`lane_roll_issue_ms`).  `plain` is the kernel's plain PyTorch version
and `library` one PyTorch call computing the same function, where there
is one.  A CUDA device is required.

    python -c "from arrowtpu_torch.probes import run_probes; run_probes()"
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, List, Optional

import torch

from .config import resolve_device
from .kernels import _build
from .kernels import probes as kp

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, data sheet
N = 8_060_928  # the probes' plane: 123 tiles x 512 rows x 128 words
ROWS = N // 128  # 62,976 rows of 128 words, or of 256 in the 256-wide probes
N_V3 = 8_000_000  # prof_v3.py's plane; its Pallas grid covered 122 tiles
ROWS_V3 = 122 * kp.TILE_ROWS
FLOOR_PLANES = 16
# Issue rates of an H100 SXM: results a clock an SM at compute capability
# 9.0 (the CUDA C++ Programming Guide's arithmetic instruction throughput
# table), on 132 SMs at the 1,980 MHz boost clock
SM_RESULTS_PER_S = 132 * 1.98e9
SHUFFLES_PER_CLOCK = 32  # warp shuffle
LOGIC_PER_CLOCK = 64  # 32-bit bitwise ops: a select is one LOP3
FLUSH_BYTES = 256 * 2**20  # read between timed calls: 5x the H100's L2
QUEUE_CYCLES = 50_000_000  # the card's wait before timed calls, ~25 ms


_flush_bufs: Dict[torch.device, torch.Tensor] = {}


def _l2_flush(device) -> None:
    """Read FLUSH_BYTES on `device` (a reduction, no host sync): the L2
    then holds clean lines of that buffer, so the next call reads its
    inputs from HBM and evicts no dirty line of an earlier call."""
    buf = _flush_bufs.get(device)
    if buf is None:
        buf = _flush_bufs[device] = torch.zeros(
            FLUSH_BYTES // 4, dtype=torch.int32, device=device)
    buf.max()


def cold_ms(fn: Callable, reps: int) -> float:
    """Median time of one call of fn() with a cold L2: CUDA events around
    each of `reps` calls, each call after an L2 flush (`_l2_flush`), all
    queued on the card behind a wait of QUEUE_CYCLES, so that the host's
    launch time is hidden and the events bracket the card's work alone
    (where fn reads a result back to the host, its wait is included)."""
    fn()
    torch.cuda.synchronize()
    dev = torch.device("cuda", torch.cuda.current_device())
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(QUEUE_CYCLES)
    for start, end in events:
        _l2_flush(dev)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def warm_ms(fn: Callable, reps: int) -> float:
    """Mean time per call of `reps` back-to-back calls of fn(), queued
    behind a wait as in cold_ms: each call finds the L2 as the call before
    left it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _max_abs_err(got, want) -> int:
    """Largest |difference| of two outputs (tensors or tuples of them)."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = 0
    for a, b in zip(got, want):
        if (a is None) != (b is None):
            raise AssertionError("outputs differ in kind")
        if a is not None:
            d = (a.to(torch.int64) - b.to(torch.int64)).abs()
            err = max(err, int(d.max()) if d.numel() else 0)
    return err


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for y in x if y is not None for t in _tensors(y)]


def fresh_call(fn: Callable, like):
    """fn(), after blocks of the sizes of `like` (the expected outputs) were
    taken from the caching allocator, filled with 0x5A bytes and freed: a
    kernel that leaves output words unwritten then shows the pattern, not
    a stale copy of the right answer left by an earlier call."""
    junk = [torch.full((t.nbytes,), 0x5A, dtype=torch.uint8, device=t.device)
            for t in _tensors(like)]
    del junk
    return fn()


class ProbeRun:
    """The lines of one run; `floor_bytes_per_s` is the measured copy
    floor once known."""

    def __init__(self, reps: int = 30, log=print, floor_bytes_per_s=None):
        self.reps, self.log = reps, log
        self.lines: List[Dict] = []
        self.floor_bytes_per_s = floor_bytes_per_s

    def probe(self, pid: str, label: str, kernel: str, fn, plain, nbytes,
              library: Optional[Callable] = None, shape: str = "",
              compare: Callable = None) -> Dict:
        """Time one probe body's counterpart fn() (which must launch
        `kernel`), its plain version and the library call, and hold fn()
        to the plain version: AssertionError unless they agree bit for
        bit.  The launches of the check are not counted."""
        before = kp.launches[kernel]
        fn()
        if kp.launches[kernel] == before:
            raise AssertionError(f"{pid} {label}: {kernel} not launched")
        ms = cold_ms(fn, self.reps)
        warm = warm_ms(fn, self.reps)
        saved = dict(kp.launches)
        want = plain()
        err = (compare or _max_abs_err)(fresh_call(fn, want), want)
        kp.launches.update(saved)
        if err:
            raise AssertionError(f"{pid} {label}: differs from its plain "
                                 f"version by up to {err} at {shape}")
        line = {"id": pid, "label": label, "kernel": kernel, "ms": ms,
                "warm_ms": warm, "plain_ms": cold_ms(plain, self.reps),
                "library_ms": (None if library is None
                               else cold_ms(library, self.reps)),
                "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "max_abs_err": err, "shape": shape}
        if self.floor_bytes_per_s:
            line["floor_ms"] = nbytes / self.floor_bytes_per_s * 1e3
        self.lines.append(line)
        self.log(format_line(line))
        return line


def format_line(line: Dict) -> str:
    lib = line["library_ms"]
    floor = line.get("floor_ms")
    shares = f"{line['bound_ms'] / line['ms']:.0%} of 3.35 TB/s"
    if floor is not None:
        shares += f", {floor / line['ms']:.0%} of the measured copy floor"
    return (f"{line['id']} {line['label']}: {line['ms']:.4f} ms (warm "
            f"{line['warm_ms']:.4f} ms); bound "
            f"{line['bound_ms']:.4f} ms ({shares}); plain "
            f"{line['plain_ms']:.4f} ms; library "
            f"{'-' if lib is None else f'{lib:.4f} ms'}; err "
            f"{line['max_abs_err']}; {line['shape']}")


def _roll_shift(k: int, start: int = 0) -> int:
    """Summed shift of rolls start..k-1, mod 128."""
    return sum(1 + j % 7 for j in range(start, k)) % 128


def lane_roll_issue_ms(rows: int, k: int, nsel: int) -> Dict[str, float]:
    """Issue bounds of lane_roll at (rows, 128): `select_ms`, the
    function's selects (one a word a selected roll) at the card's 32-bit
    logic rate; `shuffle_ms`, the shuffles of lane_roll_kernel's design
    (16 words a lane, 4 rows a warp: s shuffle results a lane for a
    selected roll by s, 16 for the one rotation of the unselected rolls)
    at its shuffle rate."""
    lanes = -(-rows // 4) * 32
    per_lane = (sum(1 + j % 7 for j in range(nsel))
                + (16 if _roll_shift(k, nsel) else 0))
    shuffles = lanes * per_lane
    return {"select_ms": rows * 128 * nsel / LOGIC_PER_CLOCK
            / SM_RESULTS_PER_S * 1e3,
            "shuffle_ms": shuffles / SHUFFLES_PER_CLOCK
            / SM_RESULTS_PER_S * 1e3}


def _stage_bytes(stage: str, P: int, n: int, count: int) -> int:
    """Least bytes of each stage's function: the copy stages read and write
    every word (rank and lookback read the mask too); kept reads the mask
    and the kept words and writes them; full also writes the zero tail."""
    return {"copy": 8 * P * n, "rank": 8 * P * n + n,
            "lookback": 8 * P * n + n, "kept": n + 8 * P * count,
            "full": n + 4 * P * count + 4 * P * n}[stage]


def _stage_compare(stage, count):
    def compare(got, want):
        out, aux = got
        wout, waux = want
        words = count if stage == "kept" else out.shape[1]
        return _max_abs_err((out[:, :words], aux), (wout[:, :words], waux))
    return compare


def compaction_ablation(run: ProbeRun, pid: str, planes, keep,
                        kernels=kp.KERNELS) -> None:
    """Every stage of each kernel on (planes, keep), one line each; the
    full stage beside the library call that computes the compaction
    (`zeros`, then `[:, :count] = planes[:, keep]`)."""
    P, n = planes.shape
    count = int(keep.sum())
    sel = keep.bool()

    def zeros_then_index():
        out = torch.zeros_like(planes)
        out[:, :count] = planes[:, sel]
        return out

    for kernel in kernels:
        for stage in kp.STAGES:
            if (stage, kernel) == ("lookback", "k1"):
                continue
            run.probe(
                pid, f"{kernel.upper()} {stage} P={P}", f"stages_{kernel}",
                lambda: kp.compaction_stages(planes, keep, stage, kernel),
                lambda: kp.compaction_stages_plain(planes, keep, stage,
                                                   kernel),
                _stage_bytes(stage, P, n, count),
                zeros_then_index if stage == "full" else None,
                f"({P}, {n}) u32, kept {count}",
                _stage_compare(stage, count))


def run_probes(device=None, reps: int = 30, log=print) -> Dict:
    """Run P1-P8's counterparts on the card at the probes' shapes; ->
    {"lines": [one dict per probe body], "floor_GBps": the measured copy
    floor, "seconds": wall time}."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    _build.require_cuda(torch.empty(0, device=dev), "run_probes")
    g = torch.Generator(device=dev).manual_seed(0)
    run = ProbeRun(reps, log)

    def issue_bounds(line, rows, k, nsel):
        """A lane_roll line gains its issue bounds beside the bytes'."""
        line.update(lane_roll_issue_ms(rows, k, nsel))
        log(f"  issue bounds: selects {line['select_ms']:.4f} ms, "
            f"shuffles {line['shuffle_ms']:.4f} ms")

    def words(*shape, high=2**31):
        return torch.randint(0, high, shape, dtype=torch.int64, device=dev,
                             generator=g).to(torch.int32)

    def index(*shape, extent):
        return torch.randint(0, extent, shape, dtype=torch.int32, device=dev,
                             generator=g)

    # the copy floor: stream copying 16 planes of N words (1.03 GB moved)
    big = words(FLOOR_PLANES, N)
    floor = run.probe("floor", f"stream copy, {FLOOR_PLANES} planes",
                      "stream", lambda: kp.stream(big),
                      lambda: kp.stream_plain(big), 8 * FLOOR_PLANES * N,
                      big.clone, f"({FLOOR_PLANES}, {N}) u32")
    del big
    run.floor_bytes_per_s = floor["bytes"] / floor["ms"] * 1e3
    floor["floor_ms"] = floor["ms"]
    log(f"copy floor: {run.floor_bytes_per_s / 1e9:.1f} GB/s = "
        f"{run.floor_bytes_per_s / HBM_BYTES_PER_S:.1%} of 3.35 TB/s")

    # P1: scripts/prof_gather.py, (62,976, 128) u32 words
    x = words(ROWS, 128)
    shape = f"({ROWS}, 128) u32"
    run.probe("P1", "copy", "stream", lambda: kp.stream(x.view(1, -1)),
              lambda: kp.stream_plain(x.view(1, -1)), 8 * N, x.clone, shape)
    for k in (7, 14, 28):
        issue_bounds(run.probe(
            "P1", f"{k} lane rolls", "lane_roll",
            lambda: kp.lane_roll(x, k, 0),
            lambda: kp.lane_roll_plain(x, k, 0), 8 * N,
            lambda: torch.roll(x, _roll_shift(k), 1), shape), ROWS, k, 0)
    m = words(ROWS, 128)
    issue_bounds(run.probe(
        "P1", "14 roll+where", "lane_roll",
        lambda: kp.lane_roll(x, 14, 14, m),
        lambda: kp.lane_roll_plain(x, 14, 14, m), 12 * N, None,
        shape + ", mask > 2^30"), ROWS, 14, 14)
    idxl = index(ROWS, 128, extent=128)
    idxl64 = idxl.to(torch.int64)
    xu = x.view(torch.uint32)
    # the u32 and i32 bodies are one function of the same 4-byte words
    run.probe("P1", "lane gather (u32 data; i32 data)", "tile_gather",
              lambda: kp.tile_gather(xu, "lanes", idxl),
              lambda: kp.tile_gather_plain(xu, "lanes", idxl), 12 * N,
              lambda: torch.gather(x, 1, idxl64), shape + ", idx i32")
    t = ROWS // kp.TILE_ROWS
    idxs = index(ROWS, 128, extent=kp.TILE_ROWS)
    idxs64 = idxs.to(torch.int64).view(t, kp.TILE_ROWS, 128)
    run.probe("P1", "sublane gather", "tile_gather",
              lambda: kp.tile_gather(x, "sublanes", idxs),
              lambda: kp.tile_gather_plain(x, "sublanes", idxs), 12 * N,
              lambda: torch.gather(x.view(t, kp.TILE_ROWS, 128), 1, idxs64),
              shape + ", idx i32 in [0, 512)")
    # the table gather reads only row 0 of each tile of x
    for label, pattern, nbytes in (
            ("row-broadcast table gather", "table", 8 * N + 4 * t * 128),
            ("2 chained lane gathers", "chained", 12 * N)):
        run.probe("P1", label, "tile_gather",
                  lambda: kp.tile_gather(x, pattern, idxl),
                  lambda: kp.tile_gather_plain(x, pattern, idxl), nbytes,
                  None, shape + ", idx i32")
    run.probe("P1", "row move (int8 one-hot matmul body; per-byte "
              "4-matmul body)", "tile_gather",
              lambda: kp.tile_gather(x, "rowmove"),
              lambda: kp.tile_gather_plain(x, "rowmove"), 8 * N, None, shape)
    del m, idxs, idxs64

    # P2: scripts/prof_gather256.py, (62,976, 256) i32 words
    x256 = words(ROWS, 256)
    x128 = x256[:, :128].contiguous()
    idx256 = index(ROWS, 256, extent=256)
    idx128 = idx128_pairs = index(ROWS, 128, extent=128)
    shape256 = f"({ROWS}, 256) i32"
    run.probe("P2, P3", "copy 256", "stream",
              lambda: kp.stream(x256.view(1, -1)),
              lambda: kp.stream_plain(x256.view(1, -1)), 16 * N, x256.clone,
              shape256)
    for label, data, idx in (("dyn gather 128", x128, idx128),
                             ("dyn gather 256", x256, idx256)):
        i64 = idx.to(torch.int64)
        run.probe("P2", label, "tile_gather",
                  lambda: kp.tile_gather(data, "lanes", idx),
                  lambda: kp.tile_gather_plain(data, "lanes", idx),
                  12 * data.numel(), lambda: torch.gather(data, 1, i64),
                  f"({ROWS}, {data.shape[1]}) i32")
    pair_idx = idx128_pairs.to(torch.int64)[..., None].expand(ROWS, 128, 2)
    pair_idx = pair_idx.contiguous()
    run.probe("P2, P3", "pair gather (P2 pair gather 256, expand + dyn; "
              "P2 deint + 2x g128 + reint; P3 deint + dyn move + reint)",
              "tile_gather",
              lambda: kp.tile_gather(x256, "pairs", idx128_pairs),
              lambda: kp.tile_gather_plain(x256, "pairs", idx128_pairs),
              16 * N + 4 * N,
              lambda: torch.gather(x256.view(ROWS, 128, 2), 1, pair_idx),
              shape256 + f", idx ({ROWS}, 128) i32")
    del idx256, pair_idx

    # P3: scripts/prof_deint.py (its copy 256 and pair move are above)
    run.probe("P3", "deint + reint (one launch)", "tile_gather",
              lambda: kp.tile_gather(x256, "roundtrip"),
              lambda: kp.tile_gather_plain(x256, "roundtrip"),
              16 * N, x256.clone, shape256 + ", identity")
    del x256, x128, idx128

    # P4: scripts/prof_floor.py, out = x + keep, 50 % mask
    keep = torch.rand(N, device=dev, generator=g) < 0.5
    keep8 = keep.to(torch.uint8)
    for P in (1, 2):
        planes = words(P, N)
        run.probe("P4", f"x + keep, P={P} (BlockSpec and manual-DMA bodies)",
                  "stream", lambda: kp.stream(planes, keep8),
                  lambda: kp.stream_plain(planes, keep8), 8 * P * N + N,
                  lambda: planes + keep8, f"({P}, {N}) u32 + (n,) u8")
    del planes

    # P5 / P6: scripts/prof_pairlayout.py, prof_epi3.py
    pl2 = words(2, ROWS, 128)
    reint = lambda: kp.tile_gather(pl2, "reinterleave")  # noqa: E731
    reint_plain = lambda: kp.tile_gather_plain(pl2, "reinterleave")  # noqa
    stack = lambda: torch.stack([pl2[0], pl2[1]], -1)  # noqa: E731
    shape_p = f"2 x ({ROWS}, 128) u32 -> ({ROWS}, 256)"
    # the (n, 2) view and P6's unused prefetched count add no work on
    # the card: one line answers all three bodies
    run.probe("P5, P6", "reinterleave (P5 flat consume, tiles and (n, 2) "
              "view; P6 behind an unused prefetched count)", "tile_gather",
              reint, reint_plain, 16 * N, stack, shape_p)
    run.probe("P5", "reinterleave, (n,) int64 view, element 0 consumed",
              "tile_gather", lambda: reint().view(torch.int64)[:1].clone(),
              lambda: reint_plain().view(torch.int64)[:1].clone(), 16 * N,
              lambda: stack().view(torch.int64)[:1].clone(),
              shape_p + ", viewed (n,) int64, [0] copied out")
    del pl2

    # P7: scripts/prof_v3.py, one plane of 8M rows as (62,464, 128)
    x7 = words(ROWS_V3, 128, high=1000)
    shape7 = f"({ROWS_V3}, 128) u32, mask x > 7"
    for k, nsel in ((0, 0), (14, 0), (14, 14), (28, 28), (56, 56)):
        issue_bounds(run.probe(
            "P7", f"{k} rolls {nsel} sels", "lane_roll",
            lambda: kp.lane_roll(x7, k, nsel),
            lambda: kp.lane_roll_plain(x7, k, nsel), 8 * x7.numel(),
            (lambda: torch.roll(x7, _roll_shift(k), 1)) if nsel == 0
            else None, shape7), ROWS_V3, k, nsel)
    i7 = index(ROWS_V3, 128, extent=128)
    s7 = index(ROWS_V3, 128, extent=kp.TILE_ROWS)
    t7 = ROWS_V3 // kp.TILE_ROWS
    i7_64, s7_64 = (i.to(torch.int64) for i in (i7, s7))
    run.probe("P7", "lane gather, 1 plane", "tile_gather",
              lambda: kp.tile_gather(x7, "lanes", i7),
              lambda: kp.tile_gather_plain(x7, "lanes", i7), 12 * x7.numel(),
              lambda: torch.gather(x7, 1, i7_64), f"({ROWS_V3}, 128) u32")
    run.probe("P7", "sublane gather, 1 plane", "tile_gather",
              lambda: kp.tile_gather(x7, "sublanes", s7),
              lambda: kp.tile_gather_plain(x7, "sublanes", s7),
              12 * x7.numel(),
              lambda: torch.gather(x7.view(t7, kp.TILE_ROWS, 128), 1,
                                   s7_64.view(t7, kp.TILE_ROWS, 128)),
              f"({ROWS_V3}, 128) u32")
    del x7, i7, s7, i7_64, s7_64
    # P7's K3 ablation: the filter mask gt(col, 0) of an int64 column in
    # [-1000, 1000) with 10 % nulls, P in {1, 2} u32 planes of 8M rows
    vals = torch.randint(-1000, 1000, (N_V3,), device=dev, generator=g)
    valid = torch.rand(N_V3, device=dev, generator=g) > 0.10
    keep7 = valid & (vals > 0)
    planes7 = vals.view(torch.int32).view(N_V3, 2).t().contiguous()
    for P in (1, 2):
        compaction_ablation(run, "P7", planes7[:P], keep7, kernels=("k3",))
    del vals, valid, keep7, planes7

    # P8: scripts/prof_kernel.py, compact v1's stages, 50 % mask
    for P in (1, 2):
        compaction_ablation(run, "P8", words(P, N), keep)

    return {"lines": run.lines,
            "floor_GBps": run.floor_bytes_per_s / 1e9,
            "seconds": time.perf_counter() - t0}
