"""Build, load and call the CUDA kernels of `csrc/`.

`nvcc` compiles every `csrc/*.cu` source (one nvcc process each, all
started together) and links them into one shared library with a plain C
interface under `arrowtpu_torch/_build/`, named by a hash of every source,
header and flag, so an edited file rebuilds; `ctypes` loads it.  Nothing
here runs at import: the package imports on a machine with no CUDA
toolkit, and only a launch on a CUDA tensor builds, and raises if the
build fails.  The second half holds what the kernel wrappers share:
operand checks, output allocation, host arrays of plane pointers, and the
compaction calls into the library on PyTorch's current stream, each
checked for a CUDA error (kernels/probes.py and kernels/dense_agg.py make
their own calls, checked the same way).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> tuple[Path, float, str]:
    """Compile the library if it is not built yet.  Returns (path, seconds
    spent compiling, compiler output); the compile runs with `-Xptxas -v`,
    which reports each kernel's registers, spills and shared memory, and
    its output is kept beside the library, so a cached build returns it
    too."""
    tag = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        tag.update(f.name.encode() + f.read_bytes())
    lib = BUILD_DIR / f"libcompact_{tag.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if lib.exists() and log.exists():
        return lib, 0.0, log.read_text()
    flags = NVCC_FLAGS + ["-Xptxas", "-v"]
    BUILD_DIR.mkdir(exist_ok=True)
    srcs = sorted(CSRC.glob("*.cu"))
    tmp = BUILD_DIR / f"{lib.stem}.{os.getpid()}.tmp"
    objs = [tmp.with_suffix(f".{src.stem}.o") for src in srcs]
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen([_nvcc(), *flags, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(srcs, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        for src, proc, out in zip(srcs, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        link = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o",
                               str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link:\n{link.stderr}")
        log.write_text("".join(logs))
        os.replace(tmp, lib)
    finally:
        for f in (tmp, *objs):
            f.unlink(missing_ok=True)
    return lib, time.perf_counter() - t0, log.read_text()


@functools.cache
def library() -> ctypes.CDLL:
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.arrowtpu_compact_tile_rows.argtypes = []
    lib.arrowtpu_compact_tile_rows.restype = i32
    lib.arrowtpu_compact_max_planes.argtypes = []
    lib.arrowtpu_compact_max_planes.restype = i32
    lib.arrowtpu_cuda_error_string.argtypes = [i32]
    lib.arrowtpu_cuda_error_string.restype = ctypes.c_char_p
    lib.arrowtpu_tile_counts.argtypes = [vp, i64, vp, vp]
    lib.arrowtpu_tile_counts.restype = i32
    lib.arrowtpu_compact_tiles.argtypes = [
        i32, vp, i64, vp, i32, ctypes.POINTER(vp), ctypes.POINTER(vp), i64,
        vp, vp, vp]
    lib.arrowtpu_compact_tiles.restype = i32
    lib.arrowtpu_compact2.argtypes = [vp, i64, i32, ctypes.POINTER(vp),
                                      ctypes.POINTER(vp), vp, vp]
    lib.arrowtpu_compact2.restype = i32
    lib.arrowtpu_compact2_stage.argtypes = [
        i32, vp, i64, i32, ctypes.POINTER(vp), ctypes.POINTER(vp), vp, vp, vp]
    lib.arrowtpu_compact2_stage.restype = i32
    lib.arrowtpu_compact_tiles_stage.argtypes = [
        i32, i32, i32, vp, i64, vp, i32, ctypes.POINTER(vp),
        ctypes.POINTER(vp), i64, vp, vp]
    lib.arrowtpu_compact_tiles_stage.restype = i32
    lib.arrowtpu_stream.argtypes = [vp, vp, vp, i64, i64, vp]
    lib.arrowtpu_stream.restype = i32
    lib.arrowtpu_lane_roll.argtypes = [vp, vp, vp, i64, i32, i32, vp]
    lib.arrowtpu_lane_roll.restype = i32
    lib.arrowtpu_tile_gather.argtypes = [i32, i32, vp, vp, vp, i64, vp]
    lib.arrowtpu_tile_gather.restype = i32
    lib.arrowtpu_dense_agg.argtypes = [
        i32, vp, vp, vp, i32, i32, i64, i32, ctypes.POINTER(vp),
        ctypes.POINTER(vp), ctypes.POINTER(i32), vp, vp, vp]
    lib.arrowtpu_dense_agg.restype = i32
    for fn in (lib.arrowtpu_dense_agg_max_cols,
               lib.arrowtpu_dense_agg_max_buckets,
               lib.arrowtpu_dense_agg_acc_words):
        fn.argtypes, fn.restype = [], i32
    if (lib.arrowtpu_compact_tile_rows(), lib.arrowtpu_compact_max_planes()) \
            != (TILE_ROWS, MAX_PLANES):
        raise RuntimeError(f"{path.name}: tile or plane limit differs from "
                           "TILE_ROWS / MAX_PLANES")
    from . import dense_agg
    if (lib.arrowtpu_dense_agg_max_cols(),
            lib.arrowtpu_dense_agg_max_buckets()) \
            != (dense_agg.MAX_COLS, dense_agg.MAX_BUCKETS):
        raise RuntimeError(f"{path.name}: column or bucket limit differs "
                           "from dense_agg.MAX_COLS / MAX_BUCKETS")
    return lib


def _check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().arrowtpu_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


# ---------------------------------------------------------------------------
# the compaction kernels' C entry points (csrc/compact.cu, compact2.cu)
# ---------------------------------------------------------------------------

TILE_ROWS = 4096   # rows per block of every kernel (kTile, tile_rank.cuh)
MAX_PLANES = 16    # planes per launch (kMaxPlanes)

count_launches = 0  # launches of tile_counts_kernel (tile_offsets)


def word_bytes(plane: torch.Tensor) -> int:
    """The bytes of one word of a plane: its element size for an (n,)
    plane, the whole row for an (n, k) one (a (n, 4) int32 plane is one
    16-byte word a row)."""
    return plane.element_size() * (plane.shape[1] if plane.dim() == 2 else 1)


def check_operands(planes, keep: torch.Tensor, word_sizes) -> list:
    """Validate a compaction call; returns the planes as a list of (n,) or
    (n, k) tensors.  `planes` is a (P, n) or (P, n, k) tensor or a sequence
    of (n,) or (n, k) tensors of one dtype and shape, whose word
    (`word_bytes`) is one of `word_sizes`; 16-byte words on the card must
    be 16-byte aligned; `keep` is (n,) uint8 0/1 or bool, on the same
    device."""
    if keep.dim() != 1 or keep.dtype not in (torch.uint8, torch.bool):
        raise ValueError("keep must be a 1-D uint8 0/1 or bool tensor")
    if not keep.is_contiguous():
        raise ValueError("keep must be contiguous")
    plist = list(planes.unbind(0)) if isinstance(planes, torch.Tensor) \
        else list(planes)
    if not plist:
        raise ValueError("no planes to compact")
    first = plist[0]
    for p in plist:
        if p.dim() not in (1, 2) or p.shape[0] != keep.shape[0]:
            raise ValueError(f"plane of shape {tuple(p.shape)} does not "
                             f"match keep of shape {tuple(keep.shape)}")
        if p.dtype != first.dtype or p.shape != first.shape \
                or p.device != keep.device:
            raise ValueError("planes must share one dtype, one shape and "
                             "keep's device")
        if not p.is_contiguous():
            raise ValueError("planes must be contiguous")
    w = word_bytes(first)
    if w not in word_sizes:
        raise ValueError(f"{w}-byte words ({first.dtype}, "
                         f"{tuple(first.shape[1:])}): this kernel moves "
                         f"{word_sizes}-byte words")
    if w == 16 and keep.device.type == "cuda" and any(
            p.data_ptr() % 16 for p in plist):
        raise ValueError("16-byte words must be 16-byte aligned")
    return plist


def require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {t.device} are not supported")


def tile_counts_plain(keep: torch.Tensor) -> torch.Tensor:
    """(ceil(n / TILE_ROWS),) int64: the kept rows of each tile, in
    plain PyTorch on keep's device."""
    n = keep.shape[0]
    padded = torch.zeros(-(-n // TILE_ROWS) * TILE_ROWS, dtype=torch.int64,
                         device=keep.device)
    padded[:n] = keep != 0
    return padded.view(-1, TILE_ROWS).sum(1)


def tile_offsets(keep: torch.Tensor) -> torch.Tensor:
    """(ceil(n / TILE_ROWS) + 1,) int64 exclusive prefix of the per-tile
    kept counts; the last entry is the count.  On the card: the count
    kernel, then a cumsum over the tile counts; on the CPU its plain
    version."""
    global count_launches
    n = keep.shape[0]
    nt = -(-n // TILE_ROWS)
    offs = torch.zeros(nt + 1, dtype=torch.int64, device=keep.device)
    if keep.device.type == "cpu":
        torch.cumsum(tile_counts_plain(keep), 0, out=offs[1:])
        return offs
    require_cuda(keep, "tile_offsets")
    if n == 0:
        return offs
    counts = torch.empty(nt, dtype=torch.int64, device=keep.device)
    with torch.cuda.device(keep.device):
        _check(library().arrowtpu_tile_counts(
            keep.data_ptr(), n, counts.data_ptr(), _stream(keep)),
            "tile_counts_kernel")
    count_launches += 1
    torch.cumsum(counts, 0, out=offs[1:])
    return offs


def empty_outputs(planes, plist, out_rows):
    """Outputs of `out_rows` words per plane, shaped like the input: a
    (P, out_rows) (or (P, out_rows, k)) tensor for a tensor, else a list.  -> (what the wrapper
    returns, the list of (out_rows,) output planes)."""
    like = plist[0]
    row = (out_rows,) + tuple(like.shape[1:])
    if isinstance(planes, torch.Tensor):
        out = torch.empty((len(plist),) + row, dtype=like.dtype,
                          device=like.device)
        return out, list(out.unbind(0))
    outs = [torch.empty(row, dtype=like.dtype, device=like.device)
            for _ in plist]
    return outs, outs


def out_rows_of(keep: torch.Tensor, out_rows) -> int:
    """The output length: n by default, else between 0 and n.  The caller
    promises it is at least the count (the plain version raises if not; the
    kernel would drop the kept words past it)."""
    n = keep.shape[0]
    if out_rows is None:
        return n
    if not 0 <= out_rows <= n:
        raise ValueError(f"out_rows {out_rows} outside [0, {n}]")
    return int(out_rows)


def _check_offs(offs: torch.Tensor, keep: torch.Tensor) -> None:
    if offs.dtype != torch.int64 or offs.device != keep.device \
            or offs.shape[0] != -(-keep.shape[0] // TILE_ROWS) + 1:
        raise ValueError("offs must be the int64 tile offsets of keep")


def _check_scratch(scratch: torch.Tensor, keep: torch.Tensor) -> None:
    if scratch.dtype != torch.int64 or scratch.device != keep.device \
            or scratch.numel() < -(-keep.shape[0] // TILE_ROWS):
        raise ValueError("scratch must be lookback_scratch(keep)")


def _check_launch(plist, outs) -> None:
    P = len(plist)
    if not 1 <= P <= MAX_PLANES or len(outs) != P:
        raise ValueError(f"{P} planes for {len(outs)} outputs")


def lookback_scratch(keep: torch.Tensor) -> torch.Tensor:
    """Device scratch of one look-back launch of tile_compact_kernel: a
    status word per tile (zeroed by the C entry point before every launch,
    so one scratch serves launches in turn)."""
    tiles = -(-keep.shape[0] // TILE_ROWS)
    return torch.empty(tiles, dtype=torch.int64, device=keep.device)


def tiles_cuda(plist, outs, keep: torch.Tensor, offs, scratch,
               count: torch.Tensor = None) -> None:
    """One tile_compact_kernel launch for K1 or K2 (csrc/compact.cu): up to
    MAX_PLANES (n,) planes of 1-, 4-, 8- or 16-byte words (a 16-byte
    word is a row of an (n, 4) int32 plane) into the out_rows-row planes of
    `outs`, written in full, zero tail included.  Given `offs` (the tile
    offsets) a tile reads its offset there; with offs None the tiles look
    back, in `scratch` (lookback_scratch(keep)), and the last one writes
    the count to `count` (a 0-d int64 tensor) when it is given."""
    if offs is None:
        _check_scratch(scratch, keep)
    else:
        _check_offs(offs, keep)
    _check_launch(plist, outs)
    if count is not None and (count.dtype != torch.int64 or count.numel() != 1
                              or count.device != keep.device):
        raise ValueError("count must be one int64 on keep's device")
    with torch.cuda.device(keep.device):
        _check(library().arrowtpu_compact_tiles(
            word_bytes(plist[0]), keep.data_ptr(), keep.shape[0],
            None if offs is None else offs.data_ptr(), len(plist),
            plane_ptrs(plist), plane_ptrs(outs), outs[0].shape[0],
            None if offs is not None else scratch.data_ptr(),
            None if count is None else count.data_ptr(), _stream(keep)),
            "tile_compact_kernel")


# the wrappers that launch tile_compact_kernel through tiles_cuda
_KERNEL_OF_CALLER = {f"{__package__}.compact3": "K1",
                     f"{__package__}.compact": "K2"}


@contextlib.contextmanager
def launch_words():
    """While active, each tiles_cuda launch is recorded as (kernel, word
    bytes): kernel "K1" or "K2" by the wrapper that made it, else the
    calling module's name.  Yields the list."""
    global tiles_cuda
    seen, real = [], tiles_cuda

    def recorded(plist, *args, **kw):
        caller = sys._getframe(1).f_globals.get("__name__", "")
        seen.append((_KERNEL_OF_CALLER.get(caller, caller),
                     word_bytes(plist[0])))
        return real(plist, *args, **kw)

    tiles_cuda = recorded
    try:
        yield seen
    finally:
        tiles_cuda = real


def compact2_cuda(plist, outs, keep: torch.Tensor,
                  scratch: torch.Tensor) -> None:
    """One tile_compact_kernel launch for K3 (csrc/compact2.cu): up to
    MAX_PLANES (n,) 4-byte planes into (n,) outputs, written in full, zero
    tail included, looking back in `scratch` (lookback_scratch(keep))."""
    _check_launch(plist, outs)
    if any(o.shape[0] != keep.shape[0] for o in outs):
        raise ValueError("compact2 writes outputs of n rows")
    _check_scratch(scratch, keep)
    with torch.cuda.device(keep.device):
        _check(library().arrowtpu_compact2(
            keep.data_ptr(), keep.shape[0], len(plist), plane_ptrs(plist),
            plane_ptrs(outs), scratch.data_ptr(), _stream(keep)),
            "tile_compact_kernel (K3)")


def plane_ptrs(tensors) -> ctypes.Array:
    """A host array of the tensors' device pointers (null for None)."""
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
