"""Host-side C++ helpers, compiled with g++ at first use.

Counterpart of `arrowtpu/native`, which the port cannot import (that runs
`arrowtpu/__init__.py`, which pulls in JAX): a copy of each source the
port uses sits in `src/`, and `load(name)` compiles it into
`arrowtpu_torch/_build/` (named by a hash of the source and flags, so an
edited source rebuilds) and loads it with ctypes.  Nothing builds at
import.  A failed build raises `NativeBuildError`: where the JAX package
returns None and its callers fall back, the port's do not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from .. import schema as st

SRC = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_lock = threading.Lock()
_libs: dict = {}


class NativeBuildError(st.ArrowTpuError):
    """A host helper's C++ source did not compile or load."""


def build(name: str) -> Path:
    """Compile `src/<name>.cpp` unless it is built; -> the library."""
    src = SRC / f"{name}.cpp"
    tag = hashlib.sha256(" ".join(CXX_FLAGS).encode() + src.read_bytes())
    out = BUILD_DIR / f"{name}_{tag.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(src)],
                       check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        detail = getattr(e, "stderr", b"") or b""
        raise NativeBuildError(f"g++ could not build {src.name}: {e} "
                               f"{detail.decode(errors='replace')}") from e
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built at its first use."""
    with _lock:
        if name not in _libs:
            path = build(name)
            try:
                _libs[name] = ctypes.CDLL(str(path))
            except OSError as e:
                raise NativeBuildError(f"cannot load {path}: {e}") from e
        return _libs[name]


def lz4_compress_block(data: bytes):
    """One LZ4 block by the greedy matcher of `src/lz4block.cpp`; None
    when the block would not fit its worst-case bound (the caller then
    stores it uncompressed)."""
    fn = load("lz4block").arrowtpu_lz4_compress_block
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                   ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    n = len(data)
    cap = n + n // 255 + 16
    dst = (ctypes.c_uint8 * cap)()
    rc = fn(bytes(data), n, dst, cap)
    if rc < 0:
        return None
    return bytes(dst[:rc])


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def avro_decode_block(body: bytes, nrows: int, fdesc, arena_cap: int):
    """One flat-record Avro block by `src/avroblock.cpp`.

    fdesc: int32 (nfields, 4) [type, nullable, null_branch, fixed_size].
    -> (vals int64 (nrows, nf), lens int64, valid uint8, arena bytes,
    consumed, views uint32 (nrows, nf, 4)); raises ValueError on a
    malformed block.  An arena that would overflow retries larger."""
    fn = load("avroblock").arrowtpu_avro_decode_block
    fn.restype = ctypes.c_int64
    nf = fdesc.shape[0]
    fd = np.ascontiguousarray(fdesc, np.int32)
    while True:
        vals = np.zeros((nrows, nf), np.int64)
        lens = np.zeros((nrows, nf), np.int64)
        valid = np.zeros((nrows, nf), np.uint8)
        views = np.zeros((nrows, nf, 4), np.uint32)
        arena = np.zeros(max(arena_cap, 1), np.uint8)
        used = ctypes.c_int64(0)
        rc = fn(body, ctypes.c_int64(len(body)), ctypes.c_int64(nrows),
                _ptr(fd, ctypes.c_int32), ctypes.c_int32(nf),
                _ptr(vals, ctypes.c_int64), _ptr(lens, ctypes.c_int64),
                _ptr(valid, ctypes.c_uint8), _ptr(arena, ctypes.c_uint8),
                ctypes.c_int64(arena.size), ctypes.byref(used),
                _ptr(views, ctypes.c_uint32))
        if rc != -2:
            break
        arena_cap = arena_cap * 2 + 1024
    if rc < 0:
        raise ValueError("avro: malformed block (native decoder)")
    return vals, lens, valid, arena[:used.value], rc, views


def avro_decode_nested(body: bytes, nrows: int, desc, child_idx,
                       arena_cap: int, cap_mult: int = 2):
    """One nested-record Avro block by `src/avronest.cpp`.

    desc: int32 (nnodes, 7) node table; child_idx: the flat int32 child
    index table (the source's header).  -> (a dict a node with 'vals',
    'views', 'valid', 'lens', 'count'; arena bytes; consumed); raises
    ValueError on a malformed block.  Buffers that would overflow retry
    at twice their size."""
    fn = load("avronest").arrowtpu_avro_decode_nested
    fn.restype = ctypes.c_int64
    nn = desc.shape[0]
    d = np.ascontiguousarray(desc, np.int32)
    ci = np.ascontiguousarray(child_idx, np.int32)
    caps = np.full(nn, max(nrows, 1) * cap_mult // 2 + 16, np.int64)
    caps[0] = max(nrows, 1)
    arena_sz = max(arena_cap, 1) * cap_mult // 2 + 1024

    def pointers(arrs):
        return (ctypes.c_void_p * nn)(*[a.ctypes.data for a in arrs])

    while True:
        vals = [np.zeros(int(c), np.int64) for c in caps]
        views = [np.zeros((int(c), 4), np.uint32) for c in caps]
        valid = [np.zeros(int(c), np.uint8) for c in caps]
        lens = [np.zeros(int(c), np.int32) for c in caps]
        counts = np.zeros(nn, np.int64)
        arena = np.zeros(arena_sz, np.uint8)
        used = ctypes.c_int64(0)
        rc = fn(body, ctypes.c_int64(len(body)), ctypes.c_int64(nrows),
                _ptr(d, ctypes.c_int32), ctypes.c_int32(nn),
                _ptr(ci, ctypes.c_int32), pointers(vals), pointers(views),
                pointers(valid), pointers(lens),
                _ptr(counts, ctypes.c_int64), _ptr(caps, ctypes.c_int64),
                _ptr(arena, ctypes.c_uint8), ctypes.c_int64(arena.size),
                ctypes.byref(used))
        if rc != -2:
            break
        caps = caps * 2
        arena_sz *= 2
    if rc < 0:
        raise ValueError("avro: malformed block (native nested decoder)")
    out = []
    for i in range(nn):
        c = int(counts[i])
        out.append({"vals": vals[i][:c], "views": views[i][:c],
                    "valid": valid[i][:c].astype(bool),
                    "lens": lens[i][:c], "count": c})
    return out, arena[:used.value], rc
