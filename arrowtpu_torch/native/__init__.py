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
