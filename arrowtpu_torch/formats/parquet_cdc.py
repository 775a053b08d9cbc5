"""Parquet content-defined chunking (CDC) page boundaries.

Counterpart of `arrowtpu/formats/parquet_cdc.py`, the same boundaries,
after the reference's parquet/src/column/chunker/cdc.rs:88
`ContentDefinedChunker` (FastCDC gearhash with a min-size skip window,
8-consecutive-match CLT normalization and a max-size cap) behind
WriterProperties.cdc_options (file/properties.rs CdcOptions).  The
boundaries depend only on the data, so inserting or editing a row
re-chunks only the pages it touches.

The per-byte rolling hash runs in C++: `native/src/cdchunk.cpp`, a copy of
the JAX package's, built with g++ at its first use.  Where the JAX package
falls back to Python without a compiler, a failed build raises
`native.NativeBuildError` here.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .. import schema as st

NUM_TABLES = 8


@dataclasses.dataclass(frozen=True)
class CdcOptions:
    """reference file/properties.rs CdcOptions."""

    min_chunk_size: int = 256 * 1024
    max_chunk_size: int = 1024 * 1024
    norm_level: int = 0


def calculate_mask(min_chunk_size: int, max_chunk_size: int,
                   norm_level: int) -> int:
    """cdc.rs calculate_mask: top-bits mask sized so chunk sizes
    approximate a normal distribution between min and max."""
    if min_chunk_size < 0:
        raise st.ArrowTpuError("cdc: min_chunk_size must be non-negative")
    if max_chunk_size <= min_chunk_size:
        raise st.ArrowTpuError("cdc: max_chunk_size must exceed min")
    avg = (min_chunk_size + max_chunk_size) // 2
    target = (avg - min_chunk_size) // NUM_TABLES
    mask_bits = target.bit_length() - 1 if target > 0 else 0
    effective = mask_bits - norm_level
    if not 1 <= effective <= 63:
        raise st.ArrowTpuError(
            f"cdc: mask bits must be in 1..63, got {effective}")
    return (0xFFFFFFFFFFFFFFFF << (64 - effective)) & 0xFFFFFFFFFFFFFFFF


def _cdc_lib() -> ctypes.CDLL:
    from .. import native

    lib = native.load("cdchunk")
    lib.arrowtpu_cdc_tables.restype = None
    lib.arrowtpu_cdc_tables.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
    lib.arrowtpu_cdc_boundaries.restype = None
    lib.arrowtpu_cdc_boundaries.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)]
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def gear_tables() -> np.ndarray:
    """(NUM_TABLES, 256) u64 gear tables, from the native generator (a
    fixed splitmix64 seed, so boundaries are stable across processes)."""
    out = np.empty(NUM_TABLES * 256, np.uint64)
    _cdc_lib().arrowtpu_cdc_tables(_ptr(out, ctypes.c_uint64))
    return out.reshape(NUM_TABLES, 256)


def row_boundaries(data: bytes, row_off: np.ndarray,
                   levels: Optional[np.ndarray],
                   options: CdcOptions) -> np.ndarray:
    """Per-row bool: a new chunk starts AFTER this row.  `data` is the
    rows' value bytes back to back, `row_off` its (nrows + 1) offsets,
    `levels` the rows' def levels or None."""
    mask = calculate_mask(options.min_chunk_size, options.max_chunk_size,
                          options.norm_level)
    nrows = len(row_off) - 1
    out = np.zeros(nrows, np.uint8)
    lib = _cdc_lib()
    tables = np.ascontiguousarray(gear_tables())
    ro = np.ascontiguousarray(row_off, np.int64)
    lv = (np.ascontiguousarray(levels, np.uint8) if levels is not None
          else np.zeros(1, np.uint8))
    lib.arrowtpu_cdc_boundaries(
        data, _ptr(ro, ctypes.c_int64), nrows, _ptr(lv, ctypes.c_uint8),
        1 if levels is not None else 0, _ptr(tables, ctypes.c_uint64), mask,
        options.min_chunk_size, options.max_chunk_size,
        _ptr(out, ctypes.c_uint8))
    return out.astype(bool)


def page_slices(vals, valid: np.ndarray, phys: int, nullable: bool,
                options: CdcOptions, n: int) -> List[Tuple[int, int]]:
    """Content-defined (r0, r1) page slices for one column chunk.
    `vals` is the writer's dense value representation: an ndarray for
    fixed-width physicals, or (starts, lens, data) for BYTE_ARRAY."""
    if n == 0:
        return [(0, 0)]
    valid = np.asarray(valid[:n], bool)
    if isinstance(vals, tuple):  # byte-array: (starts, lens, data) DENSE
        starts, lens, data = vals
        lens = np.asarray(lens, np.int64)
        starts = np.asarray(starts, np.int64)
        row_lens = np.zeros(n, np.int64)
        row_lens[valid] = lens  # null rows contribute zero value bytes
        row_off = np.zeros(n + 1, np.int64)
        np.cumsum(row_lens, out=row_off[1:])
        total = int(row_off[-1])
        if total:
            data = np.asarray(data, np.uint8)
            dense_off = np.zeros(len(lens) + 1, np.int64)
            np.cumsum(lens, out=dense_off[1:])
            idx = (np.arange(total, dtype=np.int64)
                   - np.repeat(dense_off[:-1], lens)
                   + np.repeat(starts, lens))
            buf = data[idx].tobytes()
        else:
            buf = b""
    else:
        # fixed-width DENSE values: null rows contribute zero bytes
        arr = np.ascontiguousarray(vals)
        width = arr.dtype.itemsize if arr.ndim == 1 else (
            arr.dtype.itemsize * arr.shape[1])
        row_lens = np.where(valid, np.int64(width), np.int64(0))
        row_off = np.zeros(n + 1, np.int64)
        np.cumsum(row_lens, out=row_off[1:])
        buf = arr.tobytes()
    levels = valid[:n].astype(np.uint8) if nullable else None
    marks = row_boundaries(buf, row_off, levels, options)
    cuts = np.flatnonzero(marks) + 1
    edges = [0] + [int(c) for c in cuts if c < n] + [n]
    return list(zip(edges[:-1], edges[1:]))
