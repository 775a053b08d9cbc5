"""Parquet extras: SBBF bloom filters, DELTA / BYTE_STREAM_SPLIT
encodings, the page index (ColumnIndex / OffsetIndex).

Counterpart of `arrowtpu/formats/parquet_ext.py`, the same bytes, after
the reference's
  * parquet/src/bloom_filter/mod.rs: the split-block bloom filter (block
    insert / check :304, hash -> block :321) with XXH64 seed 0 (:465) and
    the thrift BloomFilterHeader framing;
  * parquet/src/encodings/{encoding,decoding}.rs: DELTA_BINARY_PACKED,
    DELTA_LENGTH_BYTE_ARRAY, BYTE_STREAM_SPLIT;
  * file/metadata/column_index.rs + file/page_index/: each page's min /
    max / null count and its location, written between the last row group
    and the footer.

Host code in numpy: XXH64 is vectorized over u64 lanes for fixed-width
values, with a scalar form for byte arrays.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Tuple

import numpy as np

from .. import schema as st
from . import thrift

U64 = np.uint64

# ---------------------------------------------------------------------------
# XXH64 (seed 0) — reference bloom_filter/mod.rs:465 uses twox-hash XXH64
# ---------------------------------------------------------------------------

_P1 = U64(0x9E3779B185EBCA87)
_P2 = U64(0xC2B2AE3D27D4EB4F)
_P3 = U64(0x165667B19E3779F9)
_P4 = U64(0x85EBCA77C2B2AE63)
_P5 = U64(0x27D4EB2F165667C5)


def _rotl(x, r):
    r = U64(r)
    return (x << r) | (x >> (U64(64) - r))


def _avalanche(h):
    h ^= h >> U64(33)
    h *= _P2
    h ^= h >> U64(29)
    h *= _P3
    h ^= h >> U64(32)
    return h


def xxh64_u64(values: np.ndarray) -> np.ndarray:
    """Vectorized XXH64(seed=0) of 8-byte little-endian inputs."""
    with np.errstate(over="ignore"):
        k = values.astype(U64)
        h = _P5 + U64(8)
        k1 = _rotl(k * _P2, 31) * _P1
        h ^= k1
        h = _rotl(h, 27) * _P1 + _P4
        return _avalanche(h)


def xxh64_u32(values: np.ndarray) -> np.ndarray:
    """Vectorized XXH64(seed=0) of 4-byte little-endian inputs."""
    with np.errstate(over="ignore"):
        k = values.astype(np.uint32).astype(U64)
        h = _P5 + U64(4)
        h ^= k * _P1
        h = _rotl(h, 23) * _P2 + _P3
        return _avalanche(h)


def xxh64_bytes(data: bytes) -> int:
    """Scalar XXH64(seed=0) of arbitrary bytes (BYTE_ARRAY values)."""
    n = len(data)
    with np.errstate(over="ignore"):
        if n >= 32:
            v1 = _P1 + _P2
            v2 = _P2
            v3 = U64(0)
            v4 = U64(0) - _P1
            i = 0
            while i + 32 <= n:
                for j, v in enumerate((v1, v2, v3, v4)):
                    (k,) = struct.unpack_from("<Q", data, i + 8 * j)
                    v = _rotl(v + U64(k) * _P2, 31) * _P1
                    if j == 0:
                        v1 = v
                    elif j == 1:
                        v2 = v
                    elif j == 2:
                        v3 = v
                    else:
                        v4 = v
                i += 32
            h = _rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)
            for v in (v1, v2, v3, v4):
                h ^= _rotl(v * _P2, 31) * _P1
                h = h * _P1 + _P4
        else:
            h = _P5
            i = 0
        h += U64(n)
        while i + 8 <= n:
            (k,) = struct.unpack_from("<Q", data, i)
            h ^= _rotl(U64(k) * _P2, 31) * _P1
            h = _rotl(h, 27) * _P1 + _P4
            i += 8
        if i + 4 <= n:
            (k,) = struct.unpack_from("<I", data, i)
            h ^= U64(k) * _P1
            h = _rotl(h, 23) * _P2 + _P3
            i += 4
        while i < n:
            h ^= U64(data[i]) * _P5
            h = _rotl(h, 11) * _P1
            i += 1
        return int(_avalanche(h))


# ---------------------------------------------------------------------------
# SBBF — reference bloom_filter/mod.rs:304 (block ops), :321 (Sbbf)
# ---------------------------------------------------------------------------

_SALT = np.array(
    [0x47B6137B, 0x44974D91, 0x8824AD5B, 0xA2B7289D,
     0x705495C7, 0x2DF1424B, 0x9EFC4947, 0x5C6BFB31],
    dtype=np.uint32,
)


@dataclasses.dataclass
class Sbbf:
    """Split-block bloom filter: blocks of 8 u32 words; one bit set per
    word per value (parquet bloom filter spec; reference mod.rs:304)."""

    words: np.ndarray  # (nblocks, 8) uint32

    @classmethod
    def with_ndv_fpp(cls, ndv: int, fpp: float = 0.01) -> "Sbbf":
        """reference optimal_num_of_bytes/num_of_bits (mod.rs): bits =
        -8n / ln(1 - fpp^(1/8)), rounded up to a power-of-two byte count
        in [32, 128MB]."""
        import math

        bits = -8.0 * max(ndv, 1) / math.log(1.0 - fpp ** 0.125)
        nbytes = 1 << max(5, math.ceil(math.log2(max(bits / 8.0, 32.0))))
        nbytes = min(nbytes, 128 * 1024 * 1024)
        return cls(np.zeros((nbytes // 32, 8), dtype=np.uint32))

    @property
    def num_bytes(self) -> int:
        return self.words.size * 4

    def _block_index(self, h: np.ndarray) -> np.ndarray:
        # mod.rs:321 hash_to_block_index: ((h >> 32) * nblocks) >> 32
        nblocks = U64(self.words.shape[0])
        with np.errstate(over="ignore"):
            return ((h >> U64(32)) * nblocks >> U64(32)).astype(np.int64)

    def _masks(self, h: np.ndarray) -> np.ndarray:
        # block mask: bit (x * SALT[i]) >> 27 in word i (mod.rs:304)
        with np.errstate(over="ignore"):
            x = (h & U64(0xFFFFFFFF)).astype(np.uint32)
            shifts = (x[:, None] * _SALT[None, :]) >> np.uint32(27)
            return (np.uint32(1) << shifts).astype(np.uint32)

    def insert_hashes(self, h: np.ndarray) -> None:
        h = np.atleast_1d(h).astype(U64)
        bi = self._block_index(h)
        masks = self._masks(h)
        np.bitwise_or.at(self.words, (bi[:, None], np.arange(8)[None, :]), masks)

    def check_hashes(self, h: np.ndarray) -> np.ndarray:
        h = np.atleast_1d(h).astype(U64)
        bi = self._block_index(h)
        masks = self._masks(h)
        return ((self.words[bi] & masks) == masks).all(axis=1)

    # -- serialization (BloomFilterHeader + raw bitset) ---------------------
    def to_bytes(self) -> bytes:
        w = thrift.Writer()
        w.struct_begin()
        w.field_i32(1, self.num_bytes)
        for fid in (2, 3, 4):  # algorithm=BLOCK, hash=XXHASH, compression=UNCOMPRESSED
            w.field_struct(fid)
            w.struct_begin()
            w.field_struct(1)
            w.struct_begin()
            w.struct_end()
            w.struct_end()
        w.struct_end()
        return w.bytes() + self.words.astype("<u4").tobytes()

    @classmethod
    def from_buffer(cls, buf, offset: int) -> "Sbbf":
        r = thrift.Reader(buf, offset)
        hdr = r.read_struct()
        nbytes = hdr[1]
        raw = np.frombuffer(buf, dtype="<u4", count=nbytes // 4, offset=r.pos)
        return cls(raw.reshape(-1, 8).copy())


def hash_column_values(vals, phys: int) -> np.ndarray:
    """Hash decoded values per the parquet spec: XXH64 of the plain-encoded
    little-endian bytes (reference mod.rs AsBytes impls)."""
    from .parquet import P_BYTES, P_DOUBLE, P_FLOAT, P_I32, P_I64

    if phys == P_I32:
        return xxh64_u32(np.asarray(vals).astype("<i4").view(np.uint32))
    if phys == P_I64:
        return xxh64_u64(np.asarray(vals).astype("<i8").view(U64))
    if phys == P_FLOAT:
        return xxh64_u32(np.asarray(vals).astype("<f4").view(np.uint32))
    if phys == P_DOUBLE:
        return xxh64_u64(np.asarray(vals).astype("<f8").view(U64))
    if phys == P_BYTES:
        return np.array([xxh64_bytes(bytes(v)) for v in vals], dtype=U64)
    raise st.ArrowTpuError(f"bloom filter: unsupported physical type {phys}")


# ---------------------------------------------------------------------------
# DELTA_BINARY_PACKED — reference encodings/encoding/mod.rs DeltaBitPack
# ---------------------------------------------------------------------------

_BLOCK = 128
_MINIBLOCKS = 4
_MB_VALUES = _BLOCK // _MINIBLOCKS  # 32


def _uvarint(out: bytearray, v: int):
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _zz64(v: int) -> int:
    return ((v << 1) ^ (v >> 63)) & 0xFFFFFFFFFFFFFFFF


def _unzz64(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _read_uvarint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not (b & 0x80):
            return out, pos
        shift += 7


def _pack_bits(vals: np.ndarray, bw: int) -> bytes:
    """LSB-first bit-packing (same layout as RLE bit-packed groups)."""
    if bw == 0:
        return b""
    n = len(vals)
    bits = ((vals[:, None].astype(np.uint64) >> np.arange(bw, dtype=np.uint64))
            & 1).astype(np.uint8)
    flat = bits.reshape(n * bw)
    return np.packbits(flat, bitorder="little").tobytes()


def _unpack_bits(buf: bytes, bw: int, n: int) -> np.ndarray:
    if bw == 0:
        return np.zeros(n, dtype=np.uint64)
    nbytes = (n * bw + 7) // 8
    bits = np.unpackbits(
        np.frombuffer(buf, np.uint8, count=nbytes), bitorder="little"
    )[: n * bw].reshape(n, bw).astype(np.uint64)
    return (bits << np.arange(bw, dtype=np.uint64)).sum(axis=1)


def delta_binary_packed_encode(values: np.ndarray) -> bytes:
    """DELTA_BINARY_PACKED (parquet spec; reference encoding/mod.rs
    DeltaBitPackEncoder): header <block=128><miniblocks=4><count><first
    zigzag>, then per block <min-delta zigzag><4 bitwidth bytes><packed
    miniblocks>."""
    v = np.asarray(values).astype(np.int64)
    n = len(v)
    out = bytearray()
    _uvarint(out, _BLOCK)
    _uvarint(out, _MINIBLOCKS)
    _uvarint(out, n)
    _uvarint(out, _zz64(int(v[0]) if n else 0))
    if n <= 1:
        return bytes(out)
    deltas = np.diff(v)  # may wrap; parquet deltas are mod-2^64 anyway
    for b0 in range(0, len(deltas), _BLOCK):
        blk = deltas[b0 : b0 + _BLOCK]
        mind = int(blk.min())
        _uvarint(out, _zz64(mind))
        adj = (blk.astype(np.int64) - mind).astype(np.uint64)
        nmb = (len(blk) + _MB_VALUES - 1) // _MB_VALUES
        bws = []
        packed = []
        for m in range(_MINIBLOCKS):
            mb = adj[m * _MB_VALUES : (m + 1) * _MB_VALUES]
            if m >= nmb or len(mb) == 0:
                bws.append(0)
                packed.append(b"")
                continue
            mx = int(mb.max())
            bw = mx.bit_length()
            bws.append(bw)
            full = np.zeros(_MB_VALUES, np.uint64)
            full[: len(mb)] = mb
            packed.append(_pack_bits(full, bw))
        out += bytes(bws)
        for m in range(nmb):
            out += packed[m]
    return bytes(out)


def delta_binary_packed_decode(buf: bytes, pos: int = 0,
                               count: Optional[int] = None
                               ) -> Tuple[np.ndarray, int]:
    """Returns (int64 values, end position). reference decoding.rs
    DeltaBitPackDecoder."""
    block, pos = _read_uvarint(buf, pos)
    nmbs, pos = _read_uvarint(buf, pos)
    total, pos = _read_uvarint(buf, pos)
    zz, pos = _read_uvarint(buf, pos)
    first = _unzz64(zz)
    mb_values = block // nmbs if nmbs else 0
    out = np.zeros(total, np.int64)
    if total:
        out[0] = first
    got = 1
    while got < total:
        zz, pos = _read_uvarint(buf, pos)
        mind = _unzz64(zz)
        bws = buf[pos : pos + nmbs]
        pos += nmbs
        for m in range(nmbs):
            if got >= total:
                break
            bw = bws[m]
            vals = _unpack_bits(buf[pos:], bw, mb_values)
            pos += (mb_values * bw + 7) // 8
            take = min(mb_values, total - got)
            with np.errstate(over="ignore"):
                deltas = vals[:take].astype(np.int64) + mind
            out[got : got + take] = deltas
            got += take
    # prefix-sum the deltas (first value already absolute)
    with np.errstate(over="ignore"):
        out = np.cumsum(out.astype(np.uint64), dtype=np.uint64).astype(np.int64)
    return out[: count if count is not None else total], pos


# ---------------------------------------------------------------------------
# DELTA_LENGTH_BYTE_ARRAY — reference encodings DeltaLengthByteArray
# ---------------------------------------------------------------------------


def delta_length_byte_array_encode(values: List[bytes]) -> bytes:
    lens = np.array([len(v) for v in values], np.int64)
    return delta_binary_packed_encode(lens) + b"".join(values)


def delta_length_byte_array_decode(buf: bytes, n: int) -> List[bytes]:
    lens, pos = delta_binary_packed_decode(buf)
    out = []
    for ln in lens[:n]:
        out.append(buf[pos : pos + int(ln)])
        pos += int(ln)
    return out


# ---------------------------------------------------------------------------
# BYTE_STREAM_SPLIT — reference encodings byte_stream_split
# ---------------------------------------------------------------------------


def byte_stream_split_encode(values: np.ndarray) -> bytes:
    """Transpose value bytes into per-byte-position streams."""
    raw = np.ascontiguousarray(values)
    w = raw.dtype.itemsize
    b = raw.view(np.uint8).reshape(-1, w)
    return np.ascontiguousarray(b.T).tobytes()


def byte_stream_split_decode(buf: bytes, npdt, n: int) -> np.ndarray:
    w = np.dtype(npdt).itemsize
    b = np.frombuffer(buf, np.uint8, count=n * w).reshape(w, n)
    return np.ascontiguousarray(b.T).reshape(-1).view(npdt).copy()


# ---------------------------------------------------------------------------
# Page index — ColumnIndex + OffsetIndex (reference file/page_index/,
# file/metadata/column_index.rs)
# ---------------------------------------------------------------------------


def write_column_index(pages) -> bytes:
    """pages: list of dicts {null_page, min (bytes|None), max, null_count}."""
    w = thrift.Writer()
    w.struct_begin()
    w.field_list(1, thrift.CT_TRUE, len(pages))
    for p in pages:
        w.elem_bool(bool(p["null_page"]))
    w.field_list(2, thrift.CT_BINARY, len(pages))
    for p in pages:
        w.elem_binary(p["min"] or b"")
    w.field_list(3, thrift.CT_BINARY, len(pages))
    for p in pages:
        w.elem_binary(p["max"] or b"")
    w.field_i32(4, 0)  # boundary_order UNORDERED
    w.field_list(5, thrift.CT_I64, len(pages))
    for p in pages:
        w.elem_i64(int(p["null_count"]))
    w.struct_end()
    return w.bytes()


def write_offset_index(locations) -> bytes:
    """locations: list of (offset, compressed_page_size, first_row_index)."""
    w = thrift.Writer()
    w.struct_begin()
    w.field_list(1, thrift.CT_STRUCT, len(locations))
    for off, size, first in locations:
        w.struct_begin()
        w.field_i64(1, off)
        w.field_i32(2, size)
        w.field_i64(3, first)
        w.struct_end()
    w.struct_end()
    return w.bytes()


def read_column_index(buf, offset: int, length: int):
    d = thrift.Reader(buf[offset : offset + length]).read_struct()
    return {
        "null_pages": d[1],
        "min_values": [bytes(b) for b in d[2]],
        "max_values": [bytes(b) for b in d[3]],
        "boundary_order": d.get(4, 0),
        "null_counts": d.get(5),
    }


def read_offset_index(buf, offset: int, length: int):
    d = thrift.Reader(buf[offset : offset + length]).read_struct()
    return [(p[1], p[2], p[3]) for p in d[1]]
