"""LZ4 Frame codec, implemented from the spec (LZ4 Frame Format v1.6.1
and the LZ4 Block Format).

Counterpart of `arrowtpu/formats/lz4.py`, the same bytes; arrow-rs's
LZ4_FRAME IPC compression wraps the lz4_flex crate
(arrow-ipc/src/compression.rs:142 CompressionCodec::Lz4Frame).

  * `decompress` parses frames of any producer (pyarrow, arrow-rs): the
    frame descriptor (an optional content size and checksums are
    skipped), block-independent and block-linked data blocks (FLG bit 5
    clear: matches may reach into earlier blocks' output), and the block
    sequences (token, extended lengths, overlapping match copies).  Pure
    Python: keep it to a few MB.
  * `compress` emits compressed blocks through the greedy hash-table
    matcher of `native/src/lz4block.cpp` (a copy of the JAX package's),
    built with g++ at first use.  A block that does not shrink is stored
    uncompressed (high-bit block size).  Where the JAX package stores
    every block so when its build fails, the port raises.
  * `xxh32` for the frame descriptor's header checksum.
"""

from __future__ import annotations

import struct

from .. import schema as st

MAGIC = 0x184D2204
_PRIME1, _PRIME2 = 2654435761, 2246822519
_PRIME3, _PRIME4, _PRIME5 = 3266489917, 668265263, 374761393
_M32 = 0xFFFFFFFF


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def xxh32(data: bytes, seed: int = 0) -> int:
    """xxHash32 (needed for the frame descriptor HC byte)."""
    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + _PRIME1 + _PRIME2) & _M32
        v2 = (seed + _PRIME2) & _M32
        v3 = seed & _M32
        v4 = (seed - _PRIME1) & _M32
        while i + 16 <= n:
            for k, v in enumerate((v1, v2, v3, v4)):
                (lane,) = struct.unpack_from("<I", data, i + 4 * k)
                v = (v + lane * _PRIME2) & _M32
                v = (_rotl(v, 13) * _PRIME1) & _M32
                if k == 0:
                    v1 = v
                elif k == 1:
                    v2 = v
                elif k == 2:
                    v3 = v
                else:
                    v4 = v
            i += 16
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M32
    else:
        h = (seed + _PRIME5) & _M32
    h = (h + n) & _M32
    while i + 4 <= n:
        (lane,) = struct.unpack_from("<I", data, i)
        h = (h + lane * _PRIME3) & _M32
        h = (_rotl(h, 17) * _PRIME4) & _M32
        i += 4
    while i < n:
        h = (h + data[i] * _PRIME5) & _M32
        h = (_rotl(h, 11) * _PRIME1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * _PRIME2) & _M32
    h ^= h >> 13
    h = (h * _PRIME3) & _M32
    h ^= h >> 16
    return h


def _block_decompress_into(src: bytes, out: bytearray, min_reach: int,
                           max_out: int) -> None:
    """LZ4 BLOCK format sequence decoding into a shared output buffer.

    `min_reach` is the smallest absolute output offset matches may
    reference: the block's own start for block-independent frames, or 0
    for block-linked frames (matches reach into prior blocks' history)."""
    i = 0
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        out += src[i : i + lit]
        i += lit
        if i >= n:
            break  # last sequence has no match
        (offset,) = struct.unpack_from("<H", src, i)
        i += 2
        if offset == 0:
            raise st.ArrowTpuError("lz4: zero match offset (corrupt block)")
        mlen = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        start = len(out) - offset
        if start < min_reach:
            raise st.ArrowTpuError("lz4: match offset before valid history")
        # overlapping copies replicate bytes (spec), so copy byte ranges
        # chunk-wise up to the overlap distance
        end = start + mlen
        while start < end:
            take = min(end - start, len(out) - start)
            out += bytes(out[start : start + take])
            start += take
        if len(out) > max_out:
            raise st.ArrowTpuError("lz4: output exceeds declared size")


def decompress(buf: bytes, expected_size: int | None = None) -> bytes:
    """Decode one LZ4 frame."""
    (magic,) = struct.unpack_from("<I", buf, 0)
    if magic != MAGIC:
        raise st.ArrowTpuError(f"lz4: bad frame magic {magic:#x}")
    flg = buf[4]
    version = flg >> 6
    if version != 1:
        raise st.ArrowTpuError(f"lz4: unsupported frame version {version}")
    independent = (flg >> 5) & 1  # FLG bit 5: block independence
    b_checksum = (flg >> 4) & 1
    c_size = (flg >> 3) & 1
    dict_id = flg & 1
    pos = 6  # magic + FLG + BD
    if c_size:
        pos += 8
    if dict_id:
        pos += 4
    pos += 1  # HC byte
    out = bytearray()
    limit = expected_size if expected_size is not None else 1 << 40
    while True:
        (bsize,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        if bsize == 0:  # EndMark
            break
        uncompressed = bool(bsize & 0x80000000)
        bsize &= 0x7FFFFFFF
        block = buf[pos : pos + bsize]
        pos += bsize
        if b_checksum:
            pos += 4
        if uncompressed:
            out += block
        else:
            # linked frames (pyarrow default for >1-block payloads) let
            # matches reach into previously decoded blocks' history
            min_reach = len(out) if independent else 0
            _block_decompress_into(block, out, min_reach, limit)
    return bytes(out)


def compress(data: bytes, block_size: int = 4 * 1024 * 1024) -> bytes:
    """Encode one LZ4 frame.  Blocks go through the greedy matcher of
    `native/src/lz4block.cpp` (built with g++ at first use; a failed build
    raises); a block that does not shrink is stored uncompressed (its size
    with the high bit set), as the spec allows.  Blocks are compressed
    independently, so FLG bit 5 (block independence) is set."""
    from .. import native

    out = bytearray()
    out += struct.pack("<I", MAGIC)
    flg = (1 << 6) | (1 << 5)  # version 1, block-independence
    bd = 7 << 4  # 4 MB max block size
    desc = bytes([flg, bd])
    hc = (xxh32(desc) >> 8) & 0xFF
    out += desc + bytes([hc])
    for off in range(0, len(data), block_size):
        chunk = data[off : off + block_size]
        comp = native.lz4_compress_block(chunk)
        if comp is not None and len(comp) < len(chunk):
            out += struct.pack("<I", len(comp))
            out += comp
        else:
            out += struct.pack("<I", len(chunk) | 0x80000000)
            out += chunk
    out += struct.pack("<I", 0)  # EndMark
    return bytes(out)
