"""Snappy raw-block format codec, implemented from the public format
description (google/snappy format_description.txt).

Counterpart of `arrowtpu/formats/snappy.py`, the same bytes; arrow-rs's
Avro layer takes snappy blocks (arrow-avro/src/compression.rs
Codec::Snappy), and Parquet pages may be snappy-compressed.  Pure host
code.

Format: uvarint uncompressed length, then tagged elements:
  tag & 3 == 0: literal; length-1 in tag>>2 (or 1/2/3/4 extra bytes
                when tag>>2 in 60..63)
  tag & 3 == 1: copy, 1-byte offset: len 4..11 ((tag>>2)&7)+4,
                offset bits 5-7 of tag << 8 | next byte
  tag & 3 == 2: copy, 2-byte LE offset; len (tag>>2)+1
  tag & 3 == 3: copy, 4-byte LE offset; len (tag>>2)+1
"""

from __future__ import annotations

from .. import schema as st

_MAX_LITERAL = 60


def _uvarint(out: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def decompress(data: bytes) -> bytes:
    buf = memoryview(data)
    n = 0
    shift = 0
    p = 0
    while True:
        if p >= len(buf):
            raise st.ArrowTpuError("snappy: truncated length")
        b = buf[p]
        p += 1
        n |= (b & 0x7F) << shift
        if not (b & 0x80):
            break
        shift += 7
    out = bytearray()
    while p < len(buf):
        tag = buf[p]
        p += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= _MAX_LITERAL:
                nb = ln - _MAX_LITERAL + 1
                ln = int.from_bytes(buf[p:p + nb], "little")
                p += nb
            ln += 1
            out += buf[p:p + ln]
            p += ln
        else:
            if kind == 1:
                ln = ((tag >> 2) & 7) + 4
                off = ((tag >> 5) << 8) | buf[p]
                p += 1
            elif kind == 2:
                ln = (tag >> 2) + 1
                off = int.from_bytes(buf[p:p + 2], "little")
                p += 2
            else:
                ln = (tag >> 2) + 1
                off = int.from_bytes(buf[p:p + 4], "little")
                p += 4
            if off == 0 or off > len(out):
                raise st.ArrowTpuError("snappy: bad copy offset")
            # overlapping copies repeat the window byte-by-byte
            start = len(out) - off
            for i in range(ln):
                out.append(out[start + i])
    if len(out) != n:
        raise st.ArrowTpuError(
            f"snappy: length mismatch {len(out)} != {n}")
    return bytes(out)


def _emit_literal(out: bytearray, data, lo: int, hi: int) -> None:
    while lo < hi:
        ln = min(hi - lo, 1 << 16)
        l1 = ln - 1
        if l1 < _MAX_LITERAL:
            out.append(l1 << 2)
        elif l1 < (1 << 8):
            out.append(60 << 2)
            out.append(l1)
        else:
            out.append(61 << 2)
            out += l1.to_bytes(2, "little")
        out += data[lo:lo + ln]
        lo += ln


def compress(data: bytes) -> bytes:
    """Greedy hash-table matcher (the format's canonical strategy)."""
    out = bytearray()
    _uvarint(out, len(data))
    n = len(data)
    if n == 0:
        return bytes(out)
    table: dict = {}
    i = 0
    lit = 0
    while i + 4 <= n:
        key = data[i:i + 4]
        j = table.get(key)
        table[key] = i
        if j is not None and i - j < (1 << 16):
            # extend the match
            ln = 4
            while i + ln < n and ln < 64 and data[j + ln] == data[i + ln]:
                ln += 1
            _emit_literal(out, data, lit, i)
            off = i - j
            if 4 <= ln <= 11 and off < (1 << 11):
                out.append(1 | ((ln - 4) << 2) | ((off >> 8) << 5))
                out.append(off & 0xFF)
            else:
                out.append(2 | ((ln - 1) << 2))
                out += off.to_bytes(2, "little")
            i += ln
            lit = i
        else:
            i += 1
    _emit_literal(out, data, lit, n)
    return bytes(out)
