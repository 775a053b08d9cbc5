"""Minimal flatbuffers builder/reader for the Arrow IPC metadata.

Counterpart of `arrowtpu/formats/flatbuf.py`, the same bytes.  arrow-rs
vendors 11k lines of flatc-generated code (arrow-ipc/src/gen/{Schema,
Message,File}.rs from format/*.fbs); the IPC format needs only tables with
vtables, scalar fields, strings, vectors of tables and structs, and
unions, so a compact hand-rolled builder and reader replace them.  Wire
format per the flatbuffers spec: little-endian, vtables of (vtable_len,
table_len, field offsets), tables referenced by signed i32 offsets, root =
a u32 offset at the buffer's start.  The reader takes any buffer that
`struct.unpack_from` and slicing take (bytes, bytearray, memoryview), so a
large IPC file is parsed without copies."""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple


class Builder:
    """Write-backwards flatbuffer builder (minimal)."""

    def __init__(self):
        self.buf = bytearray()  # built back-to-front; index 0 = end of buffer
        self.vtables: List[Tuple[Tuple[int, ...], int]] = []  # dedup cache
        self._current: Optional[List[Tuple[int, int, int]]] = None  # (id, off_pos, kind)

    # position = offset from the END of the final buffer
    def _pos(self) -> int:
        return len(self.buf)

    def _push(self, data: bytes):
        self.buf += data[::-1]  # store reversed; final output reverses once

    def pad(self, n: int):
        if n:
            self._push(b"\0" * n)

    def align(self, a: int, extra: int = 0):
        while (self._pos() + extra) % a != 0:
            self._push(b"\0")

    def push_scalar(self, fmt: str, v) -> int:
        data = struct.pack("<" + fmt, v)
        self.align(len(data))
        self._push(data)
        return self._pos()

    def push_bytes_vector(self, data: bytes) -> int:
        """vector<ubyte>: [i32 len][bytes], length prefix 4-aligned and
        immediately before the data (no padding in between)."""
        self.align(4, extra=len(data))  # so the length slot lands 4-aligned
        self._push(data)
        self._push(struct.pack("<i", len(data)))
        return self._pos()

    def string(self, s: str) -> int:
        raw = s.encode("utf-8")
        # [i32 len][bytes][\0]; length 4-aligned, terminator after bytes
        self.align(4, extra=len(raw) + 1)
        self._push(b"\0")
        self._push(raw)
        self._push(struct.pack("<i", len(raw)))
        return self._pos()

    def vector_of_offsets(self, offsets: List[int]) -> int:
        self.align(4)
        for off in reversed(offsets):
            rel = self._pos() + 4 - off
            self._push(struct.pack("<i", rel))
        self._push(struct.pack("<i", len(offsets)))
        return self._pos()

    def vector_of_structs(self, packed: bytes, count: int, align: int = 8) -> int:
        """vector of fixed-size structs: data block aligned to `align`,
        i32 length immediately before it."""
        self.align(align, extra=len(packed))
        self._push(packed)
        self._push(struct.pack("<i", count))
        return self._pos()

    # --- table construction -------------------------------------------------
    def start_table(self):
        assert self._current is None
        self._current = []

    def slot_scalar(self, fid: int, fmt: str, v, default):
        if v == default:
            return
        pos = self.push_scalar(fmt, v)
        self._current.append((fid, pos, struct.calcsize(fmt)))

    def slot_offset(self, fid: int, off: Optional[int]):
        if off is None:
            return
        self._current.append((fid, off, -1))  # -1 marks an offset slot

    def slot_struct_inline(self, fid: int, data: bytes, align_: int):
        """structs embed inline in the table."""
        self.align(align_)
        self._push(data)
        self._current.append((fid, self._pos(), len(data)))

    def end_table(self) -> int:
        """Fields were pushed individually earlier (they live at higher
        addresses than the table start; vtable offsets are u16 distances
        from table start, so keep field pushes close to end_table).
        Offset-typed slots get their i32 uoffset cells written here."""
        slots = self._current
        self._current = None
        max_id = max((fid for fid, _, _ in slots), default=-1)
        fixed = []
        for fid, pos, kind in slots:
            if kind == -1:  # offset slot: write the forward i32 cell now
                self.align(4)
                rel = self._pos() + 4 - pos
                self._push(struct.pack("<i", rel))
                fixed.append((fid, self._pos(), 4))
            else:
                fixed.append((fid, pos, kind))
        self.align(4)
        table_pos = self._pos() + 4  # future position of the soffset cell
        voffsets = {fid: table_pos - pos for fid, pos, _ in fixed}
        n_fields = max_id + 1
        vt_len = 4 + 2 * n_fields
        tbl_len = 4
        for fid, pos, size in fixed:
            tbl_len = max(tbl_len, (table_pos - pos) + size)
        vt = struct.pack("<HH", vt_len, tbl_len)
        for fid in range(n_fields):
            vt += struct.pack("<H", voffsets.get(fid, 0))
        for k, p in self.vtables:
            if k == vt:  # shared vtable: soffset = vtable_pos - table_pos
                self._push(struct.pack("<i", p - table_pos))
                return self._pos()
        self._push(struct.pack("<i", vt_len))  # vtable sits right before
        self._push(vt)
        self.vtables.append((vt, self._pos()))
        return table_pos

    def finish(self, root: int) -> bytes:
        # final length must be 8-aligned so position-alignment == address-
        # alignment (addresses are measured from the buffer end here)
        self.align(8, extra=4)
        rel = self._pos() + 4 - root
        self._push(struct.pack("<I", rel))
        return bytes(self.buf[::-1])


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


class Table:
    """Read-side table accessor."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos

    @classmethod
    def root(cls, buf: bytes) -> "Table":
        (off,) = struct.unpack_from("<I", buf, 0)
        return cls(buf, off)

    def _field_pos(self, fid: int) -> Optional[int]:
        (soff,) = struct.unpack_from("<i", self.buf, self.pos)
        vt = self.pos - soff
        (vt_len,) = struct.unpack_from("<H", self.buf, vt)
        slot = 4 + 2 * fid
        if slot >= vt_len:
            return None
        (foff,) = struct.unpack_from("<H", self.buf, vt + slot)
        if foff == 0:
            return None
        return self.pos + foff

    def scalar(self, fid: int, fmt: str, default=0):
        p = self._field_pos(fid)
        if p is None:
            return default
        return struct.unpack_from("<" + fmt, self.buf, p)[0]

    def offset(self, fid: int) -> Optional[int]:
        p = self._field_pos(fid)
        if p is None:
            return None
        (rel,) = struct.unpack_from("<i", self.buf, p)
        return p + rel

    def table(self, fid: int) -> Optional["Table"]:
        t = self.offset(fid)
        return None if t is None else Table(self.buf, t)

    def string(self, fid: int) -> Optional[str]:
        p = self.offset(fid)
        if p is None:
            return None
        (ln,) = struct.unpack_from("<i", self.buf, p)
        return bytes(self.buf[p + 4 : p + 4 + ln]).decode("utf-8")

    def vector_len(self, fid: int) -> int:
        p = self.offset(fid)
        if p is None:
            return 0
        return struct.unpack_from("<i", self.buf, p)[0]

    def vector_tables(self, fid: int) -> List["Table"]:
        p = self.offset(fid)
        if p is None:
            return []
        (n,) = struct.unpack_from("<i", self.buf, p)
        out = []
        for i in range(n):
            ep = p + 4 + 4 * i
            (rel,) = struct.unpack_from("<i", self.buf, ep)
            out.append(Table(self.buf, ep + rel))
        return out

    def vector_scalars(self, fid: int, fmt: str) -> List:
        """vector of fixed-width scalars (e.g. Union.typeIds int32)."""
        p = self.offset(fid)
        if p is None:
            return []
        (n,) = struct.unpack_from("<i", self.buf, p)
        w = struct.calcsize("<" + fmt)
        return [struct.unpack_from("<" + fmt, self.buf, p + 4 + w * i)[0]
                for i in range(n)]

    def vector_structs(self, fid: int, item_size: int) -> List[bytes]:
        p = self.offset(fid)
        if p is None:
            return []
        (n,) = struct.unpack_from("<i", self.buf, p)
        base = p + 4
        return [self.buf[base + i * item_size : base + (i + 1) * item_size] for i in range(n)]
