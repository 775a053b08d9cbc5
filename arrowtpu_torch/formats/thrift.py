"""Thrift compact-protocol reader/writer for Parquet metadata.

Counterpart of `arrowtpu/formats/thrift.py`, the same bytes.  arrow-rs
hand-rolls exactly this instead of using a thrift library
(parquet/src/parquet_thrift.rs:653 ReadThrift and the structs generated by
parquet_macros.rs): the protocol subset Parquet needs is small, varint /
zigzag scalars, binary, lists and nested structs.  Pure host code.  The
reader takes any buffer (bytes, bytearray, memoryview) and gives binary
fields as bytes."""

from __future__ import annotations

from typing import Any, Dict

# compact-protocol wire types
CT_STOP = 0
CT_TRUE = 1
CT_FALSE = 2
CT_BYTE = 3
CT_I16 = 4
CT_I32 = 5
CT_I64 = 6
CT_DOUBLE = 7
CT_BINARY = 8
CT_LIST = 9
CT_SET = 10
CT_MAP = 11
CT_STRUCT = 12


def _uvarint(out: bytearray, v: int):
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63)


def _unzigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


class Writer:
    def __init__(self):
        self.buf = bytearray()
        self._last_fid = [0]

    def struct_begin(self):
        self._last_fid.append(0)

    def struct_end(self):
        self.buf.append(CT_STOP)
        self._last_fid.pop()

    def _field_header(self, fid: int, ctype: int):
        delta = fid - self._last_fid[-1]
        if 0 < delta <= 15:
            self.buf.append((delta << 4) | ctype)
        else:
            self.buf.append(ctype)
            _uvarint(self.buf, _zigzag(fid) & 0xFFFFFFFF)
        self._last_fid[-1] = fid

    def field_bool(self, fid: int, v: bool):
        self._field_header(fid, CT_TRUE if v else CT_FALSE)

    def field_i16(self, fid: int, v: int):
        self._field_header(fid, CT_I16)
        _uvarint(self.buf, _zigzag(v) & 0xFFFFFFFFFFFFFFFF)

    def field_i32(self, fid: int, v: int):
        self._field_header(fid, CT_I32)
        _uvarint(self.buf, _zigzag(v) & 0xFFFFFFFFFFFFFFFF)

    def field_i64(self, fid: int, v: int):
        self._field_header(fid, CT_I64)
        _uvarint(self.buf, _zigzag(v) & 0xFFFFFFFFFFFFFFFF)

    def field_double(self, fid: int, v: float):
        import struct as _s

        self._field_header(fid, CT_DOUBLE)
        self.buf += _s.pack("<d", v)

    def field_binary(self, fid: int, data: bytes):
        self._field_header(fid, CT_BINARY)
        _uvarint(self.buf, len(data))
        self.buf += data

    def field_string(self, fid: int, s: str):
        self.field_binary(fid, s.encode("utf-8"))

    def field_struct(self, fid: int):
        """Call, then struct_begin()/.../struct_end()."""
        self._field_header(fid, CT_STRUCT)

    def field_list(self, fid: int, elem_ctype: int, n: int):
        self._field_header(fid, CT_LIST)
        if n < 15:
            self.buf.append((n << 4) | elem_ctype)
        else:
            self.buf.append(0xF0 | elem_ctype)
            _uvarint(self.buf, n)

    # list element writers (no field headers inside lists)
    def elem_bool(self, v: bool):
        # compact protocol: bool list elements are one byte (1=true, 2=false)
        self.buf.append(CT_TRUE if v else CT_FALSE)

    def elem_i32(self, v: int):
        _uvarint(self.buf, _zigzag(v) & 0xFFFFFFFFFFFFFFFF)

    def elem_i64(self, v: int):
        _uvarint(self.buf, _zigzag(v) & 0xFFFFFFFFFFFFFFFF)

    def elem_binary(self, data: bytes):
        _uvarint(self.buf, len(data))
        self.buf += data

    def elem_string(self, s: str):
        self.elem_binary(s.encode("utf-8"))

    def raw(self, data: bytes):
        """Append pre-serialized thrift bytes (e.g. a complete struct body
        after field_struct(); compact-protocol structs are self-contained
        — field-id deltas reset per struct)."""
        self.buf += data

    def bytes(self) -> bytes:
        return bytes(self.buf)


class Reader:
    """Generic reader producing {fid: value} dicts; structs nest as dicts,
    lists as Python lists of (ctype-decoded) values."""

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def _u8(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def _uvarint(self) -> int:
        out = 0
        shift = 0
        while True:
            b = self._u8()
            out |= (b & 0x7F) << shift
            if not (b & 0x80):
                return out
            shift += 7

    def _ivar(self) -> int:
        return _unzigzag(self._uvarint())

    def read_struct(self) -> Dict[int, Any]:
        out: Dict[int, Any] = {}
        last_fid = 0
        while True:
            header = self._u8()
            if header == CT_STOP:
                return out
            delta = header >> 4
            ctype = header & 0x0F
            if delta == 0:
                fid = _unzigzag(self._uvarint())
            else:
                fid = last_fid + delta
            last_fid = fid
            out[fid] = self._read_value(ctype)

    def _read_value(self, ctype: int):
        if ctype == CT_TRUE:
            return True
        if ctype == CT_FALSE:
            return False
        if ctype == CT_BYTE:
            return self._u8()
        if ctype in (CT_I16, CT_I32, CT_I64):
            return self._ivar()
        if ctype == CT_DOUBLE:
            import struct as _s

            v = _s.unpack_from("<d", self.buf, self.pos)[0]
            self.pos += 8
            return v
        if ctype == CT_BINARY:
            n = self._uvarint()
            v = bytes(self.buf[self.pos : self.pos + n])
            self.pos += n
            return v
        if ctype in (CT_LIST, CT_SET):
            header = self._u8()
            n = header >> 4
            etype = header & 0x0F
            if n == 15:
                n = self._uvarint()
            if etype in (CT_TRUE, CT_FALSE):
                # bool list elements are one byte each (1=true, 2=false)
                return [self._u8() == CT_TRUE for _ in range(n)]
            return [self._read_value(etype) for _ in range(n)]
        if ctype == CT_STRUCT:
            return self.read_struct()
        if ctype == CT_MAP:
            raise NotImplementedError("thrift map not used by parquet metadata we read")
        raise ValueError(f"bad thrift compact type {ctype}")
