"""Sans-IO Parquet push decoder.

Counterpart of `arrowtpu/formats/parquet_push.py`, after the reference's
parquet/src/arrow/push_decoder/mod.rs:378 (`ParquetPushDecoder::try_decode` ->
`DecodeResult::NeedsData(ranges)`): the caller owns ALL IO.  The
decoder never reads anything itself — it announces exactly which byte
ranges it needs next, the caller pushes them (from a file, an object
store, a network stream...), and decode proceeds when enough data has
arrived.  This decouples the decode state machine from the IO layer,
the same pattern the reference uses for object_store integration.

State machine:
  footer-length tail (last 8 bytes) -> footer thrift -> per row group:
  the contiguous column-chunk byte span -> RecordBatch out.

Usage:
    dec = ParquetPushDecoder(file_len, columns=["a"])
    while True:
        status, payload = dec.try_decode()
        if status == "needs_data":
            for off, ln in payload:
                dec.push_range(off, read_somehow(off, ln))
        elif status == "batch":
            consume(payload)
        else:          # "finished"
            break
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

from .. import schema as st

FOOTER_TAIL = 8  # length + magic


class ParquetPushDecoder:
    """Caller-driven decoder (reference push_decoder/mod.rs:378)."""

    def __init__(self, file_len: int, columns: Optional[List[str]] = None,
                 decryption=None, device=None):
        if file_len < 12:
            raise st.ArrowTpuError("push decoder: file too small")
        self._file_len = file_len
        self._columns = columns
        self._decryption = decryption
        self._device = device
        self._buf = bytearray(file_len)
        self._have: List[Tuple[int, int]] = []  # provided (off, end)
        self._state = "tail"
        self._pf = None
        self._rg = 0
        self._requested: List[Tuple[int, int]] = [
            (file_len - FOOTER_TAIL, FOOTER_TAIL)]

    # -- IO side ---------------------------------------------------------
    def push_range(self, offset: int, data: bytes) -> None:
        """Provide file bytes [offset, offset+len(data))."""
        self._buf[offset : offset + len(data)] = data
        self._have.append((offset, offset + len(data)))

    def _has(self, off: int, ln: int) -> bool:
        # coverage check (ranges may arrive split; merge-scan)
        need = [(off, off + ln)]
        for s, e in sorted(self._have):
            nxt = []
            for a, b in need:
                if e <= a or s >= b:
                    nxt.append((a, b))
                    continue
                if a < s:
                    nxt.append((a, s))
                if b > e:
                    nxt.append((e, b))
            need = nxt
            if not need:
                return True
        return not need

    # -- decode side -----------------------------------------------------
    def try_decode(self):
        """Returns (status, payload): ("needs_data", [(off, len), ...]),
        ("batch", RecordBatch), or ("finished", None)."""
        missing = [r for r in self._requested if not self._has(*r)]
        if missing:
            return "needs_data", missing

        if self._state == "tail":
            (meta_len,) = struct.unpack_from(
                "<i", self._buf, self._file_len - 8)
            magic = bytes(self._buf[self._file_len - 4 :])
            if magic not in (b"PAR1", b"PARE"):
                raise st.ArrowTpuError("push decoder: bad magic")
            start = self._file_len - 8 - meta_len
            # header magic too: ParquetFile validates both ends
            self._requested = [(0, 4), (start, meta_len + 8)]
            self._state = "footer"
            return self.try_decode()

        if self._state == "footer":
            from .parquet import ParquetFile

            # assemble a sparse view: ParquetFile parses only the footer
            # slice plus ranges we later provide
            self._pf = ParquetFile(bytes(self._buf),
                                   decryption=self._decryption,
                                   device=self._device)
            self._state = "rowgroup"
            self._requested = self._rg_ranges(0)
            return self.try_decode()

        if self._state == "rowgroup":
            if self._rg >= len(self._pf.row_groups):
                return "finished", None
            # refresh the ParquetFile's buffer with the pushed bytes
            self._pf.buf = bytes(self._buf)
            batch = self._pf.read_row_group(self._rg, self._columns)
            self._rg += 1
            if self._rg < len(self._pf.row_groups):
                self._requested = self._rg_ranges(self._rg)
            else:
                self._requested = []
            return "batch", batch

        return "finished", None

    def _rg_ranges(self, rg_idx: int) -> List[Tuple[int, int]]:
        """Byte ranges needed to decode row group rg_idx's projected
        column chunks (the reference computes the same from
        ColumnChunkMetaData offsets)."""
        pf = self._pf
        rg = pf.row_groups[rg_idx]
        names = self._columns or pf.schema.names
        from .parquet_nested import is_nested, leaf_count

        ranges = []
        for name in names:
            fi = pf.schema.index_of(name)
            start_leaf = pf._field_leaf_start[fi]
            nleaves = (leaf_count(pf.schema.fields[fi].dtype)
                       if is_nested(pf.schema.fields[fi].dtype) else 1)
            for k in range(nleaves):
                chunk = rg[1][start_leaf + k]
                cm = chunk.get(3)
                if cm is None:
                    raise st.ArrowTpuError(
                        "push decoder: missing column metadata")
                off = cm.get(11, cm[9])
                ranges.append((off, cm[7]))
        return ranges


def decode_with_reader(read_fn, file_len: int,
                       columns: Optional[List[str]] = None,
                       decryption=None, device=None):
    """Convenience loop: read_fn(offset, length) -> bytes.  Yields
    RecordBatches.  (What an object-store integration would implement.)"""
    dec = ParquetPushDecoder(file_len, columns, decryption=decryption,
                             device=device)
    while True:
        status, payload = dec.try_decode()
        if status == "needs_data":
            for off, ln in payload:
                dec.push_range(off, read_fn(off, ln))
        elif status == "batch":
            yield payload
        else:
            return
