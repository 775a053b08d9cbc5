"""Parquet reader and writer, implemented from the format spec.

Counterpart of `arrowtpu/formats/parquet.py`: the same bytes, written from
the port's columns and read back onto a device (None: the card; "cpu" on
request), after the reference's parquet crate:

  * the footer and page headers as thrift compact structs
    (formats/thrift.py; file/metadata/mod.rs ParquetMetaData);
  * data page v1 framing with RLE / bit-packed hybrid levels
    (encodings/rle.rs), PLAIN and dictionary encodings with the
    dictionary-first writer and its fallback past
    `dictionary_page_size_limit` (column/writer/mod.rs:1014-1055);
    DELTA_BINARY_PACKED, DELTA_LENGTH_BYTE_ARRAY and BYTE_STREAM_SPLIT
    by `WriterProperties.column_encoding` (formats/parquet_ext.py);
  * codecs none, GZIP and ZSTD (`zstandard`, imported at first use:
    `import arrowtpu_torch.formats.parquet` needs it not); SNAPPY raises,
    as in the JAX package;
  * row-group statistics, bloom filters and the page index
    (parquet_ext.py), nested columns by Dremel levels (parquet_nested.py),
    content-defined pages (parquet_cdc.py) and modular encryption
    (parquet_crypto.py).

Framing and decoding stay on the host, vectorized in numpy per page (a
level run costs one header, never a Python step per value, except the
4-byte length prefixes of PLAIN byte arrays).  A column chunk's decoded
values become one column with one host-to-device copy per buffer
(`_assemble`).

The JAX package's timestamps are kept as they are: a Timestamp that is
not in ms is labelled TIMESTAMP_MICROS and its values are written
unconverted (callers cast s / ns first), and no Arrow schema is stored,
so a zone does not round-trip.  A column annotated as geospatial
(`formats/geospatial.geometry_field`) is written with the GEOMETRY or
GEOGRAPHY logical type and its chunks' WKB bounding box and type set
(ColumnMetaData field 17) in place of min / max.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import schema as st
from ..config import resolve_device, round_up
from ..core import batch as bt
from ..core import bitmap as bm
from ..core import column as col
from . import thrift
from .layout import grow, string_offsets_data, strings_from_offsets

MAGIC = b"PAR1"

# physical types
P_BOOL, P_I32, P_I64, P_I96, P_FLOAT, P_DOUBLE, P_BYTES, P_FLBA = range(8)
# encodings
E_PLAIN, E_PLAIN_DICT, E_RLE, E_RLE_DICT = 0, 2, 3, 8
E_DELTA_BINARY_PACKED, E_DELTA_LENGTH_BYTE_ARRAY = 5, 6
E_DELTA_BYTE_ARRAY, E_BYTE_STREAM_SPLIT = 7, 9
# codecs
C_NONE, C_SNAPPY, C_GZIP, C_ZSTD = 0, 1, 2, 6
# converted types
CONV_UTF8, CONV_DATE, CONV_TS_MS, CONV_TS_US = 0, 6, 9, 10
CONV_DECIMAL = 5
CONV_UINT8, CONV_UINT16, CONV_UINT32, CONV_UINT64 = 11, 12, 13, 14
CONV_INT8, CONV_INT16 = 15, 16

_NP_PHYS = {P_I32: "<i4", P_I64: "<i8", P_FLOAT: "<f4", P_DOUBLE: "<f8"}


def _physical(dt: st.DataType) -> Tuple[int, Optional[int]]:
    """arrow dtype -> (physical type, converted type)."""
    if isinstance(dt, st.Boolean):
        return P_BOOL, None
    if isinstance(dt, st.Int):
        conv = None
        if not dt.signed:
            conv = {8: CONV_UINT8, 16: CONV_UINT16, 32: CONV_UINT32,
                    64: CONV_UINT64}[dt.bits]
        elif dt.bits == 8:
            conv = CONV_INT8
        elif dt.bits == 16:
            conv = CONV_INT16
        return (P_I64, conv) if dt.bits == 64 else (P_I32, conv)
    if isinstance(dt, st.Float):
        return (P_DOUBLE, None) if dt.bits == 64 else (P_FLOAT, None)
    if isinstance(dt, st.Utf8):
        return P_BYTES, CONV_UTF8
    if isinstance(dt, st.Binary):
        return P_BYTES, None
    if isinstance(dt, st.Date32):
        return P_I32, CONV_DATE
    if isinstance(dt, st.Timestamp):
        if dt.unit == "ms":
            return P_I64, CONV_TS_MS
        return P_I64, CONV_TS_US  # s/ns callers should cast; us is default
    if isinstance(dt, st.Dictionary):
        return _physical(dt.value)
    nl = st.decimal_limbs(dt)
    if nl is not None:
        # DECIMAL: INT32 / INT64 for one / two limbs, FLBA (big-endian
        # two's complement) wider (reference arrow/schema/mod.rs)
        if nl == 1:
            return P_I32, CONV_DECIMAL
        if nl == 2:
            return P_I64, CONV_DECIMAL
        return P_FLBA, CONV_DECIMAL
    raise st.SchemaError(f"parquet: unsupported type {dt}")


def _dec_to_flba(limbs_np: np.ndarray) -> np.ndarray:
    """(n, nl) little-endian u32 limbs -> (n, nl*4) big-endian bytes."""
    be = np.ascontiguousarray(limbs_np[:, ::-1]).astype(">u4")
    return be.view(np.uint8).reshape(limbs_np.shape[0], -1)


def _flba_to_limbs(vals2d: np.ndarray, nl: int) -> np.ndarray:
    """(n, tl) big-endian two's-complement bytes -> (n, nl) LE u32 limbs."""
    n, tl = vals2d.shape
    want = nl * 4
    if tl < want:
        sign = (vals2d[:, 0] >= 0x80) if tl else np.zeros(n, bool)
        pad = np.where(sign[:, None], np.uint8(0xFF), np.uint8(0))
        vals2d = np.concatenate(
            [np.broadcast_to(pad, (n, want - tl)), vals2d], axis=1)
    elif tl > want:
        vals2d = vals2d[:, tl - want:]
    words = np.ascontiguousarray(vals2d).view(">u4").reshape(n, nl)
    return words[:, ::-1].astype(np.uint32)


def _logical(phys: int, conv: Optional[int],
             elem: Optional[dict] = None) -> st.DataType:
    if conv == CONV_DECIMAL and elem is not None:
        scale = elem.get(7, 0)
        precision = elem.get(8, 38)
        for nl in (1, 2, 4, 8):
            if precision <= st.MAX_DECIMAL_PRECISION[nl]:
                return st.decimal_for_limbs(nl, precision, scale)
        raise st.SchemaError(f"parquet: decimal precision {precision} > 76")
    if phys == P_BOOL:
        return st.bool_
    if phys == P_I32:
        return {CONV_DATE: st.Date32(), CONV_UINT8: st.uint8,
                CONV_UINT16: st.uint16, CONV_UINT32: st.uint32,
                CONV_INT8: st.int8, CONV_INT16: st.int16}.get(conv, st.int32)
    if phys == P_I64:
        return {CONV_TS_MS: st.Timestamp("ms"), CONV_TS_US: st.Timestamp("us"),
                CONV_UINT64: st.uint64}.get(conv, st.int64)
    if phys == P_FLOAT:
        return st.float32
    if phys == P_DOUBLE:
        return st.float64
    if phys == P_BYTES:
        return st.utf8 if conv == CONV_UTF8 else st.binary
    raise st.SchemaError(f"parquet: unsupported physical type {phys}")


# ---------------------------------------------------------------------------
# RLE / bit-packed hybrid (reference encodings/rle.rs)
# ---------------------------------------------------------------------------


def rle_encode(values: np.ndarray, bit_width: int) -> bytes:
    """Encode as alternating RLE runs / bit-packed groups, the JAX
    package's bytes.  A mid-stream bit-packed run holds exactly groups * 8
    values (only the final run may pad), so pending bit-packed values
    flush only at multiples of 8, and a long run of one value becomes an
    RLE run once the pending count aligns.  The runs of equal values are
    found in numpy; the loop steps over runs, not values."""
    values = np.asarray(values)
    out = bytearray()
    n = len(values)
    byte_w = (bit_width + 7) // 8

    def flush_packed(chunk: np.ndarray, final: bool):
        count = len(chunk)
        if count == 0:
            return
        groups = (count + 7) // 8
        assert final or count % 8 == 0
        _vw(out, (groups << 1) | 1)
        padded = np.zeros(groups * 8, chunk.dtype)
        padded[:count] = chunk
        out.extend(_bitpack(padded, bit_width))

    starts = np.flatnonzero(values[1:] != values[:-1]) + 1 if n else []
    bounds = np.concatenate([[0], starts, [n]]).astype(np.int64) if n else []
    pending_start = pending_len = 0
    for i, j in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        run = j - i
        # align pending to 8 by borrowing from the head of this run
        borrow = min((-pending_len) % 8 if run >= 16 else run, run)
        if run - borrow >= 8 and (pending_len + borrow) % 8 == 0:
            pending_len += borrow
            flush_packed(values[pending_start:pending_start + pending_len],
                         False)
            _vw(out, (run - borrow) << 1)
            out += int(values[i]).to_bytes(byte_w, "little")
            pending_start, pending_len = j, 0
        else:
            pending_len += run
    flush_packed(values[pending_start:pending_start + pending_len], True)
    return bytes(out)


def _vw(out: bytearray, v: int):
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _bitpack(vals: np.ndarray, bit_width: int) -> bytes:
    """LSB-first bit packing (parquet bit-packed run layout)."""
    bits = ((vals[:, None].astype(np.uint32)
             >> np.arange(bit_width, dtype=np.uint32)[None, :]) & 1
            ).astype(np.uint8)
    return np.packbits(bits.reshape(-1), bitorder="little").tobytes()


def rle_decode(buf, bit_width: int, count: int) -> np.ndarray:
    """Decode `count` values; vectorized per run."""
    out = np.zeros(count, np.int64)
    pos = 0
    filled = 0
    byte_w = (bit_width + 7) // 8
    while filled < count and pos < len(buf):
        header = 0
        shift = 0
        while True:
            b = buf[pos]
            pos += 1
            header |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        if header & 1:  # bit-packed: (header >> 1) groups of 8
            groups = header >> 1
            nbytes = groups * bit_width
            raw = np.frombuffer(buf, np.uint8, count=nbytes, offset=pos)
            pos += nbytes
            bits = np.unpackbits(raw, bitorder="little").reshape(-1, bit_width)
            vals = (bits.astype(np.int64)
                    << np.arange(bit_width, dtype=np.int64)[None, :]).sum(1)
            take = min(groups * 8, count - filled)
            out[filled:filled + take] = vals[:take]
            filled += take
        else:  # RLE run
            run = header >> 1
            v = int.from_bytes(bytes(buf[pos:pos + byte_w]), "little")
            pos += byte_w
            take = min(run, count - filled)
            out[filled:filled + take] = v
            filled += take
    return out


# ---------------------------------------------------------------------------
# codecs (reference compression.rs)
# ---------------------------------------------------------------------------


def _compress(codec: int, data: bytes) -> bytes:
    if codec == C_NONE:
        return data
    if codec == C_GZIP:
        import gzip

        return gzip.compress(data, 6)
    if codec == C_ZSTD:
        import zstandard

        return zstandard.ZstdCompressor().compress(data)
    raise st.ArrowTpuError(f"parquet: unsupported codec {codec}")


def _decompress(codec: int, data, uncompressed_size: int):
    if codec == C_NONE:
        return data
    if codec == C_GZIP:
        import gzip

        return gzip.decompress(data)
    if codec == C_ZSTD:
        import zstandard

        return zstandard.ZstdDecompressor().decompress(
            data, max_output_size=uncompressed_size)
    if codec == C_SNAPPY:
        raise st.ArrowTpuError("parquet: snappy codec not available")
    raise st.ArrowTpuError(f"parquet: unsupported codec {codec}")


_CODEC_NAMES = {"none": C_NONE, "uncompressed": C_NONE, "gzip": C_GZIP,
                "zstd": C_ZSTD}


# ---------------------------------------------------------------------------
# writer (reference file/writer.rs + column/writer/mod.rs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WriterProperties:
    """reference file/properties.rs:241 (subset), the JAX package's."""

    compression: str = "none"
    dictionary_enabled: bool = True
    dictionary_page_size_limit: int = 1024 * 1024
    data_page_row_limit: int = 1 << 20
    statistics_enabled: bool = True
    created_by: str = "arrowtpu parquet writer"
    bloom_filter_columns: tuple = ()
    bloom_filter_fpp: float = 0.01
    write_page_index: bool = False
    column_encoding: Optional[Dict[str, str]] = None  # name -> encoding
    # parquet_crypto.FileEncryptionProperties; the page index and bloom
    # filters are refused for encrypted files, as in the JAX package
    encryption: Optional[object] = None
    # parquet_cdc.CdcOptions: data-page boundaries by the gearhash chunker
    # in place of data_page_row_limit
    cdc_options: Optional[object] = None


def _plain_encode(vals: np.ndarray, phys: int) -> bytes:
    if phys == P_BOOL:
        return np.packbits(vals.astype(bool), bitorder="little").tobytes()
    return np.ascontiguousarray(vals).tobytes()


def _column_values(c: col.Column):
    """Live values on the host, nulls left out, and the valid bools: an
    array, or (starts, lens, data) for strings."""
    n = c.length
    valid = (np.ones(n, bool) if c.validity is None
             else bm.to_numpy_bools(c.validity, n))
    if isinstance(c, col.BooleanColumn):
        return c.values_bool()[:n].cpu().numpy()[valid], valid
    if isinstance(c, col.StringViewColumn):
        offsets, data = string_offsets_data(c)
        return (offsets[:-1][valid], np.diff(offsets)[valid], data), valid
    if isinstance(c, col.PrimitiveColumn):
        vals = c.values[:n].cpu().numpy()
        nl = st.decimal_limbs(c.dtype)
        if nl is not None:
            limbs = vals.view(np.uint32)[valid]
            if nl == 1:
                return limbs[:, 0].view(np.int32), valid
            if nl == 2:
                return np.ascontiguousarray(limbs).view(np.int64)[:, 0], valid
            return _dec_to_flba(limbs), valid
        if st.is_u64(c.dtype):
            vals = vals.view(np.uint64)
        return physical_width(vals[valid]), valid
    raise st.SchemaError(f"parquet: unsupported column {type(c).__name__}")


def physical_width(vals: np.ndarray) -> np.ndarray:
    """Values of fewer than 4 bytes at their physical type's width: int8 /
    int16 / uint8 / uint16 as INT32, float16 as FLOAT.  The JAX writer
    writes them at their own width, a file no reader can read (ROADMAP
    C.3, fault 18)."""
    if vals.dtype.itemsize >= 4:
        return vals
    return vals.astype(np.float32 if vals.dtype.kind == "f" else np.int32)


def _bytes_plain(starts, lens, data) -> bytes:
    """byte_array PLAIN: 4-byte LE length + bytes per value, built by one
    gather into the output buffer."""
    n = len(lens)
    tot_payload = int(lens.sum())
    out = np.zeros(tot_payload + 4 * n, np.uint8)
    out_offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens + 4, out=out_offsets[1:])
    lens32 = lens.astype("<u4")[:, None].view(np.uint8).reshape(n, 4)
    hdr_idx = out_offsets[:-1][:, None] + np.arange(4)[None, :]
    out[hdr_idx.reshape(-1)] = lens32.reshape(-1)
    within = np.arange(tot_payload, dtype=np.int64) - np.repeat(
        np.cumsum(lens) - lens, lens)
    out[within + np.repeat(out_offsets[:-1] + 4, lens)] = data[
        within + np.repeat(starts, lens)]
    return out.tobytes()


def _byte_list(vals) -> List[bytes]:
    starts, lens, data = vals
    raw = data.tobytes()
    return [raw[s:s + ln] for s, ln in zip(starts.tolist(), lens.tolist())]


def _write_column(out, c: col.Column, dt: st.DataType, props: WriterProperties,
                  nullable: bool = True, field_name: str = "",
                  crypt=None, rg_idx: int = 0, col_ord: int = 0):
    """Write one column chunk; -> its ColumnMetaData fields.  `crypt` is a
    (FileEncryptor, page_key) pair when its pages are encrypted."""
    phys, _ = _physical(dt)
    codec = _CODEC_NAMES[props.compression]
    n = c.length
    if isinstance(c, col.DictionaryColumn):
        c = _decode_dict(c)
    vals, valid = _column_values(c)
    num_nulls = int(n - valid.sum())
    encodings = [E_RLE]
    pages = []

    bloom = None
    if field_name in (props.bloom_filter_columns or ()):
        from . import parquet_ext as px

        # the filter is sized by the count of values, as the JAX writer
        # sizes it; its bits need each distinct value (by its bits) once
        if phys == P_BYTES:
            distinct = list(dict.fromkeys(_byte_list(vals)))
        elif vals.dtype.kind == "f":
            bits = vals.view(f"u{vals.dtype.itemsize}")
            distinct = np.unique(bits).view(vals.dtype)
        else:
            distinct = np.unique(vals)
        bloom = (len(valid) - num_nulls,
                 px.hash_column_values(distinct, phys))

    # definition levels (flat: valid ? 1 : 0); REQUIRED columns carry none
    if not nullable and num_nulls:
        raise st.ArrowTpuError("parquet: nulls in a non-nullable field")

    # rows per data page (reference properties.rs
    # data_page_row_count_limit); each page has its own level block,
    # payload slice, first row and min / max for the page index
    if props.cdc_options is not None:
        from .parquet_cdc import page_slices

        row_slices = page_slices(vals, valid, phys, nullable,
                                 props.cdc_options, n)
    else:
        page_limit = max(1, int(props.data_page_row_limit))
        row_slices = [(r0, min(r0 + page_limit, n))
                      for r0 in range(0, n, page_limit)] or [(0, 0)]
    nn_cum = (np.arange(n + 1) if not num_nulls else
              np.concatenate([[0], np.cumsum(valid.astype(np.int64))]))
    page_stats = []

    def _def_block(r0, r1):
        if not nullable:
            return b""
        dl = rle_encode(valid[r0:r1].astype(np.int64), 1)
        return struct.pack("<i", len(dl)) + dl

    def _pstats(pv, r0, r1):
        """(null_page, min, max, null_count) of one page's dense values."""
        nulls = int((r1 - r0) - (nn_cum[r1] - nn_cum[r0]))
        if len(pv) == 0:
            return {"null_page": True, "min": b"", "max": b"",
                    "null_count": nulls}
        if phys == P_BYTES:
            return {"null_page": False, "min": bytes(min(pv)),
                    "max": bytes(max(pv)), "null_count": nulls}
        if phys in _NP_PHYS:
            return {"null_page": False, "min": _stats_bytes(pv.min(), phys),
                    "max": _stats_bytes(pv.max(), phys), "null_count": nulls}
        return {"null_page": False, "min": b"", "max": b"",
                "null_count": nulls}

    # an explicit encoding (reference properties.rs set_column_encoding):
    # one page for the chunk, as in the JAX package
    override = (props.column_encoding or {}).get(field_name)
    if override:
        from . import parquet_ext as px

        if override == "delta_binary_packed" and phys in (P_I32, P_I64):
            payload = px.delta_binary_packed_encode(vals)
            enc = E_DELTA_BINARY_PACKED
        elif override == "byte_stream_split" and phys in _NP_PHYS:
            payload = px.byte_stream_split_encode(vals)
            enc = E_BYTE_STREAM_SPLIT
        elif override == "delta_length_byte_array" and phys == P_BYTES:
            payload = px.delta_length_byte_array_encode(_byte_list(vals))
            enc = E_DELTA_LENGTH_BYTE_ARRAY
        else:
            raise st.ArrowTpuError(
                f"parquet: encoding {override!r} unsupported for physical "
                f"type {phys}")
        def_block = _def_block(0, n) if nullable else b""
        pages.append(("data", def_block + payload, n, enc))
        encodings.append(enc)
    # dictionary-first for byte_array (reference column/writer :1014)
    use_dict = (not override) and props.dictionary_enabled and phys == P_BYTES
    if use_dict:
        keys: Dict[bytes, int] = {}
        uniq = _byte_list(vals)
        codes = np.fromiter((keys.setdefault(s, len(keys)) for s in uniq),
                            np.int64, len(uniq))
        uniq = list(keys)
        dict_payload = b"".join(struct.pack("<i", len(u)) + u for u in uniq)
        if len(dict_payload) <= props.dictionary_page_size_limit:
            bw = max(1, int(np.ceil(np.log2(max(len(uniq), 2)))))
            pages.append(("dict", dict_payload, len(uniq)))
            for r0, r1 in row_slices:
                pcodes = codes[nn_cum[r0]:nn_cum[r1]]
                body = bytes([bw]) + rle_encode(pcodes, bw)
                pages.append(("data", _def_block(r0, r1) + body,
                              r1 - r0, E_RLE_DICT, r0))
                page_stats.append(_pstats([uniq[k] for k in pcodes], r0, r1))
            encodings += [E_RLE_DICT, E_PLAIN]
        else:
            use_dict = False
    if not use_dict and not override:
        for r0, r1 in row_slices:
            v0, v1 = int(nn_cum[r0]), int(nn_cum[r1])
            if phys == P_BYTES:
                starts, lens, data = vals
                sl = (starts[v0:v1], lens[v0:v1], data)
                payload = _bytes_plain(*sl)
                pv = _byte_list(sl)
            else:
                pv = vals[v0:v1]
                payload = _plain_encode(pv, phys)
            pages.append(("data", _def_block(r0, r1) + payload,
                          r1 - r0, E_PLAIN, r0))
            page_stats.append(_pstats(pv, r0, r1))
        encodings.append(E_PLAIN)

    meta = _emit_pages(out, pages, codec, crypt, rg_idx, col_ord)
    stats = None
    if props.statistics_enabled and phys in _NP_PHYS:
        stats = ((vals.min(), vals.max(), num_nulls, phys) if len(vals)
                 else (None, None, num_nulls, phys))
    meta.update({"bloom": bloom, "page_stats": page_stats,
                 "num_nulls": num_nulls, "type": phys,
                 "encodings": encodings, "codec": codec, "num_values": n,
                 "statistics": stats})
    return meta


def _emit_pages(out, pages, codec: int, crypt, rg_idx: int, col_ord: int):
    """Compress and write a chunk's pages (headers in front; with `crypt`
    each header and body a GCM module) -> their offsets and sizes."""
    start_offset = out.tell()
    total_comp = total_uncomp = 0
    dict_page_offset = data_page_offset = None
    page_locations = []  # (offset, compressed size incl header, first row)
    ov = 0
    if crypt is not None:
        from . import parquet_crypto as pcx

        # spec: an encrypted page's compressed_page_size includes the
        # module's length, nonce and tag
        ov = pcx.SIZE_LEN + pcx.NONCE_LEN + pcx.TAG_LEN
    emit = []
    for page in pages:
        comp = _compress(codec, page[1])
        if page[0] == "dict":
            hdr = _page_header_dict(len(page[1]), len(comp) + ov, page[2])
            emit.append((hdr, comp, True, None))
        else:
            hdr = _page_header_data(len(page[1]), len(comp) + ov, page[2],
                                    page[3])
            emit.append((hdr, comp, False, page[4] if len(page) > 4 else 0))
        total_uncomp += len(hdr) + len(page[1])
    if crypt is not None:
        enc_ctx, page_key = crypt
        offsets = pcx.write_encrypted_pages(
            out, [e[:3] for e in emit], page_key, enc_ctx.file_aad, rg_idx,
            col_ord)
        total_comp = out.tell() - start_offset
    else:
        offsets = []
        for hdr, comp, _, _ in emit:
            offsets.append(out.tell())
            out.write(hdr)
            out.write(comp)
            total_comp += len(hdr) + len(comp)
    for off, (hdr, comp, is_dict, first_row) in zip(offsets, emit):
        if is_dict:
            if dict_page_offset is None:
                dict_page_offset = off
        else:
            if data_page_offset is None:
                data_page_offset = off
            page_locations.append((off, len(hdr) + len(comp), first_row))
    return {"page_locations": page_locations,
            "total_uncompressed_size": total_uncomp,
            "total_compressed_size": total_comp,
            "data_page_offset": data_page_offset,
            "dictionary_page_offset": dict_page_offset}


def _bit_width(maxlevel: int) -> int:
    return max(1, int(np.ceil(np.log2(maxlevel + 1))))


def _write_leaf_chunk(out, leaf, props: WriterProperties,
                      crypt=None, rg_idx: int = 0, col_ord: int = 0):
    """Write one nested leaf's chunk: [rep levels][def levels][PLAIN
    values] in one data page (reference column/writer/mod.rs
    write_mini_batch with levels)."""
    phys, _ = _physical(leaf.dtype)
    codec = _CODEC_NAMES[props.compression]
    blocks = b""
    if leaf.max_rep > 0:
        rl = rle_encode(leaf.rep_levels.astype(np.int64),
                        _bit_width(leaf.max_rep))
        blocks += struct.pack("<i", len(rl)) + rl
    if leaf.max_def > 0:
        dl = rle_encode(leaf.def_levels.astype(np.int64),
                        _bit_width(leaf.max_def))
        blocks += struct.pack("<i", len(dl)) + dl
    if isinstance(leaf.values, list):
        payload = b"".join(struct.pack("<i", len(b)) + bytes(b)
                           for b in leaf.values)
    else:
        payload = _plain_encode(np.asarray(leaf.values), phys)
    n_entries = leaf.num_entries
    body = blocks + payload
    meta = _emit_pages(out, [("data", body, n_entries, E_PLAIN, 0)], codec,
                       crypt, rg_idx, col_ord)
    meta.update({"bloom": None,
                 "num_nulls": int((leaf.def_levels < leaf.max_def).sum()),
                 "type": phys, "encodings": [E_RLE, E_PLAIN], "codec": codec,
                 "num_values": n_entries, "statistics": None})
    return meta


def _decode_dict(c: col.DictionaryColumn) -> col.Column:
    from ..ops.cast import dictionary_decode

    return dictionary_decode(c)


def _page_header_data(uncomp: int, comp: int, nvals: int,
                      encoding: int) -> bytes:
    w = thrift.Writer()
    w.struct_begin()
    w.field_i32(1, 0)  # DATA_PAGE
    w.field_i32(2, uncomp)
    w.field_i32(3, comp)
    w.field_struct(5)
    w.struct_begin()
    w.field_i32(1, nvals)
    w.field_i32(2, encoding)
    w.field_i32(3, E_RLE)  # definition level encoding
    w.field_i32(4, E_RLE)  # repetition level encoding
    w.struct_end()
    w.struct_end()
    return w.bytes()


def _page_header_dict(uncomp: int, comp: int, nvals: int) -> bytes:
    w = thrift.Writer()
    w.struct_begin()
    w.field_i32(1, 2)  # DICTIONARY_PAGE
    w.field_i32(2, uncomp)
    w.field_i32(3, comp)
    w.field_struct(7)
    w.struct_begin()
    w.field_i32(1, nvals)
    w.field_i32(2, E_PLAIN)
    w.struct_end()
    w.struct_end()
    return w.bytes()


def _stats_bytes(v, phys: int) -> bytes:
    if phys == P_I32:
        return struct.pack("<i", int(v))
    if phys == P_I64:
        return struct.pack("<q", int(v))
    if phys == P_FLOAT:
        return struct.pack("<f", float(v))
    return struct.pack("<d", float(v))


def write_parquet(batches, sink=None,
                  props: WriterProperties = None) -> Optional[bytes]:
    """One row group a batch (reference ArrowWriter,
    arrow/arrow_writer/mod.rs:182; callers slice the batches to the row
    group size).  -> the file's bytes, or None when written to `sink`."""
    from .geospatial import compute_statistics, geo_annotation
    from .parquet_nested import is_nested, shred_column

    props = props or WriterProperties()
    if isinstance(batches, bt.RecordBatch):
        batches = [batches]
    schema = batches[0].schema
    own = sink is None
    if own:
        sink = _Pieces()
    encryptor = None
    if props.encryption is not None:
        from . import parquet_crypto as pcx

        encryptor = pcx.FileEncryptor(props.encryption)
        if props.write_page_index or props.bloom_filter_columns:
            raise st.ArrowTpuError(
                "parquet encryption: page index / bloom filter module "
                "encryption not implemented; disable those writer options")
        sink.write(pcx.MAGIC_ENCRYPTED)
    else:
        sink.write(MAGIC)
    row_groups = []
    for rg_idx, batch in enumerate(batches):
        cols_meta = []
        col_ord = 0
        for f, c in zip(schema.fields, batch.columns):
            if is_nested(f.dtype):
                chunks = [(leaf.path, leaf)
                          for leaf in shred_column(f.name, c, f.nullable)]
            else:
                chunks = [([f.name], None)]
            for path, leaf in chunks:
                path_str = ".".join(path)
                key = encryptor.column_key(path_str) if encryptor else None
                crypt = (encryptor, key) if key is not None else None
                if leaf is not None:
                    meta = _write_leaf_chunk(sink, leaf, props, crypt,
                                             rg_idx, col_ord)
                    meta["file_offset"] = meta["data_page_offset"]
                else:
                    meta = _write_column(sink, c, f.dtype, props, f.nullable,
                                         f.name, crypt, rg_idx, col_ord)
                    meta["file_offset"] = (meta["dictionary_page_offset"]
                                           or meta["data_page_offset"])
                    if geo_annotation(f) is not None:
                        # a WKB bounding box and type set replace min / max
                        # (unordered, by the spec)
                        meta["geo_stats"] = compute_statistics(c.to_pylist())
                        meta["statistics"] = None
                meta["path"] = path
                meta["crypto"] = (encryptor.column_crypto_fields(path_str)
                                  if key is not None else None)
                cols_meta.append(meta)
                col_ord += 1
        row_groups.append({
            "columns": cols_meta,
            "total_byte_size": sum(m["total_uncompressed_size"]
                                   for m in cols_meta),
            "num_rows": int(batch.length)})
    # bloom filters after the row groups' data (reference file/writer.rs;
    # offsets in ColumnMetaData 14 / 15)
    for rg in row_groups:
        for m in rg["columns"]:
            if m["bloom"] is not None:
                from . import parquet_ext as px

                count, hashes = m["bloom"]
                sbbf = px.Sbbf.with_ndv_fpp(count, props.bloom_filter_fpp)
                sbbf.insert_hashes(hashes)
                blob = sbbf.to_bytes()
                m["bloom_filter_offset"] = sink.tell()
                m["bloom_filter_length"] = len(blob)
                sink.write(blob)
    # page indexes between the data and the footer (reference
    # file/page_index/)
    if props.write_page_index:
        from . import parquet_ext as px

        for rg in row_groups:
            for m in rg["columns"]:
                pages = m.get("page_stats") or [_chunk_page_stats(m)
                                                for _ in m["page_locations"]]
                blob = px.write_column_index(pages)
                m["column_index_offset"] = sink.tell()
                m["column_index_length"] = len(blob)
                sink.write(blob)
        for rg in row_groups:
            for m in rg["columns"]:
                blob = px.write_offset_index(m["page_locations"])
                m["offset_index_offset"] = sink.tell()
                m["offset_index_length"] = len(blob)
                sink.write(blob)
    meta = _file_metadata(schema, row_groups, props, encryptor)
    if encryptor is not None:
        from . import parquet_crypto as pcx

        fcm = encryptor.file_crypto_metadata()
        enc_footer = pcx.encrypt_module(
            props.encryption.footer_key,
            pcx.module_aad(encryptor.file_aad, pcx.M_FOOTER), meta)
        sink.write(fcm)
        sink.write(enc_footer)
        sink.write(struct.pack("<i", len(fcm) + len(enc_footer)))
        sink.write(pcx.MAGIC_ENCRYPTED)
    else:
        sink.write(meta)
        sink.write(struct.pack("<i", len(meta)))
        sink.write(MAGIC)
    return sink.getvalue() if own else None


class _Pieces(list):
    """The writer's own sink: every piece kept as written (no copy, no
    regrown buffer), with its position; joined once at the end."""

    def __init__(self):
        super().__init__()
        self.pos = 0

    def write(self, b) -> None:
        self.append(b)
        self.pos += len(b)

    def tell(self) -> int:
        return self.pos

    def getvalue(self) -> bytes:
        return b"".join(self)


def _chunk_page_stats(m) -> dict:
    """A chunk's statistics as one page's column-index entry (nested
    leaves, which keep no page statistics)."""
    s = m["statistics"]
    have = s is not None and s[0] is not None
    return {"null_page": m["num_values"] == m["num_nulls"],
            "min": _stats_bytes(s[0], m["type"]) if have else b"",
            "max": _stats_bytes(s[1], m["type"]) if have else b"",
            "null_count": m["num_nulls"]}


def _column_meta_thrift(m) -> bytes:
    """One ColumnMetaData struct (its own writer, so it can be inlined or
    encrypted into ColumnChunk field 9)."""
    w = thrift.Writer()
    w.struct_begin()
    w.field_i32(1, m["type"])
    w.field_list(2, thrift.CT_I32, len(m["encodings"]))
    for e in m["encodings"]:
        w.elem_i32(e)
    w.field_list(3, thrift.CT_BINARY, len(m["path"]))
    for p_ in m["path"]:
        w.elem_string(p_)
    w.field_i32(4, m["codec"])
    w.field_i64(5, m["num_values"])
    w.field_i64(6, m["total_uncompressed_size"])
    w.field_i64(7, m["total_compressed_size"])
    w.field_i64(9, m["data_page_offset"])
    if m["dictionary_page_offset"] is not None:
        w.field_i64(11, m["dictionary_page_offset"])
    if m["statistics"] is not None:
        mn, mx, nulls, phys = m["statistics"]
        w.field_struct(12)
        w.struct_begin()
        w.field_i64(3, nulls)
        if mn is not None:
            w.field_binary(5, _stats_bytes(mx, phys))  # max_value
            w.field_binary(6, _stats_bytes(mn, phys))  # min_value
        w.struct_end()
    if m.get("bloom_filter_offset") is not None:
        w.field_i64(14, m["bloom_filter_offset"])
        w.field_i32(15, m["bloom_filter_length"])
    if m.get("geo_stats") is not None:
        from .geospatial import write_geo_stats_thrift

        w.field_struct(17)  # GeospatialStatistics
        write_geo_stats_thrift(w, m["geo_stats"])
    w.struct_end()
    return w.bytes()


def _file_metadata(schema: st.Schema, row_groups, props: WriterProperties,
                   encryptor=None) -> bytes:
    from .geospatial import geo_annotation
    from ..extension import EXTENSION_NAME_KEY
    from .parquet_nested import (count_schema_elements, leaf_count,
                                 write_schema_elements)

    w = thrift.Writer()
    w.struct_begin()
    w.field_i32(1, 2)  # version
    # schema elements: the root group, then each field's subtree
    total_elems = 1 + sum(count_schema_elements(f.dtype)
                          for f in schema.fields)
    w.field_list(2, thrift.CT_STRUCT, total_elems)
    w.struct_begin()  # root
    w.field_string(4, "schema")
    w.field_i32(5, len(schema.fields))
    w.struct_end()
    for f in schema.fields:
        ext = dict(f.metadata).get(EXTENSION_NAME_KEY)
        logical = ("variant" if ext == "arrow.parquet.variant"
                   else geo_annotation(f))
        write_schema_elements(w, f.name, f.dtype, f.nullable,
                              logical=logical)
    w.field_i64(3, sum(rg["num_rows"] for rg in row_groups))
    w.field_list(4, thrift.CT_STRUCT, len(row_groups))
    for rg_idx, rg in enumerate(row_groups):
        w.struct_begin()
        w.field_list(1, thrift.CT_STRUCT, len(rg["columns"]))
        for col_ord, m in enumerate(rg["columns"]):
            w.struct_begin()  # ColumnChunk
            w.field_i64(2, m["file_offset"])
            cm_bytes = _column_meta_thrift(m)
            crypto = m.get("crypto")
            if crypto is None or crypto[0] == 1:
                # plaintext, or the footer key: the metadata stays inline
                w.field_struct(3)
                w.raw(cm_bytes)
            if crypto is not None:
                member, path_list, key_meta = crypto
                w.field_struct(8)  # crypto_metadata union
                w.struct_begin()
                w.field_struct(member)
                w.struct_begin()
                if member == 2:
                    w.field_list(1, thrift.CT_BINARY, len(path_list))
                    for p in path_list:
                        w.elem_string(p)
                    if key_meta:
                        w.field_binary(2, key_meta)
                w.struct_end()
                w.struct_end()
                if member == 2:
                    from . import parquet_crypto as pcx

                    key = props.encryption.column_keys[".".join(path_list)]
                    aad = pcx.module_aad(encryptor.file_aad,
                                         pcx.M_COLUMN_METADATA, rg_idx,
                                         col_ord)
                    w.field_binary(9, pcx.encrypt_module(key, aad, cm_bytes))
            if m.get("offset_index_offset") is not None:
                w.field_i64(4, m["offset_index_offset"])
                w.field_i32(5, m["offset_index_length"])
            if m.get("column_index_offset") is not None:
                w.field_i64(6, m["column_index_offset"])
                w.field_i32(7, m["column_index_length"])
            w.struct_end()
        w.field_i64(2, rg["total_byte_size"])
        w.field_i64(3, rg["num_rows"])
        if encryptor is not None:
            # RowGroup.ordinal (field 7, i16): parquet-cpp derives module
            # AADs from the stored ordinal
            w.field_i16(7, rg_idx)
        w.struct_end()
    w.field_string(6, props.created_by)
    # column_orders: TYPE_ORDER per leaf; without it readers must ignore
    # min_value / max_value (parquet.thrift ColumnOrder)
    n_leaves = sum(leaf_count(f.dtype) for f in schema.fields)
    w.field_list(7, thrift.CT_STRUCT, n_leaves)
    for _ in range(n_leaves):
        w.struct_begin()
        w.field_struct(1)  # TYPE_ORDER (empty struct union member)
        w.struct_begin()
        w.struct_end()
        w.struct_end()
    w.struct_end()
    return w.bytes()


# ---------------------------------------------------------------------------
# reader (reference file/serialized_reader.rs + arrow_reader)
# ---------------------------------------------------------------------------


def decode_stat(b, phys: int):
    """A statistic's bytes as a value of its physical type (bytes for
    byte arrays; None for absent)."""
    if b is None or len(b) == 0:
        return None
    fmt = {P_I32: "<i", P_I64: "<q", P_FLOAT: "<f", P_DOUBLE: "<d"}.get(phys)
    return bytes(b) if fmt is None else struct.unpack(fmt, bytes(b))[0]


def _field_stats(m: Dict[int, Any], phys: int):
    s = m.get(12)
    if not s:
        return None
    return {"null_count": s.get(3),
            "max": decode_stat(s.get(5) if 5 in s else s.get(1), phys),
            "min": decode_stat(s.get(6) if 6 in s else s.get(2), phys)}


@dataclasses.dataclass
class ChunkData:
    """A column chunk decoded on the host: each data page's values (an
    array, or a list of bytes) and the rows' valid bools."""

    values: list
    valid: np.ndarray


class ParquetFile:
    """A footer-parsed file (reference ParquetMetaData) whose
    columns are built on `device` (None: the card)."""

    def __init__(self, source, decryption=None, device=None):
        buf = source.read() if hasattr(source, "read") else source
        if isinstance(buf, str):
            with open(buf, "rb") as fh:
                buf = fh.read()
        self.device = resolve_device(device)
        self.buf = buf
        self._decryptor = None
        if self.buf[:4] == b"PARE" and self.buf[-4:] == b"PARE":
            # encrypted footer mode (parquet modular encryption)
            from . import parquet_crypto as pcx

            if decryption is None:
                raise st.ArrowTpuError(
                    "encrypted parquet file: pass decryption="
                    "FileDecryptionProperties(...)")
            footer = self._footer()
            r = thrift.Reader(footer)
            fcm = r.read_struct()
            dec = pcx.FileDecryptor(fcm[1], bytes(fcm.get(2, b"")),
                                    decryption)
            aad = pcx.module_aad(dec.file_aad, pcx.M_FOOTER)
            pt, _ = pcx.decrypt_module(dec.footer_key, aad, footer, r.pos)
            meta = thrift.Reader(pt).read_struct()
            self._decryptor = dec
        elif self.buf[:4] != MAGIC or self.buf[-4:] != MAGIC:
            raise st.ArrowTpuError("not a parquet file (bad magic)")
        else:
            meta = thrift.Reader(self._footer()).read_struct()
            if 8 in meta and decryption is not None:
                # plaintext footer mode: the algorithm is FileMetaData
                # field 8 (the footer's signature is not verified)
                from . import parquet_crypto as pcx

                self._decryptor = pcx.FileDecryptor(
                    meta[8], bytes(meta.get(9, b"")), decryption)
        self._meta = meta
        self.num_rows = meta[3]
        cb = meta.get(6)
        self.created_by = (bytes(cb).decode("utf-8", "replace")
                           if isinstance(cb, (bytes, bytearray, memoryview))
                           else "")
        from .parquet_nested import parse_schema_tree

        elems = meta[2]
        fields = []
        self._leaf_info = []        # (max_def, max_rep, dtype, nullable, tl)
        self._field_leaf_start = []  # first leaf index per field
        i = 1
        while i < len(elems):
            fld, i, leaves = parse_schema_tree(elems, i)
            self._field_leaf_start.append(len(self._leaf_info))
            self._leaf_info.extend(leaves)
            fields.append(fld)
        self.schema = st.Schema(tuple(fields))
        self.row_groups = meta[4]
        if self._decryptor is not None:
            for rg_i, rg in enumerate(self.row_groups):
                for col_i, chunk in enumerate(rg[1]):
                    self._decryptor.register_chunk(rg_i, col_i, chunk)

    @property
    def buf(self):
        return self._buf

    @buf.setter
    def buf(self, value):
        """The file's bytes; pages are read through a memoryview of them
        (no copy a page)."""
        self._buf = value
        self._view = memoryview(value)

    def _footer(self):
        n = len(self._view)
        (meta_len,) = struct.unpack_from("<i", self._view, n - 8)
        return self._view[n - 8 - meta_len:n - 8]

    def _leaf_idx(self, column: str) -> int:
        return self._field_leaf_start[self.schema.index_of(column)]

    def _chunk_meta(self, rg: int, column: str):
        return self.row_groups[rg][1][self._leaf_idx(column)][3]

    def statistics(self, rg: int, column: str):
        """Row-group statistics as a dict (reference StatisticsConverter,
        arrow_reader/statistics.rs)."""
        cm = self._chunk_meta(rg, column)
        return _field_stats(cm, cm[1])

    def geo_statistics(self, rg: int, column: str):
        """A GEOMETRY / GEOGRAPHY chunk's GeospatialStatistics
        (ColumnMetaData field 17), or None."""
        d = self._chunk_meta(rg, column).get(17)
        if d is None:
            return None
        from .geospatial import parse_geo_stats

        return parse_geo_stats(d)

    def bloom_filter(self, rg: int, column: str):
        """The column chunk's SBBF, or None (reference bloom_filter/mod.rs
        read path)."""
        off = self._chunk_meta(rg, column).get(14)
        if off is None:
            return None
        from . import parquet_ext as px

        return px.Sbbf.from_buffer(self._view, off)

    def bloom_might_contain(self, rg: int, column: str, value) -> bool:
        """Pruning check: False means the value is definitely absent."""
        sbbf = self.bloom_filter(rg, column)
        if sbbf is None:
            return True
        from . import parquet_ext as px

        if isinstance(value, str):
            value = value.encode("utf-8")
        vals = [value] if isinstance(value, bytes) else np.asarray([value])
        h = px.hash_column_values(vals, self._chunk_meta(rg, column)[1])
        return bool(sbbf.check_hashes(h)[0])

    def column_index(self, rg: int, column: str):
        """Per-page min / max / null statistics (reference page_index)."""
        chunk = self.row_groups[rg][1][self._leaf_idx(column)]
        if 6 not in chunk:
            return None
        from . import parquet_ext as px

        return px.read_column_index(self._view, chunk[6], chunk[7])

    def offset_index(self, rg: int, column: str):
        """Per-page (offset, compressed_size, first_row_index)."""
        chunk = self.row_groups[rg][1][self._leaf_idx(column)]
        if 4 not in chunk:
            return None
        from . import parquet_ext as px

        return px.read_offset_index(self._view, chunk[4], chunk[5])

    def read_row_group(self, rg_idx: int, columns: Optional[List[str]] = None
                       ) -> bt.RecordBatch:
        from .parquet_nested import LeafData, assemble_column, is_nested, \
            leaf_count

        rg = self.row_groups[rg_idx]
        num_rows = rg[3]
        cols, fields = [], []
        for name in columns or self.schema.names:
            fi = self.schema.index_of(name)
            field = self.schema.fields[fi]
            start = self._field_leaf_start[fi]
            if not is_nested(field.dtype):
                data = self.decode_chunk(rg_idx, start, field.nullable)
                cols.append(_assemble(data.values, data.valid,
                                      rg[1][start][3][1], field.dtype,
                                      num_rows, self.device))
            else:
                datas = []
                for k in range(leaf_count(field.dtype)):
                    md, mr, ldt, lnull, ltl = self._leaf_info[start + k]
                    defs, reps, values = self._read_chunk_levels(
                        rg[1][start + k], md, mr, tl=ltl, rg_idx=rg_idx,
                        col_ord=start + k)
                    datas.append(LeafData(defs, reps, values, ldt, lnull, md))
                cols.append(assemble_column(field, datas, num_rows,
                                            self.device))
            fields.append(field)
        return bt.RecordBatch(st.Schema(tuple(fields)), equalize(cols))

    def read(self, columns: Optional[List[str]] = None) -> bt.RecordBatch:
        from ..ops.concat import concat_batches

        batches = [self.read_row_group(i, columns)
                   for i in range(len(self.row_groups))]
        return batches[0] if len(batches) == 1 else concat_batches(batches)

    def _read_page(self, pos: int, key, rg_idx: int, col_ord: int,
                   is_dict: bool, data_ord):
        """One page's (header struct, compressed body, next position),
        through the modular-encryption framing (header and body as
        separate GCM modules) when `key` is set."""
        if key is not None:
            from . import parquet_crypto as pcx

            dec = self._decryptor
            hm = (pcx.M_DICTIONARY_PAGE_HEADER if is_dict
                  else pcx.M_DATA_PAGE_HEADER)
            pm = pcx.M_DICTIONARY_PAGE if is_dict else pcx.M_DATA_PAGE
            po = None if is_dict else data_ord
            hdr_pt, pos = pcx.decrypt_module(
                key, pcx.module_aad(dec.file_aad, hm, rg_idx, col_ord, po),
                self._view, pos)
            hdr = thrift.Reader(hdr_pt).read_struct()
            body, pos = pcx.decrypt_module(
                key, pcx.module_aad(dec.file_aad, pm, rg_idx, col_ord, po),
                self._view, pos)
            return hdr, body, pos
        r = thrift.Reader(self._view, pos)
        hdr = r.read_struct()
        return hdr, self._view[r.pos:r.pos + hdr[3]], r.pos + hdr[3]

    def _pages(self, cm, rg_idx: int, col_ord: int, tl):
        """A chunk's data pages in order: (header, decompressed body,
        dictionary so far)."""
        codec, remaining = cm[4], cm[5]
        pos = cm.get(11, cm[9])  # the dictionary page first if present
        key = (self._decryptor.page_key(rg_idx, col_ord)
               if self._decryptor is not None else None)
        first, has_dict, data_ord = True, 11 in cm, 0
        dictionary = None
        while remaining > 0:
            hdr, comp_body, pos = self._read_page(
                pos, key, rg_idx, col_ord, first and has_dict, data_ord)
            first = False
            body = _decompress(codec, comp_body, hdr[2])
            if hdr[1] == 2:  # dictionary
                dictionary = self._decode_dict_page(body, cm[1], hdr[7][1],
                                                    tl=tl)
                continue
            data_ord += 1
            if hdr[1] != 0:
                raise st.ArrowTpuError(
                    f"parquet: unsupported page type {hdr[1]}")
            yield hdr, body, dictionary
            remaining -= hdr[5][1]

    def decode_chunk(self, rg_idx: int, leaf: int, nullable: bool
                     ) -> ChunkData:
        """A flat column chunk's pages decoded on the host."""
        cm = self.row_groups[rg_idx][1][leaf][3]
        tl = self._leaf_info[leaf][4]
        values, valid_parts = [], []
        for hdr, body, dictionary in self._pages(cm, rg_idx, leaf, tl):
            nvals = hdr[5][1]
            vals, defs, _ = self._decode_data_page(
                body, cm[1], hdr[5][2], nvals, dictionary,
                1 if nullable else 0, 0, tl=tl)
            values.append(vals)
            valid_parts.append(defs == 1 if defs is not None
                               else np.ones(nvals, bool))
        return ChunkData(values, np.concatenate(valid_parts) if valid_parts
                         else np.zeros(0, bool))

    def _read_chunk_levels(self, chunk: Dict[int, Any], max_def: int,
                           max_rep: int, tl: Optional[int] = None,
                           rg_idx: int = 0, col_ord: int = 0):
        """A nested leaf's (def_levels, rep_levels, values), concatenated
        over its pages."""
        cm = chunk[3]
        values, defs_parts, reps_parts = [], [], []
        for hdr, body, dictionary in self._pages(cm, rg_idx, col_ord, tl):
            nvals = hdr[5][1]
            vals, defs, reps = self._decode_data_page(
                body, cm[1], hdr[5][2], nvals, dictionary, max_def, max_rep,
                tl=tl)
            values.append(vals)
            defs_parts.append(defs if defs is not None
                              else np.zeros(nvals, np.int32))
            reps_parts.append(reps if reps is not None
                              else np.zeros(nvals, np.int32))
        defs = (np.concatenate(defs_parts) if defs_parts
                else np.zeros(0, np.int32))
        reps = (np.concatenate(reps_parts) if reps_parts
                else np.zeros(0, np.int32))
        if values and isinstance(values[0], list):
            vals = [v for page in values for v in page]
        else:
            vals = np.concatenate(values) if values else np.zeros(0)
        return defs.astype(np.int32), reps.astype(np.int32), vals

    def _decode_dict_page(self, body, phys: int, encoding: int,
                          tl: Optional[int] = None):
        if phys == P_FLBA:
            n = len(body) // tl
            return np.frombuffer(body, np.uint8, count=n * tl).reshape(n, tl)
        if phys == P_BYTES:
            return _plain_byte_arrays(body, None)
        return np.frombuffer(body, dtype=_NP_PHYS[phys])

    def _decode_data_page(self, body, phys: int, enc: int, nvals: int,
                          dictionary, max_def: int, max_rep: int,
                          tl: Optional[int] = None):
        """-> (values, def_levels | None, rep_levels | None).  Data page
        v1 framing: [rep RLE][def RLE][values], each level block a 4-byte
        length + RLE / bit-packed hybrid, present iff its max level > 0
        (reference column/reader.rs:429 + encodings/rle.rs)."""
        pos = 0
        reps = defs = None
        if max_rep > 0:
            (rl_len,) = struct.unpack_from("<i", body, pos)
            reps = rle_decode(body[pos + 4:pos + 4 + rl_len],
                              _bit_width(max_rep), nvals)
            pos += 4 + rl_len
        if max_def > 0:
            (dl_len,) = struct.unpack_from("<i", body, pos)
            defs = rle_decode(body[pos + 4:pos + 4 + dl_len],
                              _bit_width(max_def), nvals)
            pos += 4 + dl_len
        payload = body[pos:]
        n_non_null = (int((defs == max_def).sum()) if defs is not None
                      else nvals)
        if enc in (E_RLE_DICT, E_PLAIN_DICT):
            codes = rle_decode(payload[1:], payload[0], n_non_null)
            if isinstance(dictionary, list):
                return [dictionary[c] for c in codes.tolist()], defs, reps
            return dictionary[codes], defs, reps
        if enc == E_DELTA_BINARY_PACKED:
            from . import parquet_ext as px

            vals, _ = px.delta_binary_packed_decode(bytes(payload),
                                                    count=n_non_null)
            return vals.astype({P_I32: np.int32, P_I64: np.int64}[phys]), \
                defs, reps
        if enc == E_DELTA_LENGTH_BYTE_ARRAY:
            from . import parquet_ext as px

            return px.delta_length_byte_array_decode(
                bytes(payload), n_non_null), defs, reps
        if enc == E_BYTE_STREAM_SPLIT:
            from . import parquet_ext as px

            return px.byte_stream_split_decode(
                bytes(payload), _NP_PHYS[phys], n_non_null), defs, reps
        if enc != E_PLAIN:
            raise st.ArrowTpuError(f"parquet: unsupported encoding {enc}")
        if phys == P_BOOL:
            bits = np.unpackbits(
                np.frombuffer(payload, np.uint8, count=(n_non_null + 7) // 8),
                bitorder="little")[:n_non_null].astype(bool)
            return bits, defs, reps
        if phys == P_BYTES:
            return _plain_byte_arrays(payload, n_non_null), defs, reps
        if phys == P_FLBA:
            vals = np.frombuffer(payload, np.uint8, count=n_non_null * tl
                                 ).reshape(n_non_null, tl)
            return vals, defs, reps
        return np.frombuffer(payload, dtype=_NP_PHYS[phys],
                             count=n_non_null), defs, reps


def _plain_byte_arrays(buf, count: Optional[int]) -> list:
    """PLAIN byte arrays (4-byte LE length, then the bytes) as views of
    `buf`: `count` of them, or as many as the buffer holds."""
    view = memoryview(buf)
    out = []
    pos, end = 0, len(view)
    while (pos < end) if count is None else (len(out) < count):
        (ln,) = struct.unpack_from("<i", view, pos)
        out.append(view[pos + 4:pos + 4 + ln])
        pos += 4 + ln
    return out


def byte_arrays_column(values: list, valid: np.ndarray, dt: st.DataType,
                       device) -> col.StringViewColumn:
    """Byte strings (those of the valid rows, in order) as a string view
    column: their bytes joined into the arena with one host-to-device
    copy, a null row's string empty."""
    n = len(valid)
    lens = np.fromiter((len(b) for b in values), np.int64, len(values))
    row_lens = np.zeros(n, np.int64)
    row_lens[valid] = lens
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(row_lens, out=offsets[1:])
    data = np.frombuffer(b"".join(values), np.uint8)
    return strings_from_offsets(offsets, data, None if valid.all() else valid,
                                dt, device)


def _assemble(values, valid: np.ndarray, phys: int, dt: st.DataType,
              num_rows: int, device) -> col.Column:
    """A chunk's decoded non-null values scattered back to their rows, as
    one column on `device` (one host-to-device copy a buffer)."""
    n = num_rows
    ok = None if valid.all() else valid
    if phys == P_BYTES or (values and isinstance(values[0], list)):
        flat = [v for page in values for v in page]
        return byte_arrays_column(flat, valid, dt, device)
    nl = st.decimal_limbs(dt)
    if nl is not None:
        vals = (np.concatenate(values, axis=0) if values
                else np.zeros((0, nl * 4), np.uint8))
        if vals.ndim == 2:  # FLBA big-endian bytes
            limbs_np = _flba_to_limbs(vals, nl)
        elif vals.dtype.itemsize == 4:
            limbs_np = vals.astype(np.int32).view(np.uint32).reshape(-1, 1)
        else:
            limbs_np = vals.astype(np.int64).view(np.uint32).reshape(-1, 2)
        full = np.zeros((n, nl), np.uint32)
        full[valid] = limbs_np if limbs_np.shape[1] == nl else np.pad(
            limbs_np, ((0, 0), (0, nl - limbs_np.shape[1])))
        return col.primitive(full, dt, validity=ok, device=device)
    vals = (values[0] if len(values) == 1 else np.concatenate(values)
            if values else np.zeros(0))
    if ok is not None or len(vals) != n:
        full = np.zeros(n, vals.dtype)
        full[valid] = vals
        vals = full
    if phys == P_BOOL:
        return col.boolean(vals.astype(bool), validity=ok, length=n,
                           device=device)
    cap = round_up(max(n, 1))
    host = np.zeros(cap, col.numpy_dtype(dt))
    host[:n] = vals
    return col.primitive(host, dt, validity=ok, length=n, device=device)


def equalize(cols) -> tuple:
    """A batch's columns at one capacity (they share the length)."""
    cap = max((c.capacity for c in cols), default=0)
    return tuple(grow(c, cap) for c in cols)


def read_parquet(source, columns: Optional[List[str]] = None, *,
                 validate: bool = False, decryption=None,
                 device=None) -> bt.RecordBatch:
    """The file's rows (the `columns` given, else all) on `device`;
    validate=True runs core/validate.check_batch on them."""
    out = ParquetFile(source, decryption=decryption, device=device).read(
        columns)
    if validate:
        from ..core.validate import check_batch

        check_batch(out)
    return out
