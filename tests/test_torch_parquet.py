"""arrowtpu_torch.formats.parquet, parquet_ext, parquet_cdc and
parquet_crypto against arrowtpu.formats and pyarrow, and ROADMAP C.3 fault
17 in the port's layout.

Tolerance: exact.  The port's writer gives the JAX writer's bytes for the
same batch and WriterProperties (plain, dictionary and its fallback, each
delta encoding, BYTE_STREAM_SPLIT, page index, bloom filter, GZIP, ZSTD,
content-defined pages); both packages read those bytes and pyarrow's to
the same columns (values, validity as bools, length, zero padding,
`tp.assert_batch_equal`), and pyarrow reads them to the source table.
Encrypted files carry `os.urandom` nonces, so they are compared by what
each package (and pyarrow) decrypts from the other's.  Every input is
drawn from a seed with numpy.
"""

import base64
import io
import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

import torch_parity as tp
from torch_parity import release_jax_caches  # noqa: F401
from arrowtpu.core import validate as jval
from arrowtpu.formats import layout as jlayout
from arrowtpu.formats import parquet as jpq
from arrowtpu.formats import parquet_cdc as jcdc
from arrowtpu.formats import parquet_crypto as jcx
from arrowtpu.formats import parquet_ext as jpx
from arrowtpu.interop import pyarrow_bridge as jpb

from arrowtpu_torch import native
from arrowtpu_torch import schema as ps
from arrowtpu_torch.core import validate as pval
from arrowtpu_torch.formats import layout as playout
from arrowtpu_torch.formats import parquet as ppq
from arrowtpu_torch.formats import parquet_cdc as pcdc
from arrowtpu_torch.formats import parquet_crypto as pcx
from arrowtpu_torch.formats import parquet_ext as ppx
from arrowtpu_torch.interop import pyarrow_bridge as ppb

N = 1000


def _table(seed: int, n: int = N) -> pa.Table:
    """Every flat type the writer maps, nulls in most columns."""
    rng = np.random.default_rng(seed)

    def nulls(p):
        return rng.random(n) < p

    words = np.array(["", "a", "bb", "word", "twelve bytes", "a string "
                      "longer than twelve bytes"] + [f"w{i}" for i in
                                                     range(40)])
    s = words[rng.integers(0, len(words), n)]
    return pa.table({
        "i64": pa.array(rng.integers(-2**40, 2**40, n), pa.int64(),
                        mask=nulls(0.1)),
        "i32": pa.array(rng.integers(-1000, 1000, n).astype(np.int32)),
        "u64": pa.array(rng.integers(0, 2**62, n).astype(np.uint64)),
        "f64": pa.array(rng.standard_normal(n), mask=nulls(0.1)),
        "f32": pa.array(rng.standard_normal(n).astype(np.float32)),
        "b": pa.array(rng.random(n) < 0.5, mask=nulls(0.1)),
        "s": pa.array(s, pa.utf8(), mask=nulls(0.1)),
        "bin": pa.array([x.encode() for x in s[::-1]], pa.binary()),
        "d": pa.array(rng.integers(-5000, 20000, n).astype(np.int32),
                      pa.date32(), mask=nulls(0.05)),
        "ts": pa.array(rng.integers(0, 2**50, n), pa.timestamp("us")),
        "dec": pa.array([None if k % 9 == 0 else int(v) for k, v in
                         enumerate(rng.integers(-10**12, 10**12, n))],
                        pa.decimal128(20, 2)),
        "dict": pa.array(words[rng.integers(0, 6, n)]).dictionary_encode(),
    })


def _pair(table: pa.Table, cuts=()):
    """The table's record batches (cut at `cuts`, one row group each) in
    both packages."""
    rb = table.combine_chunks().to_batches()[0]
    edges = [0, *cuts, rb.num_rows]
    parts = [rb.slice(a, b - a) for a, b in zip(edges, edges[1:])]
    return ([jpb.from_pyarrow(p) for p in parts],
            [ppb.from_pyarrow(p, device="cpu") for p in parts])


def _plain_values(table: pa.Table) -> dict:
    """What a Parquet round trip gives back: dictionaries decoded, and
    timestamps as their integers (the writer labels them
    TIMESTAMP_MICROS, which pyarrow reads as UTC)."""
    def plain(v):
        if pa.types.is_dictionary(v.type):
            return v.cast(v.type.value_type)
        if pa.types.is_timestamp(v.type):
            return v.cast(pa.int64())
        return v
    return {k: plain(v).to_pylist()
            for k, v in zip(table.column_names, table.columns)}


def _read_both(data, **kw):
    """Both packages' reads of `data`, held equal -> the port's as a
    pyarrow table."""
    j = jpq.read_parquet(data, **kw)
    p = ppq.read_parquet(data, device="cpu", **kw)
    tp.assert_batch_equal(j, p)
    return _as_table(p)


def _as_table(batch) -> pa.Table:
    return pa.Table.from_batches([ppb.to_pyarrow(batch)])


def _props(mod, case: str):
    """WriterProperties of a covered encoding / codec, in `mod`'s package."""
    kw = {
        "plain": dict(dictionary_enabled=False),
        "dictionary": dict(),
        "dictionary_fallback": dict(dictionary_page_size_limit=64),
        "delta_binary_packed": dict(column_encoding={
            "i64": "delta_binary_packed", "i32": "delta_binary_packed",
            "d": "delta_binary_packed"}),
        "delta_length_byte_array": dict(column_encoding={
            "s": "delta_length_byte_array",
            "bin": "delta_length_byte_array"}),
        "byte_stream_split": dict(column_encoding={
            "f64": "byte_stream_split", "f32": "byte_stream_split",
            "i64": "byte_stream_split"}),
        "page_index": dict(data_page_row_limit=96, write_page_index=True),
        "bloom_filter": dict(bloom_filter_columns=("i64", "s", "f32")),
        "gzip": dict(compression="gzip"),
        "zstd": dict(compression="zstd", dictionary_enabled=False),
        "cdc": dict(cdc_options=(jcdc if mod is jpq else pcdc).CdcOptions(
            min_chunk_size=256, max_chunk_size=1024),
            write_page_index=True),
    }[case]
    return mod.WriterProperties(**kw)


CASES = ["plain", "dictionary", "dictionary_fallback", "delta_binary_packed",
         "delta_length_byte_array", "byte_stream_split", "page_index",
         "bloom_filter", "gzip", "zstd", "cdc"]


@pytest.mark.parametrize("case", CASES)
def test_writer_bytes_equal_jax(case):
    """The same bytes as the JAX writer, two row groups; both packages
    read them to the same columns, and pyarrow to the source table."""
    table = _table(1)
    jb, pb = _pair(table, cuts=(600,))
    data = ppq.write_parquet(pb, props=_props(ppq, case))
    assert data == jpq.write_parquet(jb, props=_props(jpq, case))
    got = _read_both(data)
    assert _plain_values(got) == _plain_values(table)
    assert _plain_values(papq.read_table(io.BytesIO(data))) == \
        _plain_values(table)


def test_writer_to_sink_and_required_fields():
    """A sink and REQUIRED (non-nullable) fields: no definition levels."""
    rb = pa.record_batch({"x": pa.array(np.arange(300), pa.int64()),
                          "s": pa.array([f"r{i % 17}" for i in range(300)])},
                         schema=pa.schema([pa.field("x", pa.int64(), False),
                                           pa.field("s", pa.utf8(), False)]))
    jb, pb = jpb.from_pyarrow(rb), ppb.from_pyarrow(rb, device="cpu")
    sink = io.BytesIO()
    assert ppq.write_parquet(pb, sink) is None
    assert sink.getvalue() == jpq.write_parquet(jb)
    got = _read_both(sink.getvalue())
    assert [f.nullable for f in got.schema] == [False, False]
    with pytest.raises(ps.ArrowTpuError):
        ppq.write_parquet(ppb.from_pyarrow(pa.record_batch(
            {"x": pa.array([1, None])}, schema=pa.schema(
                [pa.field("x", pa.int64(), False)])), device="cpu"))


PYARROW_WRITES = {
    "none": dict(compression="none"),
    "gzip": dict(compression="gzip"),
    "zstd": dict(compression="zstd", data_page_size=2048),
    "dictionary_ints": dict(compression="none", use_dictionary=True),
    "delta_and_bss": dict(compression="none", use_dictionary=False,
                          column_encoding={
                              "i64": "DELTA_BINARY_PACKED",
                              "i32": "DELTA_BINARY_PACKED",
                              "s": "DELTA_LENGTH_BYTE_ARRAY",
                              "f64": "BYTE_STREAM_SPLIT",
                              "f32": "BYTE_STREAM_SPLIT"}),
}


@pytest.mark.parametrize("case", list(PYARROW_WRITES))
def test_reads_pyarrow_files(case):
    table = _table(2).drop(["dict", "u64"])
    sink = io.BytesIO()
    papq.write_table(table, sink, row_group_size=400,
                     **PYARROW_WRITES[case])
    got = _read_both(sink.getvalue())
    assert _plain_values(got) == _plain_values(table)


def test_projection_statistics_bloom_and_page_index():
    """ParquetFile's metadata readers against the JAX package's."""
    table = _table(3)
    jb, pb = _pair(table, cuts=(500,))
    kw = dict(data_page_row_limit=100, write_page_index=True,
              bloom_filter_columns=("i64", "s"))
    data = ppq.write_parquet(pb, props=ppq.WriterProperties(**kw))
    jf, pf = jpq.ParquetFile(data), ppq.ParquetFile(data, device="cpu")
    assert pf.schema.names == jf.schema.names and pf.num_rows == jf.num_rows
    for rg in range(2):
        for name in ("i64", "f64", "s", "d"):
            assert pf.statistics(rg, name) == jf.statistics(rg, name)
            assert pf.column_index(rg, name) == jf.column_index(rg, name)
            assert pf.offset_index(rg, name) == jf.offset_index(rg, name)
        for v in (table["i64"][7].as_py(), 12345, "word", "absent"):
            name = "s" if isinstance(v, str) else "i64"
            assert (pf.bloom_might_contain(rg, name, v)
                    == jf.bloom_might_contain(rg, name, v))
        tp.assert_batch_equal(jf.read_row_group(rg, ["s", "i64"]),
                              pf.read_row_group(rg, ["s", "i64"]))
    assert pf.bloom_might_contain(0, "i64", table["i64"][7].as_py())
    assert not pf.bloom_might_contain(0, "s", "absent")


def test_ext_codecs_against_jax():
    """XXH64, the SBBF, DELTA_BINARY_PACKED, DELTA_LENGTH_BYTE_ARRAY and
    BYTE_STREAM_SPLIT: the JAX package's values and bytes."""
    rng = np.random.default_rng(4)
    v64 = rng.integers(-2**63, 2**63 - 1, 3000, dtype=np.int64)
    v32 = v64.astype(np.int32)
    np.testing.assert_array_equal(ppx.xxh64_u64(v64.view(np.uint64)),
                                  jpx.xxh64_u64(v64.view(np.uint64)))
    np.testing.assert_array_equal(ppx.xxh64_u32(v32.view(np.uint32)),
                                  jpx.xxh64_u32(v32.view(np.uint32)))
    for blob in (b"", b"abc", bytes(range(7)), bytes(range(200)) * 3):
        assert ppx.xxh64_bytes(blob) == jpx.xxh64_bytes(blob)
    h = ppx.xxh64_u64(v64.view(np.uint64))
    ps_, js_ = ppx.Sbbf.with_ndv_fpp(3000, 0.01), jpx.Sbbf.with_ndv_fpp(
        3000, 0.01)
    ps_.insert_hashes(h)
    js_.insert_hashes(h)
    assert ps_.to_bytes() == js_.to_bytes()
    back = ppx.Sbbf.from_buffer(memoryview(b"xx" + ps_.to_bytes()), 2)
    assert back.check_hashes(h).all()
    for vals in (v64, np.cumsum(rng.integers(-3, 9, 1000)), v64[:1],
                 v64[:0]):
        enc = ppx.delta_binary_packed_encode(vals)
        assert enc == jpx.delta_binary_packed_encode(vals)
        np.testing.assert_array_equal(
            ppx.delta_binary_packed_decode(enc)[0], vals)
    blobs = [bytes(rng.integers(0, 256, k, dtype=np.uint8))
             for k in rng.integers(0, 30, 50)]
    enc = ppx.delta_length_byte_array_encode(blobs)
    assert enc == jpx.delta_length_byte_array_encode(blobs)
    assert ppx.delta_length_byte_array_decode(enc, len(blobs)) == blobs
    f32 = rng.standard_normal(777).astype(np.float32)
    enc = ppx.byte_stream_split_encode(f32)
    assert enc == jpx.byte_stream_split_encode(f32)
    np.testing.assert_array_equal(
        ppx.byte_stream_split_decode(enc, "<f4", 777), f32)
    levels = np.repeat(rng.integers(0, 4, 60), rng.integers(1, 40, 60))
    for bw in (2, 3):
        enc = ppq.rle_encode(levels, bw)
        assert enc == jpq.rle_encode(levels, bw)
        np.testing.assert_array_equal(ppq.rle_decode(enc, bw, len(levels)),
                                      levels)


def test_cdc_boundaries_against_jax():
    """The native gear tables and row boundaries equal the JAX package's;
    an edit re-chunks only near it."""
    np.testing.assert_array_equal(pcdc.gear_tables(), jcdc.gear_tables())
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes()
    row_off = np.arange(0, 200_001, 8, dtype=np.int64)
    levels = (rng.random(len(row_off) - 1) < 0.9).astype(np.uint8)
    opts = (pcdc.CdcOptions(2048, 8192), jcdc.CdcOptions(2048, 8192))
    for lv in (None, levels):
        got = pcdc.row_boundaries(data, row_off, lv, opts[0])
        np.testing.assert_array_equal(
            got, jcdc.row_boundaries(data, row_off, lv, opts[1]))
        assert got.sum() > 5
    assert pcdc.calculate_mask(256, 1024, 1) == jcdc.calculate_mask(
        256, 1024, 1)
    with pytest.raises(ps.ArrowTpuError):
        pcdc.calculate_mask(10, 5, 0)


def test_cdc_build_failure_raises(tmp_path, monkeypatch):
    """No Python fallback: a source that does not compile raises."""
    (tmp_path / "cdchunk.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", tmp_path)
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(native.NativeBuildError):
        pcdc.gear_tables()


# ---------------------------------------------------------------------------
# modular encryption
# ---------------------------------------------------------------------------

KF = b"0123456789012345"
KC = b"1234567890123456"
_MASTER = {"kf": KF, "kc": KC}


def _xor(raw: bytes, mid: str) -> bytes:
    k = _MASTER[mid]
    return bytes(a ^ b for a, b in zip(raw, (k * 2)[:len(raw)]))


def _km_json(dek, mid, footer):
    """Key material as pyarrow's KMS toolkit stores it (a toy XOR wrap)."""
    j = {"keyMaterialType": "PKMT1", "internalStorage": True,
         "isFooterKey": footer, "masterKeyID": mid,
         "wrappedDEK": base64.b64encode(_xor(dek, mid)).decode(),
         "doubleWrapping": False}
    if footer:
        j["kmsInstanceID"] = j["kmsInstanceURL"] = "DEFAULT"
    return json.dumps(j, separators=(",", ":")).encode()


def _retriever(km: bytes) -> bytes:
    j = json.loads(km)
    return _xor(base64.b64decode(j["wrappedDEK"]), j["masterKeyID"])


def _crypto_factory():
    import pyarrow.parquet.encryption as pe

    class ToyKms(pe.KmsClient):
        def __init__(self, config):
            super().__init__()

        def wrap_key(self, key_bytes, master_key_identifier):
            return base64.b64encode(_xor(key_bytes,
                                         master_key_identifier)).decode()

        def unwrap_key(self, wrapped_key, master_key_identifier):
            return _xor(base64.b64decode(wrapped_key), master_key_identifier)

    return pe, pe.CryptoFactory(lambda config: ToyKms(config))


def _enc_props(mod, mode: str):
    if mode == "uniform":
        return mod.FileEncryptionProperties(footer_key=KF, uniform=True)
    return mod.FileEncryptionProperties(
        footer_key=KF, column_keys={"i64": KC}, aad_prefix=b"tbl",
        store_aad_prefix=(mode == "column_keys"))


def _dec_props(mod, mode: str):
    return mod.FileDecryptionProperties(
        footer_key=KF, column_keys={"i64": KC},
        aad_prefix=b"tbl" if mode == "supplied_prefix" else None)


@pytest.mark.parametrize("mode", ["uniform", "column_keys",
                                  "supplied_prefix"])
def test_encrypted_files_cross_read(mode):
    """Each package decrypts the other's file to the same columns; a
    wrong key raises."""
    table = _table(6).select(["i64", "s", "f64", "dec"])
    jb, pb = _pair(table, cuts=(500,))
    cases = ((jpq, jcx, jb), (ppq, pcx, pb))
    files = [mod.write_parquet(b, props=mod.WriterProperties(
        encryption=_enc_props(cx, mode), compression="gzip"))
        for mod, cx, b in cases]
    assert files[0] != files[1]  # os.urandom nonces and file AAD
    for data in files:
        j = jpq.read_parquet(data, decryption=_dec_props(jcx, mode))
        p = ppq.read_parquet(data, decryption=_dec_props(pcx, mode),
                             device="cpu")
        tp.assert_batch_equal(j, p)
        assert _plain_values(_as_table(p)) == _plain_values(table)
    with pytest.raises(ps.ArrowTpuError):
        ppq.read_parquet(files[0], device="cpu",
                         decryption=pcx.FileDecryptionProperties(
                             footer_key=KC, column_keys={"i64": KF}))
    with pytest.raises(ps.ArrowTpuError):
        ppq.read_parquet(files[1], device="cpu")
    with pytest.raises(ps.ArrowTpuError):
        ppq.write_parquet(pb, props=ppq.WriterProperties(
            encryption=_enc_props(pcx, mode), write_page_index=True))


def test_encrypted_files_with_pyarrow(tmp_path):
    """pyarrow reads the port's encrypted file and the port reads
    pyarrow's, with column keys and a footer key through a toy KMS."""
    pe, factory = _crypto_factory()
    table = _table(7).select(["i64", "s", "f64"])
    _, (pb,) = _pair(table)
    dek_f, dek_a = os.urandom(16), os.urandom(16)
    fep = pcx.FileEncryptionProperties(
        footer_key=dek_f, column_keys={"i64": dek_a},
        footer_key_metadata=_km_json(dek_f, "kf", True),
        column_key_metadata={"i64": _km_json(dek_a, "kc", False)})
    path = str(tmp_path / "port.parquet")
    with open(path, "wb") as f:
        f.write(ppq.write_parquet([pb, pb], props=ppq.WriterProperties(
            encryption=fep, compression="zstd")))
    dp = factory.file_decryption_properties(pe.KmsConnectionConfig(),
                                            pe.DecryptionConfiguration())
    got = papq.ParquetFile(path, decryption_properties=dp).read()
    assert _plain_values(got) == {k: v * 2 for k, v in
                                  _plain_values(table).items()}
    for plaintext_footer in (False, True):
        enc_cfg = pe.EncryptionConfiguration(
            footer_key="kf", column_keys={"kc": ["i64"]},
            encryption_algorithm="AES_GCM_V1", double_wrapping=False,
            plaintext_footer=plaintext_footer)
        fep = factory.file_encryption_properties(pe.KmsConnectionConfig(),
                                                 enc_cfg)
        path = str(tmp_path / f"pa_{plaintext_footer}.parquet")
        with papq.ParquetWriter(path, table.schema, compression="ZSTD",
                                encryption_properties=fep) as w:
            w.write_table(table)
        got = ppq.read_parquet(path, device="cpu",
                               decryption=pcx.FileDecryptionProperties(
                                   key_retriever=_retriever))
        assert _plain_values(_as_table(got)) == _plain_values(table)


def test_module_aad_against_jax():
    for args in ((jcx.M_FOOTER,), (jcx.M_DATA_PAGE, 3, 5, 7),
                 (jcx.M_COLUMN_METADATA, 1, 2), (jcx.M_DICTIONARY_PAGE, 0, 9)):
        assert pcx.module_aad(b"fileaad", *args) == jcx.module_aad(
            b"fileaad", *args)
    with pytest.raises(ps.ArrowTpuError):
        pcx.module_aad(b"x", pcx.M_DATA_PAGE, 0, 0)


# ---------------------------------------------------------------------------
# ROADMAP C.3 fault 17: untrusted string offsets
# ---------------------------------------------------------------------------

BAD_OFFSETS = {
    # a 5-byte string running 3 bytes past 5 bytes of data: inline in a
    # view, so the views' flags never see it
    "past_the_data": ([0, 3, 8], b"abcde", "offsets_out_of_bounds"),
    "negative_start": ([-2, 1, 4], b"abcde", "offsets_out_of_bounds"),
    "decreasing": ([0, 4, 2, 5], b"abcde", "offsets_decreasing"),
}


def _nodes(offsets, data):
    n = len(offsets) - 1
    bufs = [np.zeros(0, np.uint8), np.asarray(offsets, np.int32).view(
        np.uint8), np.frombuffer(data, np.uint8)]
    return (jlayout.Node(n, 0, bufs, []), playout.Node(n, 0, bufs, []))


@pytest.mark.parametrize("case", list(BAD_OFFSETS))
def test_bad_string_offsets_raise_as_pyarrow(case):
    """pyarrow's full validation rejects the buffers, and so does the
    port's layout_to_column under validate=True; without it the column
    builds, and every validate_column flag equals the JAX package's on
    the same buffers (which flag nothing: the fault)."""
    offsets, data, flag = BAD_OFFSETS[case]
    with pytest.raises(pa.ArrowInvalid):
        pa.Array.from_buffers(pa.utf8(), len(offsets) - 1, [
            None, pa.py_buffer(np.asarray(offsets, np.int32).tobytes()),
            pa.py_buffer(data)]).validate(full=True)
    jn, pn = _nodes(offsets, data)
    with pytest.raises(ps.ValidationError, match=rf"s\.{flag}"):
        playout.layout_to_column(pn, ps.utf8, "cpu", validate=True, name="s")
    if case == "decreasing":
        return  # the JAX build takes a negative length here
    jflags = {k: bool(v) for k, v in jval.validate_column(
        jlayout.layout_to_column(jn, jpq.st.utf8)).items()}
    pflags = {k: bool(v) for k, v in pval.validate_column(
        playout.layout_to_column(pn, ps.utf8, "cpu")).items()}
    assert pflags == jflags and not any(pflags.values())


def test_string_offsets_in_bounds_pass_and_flags_equal():
    """Good offsets pass validate=True; a long string past the arena,
    built without it, sets the JAX package's flags in both (of a binary
    column: the port's UTF-8 check leaves out the rows already flagged out
    of bounds)."""
    jn, pn = _nodes([0, 3, 3, 20], bytes(range(97, 117)))
    col = playout.layout_to_column(pn, ps.utf8, "cpu", validate=True)
    assert col.to_pylist() == ["abc", "", "defghijklmnopqrst"]
    jn, pn = _nodes([0, 3, 200], bytes(range(97, 117)))
    jflags = {k: bool(v) for k, v in jval.validate_column(
        jlayout.layout_to_column(jn, jpq.st.binary)).items()}
    pflags = {k: bool(v) for k, v in pval.validate_column(
        playout.layout_to_column(pn, ps.binary, "cpu")).items()}
    assert pflags == jflags and pflags["view_out_of_bounds"]
