"""Parquet Modular Encryption (AES-GCM).

Counterpart of `arrowtpu/formats/parquet_crypto.py`, after the
reference's parquet/src/encryption/:
  * ciphers.rs:45, AES-GCM 128/256: an encrypted module is [4-byte LE
    length][12-byte nonce][ciphertext][16-byte tag], the length covering
    nonce, ciphertext and tag;
  * modules.rs, each module's AAD: file_aad || module_type(1) ||
    rg_ordinal(2 LE) || column_ordinal(2 LE) || page_ordinal(2 LE); the
    footer carries no ordinals, and only data pages and their headers a
    page ordinal;
  * decrypt.rs:351 FileDecryptionProperties / encrypt.rs
    FileEncryptionProperties;
  * the encrypted footer (file/metadata/writer.rs:618): "PARE" magic, the
    plaintext FileCryptoMetaData thrift and then the encrypted FileMetaData
    module, the 4-byte footer length covering both.

Columns named in column_keys are encrypted with their key (ColumnChunk
crypto_metadata member 2 and encrypted_column_metadata, no plaintext
metadata); uniform mode encrypts every column with the footer key (member
1); in non-uniform mode an unlisted column is plaintext.  The nonces are
`os.urandom`'s, so two encryptions of one file differ.

AES-GCM comes from the host `cryptography` package, imported inside the
calls that need it: `import arrowtpu_torch.formats.parquet_crypto` needs
it not.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Callable, Dict, List, Optional, Tuple

from .. import schema as st
from . import thrift

MAGIC_ENCRYPTED = b"PARE"
NONCE_LEN = 12
TAG_LEN = 16
SIZE_LEN = 4

# ModuleType (reference modules.rs)
M_FOOTER = 0
M_COLUMN_METADATA = 1
M_DATA_PAGE = 2
M_DICTIONARY_PAGE = 3
M_DATA_PAGE_HEADER = 4
M_DICTIONARY_PAGE_HEADER = 5
M_COLUMN_INDEX = 6
M_OFFSET_INDEX = 7


def _aesgcm(key: bytes):
    if len(key) not in (16, 24, 32):
        raise st.ArrowTpuError(
            f"parquet encryption: bad AES key length {len(key)}")
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    return AESGCM(key)


def module_aad(file_aad: bytes, mtype: int, rg: int = 0, col: int = 0,
               page: Optional[int] = None) -> bytes:
    """reference modules.rs create_module_aad."""
    if mtype == M_FOOTER:
        return file_aad + bytes([mtype])
    if rg > 0x7FFF or col > 0x7FFF:
        raise st.ArrowTpuError("parquet encryption: ordinal > i16::MAX")
    base = file_aad + bytes([mtype]) + struct.pack("<hh", rg, col)
    if mtype in (M_DATA_PAGE, M_DATA_PAGE_HEADER):
        if page is None:
            raise st.ArrowTpuError("page ordinal required for data pages")
        if page > 0x7FFF:
            raise st.ArrowTpuError(
                "parquet encryption: page ordinal > i16::MAX")
        return base + struct.pack("<h", page)
    return base


def encrypt_module(key: bytes, aad: bytes, plaintext: bytes) -> bytes:
    nonce = os.urandom(NONCE_LEN)
    ct = _aesgcm(key).encrypt(nonce, plaintext, aad)  # ciphertext||tag
    return struct.pack("<I", NONCE_LEN + len(ct)) + nonce + ct


def decrypt_module(key: bytes, aad: bytes, buf, pos: int = 0
                   ) -> Tuple[bytes, int]:
    """Returns (plaintext, position after the module)."""
    (length,) = struct.unpack_from("<I", buf, pos)
    start = pos + SIZE_LEN
    nonce = bytes(buf[start : start + NONCE_LEN])
    ct = bytes(buf[start + NONCE_LEN : start + length])
    try:
        pt = _aesgcm(key).decrypt(nonce, ct, aad)
    except Exception as e:
        raise st.ArrowTpuError(
            f"parquet decryption failed (wrong key or corrupt): {e}")
    return pt, start + length


@dataclasses.dataclass
class FileEncryptionProperties:
    """reference encrypt.rs FileEncryptionProperties (:103)."""

    footer_key: bytes
    column_keys: Dict[str, bytes] = dataclasses.field(default_factory=dict)
    uniform: bool = False  # encrypt every column with the footer key
    aad_prefix: Optional[bytes] = None
    store_aad_prefix: bool = True
    footer_key_metadata: bytes = b""
    column_key_metadata: Dict[str, bytes] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class FileDecryptionProperties:
    """reference decrypt.rs:351."""

    footer_key: Optional[bytes] = None
    column_keys: Dict[str, bytes] = dataclasses.field(default_factory=dict)
    aad_prefix: Optional[bytes] = None
    # key_metadata bytes -> key; used when explicit keys are absent
    key_retriever: Optional[Callable[[bytes], bytes]] = None

    def _footer_key(self, key_metadata: bytes) -> bytes:
        if self.footer_key is not None:
            return self.footer_key
        if self.key_retriever is not None:
            return self.key_retriever(key_metadata)
        raise st.ArrowTpuError(
            "encrypted parquet footer: no footer key or key retriever")

    def _column_key(self, path: str, key_metadata: bytes) -> bytes:
        if path in self.column_keys:
            return self.column_keys[path]
        if self.key_retriever is not None:
            return self.key_retriever(key_metadata)
        raise st.ArrowTpuError(
            f"encrypted parquet column {path!r}: no key available")


class FileEncryptor:
    """Writer-side context: file AAD + per-column key resolution."""

    def __init__(self, props: FileEncryptionProperties):
        self.props = props
        self.aad_file_unique = os.urandom(8)
        prefix = props.aad_prefix or b""
        self.file_aad = prefix + self.aad_file_unique

    def column_key(self, path: str) -> Optional[bytes]:
        """Key for a column's pages, or None when the column stays
        plaintext (non-uniform mode, unlisted column)."""
        if path in self.props.column_keys:
            return self.props.column_keys[path]
        if self.props.uniform:
            return self.props.footer_key
        return None

    def column_crypto_fields(self, path: str):
        """(union_member, path_list, key_metadata) for ColumnChunk field
        8, or None for plaintext columns."""
        if path in self.props.column_keys:
            return (2, path.split("."),
                    self.props.column_key_metadata.get(path, b""))
        if self.props.uniform:
            return (1, None, None)
        return None

    def algorithm_thrift(self, w: thrift.Writer, fid: int) -> None:
        """EncryptionAlgorithm union (AES_GCM_V1) as thrift field fid."""
        w.field_struct(fid)
        w.struct_begin()
        w.field_struct(1)  # AES_GCM_V1
        w.struct_begin()
        if self.props.aad_prefix is not None and self.props.store_aad_prefix:
            w.field_binary(1, self.props.aad_prefix)
        w.field_binary(2, self.aad_file_unique)
        if self.props.aad_prefix is not None \
                and not self.props.store_aad_prefix:
            w.field_bool(3, True)
        w.struct_end()
        w.struct_end()

    def file_crypto_metadata(self) -> bytes:
        """Plaintext FileCryptoMetaData thrift (encrypted-footer mode)."""
        w = thrift.Writer()
        w.struct_begin()
        self.algorithm_thrift(w, 1)
        if self.props.footer_key_metadata:
            w.field_binary(2, self.props.footer_key_metadata)
        w.struct_end()
        return w.bytes()


class FileDecryptor:
    """Reader-side context built from FileCryptoMetaData (or the
    plaintext footer's encryption_algorithm) + decryption properties."""

    def __init__(self, algo: Dict, key_metadata: bytes,
                 props: FileDecryptionProperties):
        if 1 not in algo:
            raise st.ArrowTpuError(
                "parquet encryption: only AES_GCM_V1 is supported "
                "(AES_GCM_CTR_V1 file encountered)")
        gcm = algo[1]
        stored_prefix = bytes(gcm.get(1, b""))
        self.aad_file_unique = bytes(gcm.get(2, b""))
        supply = bool(gcm.get(3, False))
        prefix = stored_prefix
        if supply or (not stored_prefix and props.aad_prefix):
            prefix = props.aad_prefix or b""
        self.file_aad = prefix + self.aad_file_unique
        self.props = props
        # defer footer-key resolution: a plaintext-footer file whose
        # columns are encrypted only with column keys must be readable by
        # supplying column_keys alone
        self._footer_key_metadata = key_metadata
        self._footer_key: Optional[bytes] = None
        self.page_keys: Dict[Tuple[int, int], bytes] = {}

    @property
    def footer_key(self) -> bytes:
        if self._footer_key is None:
            self._footer_key = self.props._footer_key(
                self._footer_key_metadata)
        return self._footer_key

    def register_chunk(self, rg: int, col: int, chunk: Dict) -> None:
        """Resolve the page key for a chunk and decrypt its
        encrypted_column_metadata (field 9) into field 3 if present."""
        crypto = chunk.get(8)
        if crypto is None:
            return  # plaintext column
        if 1 in crypto:  # ENCRYPTION_WITH_FOOTER_KEY
            key = self.footer_key
        else:  # ENCRYPTION_WITH_COLUMN_KEY
            ck = crypto[2]
            path = ".".join(
                p.decode() if isinstance(p, (bytes, bytearray)) else p
                for p in ck.get(1, []))
            key = self.props._column_key(path, bytes(ck.get(2, b"")))
        self.page_keys[(rg, col)] = key
        if 9 in chunk and 3 not in chunk:
            aad = module_aad(self.file_aad, M_COLUMN_METADATA, rg, col)
            pt, _ = decrypt_module(key, aad, chunk[9], 0)
            chunk[3] = thrift.Reader(pt).read_struct()

    def page_key(self, rg: int, col: int) -> Optional[bytes]:
        return self.page_keys.get((rg, col))


def write_encrypted_pages(out, pages: List[Tuple[bytes, bytes, bool]],
                          key: bytes, file_aad: bytes, rg: int, col: int
                          ) -> List[int]:
    """Write (header_bytes, compressed_body, is_dict) page modules;
    returns per-page start offsets.  Header and body are separate
    modules with their own AADs (reference encrypt.rs page writing)."""
    offsets = []
    data_ord = 0
    for hdr, body, is_dict in pages:
        offsets.append(out.tell())
        if is_dict:
            out.write(encrypt_module(
                key, module_aad(file_aad, M_DICTIONARY_PAGE_HEADER, rg,
                                col), hdr))
            out.write(encrypt_module(
                key, module_aad(file_aad, M_DICTIONARY_PAGE, rg, col),
                body))
        else:
            out.write(encrypt_module(
                key, module_aad(file_aad, M_DATA_PAGE_HEADER, rg, col,
                                data_ord), hdr))
            out.write(encrypt_module(
                key, module_aad(file_aad, M_DATA_PAGE, rg, col, data_ord),
                body))
            data_ord += 1
    return offsets
