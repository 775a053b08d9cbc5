"""VariantColumn: the Arrow representation of a variant column.

Counterpart of `arrowtpu/variant/array.py` (arrow-rs's
parquet-variant-compute crate, variant_array.rs `VariantArray`: a
StructArray with `metadata: Binary`, optional `value: Binary`, optional
`typed_value: T`, carrying the `arrow.parquet.variant` canonical
extension).  The struct is the port's StructColumn on one device: the
binary metadata and value rows are string views, and a SHREDDED
`typed_value` is ordinary columns, so columnar compute runs on the
shredded form and `variant_get` takes it without touching the bytes.
Host loops read each buffer back once (`StringViewColumn.to_pylist`: one
copy of the views and one of the arena), never once a row.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from .. import schema as st
from ..config import resolve_device
from ..core import bitmap as bm
from ..core import column as col
from ..extension import EXTENSION_NAME_KEY
from . import encoding as enc

VARIANT_EXT_NAME = "arrow.parquet.variant"

METADATA_FIELD = "metadata"
VALUE_FIELD = "value"
TYPED_VALUE_FIELD = "typed_value"


def variant_struct_dtype(
        typed_value: Optional[st.DataType] = None) -> st.Struct:
    """The struct dtype of a variant column (variant_array.rs: required
    `metadata`, optional `value`, optional `typed_value`)."""
    fields = [st.Field(METADATA_FIELD, st.binary, False),
              st.Field(VALUE_FIELD, st.binary, True)]
    if typed_value is not None:
        fields.append(st.Field(TYPED_VALUE_FIELD, typed_value, True))
    return st.Struct(tuple(fields))


def variant_field(name: str, typed_value: Optional[st.DataType] = None,
                  nullable: bool = True) -> st.Field:
    """A schema field carrying the arrow.parquet.variant extension
    annotation (variant_array.rs VariantType)."""
    return st.Field(name, variant_struct_dtype(typed_value), nullable,
                    ((EXTENSION_NAME_KEY, VARIANT_EXT_NAME),))


def is_variant_dtype(dtype: st.DataType) -> bool:
    if not isinstance(dtype, st.Struct):
        return False
    names = [f.name for f in dtype.fields]
    return (names[:1] == [METADATA_FIELD]
            and VALUE_FIELD in names
            and set(names) <= {METADATA_FIELD, VALUE_FIELD,
                               TYPED_VALUE_FIELD})


def valid_rows(c: col.Column, n: int) -> np.ndarray:
    """(n,) bool on the host: the column's validity (one read-back)."""
    if c.validity is None:
        return np.ones(n, bool)
    return bm.to_numpy_bools(c.validity, n)


class MetadataNames:
    """Row -> the field names of its metadata dictionary, the metadata
    column read back once and each distinct buffer parsed once."""

    def __init__(self, metadata: col.StringViewColumn):
        self.rows = metadata.to_pylist()
        self.cache = {}

    def __call__(self, i: int) -> List[str]:
        mb = self.rows[i] or enc.EMPTY_METADATA
        names = self.cache.get(mb)
        if names is None:
            names = enc.parse_metadata(mb)[0]
            self.cache[mb] = names
        return names


class VariantColumn:
    """A typed view over the variant StructColumn (arrow-rs VariantArray).

    Fields:
      metadata : StringViewColumn (Binary): a row's metadata buffer
      value    : StringViewColumn (Binary): a row's variant bytes, null
                 where the row is shredded whole
      typed_value : Optional[Column]: the shredded representation
    """

    def __init__(self, inner: col.StructColumn):
        if not is_variant_dtype(inner.dtype):
            raise st.SchemaError(
                "VariantColumn requires struct<metadata: binary, value: "
                f"binary[, typed_value]>, got {inner.dtype}")
        self.inner = inner
        names = [f.name for f in inner.dtype.fields]
        self.metadata = inner.children[names.index(METADATA_FIELD)]
        self.value = inner.children[names.index(VALUE_FIELD)]
        self.typed_value = (
            inner.children[names.index(TYPED_VALUE_FIELD)]
            if TYPED_VALUE_FIELD in names else None)

    @property
    def length(self) -> int:
        return self.inner.length

    @property
    def capacity(self) -> int:
        return self.inner.capacity

    @property
    def device(self) -> torch.device:
        return self.inner.device

    def metadata_bytes(self) -> List[Optional[bytes]]:
        return self.metadata.to_pylist()

    def value_bytes(self) -> List[Optional[bytes]]:
        return self.value.to_pylist()

    def to_pylist(self) -> List[Any]:
        """Every row decoded to Python values (arrow-rs
        VariantArray::value and the Variant -> owned conversion)."""
        if self.typed_value is not None:
            from .shred import unshred_variant

            return unshred_variant(self).to_pylist()
        n = self.length
        vals = self.value_bytes()
        valid = valid_rows(self.inner, n)
        names_for = MetadataNames(self.metadata)
        return [enc.decode_value(vals[i], names_for(i))
                if valid[i] and vals[i] is not None else None
                for i in range(n)]


def variant_array(values: Sequence[Any], device=None) -> VariantColumn:
    """An unshredded VariantColumn from Python values (arrow-rs
    VariantArrayBuilder) on `device` (None: the card): one metadata
    dictionary shared by the rows, one value buffer a row; None -> a null
    row (VARIANT_NULL is a valid row holding Variant::Null)."""
    device = resolve_device(device)
    b = enc.VariantBuilder()
    for v in values:
        b.append(v)
    meta, rows = b.finish()
    n = len(values)
    metadata_col = col.string_view([meta] * n, st.binary, device)
    value_col = col.string_view(
        [None if v is None else r for v, r in zip(values, rows)], st.binary,
        device)
    valid = [v is not None for v in values]
    return from_parts(metadata_col, value_col,
                      validity=None if all(valid) else valid)


def from_parts(metadata: col.StringViewColumn,
               value: col.StringViewColumn,
               typed_value: Optional[col.Column] = None,
               validity=None) -> VariantColumn:
    """Assemble from the three columns (arrow-rs VariantArray::from_parts)
    on the metadata's device; `validity` as bools or a packed bitmap."""
    children = [metadata, value]
    if typed_value is not None:
        children.append(typed_value)
    dtype = variant_struct_dtype(
        typed_value.dtype if typed_value is not None else None)
    bits = col._bitmap(validity, metadata.capacity, metadata.device)
    if bits is not None:
        bits = bm.clip(bits, metadata.length)
    inner = col.StructColumn(tuple(children), bits, metadata.length, dtype)
    return VariantColumn(inner)
