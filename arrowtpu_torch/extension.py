"""Extension types: the registry and the canonical extensions.

Counterpart of `arrowtpu/extension.py` over the port's schema (pure
Python; it imports nothing of the JAX package): arrow-rs's
`ExtensionType` trait (arrow-schema/src/extension/mod.rs), registration
through the field metadata keys `ARROW:extension:name` /
`ARROW:extension:metadata`, and the canonical extensions
(extension/canonical/): uuid, json, bool8, opaque, fixed_shape_tensor,
variable_shape_tensor.

An extension type wraps a storage DataType; compute sees only the storage
type (extensions are annotations, not physical layouts).  The Parquet
modules take EXTENSION_NAME_KEY from here."""

from __future__ import annotations

import dataclasses
import json as _json
from typing import Dict, Optional, Tuple

from . import schema as st

EXTENSION_NAME_KEY = "ARROW:extension:name"
EXTENSION_METADATA_KEY = "ARROW:extension:metadata"


@dataclasses.dataclass(frozen=True)
class ExtensionType:
    """arrow-rs extension/mod.rs ExtensionType trait: NAME, storage-type
    compatibility check, metadata (de)serialization."""

    name: str
    storage: st.DataType
    metadata: str = ""

    def supports_storage(self, dtype: st.DataType) -> bool:
        return dtype == self.storage

    def field_metadata(self) -> Tuple[Tuple[str, str], ...]:
        md = ((EXTENSION_NAME_KEY, self.name),)
        if self.metadata:
            md += ((EXTENSION_METADATA_KEY, self.metadata),)
        return md


class ExtensionRegistry:
    """Name -> constructor(storage, metadata) registry (arrow-rs keeps
    this implicit in `Field::try_extension_type::<T>`; a registry makes the
    dynamic lookup explicit)."""

    def __init__(self):
        self._types: Dict[str, type] = {}

    def register(self, name: str, cls: type) -> None:
        self._types[name] = cls

    def lookup(self, field: st.Field) -> Optional[ExtensionType]:
        md = dict(field.metadata)
        name = md.get(EXTENSION_NAME_KEY)
        if name is None:
            return None
        meta = md.get(EXTENSION_METADATA_KEY, "")
        cls = self._types.get(name)
        if cls is None:
            return ExtensionType(name, field.dtype, meta)  # opaque passthrough
        return cls.from_field(field, meta)


REGISTRY = ExtensionRegistry()


def _register(cls):
    REGISTRY.register(cls.NAME, cls)
    return cls


@_register
@dataclasses.dataclass(frozen=True)
class Uuid(ExtensionType):
    """arrow-rs extension/canonical/uuid.rs: FixedSizeBinary(16)."""

    NAME = "arrow.uuid"

    def __init__(self):
        super().__init__(self.NAME, st.FixedSizeBinary(16))

    @classmethod
    def from_field(cls, field, meta):
        if field.dtype != st.FixedSizeBinary(16):
            raise st.SchemaError("arrow.uuid requires FixedSizeBinary(16)")
        return cls()


@_register
@dataclasses.dataclass(frozen=True)
class Json(ExtensionType):
    """arrow-rs extension/canonical/json.rs: utf8 storage."""

    NAME = "arrow.json"

    def __init__(self, metadata: str = ""):
        super().__init__(self.NAME, st.utf8, metadata)

    @classmethod
    def from_field(cls, field, meta):
        if not isinstance(field.dtype, (st.Utf8, st.Dictionary)):
            raise st.SchemaError("arrow.json requires string storage")
        return cls(meta)


@_register
@dataclasses.dataclass(frozen=True)
class Bool8(ExtensionType):
    """arrow-rs extension/canonical/bool8.rs: int8 storage, 0=false."""

    NAME = "arrow.bool8"

    def __init__(self):
        super().__init__(self.NAME, st.int8)

    @classmethod
    def from_field(cls, field, meta):
        if field.dtype != st.int8:
            raise st.SchemaError("arrow.bool8 requires Int8 storage")
        return cls()


@_register
@dataclasses.dataclass(frozen=True)
class Opaque(ExtensionType):
    """arrow-rs extension/canonical/opaque.rs: any storage + json metadata
    {type_name, vendor_name}."""

    NAME = "arrow.opaque"

    def __init__(self, storage: st.DataType, type_name: str, vendor_name: str):
        super().__init__(
            self.NAME,
            storage,
            _json.dumps({"type_name": type_name, "vendor_name": vendor_name}),
        )

    @classmethod
    def from_field(cls, field, meta):
        d = _json.loads(meta or "{}")
        return cls(field.dtype, d.get("type_name", ""), d.get("vendor_name", ""))


@_register
@dataclasses.dataclass(frozen=True)
class FixedShapeTensor(ExtensionType):
    """arrow-rs extension/canonical/fixed_shape_tensor.rs:
    FixedSizeList(product(shape)) storage + json {shape, permutation?,
    dim_names?}."""

    NAME = "arrow.fixed_shape_tensor"

    def __init__(self, value_type: st.DataType, shape, permutation=None,
                 dim_names=None):
        n = 1
        for s in shape:
            n *= int(s)
        md = {"shape": list(shape)}
        if permutation is not None:
            md["permutation"] = list(permutation)
        if dim_names is not None:
            md["dim_names"] = list(dim_names)
        super().__init__(
            self.NAME, st.FixedSizeList(value_type, n), _json.dumps(md)
        )

    @property
    def shape(self):
        return tuple(_json.loads(self.metadata)["shape"])

    @classmethod
    def from_field(cls, field, meta):
        d = _json.loads(meta)
        if not isinstance(field.dtype, st.FixedSizeList):
            raise st.SchemaError("fixed_shape_tensor requires FixedSizeList")
        return cls(field.dtype.value, d["shape"], d.get("permutation"),
                   d.get("dim_names"))


@_register
@dataclasses.dataclass(frozen=True)
class VariableShapeTensor(ExtensionType):
    """arrow-rs extension/canonical/variable_shape_tensor.rs:
    Struct{data: List<T>, shape: FixedSizeList<int32>[ndim]}."""

    NAME = "arrow.variable_shape_tensor"

    def __init__(self, value_type: st.DataType, ndim: int):
        storage = st.Struct((
            st.Field("data", st.List(value_type)),
            st.Field("shape", st.FixedSizeList(st.int32, ndim), False),
        ))
        super().__init__(self.NAME, storage, "")

    @classmethod
    def from_field(cls, field, meta):
        if not isinstance(field.dtype, st.Struct):
            raise st.SchemaError("variable_shape_tensor requires Struct storage")
        shape_f = field.dtype.fields[1].dtype
        return cls(field.dtype.fields[0].dtype.value, shape_f.size)


def extension_field(name: str, ext: ExtensionType, nullable: bool = True) -> st.Field:
    """Build a Field carrying the extension annotation (arrow-rs's
    Field::try_with_extension_type)."""
    return st.Field(name, ext.storage, nullable, ext.field_metadata())
