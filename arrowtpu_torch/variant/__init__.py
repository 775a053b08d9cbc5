"""The Variant type: binary encoding, VariantColumn, shredding, path
extraction, the JSON bridge.  Counterpart of `arrowtpu/variant/` (arrow-rs's
parquet-variant, parquet-variant-compute and parquet-variant-json crates),
with the same exports."""

from .encoding import (  # noqa: F401
    VARIANT_NULL,
    VariantBuilder,
    VariantFloat,
    VariantTsNanos,
    build_metadata,
    decode_value,
    encode_value,
    encode_variant,
    parse_metadata,
)
from .array import (  # noqa: F401
    VARIANT_EXT_NAME,
    VariantColumn,
    from_parts,
    is_variant_dtype,
    variant_array,
    variant_field,
    variant_struct_dtype,
)
from .shred import shred_variant, unshred_variant  # noqa: F401
from .get import variant_get  # noqa: F401
from .json import (  # noqa: F401
    batch_json_to_variant,
    batch_variant_to_json,
    json_to_variant,
    variant_to_json,
)
