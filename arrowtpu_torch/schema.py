"""Logical type system: DataType, Field, Schema and the error classes.

Counterpart of `arrowtpu/schema.py`; every type prints as the JAX package
prints it (`dtype_parse.parse_datatype` reads it back).  Physical layouts:

  * integers, floats and the temporal types are one native torch dtype
    each (64-bit integers are native `torch.int64`; Date32 and Time32 are
    int32, Timestamp, Date64, Time64 and Duration int64; float16 is
    `torch.float16`); uint64 is stored as its 64 bits in an int64 tensor
    (`to_torch` gives int64, `is_u64` tells it apart), and every op that
    reads it is unsigned;
  * Boolean is an LSB-packed bitmap (core/bitmap.py);
  * decimals, intervals and fixed-size binary are `(capacity, W)` int32
    words (`words_per_row`): a decimal's W = 1, 2, 4 or 8 little-endian
    two's-complement u32 limbs held as int32 bits (core/limbs.py), an
    interval's 1, 2 or 4 words, a fixed-size binary's ceil(width / 4);
  * Utf8 / Binary (string views), Dictionary and the nested types (List,
    Map, FixedSizeList, Struct, Union, RunEndEncoded) have no single
    torch dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


class ArrowTpuError(Exception):
    """Engine error."""


class InvalidArgumentError(ArrowTpuError):
    pass


class ComputeError(ArrowTpuError):
    pass


class CastError(ArrowTpuError):
    pass


class SchemaError(ArrowTpuError):
    pass


class ValidationError(ArrowTpuError):
    """Untrusted input failed value validation."""


@dataclasses.dataclass(frozen=True)
class DataType:
    def to_torch(self) -> torch.dtype:
        raise SchemaError(f"{self} has no single torch dtype")


@dataclasses.dataclass(frozen=True)
class Null(DataType):
    def __str__(self):
        return "null"


@dataclasses.dataclass(frozen=True)
class Boolean(DataType):
    def __str__(self):
        return "bool"


# torch's uint16 and uint32 store, copy, index and convert but lack
# comparisons and reductions, so code that computes on them widens to
# int64 first (a lossless widening).  torch's uint64 lacks comparisons,
# addition, division and reductions on the CPU and has no lossless
# widening, so a uint64 column holds the same 64 bits in an int64 tensor.
_INT_TORCH = {
    (8, True): torch.int8, (16, True): torch.int16,
    (32, True): torch.int32, (64, True): torch.int64,
    (8, False): torch.uint8, (16, False): torch.uint16,
    (32, False): torch.uint32, (64, False): torch.int64,
}


@dataclasses.dataclass(frozen=True)
class Int(DataType):
    bits: int = 64
    signed: bool = True

    def __post_init__(self):
        if (self.bits, self.signed) not in _INT_TORCH:
            raise SchemaError(f"unsupported int type {self}")

    def to_torch(self) -> torch.dtype:
        return _INT_TORCH[(self.bits, self.signed)]

    def __str__(self):
        return f"{'' if self.signed else 'u'}int{self.bits}"


@dataclasses.dataclass(frozen=True)
class Float(DataType):
    bits: int = 64

    def __post_init__(self):
        if self.bits not in (16, 32, 64):
            raise SchemaError(f"unsupported float width {self.bits}")

    def to_torch(self) -> torch.dtype:
        return {16: torch.float16, 32: torch.float32,
                64: torch.float64}[self.bits]

    def __str__(self):
        return f"float{self.bits}"


# Temporal types: native integers with a unit.
@dataclasses.dataclass(frozen=True)
class Timestamp(DataType):
    unit: str = "us"  # s | ms | us | ns
    tz: Optional[str] = None

    def to_torch(self) -> torch.dtype:
        return torch.int64

    def __str__(self):
        return f"timestamp[{self.unit}{',' + self.tz if self.tz else ''}]"


@dataclasses.dataclass(frozen=True)
class Date32(DataType):
    def to_torch(self) -> torch.dtype:
        return torch.int32

    def __str__(self):
        return "date32"


@dataclasses.dataclass(frozen=True)
class Date64(DataType):
    def to_torch(self) -> torch.dtype:
        return torch.int64

    def __str__(self):
        return "date64"


@dataclasses.dataclass(frozen=True)
class Time32(DataType):
    unit: str = "ms"

    def to_torch(self) -> torch.dtype:
        return torch.int32

    def __str__(self):
        return f"time32[{self.unit}]"


@dataclasses.dataclass(frozen=True)
class Time64(DataType):
    unit: str = "us"

    def to_torch(self) -> torch.dtype:
        return torch.int64

    def __str__(self):
        return f"time64[{self.unit}]"


@dataclasses.dataclass(frozen=True)
class Duration(DataType):
    unit: str = "us"

    def to_torch(self) -> torch.dtype:
        return torch.int64

    def __str__(self):
        return f"duration[{self.unit}]"


# Decimals: (capacity, N) int32 limbs, N = 1, 2, 4, 8 (decimal_limbs).
@dataclasses.dataclass(frozen=True)
class Decimal32(DataType):
    precision: int = 9
    scale: int = 2

    def __str__(self):
        return f"decimal32({self.precision},{self.scale})"


@dataclasses.dataclass(frozen=True)
class Decimal64(DataType):
    precision: int = 18
    scale: int = 4

    def __str__(self):
        return f"decimal64({self.precision},{self.scale})"


@dataclasses.dataclass(frozen=True)
class Decimal128(DataType):
    precision: int = 38
    scale: int = 10

    def __str__(self):
        return f"decimal128({self.precision},{self.scale})"


@dataclasses.dataclass(frozen=True)
class Decimal256(DataType):
    precision: int = 76
    scale: int = 10

    def __str__(self):
        return f"decimal256({self.precision},{self.scale})"


@dataclasses.dataclass(frozen=True)
class Interval(DataType):
    """Calendar interval: "year_month" (one int32 of months), "day_time"
    (int32 days, int32 ms) or "month_day_nano" (int32 months, int32 days,
    int64 nanos as words lo, hi), one int32 word each."""

    unit: str = "month_day_nano"

    def __post_init__(self):
        if self.unit not in ("year_month", "day_time", "month_day_nano"):
            raise SchemaError(f"bad interval unit {self.unit!r}")

    @property
    def n_words(self) -> int:
        return {"year_month": 1, "day_time": 2, "month_day_nano": 4}[self.unit]

    def __str__(self):
        return f"interval[{self.unit}]"


@dataclasses.dataclass(frozen=True)
class Utf8(DataType):
    """Strings in the Arrow view layout (core/column.py StringViewColumn)."""

    def __str__(self):
        return "utf8"


@dataclasses.dataclass(frozen=True)
class Binary(DataType):
    def __str__(self):
        return "binary"


@dataclasses.dataclass(frozen=True)
class FixedSizeBinary(DataType):
    byte_width: int = 16

    def __str__(self):
        return f"fixed_size_binary[{self.byte_width}]"


@dataclasses.dataclass(frozen=True)
class Dictionary(DataType):
    """Integer keys into a value column (core/column.py DictionaryColumn)."""

    key: DataType = dataclasses.field(default_factory=lambda: Int(32))
    value: DataType = dataclasses.field(default_factory=Utf8)

    def __str__(self):
        return f"dictionary<{self.key},{self.value}>"


@dataclasses.dataclass(frozen=True)
class List(DataType):
    """Variable-length list, held as a list view: (start, size) a row into
    a shared child (core/column.py ListViewColumn)."""

    value: DataType = dataclasses.field(default_factory=lambda: Int(64))

    def __str__(self):
        return f"list<{self.value}>"


@dataclasses.dataclass(frozen=True)
class FixedSizeList(DataType):
    value: DataType = dataclasses.field(default_factory=lambda: Int(64))
    size: int = 1

    def __str__(self):
        return f"fixed_size_list<{self.value}>[{self.size}]"


@dataclasses.dataclass(frozen=True)
class Map(DataType):
    """A list whose items are a (key, value) struct, the key non-null."""

    key: DataType = dataclasses.field(default_factory=Utf8)
    item: DataType = dataclasses.field(default_factory=lambda: Int(64))

    @property
    def entry_struct(self) -> "Struct":
        return Struct((Field("key", self.key, False), Field("value", self.item)))

    def __str__(self):
        return f"map<{self.key},{self.item}>"


@dataclasses.dataclass(frozen=True)
class Struct(DataType):
    fields: Tuple["Field", ...] = ()

    def __str__(self):
        return ("struct<" + ", ".join(f"{f.name}:{f.dtype}"
                                      for f in self.fields) + ">")


@dataclasses.dataclass(frozen=True)
class Union(DataType):
    """Sparse or dense union: an int8 type code a row (held as int32),
    offsets iff dense, children; no validity of its own."""

    fields: Tuple["Field", ...] = ()
    type_ids: Tuple[int, ...] = ()  # type code per child, parallel to fields
    mode: str = "sparse"  # "sparse" | "dense"

    def __post_init__(self):
        if self.mode not in ("sparse", "dense"):
            raise SchemaError(f"bad union mode {self.mode!r}")
        if self.type_ids and len(self.type_ids) != len(self.fields):
            raise SchemaError("union: type_ids must parallel fields")

    def child_index(self, type_id: int) -> int:
        ids = self.type_ids or tuple(range(len(self.fields)))
        for i, t in enumerate(ids):
            if t == type_id:
                return i
        raise SchemaError(f"union has no child with type_id {type_id}")

    def __str__(self):
        inner = ", ".join(f"{f.name}:{f.dtype}" for f in self.fields)
        return f"union[{self.mode}]<{inner}>"


@dataclasses.dataclass(frozen=True)
class RunEndEncoded(DataType):
    """Run-end encoded: run_ends[j] is the cumulative logical end of run j;
    nulls live on the values."""

    run_end: DataType = dataclasses.field(default_factory=lambda: Int(32))
    value: DataType = dataclasses.field(default_factory=lambda: Int(64))

    def __str__(self):
        return f"run_end_encoded<{self.run_end},{self.value}>"


null = Null()
bool_ = Boolean()
int8 = Int(8)
int16 = Int(16)
int32 = Int(32)
int64 = Int(64)
uint8 = Int(8, signed=False)
uint16 = Int(16, signed=False)
uint32 = Int(32, signed=False)
uint64 = Int(64, signed=False)
float16 = Float(16)
float32 = Float(32)
float64 = Float(64)
utf8 = Utf8()
binary = Binary()


_DECIMALS = {1: Decimal32, 2: Decimal64, 4: Decimal128, 8: Decimal256}

# the most decimal digits each limb count holds
MAX_DECIMAL_PRECISION = {1: 9, 2: 18, 4: 38, 8: 76}


def decimal_limbs(dtype: DataType) -> Optional[int]:
    """The number of u32 limbs of a decimal type, else None."""
    for n, cls in _DECIMALS.items():
        if isinstance(dtype, cls):
            return n
    return None


def decimal_for_limbs(n: int, precision: int, scale: int) -> DataType:
    return _DECIMALS[n](precision, scale)


def words_per_row(dtype: DataType) -> Optional[int]:
    """The int32 words a row of a decimal, interval or fixed-size binary
    column holds (its values are (capacity, W) int32), else None."""
    n = decimal_limbs(dtype)
    if n is not None:
        return n
    if isinstance(dtype, Interval):
        return dtype.n_words
    if isinstance(dtype, FixedSizeBinary):
        return -(-dtype.byte_width // 4)
    return None


def is_u64(dtype: DataType) -> bool:
    """uint64: int64 bits read as unsigned."""
    return isinstance(dtype, Int) and dtype.bits == 64 and not dtype.signed


def from_torch(dt: torch.dtype) -> DataType:
    """The type of a torch dtype; torch.uint64 (which columns never hold)
    names uint64 and int64 names int64."""
    if dt == torch.bool:
        return bool_
    if dt == torch.uint64:
        return uint64
    for (bits, signed), tdt in _INT_TORCH.items():
        if tdt == dt:
            return Int(bits, signed)
    for f in (float16, float32, float64):
        if f.to_torch() == dt:
            return f
    raise SchemaError(f"no arrow type for torch dtype {dt}")


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType
    nullable: bool = True
    metadata: Tuple[Tuple[str, str], ...] = ()

    def with_name(self, name: str) -> "Field":
        return dataclasses.replace(self, name=name)


@dataclasses.dataclass(frozen=True)
class Schema:
    fields: Tuple[Field, ...]
    metadata: Tuple[Tuple[str, str], ...] = ()

    def __post_init__(self):
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            raise SchemaError(f"duplicate field names in schema: {names}")

    @property
    def names(self):
        return [f.name for f in self.fields]

    def field(self, name: str) -> Field:
        return self.fields[self.index_of(name)]

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise SchemaError(f"no field named {name!r}")

    def project(self, names) -> "Schema":
        return Schema(tuple(self.field(n) for n in names), self.metadata)

    def __len__(self):
        return len(self.fields)


def schema(pairs, metadata=()) -> Schema:
    """schema([("a", int64), ("b", float32)])"""
    return Schema(
        tuple(p if isinstance(p, Field) else Field(p[0], p[1]) for p in pairs),
        tuple(metadata))
