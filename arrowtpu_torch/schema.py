"""Logical type system: DataType, Field, Schema and the error classes.

Counterpart of `arrowtpu/schema.py` for the types this package handles so
far.  Each primitive type maps onto one torch dtype; Boolean is an LSB-packed
bitmap (core/bitmap.py), and 64-bit integers are native `torch.int64`.
Utf8 / Binary (string views) and Dictionary have no single torch dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


class ArrowTpuError(Exception):
    """Engine error."""


class InvalidArgumentError(ArrowTpuError):
    pass


class ComputeError(ArrowTpuError):
    pass


class SchemaError(ArrowTpuError):
    pass


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
# int64 first (a lossless widening).  uint64 has no such widening and waits
# for a later slice.
_INT_TORCH = {
    (8, True): torch.int8, (16, True): torch.int16,
    (32, True): torch.int32, (64, True): torch.int64,
    (8, False): torch.uint8, (16, False): torch.uint16,
    (32, False): torch.uint32,
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
        if self.bits not in (32, 64):
            raise SchemaError(f"unsupported float width {self.bits}")

    def to_torch(self) -> torch.dtype:
        return torch.float32 if self.bits == 32 else torch.float64

    def __str__(self):
        return f"float{self.bits}"


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
class Dictionary(DataType):
    """Integer keys into a value column (core/column.py DictionaryColumn)."""

    key: DataType = dataclasses.field(default_factory=lambda: Int(32))
    value: DataType = dataclasses.field(default_factory=Utf8)

    def __str__(self):
        return f"dictionary<{self.key},{self.value}>"


null = Null()
bool_ = Boolean()
int8 = Int(8)
int16 = Int(16)
int32 = Int(32)
int64 = Int(64)
uint8 = Int(8, signed=False)
uint16 = Int(16, signed=False)
uint32 = Int(32, signed=False)
float32 = Float(32)
float64 = Float(64)
utf8 = Utf8()
binary = Binary()


def from_torch(dt: torch.dtype) -> DataType:
    if dt == torch.bool:
        return bool_
    for (bits, signed), tdt in _INT_TORCH.items():
        if tdt == dt:
            return Int(bits, signed)
    if dt == torch.float32:
        return float32
    if dt == torch.float64:
        return float64
    raise SchemaError(f"no arrow type for torch dtype {dt}")


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType


@dataclasses.dataclass(frozen=True)
class Schema:
    fields: Tuple[Field, ...]

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

    def __len__(self):
        return len(self.fields)
