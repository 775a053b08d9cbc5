"""RecordBatch: a schema'd collection of equal-length columns.

Counterpart of `arrowtpu/core/batch.py`."""

from __future__ import annotations

import dataclasses
from typing import Tuple

from .. import schema as st
from . import column as col


@dataclasses.dataclass(frozen=True)
class RecordBatch:
    schema: st.Schema
    columns: Tuple[col.Column, ...]

    def __post_init__(self):
        if len(self.schema) != len(self.columns):
            raise st.InvalidArgumentError(
                f"schema has {len(self.schema)} fields, "
                f"got {len(self.columns)} columns")

    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else 0

    @property
    def length(self) -> int:
        return self.columns[0].length if self.columns else 0

    @property
    def device(self):
        return self.columns[0].device

    def column(self, name_or_idx) -> col.Column:
        if isinstance(name_or_idx, str):
            return self.columns[self.schema.index_of(name_or_idx)]
        return self.columns[name_or_idx]

    def __getitem__(self, key):
        return self.column(key)

    def project(self, names) -> "RecordBatch":
        """The named columns, in that order."""
        return RecordBatch(self.schema.project(names),
                           tuple(self.column(n) for n in names))

    def to_pydict(self):
        return {f.name: c.to_pylist()
                for f, c in zip(self.schema.fields, self.columns)}


def record_batch(data) -> RecordBatch:
    """record_batch({"a": column, ...}): columns of one capacity and length."""
    cols = list(data.values())
    for c in cols:
        if not isinstance(c, col.Column):
            raise st.InvalidArgumentError(
                f"record_batch takes columns, got {type(c).__name__}")
    if len({c.capacity for c in cols}) > 1:
        raise st.InvalidArgumentError("column capacities differ")
    if len({c.length for c in cols}) > 1:
        raise st.InvalidArgumentError("column lengths differ")
    fields = tuple(st.Field(name, c.dtype) for name, c in data.items())
    return RecordBatch(st.Schema(fields), tuple(cols))
