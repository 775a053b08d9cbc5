"""JSON reader and writer, newline-delimited and array formats.

Counterpart of `arrowtpu/formats/json.py`, after arrow-rs's arrow-json
crate: schema inference over the records (reader/schema.rs), a reader
of `batch_size`-row batches (reader/mod.rs) and a writer in the
LineDelimited or JsonArray format with or without explicit nulls
(writer/mod.rs).

Tokenizing stays on the host, as in arrow-rs: the records are parsed
and a batch's values coerced on the host (`coerce_records`), then each
column reaches its device with one host-to-device copy a buffer
(`csv.upload_columns`, over `core/column.from_pylist`).  The device is
the card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import dataclasses
import io
import json as _json
import math
import os
from typing import Any, List, Optional, Sequence

from .. import schema as st
from ..core import batch as bt
from .csv import upload_columns


# ---------------------------------------------------------------------------
# schema inference (reader/schema.rs infer_json_schema)
# ---------------------------------------------------------------------------


def _unify(a: Optional[st.DataType], b: Optional[st.DataType]
           ) -> st.DataType:
    if a is None:
        return b
    if b is None or a == b:
        return a
    if isinstance(a, st.Int) and isinstance(b, st.Float):
        return b
    if isinstance(a, st.Float) and isinstance(b, st.Int):
        return a
    if isinstance(a, st.List) and isinstance(b, st.List):
        return st.List(_unify(a.value, b.value))
    if isinstance(a, st.Struct) and isinstance(b, st.Struct):
        names = {}
        for f in a.fields + b.fields:
            if f.name in names:
                names[f.name] = st.Field(
                    f.name, _unify(names[f.name].dtype, f.dtype))
            else:
                names[f.name] = f
        return st.Struct(tuple(names.values()))
    return st.utf8  # incompatible types read as text


def _infer_value(v: Any) -> Optional[st.DataType]:
    if v is None:
        return None
    if isinstance(v, bool):
        return st.bool_
    if isinstance(v, int):
        return st.int64
    if isinstance(v, float):
        return st.float64
    if isinstance(v, str):
        return st.utf8
    if isinstance(v, list):
        inner = None
        for x in v:
            inner = _unify(inner, _infer_value(x))
        return st.List(inner if inner is not None else st.int64)
    if isinstance(v, dict):
        return st.Struct(tuple(st.Field(k, _infer_value(x) or st.int64)
                               for k, x in v.items()))
    raise st.SchemaError(f"cannot infer JSON type of {type(v)}")


def infer_json_schema(records: Sequence[dict]) -> st.Schema:
    fields: dict = {}
    for rec in records:
        for k, v in rec.items():
            t = _infer_value(v)
            fields[k] = _unify(fields[k], t) if k in fields else t
    return st.Schema(tuple(st.Field(k, t if t is not None else st.int64)
                           for k, t in fields.items()))


def _coerce(v, dtype: st.DataType):
    """A parsed JSON value as the declared or inferred type takes it."""
    if v is None:
        return None
    if isinstance(dtype, st.Float) and isinstance(v, int):
        return float(v)
    if isinstance(dtype, st.Utf8) and not isinstance(v, str):
        return _json.dumps(v)
    if isinstance(dtype, st.List):
        return [_coerce(x, dtype.value) for x in v]
    if isinstance(dtype, st.Struct):
        return {f.name: _coerce(v.get(f.name), f.dtype)
                for f in dtype.fields}
    return v


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ReaderBuilder:
    """The reader's options; `device` is where the batches are built
    (None: the card)."""

    schema: Optional[st.Schema] = None
    batch_size: int = 65536
    coerce_primitive: bool = True
    device: Optional[str] = None

    def build(self, source) -> "Reader":
        return Reader(self, source)


def _text(source) -> str:
    if isinstance(source, bytes):
        source = source.decode("utf-8")
    if isinstance(source, str) and os.path.exists(source):
        with open(source, "r", encoding="utf-8") as f:
            return f.read()
    if hasattr(source, "read"):
        source = source.read()
        if isinstance(source, bytes):
            source = source.decode("utf-8")
    return source


class Reader:
    """An iterator of RecordBatches; an empty source gives one empty
    batch, as in the JAX package."""

    def __init__(self, opts: ReaderBuilder, source):
        text = _text(source).strip()
        if text.startswith("["):  # the JsonArray format
            self._records = _json.loads(text)
        else:  # newline-delimited
            self._records = [_json.loads(line) for line in text.splitlines()
                             if line.strip()]
        self.opts = opts
        self._schema = opts.schema or infer_json_schema(self._records)
        self._pos = 0

    @property
    def schema(self) -> st.Schema:
        return self._schema

    def __iter__(self):
        return self

    def __next__(self) -> bt.RecordBatch:
        if self._pos and self._pos >= len(self._records):
            raise StopIteration
        chunk = self._records[self._pos:self._pos + self.opts.batch_size]
        self._pos += max(len(chunk), 1)
        return upload_columns(coerce_records(chunk, self._schema),
                              self._schema, self.opts.device)


def coerce_records(records: Sequence[dict], schema: st.Schema
                   ) -> List[list]:
    """The host half of a batch: each field's values, coerced."""
    return [[_coerce(rec.get(f.name), f.dtype) for rec in records]
            for f in schema.fields]


def read_json(source, **kwargs) -> bt.RecordBatch:
    from ..ops.concat import concat_batches

    batches = list(ReaderBuilder(**kwargs).build(source))
    if len(batches) == 1:
        return batches[0]
    return concat_batches(batches)


# ---------------------------------------------------------------------------
# writer (arrow-json/src/writer/mod.rs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WriterBuilder:
    """LineDelimited ("ld") or JsonArray ("array"); explicit nulls or
    none (writer/mod.rs with_explicit_nulls)."""

    format: str = "ld"
    explicit_nulls: bool = False

    def build(self, sink) -> "Writer":
        return Writer(self, sink)


class Writer:
    def __init__(self, opts: WriterBuilder, sink):
        self.opts = opts
        self.sink = sink
        self._count = 0
        if opts.format == "array":
            self.sink.write("[")

    def write(self, batch: bt.RecordBatch):
        names = batch.schema.names
        array = self.opts.format == "array"
        explicit = self.opts.explicit_nulls
        for row in zip(*(c.to_pylist() for c in batch.columns)):
            rec = {k: _clean(v) for k, v in zip(names, row)
                   if v is not None or explicit}
            text = _json.dumps(rec, separators=(",", ":"),
                               ensure_ascii=False)
            if array:
                self.sink.write("," + text if self._count else text)
            else:
                self.sink.write(text + "\n")
            self._count += 1

    def finish(self):
        if self.opts.format == "array":
            self.sink.write("]")


def _clean(v):
    if isinstance(v, float) and (math.isnan(v) or math.isinf(v)):
        return None  # JSON has no NaN or infinity
    if isinstance(v, bytes):
        return v.decode("utf-8", errors="replace")
    if isinstance(v, dict):
        return {k: _clean(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_clean(x) for x in v]
    return v


def write_json(batch: bt.RecordBatch, sink=None, **kwargs) -> Optional[str]:
    """One batch as JSON text: returned when `sink` is None, else written
    to it."""
    own = sink is None
    if own:
        sink = io.StringIO()
    w = WriterBuilder(**kwargs).build(sink)
    w.write(batch)
    w.finish()
    return sink.getvalue() if own else None
