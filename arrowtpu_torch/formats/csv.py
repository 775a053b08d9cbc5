"""CSV reader and writer.

Counterpart of `arrowtpu/formats/csv.py`, after arrow-rs's arrow-csv
crate: schema inference by regular expressions (reader/mod.rs:461), a
batch-at-a-time `Reader` built by `ReaderBuilder` (reader/mod.rs:1152)
and a `Writer` with the delimiter, header and null options (writer.rs).

One departure from the JAX package (ROADMAP C.3, fault 20): Date32 and
Timestamp columns are written as ISO dates and times, which the reader
parses back under such a field; the JAX writer writes their numbers.
Every other column is written to the JAX writer's text.

Framing and parsing stay on the host, as in both the JAX package and
arrow-rs (a byte scanner has no vector structure for the card): a batch
is parsed into host values (`parse_rows`), then each column reaches its
device with one host-to-device copy a buffer (`upload_columns`, over
`core/column.from_pylist`), never a device op per value.  The device
is the card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import csv as _csv
import dataclasses
import io
import os
import re
from typing import List, Optional, Sequence

import numpy as np

from .. import schema as st
from ..core import batch as bt
from ..core import bitmap as bm
from ..core import column as col

# inference (reader/mod.rs:461 REGEX_SET: boolean, integer, float, date,
# timestamp; the widest type that parses every sample wins)
_BOOL_RE = re.compile(r"^(true|false)$", re.IGNORECASE)
_INT_RE = re.compile(r"^-?(\d+)$")
_FLOAT_RE = re.compile(
    r"^-?(\d+)(\.\d+)?([eE][-+]?\d+)?$|^-?\.\d+([eE][-+]?\d+)?$")
_DATE_RE = re.compile(r"^\d{4}-\d{2}-\d{2}$")
_TS_RE = re.compile(r"^\d{4}-\d{2}-\d{2}[T ]\d{2}:\d{2}:\d{2}(\.\d+)?"
                    r"(Z|[+-]\d{2}:?\d{2})?$")


def infer_field_type(values: Sequence[str]) -> st.DataType:
    """The widest type that parses every non-empty sample."""
    seen = set()
    for v in values:
        if v == "":
            continue
        if _BOOL_RE.match(v):
            seen.add("bool")
        elif _INT_RE.match(v):
            seen.add("int")
        elif _FLOAT_RE.match(v):
            seen.add("float")
        elif _TS_RE.match(v):
            seen.add("timestamp")
        elif _DATE_RE.match(v):
            seen.add("date")
        else:
            seen.add("utf8")
    if not seen or "utf8" in seen:
        return st.utf8
    if seen == {"bool"}:
        return st.bool_
    if seen <= {"int"}:
        return st.int64
    if seen <= {"int", "float"}:
        return st.float64
    if seen <= {"date"}:
        return st.Date32()
    if seen <= {"date", "timestamp"}:
        return st.Timestamp("us")
    return st.utf8


def infer_schema(rows: List[List[str]], headers: List[str]) -> st.Schema:
    cols = list(zip(*rows)) if rows else [[] for _ in headers]
    return st.Schema(tuple(st.Field(h, infer_field_type(list(vals)))
                           for h, vals in zip(headers, cols)))


def _parse_column(values: List[str], dtype: st.DataType) -> list:
    """One column's fields as Python values ("" is a null)."""
    if isinstance(dtype, st.Boolean):
        return [None if v == "" else v.lower() in ("true", "t", "1")
                for v in values]
    if isinstance(dtype, (st.Utf8, st.Binary, st.Dictionary)):
        return [None if v == "" else v for v in values]
    from ..ops.cast import _parse_one

    return [None if v == "" else _parse_one(v, dtype) for v in values]


def parse_rows(rows: List[List[str]], schema: st.Schema) -> List[list]:
    """The host half of a batch: each field's values, parsed."""
    return [_parse_column([r[i] if i < len(r) else "" for r in rows],
                          f.dtype)
            for i, f in enumerate(schema.fields)]


def upload_columns(values: List[list], schema: st.Schema,
                   device) -> bt.RecordBatch:
    """The device half of a batch: each column built on `device`, one
    host-to-device copy a buffer."""
    return bt.RecordBatch(schema, tuple(
        col.from_pylist(v, f.dtype, device)
        for v, f in zip(values, schema.fields)))


@dataclasses.dataclass
class ReaderBuilder:
    """The reader's options (reader/mod.rs:1152); `device` is where the
    batches are built (None: the card)."""

    schema: Optional[st.Schema] = None
    has_header: bool = True
    delimiter: str = ","
    quote: str = '"'
    escape: Optional[str] = None
    batch_size: int = 65536
    max_records_for_inference: int = 1000
    projection: Optional[Sequence[str]] = None
    device: Optional[str] = None

    def build(self, source) -> "Reader":
        return Reader(self, source)


def _text_source(source):
    """bytes, a path, inline CSV text, a text or a binary file -> a text
    file."""
    if isinstance(source, bytes):
        return io.StringIO(source.decode("utf-8"))
    if isinstance(source, str):
        return (open(source, "r", encoding="utf-8")
                if os.path.exists(source) else io.StringIO(source))
    if isinstance(source, io.BufferedIOBase) or (
            hasattr(source, "mode") and "b" in getattr(source, "mode", "")):
        return io.TextIOWrapper(source, encoding="utf-8")
    return source


class Reader:
    """An iterator of RecordBatches of `batch_size` rows."""

    def __init__(self, opts: ReaderBuilder, source):
        self._rows = _csv.reader(_text_source(source),
                                 delimiter=opts.delimiter,
                                 quotechar=opts.quote,
                                 escapechar=opts.escape)
        self.opts = opts
        self._pending: List[List[str]] = []
        self._schema = opts.schema
        headers = None
        if opts.has_header:
            headers = next(self._rows, [])
        if self._schema is None:
            sample = []
            for row in self._rows:
                sample.append(row)
                if len(sample) >= opts.max_records_for_inference:
                    break
            if headers is None:
                width = len(sample[0]) if sample else 0
                headers = [f"column_{i + 1}" for i in range(width)]
            self._schema = infer_schema(sample, headers)
            self._pending = sample

    @property
    def schema(self) -> st.Schema:
        return self._schema

    def __iter__(self):
        return self

    def __next__(self) -> bt.RecordBatch:
        size = self.opts.batch_size
        rows, self._pending = self._pending[:size], self._pending[size:]
        while len(rows) < size:
            row = next(self._rows, None)
            if row is None:
                break
            rows.append(row)
        if not rows:
            raise StopIteration
        batch = upload_columns(parse_rows(rows, self._schema), self._schema,
                               self.opts.device)
        if self.opts.projection:
            batch = batch.project(list(self.opts.projection))
        return batch


def read_csv(source, **kwargs) -> bt.RecordBatch:
    """The whole source as one batch (the reader's batches concatenated)."""
    from ..ops.concat import concat_batches

    reader = ReaderBuilder(**kwargs).build(source)
    batches = list(reader)
    if not batches:
        return bt.RecordBatch(reader.schema, tuple(
            col.from_pylist([], f.dtype, reader.opts.device)
            for f in reader.schema.fields))
    if len(batches) == 1:
        return batches[0]
    return concat_batches(batches)


# ---------------------------------------------------------------------------
# writer (arrow-csv/src/writer.rs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WriterBuilder:
    """The writer's options (writer.rs WriterBuilder)."""

    delimiter: str = ","
    has_header: bool = True
    null_value: str = ""
    timestamp_format: Optional[str] = None

    def build(self, sink) -> "Writer":
        return Writer(self, sink)


class Writer:
    def __init__(self, opts: WriterBuilder, sink):
        self.opts = opts
        self.sink = sink
        self._wrote_header = False

    def write(self, batch: bt.RecordBatch):
        w = _csv.writer(self.sink, delimiter=self.opts.delimiter,
                        lineterminator="\n")
        if self.opts.has_header and not self._wrote_header:
            w.writerow(batch.schema.names)
            self._wrote_header = True
        w.writerows(zip(*(self._format_column(c) for c in batch.columns)))

    def _format_column(self, c: col.Column) -> List[str]:
        null = self.opts.null_value
        if isinstance(c.dtype, (st.Date32, st.Timestamp)):
            return _iso_text(c, null)
        out = []
        for v in c.to_pylist():
            if v is None:
                out.append(null)
            elif isinstance(v, bool):
                out.append("true" if v else "false")
            elif isinstance(v, float):
                out.append(repr(v))
            else:
                out.append(str(v))
        return out


def _iso_text(c: col.Column, null: str) -> List[str]:
    """A Date32 column as ISO dates and a Timestamp column as ISO times of
    its unit's precision, in UTC (arrow-csv's defaults), which the reader
    parses back (a ns time to the microsecond, Python's limit); the JAX
    writer writes their numbers, which its reader cannot parse as dates or
    times (ROADMAP C.3, fault 20)."""
    n = c.length
    unit = "D" if isinstance(c.dtype, st.Date32) else c.dtype.unit
    values = c.values[:n].cpu().numpy().astype(f"datetime64[{unit}]")
    text = np.datetime_as_string(values).tolist()
    if c.validity is None:
        return text
    valid = bm.to_numpy_bools(c.validity, n)
    return [t if ok else null for t, ok in zip(text, valid)]


def write_csv(batch: bt.RecordBatch, sink=None, **kwargs) -> Optional[str]:
    """One batch as CSV text: returned when `sink` is None, else written
    to it."""
    own = sink is None
    if own:
        sink = io.StringIO()
    WriterBuilder(**kwargs).build(sink).write(batch)
    return sink.getvalue() if own else None
