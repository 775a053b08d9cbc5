"""Row-wise Parquet record API.

Counterpart of `arrowtpu/formats/parquet_record.py`, after the reference's
parquet/src/record/ (api.rs `Row` with typed getters and
`to_json_value`; reader.rs RowIter over a file; record_writer.rs the row
-> file direction).

The reference assembles rows from column triplet readers; here the
columnar reader is the fast path and the row API a windowed facade over
it (core/accessor.py): the columns sit on the reader's device and rows
come to the host one window at a time.
"""

from __future__ import annotations

import json
from typing import Any, Iterator, List, Optional, Tuple

from .. import schema as st
from ..core import batch as bt


class Row:
    """One record: ordered (name, value) pairs with typed getters
    (reference record/api.rs:56 Row; getters api.rs get_bool/get_int/
    get_string/...)."""

    __slots__ = ("_fields",)

    def __init__(self, fields: List[Tuple[str, Any]]):
        self._fields = fields

    def __len__(self) -> int:
        return len(self._fields)

    def column_iter(self):
        return iter(self._fields)

    def into_columns(self) -> List[Tuple[str, Any]]:
        return list(self._fields)

    def _get(self, name: str, types, type_name: str):
        for k, v in self._fields:
            if k == name:
                if v is None or isinstance(v, types):
                    return v
                raise st.ArrowTpuError(
                    f"record: field {name!r} is not {type_name}: {v!r}")
        raise st.ArrowTpuError(f"record: no field {name!r}")

    def get_bool(self, name: str) -> Optional[bool]:
        return self._get(name, bool, "bool")

    def get_int(self, name: str) -> Optional[int]:
        v = self._get(name, (int, bool), "int")
        return None if v is None else int(v)

    get_long = get_int

    def get_float(self, name: str) -> Optional[float]:
        return self._get(name, float, "float")

    get_double = get_float

    def get_string(self, name: str) -> Optional[str]:
        return self._get(name, str, "string")

    def get_bytes(self, name: str) -> Optional[bytes]:
        return self._get(name, (bytes, bytearray), "bytes")

    def get_group(self, name: str) -> Optional["Row"]:
        v = self._get(name, dict, "group")
        return None if v is None else Row(list(v.items()))

    def get_list(self, name: str) -> Optional[list]:
        return self._get(name, list, "list")

    def get_map(self, name: str) -> Optional[dict]:
        v = self._get(name, (list, dict), "map")
        if v is None or isinstance(v, dict):
            return v
        return dict(v)

    def to_json_value(self):
        """reference api.rs:111 to_json_value."""
        def conv(v):
            if isinstance(v, (bytes, bytearray)):
                import base64

                return base64.b64encode(bytes(v)).decode("ascii")
            if isinstance(v, dict):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, list):
                if v and isinstance(v[0], tuple):
                    return {str(k): conv(x) for k, x in v}
                return [conv(x) for x in v]
            return v

        return {k: conv(v) for k, v in self._fields}

    def to_json(self) -> str:
        return json.dumps(self.to_json_value())

    def __eq__(self, other):
        return isinstance(other, Row) and self._fields == other._fields

    def __repr__(self):
        inner = ", ".join(f"{k}: {v!r}" for k, v in self._fields)
        return "{" + inner + "}"


class RowIter:
    """Streaming row iterator over a Parquet source (reference
    record/reader.rs RowIter::from_file_into)."""

    def __init__(self, source, columns: Optional[List[str]] = None,
                 window: int = 8192, device=None):
        from .parquet import ParquetFile

        self._pf = (source if isinstance(source, ParquetFile)
                    else ParquetFile(source, device=device))
        self._columns = columns
        self._window = window

    @property
    def schema(self) -> st.Schema:
        return self._pf.schema

    def __iter__(self) -> Iterator[Row]:
        from ..core.accessor import iter_rows

        batch = self._pf.read(self._columns)
        for d in iter_rows(batch, self._window):
            yield Row(list(d.items()))


def read_rows(source, columns: Optional[List[str]] = None,
              device=None) -> List[Row]:
    return list(RowIter(source, columns, device=device))


def write_rows(rows: List[Row], schema: st.Schema, sink=None,
               props=None, device=None) -> Optional[bytes]:
    """Row -> file direction (reference record_writer.rs RecordWriter):
    the rows become one RecordBatch on `device` (None: the card), then the
    columnar writer runs."""
    from ..core import column as col
    from .parquet import equalize, write_parquet

    dicts = [dict(r.into_columns()) for r in rows]
    cols = [col.from_pylist([d.get(f.name) for d in dicts], f.dtype, device)
            for f in schema.fields]
    return write_parquet(bt.RecordBatch(schema, equalize(cols)), sink,
                         props=props)
