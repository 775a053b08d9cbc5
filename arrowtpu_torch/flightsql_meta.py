"""FlightSQL's metadata results: GetSqlInfo, GetTableTypes, GetTables,
the key commands and GetXdbcTypeInfo.

Counterpart of `arrowtpu/flightsql_meta.py`, after arrow-rs's
arrow-flight/src/sql/metadata/ (sql_info.rs SqlInfoDataBuilder and its
value union; table_types.rs; xdbc_info.rs and its 19-field schema) and
the result schemas of the key commands (sql/arrow.flight.protocol.sql.rs:
239-287).  Each builder returns a RecordBatch of the protocol's schema,
its columns built on `device` (None: the card).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import schema as st
from .core import batch as bt
from .core import column as col

# SqlInfo enum values (sql.proto SqlInfo)
FLIGHT_SQL_SERVER_NAME = 0
FLIGHT_SQL_SERVER_VERSION = 1
FLIGHT_SQL_SERVER_ARROW_VERSION = 2
FLIGHT_SQL_SERVER_READ_ONLY = 3
FLIGHT_SQL_SERVER_SQL = 4
FLIGHT_SQL_SERVER_SUBSTRAIT = 5
FLIGHT_SQL_SERVER_TRANSACTION = 8
SQL_IDENTIFIER_QUOTE_CHAR = 504

# value union children (sql_info.rs UNION_TYPE): type id = child ordinal
_SQL_INFO_UNION = st.Union(
    (
        st.Field("string_value", st.utf8, False),
        st.Field("bool_value", st.bool_, False),
        st.Field("bigint_value", st.int64, False),
        st.Field("int32_bitmask", st.int32, False),
        st.Field("string_list", st.List(st.utf8)),
        st.Field("int32_to_int32_list_map",
                 st.Map(st.int32, st.List(st.int32))),
    ),
    (0, 1, 2, 3, 4, 5),
    "dense",
)

SQL_INFO_SCHEMA = st.Schema((
    st.Field("info_name", st.uint32, False),
    st.Field("value", _SQL_INFO_UNION, False),
))


def default_sql_infos() -> Dict[int, object]:
    """The server defaults (the reference leaves population to the
    application; these mirror its examples)."""
    return {
        FLIGHT_SQL_SERVER_NAME: "arrowtpu",
        FLIGHT_SQL_SERVER_VERSION: "1.0",
        FLIGHT_SQL_SERVER_ARROW_VERSION: "1.0",
        FLIGHT_SQL_SERVER_READ_ONLY: True,
        FLIGHT_SQL_SERVER_SQL: True,
        FLIGHT_SQL_SERVER_SUBSTRAIT: False,
        FLIGHT_SQL_SERVER_TRANSACTION: 0,
        SQL_IDENTIFIER_QUOTE_CHAR: '"',
    }


def sql_info_batch(infos: Dict[int, object], which: Sequence[int] = (),
                   device=None) -> bt.RecordBatch:
    """SqlInfoDataBuilder::build (sql_info.rs): rows sorted by
    info_name; `which` filters to the requested names (empty = all)."""
    names = sorted(infos if not which
                   else [k for k in infos if k in set(which)])
    type_ids: List[int] = []
    offsets: List[int] = []
    strings: List[str] = []
    bools: List[bool] = []
    bigints: List[int] = []
    bitmasks: List[int] = []
    str_lists: List[List[str]] = []
    maps: List[List[Tuple[int, List[int]]]] = []
    for k in names:
        v = infos[k]
        if isinstance(v, bool):
            type_ids.append(1)
            offsets.append(len(bools))
            bools.append(v)
        elif isinstance(v, int):
            type_ids.append(2)
            offsets.append(len(bigints))
            bigints.append(v)
        elif isinstance(v, str):
            type_ids.append(0)
            offsets.append(len(strings))
            strings.append(v)
        elif isinstance(v, (list, tuple)) and (
                not v or isinstance(v[0], str)):
            type_ids.append(4)
            offsets.append(len(str_lists))
            str_lists.append(list(v))
        elif isinstance(v, dict):
            type_ids.append(5)
            offsets.append(len(maps))
            maps.append(sorted(v.items()))
        else:
            raise st.ComputeError(f"sql_info: unsupported value {v!r}")
    children = (
        col.string_view(strings, st.utf8, device),
        col.boolean(np.asarray(bools, bool), device=device),
        col.from_pylist(bigints, st.int64, device),
        col.from_pylist(bitmasks, st.int32, device),
        col.list_view(str_lists, st.List(st.utf8), device),
        col.list_view(maps, st.Map(st.int32, st.List(st.int32)), device),
    )
    value = col.union_column(type_ids, children, _SQL_INFO_UNION,
                             offsets=offsets, device=device)
    info_name = col.primitive(np.asarray(names, np.uint32), st.uint32,
                              length=len(names), device=device)
    return bt.RecordBatch(SQL_INFO_SCHEMA, (info_name, value))


# ---------------------------------------------------------------------------
# table types (table_types.rs)
# ---------------------------------------------------------------------------

TABLE_TYPES_SCHEMA = st.Schema((st.Field("table_type", st.utf8, False),))


def table_types_batch(types: Sequence[str] = ("TABLE",),
                      device=None) -> bt.RecordBatch:
    return bt.RecordBatch(
        TABLE_TYPES_SCHEMA,
        (col.string_view(sorted(set(types)), st.utf8, device),))


# ---------------------------------------------------------------------------
# tables listing (tables.rs GetTablesBuilder)
# ---------------------------------------------------------------------------

def tables_schema(include_schema: bool) -> st.Schema:
    fields = [st.Field("catalog_name", st.utf8),
              st.Field("db_schema_name", st.utf8),
              st.Field("table_name", st.utf8, False),
              st.Field("table_type", st.utf8, False)]
    if include_schema:
        fields.append(st.Field("table_schema", st.binary, False))
    return st.Schema(tuple(fields))


def tables_batch(tables: Dict[str, bt.RecordBatch],
                 include_schema: bool = False,
                 catalog: str = "main",
                 db_schema: str = "public", device=None) -> bt.RecordBatch:
    names = sorted(tables)
    cols = [_text([catalog] * len(names), device),
            _text([db_schema] * len(names), device),
            _text(names, device),
            _text(["TABLE"] * len(names), device)]
    if include_schema:
        from .formats import ipc as _ipc

        cols.append(col.string_view(
            [_ipc.encode_schema_message(tables[n].schema, {})
             for n in names], st.binary, device))
    return bt.RecordBatch(tables_schema(include_schema), tuple(cols))


# ---------------------------------------------------------------------------
# key metadata (protocol schemas sql.rs:239-287)
# ---------------------------------------------------------------------------

PRIMARY_KEYS_SCHEMA = st.Schema((
    st.Field("catalog_name", st.utf8),
    st.Field("db_schema_name", st.utf8),
    st.Field("table_name", st.utf8, False),
    st.Field("column_name", st.utf8, False),
    st.Field("key_name", st.utf8),
    st.Field("key_sequence", st.int32, False),
))

_FK_FIELDS = (
    st.Field("pk_catalog_name", st.utf8),
    st.Field("pk_db_schema_name", st.utf8),
    st.Field("pk_table_name", st.utf8, False),
    st.Field("pk_column_name", st.utf8, False),
    st.Field("fk_catalog_name", st.utf8),
    st.Field("fk_db_schema_name", st.utf8),
    st.Field("fk_table_name", st.utf8, False),
    st.Field("fk_column_name", st.utf8, False),
    st.Field("key_sequence", st.int32, False),
    st.Field("fk_key_name", st.utf8),
    st.Field("pk_key_name", st.utf8),
    st.Field("update_rule", st.uint8, False),
    st.Field("delete_rule", st.uint8, False),
)
IMPORTED_EXPORTED_KEYS_SCHEMA = st.Schema(_FK_FIELDS)


@dataclasses.dataclass(frozen=True)
class ForeignKeyDef:
    """A registered FK: fk_table.fk_columns -> pk_table.pk_columns."""

    fk_table: str
    fk_columns: Tuple[str, ...]
    pk_table: str
    pk_columns: Tuple[str, ...]
    key_name: str = ""


def primary_keys_batch(pks: Dict[str, Sequence[str]],
                       table: str,
                       catalog: str = "main",
                       db_schema: str = "public",
                       device=None) -> bt.RecordBatch:
    cols = pks.get(table, ())
    n = len(cols)
    return bt.RecordBatch(PRIMARY_KEYS_SCHEMA, (
        _text([catalog] * n, device),
        _text([db_schema] * n, device),
        _text([table] * n, device),
        _text(list(cols), device),
        _text([f"pk_{table}"] * n, device),
        col.from_pylist(list(range(1, n + 1)), st.int32, device),
    ))


def foreign_keys_batch(fks: Sequence[ForeignKeyDef],
                       table: str, role: str,
                       catalog: str = "main",
                       db_schema: str = "public",
                       device=None) -> bt.RecordBatch:
    """role='imported': FKs defined ON `table`; role='exported': FKs
    referencing `table`'s primary key (protocol semantics)."""
    rows: List[Tuple] = []
    for fk in fks:
        if role == "imported" and fk.fk_table != table:
            continue
        if role == "exported" and fk.pk_table != table:
            continue
        for seq, (pkc, fkc) in enumerate(
                zip(fk.pk_columns, fk.fk_columns), start=1):
            rows.append((catalog, db_schema, fk.pk_table, pkc,
                         catalog, db_schema, fk.fk_table, fkc,
                         seq, fk.key_name or f"fk_{fk.fk_table}",
                         f"pk_{fk.pk_table}", 3, 3))  # 3 = NO ACTION
    return _fk_rows_to_batch(rows, device)


def cross_reference_batch(fks: Sequence[ForeignKeyDef],
                          pk_table: str, fk_table: str,
                          catalog: str = "main",
                          db_schema: str = "public",
                          device=None) -> bt.RecordBatch:
    rows: List[Tuple] = []
    for fk in fks:
        if fk.pk_table != pk_table or fk.fk_table != fk_table:
            continue
        for seq, (pkc, fkc) in enumerate(
                zip(fk.pk_columns, fk.fk_columns), start=1):
            rows.append((catalog, db_schema, fk.pk_table, pkc,
                         catalog, db_schema, fk.fk_table, fkc,
                         seq, fk.key_name or f"fk_{fk.fk_table}",
                         f"pk_{fk.pk_table}", 3, 3))
    return _fk_rows_to_batch(rows, device)


def _fk_rows_to_batch(rows: List[Tuple], device) -> bt.RecordBatch:
    cols = list(zip(*rows)) if rows else [[] for _ in _FK_FIELDS]
    return bt.RecordBatch(IMPORTED_EXPORTED_KEYS_SCHEMA, tuple(
        col.from_pylist(list(vals), f.dtype, device)
        for f, vals in zip(_FK_FIELDS, cols)))


# ---------------------------------------------------------------------------
# XdbcTypeInfo (xdbc_info.rs)
# ---------------------------------------------------------------------------

XDBC_TYPE_INFO_SCHEMA = st.Schema((
    st.Field("type_name", st.utf8, False),
    st.Field("data_type", st.int32, False),
    st.Field("column_size", st.int32),
    st.Field("literal_prefix", st.utf8),
    st.Field("literal_suffix", st.utf8),
    st.Field("create_params", st.List(st.utf8)),
    st.Field("nullable", st.int32, False),
    st.Field("case_sensitive", st.bool_, False),
    st.Field("searchable", st.int32, False),
    st.Field("unsigned_attribute", st.bool_),
    st.Field("fixed_prec_scale", st.bool_, False),
    st.Field("auto_increment", st.bool_),
    st.Field("local_type_name", st.utf8),
    st.Field("minimum_scale", st.int32),
    st.Field("maximum_scale", st.int32),
    st.Field("sql_data_type", st.int32, False),
    st.Field("datetime_subcode", st.int32),
    st.Field("num_prec_radix", st.int32),
    st.Field("interval_precision", st.int32),
))

# XdbcDataType enum values (sql.proto)
XDBC_BIT = -7
XDBC_TINYINT = -6
XDBC_BIGINT = -5
XDBC_BINARY = -2
XDBC_INTEGER = 4
XDBC_SMALLINT = 5
XDBC_DOUBLE = 8
XDBC_VARCHAR = 12
XDBC_DATE = 91
XDBC_TIMESTAMP = 93

_XDBC_ROWS = [
    # (type_name, data_type, column_size, prefix, suffix, create_params,
    #  case_sensitive, unsigned, radix)
    ("BIT", XDBC_BIT, 1, None, None, None, False, None, None),
    ("TINYINT", XDBC_TINYINT, 3, None, None, None, False, False, 10),
    ("SMALLINT", XDBC_SMALLINT, 5, None, None, None, False, False, 10),
    ("INTEGER", XDBC_INTEGER, 10, None, None, None, False, False, 10),
    ("BIGINT", XDBC_BIGINT, 19, None, None, None, False, False, 10),
    ("DOUBLE", XDBC_DOUBLE, 15, None, None, None, False, False, 2),
    ("VARCHAR", XDBC_VARCHAR, 2**31 - 1, "'", "'", ["length"], True,
     None, None),
    ("BINARY", XDBC_BINARY, 2**31 - 1, None, None, ["length"], False,
     None, None),
    ("DATE", XDBC_DATE, 10, "'", "'", None, False, None, None),
    ("TIMESTAMP", XDBC_TIMESTAMP, 26, "'", "'", None, False, None, None),
]


def xdbc_type_info_batch(data_type: Optional[int] = None,
                         device=None) -> bt.RecordBatch:
    rows = [r for r in _XDBC_ROWS
            if data_type is None or r[1] == data_type]
    n = len(rows)

    def ints(vals):
        return col.from_pylist(list(vals), st.int32, device)

    def bools(vals):
        return col.from_pylist(list(vals), st.bool_, device)

    return bt.RecordBatch(XDBC_TYPE_INFO_SCHEMA, (
        _text([r[0] for r in rows], device),
        ints(r[1] for r in rows),
        ints(r[2] for r in rows),
        _text([r[3] for r in rows], device),
        _text([r[4] for r in rows], device),
        col.list_view([r[5] for r in rows], st.List(st.utf8), device),
        ints([1] * n),  # nullable
        bools(r[6] for r in rows),
        ints([3] * n),  # searchable
        bools(r[7] for r in rows),
        bools([False] * n),
        bools([None] * n),
        _text([r[0] for r in rows], device),
        ints([None] * n),
        ints([None] * n),
        ints(r[1] for r in rows),
        ints([None] * n),
        ints(r[8] for r in rows),
        ints([None] * n),
    ))


def _text(values, device) -> col.StringViewColumn:
    return col.string_view(values, st.utf8, device)
