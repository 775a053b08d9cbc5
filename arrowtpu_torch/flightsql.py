"""Flight SQL: the query protocol on the Flight data plane.

Counterpart of `arrowtpu/flightsql.py`, after arrow-rs's
arrow-flight/src/sql/ (server.rs:56 FlightSqlService, client.rs, and the
command messages of gen/arrow.flight.protocol.sql.rs): commands travel
as `google.protobuf.Any` payloads inside FlightDescriptor.cmd and
Ticket.ticket.  The statement path (CommandStatementQuery ->
GetFlightInfo -> TicketStatementQuery -> DoGet), prepared statements,
transactions and the catalog and metadata commands.

Statements run on the engine's own operators: `execute_select` parses a
small SELECT and evaluates its WHERE with `ops.cmp` and `and_kleene`,
keeps the rows with `filter_record_batch` (K1, and K2 on a batch's byte
plane) and cuts LIMIT with `slice_batch`, on the device the tables live
on.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, List, Optional

from . import schema as st
from .core import batch as bt
from .flight import (FlightClient, FlightServer, _first, _parse, _w_bytes,
                     _w_varint, decode_descriptor, decode_ticket,
                     encode_descriptor, encode_flight_info)

_TYPE_PREFIX = "type.googleapis.com/arrow.flight.protocol.sql."


def _any_pack(type_name: str, value: bytes) -> bytes:
    out = bytearray()
    _w_bytes(out, 1, (_TYPE_PREFIX + type_name).encode())
    _w_bytes(out, 2, value)
    return bytes(out)


def _any_unpack(buf: bytes):
    d = _parse(buf)
    url = bytes(_first(d, 1)).decode()
    return url.rsplit(".", 1)[-1], bytes(_first(d, 2))


def command_statement_query(query: str) -> bytes:
    """CommandStatementQuery{query=1} wrapped in Any (sql.proto)."""
    inner = bytearray()
    _w_bytes(inner, 1, query.encode())
    return _any_pack("CommandStatementQuery", bytes(inner))


def ticket_statement_query(handle: bytes) -> bytes:
    """TicketStatementQuery{statement_handle=1} wrapped in Any."""
    inner = bytearray()
    _w_bytes(inner, 1, handle)
    return _any_pack("TicketStatementQuery", bytes(inner))


def command_get_tables() -> bytes:
    return _any_pack("CommandGetTables", b"")


def command_get_catalogs() -> bytes:
    return _any_pack("CommandGetCatalogs", b"")


def command_get_db_schemas() -> bytes:
    return _any_pack("CommandGetDbSchemas", b"")


def command_get_sql_info(infos=()) -> bytes:
    """CommandGetSqlInfo{repeated uint32 info=1}."""
    inner = bytearray()
    if infos:
        packed = bytearray()
        for i in infos:
            _w_varint(packed, int(i))
        _w_bytes(inner, 1, bytes(packed))
    return _any_pack("CommandGetSqlInfo", bytes(inner))


def command_get_table_types() -> bytes:
    return _any_pack("CommandGetTableTypes", b"")


def _keys_cmd(name: str, table: str) -> bytes:
    inner = bytearray()
    _w_bytes(inner, 3, table.encode())
    return _any_pack(name, bytes(inner))


def command_get_primary_keys(table: str) -> bytes:
    return _keys_cmd("CommandGetPrimaryKeys", table)


def command_get_exported_keys(table: str) -> bytes:
    return _keys_cmd("CommandGetExportedKeys", table)


def command_get_imported_keys(table: str) -> bytes:
    return _keys_cmd("CommandGetImportedKeys", table)


def command_get_cross_reference(pk_table: str, fk_table: str) -> bytes:
    inner = bytearray()
    _w_bytes(inner, 3, pk_table.encode())
    _w_bytes(inner, 6, fk_table.encode())
    return _any_pack("CommandGetCrossReference", bytes(inner))


def command_get_xdbc_type_info(data_type: Optional[int] = None) -> bytes:
    inner = bytearray()
    if data_type is not None:
        # int32 field 1 (varint; negative values use 10-byte two's compl.)
        _w_varint(inner, (1 << 3) | 0)
        _w_varint(inner, data_type & 0xFFFFFFFFFFFFFFFF
                  if data_type < 0 else data_type)
    return _any_pack("CommandGetXdbcTypeInfo", bytes(inner))


def command_prepared_statement_query(handle: bytes) -> bytes:
    """CommandPreparedStatementQuery{prepared_statement_handle=1}."""
    inner = bytearray()
    _w_bytes(inner, 1, handle)
    return _any_pack("CommandPreparedStatementQuery", bytes(inner))


def action_create_prepared_statement(query: str) -> bytes:
    """ActionCreatePreparedStatementRequest{query=1} wrapped in Any."""
    inner = bytearray()
    _w_bytes(inner, 1, query.encode())
    return _any_pack("ActionCreatePreparedStatementRequest", bytes(inner))


def action_close_prepared_statement(handle: bytes) -> bytes:
    inner = bytearray()
    _w_bytes(inner, 1, handle)
    return _any_pack("ActionClosePreparedStatementRequest", bytes(inner))


# ---------------------------------------------------------------------------
# a minimal SELECT, evaluated by the engine's operators
# ---------------------------------------------------------------------------

_SELECT_RE = re.compile(
    r"^\s*select\s+(?P<cols>\*|[\w\s,]+?)\s+from\s+(?P<table>\w+)"
    r"(?:\s+where\s+(?P<where>.+?))?(?:\s+limit\s+(?P<limit>\d+))?\s*;?\s*$",
    re.IGNORECASE | re.DOTALL,
)
_COND_RE = re.compile(
    r"^\s*(?P<col>\w+)\s*(?P<op>=|==|!=|<>|<=|>=|<|>)\s*(?P<lit>.+?)\s*$")

_OPS = {"=": "eq", "==": "eq", "!=": "neq", "<>": "neq", "<": "lt",
        "<=": "lt_eq", ">": "gt", ">=": "gt_eq"}


def _literal(text: str):
    text = text.strip()
    if text.startswith("'") and text.endswith("'"):
        return text[1:-1]
    if "." in text or "e" in text.lower():
        return float(text)
    return int(text)


def execute_select(tables: Dict[str, bt.RecordBatch], sql: str
                   ) -> bt.RecordBatch:
    """SELECT [cols | *] FROM t [WHERE col op lit [AND ...]] [LIMIT n]
    over `tables`, on the device their batches live on."""
    from . import ops

    m = _SELECT_RE.match(sql)
    if not m:
        raise st.ComputeError(f"flightsql: cannot parse query: {sql!r}")
    table = m.group("table")
    if table not in tables:
        raise st.ComputeError(f"flightsql: unknown table {table!r}")
    batch = tables[table]
    if m.group("where"):
        mask = None
        for cond in re.split(r"\s+and\s+", m.group("where"),
                             flags=re.IGNORECASE):
            cm = _COND_RE.match(cond)
            if not cm:
                raise st.ComputeError(f"flightsql: bad condition {cond!r}")
            fn = getattr(ops, _OPS[cm.group("op")])
            part = fn(batch[cm.group("col")], _literal(cm.group("lit")))
            mask = part if mask is None else ops.and_kleene(mask, part)
        batch = ops.filter_record_batch(batch, mask)
    cols = m.group("cols").strip()
    if cols != "*":
        batch = batch.project([c.strip() for c in cols.split(",")])
    if m.group("limit") is not None:
        batch = ops.slice_batch(batch, 0, min(int(m.group("limit")),
                                              batch.length))
    return batch


# ---------------------------------------------------------------------------
# server / client
# ---------------------------------------------------------------------------


class FlightSqlServer(FlightServer):
    """FlightSqlService (sql/server.rs:56): statement queries, prepared
    statements, transactions and the metadata commands over registered
    tables; any Flight client that sends command descriptors works with
    it (pyarrow.flight's included).  Results are built on `device` (None:
    the card); a registered table is queried where it lives."""

    def __init__(self, tables: Optional[Dict[str, bt.RecordBatch]] = None,
                 device=None):
        super().__init__(device)
        from . import flightsql_meta as fm

        self.sql_tables: Dict[str, bt.RecordBatch] = tables or {}
        self._statements: Dict[bytes, bt.RecordBatch] = {}
        self._prepared: Dict[bytes, str] = {}  # handle -> SQL text
        self._primary_keys: Dict[str, tuple] = {}
        self._foreign_keys: list = []
        self._transactions: set = set()
        self.sql_infos = fm.default_sql_infos()
        self._next = 0
        self._lock = threading.Lock()

    def register_table(self, name: str, batch: bt.RecordBatch):
        self.sql_tables[name] = batch

    def _handle(self, prefix: str) -> bytes:
        with self._lock:
            handle = f"{prefix}-{self._next}".encode()
            self._next += 1
        return handle

    # -- actions (server.rs do_action_create_prepared_statement,
    # ClosePreparedStatement, BeginTransaction, EndTransaction)
    def do_action(self, action_type: str, body: bytes):
        if action_type == "CreatePreparedStatement":
            name, payload = _any_unpack(body)
            if name != "ActionCreatePreparedStatementRequest":
                raise st.ComputeError(f"flightsql: bad action body {name}")
            sql = bytes(_first(_parse(payload), 1)).decode()
            # run it once, so that bad SQL fails at prepare()
            dataset = execute_select(self.sql_tables, sql)
            handle = self._handle("prep")
            with self._lock:
                self._prepared[handle] = sql
            from .formats import ipc

            result = bytearray()
            _w_bytes(result, 1, handle)
            _w_bytes(result, 2, ipc.encode_schema_message(dataset.schema, {}))
            yield _any_pack("ActionCreatePreparedStatementResult",
                            bytes(result))
            return
        if action_type == "ClosePreparedStatement":
            _, payload = _any_unpack(body)
            with self._lock:
                self._prepared.pop(bytes(_first(_parse(payload), 1)), None)
            return
        if action_type == "BeginTransaction":
            # the tables are immutable snapshots: a transaction is a
            # handle to a consistent read
            handle = self._handle("txn")
            with self._lock:
                self._transactions.add(handle)
            result = bytearray()
            _w_bytes(result, 1, handle)
            yield _any_pack("ActionBeginTransactionResult", bytes(result))
            return
        if action_type == "EndTransaction":
            _, payload = _any_unpack(body)
            handle = bytes(_first(_parse(payload), 1))
            with self._lock:
                if handle not in self._transactions:
                    raise st.ComputeError(
                        "flightsql: unknown transaction handle")
                self._transactions.discard(handle)
            return
        yield from super().do_action(action_type, body)

    def list_actions(self):
        return [("CreatePreparedStatement",
                 "Creates a reusable prepared statement resource"),
                ("ClosePreparedStatement",
                 "Closes a reusable prepared statement resource"),
                ("BeginTransaction", "Begins a transaction"),
                ("EndTransaction", "Commits or rolls back a transaction")]

    def _get_flight_info(self, request: bytes, context):
        desc = decode_descriptor(request)
        if not desc["cmd"]:
            return super()._get_flight_info(request, context)
        name, payload = _any_unpack(desc["cmd"])
        if name == "CommandStatementQuery":
            result = execute_select(
                self.sql_tables, bytes(_first(_parse(payload), 1)).decode())
            prefix = "stmt"
        elif name == "CommandPreparedStatementQuery":
            sql = self._prepared.get(bytes(_first(_parse(payload), 1)))
            if sql is None:
                raise st.ComputeError(
                    "flightsql: unknown prepared statement handle")
            result = execute_select(self.sql_tables, sql)
            prefix = "stmt"
        else:
            result = self._metadata_listing(name, payload)
            if result is None:
                raise st.ComputeError(
                    f"flightsql: unsupported command {name}")
            prefix = "meta"
        handle = self._handle(prefix)
        with self._lock:
            self._statements[handle] = result
        return encode_flight_info(result.schema, request,
                                  ticket_statement_query(handle),
                                  total_records=result.length)

    def do_get_batches(self, ticket: bytes):
        # a FlightSQL ticket is an Any-wrapped TicketStatementQuery; it is
        # good for one DoGet, which frees its result
        if ticket.startswith(b"\n"):
            try:
                name, payload = _any_unpack(ticket)
            except Exception:
                name = None
            if name == "TicketStatementQuery":
                handle = bytes(_first(_parse(payload), 1))
                with self._lock:
                    result = self._statements.pop(handle, None)
                if result is None:
                    raise KeyError(handle)
                return result.schema, iter([result])
        return super().do_get_batches(ticket)

    def register_primary_key(self, table: str, columns) -> None:
        """Declare `table`'s primary key for GetPrimaryKeys."""
        self._primary_keys[table] = tuple(columns)

    def register_foreign_key(self, fk_table: str, fk_columns,
                             pk_table: str, pk_columns,
                             key_name: str = "") -> None:
        """Declare a foreign key for GetImportedKeys / GetExportedKeys /
        GetCrossReference."""
        from . import flightsql_meta as fm

        self._foreign_keys.append(fm.ForeignKeyDef(
            fk_table, tuple(fk_columns), pk_table, tuple(pk_columns),
            key_name))

    def _metadata_listing(self, name: str, payload: bytes):
        """The catalog and metadata commands' batches (server.rs do_get_*
        and sql/metadata/), or None for a command it does not know."""
        from . import flightsql_meta as fm

        d = _parse(payload) if payload else {}
        dev = self.device

        def text(fid):
            v = _first(d, fid, None)
            return bytes(v).decode() if v is not None else ""

        if name == "CommandGetTables":
            return fm.tables_batch(self.sql_tables,
                                   include_schema=bool(_first(d, 5, 0)),
                                   device=dev)
        if name == "CommandGetCatalogs":
            return bt.RecordBatch(
                st.Schema((st.Field("catalog_name", st.utf8, False),)),
                (fm._text(["main"], dev),))
        if name == "CommandGetDbSchemas":
            return bt.RecordBatch(
                st.Schema((st.Field("catalog_name", st.utf8),
                           st.Field("db_schema_name", st.utf8, False))),
                (fm._text(["main"], dev), fm._text(["public"], dev)))
        if name == "CommandGetTableTypes":
            return fm.table_types_batch(device=dev)
        if name == "CommandGetSqlInfo":
            raw = _first(d, 1, None)
            if raw is None:
                which = []
            elif isinstance(raw, int):
                which = [raw]
            else:
                which = _packed_varints(bytes(raw))
            return fm.sql_info_batch(self.sql_infos, which, device=dev)
        if name == "CommandGetPrimaryKeys":
            return fm.primary_keys_batch(self._primary_keys, text(3),
                                         device=dev)
        if name in ("CommandGetExportedKeys", "CommandGetImportedKeys"):
            role = "exported" if "Exported" in name else "imported"
            return fm.foreign_keys_batch(self._foreign_keys, text(3), role,
                                         device=dev)
        if name == "CommandGetCrossReference":
            return fm.cross_reference_batch(self._foreign_keys, text(3),
                                            text(6), device=dev)
        if name == "CommandGetXdbcTypeInfo":
            raw = _first(d, 1, None)
            dt_val = None
            if raw is not None and isinstance(raw, int):
                dt_val = raw if raw < 2**31 else raw - 2**64
            return fm.xdbc_type_info_batch(dt_val, device=dev)
        return None


def _packed_varints(raw: bytes) -> List[int]:
    out = []
    pos = 0
    while pos < len(raw):
        v = 0
        shift = 0
        while True:
            b = raw[pos]
            pos += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        out.append(v)
    return out


def _first_ticket(info: bytes) -> Optional[bytes]:
    """The ticket of a FlightInfo's first endpoint, or None."""
    endpoints = _parse(info).get(3, [])
    if not endpoints:
        return None
    return decode_ticket(bytes(_first(_parse(bytes(endpoints[0])), 1)))


class FlightSqlClient:
    """FlightSqlServiceClient (sql/client.rs): `execute` runs
    GetFlightInfo(CommandStatementQuery), then DoGet of its ticket; the
    batches are decoded onto `device` (None: the card)."""

    def __init__(self, location: str, device=None):
        self._inner = FlightClient(location, device)

    def _run_command(self, cmd: bytes) -> List[bt.RecordBatch]:
        """GetFlightInfo(cmd), then DoGet of its first endpoint's ticket."""
        ticket = _first_ticket(self._inner._info(encode_descriptor(cmd=cmd)))
        return [] if ticket is None else self._inner.do_get(ticket)

    def execute(self, sql: str) -> List[bt.RecordBatch]:
        return self._run_command(command_statement_query(sql))

    def prepare(self, sql: str) -> "PreparedStatement":
        """DoAction CreatePreparedStatement -> a handle (client.rs
        prepare)."""
        results = self._inner.do_action(
            "CreatePreparedStatement", action_create_prepared_statement(sql))
        if not results:
            raise st.ComputeError("flightsql: prepare returned no result")
        name, payload = _any_unpack(results[0])
        if name != "ActionCreatePreparedStatementResult":
            raise st.ComputeError(f"flightsql: unexpected result {name}")
        return PreparedStatement(self, bytes(_first(_parse(payload), 1)))

    def get_tables(self) -> List[str]:
        return [name for b in self._run_command(command_get_tables())
                for name in b.to_pydict()["table_name"]]

    def get_sql_info(self, infos=()) -> List[bt.RecordBatch]:
        return self._run_command(command_get_sql_info(infos))

    def get_table_types(self) -> List[str]:
        return [t for b in self._run_command(command_get_table_types())
                for t in b.to_pydict()["table_type"]]

    def get_primary_keys(self, table: str) -> List[bt.RecordBatch]:
        return self._run_command(command_get_primary_keys(table))

    def get_exported_keys(self, table: str) -> List[bt.RecordBatch]:
        return self._run_command(command_get_exported_keys(table))

    def get_imported_keys(self, table: str) -> List[bt.RecordBatch]:
        return self._run_command(command_get_imported_keys(table))

    def get_cross_reference(self, pk_table: str,
                            fk_table: str) -> List[bt.RecordBatch]:
        return self._run_command(
            command_get_cross_reference(pk_table, fk_table))

    def get_xdbc_type_info(self, data_type=None) -> List[bt.RecordBatch]:
        return self._run_command(command_get_xdbc_type_info(data_type))

    def close(self):
        self._inner.close()


class PreparedStatement:
    """A server-side prepared statement (client.rs PreparedStatement):
    `execute` is GetFlightInfo then DoGet, `close` the
    ClosePreparedStatement action."""

    def __init__(self, client: FlightSqlClient, handle: bytes):
        self._client = client
        self.handle = handle

    def execute(self) -> List[bt.RecordBatch]:
        return self._client._run_command(
            command_prepared_statement_query(self.handle))

    def close(self) -> None:
        self._client._inner.do_action(
            "ClosePreparedStatement",
            action_close_prepared_statement(self.handle))
