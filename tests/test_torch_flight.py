"""arrowtpu_torch's Flight and FlightSQL (flight.py, flightsql.py,
flightsql_meta.py) against the JAX package's and stock pyarrow.flight,
over in-process gRPC servers on localhost.

Tolerance: exact.  The port's client reads the JAX package's server and
the JAX package's client the port's, to the batches served (compared
column by column); stock pyarrow.flight clients get, put, list and run
FlightSQL statements, prepared statements and metadata commands against
the port's server, and the port's client reads a pyarrow server.  The
FlightData messages of a DoGet, the IPC messages of every metadata batch
and the command encoders' bytes equal the JAX package's; `execute_select`
and each metadata command give the JAX package's batches.  Every server
is stopped (the JAX package's thread pool shut down too) and every client
closed: no thread started here outlives the file.
"""

import threading

import numpy as np
import pyarrow as pa
import pyarrow.flight as paf
import pytest

from arrowtpu import flight as jfl
from arrowtpu import flightsql as jsql
from arrowtpu import flightsql_meta as jmeta
from arrowtpu.formats import ipc as jipc
from arrowtpu.interop import pyarrow_bridge as jpb

from arrowtpu_torch import flight as pfl
from arrowtpu_torch import flightsql as psql
from arrowtpu_torch import flightsql_meta as pmeta
from arrowtpu_torch import schema as ps
from arrowtpu_torch.formats import ipc as pipc
from arrowtpu_torch.interop import pyarrow_bridge as ppb
from torch_parity import assert_batch_equal, release_jax_caches  # noqa: F401

N = 2000
THREADS_AT_START = []


def _table(seed=0, n=N):
    rng = np.random.default_rng(seed)
    words = np.array(["a", "bb", "a string longer than twelve", ""], object)
    return pa.table({
        "k": pa.array(rng.integers(0, 10, n), pa.int64()),
        "v": pa.array(rng.integers(-50, 50, n), pa.int64(),
                      mask=rng.random(n) < 0.1),
        "u": pa.array(rng.integers(0, 300, n).astype(np.uint32)),
        "s": pa.array(words[rng.integers(0, 4, n)], pa.utf8(),
                      mask=rng.random(n) < 0.1),
        "f": pa.array(rng.normal(0, 1, n), pa.float64())})


def _pair(table):
    rb = table.combine_chunks().to_batches()[0]
    return jpb.from_pyarrow(rb), ppb.from_pyarrow(rb, device="cpu")


def _stop_jax(server):
    """The JAX package's stop, then a wait for its gRPC server and its
    thread pool, which that stop leaves running."""
    grpc_server = server._server
    if grpc_server is None:
        return
    server.stop()
    grpc_server.stop(None).wait()
    grpc_server._state.thread_pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def data():
    return _pair(_table(0)), _pair(_table(1, 300))


@pytest.fixture(scope="module")
def servers(data):
    """A FlightSqlServer of each package over the same table "t", with
    the dataset "demo" (two batches) and keys declared."""
    THREADS_AT_START.extend(threading.enumerate())
    (jt, pt_), (j2, p2) = data
    p = psql.FlightSqlServer({"t": pt_}, device="cpu")
    j = jsql.FlightSqlServer({"t": jt})
    p.tables["demo"] = [pt_, p2]
    j.tables["demo"] = [jt, j2]
    for s in (p, j):
        s.register_table("u", s.sql_tables["t"])
        s.register_primary_key("t", ["k"])
        s.register_foreign_key("u", ["k"], "t", ["k"], "fk_u")
    ports = p.serve(), j.serve()
    yield p, j, ports
    p.stop()
    _stop_jax(j)


def _loc(port):
    return f"grpc://127.0.0.1:{port}"


def test_port_client_reads_jax_server_and_back(servers):
    p, j, (pport, jport) = servers
    pc = pfl.FlightClient(_loc(jport), device="cpu")
    jc = jfl.FlightClient(_loc(pport))
    try:
        got, want = pc.do_get(b"demo"), jc.do_get(b"demo")
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert_batch_equal(w, g)
        assert pc.get_flight_info("demo") == jc.get_flight_info("demo") == {
            "tickets": [b"demo"], "total_records": N + 300}
        assert {"path": ["demo"]} in pc.list_flights()
        assert pc.handshake(b"hello") == jc.handshake(b"hello") == b"hello"
    finally:
        pc.close()
        jc.close()


def test_do_get_messages_equal_jax(servers):
    p, j, _ = servers
    req = pfl.encode_ticket(b"demo")
    assert req == jfl.encode_ticket(b"demo")
    assert list(p._do_get(req, None)) == list(j._do_get(req, None))
    assert pfl.encode_flight_info(p.tables["demo"][0].schema, b"d", b"t",
                                  7) == \
        jfl.encode_flight_info(j.tables["demo"][0].schema, b"d", b"t", 7)
    for desc in (dict(path=["a", "b"]), dict(cmd=b"\x01\x02")):
        assert pfl.encode_descriptor(**desc) == jfl.encode_descriptor(**desc)


def test_put_and_exchange_both_ways(servers, data):
    p, j, (pport, jport) = servers
    (jt, pt_), _ = data
    pc = pfl.FlightClient(_loc(jport), device="cpu")
    jc = jfl.FlightClient(_loc(pport))
    try:
        pc.do_put("from_port", [pt_])
        jc.do_put("from_jax", [jt])
        assert_batch_equal(j.tables["from_port"][0], p.tables["from_jax"][0])
        assert_batch_equal(jc.do_exchange("x", [jt])[0],
                           pc.do_exchange("x", [pt_])[0])
    finally:
        pc.close()
        jc.close()


def test_stock_pyarrow_client_against_port_server(servers, data):
    p, _, (pport, _) = servers
    (_, pt_), (_, p2) = data
    client = paf.connect(_loc(pport))
    try:
        table = client.do_get(paf.Ticket(b"demo")).read_all()
        assert table.to_pydict() == {k: pt_.to_pydict()[k] + p2.to_pydict()[k]
                                     for k in table.schema.names}
        info = client.get_flight_info(paf.FlightDescriptor.for_path("demo"))
        assert info.total_records == N + 300
        t = pa.table({"y": pa.array([1.5, None], pa.float64()),
                      "d": pa.array(["a", "b"]).dictionary_encode()})
        writer, _ = client.do_put(paf.FlightDescriptor.for_path("from_pa"),
                                  t.schema)
        writer.write_table(t)
        writer.close()
        assert p.tables["from_pa"][0].to_pydict() == {"y": [1.5, None],
                                                      "d": ["a", "b"]}
        assert {f.descriptor.path[0] for f in client.list_flights()} >= {
            b"demo", b"from_pa"}
        client.wait_for_available(timeout=5)
    finally:
        client.close()


class _PaServer(paf.FlightServerBase):
    def __init__(self):
        super().__init__("grpc://127.0.0.1:0")
        self.table = pa.table({"z": pa.array([7, None, 9], pa.int64()),
                               "d": pa.array(["x", None, "x"])
                               .dictionary_encode()})

    def do_get(self, context, ticket):
        return paf.RecordBatchStream(self.table)


def test_port_client_reads_pyarrow_server():
    s = _PaServer()
    c = pfl.FlightClient(_loc(s.port), device="cpu")
    try:
        got = c.do_get(b"anything")
        assert [v for b in got for v in b.to_pydict()["z"]] == [7, None, 9]
        assert [v for b in got for v in b.to_pydict()["d"]] == ["x", None,
                                                                "x"]
    finally:
        c.close()
        s.shutdown()


QUERIES = ["SELECT k, v FROM t WHERE v > 0 AND k <= 5 LIMIT 7",
           "SELECT * FROM t WHERE u <> 0 AND u < 150",
           "SELECT s, f FROM t WHERE k = 3 LIMIT 100000",
           "select u from t where f >= 0.5"]


def test_execute_select_equals_jax(data):
    (jt, pt_), _ = data
    for q in QUERIES:
        assert_batch_equal(jsql.execute_select({"t": jt}, q),
                           psql.execute_select({"t": pt_}, q))
    for bad in ("DROP TABLE t", "SELECT * FROM missing",
                "SELECT k FROM t WHERE k ~ 1"):
        with pytest.raises(ps.ComputeError):
            psql.execute_select({"t": pt_}, bad)


def test_flightsql_statements_both_ways(servers, data):
    p, j, (pport, jport) = servers
    (jt, pt_), _ = data
    pc = psql.FlightSqlClient(_loc(jport), device="cpu")
    jc = jsql.FlightSqlClient(_loc(pport))
    try:
        for q in QUERIES[:2]:
            assert_batch_equal(jsql.execute_select({"t": jt}, q),
                               pc.execute(q)[0])
            assert_batch_equal(jc.execute(q)[0],
                               psql.execute_select({"t": pt_}, q))
        prep = pc.prepare(QUERIES[0])
        want = jsql.execute_select({"t": jt}, QUERIES[0])
        for _ in range(2):
            assert_batch_equal(want, prep.execute()[0])
        prep.close()
        with pytest.raises(Exception):
            prep.execute()
        assert pc.get_tables() == jc.get_tables() == ["t", "u"]
    finally:
        pc.close()
        jc.close()


def test_stock_pyarrow_flightsql(servers, data):
    p, _, (pport, _) = servers
    (jt, _), _ = data
    client = paf.FlightClient(_loc(pport))
    try:
        q = QUERIES[1]
        info = client.get_flight_info(paf.FlightDescriptor.for_command(
            psql.command_statement_query(q)))
        table = client.do_get(info.endpoints[0].ticket).read_all()
        want = jsql.execute_select({"t": jt}, q).to_pydict()
        assert table.to_pydict() == want
        result = list(client.do_action(paf.Action(
            "CreatePreparedStatement",
            psql.action_create_prepared_statement(QUERIES[0]))))
        name, payload = psql._any_unpack(result[0].body.to_pybytes())
        assert name == "ActionCreatePreparedStatementResult"
        handle = bytes(psql._first(psql._parse(payload), 1))
        info = client.get_flight_info(paf.FlightDescriptor.for_command(
            psql.command_prepared_statement_query(handle)))
        table = client.do_get(info.endpoints[0].ticket).read_all()
        assert table.to_pydict() == jsql.execute_select(
            {"t": jt}, QUERIES[0]).to_pydict()
        assert {a.type for a in client.list_actions()} == {
            "CreatePreparedStatement", "ClosePreparedStatement",
            "BeginTransaction", "EndTransaction"}
        for cmd in (psql.command_get_sql_info([0]),
                    psql.command_get_table_types(),
                    psql.command_get_primary_keys("t"),
                    psql.command_get_xdbc_type_info()):
            info = client.get_flight_info(
                paf.FlightDescriptor.for_command(cmd))
            assert client.do_get(info.endpoints[0].ticket).read_all() \
                .num_rows > 0
    finally:
        client.close()


def _messages(pkg_ipc, batch):
    return pkg_ipc.encode_schema_message(batch.schema, {}), \
        pkg_ipc.encode_batch_messages(batch, {}, set())


COMMANDS = [("get_catalogs", ()), ("get_db_schemas", ()),
            ("get_tables", ()), ("get_table_types", ()),
            ("get_sql_info", ()), ("get_sql_info", ([1, 8, 504],)),
            ("get_primary_keys", ("t",)), ("get_exported_keys", ("t",)),
            ("get_imported_keys", ("u",)), ("get_imported_keys", ("t",)),
            ("get_cross_reference", ("t", "u")),
            ("get_xdbc_type_info", ()), ("get_xdbc_type_info", (-5,)),
            ("get_xdbc_type_info", (12,))]


def test_metadata_commands_equal_jax(servers):
    """Each command's encoding, and the batch the port's server answers
    with, against the JAX package's: the same IPC messages."""
    p, j, (pport, jport) = servers
    pc = psql.FlightSqlClient(_loc(pport), device="cpu")
    jc = jsql.FlightSqlClient(_loc(jport))
    try:
        for name, args in COMMANDS:
            cmd = getattr(psql, "command_" + name)(*args)
            assert cmd == getattr(jsql, "command_" + name)(*args), name
            got, want = pc._run_command(cmd), jc._run_command(cmd)
            assert len(got) == len(want) == 1, name
            assert _messages(pipc, got[0]) == _messages(jipc, want[0]), name
            assert got[0].to_pydict() == want[0].to_pydict(), name
    finally:
        pc.close()
        jc.close()


def test_metadata_builders_equal_jax():
    infos = {**jmeta.default_sql_infos(), 900: ["a", "b"],
             901: {1: [2, 3], 4: []}}
    pairs = [
        (jmeta.sql_info_batch(infos), pmeta.sql_info_batch(infos,
                                                           device="cpu")),
        (jmeta.table_types_batch(("VIEW", "TABLE")),
         pmeta.table_types_batch(("VIEW", "TABLE"), device="cpu")),
        (jmeta.primary_keys_batch({}, "t"),
         pmeta.primary_keys_batch({}, "t", device="cpu")),
        (jmeta.cross_reference_batch([], "a", "b"),
         pmeta.cross_reference_batch([], "a", "b", device="cpu"))]
    for want, got in pairs:
        assert _messages(pipc, got) == _messages(jipc, want)
        assert got.to_pydict() == want.to_pydict()


def test_transactions(servers):
    p, _, (pport, _) = servers
    c = pfl.FlightClient(_loc(pport), device="cpu")
    try:
        res = c.do_action("BeginTransaction", psql._any_pack(
            "ActionBeginTransactionRequest", b""))
        name, payload = psql._any_unpack(res[0])
        assert name == "ActionBeginTransactionResult"
        handle = bytes(psql._first(psql._parse(payload), 1))
        assert handle.startswith(b"txn-")
        inner = bytearray()
        psql._w_bytes(inner, 1, handle)
        end = psql._any_pack("ActionEndTransactionRequest", bytes(inner))
        assert c.do_action("EndTransaction", end) == []
        with pytest.raises(Exception):
            c.do_action("EndTransaction", end)  # the handle is gone
    finally:
        c.close()


def test_zz_no_server_thread_outlives_the_file(servers):
    """The module's servers stop at its end, so stop them here and count:
    `threading.active_count()` is the file's start count, less the
    threads of earlier files that ended meanwhile (a JAX server's pool,
    once collected): no thread this file started is alive."""
    p, j, _ = servers
    p.stop()
    _stop_jax(j)
    started = [t.name for t in threading.enumerate()
               if t not in THREADS_AT_START]
    assert not started, started
    assert threading.active_count() == sum(t.is_alive()
                                           for t in THREADS_AT_START)
