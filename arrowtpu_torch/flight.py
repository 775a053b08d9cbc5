"""Arrow Flight: the gRPC data plane of the arrow.flight.protocol service.

Counterpart of `arrowtpu/flight.py`, after arrow-rs's arrow-flight crate
(the tonic service of format/Flight.proto; FlightClient, client.rs:71,
with do_get :213 and do_put :368; FlightDataEncoder, encode.rs:145,
which ships an IPC message's metadata and body in separate protobuf
fields; FlightDataDecoder, decode.rs:225).

Flight is the host's ingest and egress plane.  The protobuf messages are
encoded by hand (the wire format is a dozen tag / length rules), the IPC
messages by the port's `formats/ipc.py`, and the service is registered
with grpc's generic handlers under the real service name, so stock
`pyarrow.flight` clients and servers interoperate.  `grpc` is imported
inside `FlightServer.serve` and `FlightClient`, never when this module is
imported.  Batches a server receives and a client reads are decoded onto
their `device` (None: the card).  `stop` waits for the server's threads
and a client's `close` ends its channel, so neither leaves a thread
behind.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterable, List

from . import schema as st
from .config import resolve_device
from .core import batch as bt
from .formats import ipc

SERVICE = "arrow.flight.protocol.FlightService"

# ---------------------------------------------------------------------------
# protobuf's wire format: varints and length-delimited fields
# ---------------------------------------------------------------------------


def _w_varint(out: bytearray, v: int):
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _w_bytes(out: bytearray, field: int, data: bytes):
    _w_varint(out, (field << 3) | 2)
    _w_varint(out, len(data))
    out += data


def _w_int(out: bytearray, field: int, v: int):
    if v == 0:
        return
    _w_varint(out, field << 3)
    _w_varint(out, v)


def _r_varint(buf, pos: int):
    v = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7


def _parse(buf: bytes) -> Dict[int, list]:
    """A message's fields: {number: [varint int or bytes, ...]}."""
    out: Dict[int, list] = {}
    pos = 0
    while pos < len(buf):
        tag, pos = _r_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v, pos = _r_varint(buf, pos)
        elif wire in (1, 2, 5):
            if wire == 2:
                ln, pos = _r_varint(buf, pos)
            else:
                ln = 8 if wire == 1 else 4
            v = buf[pos:pos + ln]
            pos += ln
        else:
            raise st.ArrowTpuError(f"flight: unsupported wire type {wire}")
        out.setdefault(field, []).append(v)
    return out


def _first(d: Dict[int, list], field: int, default=b""):
    return d[field][0] if field in d else default


# ---------------------------------------------------------------------------
# Flight's messages
# ---------------------------------------------------------------------------


def encode_ticket(ticket: bytes) -> bytes:
    out = bytearray()
    _w_bytes(out, 1, ticket)
    return bytes(out)


def decode_ticket(buf: bytes) -> bytes:
    return bytes(_first(_parse(buf), 1))


def encode_descriptor(path: List[str] = None, cmd: bytes = None) -> bytes:
    out = bytearray()
    if cmd is not None:
        _w_int(out, 1, 2)  # CMD
        _w_bytes(out, 2, cmd)
    else:
        _w_int(out, 1, 1)  # PATH
        for p in path or []:
            _w_bytes(out, 3, p.encode("utf-8"))
    return bytes(out)


def decode_descriptor(buf: bytes):
    d = _parse(buf)
    dtype = _first(d, 1, 0)
    return {"type": dtype if isinstance(dtype, int) else 0,
            "cmd": bytes(_first(d, 2)),
            "path": [bytes(p).decode("utf-8") for p in d.get(3, [])]}


def _dataset_name(desc: dict) -> str:
    return desc["path"][0] if desc["path"] else desc["cmd"].decode()


def encode_flight_data(data_header: bytes, data_body: bytes,
                       descriptor: bytes = None,
                       app_metadata: bytes = b"") -> bytes:
    out = bytearray()
    if descriptor:
        _w_bytes(out, 1, descriptor)
    _w_bytes(out, 2, data_header)
    if app_metadata:
        _w_bytes(out, 3, app_metadata)
    _w_bytes(out, 1000, data_body)
    return bytes(out)


def decode_flight_data(buf: bytes):
    d = _parse(buf)
    return {"descriptor": bytes(_first(d, 1)),
            "data_header": bytes(_first(d, 2)),
            "app_metadata": bytes(_first(d, 3)),
            "data_body": bytes(_first(d, 1000))}


def encode_batches(schema: st.Schema, batches: Iterable[bt.RecordBatch],
                   descriptor: bytes = None):
    """FlightData messages of a stream, as DoGet sends them (encode.rs):
    the schema (with `descriptor`, when given), then each batch's
    dictionaries not sent yet and the batch."""
    dict_ids: Dict[str, int] = {}
    sent: set = set()
    yield encode_flight_data(ipc.encode_schema_message(schema, dict_ids),
                             b"", descriptor=descriptor)
    for b in batches:
        for meta, body in ipc.encode_batch_messages(b, dict_ids, sent):
            yield encode_flight_data(meta, body)


def decode_batches(messages, device=None):
    """FlightData messages -> (the first descriptor, decoded, or None;
    the batches on `device`) (decode.rs FlightDataDecoder)."""
    decoder = ipc.MessageDecoder(device)
    descriptor = None
    batches: List[bt.RecordBatch] = []
    for raw in messages:
        fd = decode_flight_data(raw)
        if fd["descriptor"] and descriptor is None:
            descriptor = decode_descriptor(fd["descriptor"])
        if fd["data_header"]:
            out = decoder.decode(fd["data_header"], fd["data_body"])
            if out is not None:
                batches.append(out)
    return descriptor, batches


_NO_DESCRIPTOR = {"path": [], "cmd": b""}


def _ipc_framed_schema(schema: st.Schema) -> bytes:
    """FlightInfo.schema and SchemaResult.schema: the IPC-encapsulated
    schema message (continuation, length, flatbuffer)."""
    meta = ipc.encode_schema_message(schema, {})
    return struct.pack("<Ii", ipc.CONTINUATION, len(meta)) + meta


def encode_flight_info(schema: st.Schema, descriptor: bytes, ticket: bytes,
                       total_records: int = -1,
                       total_bytes: int = -1) -> bytes:
    out = bytearray()
    _w_bytes(out, 1, _ipc_framed_schema(schema))
    _w_bytes(out, 2, descriptor)
    ep = bytearray()
    _w_bytes(ep, 1, encode_ticket(ticket))
    _w_bytes(out, 3, bytes(ep))
    if total_records >= 0:
        _w_int(out, 4, total_records)
    if total_bytes >= 0:
        _w_int(out, 5, total_bytes)
    return bytes(out)


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

# the service's methods: (gRPC kind, FlightServer method)
_METHODS = {
    "DoAction": ("unary_stream", "_do_action"),
    "ListActions": ("unary_stream", "_list_actions"),
    "DoGet": ("unary_stream", "_do_get"),
    "DoPut": ("stream_stream", "_do_put"),
    "GetFlightInfo": ("unary_unary", "_get_flight_info"),
    "GetSchema": ("unary_unary", "_get_schema"),
    "ListFlights": ("unary_stream", "_list_flights"),
    "Handshake": ("stream_stream", "_handshake"),
    "DoExchange": ("stream_stream", "_do_exchange"),
}


def _raw(x):
    return x


class FlightServer:
    """An in-process Flight service over a registry of named datasets
    (the FlightService trait, examples/flight/server).

    Override `do_get_batches(ticket) -> (schema, iter[RecordBatch])` and
    `do_put_batches(descriptor, iter[RecordBatch])` to serve something
    else.  Batches put to it are decoded onto `device` (None: the
    card)."""

    def __init__(self, device=None):
        self.tables: Dict[str, List[bt.RecordBatch]] = {}
        self.device = resolve_device(device)
        self._server = None
        self._pool = None

    # -- what a subclass overrides ------------------------------------------
    def do_exchange_batches(self, descriptor: dict,
                            batches: Iterable[bt.RecordBatch]):
        """DoExchange (client.rs:422): the client's batches in, the
        response batches out; an echo by default."""
        return list(batches)

    def handshake_payload(self, payload: bytes) -> bytes:
        """Handshake: the response payload; an echo (no auth) by
        default."""
        return payload

    def do_get_batches(self, ticket: bytes):
        name = ticket.decode("utf-8")
        batches = self.tables.get(name)
        if batches is None:
            raise KeyError(f"no dataset {name!r}")
        return batches[0].schema, iter(batches)

    def do_put_batches(self, descriptor: dict,
                       batches: Iterable[bt.RecordBatch]):
        self.tables[_dataset_name(descriptor)] = list(batches)

    def do_action(self, action_type: str, body: bytes):
        """FlightService::do_action: an iterable of result bodies."""
        raise st.ComputeError(f"unsupported action {action_type!r}")

    def list_actions(self):
        """[(type, description)] (ListActions)."""
        return []

    # -- the gRPC methods -----------------------------------------------------
    def _do_get(self, request: bytes, context):
        schema, batches = self.do_get_batches(decode_ticket(request))
        yield from encode_batches(schema, batches)

    def _do_put(self, request_iterator, context):
        descriptor, batches = decode_batches(request_iterator, self.device)
        self.do_put_batches(descriptor or _NO_DESCRIPTOR, batches)
        yield b""  # one empty PutResult

    def _get_flight_info(self, request: bytes, context):
        name = _dataset_name(decode_descriptor(request))
        batches = self.tables.get(name)
        if batches is None:
            raise KeyError(name)
        return encode_flight_info(
            batches[0].schema, request, name.encode("utf-8"),
            total_records=sum(b.length for b in batches))

    def _get_schema(self, request: bytes, context):
        name = _dataset_name(decode_descriptor(request))
        out = bytearray()
        _w_bytes(out, 1, _ipc_framed_schema(self.tables[name][0].schema))
        return bytes(out)

    def _handshake(self, request_iterator, context):
        for raw in request_iterator:
            out = bytearray()
            _w_int(out, 1, 1)  # protocol_version
            resp = self.handshake_payload(bytes(_first(_parse(raw), 2)))
            if resp:
                _w_bytes(out, 2, resp)
            yield bytes(out)

    def _do_exchange(self, request_iterator, context):
        descriptor, batches = decode_batches(request_iterator, self.device)
        result = list(self.do_exchange_batches(descriptor or _NO_DESCRIPTOR,
                                               batches))
        if result:
            yield from encode_batches(result[0].schema, result)

    def _list_flights(self, request: bytes, context):
        for name, batches in self.tables.items():
            yield encode_flight_info(
                batches[0].schema, encode_descriptor(path=[name]),
                name.encode("utf-8"),
                total_records=sum(b.length for b in batches))

    def _do_action(self, request: bytes, context):
        # Action{type=1 string, body=2 bytes} -> a stream of Result{body=1}
        d = _parse(request)
        for result_body in self.do_action(bytes(_first(d, 1)).decode(),
                                          bytes(_first(d, 2))):
            out = bytearray()
            _w_bytes(out, 1, result_body)
            yield bytes(out)

    def _list_actions(self, request: bytes, context):
        for name, desc in self.list_actions():
            out = bytearray()
            _w_bytes(out, 1, name.encode())
            _w_bytes(out, 2, desc.encode())
            yield bytes(out)

    def serve(self, port: int = 0) -> int:
        """Start on 127.0.0.1 (`port` 0: one the OS picks); -> the port."""
        import grpc
        from concurrent import futures

        handlers = {
            name: getattr(grpc, f"{kind}_rpc_method_handler")(
                getattr(self, method), request_deserializer=_raw,
                response_serializer=_raw)
            for name, (kind, method) in _METHODS.items()}
        self._pool = futures.ThreadPoolExecutor(max_workers=8)
        server = grpc.server(self._pool)
        server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE, handlers),))
        port = server.add_insecure_port(f"127.0.0.1:{port}")
        server.start()
        self._server = server
        return port

    def stop(self):
        """Stop serving and wait until the server's threads have ended."""
        if self._server is not None:
            self._server.stop(grace=None).wait()
            self._server = None
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class FlightClient:
    """FlightClient (client.rs:71); the batches it reads are decoded onto
    `device` (None: the card)."""

    def __init__(self, location: str, device=None):
        import grpc

        self.device = resolve_device(device)
        if location.startswith("grpc://"):
            location = location[len("grpc://"):]
        self._channel = grpc.insecure_channel(location)

        def rpc(kind, name):
            return getattr(self._channel, kind)(
                f"/{SERVICE}/{name}", request_serializer=_raw,
                response_deserializer=_raw)

        self._do_get = rpc("unary_stream", "DoGet")
        self._do_put = rpc("stream_stream", "DoPut")
        self._info = rpc("unary_unary", "GetFlightInfo")
        self._list = rpc("unary_stream", "ListFlights")
        self._handshake_rpc = rpc("stream_stream", "Handshake")
        self._exchange_rpc = rpc("stream_stream", "DoExchange")
        self._action_rpc = rpc("unary_stream", "DoAction")

    def do_action(self, action_type: str, body: bytes = b"") -> List[bytes]:
        """client.rs do_action: the Result bodies."""
        req = bytearray()
        _w_bytes(req, 1, action_type.encode())
        if body:
            _w_bytes(req, 2, body)
        return [bytes(_first(_parse(chunk), 1))
                for chunk in self._action_rpc(bytes(req))]

    def do_get(self, ticket: bytes) -> List[bt.RecordBatch]:
        """client.rs:213."""
        return decode_batches(self._do_get(encode_ticket(ticket)),
                              self.device)[1]

    def do_put(self, path: str, batches: List[bt.RecordBatch]):
        """client.rs:368."""
        return list(self._do_put(encode_batches(
            batches[0].schema, batches, encode_descriptor(path=[path]))))

    def get_flight_info(self, path: str) -> dict:
        d = _parse(self._info(encode_descriptor(path=[path])))
        total = _first(d, 4, 0)
        return {"tickets": [decode_ticket(bytes(_first(_parse(bytes(ep)), 1)))
                            for ep in d.get(3, [])],
                "total_records": total if isinstance(total, int) else 0}

    def list_flights(self) -> List[dict]:
        return [{"path": decode_descriptor(bytes(_first(_parse(raw), 2)))[
            "path"]} for raw in self._list(b"")]

    def handshake(self, payload: bytes = b"") -> bytes:
        """client.rs handshake: one round trip -> the server's payload."""
        req = bytearray()
        _w_int(req, 1, 1)
        if payload:
            _w_bytes(req, 2, payload)
        for raw in self._handshake_rpc(iter([bytes(req)])):
            return bytes(_first(_parse(raw), 2))
        return b""

    def do_exchange(self, path: str, batches: List[bt.RecordBatch]):
        """DoExchange (client.rs:422): the batches sent, the response
        batches decoded."""
        return decode_batches(self._exchange_rpc(encode_batches(
            batches[0].schema, batches, encode_descriptor(path=[path]))),
            self.device)[1]

    def close(self):
        self._channel.close()
