"""Where the buffers of each record batch of an Arrow IPC stream or file
lie, found with the port's own message parser; the tests (and
`chip_smoke.py`) patch bytes there to feed the readers malformed input.
Imports no JAX, so the card's tests can use it too."""

import struct

from arrowtpu_torch import schema as st
from arrowtpu_torch.formats import ipc


def buffer_count(dt: st.DataType) -> int:
    """The buffers of a column of `dt` and its children, as a record
    batch lists them."""
    if isinstance(dt, st.Null):
        return 0
    if isinstance(dt, st.Union):
        return (2 if dt.mode == "dense" else 1) + sum(
            buffer_count(f.dtype) for f in dt.fields)
    if isinstance(dt, (st.Utf8, st.Binary)):
        return 3
    if isinstance(dt, st.Map):
        return 2 + buffer_count(dt.entry_struct)
    if isinstance(dt, st.List):
        return 2 + buffer_count(dt.value)
    if isinstance(dt, st.Struct):
        return 1 + sum(buffer_count(f.dtype) for f in dt.fields)
    if isinstance(dt, st.FixedSizeList):
        return 1 + buffer_count(dt.value)
    return 2  # validity and values (or keys)


def batch_buffers(source):
    """Per record batch, {field name: [(offset in the source, length) of
    each of its column's buffers, in the order the batch lists them]}; a
    compressed buffer's span holds its 8-byte length prefix too."""
    buf = ipc._source_view(source)
    m = ipc._parse_message(buf, 8 if buf[:6] == ipc.MAGIC else 0)
    fields = ipc._read_schema_fb(m[1]).fields
    out = []
    while True:
        m = ipc._parse_message(buf, m[4])
        if m is None:
            return out
        header_type, header, body_start, _, _ = m
        if header_type != ipc.H_BATCH:
            continue
        spans = [(body_start + off, ln) for off, ln in (
            struct.unpack("<qq", s) for s in header.vector_structs(2, 16))]
        per_field = {}
        for f in fields:
            k = buffer_count(f.dtype)
            per_field[f.name], spans = spans[:k], spans[k:]
        out.append(per_field)
