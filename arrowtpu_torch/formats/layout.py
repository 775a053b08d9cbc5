"""Arrow physical layout <-> columns, on the host in numpy.

Counterpart of `arrowtpu/formats/layout.py`: a `Node` is one array of the
Arrow columnar format (its length, null count and buffers, then its
children in preorder), the shape the IPC format and the C Data Interface
flatten.  `column_to_layout` reads a column's buffers to the host (one
copy a buffer, cut to the live rows); `layout_to_column` builds a column
from them on a device (None: the card).

The port's bitmaps are Arrow's own LSB order, so validity and boolean
buffers cross as bytes with no bit reordering; a buffer's bits past the
length are zero.  Per class: a primitive is [validity, values] (a
decimal's, interval's or fixed-size binary's values are its 32-bit words,
as in the JAX package); a string view becomes offsets and data
(`string_offsets_data`); a dictionary is its keys' node with the value
column beside it; a list view becomes offsets and the child gathered in
row order (`list_flat_indices`); a struct and a fixed-size list are
[validity] and their children; a union is [type ids (+ offsets when
dense)] with no validity.  Run-end columns have no layout here, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .. import schema as st
from ..config import resolve_device, round_up
from ..core import bitmap as bm
from ..core import column as col


@dataclasses.dataclass
class Node:
    """(length, null_count) + this column's own buffers, preorder children."""

    length: int
    null_count: int
    buffers: List[np.ndarray]  # uint8 arrays
    children: List["Node"]
    dictionary: Optional[col.Column] = None  # set on dictionary columns


# ---------------------------------------------------------------------------
# column -> layout
# ---------------------------------------------------------------------------


def bits_buf(bitmap: torch.Tensor, n: int) -> np.ndarray:
    """A packed bitmap's first n bits as Arrow's bytes (bits past n 0)."""
    return bm.clip(bitmap, n)[:(n + 7) // 8].cpu().numpy()


def validity_buf(c: col.Column, n: int):
    """-> (Arrow validity bytes, empty when no row is null; null count)."""
    if c.validity is None:
        return np.zeros(0, np.uint8), 0
    buf = bits_buf(c.validity, n)
    nulls = n - int(np.unpackbits(buf).sum())
    if nulls == 0:
        return np.zeros(0, np.uint8), 0
    return buf, nulls


def valid_bools(c: col.Column) -> np.ndarray:
    """The column's rows are valid, as host bools."""
    return c.valid_bool()[:c.length].cpu().numpy()


def string_offsets64(c: col.StringViewColumn):
    """views + arena -> (int64 offsets, uint8 data) on the host, the bytes
    gathered on the column's device from two pools (the arena for strings
    of more than 12 bytes, the view words themselves for inline ones), so
    only the live strings' bytes cross to the host."""
    n = c.length
    dev = c.device
    views = c.views[:n]
    lens = torch.where(c.valid_bool()[:n], views[:, 0].to(torch.int64), 0)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(lens, 0, out=offsets[1:])
    total = int(offsets[-1])
    if not total:
        return offsets.cpu().numpy(), np.zeros(0, np.uint8)
    arena_len = c.arena.shape[0]
    pool = torch.cat([c.arena, views.contiguous().view(torch.uint8).reshape(
        -1)])
    src = torch.where(views[:, 0] <= 12,
                      arena_len + torch.arange(n, device=dev) * 16 + 4,
                      views[:, 3].to(torch.int64) & 0xFFFFFFFF)
    idx = torch.arange(total, device=dev) + torch.repeat_interleave(
        src - offsets[:-1], lens, output_size=total)
    return offsets.cpu().numpy(), pool[idx].cpu().numpy()


def string_offsets_data(c: col.StringViewColumn):
    """views + arena -> (int32 offsets, uint8 data)."""
    offsets, data = string_offsets64(c)
    return offsets.astype(np.int32), data


def list_flat_indices(c: col.ListViewColumn):
    """(start, size) views -> (int32 offsets, child row of each item)."""
    n = c.length
    starts = c.starts[:n].cpu().numpy().astype(np.int64)
    sizes = np.where(valid_bools(c),
                     c.sizes[:n].cpu().numpy().astype(np.int64), 0)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    total = int(offsets[-1])
    idx = (np.arange(total, dtype=np.int64) - np.repeat(offsets[:-1], sizes)
           + np.repeat(starts, sizes))
    return offsets.astype(np.int32), idx


def _bytes(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8).reshape(-1)


def column_to_layout(c: col.Column) -> Node:
    n = c.length
    if isinstance(c, col.NullColumn):
        return Node(n, n, [], [])
    if isinstance(c, col.DictionaryColumn):
        keys = column_to_layout(c.keys)
        return Node(n, keys.null_count, keys.buffers, [], dictionary=c.values)
    if isinstance(c, col.UnionColumn):
        bufs = [_bytes(c.type_id_arr[:n].cpu().numpy().astype(np.int8))]
        if c.offsets is not None:
            bufs.append(_bytes(c.offsets[:n].cpu().numpy().astype(np.int32)))
        return Node(n, 0, bufs, [column_to_layout(ch) for ch in c.children])
    if isinstance(c, col.RunEndColumn):
        raise st.SchemaError(f"no arrow layout for {type(c).__name__}")
    vbuf, nulls = validity_buf(c, n)
    if isinstance(c, col.BooleanColumn):
        return Node(n, nulls, [vbuf, bits_buf(c.values, n)], [])
    if isinstance(c, col.PrimitiveColumn):
        return Node(n, nulls, [vbuf, _bytes(c.values[:n].cpu().numpy())], [])
    if isinstance(c, col.StringViewColumn):
        offsets, data = string_offsets_data(c)
        return Node(n, nulls, [vbuf, _bytes(offsets), data], [])
    if isinstance(c, col.ListViewColumn):
        from ..ops.take import take

        offsets, idx = list_flat_indices(c)
        flat = take(c.child, col.primitive(idx.astype(np.int32), st.int32,
                                           device=c.device))
        return Node(n, nulls, [vbuf, _bytes(offsets)],
                    [column_to_layout(flat)])
    if isinstance(c, col.StructColumn):
        return Node(n, nulls, [vbuf],
                    [column_to_layout(ch) for ch in c.children])
    if isinstance(c, col.FixedSizeListColumn):
        return Node(n, nulls, [vbuf], [column_to_layout(c.child)])
    raise st.SchemaError(f"no arrow layout for {type(c).__name__}")


# ---------------------------------------------------------------------------
# layout -> column
# ---------------------------------------------------------------------------


def _bools(buf: np.ndarray, n: int) -> np.ndarray:
    return np.unpackbits(buf[:(n + 7) // 8], bitorder="little")[:n].astype(
        bool)


def _validity(node: Node) -> Optional[np.ndarray]:
    """The node's valid rows as bools, or None when all are valid."""
    if node.null_count == 0 or not node.buffers or not len(node.buffers[0]):
        return None
    return _bools(node.buffers[0], node.length)


def _values(buf: np.ndarray, npdt, count: int, ok) -> np.ndarray:
    """`count` values of `npdt` from a buffer, 0 under a null."""
    vals = np.frombuffer(buf, dtype=npdt, count=count)
    if ok is None:
        return vals.copy()
    shape = (-1,) + (1,) * (vals.ndim - 1)
    return np.where(ok.reshape(shape), vals, np.zeros(1, npdt))


def layout_to_column(node: Node, dt: st.DataType, device=None) -> col.Column:
    device = resolve_device(device)
    n = node.length
    cap = round_up(max(n, 1))
    if isinstance(dt, st.Null):
        return col.null_column(n, device)
    ok = _validity(node)
    bufs = node.buffers
    if isinstance(dt, st.Boolean):
        vals = _bools(bufs[1], n)
        return col.boolean(vals if ok is None else vals & ok, validity=ok,
                           device=device)
    if isinstance(dt, st.Dictionary):
        keys = layout_to_column(dataclasses.replace(node, dictionary=None),
                                dt.key, device)
        return col.DictionaryColumn(keys, node.dictionary, None, dt)
    nl = st.decimal_limbs(dt)
    if nl is not None:
        limbs = _values(bufs[1], np.uint32, n * nl, None).reshape(n, nl)
        if ok is not None:
            limbs = np.where(ok[:, None], limbs, np.uint32(0))
        return col.primitive(limbs, dt, validity=ok, device=device)
    if isinstance(dt, (st.Int, st.Float, st.Timestamp, st.Date32, st.Date64,
                       st.Time32, st.Time64, st.Duration)):
        return col.primitive(_values(bufs[1], col.numpy_dtype(dt), n, ok),
                             dt, validity=ok, device=device)
    if isinstance(dt, (st.Utf8, st.Binary)):
        offsets = np.frombuffer(bufs[1], np.int32,
                                count=n + 1).astype(np.int64)
        return strings_from_offsets(offsets, bufs[2], ok, dt, device)
    if isinstance(dt, (st.List, st.Map)):
        offsets = np.frombuffer(bufs[1], np.int32,
                                count=n + 1).astype(np.int64)
        child_dt = dt.entry_struct if isinstance(dt, st.Map) else dt.value
        child = layout_to_column(node.children[0], child_dt, device)
        starts = np.zeros(cap, np.int32)
        sizes = np.zeros(cap, np.int32)
        live = np.ones(n, bool) if ok is None else ok
        starts[:n] = np.where(live, offsets[:-1], 0)
        sizes[:n] = np.where(live, np.diff(offsets), 0)
        return col.ListViewColumn(
            torch.from_numpy(starts).to(device),
            torch.from_numpy(sizes).to(device), child,
            bitmap(ok, cap, device), n, dt)
    if isinstance(dt, st.Struct):
        children = tuple(grow(layout_to_column(ch, f.dtype, device), cap)
                         for ch, f in zip(node.children, dt.fields))
        return col.StructColumn(children, bitmap(ok, cap, device), n, dt)
    if isinstance(dt, st.FixedSizeList):
        child = layout_to_column(node.children[0], dt.value, device)
        return col.FixedSizeListColumn(grow(child, cap * dt.size),
                                       bitmap(ok, cap, device), n, dt)
    if isinstance(dt, st.Union):
        tids = np.frombuffer(bufs[0].tobytes(), np.int8, count=n)
        offs = (np.frombuffer(bufs[1].tobytes(), np.int32, count=n)
                if dt.mode == "dense" else None)
        children = [layout_to_column(ch, f.dtype, device)
                    for ch, f in zip(node.children, dt.fields)]
        return col.union_column(tids, children, dt, offsets=offs, length=n,
                                device=device)
    raise st.SchemaError(f"cannot rebuild column of type {dt}")


def bitmap(ok: Optional[np.ndarray], cap: int, device):
    """Host bools (None: all valid) -> a packed bitmap of `cap` rows."""
    return None if ok is None else bm.from_numpy_bools(ok, cap, device)


def strings_from_offsets(offsets: np.ndarray, data: np.ndarray,
                         ok: Optional[np.ndarray], dt: st.DataType,
                         device) -> col.StringViewColumn:
    """Offset-encoded strings (int64 offsets, uint8 data) -> a string view
    column whose arena is the data buffer; a null's view is zero."""
    from ..interop.numpy_bridge import string_view_from_numpy

    return string_view_from_numpy(data, offsets[:-1], np.diff(offsets), ok,
                                  dt, device)


def grow(c: col.Column, cap: int) -> col.Column:
    """`c` with its capacity raised to `cap` rows (zero rows added); a
    column of that capacity or more is returned as it is."""
    if c.capacity >= cap:
        return c
    dev = c.device

    def pad(t):
        out = torch.zeros((cap,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=dev)
        out[:t.shape[0]] = t
        return out

    def bits(b):
        return None if b is None else _pad_bits(b, cap)

    if isinstance(c, col.PrimitiveColumn):
        return dataclasses.replace(c, values=pad(c.values),
                                   validity=bits(c.validity))
    if isinstance(c, col.BooleanColumn):
        return dataclasses.replace(c, values=_pad_bits(c.values, cap),
                                   validity=bits(c.validity))
    if isinstance(c, col.StringViewColumn):
        return dataclasses.replace(c, views=pad(c.views),
                                   validity=bits(c.validity))
    if isinstance(c, col.DictionaryColumn):
        return dataclasses.replace(c, keys=grow(c.keys, cap))
    if isinstance(c, col.ListViewColumn):
        return dataclasses.replace(c, starts=pad(c.starts),
                                   sizes=pad(c.sizes),
                                   validity=bits(c.validity))
    if isinstance(c, col.StructColumn):
        return dataclasses.replace(
            c, children=tuple(grow(ch, cap) for ch in c.children),
            validity=bits(c.validity))
    if isinstance(c, col.FixedSizeListColumn):
        return dataclasses.replace(c, child=grow(c.child, cap * c.dtype.size),
                                   validity=bits(c.validity))
    if isinstance(c, col.NullColumn):
        return col.NullColumn(c.length, cap, dev)
    raise st.SchemaError(f"cannot grow {type(c).__name__}")


def _pad_bits(bits: torch.Tensor, cap: int) -> torch.Tensor:
    out = torch.zeros(bm.num_bytes(cap), dtype=torch.uint8,
                      device=bits.device)
    out[:bits.shape[0]] = bits
    return out
