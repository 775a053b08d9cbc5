"""Take: gather rows by an index column.

Counterpart of `arrowtpu/ops/take.py` for primitive, boolean, null and
dictionary columns (a dictionary takes its keys and shares its values).
A null or out-of-bounds index (outside [0, length) of the source) gives a
null output row.  As in the JAX package, every output
row below the length takes the value at its index clipped into the
source's capacity, so the values under a null row are the same in both
packages; rows past the length are zero (the port's padding contract).
The output has the index column's length and capacity, and always a
validity bitmap.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import schema as st
from ..core import batch as bt
from ..core import bitmap as bm
from ..core import column as col


def take(c: col.Column, indices: col.PrimitiveColumn) -> col.Column:
    if not (isinstance(indices, col.PrimitiveColumn)
            and isinstance(indices.dtype, st.Int)):
        raise st.ComputeError("take: indices must be an integer column")
    live = bm.row_mask_bool(indices.capacity, indices.length, indices.device)
    raw = indices.values.to(torch.int64)
    ok = live & (raw >= 0) & (raw < c.length)
    if indices.validity is not None:
        ok &= bm.unpack(indices.validity)
    n = indices.length
    if isinstance(c, col.NullColumn):
        return col.NullColumn(n, indices.capacity, c.device)
    if isinstance(c, col.DictionaryColumn):  # the keys; values are shared
        return dataclasses.replace(c, keys=take(c.keys, indices))
    # as the JAX package: the index's low 32 bits read as int32, clipped
    # (the even int32 words of little-endian int64s)
    idx = raw.contiguous().view(torch.int32)[0::2].clamp(
        0, c.capacity - 1).to(torch.int64)
    # an in-bounds index of a column without a bitmap selects a valid row
    validity = bm.pack(ok if c.validity is None
                       else bm.unpack(c.validity)[idx] & ok)
    if isinstance(c, col.BooleanColumn):
        return col.BooleanColumn(bm.pack(c.values_bool()[idx] & live),
                                 validity, n)
    if isinstance(c, col.PrimitiveColumn):
        values = c.values[idx]
        if n < indices.capacity:
            values[n:] = 0
        return col.PrimitiveColumn(values, validity, n, c.dtype)
    raise st.ComputeError(f"take: unsupported column {type(c).__name__}")


def take_record_batch(batch: bt.RecordBatch,
                      indices: col.PrimitiveColumn) -> bt.RecordBatch:
    return bt.RecordBatch(batch.schema,
                          tuple(take(c, indices) for c in batch.columns))
