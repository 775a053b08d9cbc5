"""Union columns: extract one child, take rows.

Counterpart of `arrowtpu/ops/union.py`:

  * `union_extract(u, field)`: the child's values where the row's type
    code is the field's, null elsewhere; a sparse union's child is
    row-parallel (its validity ANDed with the match), a dense union's is
    gathered through the offsets by `ops.take` (a row of another type is
    a null index);
  * `take_union(u, indices)`: the type codes (and a dense union's
    offsets) gathered at the indices' low 32 bits clipped into the
    capacity, a sparse union's children taken by `ops.take`.

Rows past the length are zero (the port's padding contract), where the
JAX package leaves whatever the gather read there.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import schema as st
from ..core import bitmap as bm
from ..core import column as col


def _with_validity(c: col.Column, validity: torch.Tensor) -> col.Column:
    if isinstance(c, col.DictionaryColumn):
        return dataclasses.replace(c, keys=_with_validity(c.keys, validity))
    if isinstance(c, (col.NullColumn, col.RunEndColumn, col.UnionColumn)):
        raise st.ComputeError(
            f"union_extract: a {type(c).__name__} child is not supported")
    return dataclasses.replace(c, validity=validity)


def union_extract(u: col.UnionColumn, field: str) -> col.Column:
    """The child `field` as a top-level column, null where the row holds
    another type."""
    names = [f.name for f in u.dtype.fields]
    if field not in names:
        raise st.SchemaError(f"union has no field {field!r}")
    i = names.index(field)
    code = (u.dtype.type_ids or tuple(range(len(names))))[i]
    child = u.children[i]
    live = bm.row_mask_bool(u.capacity, u.length, u.device)
    sel = (u.type_id_arr == code) & live
    if u.is_dense:
        from .take import take

        idx = col.PrimitiveColumn(torch.where(sel, u.offsets, 0),
                                  bm.pack(sel), u.length, st.int32)
        return take(child, idx)
    return _with_validity(child, bm.pack(sel & child.valid_bool()))


def take_union(u: col.UnionColumn, indices: col.PrimitiveColumn
               ) -> col.UnionColumn:
    """The union's rows at `indices`."""
    from .take import take

    live = bm.row_mask_bool(indices.capacity, indices.length, u.device)
    # the low 32 bits as int32: the even words of little-endian int64s
    low = indices.values.to(torch.int64).contiguous().view(torch.int32)[0::2]
    idx = low.clamp(0, u.capacity - 1).to(torch.int64)
    tids = torch.where(live, u.type_id_arr[idx], 0)
    if u.is_dense:
        return dataclasses.replace(
            u, type_id_arr=tids,
            offsets=torch.where(live, u.offsets[idx], 0),
            length=indices.length)
    return dataclasses.replace(
        u, type_id_arr=tids, length=indices.length,
        children=tuple(take(c, indices) for c in u.children))
