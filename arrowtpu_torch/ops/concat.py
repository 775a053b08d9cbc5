"""Concat: the live rows of several columns or batches, back to back.

Counterpart of `arrowtpu/ops/concat.py` (`concat`, `concat_batches`) for
the column classes the port has.  The JAX package places each input's
rows at traced offsets with masked writes into a slab of the summed
capacities; here the lengths are Python ints, so the output is a
`torch.cat` of the live slices, zero-padded to the port's capacity (the
total length rounded up to the capacity granule).

  * validity is kept only where some input has a bitmap (an input without
    one contributes valid rows);
  * string views: the arenas are concatenated whole, and each input's
    non-inline views (byte length > 12) have their arena offset rebased by
    the start of that input's arena (inputs that share one arena, slices
    of one column, keep it); `len_bound` is the inputs' largest, or None
    if any is None;
  * dictionary columns concatenate their keys and keep the dictionary,
    which must be the same values object in every input (the JAX package
    asks for the same arrays): dictionaries are not merged yet.

  * list views concatenate their children's live rows and rebase each
    input's starts by the rows of the children before it (the JAX package
    concatenates whole child capacities; either way a row reads the same
    items);
  * a struct concatenates each child, a fixed-size list its children's
    `length * size` live rows, into a child of the output's capacity times
    the size;
  * run-end and union columns raise, as in the JAX package.

`interleave(columns, src_idx, row_idx)` (the reference's interleave.rs)
gives `out[i] = columns[src_idx[i]][row_idx[i]]`: the sources are
concatenated (with at least one padding row past their total), each
(source, row) pair maps onto the concatenation through the sources'
cumulative lengths, and one `take` gathers the rows (`gather_rows`: a
16-byte row as one element).  A row is null where either index is null or
the row index falls outside its source's length; such a row reads the
padding, zeros, as the JAX package's slab of whole capacities gives it.
The output has the index column's length and capacity.  It takes
primitive columns (multi-word rows included), booleans and string views;
every other class raises, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from .. import schema as st
from ..config import round_up
from ..core import batch as bt
from ..core import bitmap as bm
from ..core import column as col


def _cat(parts: List[torch.Tensor], lengths: Sequence[int],
         capacity: int) -> torch.Tensor:
    """The first `length` rows of each part, back to back, then zeros up
    to `capacity` rows."""
    first = parts[0]
    out = torch.zeros((capacity,) + tuple(first.shape[1:]), dtype=first.dtype,
                      device=first.device)
    total = sum(lengths)
    if total:
        torch.cat([p[:n] for p, n in zip(parts, lengths)], out=out[:total])
    return out


def concat(columns: Sequence[col.Column]) -> col.Column:
    """The inputs' live rows back to back, in one column of their class."""
    if not columns:
        raise st.ComputeError("concat: no inputs")
    return _concat(columns, round_up(max(sum(c.length for c in columns), 1)))


def _concat(columns: Sequence[col.Column], cap: int) -> col.Column:
    """concat into a column of capacity `cap` (at least the total)."""
    first = columns[0]
    if any(type(c) is not type(first) for c in columns):
        raise st.ComputeError("concat: mixed column kinds")
    lengths = [c.length for c in columns]
    total = sum(lengths)

    if isinstance(first, col.NullColumn):
        return col.NullColumn(total, cap, first.device)

    if isinstance(first, col.DictionaryColumn):
        if any(c.values is not first.values for c in columns[1:]):
            raise st.ComputeError(
                "concat: dictionary merge across distinct dictionaries not "
                "yet supported — decode first")
        return dataclasses.replace(first,
                                   keys=_concat([c.keys for c in columns], cap))
    if isinstance(first, (col.RunEndColumn, col.UnionColumn)):
        raise st.ComputeError(f"concat: unsupported column "
                              f"{type(first).__name__}")

    validity: Optional[torch.Tensor] = None
    if any(c.validity is not None for c in columns):
        validity = bm.pack(_cat([c.valid_bool() for c in columns], lengths,
                                cap))

    if isinstance(first, col.BooleanColumn):
        values = _cat([c.values_bool() for c in columns], lengths, cap)
        return col.BooleanColumn(bm.pack(values), validity, total)

    if isinstance(first, col.PrimitiveColumn):
        return col.PrimitiveColumn(
            _cat([c.values for c in columns], lengths, cap), validity, total,
            first.dtype)

    if isinstance(first, col.StringViewColumn):
        views, arena, bound = _one_arena(columns)
        return col.StringViewColumn(_cat(views, lengths, cap), arena,
                                    validity, total, first.dtype, bound)

    if isinstance(first, col.ListViewColumn):
        starts, rebase = [], 0
        for c in columns:
            starts.append(c.starts + rebase if rebase else c.starts)
            rebase += c.child.length
        return col.ListViewColumn(
            _cat(starts, lengths, cap),
            _cat([c.sizes for c in columns], lengths, cap),
            concat([c.child for c in columns]), validity, total, first.dtype)

    if isinstance(first, col.StructColumn):
        return col.StructColumn(
            tuple(_concat([c.children[i] for c in columns], cap)
                  for i in range(len(first.children))),
            validity, total, first.dtype)

    if isinstance(first, col.FixedSizeListColumn):
        size = first.dtype.size
        return col.FixedSizeListColumn(
            _concat([c.child for c in columns], cap * size), validity, total,
            first.dtype)

    raise st.ComputeError(f"concat: unsupported column {type(first).__name__}")


def _one_arena(columns: Sequence[col.StringViewColumn]):
    """-> (each input's views, over one arena; that arena; the len_bound:
    the inputs' largest, or None if any is None).  Inputs that share one
    arena (slices or runs of one column) keep it; otherwise the arenas go
    back to back and each input's long views (byte length > 12) are
    rebased by the start of its arena."""
    bounds = [c.len_bound for c in columns]
    bound = None if any(b is None for b in bounds) else max(bounds)
    first = columns[0]
    if all(c.arena is first.arena for c in columns):
        return [c.views for c in columns], first.arena, bound
    views, start = [], 0
    for c in columns:
        v = c.views
        if start:
            v = v.clone()
            v[:, 3] = torch.where(v[:, 0] > 12, v[:, 3] + start, v[:, 3])
        views.append(v)
        start += c.arena.shape[0]
    return views, torch.cat([c.arena for c in columns]), bound


def concat_batches(batches: Sequence[bt.RecordBatch]) -> bt.RecordBatch:
    """The batches' rows back to back; every batch has the first's field
    names."""
    if not batches:
        raise st.ComputeError("concat_batches: no inputs")
    schema = batches[0].schema
    for b in batches[1:]:
        if b.schema.names != schema.names:
            raise st.SchemaError("concat_batches: schema mismatch")
    return bt.RecordBatch(schema, tuple(
        concat([b.columns[i] for b in batches]) for i in range(len(schema))))


_INTERLEAVED = (col.PrimitiveColumn, col.BooleanColumn, col.StringViewColumn)


def check_interleaved(column: col.Column) -> None:
    """Raise for a class that `interleave` does not take."""
    if not isinstance(column, _INTERLEAVED):
        raise st.ComputeError(
            f"interleave: unsupported column {type(column).__name__}")


def interleave(columns: Sequence[col.Column], src_idx: col.PrimitiveColumn,
               row_idx: col.PrimitiveColumn) -> col.Column:
    """out[i] = columns[src_idx[i]][row_idx[i]] (module docstring)."""
    from .take import take

    if not columns:
        raise st.ComputeError("interleave: no inputs")
    check_interleaved(columns[0])
    lengths = [c.length for c in columns]
    total = sum(lengths)
    whole = _concat(columns, round_up(total + 1))
    lens = torch.tensor(lengths, dtype=torch.int64, device=whole.device)
    src = src_idx.values.to(torch.int64).clamp(0, len(columns) - 1)
    row = row_idx.values.to(torch.int64)
    inside = (row >= 0) & (row < lens[src])
    # a row outside its source reads row `total`: padding, out of bounds
    flat = torch.where(inside, (lens.cumsum(0) - lens)[src] + row, total)
    index = col.PrimitiveColumn(flat, bm.union(src_idx.validity,
                                               row_idx.validity),
                                src_idx.length, st.int64)
    return take(whole, index)
