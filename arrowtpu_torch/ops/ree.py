"""Run-end encoding: encode, decode and take.

Counterpart of `arrowtpu/ops/ree.py`, in its shape: encode marks the rows
that start a run (each row IS DISTINCT FROM the row before it, so NaNs of
one payload share a run and so do nulls; string views, which the JAX
package's encode does not take, by their bytes) and compacts the row
numbers and the values of those rows with one filter plan, one K1 launch
for the two when they share a word size; decode and take map logical rows to runs by
`RunEndColumn.physical_index` (a binary search of the run ends) and take
the runs' values.

The port's filter cuts its output to the count rounded up to the capacity
granule, so an encoded column's run ends and values have that capacity,
not the input's (the JAX package keeps the input's); the runs themselves
and the padding run ends (the logical length, at least 1) are the JAX
package's.
"""

from __future__ import annotations

import torch

from .. import schema as st
from ..config import round_up
from ..core import batch as bt
from ..core import bitmap as bm
from ..core import column as col


def run_end_decode(c: col.RunEndColumn) -> col.Column:
    """The plain column of a run-end column, at the capacity of its
    length."""
    return run_end_decode_to(c, round_up(max(c.length, 1)))


def run_end_decode_to(c: col.RunEndColumn, capacity: int) -> col.Column:
    """Decode into a column of `capacity` rows (at least the length)."""
    from .take import take

    phys = c.physical_index(torch.arange(capacity, dtype=torch.int32,
                                         device=c.device))
    phys[c.length:] = 0
    return take(c.values, col.PrimitiveColumn(phys, None, c.length,
                                              st.int32))


def run_end_encode(c: col.Column) -> col.RunEndColumn:
    """Compress the runs of equal adjacent rows of `c` (any column with a
    `distinct`): run j's value is its first row's, run_ends[j] the row
    after its last."""
    from .filter import filter_record_batch

    cap, n, dev = c.capacity, c.length, c.device
    starts = _differs_from_previous(c)
    starts &= bm.row_mask_bool(cap, n, dev)
    starts[0] = n > 0
    rows = col.PrimitiveColumn(torch.arange(cap, dtype=torch.int32,
                                            device=dev), None, n, st.int32)
    runs = filter_record_batch(
        bt.record_batch({"start": rows, "value": c}),
        col.BooleanColumn(bm.pack(starts), None, n))
    n_runs = runs.length
    ends = torch.full((runs.capacity,), max(n, 1), dtype=torch.int32,
                      device=dev)
    if n_runs:
        ends[:n_runs - 1] = runs["start"].values[1:n_runs]
        ends[n_runs - 1] = n
    return col.RunEndColumn(ends, runs["value"], n,
                            st.RunEndEncoded(st.int32, c.dtype))


def _differs_from_previous(c: col.Column) -> torch.Tensor:
    """(capacity,) bool: row i IS DISTINCT FROM row i - 1 (row 0: from
    a null).  String views compare their bytes: the JAX package's
    `distinct` takes no string column, so its encode raises there."""
    from . import cmp

    if not isinstance(c, col.StringViewColumn):
        return cmp.distinct(c, _shift_one(c)).values_bool()
    from .strings import byte_matrix, max_byte_length

    mat, lens = byte_matrix(c, max_byte_length(c))
    valid = c.valid_bool()
    same = (lens[1:] == lens[:-1]) & (mat[1:] == mat[:-1]).all(dim=1)
    out = valid.clone()
    out[1:] = (valid[1:] ^ valid[:-1]) | (valid[1:] & valid[:-1] & ~same)
    return out


def _shift_one(c: col.Column) -> col.Column:
    """`c` shifted down one row (row i holds row i - 1); row 0 null."""
    from .take import take

    rows = torch.arange(c.capacity, dtype=torch.int32, device=c.device)
    return take(c, col.PrimitiveColumn((rows - 1).clamp_(min=0),
                                       bm.pack(rows > 0), c.length,
                                       st.int32))


def take_run(c: col.RunEndColumn, indices: col.PrimitiveColumn
             ) -> col.Column:
    """Logical rows of a run-end column at `indices` (an integer column;
    a null index gives a null row): only the run ends and the runs'
    values are read."""
    from .take import take

    raw = indices.values.to(torch.int32).clamp_(min=0)
    return take(c.values, col.PrimitiveColumn(
        c.physical_index(raw), indices.validity, indices.length, st.int32))
