"""Logical equality of columns and batches, computed on the device.

Counterpart of `arrowtpu/ops/equal.py` (the reference's arrow-data
equal/mod.rs `equal`): two columns are equal when they have the same dtype
and length, the same validity on their live rows (as bools) and equal
values under the rows valid in both; capacities, padding, arena layouts,
dictionary key spaces and list offsets do not matter.  The result is a 0-d
bool tensor on the column's device (a dtype or length mismatch: False
without touching the data).

  * primitive values compare by their bits (a row of words as a whole), as
    arrow-data compares a values buffer: NaNs of one payload are equal,
    -0.0 and +0.0 are not;
  * string views compare their lengths and their bytes through each
    side's own views (byte matrices at one width);
  * dictionaries compare their decoded values (`take` of the values by the
    keys);
  * list views compare their sizes, then the elements of the rows valid in
    both through the children (validity included);
  * structs and fixed-size lists compare their children under the rows
    valid in both.

Run-end and union columns raise ComputeError, as in the JAX package.
"""

from __future__ import annotations

import torch

from .. import schema as st
from ..core import batch as bt
from ..core import column as col


def _all(pred: torch.Tensor) -> torch.Tensor:
    return pred.all() if pred.numel() else torch.ones(
        (), dtype=torch.bool, device=pred.device)


def _rows_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n,) bool: the rows of two value tensors have the same bits."""
    if a.dtype.is_floating_point:
        width = {torch.float64: torch.int64, torch.float32: torch.int32,
                 torch.float16: torch.int16}[a.dtype]
        a, b = a.view(width), b.view(width)
    eq = a == b
    return eq.all(dim=1) if eq.dim() == 2 else eq


def _strings_equal(a, b, n: int) -> torch.Tensor:
    from .strings import byte_matrix, max_byte_length

    w = max(max_byte_length(a), max_byte_length(b))
    ma, la = byte_matrix(a, w)
    mb, lb_ = byte_matrix(b, w)
    return (la[:n] == lb_[:n]) & (ma[:n] == mb[:n]).all(dim=1)


def _lists_equal(a, b, ok: torch.Tensor, n: int) -> torch.Tensor:
    """Sizes equal under `ok`, then the elements of those rows."""
    sa = torch.where(ok, a.sizes[:n].to(torch.int64), 0)
    sb = torch.where(ok, b.sizes[:n].to(torch.int64), 0)
    if not bool((sa == sb).all()):
        return torch.zeros((), dtype=torch.bool, device=ok.device)
    from .take import take

    total = int(sa.sum())
    row = torch.repeat_interleave(torch.arange(n, device=ok.device), sa,
                                  output_size=total)
    within = torch.arange(total, device=ok.device) - (
        torch.cumsum(sa, 0) - sa)[row]
    ia = a.starts[:n].to(torch.int64)[row] + within
    ib = b.starts[:n].to(torch.int64)[row] + within
    return _eq(take(a.child, col.primitive(ia, st.int64)),
               take(b.child, col.primitive(ib, st.int64)),
               torch.ones(total, dtype=torch.bool, device=ok.device))


def _eq(a: col.Column, b: col.Column, mask: torch.Tensor) -> torch.Tensor:
    """0-d bool: on the rows under `mask` ((n,) bool, n <= both lengths)
    the validity agrees, and the values agree where both are valid."""
    n = mask.shape[0]
    if isinstance(a, col.DictionaryColumn):
        from .take import take

        return _eq(take(a.values, a.keys), take(b.values, b.keys), mask)
    if isinstance(a, (col.RunEndColumn, col.UnionColumn)):
        raise st.ComputeError(f"equal: unsupported column {type(a).__name__}")
    va, vb = a.valid_bool()[:n], b.valid_bool()[:n]
    res = _all((va == vb) | ~mask)
    ok = va & vb & mask
    if isinstance(a, col.NullColumn):
        return res
    if isinstance(a, col.BooleanColumn):
        same = a.values_bool()[:n] == b.values_bool()[:n]
    elif isinstance(a, col.StringViewColumn):
        same = _strings_equal(a, b, n)
    elif isinstance(a, col.PrimitiveColumn):
        same = _rows_equal(a.values[:n], b.values[:n])
    elif isinstance(a, col.StructColumn):
        for ca, cb in zip(a.children, b.children):
            res = res & _eq(ca, cb, ok)
        return res
    elif isinstance(a, col.FixedSizeListColumn):
        return res & _eq(a.child, b.child,
                         ok.repeat_interleave(a.dtype.size))
    elif isinstance(a, col.ListViewColumn):
        return res & _lists_equal(a, b, ok, n)
    else:
        raise st.ComputeError(f"equal: unsupported column {type(a).__name__}")
    return res & _all(same | ~ok)


def equal_columns(a: col.Column, b: col.Column) -> torch.Tensor:
    """0-d bool tensor on `a`'s device: the columns are logically equal."""
    if a.dtype != b.dtype or a.length != b.length:
        return torch.zeros((), dtype=torch.bool, device=a.device)
    return _eq(a, b, torch.ones(a.length, dtype=torch.bool, device=a.device))


def equal_batches(a: bt.RecordBatch, b: bt.RecordBatch) -> torch.Tensor:
    """0-d bool tensor: the same field names and dtypes, and every column
    logically equal."""
    device = a.columns[0].device if a.columns else torch.device("cpu")
    if (a.schema.names != b.schema.names
            or [f.dtype for f in a.schema.fields]
            != [f.dtype for f in b.schema.fields]):
        return torch.zeros((), dtype=torch.bool, device=device)
    res = torch.ones((), dtype=torch.bool, device=device)
    for ca, cb in zip(a.columns, b.columns):
        res = res & equal_columns(ca, cb)
    return res
