"""Windowed accessors (arrowtpu_torch.core.accessor), pretty printing and
memory accounting (arrowtpu_torch.utils) against arrowtpu's.

`iter_column` and `ArrayAccessor.value` over every column class, with
windows that end inside the column and inside a bitmap byte, against
`to_pylist`; `iter_rows` over a batch of nine classes against
`to_pydict` and the JAX package's `iter_rows` on the same rows;
`pretty_format_batches` text equal to the JAX package's; and
`buffer_memory_size` held to a sum written out by hand from each column's
tensors (the two packages lay columns out differently, so the JAX
package's sizes are not the port's).

Tolerance: exact.
"""

import numpy as np
import pytest

from arrowtpu.core import accessor as jacc
from arrowtpu.core import batch as jbt
from arrowtpu.utils import pretty as jpretty

from test_torch_interop import ROWS, _columns, _dtype
import arrowtpu_torch.schema as ps
from arrowtpu_torch.core import accessor as pacc
from arrowtpu_torch.core import batch as pbt
from arrowtpu_torch.core import column as pcol
from arrowtpu_torch import utils as putils
from torch_parity import release_jax_caches  # noqa: F401


def _port_column(name):
    pspec, rows = ROWS[name][1:]
    if name == "null":
        return pcol.null_column(len(rows), "cpu"), rows
    return pcol.from_pylist(rows, _dtype(ps, pspec), device="cpu"), rows


@pytest.mark.parametrize("name", list(ROWS))
@pytest.mark.parametrize("window", [5, 64])
def test_iter_column_and_value_match_to_pylist(name, window):
    pc, rows = _port_column(name)
    want = pc.to_pylist()
    assert list(pacc.iter_column(pc, window)) == want
    acc = pacc.ArrayAccessor(pc, window)
    assert len(acc) == len(rows)
    for i in np.random.default_rng(window).permutation(len(rows)):
        assert acc.value(int(i)) == want[i]
    with pytest.raises(IndexError):
        acc.value(len(rows))


def test_run_end_and_union_fall_back_to_to_pylist():
    r = pcol.run_end_from_pylist([1, 1, None, 3], ps.int64, device="cpu")
    assert list(pacc.iter_column(r, 3)) == [1, 1, None, 3]


def _batches(n):
    names = ["int64", "utf8", "bool", "float64", "binary", "list", "struct",
             "decimal128", "ts_moscow"]
    return (jbt.record_batch({k: _columns(k, n)[0] for k in names}),
            pbt.record_batch({k: _columns(k, n)[1] for k in names}))


def test_iter_rows_and_pretty_text_match_jax():
    jb, pb = _batches(20)
    rows = list(pacc.iter_rows(pb, window=6))
    d = pb.to_pydict()
    assert rows == [{k: d[k][i] for k in d} for i in range(20)]
    assert rows == list(jacc.iter_rows(jb, window=6))
    for max_rows in (100, 7):
        text = putils.pretty_format_batches([pb, pb], max_rows)
        assert text == jpretty.pretty_format_batches([jb, jb], max_rows)
    assert putils.pretty_format_batches([]) == "(no batches)"


def test_print_batches(capsys):
    jb, pb = _batches(3)
    putils.print_batches(pb)
    assert capsys.readouterr().out == jpretty.pretty_format_batches(jb) + "\n"


def test_buffer_memory_size_by_hand():
    _, c, _ = _columns("int32")  # 70 rows: 128 int32 values, a bitmap
    assert putils.buffer_memory_size(c) == 128 * 4 + 128 // 8
    _, s, _ = _columns("utf8")  # views, arena and bitmap
    assert putils.buffer_memory_size(s) == (
        s.views.numel() * 4 + s.arena.numel() + s.validity.numel())
    _, d, _ = _columns("dict")  # keys (values, bitmap) and the values'
    v = d.values
    assert putils.buffer_memory_size(d) == (
        d.keys.values.numel() * 4 + d.keys.validity.numel()
        + v.views.numel() * 4 + v.arena.numel() + d.value_ranks.numel() * 4)
    _, lst, _ = _columns("list")
    ch = lst.child
    assert putils.buffer_memory_size(lst) == (
        2 * lst.starts.numel() * 4 + lst.validity.numel()
        + ch.values.numel() * 8 + ch.validity.numel())
    b = pbt.record_batch({"a": c, "b": pcol.null_column(70, "cpu")})
    assert putils.buffer_memory_size(b) == putils.buffer_memory_size(c)
    # a tensor reached twice counts once
    shared = pbt.record_batch({"a": c, "b": c})
    assert putils.buffer_memory_size(shared) == putils.buffer_memory_size(c)


def test_pool_and_metrics():
    _, c, _ = _columns("int64")
    pool = putils.TrackingMemoryPool()
    n = pool.claim("scan", c)
    assert n == putils.buffer_memory_size(c) == 128 * 8 + 16
    pool.claim("sort", 100)
    assert pool.used() == n + 100 and pool.used("scan") == n
    pool.release("scan", n + 5)
    assert pool.used("scan") == 0 and pool.used() == 100
    m = putils.Metrics()
    b = pbt.record_batch({"a": c})
    m.record_batch(b)
    m.record_batch(b)
    assert (m.records_read, m.bytes_read, m.batches_decoded) == (
        140, 2 * n, 2)
