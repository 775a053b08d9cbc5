"""Parity of arrowtpu_torch's filter with arrowtpu.ops.filter on the same
numpy inputs.  Tolerance: exact (values at every row below the length,
validity as bools, length, zero padding)."""

import numpy as np
import pytest

import torch_parity as tp
from torch_parity import release_jax_caches  # noqa: F401
from arrowtpu import ops as jops
from arrowtpu.core import batch as jbt
from arrowtpu_torch import ops as pops
from arrowtpu_torch.core import batch as pbt
from arrowtpu_torch.kernels import compact as k2
from arrowtpu_torch.kernels import compact3 as k1

COLUMNS = [("i64", "int64", -10**9, 10**9), ("i32", "int32", -1000, 1000),
           ("i16", "int16", -300, 300), ("u8", "uint8", 0, 256),
           ("flag", "bool", 0, 2)]


def _batches(rng, n, null_density):
    jcols, pcols = {}, {}
    for name, dt, lo, hi in COLUMNS:
        vals = rng.integers(lo, hi, n)
        valid = rng.random(n) > null_density if null_density else None
        jcols[name] = tp.jax_column(vals, valid, dt)
        pcols[name] = tp.port_column(vals, valid, dt)
    return jbt.record_batch(jcols), pbt.record_batch(pcols)


@pytest.mark.parametrize("n", [4096, 1000])
@pytest.mark.parametrize("null_density", [0.0, 0.1])
def test_filter_record_batch(n, null_density):
    rng = np.random.default_rng(n)
    jb, pb = _batches(rng, n, null_density)
    mask = rng.random(n) < 0.6
    mvalid = rng.random(n) > 0.1  # null predicate rows select nothing
    jm = tp.jax_column(mask, mvalid, "bool")
    pm = tp.port_column(mask, mvalid, "bool")
    tp.assert_batch_equal(jops.filter_record_batch(jb, jm),
                          pops.filter_record_batch(pb, pm))


def test_filter_null_column():
    from arrowtpu.core import column as jcol
    import arrowtpu_torch as pt

    rng = np.random.default_rng(7)
    mask = rng.random(500) < 0.3
    jr = jops.filter_(jcol.null_column(500), tp.jax_column(mask, None, "bool"))
    pr = pops.filter_(pt.null_column(500, device="cpu"),
                      tp.port_column(mask, None, "bool"))
    tp.assert_column_equal(jr, pr, "null column")


def test_folded_validity_is_skipped():
    """mask = x > 0 carries x's own validity, which the plan folds into the
    keep mask: the output has no bitmap and no byte-plane launch is made."""
    rng = np.random.default_rng(8)
    vals = rng.integers(-100, 100, 4096)
    valid = rng.random(4096) > 0.1
    jx = tp.jax_column(vals, valid, "int64")
    px = tp.port_column(vals, valid, "int64")
    jr = jops.filter_(jx, jops.gt(jx, 0))
    pr = pops.filter_(px, pops.gt(px, 0))
    tp.assert_column_equal(jr, pr, "folded")
    assert jr.validity is None and pr.validity is None


def test_planes_by_kind_keep_input_order():
    """compact_planes groups planes by dtype (one launch per kind) and
    hands them back in input order, cut to the port's output capacity (the
    count rounded up to 64 rows)."""
    import torch

    rng = np.random.default_rng(9)
    keep = torch.from_numpy(rng.random(832) < 0.5)
    plan = pops.build_plan(tp.port_column(keep.numpy(), None, "bool"))
    planes = [torch.from_numpy(rng.integers(-9, 9, 832).astype(dt))
              for dt in (np.int64, np.uint8, np.int32, np.int64, np.int16)]
    out = pops.filter.compact_planes(planes, plan)
    count = int(keep.sum())
    assert plan.count == count and plan.out_capacity == -(-count // 64) * 64
    for p, o in zip(planes, out):
        want = torch.zeros(plan.out_capacity, dtype=p.dtype)
        want[:count] = p[keep]
        assert o.dtype == p.dtype and torch.equal(o, want)
    assert torch.equal(plan.offs, k1.tile_offsets(keep))
    assert k2.tile_info is k1.tile_offsets
