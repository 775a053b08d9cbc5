"""The whole flagship step, predicate -> filter -> group-by: arrowtpu_torch's
`entry(device="cpu")` against `__graft_entry__.entry()` on the same numpy
arrays, at 4096 rows with and without nulls.  Tolerance: exact (keys, sums,
counts, mins, group order, validity as bools, length, zero padding)."""

import jax
import numpy as np
import pytest

import __graft_entry__ as ge
import arrowtpu as at
import torch_parity as tp
from arrowtpu_torch import column_to_numpy
from arrowtpu_torch import entry as pe


def _jax_batch(arrays):
    return at.record_batch({name: tp.jax_column(v, ok, "int64")
                            for name, (v, ok) in arrays.items()})


def test_entry_without_nulls_is_the_jax_example():
    jstep, (jb,) = ge.entry()
    pstep, (pb,) = pe.entry(device="cpu")
    for name in jb.schema.names:
        jv, jok, jn = tp.jax_to_numpy(jb[name])
        pv, pok, pn = column_to_numpy(pb[name])
        assert jn == pn == 4096
        np.testing.assert_array_equal(pv, jv)
        assert pok.all() and jok.all()
    tp.assert_batch_equal(jax.jit(jstep)(jb), pstep(pb))


@pytest.mark.parametrize("null_density,key_card", [(0.1, 64), (0.1, 1000),
                                                   (0.4, 64)])
def test_entry_with_nulls(null_density, key_card):
    arrays = pe.example_arrays(4096, 0, null_density, key_card)
    jstep, _ = ge.entry()
    pb = pe.example_batch(4096, 0, null_density, key_card, device="cpu")
    out = pe.step(pb)
    assert out.length > 0
    tp.assert_batch_equal(jax.jit(jstep)(_jax_batch(arrays)), out)


@pytest.mark.parametrize("cardinality,engine", [(12, "dense"),
                                                (100_000, "sort")])
def test_agg_step_is_the_bench_plan(cardinality, engine):
    """BASELINE config 4 as bench.py runs it, at 4096 rows: the port's plan
    against the JAX package's plan_group_by on the bench's data (the CPU
    tests run 32 dense buckets, so 12 keys take the dense engine and 100
    would not), and against the numpy oracle."""
    from arrowtpu.ops import groupby as jgb

    arrays = pe.example_agg_arrays(4096, cardinality)
    jb = at.record_batch({"k": tp.jax_column(arrays["k"][0], None, "int32"),
                          "v": tp.jax_column(arrays["v"][0], None, "int64")})
    pb = pe.example_agg_batch(4096, cardinality, device="cpu")
    plan = pe.agg_plan(pb)
    assert plan.engine == engine
    out = pe.agg_step(plan, pb)
    tp.assert_batch_equal(jgb.plan_group_by(jb, ["k"], pe.AGG_AGGS)(jb), out)
    assert pe.check_agg(out, pe.agg_oracle(arrays)) == out.length > 0
