"""The whole flagship step, predicate -> filter -> group-by: arrowtpu_torch's
`entry(device="cpu")` against `__graft_entry__.entry()` on the same numpy
arrays, at 4096 rows with and without nulls.  Tolerance: exact (keys, sums,
counts, mins, group order, validity as bools, length, zero padding).
Then the port's text-keyed join step and its lineitem exchange with a
distributed Q1, each at one rank against its numpy oracle."""

import numpy as np
import pytest

import __graft_entry__ as ge
import arrowtpu as at
import torch_parity as tp
from torch_parity import release_jax_caches  # noqa: F401
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
    tp.assert_batch_equal(tp.jit(jstep)(jb), pstep(pb))


@pytest.mark.parametrize("null_density,key_card", [(0.1, 64), (0.1, 1000),
                                                   (0.4, 64)])
def test_entry_with_nulls(null_density, key_card):
    arrays = pe.example_arrays(4096, 0, null_density, key_card)
    jstep, _ = ge.entry()
    pb = pe.example_batch(4096, 0, null_density, key_card, device="cpu")
    out = pe.step(pb)
    assert out.length > 0
    tp.assert_batch_equal(tp.jit(jstep)(_jax_batch(arrays)), out)


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


def test_text_join_step_against_the_oracle():
    """config 5's join step with k carried as TPC-H's c_name text on both
    sides and rv as a Decimal128(15, 2), at one rank, 4096 x 512 rows:
    the keys and sums read back to integers equal `join_oracle`'s."""
    from arrowtpu_torch.parallel import mesh

    shards = pe.example_join_shards(0, 1, 4096, 512, key_range=640,
                                    key_nulls=0.05, rv_nulls=0.1,
                                    permute_build=True)
    left, right = pe.text_join_batches(shards, device="cpu")
    assert left["k"].to_pylist()[:2] == [
        None if ok is not None and not ok else "Customer#%09d" % k
        for k, ok in zip(shards[0]["k"][0][:2], shards[0]["k"][1][:2])]
    with mesh.process_group(0, 1, "cpu") as group:
        out = pe.join_step(left, right, group)
    assert pe.check_text_join_output([out], pe.join_oracle([shards])) > 0


def test_lineitem_exchange_and_distributed_q1():
    """lineitem (about 12,000 rows, every column class) through the
    exchange at one rank comes back row for row, and Q1 as a distributed
    query on it gives q1_oracle's sums and counts."""
    from arrowtpu_torch.parallel import mesh

    arrays = pe.example_lineitem_arrays(sf=0.002, seed=6)
    batch = pe.lineitem_batch(arrays, device="cpu")
    with mesh.process_group(0, 1, "cpu") as group:
        ex = pe.lineitem_exchange(batch, group)
        assert pe.check_same_rows(ex, batch) == batch.length
        out = pe.q1_distributed_step(ex, group)
    want = pe.q1_oracle(arrays)
    assert pe.check_q1(out, arrays, want, pe.Q1_DISTRIBUTED_AGGS) == sum(
        want["count_order"])
    assert out.schema.names == pe.Q1_KEYS + [
        name for name, _ in pe.Q1_DISTRIBUTED_AGGS]
