"""Temporal keys and values in arrowtpu_torch's group_by against
arrowtpu.ops.groupby on the same inputs: Date32, Date64, Timestamp with a
time zone, Time64 and Duration keys on the sort pipeline, a Date32 key on
the dense engine of both packages, and two temporal keys through
`distributed_group_by`; Timestamp min / max, Date32 min, Duration sum,
Date64 mean and an interval's count as values.  All cases share one
schema, so the JAX side compiles little.

Tolerance: exact (keys, aggregates, group order, validity as bools, zero
padding), with one difference by design: the JAX package types the min and
max of a Date32 or Time32 column int32 (its physical dtype), the port
keeps the column's type (ROADMAP C.3); their values are held equal.
Interval keys raise in both (a shape error in the JAX package, fault 10 of
C.3), and an interval takes count alone.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest

import torch_parity as tp
import arrowtpu.schema as js
from arrowtpu.core import batch as jbt
from arrowtpu.core import bitmap as jbm
from arrowtpu.core import column as jcol
from arrowtpu.ops import groupby as jgb

import arrowtpu_torch.schema as ps
from arrowtpu_torch import ops as pops
from arrowtpu_torch.core import batch as pbt
from arrowtpu_torch.core import column as pcol
from arrowtpu_torch.ops import groupby as pgb

N = 120
TYPES = {"d32": (js.Date32(), ps.Date32(), 18000),
         "d64": (js.Date64(), ps.Date64(), 86_400_000 * 18000),
         "ts": (js.Timestamp("us", "UTC"), ps.Timestamp("us", "UTC"),
                1_600_000_000_000_000),
         "t64": (js.Time64("ns"), ps.Time64("ns"), 3_600_000_000_000),
         "dur": (js.Duration("ms"), ps.Duration("ms"), -5_000)}
AGGS = [("ts", "min"), ("ts", "max"), ("d32", "min"), ("v", "sum"),
        ("dur", "sum"), ("d64", "mean"), ("iv", "count")]


def _batches(seed=0, nulls=0.1):
    """Every temporal type over 5 distinct values (so keys repeat), an
    int64 and a day_time interval, ~10 % nulls on each."""
    rng = np.random.default_rng(seed)
    jcols, pcols = {}, {}
    for name, (jdt, pdt, base) in TYPES.items():
        step = 3 if name == "d32" else 1_000_003
        vals = [None if rng.random() < nulls else
                base + step * int(rng.integers(0, 5)) for _ in range(N)]
        jcols[name] = jcol.from_pylist(vals, jdt)
        pcols[name] = pcol.from_pylist(vals, pdt, device="cpu")
    v = [None if rng.random() < nulls else int(x)
         for x in rng.integers(-99, 99, N)]
    iv = [None if rng.random() < nulls else (int(a), int(b))
          for a, b in rng.integers(-9, 9, (N, 2))]
    jcols["v"], pcols["v"] = (jcol.from_pylist(v, js.int64),
                              pcol.from_pylist(v, ps.int64, device="cpu"))
    idt = ("day_time",)
    jcols["iv"] = jcol.from_pylist(iv, js.Interval(*idt))
    pcols["iv"] = pcol.from_pylist(iv, ps.Interval(*idt), device="cpu")
    return jbt.record_batch(jcols), pbt.record_batch(pcols)


def _assert_same(jout, pout):
    """assert_batch_equal, but a Date32 / Time32 min or max is compared
    under the port's own type (the JAX package types it int32)."""
    for f in jout.schema.fields:
        jc, pc = jout[f.name], pout[f.name]
        if isinstance(pc.dtype, (ps.Date32, ps.Time32)) and str(
                jc.dtype) == "int32":
            assert f.name.split("_")[0] in ("min", "max"), f.name
            jc = dataclasses.replace(jc, dtype=js.Date32() if isinstance(
                pc.dtype, ps.Date32) else js.Time32(pc.dtype.unit))
        tp.assert_column_equal(jc, pc, f.name)
    assert [f.name for f in jout.schema.fields] == pout.schema.names


@functools.partial(tp.jit, static_argnums=(1, 2))
def _jax_dense_group_by(batch, key, aggs):
    """The JAX package's dense engine, as its plan runs it, at 16 buckets
    (its plan takes 128 for this key range, about 30 s of compile here;
    the output does not depend on the bucket count)."""
    kc = batch[key]
    ok = kc.valid_bool() & jbm.row_mask_bool(batch.capacity, batch.length)
    kmin = jnp.min(jnp.where(ok, kc.values, jnp.iinfo(kc.values.dtype).max))
    return jbt.RecordBatch(
        jgb._dense_out_schema(batch, [key], aggs),
        jgb._dense_group_by(batch, (key,), aggs, kmin, NB=16))


@pytest.mark.parametrize("key", list(TYPES))
def test_temporal_keys_match_jax(key):
    jb, pb = _batches()
    jout = jgb.group_by(jb, [key], AGGS)
    pout = pgb.group_by(pb, [key], AGGS)
    assert str(pout[key].dtype) == str(pb[key].dtype)
    _assert_same(jout, pout)


def test_date32_key_takes_the_dense_engine():
    """The reference's engine rule (a 32-bit key, integer and temporal
    values: dense), the dense engine's output equal to the JAX package's
    dense engine on the same batch, and to the port's sort pipeline."""
    jb, pb = _batches(1)
    aggs = (("ts", "min"), ("v", "sum"), ("d32", "count"), ("dur", "max"),
            ("d32", "max"))
    assert jgb._dense_eligible(jb, ("d32",), aggs)
    plan = pgb.plan_group_by(pb, ["d32"], aggs)
    assert plan.engine == "dense"
    dense = pgb.group_by(pb, ["d32"], aggs)
    assert str(dense["max_d32"].dtype) == "date32"
    assert str(dense["sum_v"].dtype) == "int64"
    _assert_same(_jax_dense_group_by(jb, "d32", aggs), dense)
    assert bool(pops.equal_batches(plan(pb), dense))
    assert bool(pops.equal_batches(pgb._sort_group_by(pb, ["d32"], aggs),
                                   dense))
    assert pgb.plan_group_by(pb, ["d32"], aggs + (("iv", "count"),)
                             ).engine == "sort"


def test_two_temporal_keys_match_jax():
    jb, pb = _batches(2)
    keys = ["d32", "ts"]
    _assert_same(jgb.group_by(jb, keys, AGGS),
                 pgb.group_by(pb, keys, AGGS))


def test_intervals_take_count_alone():
    jb, pb = _batches(3)
    with pytest.raises(ps.ComputeError):
        pgb.group_by(pb, ["iv"], [("v", "count")])
    with pytest.raises(ValueError):  # fault 10 of ROADMAP C.3
        jgb.group_by(jb, ["iv"], [("v", "count")])
    for agg in ("min", "max", "sum", "mean"):
        with pytest.raises(ps.ComputeError):
            pgb.group_by(pb, ["d64"], [("iv", agg)])


def test_distributed_group_by_takes_temporal_keys():
    """distributed_group_by at one gloo rank (the exchange hashes the
    temporal keys as the JAX package does) equals the JAX package's
    group_by of the same batch, and the port's local one."""
    from arrowtpu_torch.parallel import mesh
    from arrowtpu_torch.parallel.distributed import distributed_group_by

    jb, pb = _batches(4)
    keys = ["d32", "ts"]
    with mesh.process_group(0, 1, "cpu") as group:
        got = distributed_group_by(pb, keys, AGGS, group=group)
    _assert_same(jgb.group_by(jb, keys, AGGS), got)
    assert bool(pops.equal_batches(got, pgb.group_by(pb, keys, AGGS)))
