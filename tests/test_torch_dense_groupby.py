"""Parity of arrowtpu_torch's dense-range GROUP BY engine, its dispatch and
its planner with arrowtpu.ops.groupby on the same numpy inputs.

The two engines of the reference leave different values under a null key
(the dense engine writes key value 0 for the null group, the sort
pipeline carries the first null row's raw value), and the comparison
covers values under nulls, so these cases prove that the port picks the
reference's engine: every nullable key here holds nonzero values under its
nulls, and each case also asserts which engine ran.

One row count and one schema per group of cases, so the JAX package
compiles few programs: `group_by`'s dispatch on one schema serves the
range cases (just under, at and over the bucket count less `off`), the
wrapping sums, the all-null key and the empty batch.
Tolerance: exact (keys, values under nulls, validity as bools, length,
zero padding).  Integer sums wrap mod 2**64 (int64) or mod 2**32 (int32)
in both packages; the mean is the wrapped int64 sum over the count, one
division.
"""

import numpy as np
import pytest
import torch

import torch_parity as tp
from torch_parity import release_jax_caches  # noqa: F401
from arrowtpu.core import batch as jbt
from arrowtpu.ops import groupby as jgb
from arrowtpu_torch import config as pconfig
from arrowtpu_torch import schema as pst
from arrowtpu_torch.core import batch as pbt
from arrowtpu_torch.core import bitmap as pbm
from arrowtpu_torch.core import column as pcol
from arrowtpu_torch.interop.numpy_bridge import column_to_numpy
from arrowtpu_torch.kernels import dense_agg as dk
from arrowtpu_torch.ops import groupby as pgb

N = 2048
NB = pconfig.DENSE_GROUPBY_BUCKETS
I64 = np.iinfo(np.int64)

AGGS = [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max"),
        ("v", "mean"), ("w", "sum"), ("w", "mean")]


def _pair(cols, length=N):
    """{name: (values, valid or None, dtype name)} -> (JAX batch, port
    batch) of `length` live rows over N."""
    jcols, pcols = {}, {}
    for name, (vals, valid, dt) in cols.items():
        jcols[name] = tp.jax_column(vals, valid, dt).with_length(length)
        pcols[name] = pcol.primitive(
            np.asarray(vals, tp._NP[dt]), getattr(pst, dt), validity=valid,
            length=length, device="cpu")
    return jbt.record_batch(jcols), pbt.record_batch(pcols)


def _main_schema(case, seed):
    """The one schema of the range cases: a nullable int32 key (nonzero
    values under its nulls), nullable int32 v and int64 w."""
    rng = np.random.default_rng(seed)
    span = {"under": NB - 2, "at": NB - 1, "over": 3 * NB, "wrap": 9,
            "all_null_key": 9, "empty": 9}[case]
    lo = -7
    k = rng.integers(lo, lo + span + 1, N)
    k[:2] = lo, lo + span  # both ends of the range on valid rows
    k_ok = rng.random(N) > 0.1
    k_ok[:2] = True
    k[~k_ok] = rng.integers(1000, 2000, int((~k_ok).sum()))
    if case == "all_null_key":
        k_ok[:] = False
    v = rng.integers(-1000, 1000, N)
    w = rng.integers(-10**12, 10**12, N)
    if case == "wrap":
        v = rng.integers(2**31 - 2**20, 2**31, N)  # int32 sums wrap
        w = rng.integers(I64.max - 2**40, I64.max, N, dtype=np.int64)
        w[::3] = rng.integers(I64.min, I64.min + 2**40, len(w[::3]),
                              dtype=np.int64)
    cols = {"k": (k, k_ok, "int32"),
            "v": (v, rng.random(N) > 0.2, "int32"),
            "w": (w, rng.random(N) > 0.2, "int64")}
    return _pair(cols, 0 if case == "empty" else N)


def _null_group_key(out):
    """The key value the output holds under its null group, or None."""
    vals, ok, _ = column_to_numpy(out["k"])
    return None if ok.all() else int(vals[np.flatnonzero(~ok)[0]])


@pytest.mark.parametrize("case,engine", [
    ("under", "dense"), ("at", "sort"), ("over", "sort"), ("wrap", "dense"),
    ("all_null_key", "dense"), ("empty", "dense")])
def test_group_by_picks_the_reference_engine(case, engine):
    jb, pb = _main_schema(case, seed=len(case))
    got = pgb.group_by(pb, ["k"], AGGS)
    tp.assert_batch_equal(jgb.group_by(jb, ["k"], AGGS), got)
    null_key = _null_group_key(got)
    if case == "empty":
        assert got.length == 0
    else:
        # the dense engine writes 0 under the null group; the sort
        # pipeline the first null row's raw value (here in [1000, 2000))
        assert (null_key == 0) == (engine == "dense"), null_key


@pytest.mark.parametrize("kdt,lo,span,nullable,engine,vdt", [
    ("int8", -100, NB, False, "sort", "uint32"),   # range NB with off 0
    ("int16", 30000, NB - 1, False, "dense", "int32"),  # NB - 1, off 0
    ("uint32", 2**32 - NB + 1, NB - 2, True, "dense", "uint32"),  # 2**32
])
def test_key_dtypes(kdt, lo, span, nullable, engine, vdt):
    """Every key width, and uint32 values (their sums wrap mod 2**32)."""
    rng = np.random.default_rng(span)
    k = lo + rng.integers(0, span + 1, N)
    k[:2] = lo, lo + span
    k_ok = None
    if nullable:
        k_ok = rng.random(N) > 0.1
        k_ok[:2] = True
        k[~k_ok] = lo + 5  # nonzero under the nulls
    lo_v = 0 if vdt == "uint32" else -10**9
    cols = {"k": (k, k_ok, kdt),
            "v": (rng.integers(lo_v, lo_v + 2 * 10**9, N),
                  rng.random(N) > 0.2, vdt)}
    jb, pb = _pair(cols)
    aggs = [("v", "sum")]
    got = pgb.group_by(pb, ["k"], aggs)
    tp.assert_batch_equal(jgb.plan_group_by(jb, ["k"], aggs)(jb), got)
    assert pgb.plan_group_by(pb, ["k"], aggs).engine == engine


@pytest.mark.parametrize("span,vrange,buckets", [
    (NB // 2 - 3, 10**12, NB // 2),     # half tier (range < NB/2 - off)
    (NB - 4, 100, NB),                  # full tier
    (5 * NB, 100, 0),                   # sort tier
])
def test_plan_tiers(span, vrange, buckets):
    rng = np.random.default_rng(span + vrange % 97)
    k = rng.integers(0, span + 1, N)
    k[:2] = 0, span
    k_ok = rng.random(N) > 0.1
    k_ok[:2] = True
    k[~k_ok] = 1 + span  # nonzero under the nulls, outside the range
    cols = {"k": (k, k_ok, "int32"),
            "v": (rng.integers(-vrange, vrange, N), rng.random(N) > 0.2,
                  "int64")}
    jb, pb = _pair(cols)
    aggs = [("v", "sum"), ("v", "min")]
    plan = pgb.plan_group_by(pb, ["k"], aggs)
    assert plan.buckets == buckets
    assert plan.engine == ("dense" if buckets else "sort")
    want = jgb.plan_group_by(jb, ["k"], aggs)(jb)
    tp.assert_batch_equal(want, plan(pb))
    tp.assert_batch_equal(want, pgb.group_by(pb, ["k"], aggs))


def _oracle(key, key_ok, kmin, off, nb, n, values):
    """The kernel's contract, row by row in Python integers."""
    rows = np.zeros(nb, np.int64)
    stats = np.zeros((len(values), 4, nb), object)
    stats[:, 2], stats[:, 3] = I64.max, I64.min
    for i in range(n):
        b = 0 if key_ok is not None and not key_ok[i] else \
            int(key[i]) - kmin + off
        if not 0 <= b < nb:
            continue
        rows[b] += 1
        for c, (v, ok) in enumerate(values):
            if ok is None or ok[i]:
                x = int(v[i])
                stats[c, 0, b] += 1
                stats[c, 1, b] = (stats[c, 1, b] + x + 2**63) % 2**64 - 2**63
                stats[c, 2, b] = min(stats[c, 2, b], x)
                stats[c, 3, b] = max(stats[c, 3, b], x)
    return rows, stats.astype(np.int64)


@pytest.mark.parametrize("kdt,nullable,n", [
    (torch.int8, True, 300), (torch.int32, False, 257),
    (torch.uint32, True, 0), (torch.uint16, False, 511)])
def test_dense_aggregate_plain_contract(kdt, nullable, n):
    """dense_aggregate (the plain version, on the CPU) against the
    contract: null keys in bucket 0, rows outside [0, nb) and past n
    dropped, sums wrapping, min/max identities in empty buckets, the
    extreme int64 values."""
    rng = np.random.default_rng(n)
    cap, nb, off = 512, 13, int(nullable)
    kmin = 3 if kdt.is_signed else 2**16 - 5 if kdt == torch.uint32 else 7
    key = (kmin + rng.integers(-3, nb + 2, cap)).astype(np.int64)
    key_ok = rng.random(cap) > 0.2 if nullable else None
    values = []
    for dt in (np.int8, np.int64, np.uint32):
        info = np.iinfo(dt)
        v = rng.integers(info.min, info.max, cap, dtype=dt, endpoint=True)
        if dt == np.int64:
            v[:4] = I64.min, I64.max, I64.max, I64.min
        values.append((v, rng.random(cap) > 0.3))
    values[1] = (values[1][0], None)
    rows, stats = dk.dense_aggregate(
        torch.from_numpy(key).to(kdt),
        None if key_ok is None else pbm.from_numpy_bools(key_ok, cap, "cpu"),
        torch.tensor(kmin), off, nb, n,
        [(torch.from_numpy(v), None if ok is None
          else pbm.from_numpy_bools(ok, cap, "cpu")) for v, ok in values])
    want_rows, want_stats = _oracle(key, key_ok, kmin, off, nb, n, values)
    np.testing.assert_array_equal(rows.numpy(), want_rows)
    np.testing.assert_array_equal(stats.numpy(), want_stats)
