"""The distributed step (exchange -> hash join -> two-phase group-by) of
arrowtpu_torch against the JAX package's on the same numpy shards, at the
shapes of `__graft_entry__.dryrun_multichip` (256 probe rows and 32 unique
build keys a rank).

The same mesh program also runs `distributed_group_by` alone on shards
whose group key is not the exchange's partition of the data, so partial
groups of one key meet from several ranks and merge; some of them have no
valid value on one rank or on every rank, and some keys are null.  Sum,
count, min and max are held to the JAX mesh's output.  Mean is held to the
JAX package's finalizer (`distributed.py`: sum / max(count, 1) in float64,
null where the merged sum or count is null or the count is 0) applied to
the JAX mesh's merged sum and count: the JAX package's own finalizer does
not run on int64 counts, whose comparison with 0 it packs into a bitmap
with both u32 limbs of each row.

The JAX reference is `parallel.shard_map_batches` on a 4-device JAX CPU
mesh (under `jax.jit`: one compile for the exchange, the step and the
group-by each), computed once per module.  The port
runs as gloo process groups: four spawned processes, held per rank, and
one rank in this process on the union of the four ranks' shards, held to
the four JAX ranks' outputs together (ordered by their unique keys; the
exchange's rows as a multiset).  Tolerance: bit-exact (values below the
length, validity as bools, length, zero padding).
"""

import numpy as np
import pytest


import torch_parity as tp
from torch_parity import release_jax_caches  # noqa: F401
from arrowtpu import parallel
from arrowtpu.core import batch as jbt
from arrowtpu_torch import column_to_numpy
from arrowtpu_torch import entry as pe
from arrowtpu_torch.interop.numpy_bridge import batch_from_numpy
from arrowtpu_torch.parallel import distributed as pdist
from arrowtpu_torch.parallel import mesh as pmesh
from arrowtpu_torch.parallel import shuffle as pshuffle


def _jax_batch(arrays):
    return jbt.record_batch({name: tp.jax_column(v, ok, "int64")
                             for name, (v, ok) in arrays.items()})


JAX_AGGS = [("x", "sum"), ("x", "count"), ("x", "min"), ("x", "max")]
AGGS = JAX_AGGS + [("x", "mean")]


def _group_shards(n):
    """Per-rank {g, x}: 32 rows, 16 keys (15 % null), x 40 % null and null
    on every row of key 0."""
    shards = []
    for r in range(n):
        rng = np.random.default_rng(50 + r)
        g, g_ok = rng.integers(0, 16, 32), rng.random(32) > 0.15
        x, x_ok = rng.integers(-1000, 1000, 32), rng.random(32) > 0.4
        shards.append({"g": (g, g_ok), "x": (x, x_ok & (g != 0))})
    return shards


def _jax_step(n):
    """Per-rank (exchanged probe side, output of the step, output of the
    group-by of `_group_shards`) of the JAX package on an n-device mesh."""
    shards = [pe.example_join_shards(r, n) for r in range(n)]
    left = parallel.stack_batches([_jax_batch(lt) for lt, _ in shards])
    right = parallel.stack_batches([_jax_batch(rt) for _, rt in shards])
    grouped = parallel.stack_batches([_jax_batch(a)
                                      for a in _group_shards(n)])

    def step(lb, rb):
        joined, _ = parallel.distributed_hash_join(
            lb, rb, ["k"], num_partitions=n, axis_name="d")
        return parallel.distributed_group_by(
            joined, ["k"], [("rv", "sum"), ("rv", "count")],
            num_partitions=n, axis_name="d")

    # one jit a part: XLA's compile time grows faster than the program
    parts = [
        ((left,), lambda lb: parallel.exchange(lb, ["k"], axis_name="d",
                                               num_partitions=n)),
        ((left, right), step),
        ((grouped,), lambda gb: parallel.distributed_group_by(
            gb, ["g"], JAX_AGGS, num_partitions=n, axis_name="d"))]
    mesh = parallel.make_mesh(n)
    return tuple(parallel.unstack_batches(tp.jit(
        lambda *a, body=body: parallel.shard_map_batches(body, mesh, *a))(
            *args)) for args, body in parts)


def _assert_aggregates_equal(jb, pb):
    """The port's output of AGGS against the JAX mesh's of JAX_AGGS, and
    mean_x against the JAX finalizer on the JAX mesh's sum_x and count_x."""
    names = [f.name for f in jb.schema.fields]
    assert pb.schema.names == names + ["mean_x"]
    for name in names:
        tp.assert_column_equal(jb[name], pb[name], name)
    s, s_ok, n = tp.jax_to_numpy(jb["sum_x"])
    c, c_ok, _ = tp.jax_to_numpy(jb["count_x"])
    v, ok, pn = pe.column_to_numpy(pb["mean_x"])
    assert pn == n and str(pb["mean_x"].dtype) == "float64"
    np.testing.assert_array_equal(ok, s_ok & c_ok & (c > 0))
    np.testing.assert_array_equal(v, s.astype(np.float64) / np.maximum(c, 1))
    tp.assert_zero_padding(pb["mean_x"])


@pytest.fixture(scope="module")
def jax_four_ranks():
    return _jax_step(4)


@pytest.fixture
def group():
    with pmesh.process_group(0, 1, "cpu") as g:
        yield g


def _union(shards):
    """{name: (values, valid)} of several ranks' shards, concatenated."""
    return {name: (np.concatenate([s[name][0] for s in shards]),
                   None if any(s[name][1] is None for s in shards)
                   else np.concatenate([s[name][1] for s in shards]))
            for name in shards[0]}


def _columns_by_key(columns, key):
    """{name: (values, valid)} rows ordered by the key column's validity
    (null first) then value, as a group-by orders its groups."""
    v, ok = columns[key]
    order = np.lexsort((np.where(ok, v, 0), ok))
    return {n: (a[order], b[order]) for n, (a, b) in columns.items()}


def _jax_union(batches):
    """The JAX mesh's per-rank outputs as one set of numpy columns."""
    names = [f.name for f in batches[0].schema.fields]
    parts = [{n: tp.jax_to_numpy(b[n])[:2] for n in names} for b in batches]
    return {n: tuple(np.concatenate([p[n][i] for p in parts])
                     for i in range(2)) for n in names}


def _port_columns(batch):
    return {n: column_to_numpy(batch[n])[:2] for n in batch.schema.names}


def _assert_columns_equal(got, want):
    assert list(got) == list(want)
    for name, (v, ok) in want.items():
        np.testing.assert_array_equal(got[name][1], ok, err_msg=name)
        np.testing.assert_array_equal(got[name][0], v, err_msg=name)


def test_one_rank_in_process(group, jax_four_ranks):
    """The port at one rank, in this process, on the union of the four
    ranks' shards, against the JAX mesh's four ranks together: its
    exchange keeps every row in order (the JAX mesh's exchanged rows are
    the same multiset), and the step's and the group-by's outputs, whose
    keys are unique, are the JAX ranks' outputs ordered by key, exactly
    (values under nulls included; mean_x by the JAX finalizer's formula
    on the mesh's sum_x and count_x)."""
    jax_ex, jax_out, jax_agg = jax_four_ranks
    shards = [pe.example_join_shards(r, 4) for r in range(4)]
    left = batch_from_numpy(_union([lt for lt, _ in shards]), device="cpu")
    right = batch_from_numpy(_union([rt for _, rt in shards]), device="cpu")
    ex = pshuffle.exchange(left, ["k"], group)
    assert ex.length == left.length
    got = _port_columns(ex)
    _assert_columns_equal(got, {n: (c[0], np.ones(left.length, bool))
                                for n, c in _port_columns(left).items()})
    want = _jax_union(jax_ex)
    _assert_columns_equal(_columns_by_key(got, "k"),
                          _columns_by_key(want, "k"))
    out = pe.join_step(left, right, group)
    _assert_columns_equal(_port_columns(out),
                          _columns_by_key(_jax_union(jax_out), "k"))
    for c in out.columns:
        tp.assert_zero_padding(c)
    batch = batch_from_numpy(_union(_group_shards(4)), device="cpu")
    agg = pdist.distributed_group_by(batch, ["g"], AGGS, group=group)
    want = _columns_by_key(_jax_union(jax_agg), "g")
    s, s_ok = want["sum_x"]
    c, c_ok = want["count_x"]
    want["mean_x"] = (s.astype(np.float64) / np.maximum(c, 1),
                      s_ok & c_ok & (c > 0))
    _assert_columns_equal(_port_columns(agg), want)
    for c in agg.columns:
        tp.assert_zero_padding(c)


def test_four_spawned_ranks_match_the_jax_mesh(jax_four_ranks):
    _, jax_out, _ = jax_four_ranks
    outs = pmesh.run(pe._dryrun_rank, 4, "cpu", 4)
    assert sum(o.length for o in outs) > 0
    for j, p in zip(jax_out, outs):
        tp.assert_batch_equal(j, p)


def test_every_aggregate_merges_across_four_ranks_as_the_jax_mesh(
        jax_four_ranks):
    """sum, count, min, max and mean (with its finalizer) merged from
    partial groups on several ranks, per rank against the JAX mesh."""
    *_, jax_agg = jax_four_ranks
    outs = pe.group_by_shards(_group_shards(4), ["g"], AGGS, device="cpu")
    for j, p in zip(jax_agg, outs):
        _assert_aggregates_equal(j, p)
    # the case the finalizer's validity rule is for: a group with no
    # valid value on any rank (key 0), and groups on more than one rank
    mean = [pe.column_to_numpy(o["mean_x"]) for o in outs]
    keys = [pe.column_to_numpy(o["g"]) for o in outs]
    zero = [(m[1], k[0] == 0) for m, k in zip(mean, keys)]
    assert any((~ok & is0).any() for ok, is0 in zero)
    shard_keys = [set(a["g"][0][a["g"][1]]) for a in _group_shards(4)]
    assert len(set.intersection(*shard_keys)) >= 5


def test_dryrun_multichip_passes_its_oracle():
    assert pe.dryrun_multichip(4, device="cpu") > 0


def test_partition_ids_match(rng):
    """Each row goes to the same rank as in the JAX package, nulls and
    32-bit keys included."""
    from arrowtpu.parallel import shuffle as jshuffle

    k = rng.integers(-2**40, 2**40, 700)
    ok = rng.random(700) > 0.1
    k32 = rng.integers(-1000, 1000, 700)
    jb = jbt.record_batch({"k": tp.jax_column(k, ok, "int64"),
                           "j": tp.jax_column(k32, None, "int32")})
    pb = batch_from_numpy({"k": (k, ok), "j": (k32.astype(np.int32), None)},
                          device="cpu")
    for n in (3, 4, 8):
        want = np.asarray(jshuffle.partition_ids(jb, ["k", "j"], n))[:700]
        got = pshuffle.partition_ids(pb, ["k", "j"], n).numpy()[:700]
        np.testing.assert_array_equal(got, want)


def test_mean_min_max_at_one_rank(group, rng):
    """The merge of every aggregate and mean's finalizer, against the
    port's one-phase group_by (one rank: the exchange keeps every row)."""
    from arrowtpu_torch.ops import groupby as pgb

    k = rng.integers(0, 30, 500)
    v = rng.integers(-1000, 1000, 500)
    batch = batch_from_numpy({"k": (k, rng.random(500) > 0.1),
                              "v": (v, rng.random(500) > 0.3)}, device="cpu")
    aggs = [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max"),
            ("v", "mean")]
    got = pdist.distributed_group_by(batch, ["k"], aggs, group=group)
    want = pgb.group_by(pmesh.normalize_batch(batch), ["k"], aggs)
    assert got.schema.names == want.schema.names
    for name in want.schema.names:
        gv, gok, gn = column_to_numpy(got[name])
        wv, wok, wn = column_to_numpy(want[name])
        assert gn == wn
        np.testing.assert_array_equal(gok, wok)
        np.testing.assert_array_equal(gv[wok], wv[wok])
