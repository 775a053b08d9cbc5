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

The JAX reference is `parallel.shard_map_batches` on a JAX CPU mesh (under
`jax.jit`: one compile a mesh size), computed once per module.  The port
runs as gloo process groups: one rank in this process, four spawned
processes.  Tolerance: bit-exact per rank (values below the length,
validity as bools, length, zero padding).
"""

import numpy as np
import pytest

import jax

import torch_parity as tp
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

    def body(lb, rb, gb):
        l_ex = parallel.exchange(lb, ["k"], axis_name="d", num_partitions=n)
        joined, _ = parallel.distributed_hash_join(
            lb, rb, ["k"], num_partitions=n, axis_name="d")
        out = parallel.distributed_group_by(
            joined, ["k"], [("rv", "sum"), ("rv", "count")],
            num_partitions=n, axis_name="d")
        agg = parallel.distributed_group_by(gb, ["g"], JAX_AGGS,
                                            num_partitions=n, axis_name="d")
        return l_ex, out, agg

    mesh = parallel.make_mesh(n)
    outs = jax.jit(lambda a, b, c: parallel.shard_map_batches(
        body, mesh, a, b, c))(left, right, grouped)
    return tuple(parallel.unstack_batches(o) for o in outs)


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
def jax_one_rank():
    return _jax_step(1)


@pytest.fixture(scope="module")
def jax_four_ranks():
    return _jax_step(4)


@pytest.fixture
def group():
    with pmesh.process_group(0, 1, "cpu") as g:
        yield g


def test_one_rank_in_process(group, jax_one_rank):
    jax_ex, jax_out, jax_agg = jax_one_rank
    left, right = (batch_from_numpy(a, device="cpu")
                   for a in pe.example_join_shards(0, 1))
    tp.assert_batch_equal(jax_ex[0], pshuffle.exchange(left, ["k"], group))
    tp.assert_batch_equal(jax_out[0], pe.join_step(left, right, group))
    batch = batch_from_numpy(_group_shards(1)[0], device="cpu")
    _assert_aggregates_equal(jax_agg[0], pdist.distributed_group_by(
        batch, ["g"], AGGS, group=group))


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
