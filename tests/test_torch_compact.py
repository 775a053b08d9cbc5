"""The compaction kernels' plain versions (what the wrappers run on a CPU
tensor) against the JAX package's compaction, on the same numpy inputs.

K1 (kernels/compact3.py) has no interpret mode on the JAX side; it is held
against the JAX package's CPU compaction (`ops.filter._scatter_compact`,
`ops.groupby._compact_u32_planes`).  K2 (kernels/compact.py) is held
against the Pallas kernel itself in interpret mode, as
tests/test_pallas_compact.py runs it.  Tolerance: bit-exact, count and
zero tail included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrowtpu.ops import filter as jfilter
from arrowtpu.ops import groupby as jgb
from arrowtpu.pallas import compact as jc
from arrowtpu_torch.kernels import _build
from arrowtpu_torch.kernels import compact as k2
from arrowtpu_torch.kernels import compact3 as k1
from torch_parity import TORCH_THREADS
from torch_parity import release_jax_caches  # noqa: F401

torch.set_num_threads(TORCH_THREADS)

DENSITIES = [0.0, 0.02, 0.5, 0.96, 1.0]
N = 9000  # ragged: two full 4096-row tiles and a partial one


def _keep(rng, n, density):
    return rng.random(n) < density


# the edges the card's tile body is tested at: n one past and three past a
# 4096-row tile, a single kept row, the flagship's 5.5 %
EDGE_NS = [4097, 4099]
EDGE_DENSITIES = [0.0, "one", 0.055, 0.5, 0.96, 1.0]


def edge_keep(rng, n, density):
    if density == "one":
        keep = np.zeros(n, bool)
        keep[(n * 7) // 11] = True
        return keep
    return _keep(rng, n, density)


def edge_rows(n, count, which):
    """out_rows of count + 1 or n - 1, kept in [count, n]."""
    return max(count, min(count + 1 if which == "count+1" else n - 1, n))


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("P", [1, 2, 4, 8, 16])
def test_k1_u32_against_jax_group_extraction(P, density):
    rng = np.random.default_rng(P * 10 + int(density * 100))
    planes = rng.integers(0, 2**32, (P, N), dtype=np.uint32)
    keep = _keep(rng, N, density)
    want = jgb._compact_u32_planes([jnp.asarray(p) for p in planes],
                                   jnp.asarray(keep), N)
    got = k1.compact_planes(torch.from_numpy(planes), torch.from_numpy(keep))
    assert got.shape == (P, N) and got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), np.stack(want))


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("P", [1, 2, 5])
def test_k1_u64_against_jax_filter(P, density):
    """int64 planes move as whole 8-byte words (the JAX package splits them
    into limb pairs; its scatter fallback takes them whole)."""
    rng = np.random.default_rng(100 + P * 10 + int(density * 100))
    planes = rng.integers(-2**63, 2**63 - 1, (P, N), dtype=np.int64)
    keep = _keep(rng, N, density)
    plan = jfilter.FilterPlan(jnp.asarray(keep), None, int(keep.sum()))
    want = np.asarray(jfilter._scatter_compact(jnp.asarray(planes.T), plan)).T
    got = k1.compact_planes([torch.from_numpy(p) for p in planes],
                            torch.from_numpy(keep.astype(np.uint8)))
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want)


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("mode", ["u8", "u32"])
def test_k2_against_pallas_interpret(mode, density):
    rng = np.random.default_rng(200 + int(density * 100))
    n = jc.TILE
    keep = _keep(rng, n, density).astype(np.uint8)
    if mode == "u8":
        x = rng.integers(0, 256, n, dtype=np.uint8)
        want, wcnt = jc.compact_bytes(jnp.asarray(x), jnp.asarray(keep),
                                      interpret=True)
        got, cnt = k2.compact_bytes(torch.from_numpy(x), torch.from_numpy(keep))
    else:
        x = rng.integers(0, 2**32, n, dtype=np.uint32)
        want, wcnt = jc.compact_words(jnp.asarray(x), jnp.asarray(keep),
                                      interpret=True)
        got, cnt = k2.compact_words(torch.from_numpy(x), torch.from_numpy(keep))
    assert int(cnt) == int(wcnt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_info", [True, False])
@pytest.mark.parametrize("mode", ["u8", "bool"])
@pytest.mark.parametrize("n", EDGE_NS)
def test_k2_edges_against_pallas_interpret(n, mode, with_info):
    """Four byte planes (the filter's validity planes) at n one and three
    past a tile, at every edge density, with the tile info given and not:
    the Pallas kernel in interpret mode runs the planes padded with dropped
    rows to its 16,384-word tile, and its first n words and its count are
    the port's."""
    rng = np.random.default_rng(1000 + n)
    pad = jc.TILE
    for density in EDGE_DENSITIES:
        keep = np.zeros(pad, np.uint8)
        keep[:n] = edge_keep(rng, n, density)
        planes = np.zeros((4, pad), np.uint8)
        planes[:, :n] = rng.integers(0, 2, (4, n)) if mode == "bool" \
            else rng.integers(0, 256, (4, n))
        jkeep = jnp.asarray(keep)
        tile_r = jc.pick_tile_r(pad)
        want, wcnt = jc.compact_planes_info(
            jnp.asarray(planes), jkeep, jc.tile_info(jkeep, tile_r), tile_r,
            is_u32=False, interpret=True)
        t_keep = torch.from_numpy(keep[:n].astype(bool))
        t_planes = torch.from_numpy(planes[:, :n].copy())
        if mode == "bool":
            t_planes = t_planes.bool()
        info = k2.tile_info(t_keep) if with_info else None
        got, cnt = k2.compact_planes_info(t_planes, t_keep, info)
        assert int(cnt) == int(wcnt) == int(keep.sum())
        assert got.dtype == t_planes.dtype and got.shape == (4, n)
        np.testing.assert_array_equal(got.numpy().astype(np.uint8),
                                      np.asarray(want)[:, :n])


@pytest.mark.parametrize("density", [0.3, 1.0])
def test_k2_bool_planes_ragged(density):
    """Validity-style bool planes at a ragged n, several per call."""
    rng = np.random.default_rng(300)
    keep = torch.from_numpy(_keep(rng, N, density))
    planes = torch.from_numpy(rng.random((3, N)) < 0.7)
    out, cnt = k2.compact_planes_info(planes, keep, k2.tile_info(keep))
    assert int(cnt) == int(keep.sum())
    for p, o in zip(planes, out):
        np.testing.assert_array_equal(o[: int(cnt)].numpy(), p[keep].numpy())
        assert not o[int(cnt):].any()


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_out_rows_cuts_the_zero_tail(kernel):
    """An output of out_rows words (count <= out_rows <= n) is the default
    output's first out_rows words; fewer rows than the count raise."""
    rng = np.random.default_rng(500)
    keep = torch.from_numpy(_keep(rng, N, 0.3))
    count = int(keep.sum())
    planes = torch.from_numpy(rng.integers(0, 2**31, (2, N), dtype=np.int32))

    def run(rows):
        if kernel == "K1":
            return k1.compact_planes(planes, keep, out_rows=rows)
        return k2.compact_planes_info(planes, keep, out_rows=rows)[0]

    full = run(None)
    assert full.shape == (2, N)
    assert torch.equal(run(count + 5), full[:, : count + 5])
    with pytest.raises(RuntimeError):
        run(count - 1)
    with pytest.raises(ValueError):
        run(N + 1)


@pytest.mark.parametrize("which", ["count+1", "n-1"])
@pytest.mark.parametrize("density", EDGE_DENSITIES)
@pytest.mark.parametrize("n", EDGE_NS)
def test_k1_u32_edges_against_jax_group_extraction(n, density, which):
    """17 u32 planes (two launches' worth on the card), output cut to
    out_rows: the JAX extraction with cap = out_rows."""
    rng = np.random.default_rng(800 + n)
    planes = rng.integers(0, 2**32, (17, n), dtype=np.uint32)
    keep = edge_keep(rng, n, density)
    rows = edge_rows(n, int(keep.sum()), which)
    want = jgb._compact_u32_planes([jnp.asarray(p) for p in planes],
                                   jnp.asarray(keep), rows)
    got = k1.compact_planes(torch.from_numpy(planes), torch.from_numpy(keep),
                            out_rows=rows)
    assert got.shape == (17, rows)
    np.testing.assert_array_equal(got.numpy(), np.stack(want))


@pytest.mark.parametrize("which", ["count+1", "n-1"])
@pytest.mark.parametrize("density", EDGE_DENSITIES)
@pytest.mark.parametrize("n", EDGE_NS)
def test_k1_u64_edges_against_jax_filter(n, density, which):
    """int64 planes with the filter's tile offsets, output cut to out_rows:
    the first out_rows rows of the JAX filter's compaction."""
    rng = np.random.default_rng(900 + n)
    planes = rng.integers(-2**63, 2**63 - 1, (2, n), dtype=np.int64)
    keep = edge_keep(rng, n, density)
    rows = edge_rows(n, int(keep.sum()), which)
    plan = jfilter.FilterPlan(jnp.asarray(keep), None, int(keep.sum()))
    want = np.asarray(jfilter._scatter_compact(jnp.asarray(planes.T), plan)).T
    t_keep = torch.from_numpy(keep)
    got = k1.compact_planes(torch.from_numpy(planes), t_keep,
                            k1.tile_offsets(t_keep), rows)
    np.testing.assert_array_equal(got.numpy(), want[:, :rows])


def test_tile_offsets_ragged():
    rng = np.random.default_rng(400)
    keep = _keep(rng, N, 0.5)
    offs = k1.tile_offsets(torch.from_numpy(keep)).numpy()
    tiles = [keep[i:i + _build.TILE_ROWS].sum()
             for i in range(0, N, _build.TILE_ROWS)]
    np.testing.assert_array_equal(offs, np.concatenate([[0], np.cumsum(tiles)]))


def test_wrappers_check_their_operands():
    keep = torch.ones(100, dtype=torch.bool)
    with pytest.raises(ValueError):  # 2-byte words: neither kernel moves them
        k1.compact_planes([torch.zeros(100, dtype=torch.int16)], keep)
    with pytest.raises(ValueError):  # 8-byte words are K1's, not K2's
        k2.compact_words(torch.zeros(100, dtype=torch.int64), keep)
    with pytest.raises(ValueError):  # length mismatch
        k1.compact_planes([torch.zeros(99, dtype=torch.int64)], keep)
    with pytest.raises(ValueError):  # keep must be u8 or bool
        k1.compact_planes([torch.zeros(100, dtype=torch.int64)],
                          keep.to(torch.int32))
    with pytest.raises(ValueError):  # planes must be contiguous
        k1.compact_planes([torch.zeros(200, dtype=torch.int64)[::2]], keep)
