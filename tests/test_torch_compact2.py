"""K3's plain version (what kernels/compact2.py runs on a CPU tensor)
against the JAX package's compaction on the same numpy inputs.

The JAX K3 (`arrowtpu/pallas/compact2.py`) has no interpret mode, so, as
for K1 in tests/test_torch_compact.py, it is held against the JAX
package's CPU compaction of the same contract (`ops.filter.
_scatter_compact`, `ops.groupby._compact_u32_planes`).  Tolerance:
bit-exact, zero tail included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrowtpu.ops import filter as jfilter
from arrowtpu.ops import groupby as jgb
from arrowtpu_torch.kernels import compact2 as k3
from arrowtpu_torch.kernels import compact3 as k1
from torch_parity import TORCH_THREADS
from torch_parity import release_jax_caches  # noqa: F401

torch.set_num_threads(TORCH_THREADS)

DENSITIES = [0.0, 0.02, 0.5, 0.96, 1.0]
N = 9000  # ragged: two full 4096-row tiles and a partial one


def _inputs(P, density, seed):
    rng = np.random.default_rng(seed)
    planes = rng.integers(0, 2**32, (P, N), dtype=np.uint32)
    return planes, rng.random(N) < density


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("P", [1, 2, 4, 8, 16])
def test_k3_against_jax_compaction(P, density):
    planes, keep = _inputs(P, density, 600 + P * 10 + int(density * 100))
    got = k3.compact_planes(torch.from_numpy(planes), torch.from_numpy(keep))
    assert got.shape == (P, N) and got.dtype == torch.uint32
    want = np.stack(jgb._compact_u32_planes(
        [jnp.asarray(p) for p in planes], jnp.asarray(keep), N))
    np.testing.assert_array_equal(got.numpy(), want)
    plan = jfilter.FilterPlan(jnp.asarray(keep), None, int(keep.sum()))
    want_filter = np.asarray(jfilter._scatter_compact(
        jnp.asarray(planes.T), plan)).T
    np.testing.assert_array_equal(got.numpy(), want_filter)
    assert not got[:, int(keep.sum()):].any()


@pytest.mark.parametrize("density", [0.3, 1.0])
def test_k3_equals_k1_and_takes_lists(density):
    """The same function as K1's (4-byte words, full-length output), for a
    (P, n) tensor and for a list of planes over 16 (two launches' worth on
    the card)."""
    planes, keep = _inputs(17, density, 700)
    t_planes = torch.from_numpy(planes.view(np.int32))
    t_keep = torch.from_numpy(keep.astype(np.uint8))
    got = k3.compact_planes(list(t_planes), t_keep)
    assert isinstance(got, list) and len(got) == 17
    want = k1.compact_planes(t_planes, t_keep)
    assert torch.equal(torch.stack(got), want)


@pytest.mark.parametrize("density", [0.0, "one", 0.055, 0.5, 0.96, 1.0])
@pytest.mark.parametrize("n", [4097, 4099])
def test_k3_edges_against_jax_compaction(n, density):
    """17 planes (two launches' worth on the card) at n one and three past
    a 4096-row tile, including a single kept row."""
    rng = np.random.default_rng(1000 + n)
    planes = rng.integers(0, 2**32, (17, n), dtype=np.uint32)
    if density == "one":
        keep = np.zeros(n, bool)
        keep[(n * 7) // 11] = True
    else:
        keep = rng.random(n) < density
    got = k3.compact_planes(torch.from_numpy(planes), torch.from_numpy(keep))
    want = np.stack(jgb._compact_u32_planes(
        [jnp.asarray(p) for p in planes], jnp.asarray(keep), n))
    np.testing.assert_array_equal(got.numpy(), want)


def test_k3_checks_its_operands():
    keep = torch.ones(100, dtype=torch.bool)
    with pytest.raises(ValueError):  # 8-byte words are K1's
        k3.compact_planes([torch.zeros(100, dtype=torch.int64)], keep)
    with pytest.raises(ValueError):  # length mismatch
        k3.compact_planes([torch.zeros(99, dtype=torch.int32)], keep)
    with pytest.raises(ValueError):  # keep must be u8 or bool
        k3.compact_planes([torch.zeros(100, dtype=torch.int32)],
                          keep.to(torch.int32))
