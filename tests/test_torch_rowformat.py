"""arrowtpu_torch's sort over order-preserving planes gives the JAX
package's order: `rowformat.encode_columns` + `pack.sort_by_planes` on both
sides, the same numpy keys, and the permutations compared over the live
rows (the two packages pad to different capacities).  Tolerance: exact
(stable order, ties by row index)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import torch_parity as tp
from torch_parity import release_jax_caches  # noqa: F401
from arrowtpu import config as jconfig
from arrowtpu.rowformat import encode as jrf
from arrowtpu.rowformat import pack as jrp
from arrowtpu_torch import config as pconfig
from arrowtpu_torch.rowformat import encode as prf
from arrowtpu_torch.rowformat import pack as prp

N = 700


def _keys(rng, spec):
    """spec: [(dtype, lo, hi, null density)] -> [(jax column, port column)];
    an int64 column's first rows are its type's extremes."""
    cols = []
    for dt, lo, hi, nulls in spec:
        if dt == "bool":
            vals = rng.random(N) < 0.5
        else:
            vals = rng.integers(lo, hi, N, dtype=np.int64)
            vals[:2] = [lo, hi - 1]
        valid = rng.random(N) > nulls if nulls else None
        cols.append((tp.jax_column(vals, valid, dt),
                     tp.port_column(vals, valid, dt)))
    return cols


def _perms(cols, opts):
    jcols, pcols = zip(*cols)
    jplanes = jrf.encode_columns(
        jcols, [jconfig.SortOptions(d, nf) for d, nf in opts])
    cap = jcols[0].capacity
    _, (jperm,) = jrp.sort_by_planes(jplanes, cap, N,
                                     [jnp.arange(cap, dtype=jnp.int32)])
    pplanes = prf.encode_columns(
        pcols, [pconfig.SortOptions(d, nf) for d, nf in opts])
    pcap = pcols[0].capacity
    _, (pperm,) = prp.sort_by_planes(pplanes, pcap, N, [torch.arange(pcap)])
    return np.asarray(jperm)[:N], pperm[:N].numpy()


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("nulls_first", [True, False])
def test_multi_column_order_matches_jax(descending, nulls_first):
    rng = np.random.default_rng(int(descending) * 2 + int(nulls_first))
    cols = _keys(rng, [("int64", -20, 20, 0.1), ("bool", 0, 2, 0.2),
                       ("int32", 0, 5, 0.0)])
    opts = [(descending, nulls_first), (False, True), (descending, True)]
    jperm, pperm = _perms(cols, opts)
    np.testing.assert_array_equal(pperm, jperm)


def test_full_range_int64_takes_a_raw_word():
    """A plane whose range needs all 64 bits cannot be packed; it is sorted
    as its own key and the order still matches."""
    rng = np.random.default_rng(9)
    cols = _keys(rng, [("int64", -2**63, 2**63, 0.1), ("int64", 0, 3, 0.0)])
    jperm, pperm = _perms(cols, [(False, True), (False, True)])
    np.testing.assert_array_equal(pperm, jperm)
