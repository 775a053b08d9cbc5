"""The probe kernels' plain versions (what kernels/probes.py runs on a CPU
tensor) against the TPU probes' kernel bodies, run by
`pl.pallas_call(..., interpret=True)` on the JAX CPU backend with the
probes' own (512, W) blocks over 2-3 tiles.

The probe scripts define their kernels inside `main()`, so each body is
restated here beside the file:line it comes from.  The compaction stages
are held to their numpy definitions, and the `full` stage to the JAX
package's compaction as tests/test_torch_compact*.py hold K1 and K3 (the
Pallas K1 and K3 have no interpret mode).  Tolerance: bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from arrowtpu.ops import groupby as jgb
import torch_parity as tp
from torch_parity import release_jax_caches  # noqa: F401
from arrowtpu_torch.kernels import probes
from torch_parity import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)

R = 512  # the probes' block rows
ROWS = 2 * R


def _call(kernel, arrays, out_width, out_dtype=None, rows=None):
    """The probes' pallas_call: one (R, width) block of each input and of
    the output per grid step (prof_gather.py:19-33, prof_gather256.py:24-40,
    prof_deint.py:50-65)."""
    rows = arrays[0].shape[0] if rows is None else rows
    return np.asarray(pl.pallas_call(
        kernel, grid=(rows // R,),
        in_specs=[pl.BlockSpec((R, a.shape[1]), lambda t: (t, 0))
                  for a in arrays],
        out_specs=pl.BlockSpec((R, out_width), lambda t: (t, 0)),
        out_shape=jax.ShapeDtypeStruct(
            (rows, out_width), out_dtype or arrays[0].dtype),
        interpret=True)(*[jnp.asarray(a) for a in arrays]))


def _words(rng, shape, dtype=np.uint32):
    return rng.integers(0, 2**31, shape, dtype=np.int64).astype(dtype)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _copy(i_ref, o_ref):  # prof_gather.py:51, prof_gather256.py:61
    o_ref[...] = i_ref[...]


# ---------------------------------------------------------------------------
# stream: P1 / P2 / P3 copies, P4 x + keep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [128, 256])
def test_stream_copy_matches_probe_copy(width):
    x = _words(np.random.default_rng(0), (ROWS, width), np.int32)
    want = _call(_copy, [x], width)
    got = probes.stream(_t(x.reshape(1, -1)))
    np.testing.assert_array_equal(got.numpy().reshape(ROWS, width), want)


@pytest.mark.parametrize("P", [1, 2])
def test_stream_matches_prof_floor(P):
    """prof_floor.py:27-28 (kern_a, out = x + keep over (P, rows, 128)
    blocks).  kern_b (:47-75) computes the same through manual DMA."""
    rng = np.random.default_rng(P)
    n = 3 * R * 128
    keep = (rng.random(n) > 0.5).astype(np.uint8)
    planes = rng.integers(0, 2**32, (P, n), dtype=np.uint32)

    def kern_a(keep_ref, x_ref, o_ref):
        o_ref[...] = x_ref[...] + keep_ref[...][None].astype(jnp.uint32)

    with jax.enable_x64(False):
        want = np.asarray(pl.pallas_call(
            kern_a, grid=(3,),
            in_specs=[pl.BlockSpec((R, 128), lambda t: (t, 0)),
                      pl.BlockSpec((P, R, 128), lambda t: (0, t, 0))],
            out_specs=pl.BlockSpec((P, R, 128), lambda t: (0, t, 0)),
            out_shape=jax.ShapeDtypeStruct((P, n // 128, 128), jnp.uint32),
            interpret=True)(jnp.asarray(keep.reshape(-1, 128)),
                            jnp.asarray(planes.reshape(P, -1, 128))))
    got = probes.stream(_t(planes), _t(keep))
    np.testing.assert_array_equal(got.numpy(), want.reshape(P, n))
    np.testing.assert_array_equal(probes.stream(_t(planes), _t(keep == 1)),
                                  got)


# ---------------------------------------------------------------------------
# lane_roll: P1 roll chains, P7 roll calibration
# ---------------------------------------------------------------------------


def _rolls_body(k):  # prof_gather.py:55-61
    def kern(i_ref, o_ref):
        v = i_ref[...]
        for j in range(k):
            v = pltpu.roll(v, 1 + (j % 7), axis=1)
        o_ref[...] = v
    return kern


def _rollsel_body(k):  # prof_gather.py:67-74
    def kern(i_ref, m_ref, o_ref):
        v = i_ref[...]
        m = m_ref[...] > (1 << 30)
        for j in range(k):
            v = jnp.where(m, pltpu.roll(v, 1 + (j % 7), axis=1), v)
        o_ref[...] = v
    return kern


def _calibration_body(nrolls, nsel):  # prof_v3.py:91-102
    def kern(x_ref, o_ref):
        x = x_ref[...]
        m = x > 7
        for i in range(nrolls):
            y = pltpu.roll(x, 1 + (i % 7), axis=1)
            if i < nsel:
                x = jnp.where(m, y, x)
            else:
                x = y
        o_ref[...] = x
    return kern


@pytest.mark.parametrize("k", [7, 14, 28])
def test_lane_rolls_match_prof_gather(k):
    x = _words(np.random.default_rng(k), (ROWS, 128))
    want = _call(_rolls_body(k), [x], 128)
    np.testing.assert_array_equal(probes.lane_roll(_t(x), k, 0).numpy(), want)


def test_roll_where_matches_prof_gather():
    rng = np.random.default_rng(14)
    x, m = _words(rng, (ROWS, 128)), _words(rng, (ROWS, 128))
    want = _call(_rollsel_body(14), [x, m], 128)
    got = probes.lane_roll(_t(x), 14, 14, mask=_t(m))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nrolls,nsel", [(0, 0), (14, 0), (14, 14), (28, 28),
                                         (56, 56), (28, 14), (13, 5),
                                         (20, 1)])
def test_roll_calibration_matches_prof_v3(nrolls, nsel):
    # small values too, so that x > 7 is false on some words
    x = _words(np.random.default_rng(nrolls + nsel), (ROWS, 128)) % 16
    want = _call(_calibration_body(nrolls, nsel), [x], 128)
    np.testing.assert_array_equal(
        probes.lane_roll(_t(x), nrolls, nsel).numpy(), want)


# ---------------------------------------------------------------------------
# tile_gather: P1, P2, P3, P5, P6, P7 gathers
# ---------------------------------------------------------------------------


def _take_lanes(i_ref, ix_ref, o_ref):  # prof_gather.py:81-83, prof_v3.py:133
    o_ref[...] = jnp.take_along_axis(
        i_ref[...], ix_ref[...], axis=1).astype(i_ref.dtype)


def _take_sublanes(i_ref, ix_ref, o_ref):  # prof_gather.py:93-95, v3:167
    o_ref[...] = jnp.take_along_axis(
        i_ref[...], ix_ref[...], axis=0).astype(i_ref.dtype)


def _table(i_ref, ix_ref, o_ref):  # prof_gather.py:99-103
    tblb = jnp.broadcast_to(i_ref[0:1, :], ix_ref.shape)
    o_ref[...] = jnp.take_along_axis(tblb, ix_ref[...],
                                     axis=1).astype(i_ref.dtype)


def _chained(i_ref, ix_ref, o_ref):  # prof_gather.py:107-110
    a = jnp.take_along_axis(i_ref[...], ix_ref[...], axis=1)
    o_ref[...] = jnp.take_along_axis(
        a, (ix_ref[...] ^ 63), axis=1).astype(i_ref.dtype)


def _rowmove_onehot():
    return (jax.lax.broadcasted_iota(jnp.int32, (R, R), 0)
            == jax.lax.broadcasted_iota(jnp.int32, (R, R), 1) - 1
            ).astype(jnp.int8)


def _rowmove_i8(i_ref, o_ref):  # prof_gather.py:115-125
    x8 = jax.lax.bitcast_convert_type(i_ref[...], jnp.int8).reshape(R, 512)
    y = jax.lax.dot_general(_rowmove_onehot(), x8, (((0,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32)
    y8 = y.astype(jnp.int8).reshape(R, 128, 4)
    o_ref[...] = jax.lax.bitcast_convert_type(y8, jnp.uint32)


def _rowmove_bytes(i_ref, o_ref):  # prof_gather.py:130-140
    xv = i_ref[...]
    out = jnp.zeros((R, 128), jnp.uint32)
    for k in range(4):
        plane = ((xv >> (8 * k)) & 0xFF).astype(jnp.int8)
        y = jax.lax.dot_general(_rowmove_onehot(), plane,
                                (((0,), (0,)), ((), ())),
                                preferred_element_type=jnp.int32)
        out = out | ((y.astype(jnp.uint32) & 0xFF) << (8 * k))
    o_ref[...] = out


@pytest.mark.parametrize("body,pattern,extent", [
    (_take_lanes, "lanes", 128), (_take_sublanes, "sublanes", R),
    (_table, "table", 128), (_chained, "chained", 128)])
@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
def test_gathers_match_prof_gather(body, pattern, extent, dtype):
    rng = np.random.default_rng(extent)
    x = _words(rng, (ROWS, 128), dtype)
    idx = rng.integers(0, extent, (ROWS, 128), dtype=np.int32)
    want = _call(body, [x, idx], 128)
    got = probes.tile_gather(_t(x), pattern, _t(idx))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("body", [_rowmove_i8, _rowmove_bytes])
def test_rowmove_matches_prof_gather_matmuls(body):
    x = np.random.default_rng(8).integers(0, 2**32, (ROWS, 128),
                                          dtype=np.uint32)
    want = _call(body, [x], 128)
    np.testing.assert_array_equal(
        probes.tile_gather(_t(x), "rowmove").numpy(), want)


def _gpair(i_ref, j_ref, o_ref):  # prof_gather256.py:75-80
    lane = jax.lax.broadcasted_iota(jnp.int32, (R, 256), 1)
    jj = jnp.take_along_axis(
        jnp.concatenate([j_ref[...], j_ref[...]], 1), lane >> 1, axis=1)
    o_ref[...] = jnp.take_along_axis(i_ref[...], jj * 2 + (lane & 1), axis=1)


def _gsplit(i_ref, j_ref, o_ref):  # prof_gather256.py:84-95
    x = i_ref[...]
    lane = jax.lax.broadcasted_iota(jnp.int32, (R, 128), 1)
    lo = jnp.take_along_axis(x, lane * 2, axis=1)[:, :128]
    hi = jnp.take_along_axis(x, lane * 2 + 1, axis=1)[:, :128]
    j = j_ref[...]
    lo = jnp.take_along_axis(lo, j, axis=1)
    hi = jnp.take_along_axis(hi, j, axis=1)
    lane2 = jax.lax.broadcasted_iota(jnp.int32, (R, 256), 1)
    cat = jnp.concatenate([lo, hi], axis=1)
    o_ref[...] = jnp.take_along_axis(
        cat, (lane2 >> 1) + (lane2 & 1) * 128, axis=1)


def _deint(xt):  # prof_deint.py:27-37
    lane = jax.lax.broadcasted_iota(jnp.int32, xt.shape[:1] + (128,), 1)
    e2 = (lane & 63) * 2
    h0, h1 = xt[:, :128], xt[:, 128:]
    half = lane < 64
    lo = jnp.where(half, jnp.take_along_axis(h0, e2, axis=1),
                   jnp.take_along_axis(h1, e2, axis=1))
    hi = jnp.where(half, jnp.take_along_axis(h0, e2 + 1, axis=1),
                   jnp.take_along_axis(h1, e2 + 1, axis=1))
    return lo, hi


def _reint(lo, hi):  # prof_deint.py:39-48, prof_pairlayout.py:40-51
    lane = jax.lax.broadcasted_iota(jnp.int32, lo.shape[:1] + (128,), 1)
    par = (lane & 1) == 1
    i0 = lane >> 1
    h0 = jnp.where(par, jnp.take_along_axis(hi, i0, axis=1),
                   jnp.take_along_axis(lo, i0, axis=1))
    h1 = jnp.where(par, jnp.take_along_axis(hi, 64 + i0, axis=1),
                   jnp.take_along_axis(lo, 64 + i0, axis=1))
    return jnp.concatenate([h0, h1], axis=1)


def _roundtrip(i_ref, o_ref):  # prof_deint.py:81-83
    o_ref[...] = _reint(*_deint(i_ref[...]))


def _deint_move(i_ref, s_ref, o_ref):  # prof_deint.py:89-94
    lo, hi = _deint(i_ref[...])
    s = s_ref[...]
    o_ref[...] = _reint(jnp.take_along_axis(lo, s, axis=1),
                        jnp.take_along_axis(hi, s, axis=1))


@pytest.mark.parametrize("width", [128, 256])
def test_dynamic_gather_matches_prof_gather256(width):
    """prof_gather256.py:64-71, dyn gather 128 and 256."""
    rng = np.random.default_rng(width)
    x = _words(rng, (ROWS, width), np.int32)
    idx = rng.integers(0, width, (ROWS, width), dtype=np.int32)
    want = _call(_take_lanes, [x, idx], width)
    np.testing.assert_array_equal(
        probes.tile_gather(_t(x), "lanes", _t(idx)).numpy(), want)


@pytest.mark.parametrize("body", [_gpair, _gsplit, _deint_move])
def test_pair_gathers_match_prof_gather256_and_deint(body):
    rng = np.random.default_rng(3)
    x = _words(rng, (ROWS, 256), np.int32)
    idx = rng.integers(0, 128, (ROWS, 128), dtype=np.int32)
    want = _call(body, [x, idx], 256)
    np.testing.assert_array_equal(
        probes.tile_gather(_t(x), "pairs", _t(idx)).numpy(), want)


@pytest.mark.parametrize("route", ["two patterns", "roundtrip"])
def test_deinterleave_reinterleave_match_prof_deint(route):
    """prof_deint.py:81-83 (k_roundtrip): the round trip is the identity;
    its halves are the deinterleave and reinterleave patterns, and the
    roundtrip pattern computes it in one launch on the card."""
    x = _words(np.random.default_rng(4), (ROWS, 256), np.int32)
    want = _call(_roundtrip, [x], 256)
    if route == "roundtrip":
        back = probes.tile_gather(_t(x), "roundtrip")
    else:
        planes = probes.tile_gather(_t(x), "deinterleave")
        lo, hi = tp.jit(_deint)(jnp.asarray(x))
        np.testing.assert_array_equal(planes[0].numpy(), np.asarray(lo))
        np.testing.assert_array_equal(planes[1].numpy(), np.asarray(hi))
        back = probes.tile_gather(planes, "reinterleave")
    np.testing.assert_array_equal(back.numpy(), want)
    np.testing.assert_array_equal(want, x)


def test_reinterleave_matches_prof_pairlayout_and_epi3():
    """prof_pairlayout.py:68-71 (two u32 planes -> (rows, 256) pairs) and
    prof_epi3.py:26-29, the same body behind a scalar-prefetched count it
    does not use (that script imports arrowtpu.pallas.compact4, which is
    not in the tree, so its _reint is P5's)."""
    rng = np.random.default_rng(5)
    n = ROWS * 128
    planes = rng.integers(0, 2**32, (2, n), dtype=np.uint32)
    lo, hi = (p.reshape(ROWS, 128) for p in planes)

    def kern(lo_ref, hi_ref, o_ref):
        o_ref[...] = _reint(lo_ref[...].astype(jnp.int32),
                            hi_ref[...].astype(jnp.int32)).astype(jnp.uint32)

    def kern_cnt(cnt_ref, lo_ref, hi_ref, o_ref):
        kern(lo_ref, hi_ref, o_ref)

    with jax.enable_x64(False):
        want = _call(kern, [lo, hi], 256)
        gs = pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(ROWS // R,),
            in_specs=[pl.BlockSpec((R, 128), lambda t, c: (t, 0))] * 2,
            out_specs=pl.BlockSpec((R, 256), lambda t, c: (t, 0)))
        want_epi = np.asarray(pl.pallas_call(
            kern_cnt, grid_spec=gs,
            out_shape=jax.ShapeDtypeStruct((ROWS, 256), jnp.uint32),
            interpret=True)(jnp.asarray([3_000_000], jnp.int32),
                            jnp.asarray(lo), jnp.asarray(hi)))
    got = probes.tile_gather(_t(planes.reshape(2, ROWS, 128)), "reinterleave")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want_epi, want)
    # the (n, 2) view of the result is the pairs (lo[i], hi[i])
    np.testing.assert_array_equal(got.numpy().reshape(n, 2), planes.T)


# ---------------------------------------------------------------------------
# compaction_stages: P7's K3 ablation (prof_v3.py:65-78), P8
# (prof_kernel.py:147)
# ---------------------------------------------------------------------------

N_STAGE = 9000  # two full 4096-row tiles and a partial one


@pytest.mark.parametrize("density", [0.0, 0.055, 0.5, 1.0])
@pytest.mark.parametrize("kernel", probes.KERNELS)
def test_compaction_stages_match_their_definitions(kernel, density):
    rng = np.random.default_rng(int(density * 1000))
    planes = rng.integers(0, 2**32, (2, N_STAGE), dtype=np.uint32)
    keep = rng.random(N_STAGE) < density
    count = int(keep.sum())
    tiles = np.add.reduceat(keep.astype(np.int64),
                            np.arange(0, N_STAGE, 4096))
    kept_words = planes[:, keep]
    stages = [s for s in probes.STAGES if (s, kernel) != ("lookback", "k1")]
    for stage in stages:
        out, aux = probes.compaction_stages(_t(planes), _t(keep), stage,
                                            kernel)
        out = out.numpy()
        if stage in ("copy", "rank", "lookback"):
            np.testing.assert_array_equal(out, planes)
        want_aux = {"rank": tiles,
                    "lookback": np.cumsum(tiles) - tiles}.get(stage)
        if want_aux is None:
            assert aux is None
        else:
            np.testing.assert_array_equal(aux.numpy(), want_aux)
        if stage == "kept":
            np.testing.assert_array_equal(out[:, :count], kept_words)
        if stage == "full":
            want = np.stack(jgb._compact_u32_planes(
                [jnp.asarray(p) for p in planes], jnp.asarray(keep), N_STAGE))
            np.testing.assert_array_equal(out, want)


def test_compaction_stages_check_their_operands():
    planes = torch.zeros((2, 100), dtype=torch.int32)
    keep = torch.ones(100, dtype=torch.bool)
    with pytest.raises(ValueError):  # K1's look-back is its count pass
        probes.compaction_stages(planes, keep, "lookback", "k1")
    with pytest.raises(ValueError):
        probes.compaction_stages(planes, keep, "nope")
    with pytest.raises(ValueError):
        probes.compaction_stages(planes.to(torch.int64), keep, "copy")
