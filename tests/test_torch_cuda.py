"""The CUDA kernels against their plain versions, and the port's paths on
the card against the CPU or a numpy oracle.

Marked `cuda`; each test skips where there is no CUDA device.  This file
imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: bit-exact (count and zero tail included), except float sums
and means of random values, whose cumsum the card adds in another order
than the CPU: those are held within 2**-40 x the sum of |v| over the
column (over the count for a mean); and the NaNs of float arithmetic,
which are NaN on both, but the card's with its one canonical payload
(it does not carry an input NaN's payload through an op).
"""

import numpy as np
import pytest
import torch

import ipc_spans
from arrowtpu_torch.config import TakeOptions
from arrowtpu_torch.entry import (agg_oracle, agg_plan, agg_step, check_agg,
                                  check_join_output, check_lexsort, check_q6,
                                  example_agg_arrays, example_lineitem_arrays,
                                  lineitem_batch, q6_oracle, q6_step,
                                  check_q1, q1_oracle, q1_step,
                                  dryrun_multichip, example_batch,
                                  example_join_shards,
                                  example_lexsort_arrays, join_oracle,
                                  join_step, lexsort_columns, lexsort_keys,
                                  lexsort_step, step)
from arrowtpu_torch import schema as st
from arrowtpu_torch.core import batch as pbt
from arrowtpu_torch.core import bitmap as bm
from arrowtpu_torch.core import column as pcol
from arrowtpu_torch.core import validate as pval
from arrowtpu_torch.formats import ipc as pipc
from arrowtpu_torch.interop.numpy_bridge import (batch_from_numpy,
                                                 column_to_numpy)
from arrowtpu_torch.kernels import _build
from arrowtpu_torch.kernels import compact as k2
from arrowtpu_torch.kernels import compact2 as k3
from arrowtpu_torch.kernels import compact3 as k1
from arrowtpu_torch.kernels import dense_agg as dk
from arrowtpu_torch.kernels import probes
from arrowtpu_torch.ops import groupby as gb
from arrowtpu_torch.ops.groupby import group_by
from arrowtpu_torch.ops.concat import concat, concat_batches
from arrowtpu_torch.ops.filter import filter_record_batch
from arrowtpu_torch.ops.take import take_record_batch
from arrowtpu_torch.ops.join import hash_join
from arrowtpu_torch.parallel import distributed as pdist
from arrowtpu_torch.parallel import mesh
from arrowtpu_torch.parallel import shuffle as pshuffle
from arrowtpu_torch.probes import fresh_call

pytestmark = pytest.mark.cuda

DENSITIES = [0.0, 0.02, 0.5, 0.96, 1.0]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _planes(P, n, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max, (P, n), dtype=dtype,
                         device=device, generator=g)


def _keep(n, density, device, seed):
    g = torch.Generator(device=device).manual_seed(seed + 1)
    return torch.rand(n, device=device, generator=g) < density


@pytest.mark.parametrize("n", [1, 4095, 65536, 1_000_003])
@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("dtype,P", [(torch.int32, 1), (torch.int32, 16),
                                     (torch.int64, 2), (torch.int64, 17)])
def test_k1_matches_plain(cuda, dtype, P, density, n):
    planes = _planes(P, n, dtype, cuda, n + P)
    keep = _keep(n, density, cuda, n)
    k1.launches = 0
    got = k1.compact_planes(planes, keep)
    assert k1.launches == -(-P // 16)
    want = k1.compact_planes_plain(planes, keep)
    assert torch.equal(got, want)
    rows = min(n, int(keep.sum()) + 7)  # output cut to just past the count
    assert torch.equal(k1.compact_planes(planes, keep, out_rows=rows),
                       want[:, :rows])


@pytest.mark.parametrize("n", [4095, 1_000_003])
@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
def test_k2_matches_plain(cuda, dtype, density, n):
    planes = _planes(3, n, dtype, cuda, n)
    keep = _keep(n, density, cuda, n).to(torch.uint8)
    got, cnt = k2.compact_planes_info(planes, keep)
    want, wcnt = k2.compact_planes_info_plain(planes, keep)
    assert int(cnt) == int(wcnt) and torch.equal(got, want)


# ---------------------------------------------------------------------------
# K2 on the tile body: u8 (bool, validity) and u32 words, both frames
# ---------------------------------------------------------------------------

K2_NS = [1, 15, 16, 17, 4095, 4097, 4099, 1_000_003]
K2_DENSITIES = [0.0, "one", 0.005, 0.055, 0.0625, 0.5, 0.96, 1.0]
K2_SHIFTS = {torch.uint8: range(16), torch.bool: (0, 1, 7, 15),
             torch.int32: range(4)}  # in words: 0 to 15 bytes


def _k2_planes(dtype, P, n, shift, device, seed):
    """(P, n) planes `shift` words into their storage, so that plane p
    starts (shift + p n) words in: every byte offset mod 16 when n is odd."""
    store = torch.uint8 if dtype == torch.bool else dtype
    raw = _planes(1, P * n + shift, store, device, seed)[0]
    if dtype == torch.bool:
        raw = raw.bool()
    return raw[shift:].view(P, n)


@pytest.mark.parametrize("density", K2_DENSITIES)
@pytest.mark.parametrize("n", K2_NS)
@pytest.mark.parametrize("dtype", [torch.uint8, torch.bool, torch.int32])
def test_k2_frames_shifts_and_out_rows(cuda, dtype, n, density):
    """K2 with the tile info (the filter's plan) and without (look-back, the
    count written on the card), its four planes 0 to 15 bytes into their
    storage, at every out_rows from the count to n, on outputs poisoned
    with 0x5A: equal to the plain version, count included, one launch."""
    keep = _edge_keep(n, density, cuda, n + 61).to(torch.uint8)
    count = int(keep.sum())
    info = k2.tile_info(keep)
    for shift in K2_SHIFTS[dtype]:
        planes = _k2_planes(dtype, 4, n, shift, cuda, n + shift)
        for rows in _out_rows(n, count):
            want, wcnt = k2.compact_planes_info_plain(planes, keep, rows)
            for i in (info, None):
                k2.launches = 0
                got, cnt = fresh_call(
                    lambda: k2.compact_planes_info(planes, keep, i, rows),
                    (want, wcnt))
                torch.cuda.synchronize()
                assert k2.launches == 1
                assert torch.equal(got, want), (shift, rows, i is None)
                assert cnt.dim() == 0 and cnt.device == keep.device
                assert int(cnt) == int(wcnt) == count


@pytest.mark.parametrize("with_info", [True, False])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
def test_k2_seventeen_planes(cuda, dtype, with_info):
    """P = 17: two launches sharing the mask (and, without info, one
    scratch that the second launch finds reset)."""
    n = 1_000_003
    planes = _planes(17, n, dtype, cuda, 71)
    keep = _keep(n, 0.055, cuda, 72)
    info = k2.tile_info(keep) if with_info else None
    want, wcnt = k2.compact_planes_info_plain(planes, keep)
    k2.launches = 0
    got, cnt = fresh_call(lambda: k2.compact_planes_info(planes, keep, info),
                          (want, wcnt))
    torch.cuda.synchronize()
    assert k2.launches == 2
    assert torch.equal(got, want) and int(cnt) == int(wcnt)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
def test_k2_look_back_twice_on_one_scratch(cuda, dtype):
    """Two look-back launches in a row on one scratch and one count word,
    on masks of other densities: the second finds its status words reset
    and writes its own count."""
    n = 1_000_003
    planes = _planes(4, n, dtype, cuda, 81)
    masks = [_keep(n, d, cuda, 82 + i) for i, d in enumerate((0.5, 0.055))]
    scratch = _build.lookback_scratch(masks[0])
    count = torch.empty((), dtype=torch.int64, device=cuda)
    for keep in masks:
        want, wcnt = k2.compact_planes_info_plain(planes, keep)
        out = torch.full_like(want, 0x5A)
        _build.tiles_cuda(list(planes), list(out), keep, None, scratch,
                          count)
        torch.cuda.synchronize()
        assert torch.equal(out, want) and int(count) == int(wcnt)


@pytest.mark.parametrize("shift", [0, 1, 3])
@pytest.mark.parametrize("dtype,density", [(torch.uint8, 0.2),
                                           (torch.int32, 0.25),
                                           (torch.int64, 0.5)])
def test_tiles_either_side_of_the_dense_threshold(cuda, dtype, density,
                                                  shift):
    """At the density of the word's dense threshold (a fifth of a tile's
    rows kept for bytes, a quarter for u32, half for u64) about half the
    tiles are staged whole by bulk copies and the rest load their kept
    words: one launch in each frame, on planes `shift` words into their
    storage, equals the plain version, count included."""
    n = 1_000_003
    planes = _k2_planes(dtype, 4, n, shift, cuda, 91)
    keep = _keep(n, density, cuda, 92)
    kept = int(keep.sum())
    want = torch.zeros_like(planes)
    want[:, :kept] = planes[:, keep]
    count = torch.empty((), dtype=torch.int64, device=cuda)
    for offs in (_build.tile_offsets(keep), None):
        out = torch.full_like(want, 0x5A)
        _build.tiles_cuda(list(planes), list(out), keep, offs,
                          _build.lookback_scratch(keep), count)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    assert int(count) == kept


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int64])
def test_unaligned_nonbinary_keep(cuda, dtype):
    """A keep mask one byte into its buffer (the kernels' scalar load path)
    whose kept bytes are 2, not 1: any nonzero byte keeps its row."""
    n = 100_003
    planes = _planes(3, n, dtype, cuda, 5)
    raw = (torch.rand(n + 1, device=cuda) < 0.3).to(torch.uint8) * 2
    keep = raw[1:]
    assert keep.data_ptr() % 16
    if dtype == torch.uint8:
        got, cnt = k2.compact_planes_info(planes, keep)
        want, wcnt = k2.compact_planes_info_plain(planes, keep)
        assert int(cnt) == int(wcnt)
    else:
        got = k1.compact_planes(planes, keep)
        want = k1.compact_planes_plain(planes, keep)
    assert torch.equal(got, want)
    assert int(k1.tile_offsets(keep)[-1]) == int(keep.bool().sum())


# ---------------------------------------------------------------------------
# K1 and K3's tile body: the index list, both offset frames, the zero fill
# ---------------------------------------------------------------------------

EDGE_DENSITIES = [0.0, "one", 0.055, 0.5, 0.96, 1.0]


def _edge_keep(n, density, device, seed):
    """A mask of `density`, or "one": a single kept row."""
    if density == "one":
        keep = torch.zeros(n, dtype=torch.bool, device=device)
        keep[(n * 7) // 11] = True
        return keep
    return _keep(n, density, device, seed)


def _out_rows(n, count):
    """out_rows of count, count + 1, n - 1 and n, each kept in [count, n]."""
    return sorted({max(count, min(r, n)) for r in (count, count + 1, n - 1,
                                                   n)})


def _same(kernel, want):
    """kernel() on output blocks first poisoned with 0x5A (fresh_call)
    equals `want` bit for bit."""
    got = fresh_call(kernel, want)
    torch.cuda.synchronize()
    if isinstance(want, list):
        assert len(got) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 4095, 4097, 4099, 1_000_003])
@pytest.mark.parametrize("density", EDGE_DENSITIES)
@pytest.mark.parametrize("dtype,P", [(torch.int32, 3), (torch.int64, 2)])
def test_k1_frames_and_out_rows(cuda, dtype, P, density, n):
    """K1 with offs (the tiles read their offsets) and without (the tiles
    look back), at every out_rows from the count to n: the zero range cut
    at out_rows, and plane starts that are not 16-byte aligned when n * w
    is not a multiple of 16."""
    planes = _planes(P, n, dtype, cuda, n + 3 * P)
    keep = _edge_keep(n, density, cuda, n + 5)
    count = int(keep.sum())
    offs = k1.tile_offsets(keep)
    for rows in _out_rows(n, count):
        want = k1.compact_planes_plain(planes, keep, rows)
        for o in (offs, None):
            k1.launches = 0
            _same(lambda: k1.compact_planes(planes, keep, o, rows), want)
            assert k1.launches == 1


@pytest.mark.parametrize("n", [1, 4095, 4097, 4099, 1_000_003])
@pytest.mark.parametrize("density", EDGE_DENSITIES)
def test_k3_edge_shapes(cuda, density, n):
    planes = _planes(5, n, torch.int32, cuda, n + 7)
    keep = _edge_keep(n, density, cuda, n + 9)
    want = k3.compact_planes_plain(planes, keep)
    _same(lambda: k3.compact_planes(planes, keep), want)


@pytest.mark.parametrize("density", [0.055, 0.5, 0.96])
def test_unaligned_planes_take_the_scalar_head(cuda, density):
    """Planes one word into their buffer, and (P, n) outputs whose planes
    after the first start off a 16-byte boundary (n * 4 = 4 mod 16): the
    loads take any address and the zero fill its scalar head words."""
    n, P = 100_001, 4
    raw = _planes(1, P * n + 1, torch.int32, cuda, 21)[0]
    planes = raw[1:].view(P, n)
    assert planes.data_ptr() % 16 == 4
    keep = _keep(n, density, cuda, 22)
    count = int(keep.sum())
    want = k1.compact_planes_plain(planes, keep)
    _same(lambda: k3.compact_planes(planes, keep), want)
    _same(lambda: k1.compact_planes(planes, keep), want)
    _same(lambda: k1.compact_planes(planes, keep, k1.tile_offsets(keep)),
          want)
    rows = count + 3  # outputs of count + 3 rows: plane p at 4 p (count + 3)
    _same(lambda: k1.compact_planes(list(planes), keep, out_rows=rows),
          list(want[:, :rows]))


@pytest.mark.parametrize("dtype,shift", [(torch.int32, 0), (torch.int32, 1),
                                         (torch.int32, 3), (torch.int64, 0),
                                         (torch.int64, 1)])
def test_dense_and_sparse_tiles_in_one_launch(cuda, dtype, shift):
    """Tiles alternate between 96 % and 2 % kept, so the dense ones stage
    their words by bulk copies and the sparse ones word by word in one
    launch; the planes start `shift` words into their buffer and n * w is
    not a multiple of 16, so a chunk's first and last words lie outside the
    copies' 16-byte units.  Both frames, out_rows from the count to n."""
    tile = _build.TILE_ROWS
    n, P = 10 * tile + 123, 3
    raw = _planes(1, P * n + shift, dtype, cuda, 51)[0]
    planes = raw[shift:].view(P, n)
    dense = (torch.arange(n, device=cuda) // tile) % 2 == 0
    keep = torch.where(dense, _keep(n, 0.96, cuda, 52), _keep(n, 0.02, cuda,
                                                              53))
    count = int(keep.sum())
    offs = k1.tile_offsets(keep)
    for rows in _out_rows(n, count):
        want = k1.compact_planes_plain(planes, keep, rows)
        for o in (offs, None):
            _same(lambda: k1.compact_planes(planes, keep, o, rows), want)
    if dtype == torch.int32:
        _same(lambda: k3.compact_planes(planes, keep),
              k3.compact_planes_plain(planes, keep))


@pytest.mark.parametrize("n", [4097, 1_000_003])
def test_seventeen_planes(cuda, n):
    """P = 17: two launches, sharing the mask (and, without offs, one
    scratch that the second launch finds reset)."""
    planes = _planes(17, n, torch.int32, cuda, 31)
    keep = _keep(n, 0.3, cuda, 32)
    want = k1.compact_planes_plain(planes, keep)
    for kernel, module in ((lambda: k3.compact_planes(planes, keep), k3),
                           (lambda: k1.compact_planes(planes, keep), k1),
                           (lambda: k1.compact_planes(
                               planes, keep, k1.tile_offsets(keep)), k1)):
        module.launches = 0
        _same(kernel, want)
        assert module.launches == 2


def test_k1_look_back_twice_in_a_row(cuda):
    """Two K1 calls without offs on different masks, back to back: the
    second finds its status words and tile counter reset."""
    n = 1_000_003
    planes = _planes(2, n, torch.int64, cuda, 41)
    masks = [_keep(n, d, cuda, 42 + i) for i, d in enumerate((0.5, 0.02))]
    got = [k1.compact_planes(planes, m) for m in masks]
    for g, m in zip(got, masks):
        assert torch.equal(g, k1.compact_planes_plain(planes, m))


def test_group_by_launches_no_count_kernel(cuda):
    """Group extraction passes no offs: each K1 call is one kernel launch,
    with no count kernel (and so no cumsum of its counts)."""
    batch = example_batch(200_000, 3, 0.1, 5000, device=cuda)
    k1.launches = 0
    _build.count_launches = 0
    out = group_by(batch, ["k"], [("v", "sum"), ("v", "count"), ("v", "min")])
    torch.cuda.synchronize()
    assert k1.launches == 2 and _build.count_launches == 0
    cpu = example_batch(200_000, 3, 0.1, 5000, device="cpu")
    assert out.to_pydict() == group_by(cpu, ["k"], [
        ("v", "sum"), ("v", "count"), ("v", "min")]).to_pydict()


def test_cuda_tensors_never_fall_back(cuda):
    keep = torch.ones(10, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        k1.compact_planes([torch.zeros(10, dtype=torch.int16, device=cuda)],
                          keep)


def test_step_on_card_matches_cpu(cuda):
    got = step(example_batch(50_000, 3, 0.1, 5000, device=cuda)).to_pydict()
    want = step(example_batch(50_000, 3, 0.1, 5000, device="cpu")).to_pydict()
    assert got == want


@pytest.mark.parametrize("n", [1, 4095, 65536, 1_000_003])
@pytest.mark.parametrize("P", [1, 16, 17])
def test_k3_matches_plain_and_k1_twice(cuda, P, n):
    """K3 against its plain version and against K1 (the same function), two
    masks in a row: the second launch finds its status words and tile
    counter reset."""
    planes = _planes(P, n, torch.int32, cuda, n + P)
    for density in DENSITIES:
        masks = [_keep(n, density, cuda, n + i) for i in range(2)]
        k3.launches = 0
        got = [k3.compact_planes(planes, keep) for keep in masks]
        assert k3.launches == 2 * -(-P // 16)
        for g, keep in zip(got, masks):
            want = k3.compact_planes_plain(planes, keep)
            assert torch.equal(g, want)
            assert torch.equal(g, k1.compact_planes(planes, keep))
            assert not g[:, int(keep.sum()):].any()


def test_hash_join_on_card_matches_cpu(cuda):
    """N:M join with null keys: the card's rounds and gathers give the CPU's
    answer (which the CPU tests hold against the JAX package)."""
    rng = np.random.default_rng(5)
    arrays = ({"k": (rng.integers(0, 50_000, 200_000),
                     rng.random(200_000) > 0.05),
               "v": (rng.integers(-50, 50, 200_000), None)},
              {"k": (rng.integers(0, 40_000, 60_000),
                     rng.random(60_000) > 0.05),
               "rv": (rng.integers(0, 10**6, 60_000),
                      rng.random(60_000) > 0.1)})
    for how in ("inner", "left", "semi", "anti"):
        outs = []
        for device in (cuda, "cpu"):
            left, right = (batch_from_numpy(a, device=device) for a in arrays)
            out, info = hash_join(left, right, ["k"], how=how)
            outs.append((out.to_pydict(), bool(info.duplicates)))
        assert outs[0] == outs[1], how


def test_join_step_on_card_against_oracle(cuda):
    """The distributed step at world size 1 over NCCL, 3M x 300k rows."""
    shards = example_join_shards(0, 1, 3_000_000, 300_000, key_range=375_000,
                                 key_nulls=0.05, rv_nulls=0.1,
                                 permute_build=True)
    left, right = (batch_from_numpy(a, device=cuda) for a in shards)
    with mesh.process_group(0, 1, cuda) as group:
        k1.launches = 0
        out = join_step(left, right, group)
        assert k1.launches > 0
    assert check_join_output([out], join_oracle([shards])) > 0


def _tensors_of(c):
    return [getattr(c, n) for n in ("values", "views", "arena", "validity")
            if isinstance(getattr(c, n, None), torch.Tensor)]


def test_concat_on_card_matches_cpu(cuda):
    """concat_batches of int64 (nulls), float64 and bool (nulls) columns
    with a zero-length input, and concat of string views and of dictionary
    columns sharing one dictionary: every tensor of the card's output
    equals the CPU's."""
    rng = np.random.default_rng(11)
    arrays = [{"a": (rng.integers(-2**40, 2**40, n), rng.random(n) > 0.2),
               "f": (rng.standard_normal(n), None),
               "b": (rng.random(n) < 0.5, rng.random(n) > 0.1)}
              for n in (100_000, 0, 77_777)]
    strings = [["pear", None, "a string longer than twelve", ""], [],
               ["x" * 40, "fig", None]]
    words = ["b", "a long dictionary word", "c"]
    keys = [(rng.integers(0, 3, n).astype(np.int32), rng.random(n) > 0.2)
            for n in (5000, 0, 300)]
    outs = []
    for device in (cuda, "cpu"):
        proto = pcol.dictionary_encode_host(words, device=device)
        outs.append((
            concat_batches([batch_from_numpy(a, device=device)
                            for a in arrays]),
            concat([pcol.string_view(w, device=device) for w in strings]),
            concat([pcol.DictionaryColumn(
                pcol.primitive(k, st.int32, validity=ok, device=device),
                proto.values, proto.value_ranks, proto.dtype)
                for k, ok in keys])))
    (gb, gs, gd), (wb, ws, wd) = outs
    assert gb.device.type == "cuda" and gb.length == 177_777
    assert gs.to_pylist() == ws.to_pylist() == sum(strings, [])
    assert gd.to_pylist() == wd.to_pylist()
    for g, w in zip(gb.columns + (gs, gd.keys), wb.columns + (ws, wd.keys)):
        assert (g.length, g.capacity) == (w.length, w.capacity)
        for x, y in zip(_tensors_of(g), _tensors_of(w)):
            assert torch.equal(x.cpu(), y)


def test_skew_join_on_card_matches_cpu(cuda):
    """The skew path and chunked probes at world size 1 over NCCL, 400k x
    40k rows with Zipf(1.0) probe keys: the join's output and flags equal
    the CPU's (which the CPU tests hold to the JAX package), K1 and K2
    launch in its filters, and the step equals the numpy oracle."""
    shards = example_join_shards(0, 1, 400_000, 40_000, key_range=50_000,
                                 key_nulls=0.05, rv_nulls=0.1,
                                 permute_build=True, zipf=1.0)
    skew = {"skew_threshold": 0.01, "probe_chunks": 4}
    outs = []
    for device in (cuda, "cpu"):
        left, right = (batch_from_numpy(a, device=device) for a in shards)
        with mesh.process_group(0, 1, device) as group:
            k1.launches = k2.launches = 0
            out, info = pdist.distributed_hash_join(left, right, ["k"],
                                                    group=group, **skew)
            if device is cuda:
                # the inner join filters nothing: these are the skew path's
                assert k1.launches > 0 and k2.launches > 0
                assert check_join_output(
                    [join_step(left, right, group, **skew)],
                    join_oracle([shards])) > 0
        outs.append(([column_to_numpy(c) for c in out.columns],
                     bool(info.duplicates), info.overflow))
    (got, *flags), (want, *want_flags) = outs
    assert flags == want_flags == [False, False]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_dryrun_multichip_on_one_card(cuda):
    assert dryrun_multichip(1) > 0


# ---------------------------------------------------------------------------
# the probe kernels and the compaction stage variants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 4097, 65_539])
@pytest.mark.parametrize("P", [1, 2, 16])
def test_stream_matches_plain(cuda, P, n):
    planes = _planes(P, n, torch.int32, cuda, n + P)
    keep = _keep(n, 0.5, cuda, n).to(torch.uint8)
    probes.launches["stream"] = 0
    for k in (None, keep, keep.bool()):
        assert torch.equal(probes.stream(planes, k),
                           probes.stream_plain(planes, k))
    assert probes.launches["stream"] == 3
    # planes and keep one word / one byte off their 16-byte boundary
    raw = _planes(1, P * n + 1, torch.int32, cuda, 3)[0]
    shifted = raw[1:].view(P, n)
    kraw = _keep(n + 1, 0.5, cuda, 4).to(torch.uint8)
    assert torch.equal(probes.stream(shifted, kraw[1:]),
                       probes.stream_plain(shifted, kraw[1:]))


@pytest.mark.parametrize("rows", [1000, 1, 3, 1001])
@pytest.mark.parametrize("k,nsel", [(0, 0), (7, 0), (14, 14), (28, 28),
                                    (56, 56), (14, 3), (28, 14), (13, 5),
                                    (20, 1), (64, 0), (71, 70)])
@pytest.mark.parametrize("with_mask", [False, True])
def test_lane_roll_matches_plain(cuda, k, nsel, with_mask, rows):
    # rows that leave the last warp's rows part filled; at offset 1 the
    # rows start one word into their buffers (no 16-byte accesses)
    for offset in (0, 1):
        flat = _planes(1, rows * 128 + offset, torch.int32, cuda, k)[0]
        flat[::3] %= 16  # so that x > 7 is false on some words
        x = flat[offset:].view(rows, 128)
        mask = (_planes(1, rows * 128 + offset, torch.int32, cuda, 9)[0]
                [offset:].view(rows, 128) if with_mask else None)
        assert torch.equal(probes.lane_roll(x, k, nsel, mask),
                           probes.lane_roll_plain(x, k, nsel, mask))


def _gather_case(pattern, W, rows, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    info = torch.iinfo(torch.int32)
    shape = (2, rows, 128) if pattern == "reinterleave" else (rows, W)
    x = torch.randint(info.min, info.max, shape, dtype=torch.int32,
                      device=device, generator=g)
    extent = {"sublanes": probes.TILE_ROWS, "pairs": 128}.get(pattern, W)
    idx_shape = (rows, 128) if pattern == "pairs" else (rows, W)
    idx = (None if pattern in ("rowmove", "deinterleave", "reinterleave",
                               "roundtrip")
           else torch.randint(0, extent, idx_shape, dtype=torch.int32,
                              device=device, generator=g))
    return x, idx


GATHERS = [(p, W) for p in ("lanes", "sublanes", "table", "chained",
                            "rowmove") for W in (128, 256)]
GATHERS += [("deinterleave", 256), ("reinterleave", 256), ("pairs", 256),
            ("roundtrip", 256)]


@pytest.mark.parametrize("pattern,W", GATHERS)
def test_tile_gather_matches_plain(cuda, pattern, W):
    x, idx = _gather_case(pattern, W, 3 * probes.TILE_ROWS, cuda, W)
    got = probes.tile_gather(x, pattern, idx)
    assert torch.equal(got, probes.tile_gather_plain(x, pattern, idx))
    if idx is not None:  # indices past the extent wrap, as in the plain
        wide = idx + 1024
        assert torch.equal(probes.tile_gather(x, pattern, wide),
                           probes.tile_gather_plain(x, pattern, wide))


@pytest.mark.parametrize("rows", [probes.TILE_ROWS, 62_976])
@pytest.mark.parametrize("pattern,W", [("roundtrip", 256), ("sublanes", 128),
                                       ("sublanes", 256)])
def test_redesigned_gathers_match_plain(cuda, pattern, W, rows):
    """The round trip in one launch (the identity) and the sublane gather
    staged in shared memory, at one tile and at the probes' 62,976 rows, on
    outputs poisoned with 0x5A; the sublane indices also past 512 and
    negative (taken modulo 512, as in the plain version)."""
    x, idx = _gather_case(pattern, W, rows, cuda, rows + W)
    want = probes.tile_gather_plain(x, pattern, idx)
    probes.launches["tile_gather"] = 0
    got = fresh_call(lambda: probes.tile_gather(x, pattern, idx), want)
    torch.cuda.synchronize()
    assert probes.launches["tile_gather"] == 1
    assert torch.equal(got, want)
    if pattern == "roundtrip":
        assert torch.equal(got, x)
    else:
        wide = idx * 3 - 700
        assert torch.equal(probes.tile_gather(x, pattern, wide),
                           probes.tile_gather_plain(x, pattern, wide))


STAGE_CASES = [(s, k) for k in probes.KERNELS for s in probes.STAGES
               if (s, k) != ("lookback", "k1")]


@pytest.mark.parametrize("n,P", [(100_003, 3), (4099, 17)])
@pytest.mark.parametrize("density", [0.0, 0.055, 0.5, 1.0])
@pytest.mark.parametrize("stage,kernel", STAGE_CASES)
def test_compaction_stage_matches_plain(cuda, stage, kernel, density, n, P):
    planes = _planes(P, n, torch.int32, cuda, 11)
    keep = _keep(n, density, cuda, 12)
    got, aux = fresh_call(
        lambda: probes.compaction_stages(planes, keep, stage, kernel),
        probes.compaction_stages_plain(planes, keep, stage, kernel))
    want, waux = probes.compaction_stages_plain(planes, keep, stage, kernel)
    words = int(keep.sum()) if stage == "kept" else n
    assert torch.equal(got[:, :words], want[:, :words])
    assert (aux is None) == (waux is None)
    if aux is not None:
        assert torch.equal(aux, waux)


def test_lexsort_on_card_matches_cpu(cuda):
    """Config 3's lexsort at 1M rows: the card's index equals the CPU's
    and passes the host check."""
    arrays = example_lexsort_arrays(1_000_000)
    got, want = (lexsort_step(lexsort_columns(*arrays, device=d))
                 for d in (cuda, "cpu"))
    assert got.length == want.length == 1_000_000
    assert torch.equal(got.values.cpu(), want.values)
    check_lexsort(want.values.numpy(), lexsort_keys(*arrays))


@pytest.mark.parametrize("kernel,module,with_offs", [
    ("k3", k3, False), ("k1", k1, False), ("k1", k1, True)])
def test_full_stage_is_the_production_kernel(cuda, kernel, module,
                                             with_offs):
    """The full stage of tile_compact_kernel equals each production entry:
    K3, and K1 in both offset frames."""
    planes = _planes(17, 70_001, torch.int32, cuda, 13)
    keep = _keep(70_001, 0.3, cuda, 14)
    got, _ = probes.compaction_stages(planes, keep, "full", kernel)
    if module is k3:
        want = k3.compact_planes(planes, keep)
    else:
        want = k1.compact_planes(
            planes, keep, k1.tile_offsets(keep) if with_offs else None)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the dense-range aggregate (kernels/dense_agg.py) and config 4
# ---------------------------------------------------------------------------

I64 = torch.iinfo(torch.int64)
DENSE_VALUE_DTYPES = [torch.int8, torch.int16, torch.int32, torch.int64,
                      torch.uint8, torch.uint32]


def _dense_inputs(nb, n, nullable, key_dtype, ncols, device, seed):
    """A key over nb + 4 values around kmin (so some rows fall outside the
    buckets), values of every width with their extremes, validity bitmaps
    when nullable."""
    g = torch.Generator(device=device).manual_seed(seed)
    cap = -(-max(n, 1) // 64) * 64
    kmin = 3 if key_dtype != torch.uint32 else 2**32 - nb - 1
    key = (kmin - 2 + torch.randint(0, nb + 4, (cap,), generator=g,
                                    device=device)).to(key_dtype)

    def bitmap():
        if not nullable:
            return None
        return bm.pack(torch.rand(cap, generator=g, device=device) > 0.2)

    values = []
    for c in range(ncols):
        dt = DENSE_VALUE_DTYPES[c % len(DENSE_VALUE_DTYPES)]
        if dt == torch.uint32:
            v = torch.randint(0, 2**32, (cap,), generator=g, device=device)
            v[:2] = torch.tensor([0, 2**32 - 1])
            v = v.to(dt)
        else:
            info = torch.iinfo(dt)
            v = torch.randint(info.min, info.max, (cap,), dtype=dt,
                              generator=g, device=device)
            v[:4] = torch.tensor([info.min, info.max, info.max, info.min])
        values.append((v, bitmap()))
    kmin_t = torch.tensor([kmin], dtype=torch.int64, device=device)
    return key, bitmap(), kmin_t, values


@pytest.mark.parametrize("nullable", [False, True])
@pytest.mark.parametrize("n", [1, 4097, 1_000_003, 8_000_000])
@pytest.mark.parametrize("nb,key_dtype", [(2, torch.int8), (128, torch.int32),
                                          (256, torch.uint32)])
def test_dense_agg_matches_plain(cuda, nb, key_dtype, n, nullable):
    """The kernel against its plain version, bit for bit, twice in a row
    (atomics land in another order each run; integer results do not
    care): int8-int64 and uint8 / uint32 values with their extremes, sums
    that wrap, rows outside the buckets and past n."""
    key, kvalid, kmin, values = _dense_inputs(nb, n, nullable, key_dtype, 6,
                                              cuda, n + nb)
    want = dk.dense_aggregate_plain(key, kvalid, kmin, int(nullable), nb, n,
                                    values)
    for _ in range(2):
        dk.launches = 0
        got = dk.dense_aggregate(key, kvalid, kmin, int(nullable), nb, n,
                                 values)
        torch.cuda.synchronize()
        assert dk.launches == 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("nb,ncols,launches", [(256, 9, 2), (4096, 2, 2),
                                               (128, 0, 1)])
def test_dense_agg_launch_splits(cuda, nb, ncols, launches):
    """More value columns than one launch's shared memory holds: the
    columns split over launches, the rows counted in the first; no value
    column: the rows alone."""
    key, kvalid, kmin, values = _dense_inputs(nb, 100_003, True, torch.int32,
                                              ncols, cuda, nb)
    want = dk.dense_aggregate_plain(key, kvalid, kmin, 1, nb, 100_003, values)
    dk.launches = 0
    got = dk.dense_aggregate(key, kvalid, kmin, 1, nb, 100_003, values)
    torch.cuda.synchronize()
    assert dk.launches == launches
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _dense_law_inputs(nb, n, law, device, seed):
    """Keys by `law` ("one bucket": every row in bucket nb - 1, the worst
    contention; "zipf": bucket ranks by 1/rank over nb + 4 values around
    kmin, so some fall outside; "all null": a key bitmap of zeros, every
    row in the null bucket 0), values of every width (8 to 64 bits, signed
    and unsigned) with their extremes, every other column nullable."""
    g = torch.Generator(device=device).manual_seed(seed)
    cap = -(-n // 64) * 64
    kmin = 5
    if law == "one bucket":
        key = torch.full((cap,), kmin + nb - 1, dtype=torch.int32,
                         device=device)
    else:
        w = 1.0 / torch.arange(1, nb + 5, dtype=torch.float64, device=device)
        key = (kmin - 2 + torch.multinomial(w, cap, replacement=True,
                                            generator=g)).to(torch.int32)
    key_valid = (torch.zeros(cap // 8, dtype=torch.uint8, device=device)
                 if law == "all null" else None)
    values = []
    for c, dt in enumerate(DENSE_VALUE_DTYPES):
        lo, hi = ((0, 2**32 - 1) if dt == torch.uint32 else
                  (torch.iinfo(dt).min, torch.iinfo(dt).max))
        v = torch.randint(lo, hi, (cap,), dtype=torch.int64, generator=g,
                          device=device)
        v[:4] = torch.tensor([lo, hi, hi, lo])
        ok = (bm.pack(torch.rand(cap, generator=g, device=device) > 0.3)
              if c % 2 else None)
        values.append((v.to(dt), ok))
    return key, key_valid, torch.tensor([kmin], dtype=torch.int64,
                                        device=device), values


@pytest.mark.parametrize("n", [4097, 8_000_000])
@pytest.mark.parametrize("law", ["one bucket", "zipf", "all null"])
@pytest.mark.parametrize("nb", [1, 2, 128, 4096])
def test_dense_agg_key_laws(cuda, nb, law, n):
    """The worst contention, a skewed key and an all-null key at 1 to 4096
    buckets, values of every width: bit for bit against the plain version
    on poisoned outputs, twice in a row on one accumulator."""
    key, key_valid, kmin, values = _dense_law_inputs(nb, n, law, cuda,
                                                     nb + n)
    off = int(law == "all null")
    args = (key, key_valid, kmin, off, nb, n, values)
    want = dk.dense_aggregate_plain(*args)
    for _ in range(2):
        _same(lambda: list(dk.dense_aggregate(*args)), list(want))


def test_dense_agg_never_falls_back(cuda):
    key = torch.zeros(64, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        dk.dense_aggregate(key, None, torch.zeros(1, dtype=torch.int64,
                                                  device=cuda), 0, 4, 64, [])


def _columns_equal(got, want, tol=None):
    """Two port batches (card, CPU): names, length, dtypes, validity,
    values (floats by their bits, or within tol[name] where given; a
    dictionary by its keys), zero padding."""
    assert got.schema.names == want.schema.names
    assert got.length == want.length
    for name in want.schema.names:
        g, w = got[name], want[name]
        if isinstance(w, pcol.DictionaryColumn):
            g, w = g.keys, w.keys
        gv, gok, _ = column_to_numpy(g)
        wv, wok, _ = column_to_numpy(w)
        assert str(g.dtype) == str(w.dtype), name
        np.testing.assert_array_equal(gok, wok, name)
        if tol is not None and name in tol:
            assert (np.abs(gv - wv) <= tol[name]).all(), name
        elif gv.dtype.kind == "f":
            ui = np.uint64 if gv.itemsize == 8 else np.uint32
            np.testing.assert_array_equal(gv.view(ui), wv.view(ui), name)
        else:
            np.testing.assert_array_equal(gv, wv, name)
        assert not g.values[got.length:].any(), name


@pytest.mark.parametrize("span,nulls,engine", [
    (100, 0.1, "dense"), (200, 0.0, "dense"), (1_000_000, 0.1, "sort")])
def test_group_by_on_card_matches_cpu(cuda, span, nulls, engine):
    """plan_group_by and group_by on the card against the port on the
    CPU, both engines: an int32 key (nonzero under its nulls) with int64
    and int16 values, every aggregate."""
    rng = np.random.default_rng(span)
    n = 300_000
    k = rng.integers(-5, span - 5, n).astype(np.int32)
    k_ok = rng.random(n) > nulls if nulls else None
    arrays = {"k": (k, k_ok),
              "v": (rng.integers(-10**12, 10**12, n), rng.random(n) > 0.2),
              "w": (rng.integers(-2**15, 2**15, n).astype(np.int16), None)}
    aggs = [(c, a) for c in ("v", "w")
            for a in ("sum", "count", "min", "max", "mean")]
    on = {d: batch_from_numpy(arrays, device=d) for d in (cuda, "cpu")}
    plan = gb.plan_group_by(on[cuda], ["k"], aggs)
    assert plan.engine == engine
    dk.launches = k1.launches = 0
    got = plan(on[cuda])
    torch.cuda.synchronize()
    assert (dk.launches, k1.launches > 0) == (
        (1, False) if engine == "dense" else (0, True))
    want = gb.plan_group_by(on["cpu"], ["k"], aggs)(on["cpu"])
    _columns_equal(got, want)
    _columns_equal(group_by(on[cuda], ["k"], aggs), want)


def test_float_bool_dictionary_group_by_on_card_matches_cpu(cuda):
    """The sort pipeline's float, boolean and dictionary columns on the
    card against the CPU: a float key with +-0, +-inf and NaN, a
    dictionary key, float64 / float32 and boolean values."""
    rng = np.random.default_rng(5)
    n = 200_000
    fk = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.5])[
        rng.integers(0, 6, n)]
    fk_ok = rng.random(n) > 0.05
    v = rng.standard_normal(n) * 1e3
    valid = rng.random(n) > 0.1
    words = [f"w{i:02d}" for i in rng.permutation(20)]
    keys = rng.integers(0, 20, n, dtype=np.int32)
    float_aggs = [("v", "sum"), ("v", "mean"), ("v", "min"), ("s", "max"),
                  ("s", "sum"), ("b", "sum"), ("b", "max")]
    dict_aggs = [("b", "min"), ("v", "max"), ("v", "count")]
    out = {}
    for d in (cuda, "cpu"):
        b = batch_from_numpy({"f": (fk, fk_ok), "v": (v, valid),
                              "s": (v.astype(np.float32), None),
                              "b": (v > 0, ~valid)}, device=d)
        proto = pcol.dictionary_encode_host(
            words, st.Dictionary(st.int32, st.utf8), device=d)
        dcol = pcol.DictionaryColumn(
            pcol.primitive(keys, st.int32, validity=valid, device=d),
            proto.values, proto.value_ranks, proto.dtype)
        b = pbt.RecordBatch(
            st.Schema(b.schema.fields + (st.Field("d", dcol.dtype),)),
            b.columns + (dcol,))
        out[d] = (group_by(b, ["f"], float_aggs),
                  group_by(b, ["d"], dict_aggs))
    want = out["cpu"][0]
    bound = 2.0**-40 * np.abs(v).sum()
    count = column_to_numpy(group_by(
        batch_from_numpy({"f": (fk, fk_ok), "v": (v, valid)}, device="cpu"),
        ["f"], [("v", "count")])["count_v"])[0]
    _columns_equal(out[cuda][0], want, tol={
        "sum_v": bound, "mean_v": bound / np.maximum(count, 1),
        # float32 sums: the bound, then one float32 rounding of the result
        "sum_s": bound + np.abs(column_to_numpy(want["sum_s"])[0]) * 2.0**-23})
    _columns_equal(out[cuda][1], out["cpu"][1])


@pytest.mark.parametrize("cardinality,engine", [(100, "dense"),
                                                (1_000_000, "sort")])
def test_agg_step_on_card_against_oracle(cuda, cardinality, engine):
    """BASELINE config 4 at its full 8,000,000 rows, as bench.py runs it:
    the plan's engine and buckets, one dense_agg launch and no K1 at 100
    keys, K1 and no dense_agg at 1,000,000, exact against numpy."""
    arrays = example_agg_arrays(8_000_000, cardinality)
    batch = batch_from_numpy(arrays, device=cuda)
    plan = agg_plan(batch)
    assert (plan.engine, plan.buckets) == (
        (engine, 128) if engine == "dense" else (engine, 0))
    dk.launches = k1.launches = 0
    out = agg_step(plan, batch)
    torch.cuda.synchronize()
    assert (dk.launches == 1, k1.launches == 0) == (
        (True, True) if engine == "dense" else (False, False))
    assert check_agg(out, agg_oracle(arrays)) > 0


# ---------------------------------------------------------------------------
# K1's 16-byte word; the column classes through filter and take; TPC-H Q6


@pytest.mark.parametrize("n", [1, 4095, 65536, 1_000_003])
@pytest.mark.parametrize("density", DENSITIES + [0.055, 0.3])
@pytest.mark.parametrize("P", [1, 2, 4, 17])
def test_k1_16_byte_words_match_plain(cuda, P, density, n):
    """(P, n, 4) int32 planes, a 16-byte word a row, in both frames and
    with the output cut: on both sides of the dense threshold (half a
    tile's rows kept) and across the four chunks of a dense tile."""
    g = torch.Generator(device=cuda).manual_seed(n + P)
    planes = torch.randint(-2**31, 2**31 - 1, (P, n, 4), dtype=torch.int32,
                           device=cuda, generator=g)
    keep = _keep(n, density, cuda, n + 3)
    want = k1.compact_planes_plain(planes, keep)
    offs = k1.tile_offsets(keep)
    for o in (None, offs):
        k1.launches = 0
        assert torch.equal(k1.compact_planes(planes, keep, o), want)
        assert k1.launches == -(-P // 16)
        rows = min(n, int(keep.sum()) + 5)
        got = k1.compact_planes(list(planes), keep, o, rows)
        assert all(torch.equal(a, b[:rows]) for a, b in zip(got, want))


def test_k1_16_byte_words_must_be_aligned(cuda):
    words = torch.zeros(65, 4, dtype=torch.int32, device=cuda)
    keep = torch.ones(64, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        k1.compact_planes([words.view(-1)[1:257].view(64, 4)], keep)
    with pytest.raises(ValueError):  # 12-byte rows: no such word
        k1.compact_planes([torch.zeros(64, 3, dtype=torch.int32,
                                       device=cuda)], keep)


# K1's 16-byte word (tile_compact_kernel<uint4> with tile offsets,
# compact16_kernel in the look-back frame): the kept shares of the main
# path's calls, both frames, every out_rows, every plane count, tiles either
# side of the dense choice, more tiles than resident blocks

WIDE_DENSITIES = [0.0, "one", 0.005, 0.019, 0.055, 0.5, 0.96, 1.0]


def _wide_planes(P, n, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-2**31, 2**31 - 1, (P, n, 4), dtype=torch.int32,
                         device=device, generator=g)


@pytest.mark.parametrize("n", [1, 4095, 4097, 1_000_003])
@pytest.mark.parametrize("density", WIDE_DENSITIES)
def test_k1_16_frames_and_out_rows(cuda, density, n):
    """Both frames at every out_rows from the count to n, on outputs
    poisoned with 0x5A: every word below out_rows written exactly once."""
    planes = _wide_planes(3, n, cuda, n + 16)
    keep = _edge_keep(n, density, cuda, n + 17)
    count = int(keep.sum())
    offs = k1.tile_offsets(keep)
    for rows in _out_rows(n, count):
        want = k1.compact_planes_plain(planes, keep, rows)
        for o in (offs, None):
            k1.launches = 0
            _same(lambda: k1.compact_planes(planes, keep, o, rows), want)
            assert k1.launches == 1


@pytest.mark.parametrize("P", list(range(1, 17)))
def test_k1_16_every_plane_count(cuda, P):
    n = 65_539
    planes = _wide_planes(P, n, cuda, P)
    keep = _keep(n, 0.019, cuda, P)
    want = k1.compact_planes_plain(list(planes), keep)
    offs = k1.tile_offsets(keep)
    for o in (offs, None):
        _same(lambda: k1.compact_planes(list(planes), keep, o), want)


def test_k1_16_either_side_of_the_dense_choice(cuda):
    """Tiles of 2047, 2048 and 2049 kept rows in turn (both kernels take
    bulk copies from half a tile kept) and sparse and empty tiles, in one
    launch."""
    n = 40 * 4096 + 123
    g = torch.Generator(device=cuda).manual_seed(40)
    keep = torch.zeros(n, dtype=torch.bool, device=cuda)
    kept = [2047, 2048, 2049, 0, 78, 4096]
    for t in range(-(-n // 4096)):
        rows = min(4096, n - t * 4096)
        k = min(kept[t % len(kept)], rows)
        pick = torch.randperm(rows, device=cuda, generator=g)[:k]
        keep[t * 4096 + pick] = True
    planes = _wide_planes(5, n, cuda, 41)
    want = k1.compact_planes_plain(planes, keep)
    offs = k1.tile_offsets(keep)
    for o in (offs, None):
        _same(lambda: k1.compact_planes(planes, keep, o), want)


def test_k1_16_look_back_twice_on_one_scratch(cuda):
    """Two look-back launches in a row on one scratch (the C entry zeroes
    it before each), the count written by the last tile."""
    n = 1_000_003
    planes = list(_wide_planes(2, n, cuda, 50))
    scratch = None
    for i, density in enumerate((0.019, 0.5)):
        keep = _keep(n, density, cuda, 51 + i)
        if scratch is None:
            scratch = _build.lookback_scratch(keep)
        want = k1.compact_planes_plain(planes, keep)
        outs = [torch.full_like(p, 0x5A5A5A5A) for p in planes]
        count = torch.full((), -1, dtype=torch.int64, device=cuda)
        _build.tiles_cuda(planes, outs, keep, None, scratch, count)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(outs, want))
        assert int(count) == int(keep.sum())


@pytest.mark.parametrize("density", [0.019, 0.5])
@pytest.mark.parametrize("frame", ["offs", "look-back"])
def test_k1_16_more_tiles_than_resident_blocks(cuda, frame, density):
    """40M rows are 9,766 tiles, many times the blocks the card holds at
    once (132 SMs x a few): blocks start as earlier ones finish, and in
    the look-back frame a tile waits on tiles whose blocks started before
    it, some still running."""
    n = 40_000_003
    planes = _wide_planes(1, n, cuda, 60)
    keep = _keep(n, density, cuda, 61)
    rows = -(-int(keep.sum()) // 64) * 64
    want = k1.compact_planes_plain(planes, keep, rows)
    offs = k1.tile_offsets(keep) if frame == "offs" else None
    for _ in range(2):
        _same(lambda: k1.compact_planes(planes, keep, offs, rows), want)


def _bits(t):
    """A float tensor as its bits (NaN payloads and signed zeros compare)."""
    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()])
    return t


def _same_column(g, w, nan_payloads=True):
    """A column on the card equals the CPU's: class, length, capacity and
    every tensor (recursively; an arena only as bytes; floats by bits).
    `nan_payloads=False` takes any NaN as any other: the card gives every
    NaN result of float arithmetic one canonical payload, the host keeps
    an input NaN's."""
    assert type(g) is type(w) and g.length == w.length
    assert g.capacity == w.capacity and g.dtype == w.dtype
    for name in ("values", "views", "arena", "validity", "starts", "sizes",
                 "keys", "child", "children"):
        x, y = getattr(g, name, None), getattr(w, name, None)
        if isinstance(x, torch.Tensor):
            x = x.cpu() if x.device.type == "cuda" else None
            assert x is not None, f"{name} is not on the card"
            if not nan_payloads and x.is_floating_point():
                nan = x.isnan()
                assert torch.equal(nan, y.isnan()), name
                x, y = x.masked_fill(nan, 0), y.masked_fill(nan, 0)
            assert torch.equal(_bits(x), _bits(y)), name
        elif isinstance(x, tuple):
            for a, b in zip(x, y):
                _same_column(a, b, nan_payloads)
        elif x is not None and not isinstance(x, (int, st.DataType)):
            _same_column(x, y, nan_payloads)
        else:
            assert (x is None) == (y is None), name


def _classes_batch(device, n=70_000):
    rng = np.random.default_rng(13)
    words = ["", "abc", "twelve bytes", "a string past the inline bytes"]
    strs = [None if rng.random() < 0.1 else words[rng.integers(4)]
            for _ in range(n)]
    dec = [None if rng.random() < 0.1 else int(x)
           for x in rng.integers(-10**15, 10**15, n)]
    return pbt.record_batch({
        "s": pcol.string_view(strs, device=device),
        "d128": pcol.from_pylist(dec, st.Decimal128(18, 2), device=device),
        "d64": pcol.from_pylist(dec, st.Decimal64(18, 2), device=device),
        "d256": pcol.from_pylist(dec, st.Decimal256(40, 2), device=device),
        "day": pcol.primitive(rng.integers(0, 20000, n), st.Date32(),
                              device=device),
        "iv": pcol.primitive(rng.integers(0, 2**32, (n, 4)).astype(np.uint32),
                             st.Interval(), device=device),
        "fsb": pcol.primitive(rng.integers(0, 2**32, (n, 3)).astype(np.uint32),
                              st.FixedSizeBinary(11), device=device)})


def test_classes_filter_and_take_on_card_match_cpu(cuda):
    """String views, decimals (32-, 64- and 16-byte rows: Decimal256 as two
    16-byte words under the repeated mask), dates, intervals and a 12-byte
    fixed-size binary (three 4-byte planes): one plan on the card, K1 at
    4, 8 and 16 bytes, equal to the CPU."""
    batches = {d: _classes_batch(d) for d in (cuda, "cpu")}
    masks = {}
    for d, b in batches.items():
        rng = np.random.default_rng(14)
        keep = rng.random(b.length) < 0.3
        masks[d] = pcol.boolean(keep, validity=rng.random(b.length) > 0.1,
                                device=d)
    k1.launches = k2.launches = 0
    got = filter_record_batch(batches[cuda], masks[cuda])
    torch.cuda.synchronize()
    assert k1.launches >= 3 and k2.launches == 1
    want = filter_record_batch(batches["cpu"], masks["cpu"])
    for a, b in zip(got.columns, want.columns):
        _same_column(a, b)
    rng = np.random.default_rng(15)
    idx = rng.integers(-5, 70_005, 50_000)
    ok = rng.random(50_000) > 0.01
    outs = [take_record_batch(b, pcol.primitive(idx, validity=ok, device=d),
                              TakeOptions(True))
            for d, b in batches.items()]
    assert outs[0][1] is outs[1][1] is True
    for a, b in zip(outs[0][0].columns, outs[1][0].columns):
        _same_column(a, b)


def test_nested_filter_and_take_on_card_match_cpu(cuda):
    """List view, struct (with a string child) and fixed-size list with
    nulls: K1 and K2 launch, the card equals the CPU."""
    rng = np.random.default_rng(16)
    n = 30_000
    lists = [None if rng.random() < 0.1 else
             [int(x) for x in rng.integers(0, 9, rng.integers(0, 5))]
             for _ in range(n)]
    structs = [None if rng.random() < 0.1 else
               {"i": int(rng.integers(9)), "s": "s" * int(rng.integers(20))}
               for _ in range(n)]
    fsl = [None if rng.random() < 0.1 else [float(rng.random())] * 4
           for _ in range(n)]
    keep = rng.random(n) < 0.5
    kvalid = rng.random(n) > 0.1
    idx = rng.integers(-2, n + 2, 20_000)
    outs = []
    for d in (cuda, "cpu"):
        b = pbt.record_batch({
            "lv": pcol.from_pylist(lists, st.List(st.int64), device=d),
            "st": pcol.from_pylist(structs, st.Struct((
                st.Field("i", st.int32), st.Field("s", st.utf8))), device=d),
            "fl": pcol.from_pylist(fsl, st.FixedSizeList(st.float32, 4),
                                   device=d)})
        k1.launches = k2.launches = 0
        f = filter_record_batch(b, pcol.boolean(keep, validity=kvalid,
                                                device=d))
        launched = (k1.launches, k2.launches)
        outs.append((f, take_record_batch(b, pcol.primitive(idx, device=d)),
                     launched))
    assert outs[0][2][0] >= 1 and outs[0][2][1] >= 1
    for part in (0, 1):
        for a, b in zip(outs[0][part].columns, outs[1][part].columns):
            _same_column(a, b)
            assert a.to_pylist() == b.to_pylist()


def test_q6_step_on_card_against_oracle(cuda):
    """TPC-H Q6 over about 200,000 lineitem rows on the card: exact against
    q6_oracle (every column's kept rows and the revenue), with K1 launched
    at 16-, 8- and 4-byte words inside the filter."""
    arrays = example_lineitem_arrays(sf=0.033, seed=6)
    assert 190_000 < len(arrays["l_orderkey"]) < 210_000
    batch = lineitem_batch(arrays, device=cuda)
    with _build.launch_words() as words:
        out = q6_step(batch)
    assert sorted(words) == [("K1", 4), ("K1", 8), ("K1", 16)]
    assert check_q6(out, arrays, q6_oracle(arrays)) > 3000


def test_q1_step_on_card_against_oracle(cuda):
    """TPC-H Q1 over about 200,000 lineitem rows on the card: exact against
    q1_oracle (4 groups, the sums as integers, the means bit for bit, the
    counts), with K1 launched at 16-byte words in the filter and at 16 and
    8 bytes in the group-by's extraction."""
    arrays = example_lineitem_arrays(sf=0.033, seed=6)
    batch = lineitem_batch(arrays, device=cuda)
    with _build.launch_words() as words:
        out = q1_step(batch)
    assert sorted(set(words)) == [("K1", 8), ("K1", 16)]
    assert words.count(("K1", 16)) == 2  # the filter, the group keys
    assert check_q1(out, arrays, q1_oracle(arrays)) > 190_000


def test_string_lexsort_on_card_matches_cpu(cuda):
    """lexsort of a string key with inline, arena, empty and trailing-zero
    strings and nulls (48 bytes: the grouped sort), a decimal and an int
    key, on the card and on the CPU."""
    from arrowtpu_torch.ops import sortmod as srt
    from arrowtpu_torch.config import SortOptions

    rng = np.random.default_rng(11)
    words = ["", "a", "a\0", "ab", "twelve bytes", "thirteen byte"]
    data = [None if rng.random() < 0.1 else
            words[int(rng.integers(0, len(words)))] if rng.random() < 0.7
            else "x" * 16 + "".join(rng.choice(list("ab\0"),
                                               int(rng.integers(4, 30))))
            for _ in range(70_000)]
    ints = rng.integers(0, 3, len(data))
    cents = rng.integers(-500, 500, len(data))
    opts = [SortOptions(True, False), SortOptions(), SortOptions(False, False)]
    outs = []
    for d in ("cpu", cuda):
        cols = [pcol.string_view(data, device=d),
                pcol.primitive(ints, st.int32, device=d),
                pcol.primitive([int(c) for c in cents], st.Decimal128(20, 2),
                               device=d)]
        outs.append(srt.lexsort_to_indices(cols, opts).values.cpu())
    assert torch.equal(outs[0], outs[1])


def test_decimal_means_and_gathers_on_card_match_cpu(cuda):
    """A decimal mean divides by 10**scale as a tensor (a division by a
    host scalar multiplies by its reciprocal on the card); 16- and 8-byte
    rows gather as one element; both bit for bit as on the CPU."""
    from arrowtpu_torch.ops import decimal as dec
    from arrowtpu_torch.ops.take import gather_rows

    rng = np.random.default_rng(12)
    keys = rng.integers(0, 7, 50_000)
    vals = [int(v) for v in rng.integers(-10**12, 10**12, len(keys))]
    outs = []
    for d in ("cpu", cuda):
        b = pbt.record_batch({
            "k": pcol.primitive(keys, st.int64, device=d),
            "v": pcol.primitive(vals, st.Decimal128(30, 3), device=d)})
        g = group_by(b, ["k"], [("v", "mean"), ("v", "sum")])
        outs.append((g["mean_v"].values.cpu(), g["sum_v"].values.cpu(),
                     dec.to_float(b["v"]).values.cpu()))
    for a, b in zip(*outs):
        assert torch.equal(a.view(torch.int64) if a.is_floating_point()
                           else a, b.view(torch.int64)
                           if b.is_floating_point() else b)
    rows = torch.randint(-2**31, 2**31 - 1, (10_000, 4), dtype=torch.int32,
                         device=cuda)
    idx = torch.randint(0, 10_000, (30_000,), device=cuda)
    for w in (4, 2, 3):
        r = rows[:, :w].contiguous()
        assert torch.equal(gather_rows(r, idx), r[idx])


# ---------------------------------------------------------------------------
# the distributed layer over every key and column class
# ---------------------------------------------------------------------------

KEY_WORDS = ["pear", "apple", "a word longer than twelve bytes", "", "fig",
             "twelve bytes", "thirteen byte"]


def _key_values(kind, n, rng):
    """n Python values (None for a null) of a key class, drawn from one
    pool of 40 values of the class, and its type."""
    draw = rng.integers(0, 40, n)
    ok = rng.random(n) > 0.1
    pool_rng = np.random.default_rng(40)
    if kind in ("float64", "float32"):
        pool = np.concatenate([[0.0, -0.0, np.nan, np.inf, -np.inf],
                               pool_rng.normal(size=35)])
        return [float(pool[i]) if o else None for i, o in zip(draw, ok)], \
            getattr(st, kind)
    types = {"date32": st.Date32(), "date64": st.Date64(),
             "time32": st.Time32("ms"), "time64": st.Time64("ns"),
             "timestamp": st.Timestamp("us", "UTC"),
             "duration": st.Duration("ms"),
             "decimal32": st.Decimal32(9, 2),
             "decimal64": st.Decimal64(18, 2),
             "decimal128": st.Decimal128(15, 2),
             "decimal256": st.Decimal256(76, 2),
             "fsb9": st.FixedSizeBinary(9), "utf8": st.utf8,
             "dictionary": st.Dictionary(st.int32, st.utf8)}
    if kind in ("utf8", "dictionary"):
        pool = [KEY_WORDS[i % 7] + "-" * (i % 3) * 7 + str(i)
                for i in range(40)]
    elif kind == "fsb9":
        pool = [bytes([i]) * 9 for i in range(40)]
    else:
        pool = [int(x) for x in pool_rng.integers(-10**6, 10**6, 40)]
    return [pool[i] if o else None for i, o in zip(draw, ok)], types[kind]


def _key_column(kind, values, dtype, device):
    if kind == "dictionary":
        return pcol.dictionary_encode_host(values, dtype, device=device)
    return pcol.from_pylist(values, dtype, device=device)


HASH_CLASSES = ["float64", "float32", "date32", "date64", "time32", "time64",
                "timestamp", "duration", "decimal32", "decimal64",
                "decimal128", "decimal256", "fsb9", "dictionary", "utf8"]


@pytest.mark.parametrize("kind", HASH_CLASSES)
def test_key_hash_of_every_class_on_card_matches_cpu(cuda, kind):
    """hash_planes_of + hash_planes (partition and skew seeds) of a
    nullable key of every class, alone and beside an int64 key, and of a
    null column, on the card and on the CPU."""
    from arrowtpu_torch.rowformat import encode as rf
    from arrowtpu_torch.rowformat import hashing as hsh

    rng = np.random.default_rng(HASH_CLASSES.index(kind))
    values, dtype = _key_values(kind, 5000, rng)
    ints = rng.integers(-2**62, 2**62, 5000)
    got = []
    for d in (cuda, "cpu"):
        cols = [_key_column(kind, values, dtype, d),
                pcol.primitive(ints, st.int64, device=d)]
        got.append([hsh.hash_planes(rf.hash_planes_of(c), seed=s).cpu()
                    for c in (cols[:1], cols, [pcol.null_column(5000, d)])
                    for s in (0x5157, 0x517E)])
    for a, b in zip(*got):
        assert torch.equal(a, b)


def _typed_join_batches(kind, device, seed=21):
    """Probe and build batches keyed by a class, an N:M join with null
    keys, payloads of int64, utf8 and Decimal128."""
    rng = np.random.default_rng(seed)
    lv, dtype = _key_values(kind, 20_000, rng)
    rv, _ = _key_values(kind, 400, rng)
    left = pbt.record_batch({
        "k": _key_column(kind, lv, dtype, device),
        "v": pcol.primitive(rng.integers(-9, 9, 20_000), device=device)})
    right = pbt.record_batch({
        "k": _key_column(kind, rv, dtype, device),
        "t": pcol.from_pylist([KEY_WORDS[i % 7] * (i % 4) for i in
                               range(400)], st.utf8, device=device),
        "d": pcol.from_pylist([int(x) for x in rng.integers(-10**9, 10**9,
                                                            400)],
                              st.Decimal128(15, 2), device=device)})
    if kind == "dictionary":  # both sides over one dictionary
        right = pbt.record_batch({**{n: right[n] for n in ("t", "d")},
                                  "k": pcol.DictionaryColumn(
                                      right["k"].keys, left["k"].values,
                                      left["k"].value_ranks, dtype)})
    return left, right


@pytest.mark.parametrize("kind", ["float64", "decimal128", "date64", "fsb9",
                                  "dictionary", "utf8"])
def test_hash_join_on_every_key_class_on_card_matches_cpu(cuda, kind):
    outs = []
    for d in (cuda, "cpu"):
        left, right = _typed_join_batches(kind, d)
        if kind == "dictionary":  # equal values, built apart: ranks agree
            assert right["k"].values is left["k"].values
        outs.append(hash_join(left, right, ["k"])[0])
    assert outs[1].length > 20_000
    for a, b in zip(outs[0].columns, outs[1].columns):
        _same_column(a, b)


def test_string_widths_and_dictionaries_on_card(cuda):
    """Text keys of two widths join as the host oracle does; dictionary
    keys of two dictionaries raise (the JAX package's two faults)."""
    left = pbt.record_batch({"k": pcol.from_pylist(
        ["ab", "cd", "ef"], st.utf8, device=cuda)})
    right = pbt.record_batch({"k": pcol.from_pylist(
        ["ab", "cd", "x" * 40], st.utf8, device=cuda), "r": pcol.primitive(
            [0, 1, 2], device=cuda)})
    out, _ = hash_join(left, right, ["k"])
    assert out["k"].to_pylist() == ["ab", "cd"]
    assert out["r"].to_pylist() == [0, 1]

    def side(words):
        return pbt.record_batch({"k": pcol.dictionary_encode_host(
            words, device=cuda)})

    with pytest.raises(st.ComputeError):
        hash_join(side(["a", "b", "a"]), side(["b", "c"]), ["k"])


def _mixed_batch(device, n=40_000):
    rng = np.random.default_rng(22)
    k = rng.integers(0, 5000, n)
    strs = [None if rng.random() < 0.1 else KEY_WORDS[i % 7] * (i % 4)
            for i in rng.integers(0, 100, n)]
    floats = np.concatenate([[0.0, -0.0, np.nan], rng.normal(size=97)])
    return pbt.record_batch({
        "k": pcol.primitive(k, validity=rng.random(n) > 0.05, device=device),
        "d": pcol.from_pylist([None if rng.random() < 0.1 else int(x) for x
                               in rng.integers(-10**12, 10**12, n)],
                              st.Decimal128(15, 2), device=device),
        "s": pcol.from_pylist(strs, st.utf8, device=device),
        "f": pcol.primitive(floats[rng.integers(0, 100, n)], st.float64,
                            device=device)})


def test_exchange_and_group_by_of_every_class_on_card_match_cpu(cuda):
    """At world size 1 over NCCL: the exchange of int64, Decimal128, utf8
    (inline and arena) and float64 columns keeps every row in order, and
    the two-phase group-by on the utf8 key with a decimal sum and count,
    and a decimal mean raises; all equal to the CPU's."""
    outs = []
    for d in (cuda, "cpu"):
        b = _mixed_batch(d)
        with mesh.process_group(0, 1, d) as group:
            ex = pshuffle.exchange(b, ["k"], group)
            agg = pdist.distributed_group_by(
                b, ["s"], [("d", "sum"), ("d", "count")], group=group)
            with pytest.raises(st.ComputeError):
                pdist.distributed_group_by(b, ["s"], [("d", "mean")],
                                           group=group)
        for name in ("k", "d", "s"):
            assert ex[name].to_pylist() == b[name].to_pylist(), name
        (fv, fok, _), (bv, bok, _) = (column_to_numpy(c["f"])
                                      for c in (ex, b))
        assert np.array_equal(fv.view(np.int64), bv.view(np.int64))
        assert np.array_equal(fok, bok) and fok.all()
        outs.append((ex, agg))
    for part in (0, 1):
        for a, b in zip(outs[0][part].columns, outs[1][part].columns):
            _same_column(a, b)


@pytest.mark.parametrize("kind", ["utf8", "float64"])
@pytest.mark.parametrize("kw", [{}, {"probe_chunks": 2},
                                {"skew_threshold": 0.02, "probe_chunks": 2}])
def test_distributed_join_on_every_key_class_on_card_matches_cpu(cuda, kind,
                                                                 kw):
    """distributed_hash_join at world size 1 over NCCL on a utf8 and a
    float64 key, unchunked, in two chunks and through the skew path (its
    hot build rows' utf8 and decimal payloads replicated): the output and
    flags equal the CPU's."""
    outs = []
    for d in (cuda, "cpu"):
        left, right = _typed_join_batches(kind, d, seed=23)
        with mesh.process_group(0, 1, d) as group:
            out, info = pdist.distributed_hash_join(left, right, ["k"],
                                                    group=group, **kw)
        outs.append((out, bool(info.duplicates), info.overflow))
    assert outs[0][1:] == outs[1][1:] and outs[1][0].length > 20_000
    for a, b in zip(outs[0][0].columns, outs[1][0].columns):
        _same_column(a, b)


# ---------------------------------------------------------------------------
# the predicate layer: numeric, bitwise, boolean, zip and strings on the
# card against the port's own CPU results on the same numpy inputs
# ---------------------------------------------------------------------------

from arrowtpu_torch import entry as pentry  # noqa: E402
from arrowtpu_torch import ops as pops  # noqa: E402
from arrowtpu_torch.interop.numpy_bridge import column_from_numpy  # noqa: E402

ELEMENTWISE_N = 5000
ELEMENTWISE_DTYPES = ["int8", "int16", "int32", "int64", "uint8", "uint16",
                      "uint32", "float32", "float64"]


def _elementwise_values(name, seed):
    """ELEMENTWISE_N values: the type's corners paired with each other
    (INT_MIN, -1, 0, the maximum; NaN, -0.0, infinities, a subnormal),
    then random ones over the whole range."""
    rng = np.random.default_rng(seed)
    dt = np.dtype(name)
    if dt.kind == "f":
        fi = np.finfo(dt)
        corners = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5, -2.5,
                            fi.max, -fi.max, fi.tiny, fi.tiny / 4, 7.0,
                            -7.0, 3e-3], dt)
        rest = (rng.standard_normal(ELEMENTWISE_N) * 1e3).astype(dt)
    else:
        info = np.iinfo(dt)
        corners = np.array(sorted({info.min, info.min + 1, -1 if info.min
                                   else 2, 0, 1, info.max, 7}), dt)
        rest = rng.integers(info.min, info.max, ELEMENTWISE_N, endpoint=True,
                            dtype=np.uint64 if name == "uint32"
                            else np.int64).astype(dt)
    k = len(corners)
    grid = np.repeat(corners, k) if seed % 2 else np.tile(corners, k)
    rest[:k * k] = grid
    return rest


def _both(values, valid, name, device):
    """The same column on the card and on the CPU."""
    dt = st.bool_ if name == "bool" else getattr(st, name)
    return tuple(column_from_numpy(values, valid, len(values), dt, device=d)
                 for d in (device, "cpu"))


def _valid_bools(seed, density=0.1):
    return np.random.default_rng(seed + 50).random(ELEMENTWISE_N) > density


@pytest.mark.parametrize("name", ELEMENTWISE_DTYPES)
def test_numeric_ops_on_card_match_cpu(cuda, name):
    """add, sub, mul, div, rem column with column and with scalars on both
    sides, neg, the checked ops' columns and flags, zero and -1 divisors,
    a float64 divided by a Python scalar (a one-element tensor on the
    card, so no reciprocal multiply) and the float rem: bit for bit."""
    float_ = np.dtype(name).kind == "f"
    (ga, ca) = _both(_elementwise_values(name, 1), _valid_bools(1), name,
                     cuda)
    (gb, cb) = _both(_elementwise_values(name, 2), None, name, cuda)
    scalars = (2.5, 1e-3, 3.0) if float_ else (7, 0, -1, 300)

    def same(g, c):  # NaN results differ in payload
        _same_column(g, c, nan_payloads=False)
    for op in ("add", "sub", "mul", "div", "rem"):
        f = getattr(pops, op)
        same(f(ga, gb), f(ca, cb))
        for s in scalars:
            same(f(ga, s), f(ca, s))
            same(f(s, gb), f(s, cb))
        if not float_:
            same(f(ga, 1.5), f(ca, 1.5))  # a float64 result
        g, gflag = getattr(pops, f"{op}_checked")(ga, gb)
        c, cflag = getattr(pops, f"{op}_checked")(ca, cb)
        same(g, c)
        assert gflag.device.type == "cuda" and bool(gflag) == bool(cflag)
    same(pops.neg(ga), pops.neg(ca))
    if name == "float64":  # the division by a host scalar, one per value
        for s in (3.0, 10.0, 7.0, 0.1):
            same(pops.div(ga, s), pops.div(ca, s))


def test_int_min_and_minus_one_on_card(cuda):
    """INT_MIN / -1 and INT_MIN * -1 (computed as wrapping negations,
    flagged by the checked ops) and zero divisors at each width."""
    for name in ("int8", "int16", "int32", "int64"):
        mn = np.iinfo(np.dtype(name)).min
        x = np.array([mn, mn, 5, -5, mn, 9], name)
        y = np.array([-1, 0, 0, -1, 1, -1], name)
        (ga, ca), (gb, cb) = (_both(v, None, name, cuda) for v in (x, y))
        for op in ("div", "rem", "mul"):
            _same_column(getattr(pops, op)(ga, gb), getattr(pops, op)(ca, cb))
        assert bool(pops.div_checked(ga, gb)[1])
        assert bool(pops.mul_checked(ga, -1)[1])
        assert pops.div(ga, gb).to_pylist()[0] == mn


@pytest.mark.parametrize("name", ELEMENTWISE_DTYPES[:7])
def test_bitwise_ops_on_card_match_cpu(cuda, name):
    """and / or / xor / not, and shifts by amounts in range, at and past
    the width, and negative (column and scalar): the explicit amount rule
    gives the CPU's result on the card."""
    (ga, ca) = _both(_elementwise_values(name, 3), _valid_bools(3), name,
                     cuda)
    (gb, cb) = _both(_elementwise_values(name, 4), None, name, cuda)
    bits = np.dtype(name).itemsize * 8
    lo = -70 if np.dtype(name).kind == "i" else 0
    hi = min(bits + 70, np.iinfo(np.dtype(name)).max)
    amounts = np.random.default_rng(5).integers(lo, hi, ELEMENTWISE_N)
    (gk, ck) = _both(amounts.astype(name), _valid_bools(5), name, cuda)
    for op in ("bit_and", "bit_or", "bit_xor"):
        f = getattr(pops, op)
        _same_column(f(ga, gb), f(ca, cb))
        _same_column(f(ga, 0x5A), f(ca, 0x5A))
    _same_column(pops.bit_not(ga), pops.bit_not(ca))
    for op in ("shift_left", "shift_right"):
        f = getattr(pops, op)
        _same_column(f(ga, gk), f(ca, ck))
        for k in (0, 3, bits - 1, bits, 70, -1, -65):
            _same_column(f(ga, k), f(ca, k))


def test_boolean_zip_nullif_shift_on_card_match_cpu(cuda):
    rng = np.random.default_rng(6)
    (ga, ca), (gb, cb) = (
        _both(rng.random(ELEMENTWISE_N) < 0.5, _valid_bools(s, 0.2), "bool",
              cuda) for s in (7, 8))
    for op in ("and_", "or_", "xor", "and_not", "and_kleene", "or_kleene"):
        _same_column(getattr(pops, op)(ga, gb), getattr(pops, op)(ca, cb))
    for op in ("not_", "is_null", "is_not_null"):
        _same_column(getattr(pops, op)(ga), getattr(pops, op)(ca))
    for name in ("int32", "int64", "uint32", "float64"):
        (gx, cx) = _both(_elementwise_values(name, 9), _valid_bools(9),
                         name, cuda)
        (gy, cy) = _both(_elementwise_values(name, 10), None, name, cuda)
        _same_column(pops.zip_(ga, gx, gy), pops.zip_(ca, cx, cy))
        _same_column(pops.zip_(ga, gx, 0), pops.zip_(ca, cx, 0))
        _same_column(pops.nullif(gx, ga), pops.nullif(cx, ca))
        for offset in (3, -17):
            _same_column(pops.shift(gx, offset), pops.shift(cx, offset))
    dec = [None if rng.random() < 0.1 else int(v)
           for v in rng.integers(-10**12, 10**12, ELEMENTWISE_N)]
    gd, cd = (pcol.from_pylist(dec, st.Decimal128(15, 2), device=d)
              for d in (cuda, "cpu"))
    ge, ce = (pcol.from_pylist(dec[::-1], st.Decimal128(15, 2), device=d)
              for d in (cuda, "cpu"))
    import decimal
    for falsy in ((ge, ce), (0, 0), (decimal.Decimal("9.99"),) * 2):
        _same_column(pops.zip_(ga, gd, falsy[0]), pops.zip_(ca, cd, falsy[1]))
    _same_column(pops.sub(1, gd), pops.sub(1, cd))
    _same_column(pops.neg(gd), pops.neg(cd))


LIKE_WORDS = ["PROMO BRUSHED TIN", "STANDARD ANODIZED BRASS", "promo plated",
              "forest green lace", "Brand#12", "", "a%b", "été",
              "MEDIUM POLISHED STEEL", "dark green", "ÉTÉ forest", "SM CASE",
              "a string well past the sixteen-byte granule, with green"]


@pytest.mark.parametrize("dictionary", [False, True])
def test_like_family_on_card_matches_cpu(cuda, dictionary):
    """Every LIKE kind (eq, starts, ends, contains on the card; the regex
    kind on the host, its result back on the card), ilike and the
    negations, starts_with / ends_with / contains and regexp_is_match, on
    views and on a dictionary."""
    rng = np.random.default_rng(11)
    data = [None if rng.random() < 0.1 else LIKE_WORDS[i]
            for i in rng.integers(0, len(LIKE_WORDS), ELEMENTWISE_N)]
    make = (pcol.dictionary_encode_host if dictionary else
            pcol.string_view)
    g = make(data, device=cuda)
    c = make(data, device="cpu")
    for p in ("PROMO%", "%BRASS", "%green%", "Brand#12", "P_OMO%", "%a%b%",
              "", "%", "é%", "MEDIUM POLISHED%"):
        for op in ("like", "nlike", "ilike", "nilike"):
            _same_column(getattr(pops, op)(g, p), getattr(pops, op)(c, p))
    for op, arg in (("starts_with", "PROMO"), ("ends_with", "BRASS"),
                    ("contains", "green")):
        _same_column(getattr(pops, op)(g, arg), getattr(pops, op)(c, arg))
    for pattern, flags in (("green", ""), ("promo", "i")):
        _same_column(pops.regexp_is_match(g, pattern, flags),
                     pops.regexp_is_match(c, pattern, flags))


def test_substring_concat_case_on_card_match_cpu(cuda):
    rng = np.random.default_rng(12)
    data = [None if rng.random() < 0.1 else LIKE_WORDS[i]
            for i in rng.integers(0, len(LIKE_WORDS), ELEMENTWISE_N)]
    ascii_data = [s if s is None or s.isascii() else "plain" for s in data]
    g, c = (pcol.string_view(ascii_data, device=d) for d in (cuda, "cpu"))
    g2, c2 = (pcol.string_view(data[::-1], device=d) for d in (cuda, "cpu"))
    for start, length in ((0, None), (2, 5), (-4, None), (30, 3)):
        _same_column(pops.substring(g, start, length),
                     pops.substring(c, start, length))
    _same_column(pops.concat_elements(g, g2), pops.concat_elements(c, c2))
    for op in ("lower", "upper"):
        _same_column(getattr(pops, op)(g), getattr(pops, op)(c))
        # a non-ASCII byte: mapped on the host, back on the card
        got = getattr(pops, op)(g2)
        assert got.views.device.type == "cuda"
        assert got.to_pylist() == getattr(pops, op)(c2).to_pylist()


def test_q14_q19_on_card_against_oracle(cuda):
    """TPC-H Q14 and Q19 over about 200,000 lineitem rows and 6,600 parts
    on the card, exact against their oracles; K1 launches in each step."""
    la = example_lineitem_arrays(sf=0.033, seed=6)
    pa = pentry.example_part_arrays(sf=0.033)
    lb, pb = lineitem_batch(la, device=cuda), pentry.part_batch(pa, cuda)
    for name, fn, oracle in (("Q14", pentry.q14_step, pentry.q14_oracle),
                             ("Q19", pentry.q19_step, pentry.q19_oracle)):
        with _build.launch_words() as words:
            got = fn(lb, pb)
        assert ("K1", 16) in words and ("K1", 8) in words, (name, words)
        pentry.check_query(got, oracle(la, pa), name)


# ---------------------------------------------------------------------------
# the rest of sort and group-by: interleave, merge, RowConverter, slice /
# coalesce, equal, struct / list-view keys, temporal group-by, Q3
# ---------------------------------------------------------------------------

from arrowtpu_torch.config import SortOptions  # noqa: E402
from arrowtpu_torch.rowformat.decode import RowConverter  # noqa: E402

OPTION_PAIRS = [(False, True), (False, False), (True, True), (True, False)]


def _runs(batch, lengths):
    out, start = [], 0
    for n in lengths:
        out.append(pops.slice_batch(batch, start, n))
        start += n
    return out


def test_interleave_and_merge_on_card_match_cpu(cuda):
    """Three sorted runs of uneven lengths of every class interleave takes
    (string views, decimals of 8, 16 and 32 bytes, dates, intervals, a
    fixed-size binary): merge_indices, merge_batches and interleave on the
    card equal the CPU, the merge equals one sort of the whole, by
    equal_batches on the card, and interleave by the merge index equals the
    merged column."""
    by = ["day", "d128"]
    opts = [SortOptions(), SortOptions(True, False)]
    outs = []
    for d in (cuda, "cpu"):
        runs = [pops.sort_batch(r, by, opts)
                for r in _runs(_classes_batch(d), (30_000, 7, 39_993))]
        src, row = pops.merge_indices([[r[n] for n in by] for r in runs],
                                      opts)
        merged = pops.merge_batches(runs, by, opts)
        whole = pops.sort_batch(pops.concat_batches(runs), by, opts)
        same = pops.equal_batches(merged, whole)
        assert same.device.type == torch.device(d).type and bool(same)
        woven = pops.interleave([r["d128"] for r in runs], src, row)
        assert bool(pops.equal_columns(woven, merged["d128"]))
        outs.append((src, row, merged, woven))
    _same_column(outs[0][0], outs[1][0])
    _same_column(outs[0][1], outs[1][1])
    for a, b in zip(outs[0][2].columns, outs[1][2].columns):
        _same_column(a, b)
    _same_column(outs[0][3], outs[1][3])


def _row_columns(device, n=50_000):
    rng = np.random.default_rng(17)
    f64 = rng.standard_normal(n)
    special = np.array([0, 0x8000000000000000, 0x7FF0000000000000,
                        0xFFF0000000000000, 0x7FF8000000000000,
                        0xFFF8000000000000, 0x7FF0000000000001,
                        0xFFF0000000000123], np.uint64).view(np.float64)
    f64[::997][:len(special)] = special
    f32 = rng.standard_normal(n).astype(np.float32)
    f32[::991][:4] = np.array([0x7FC00001, 0xFFC00123, 0x80000000,
                               0x7F800000], np.uint32).view(np.float32)
    ok = rng.random(n) > 0.1
    words = ["", "abc", "twelve bytes", "a string past the inline bytes"]
    strs = [None if rng.random() < 0.1 else words[rng.integers(4)]
            for _ in range(n)]
    return [pcol.primitive(f64, validity=ok, device=device),
            pcol.primitive(f32, validity=ok, device=device),
            pcol.primitive(rng.integers(-128, 128, n).astype(np.int8),
                           validity=ok, device=device),
            pcol.primitive(rng.integers(0, 2**32, n).astype(np.uint32),
                           st.Int(32, False), validity=ok, device=device),
            pcol.boolean(rng.random(n) < 0.5, validity=ok, device=device),
            pcol.primitive(rng.integers(0, 20000, n), st.Date32(),
                           validity=ok, device=device),
            pcol.string_view(strs, device=device),
            pcol.from_pylist([None if s is None else s[:3] for s in strs],
                             st.Dictionary(st.int32, st.utf8), device=device),
            pcol.from_pylist([None if rng.random() < 0.1 else int(x) for x in
                              rng.integers(-10**15, 10**15, n)],
                             st.Decimal128(18, 2), device=device)]


@pytest.mark.parametrize("descending,nulls_first", OPTION_PAIRS)
def test_row_converter_on_card_matches_cpu(cuda, descending, nulls_first):
    """convert_columns and convert_rows on the card: the planes equal the
    CPU's, and the columns come back as they were (NaN payloads and -0.0
    included: floats by their bits, null rows zero)."""
    got = {}
    for d in (cuda, "cpu"):
        cols = _row_columns(d)
        rc = RowConverter([SortOptions(descending, nulls_first)] * len(cols))
        planes = rc.convert_columns(cols)
        back = rc.convert_rows(planes, cols[0].length)
        for a, b in zip(cols, back):
            assert bool(pops.equal_columns(a, b))
        got[d] = (planes, back)
    for a, b in zip(got[cuda][0], got["cpu"][0]):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(got[cuda][1], got["cpu"][1]):
        _same_column(a, b)


def test_coalescer_slice_and_equal_on_card_match_cpu(cuda):
    """BatchCoalescer (a push through a mask included) and slice_batch on
    the card equal the CPU; equal_columns is a 0-d bool on the card that
    tells one changed valid value."""
    outs = []
    for d in (cuda, "cpu"):
        b = _classes_batch(d)
        co = pops.BatchCoalescer(b.schema, 16_384)
        for r in _runs(b, (10_000, 7, 20_000)):
            co.push_batch(r)
        keep = np.random.default_rng(18).random(b.length - 30_007) < 0.7
        co.push_batch_with_filter(pops.slice_batch(b, 30_007, b.length),
                                  pcol.boolean(keep, device=d))
        done = []
        while (x := co.next_completed_batch()) is not None:
            done.append(x)
        outs.append(done + [co.finish()])
    assert len(outs[0]) == len(outs[1]) > 2
    for x, y in zip(*outs):
        for a, b in zip(x.columns, y.columns):
            _same_column(a, b)
    d128 = outs[0][0]["d128"]
    changed = d128.values.clone()
    row = int(torch.nonzero(d128.valid_bool())[0])
    changed[row, 0] += 1
    same = pops.equal_columns(d128, d128)
    assert same.device.type == "cuda" and bool(same)
    assert not bool(pops.equal_columns(d128, pcol.PrimitiveColumn(
        changed, d128.validity, d128.length, d128.dtype)))


def test_struct_and_list_sort_keys_on_card_match_cpu(cuda):
    rng = np.random.default_rng(19)
    n = 20_000
    lists = [None if rng.random() < 0.1 else
             [None if rng.random() < 0.05 else int(x)
              for x in rng.integers(0, 2, rng.integers(0, 12))]
             for _ in range(n)]
    structs = [None if rng.random() < 0.1 else
               {"i": int(rng.integers(3)), "s": "s" * int(rng.integers(20))}
               for _ in range(n)]
    got = []
    for d in (cuda, "cpu"):
        lv = pcol.from_pylist(lists, st.List(st.int64), device=d)
        sv = pcol.from_pylist(structs, st.Struct((
            st.Field("i", st.int32), st.Field("s", st.utf8))), device=d)
        got.append([pops.sortmod.sort_to_indices(c, SortOptions(*o))
                    for c in (lv, sv) for o in OPTION_PAIRS]
                   + [pops.lexsort_to_indices([sv, lv])])
    for a, b in zip(*got):
        _same_column(a, b)


def test_temporal_group_by_on_card_matches_cpu(cuda):
    """Date32 (dense engine), Timestamp and Duration keys (sort pipeline)
    with timestamp min / max, a duration sum and an interval count."""
    rng = np.random.default_rng(20)
    n = 100_000
    ok = rng.random(n) > 0.1
    outs = []
    for d in (cuda, "cpu"):
        b = pbt.record_batch({
            "day": pcol.primitive(rng.integers(0, 200, n) if not outs else
                                  outs[0][0], st.Date32(), device=d),
            "ts": pcol.primitive(np.arange(n) % 977 * 1_000_003,
                                 st.Timestamp("us", "UTC"), validity=ok,
                                 device=d),
            "dur": pcol.primitive(np.arange(n) % 13 - 6, st.Duration("ms"),
                                  validity=ok, device=d),
            "iv": pcol.primitive(np.tile(np.arange(4, dtype=np.uint32),
                                         (n, 1)), st.Interval(),
                                 validity=ok, device=d)})
        dk.launches = 0
        dense = group_by(b, ["day"], [("ts", "min"), ("dur", "sum")])
        dense_launches = dk.launches
        sort = [group_by(b, [k], [("ts", "min"), ("ts", "max"),
                                  ("dur", "sum"), ("iv", "count")])
                for k in ("ts", "dur")]
        outs.append((b["day"].values[:n].cpu().numpy(), dense, sort,
                     dense_launches))
    assert outs[0][3] == 1
    for x, y in zip([outs[0][1]] + outs[0][2], [outs[1][1]] + outs[1][2]):
        for a, b in zip(x.columns, y.columns):
            _same_column(a, b)


def test_q3_on_card_against_oracle(cuda):
    """TPC-H Q3 over about 200,000 lineitem rows, 50,000 orders and 4,950
    customers on the card: exact against q3_oracle, K1 launched in the
    filters."""
    la = example_lineitem_arrays(sf=0.033, seed=6)
    oa = pentry.example_orders_arrays(0.033, lineitem=la)
    ca = pentry.example_customer_arrays(0.033)
    with _build.launch_words() as words:
        got = pentry.q3_step(pentry.customer_batch(ca, cuda),
                             pentry.orders_batch(oa, cuda),
                             lineitem_batch(la, device=cuda))
    assert ("K1", 8) in words and ("K1", 16) in words, words
    out = pentry.check_q3(got, pentry.q3_oracle(ca, oa, la))
    assert len(out["rows"]) == 10


# ---------------------------------------------------------------------------
# uint64, float16, cast, whole-column aggregates, ClickBench
# ---------------------------------------------------------------------------

CAST_NUMERIC = ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
                "uint32", "uint64", "float16", "float32", "float64"]


def _u64_values(seed, n=ELEMENTWISE_N):
    """uint64 values, half of them 2**63 or more, with the corners."""
    v = np.random.default_rng(seed).integers(0, 2**64, n, dtype=np.uint64,
                                             endpoint=False)
    v[:8] = [0, 1, 7, 2**63 - 1, 2**63, 2**63 + 1, 2**64 - 2, 2**64 - 1]
    return v


def _f16_values(seed, n=ELEMENTWISE_N):
    v = (np.random.default_rng(seed).standard_normal(n) * 100).astype(
        np.float16)
    v[:8] = [np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5, -2.5, 65504.0]
    return v


def _cast_values(name, seed, n=ELEMENTWISE_N):
    if name == "bool":
        return np.random.default_rng(seed).random(n) < 0.5
    if name == "uint64":
        return _u64_values(seed, n)
    if name == "float16":
        return _f16_values(seed, n)
    return _elementwise_values(name, seed)[:n]


def test_uint64_and_float16_ops_on_card_match_cpu(cuda):
    """uint64 above 2**63 and float16's -0.0, inf and NaN through add,
    sub, mul, div, rem (column and scalar; uint64's exact unsigned
    division), the checked flags, compares, shifts (logical, amounts
    mod 64) and neg: bit for bit."""
    def same(g, c):
        _same_column(g, c, nan_payloads=False)
    for name, values in (("uint64", _u64_values), ("float16", _f16_values)):
        (ga, ca) = _both(values(1), _valid_bools(1), name, cuda)
        (gb, cb) = _both(values(2), None, name, cuda)
        scalars = (7, 2**63 + 5, 1) if name == "uint64" else (1.5, 3, 0.0)
        for op in ("add", "sub", "mul", "div", "rem"):
            f = getattr(pops, op)
            same(f(ga, gb), f(ca, cb))
            for s in scalars:
                same(f(ga, s), f(ca, s))
        for op in ("eq", "lt", "gt_eq", "distinct"):
            f = getattr(pops, op)
            same(f(ga, gb), f(ca, cb))
            same(f(ga, scalars[1]), f(ca, scalars[1]))
        same(pops.neg(ga), pops.neg(ca))
        if name == "uint64":
            for op in ("add_checked", "sub_checked", "mul_checked"):
                g, gf = getattr(pops, op)(ga, gb)
                c, cf = getattr(pops, op)(ca, cb)
                same(g, c)
                assert bool(gf) == bool(cf)
            k = np.arange(ELEMENTWISE_N, dtype=np.uint64) % 70
            (gk, ck) = _both(k, None, "uint64", cuda)
            for op in ("shift_right", "shift_left"):
                same(getattr(pops, op)(ga, gk), getattr(pops, op)(ca, ck))
            assert pops.shift_right(ga, 1).to_pylist()[7] == 2**63 - 1
            assert pops.rem(gb, 7).to_pylist()[7] == (2**64 - 1) % 7


@pytest.mark.parametrize("source", CAST_NUMERIC)
def test_cast_matrix_on_card_matches_cpu(cuda, source):
    """ops.cast from `source` to every numeric type, safe (failures are
    nulls, their values zero) and unsafe where no valid row fails: bit
    for bit, uint64 -> float64 by hi * 2**32 + lo."""
    (g, c) = _both(_cast_values(source, 3), _valid_bools(3), source, cuda)
    for target in CAST_NUMERIC:
        dt = st.bool_ if target == "bool" else getattr(st, target)
        _same_column(pops.cast(g, dt), pops.cast(c, dt), nan_payloads=False)
    if source in ("uint8", "uint16", "uint32"):
        for target in ("uint64", "int64", "float64"):
            dt = getattr(st, target)
            opts = pops.castmod.CastOptions(safe=False)
            _same_column(pops.cast(g, dt, opts), pops.cast(c, dt, opts))
    if source == "uint64":
        with pytest.raises(st.ComputeError):
            pops.cast(g, st.int64, pops.castmod.CastOptions(safe=False))


def _u64_f16_batch(device, n=100_000):
    rng = np.random.default_rng(21)
    ok = rng.random(n) > 0.1
    uk = rng.integers(0, 2000, n).astype(np.uint64) * np.uint64(2**53 + 1)
    hk = np.array([1.5, 2.5, -0.0, 0.0, np.inf, np.nan], np.float16)[
        rng.integers(0, 6, n)]
    return pbt.record_batch({
        "uk": pcol.primitive(uk, st.uint64, device=device),
        "hk": pcol.primitive(hk, st.float16, device=device),
        "k": pcol.primitive(rng.integers(0, 50, n).astype(np.int32),
                            st.int32, device=device),
        "uv": pcol.primitive(_u64_values(22, n), st.uint64, validity=ok,
                             device=device),
        "hv": pcol.primitive(_f16_values(23, n), st.float16, validity=ok,
                             device=device)})


def test_uint64_float16_sort_group_by_and_aggregates_on_card_match_cpu(
        cuda):
    """sort_to_indices, the RowConverter round trip, group_by on (uint64,
    float16) keys (sort pipeline, K1 at 8 and 2 bytes) and on an int32
    key with uint64 values (the dense engine, values flipped), and the
    whole-column aggregates, on the card against the CPU: bit for bit,
    but float sums (a float64 cumsum in another order, then float16):
    within 2**-10 x the sum of |v| over the column."""
    got = {}
    for d in (cuda, "cpu"):
        b = _u64_f16_batch(d)
        out = [pops.sortmod.sort_to_indices(b[c], SortOptions(*o))
               for c in ("uk", "uv", "hv") for o in OPTION_PAIRS]
        rc = RowConverter([SortOptions(True, False), SortOptions()] * 2)
        cols = [b["uv"], b["hv"], b["uk"], b["hk"]]
        back = rc.convert_rows(rc.convert_columns(cols), b.length)
        for a, x in zip(cols, back):
            assert bool(pops.equal_columns(a, x))
        dk.launches = 0
        grouped = group_by(b, ["uk", "hk"], [
            ("uv", "sum"), ("uv", "min"), ("uv", "max"), ("uv", "mean"),
            ("hv", "min"), ("hv", "max")])
        sums = group_by(b, ["uk"], [("hv", "sum"), ("hv", "mean")])
        dense = group_by(b, ["k"], [("uv", "sum"), ("uv", "min"),
                                    ("uv", "max"), ("uv", "mean")])
        aggs = [pops.finalize(getattr(pops, a)(b[c]), b[c].dtype)
                for c in ("uv", "hv") for a in ("min_", "max_")]
        aggs += [pops.finalize(pops.sum_(b["uv"]), st.uint64),
                 pops.finalize(pops.product(b["uv"]), st.uint64)]
        got[d] = (out, back, grouped, sums, dense, aggs, dk.launches,
                  pops.finalize(pops.sum_(b["hv"])),
                  _finite_magnitude(column_to_numpy(b["hv"])[0]))
    g, c = got[cuda], got["cpu"]
    assert g[6] == 1  # the dense engine's one launch on the card
    for x, y in zip(g[0] + g[1] + list(g[2].columns) + list(g[4].columns),
                    c[0] + c[1] + list(c[2].columns) + list(c[4].columns)):
        _same_column(x, y)
    _same_column(g[3]["uk"], c[3]["uk"])
    for name in ("sum_hv", "mean_hv"):
        x = g[3][name].values.cpu().to(torch.float64)
        y = c[3][name].values.to(torch.float64)
        finite = y.isfinite()
        assert torch.equal(x[~finite].nan_to_num(), y[~finite].nan_to_num())
        assert ((x - y)[finite].abs() <= 2**-10 * c[8]).all(), name
    assert [repr(x) for x in g[5]] == [repr(x) for x in c[5]]
    assert abs(g[7] - c[7]) <= 2**-10 * c[8] or (g[7] != g[7] and
                                                 c[7] != c[7])


def _finite_magnitude(v: np.ndarray) -> float:
    """The sum of |v| over the finite values, in float64."""
    v = v.astype(np.float64)
    return float(np.abs(v[np.isfinite(v)]).sum())


def test_clickbench_on_card_against_oracle(cuda):
    """ClickBench queries 1-8 over 200,000 rows of `hits` on the card:
    exact against clickbench_oracle (AVG(UserID) within 1e-12), K1 at 8
    bytes in the uint64 group-bys and K2 in query 6's filter."""
    arrays = pentry.example_hits_arrays(200_000)
    batch = pentry.hits_batch(arrays, cuda)
    want = pentry.clickbench_oracle(arrays)
    for q in sorted(pentry.CLICKBENCH_QUERIES):
        with _build.launch_words() as words:
            got = pentry.clickbench_step(batch, q)
        pentry.check_clickbench(got, want[q], q)
        if q in (4, 7, 8):
            assert ("K1", 8) in words, (q, words)
        if q == 6:
            assert ("K2", 1) in words, words


# ---------------------------------------------------------------------------
# run-end encoding, date_part with zones, the C Data Interface
# ---------------------------------------------------------------------------

ZONES = ["Europe/Moscow", "America/New_York", "Australia/Lord_Howe",
         "+05:45"]
TEMPORAL = [st.Date32(), st.Date64(), st.Time32("s"), st.Time32("ms"),
            st.Time64("us"), st.Time64("ns"), st.Duration("ms"),
            *[st.Timestamp(u) for u in ("s", "ms", "us", "ns")],
            *[st.Timestamp("s", z) for z in ZONES],
            *[st.Timestamp("ms", z) for z in ZONES]]


def _instants(dtype, n=3000, seed=0):
    """n values of `dtype`: near every transition of its zone (one second
    before, at, after), then random ones within 1700-2250."""
    from arrowtpu_torch.ops import tzdb

    rng = np.random.default_rng(seed)
    if isinstance(dtype, st.Date32):
        return rng.integers(-10**5, 10**5, n).astype(np.int32)
    if isinstance(dtype, (st.Time32, st.Time64)):
        per_s = {"s": 1, "ms": 10**3, "us": 10**6, "ns": 10**9}[dtype.unit]
        v = rng.integers(0, 86_400 * per_s, n)
        return v.astype(np.int32) if isinstance(dtype, st.Time32) else v
    if isinstance(dtype, st.Date64):
        return rng.integers(-8 * 10**12, 8 * 10**12, n)
    per_s = {"s": 1, "ms": 10**3, "us": 10**6, "ns": 10**9}[dtype.unit]
    v = rng.integers(-8_500_000_000, 8_800_000_000, n) * per_s
    v += rng.integers(0, per_s, n)
    if getattr(dtype, "tz", None):
        t = tzdb.zone_table(dtype.tz)[0]
        near = np.stack([t - 1, t, t + 1], 1).reshape(-1)[:n] * per_s
        v[:len(near)] = near
    return v


@pytest.mark.parametrize("dtype", TEMPORAL, ids=str)
def test_date_part_on_card_matches_cpu(cuda, dtype):
    from arrowtpu_torch.ops import temporal

    v = _instants(dtype)
    valid = np.random.default_rng(1).random(len(v)) > 0.1
    on = {d: pcol.primitive(v, dtype, validity=valid, device=d)
          for d in ("cpu", cuda)}
    for part in temporal.PARTS:
        got = temporal.date_part(on[cuda], part)
        want = temporal.date_part(on["cpu"], part)
        assert torch.equal(got.values.cpu(), want.values), (dtype, part)
        assert torch.equal(got.validity.cpu(), want.validity)


def _ree_cases():
    rng = np.random.default_rng(3)

    def runs(pool, n=5000):
        out = []
        while len(out) < n:
            out += [pool[int(rng.integers(len(pool)))]] * int(
                rng.integers(1, 9))
        return out[:n]
    nan = float("nan")
    return {"int32": (runs([1, 2, None, -7]), st.int32),
            "uint32": (runs([62, 2**32 - 1, 0]), st.uint32),
            "float64": (runs([nan, 0.5, None, -0.0, 0.0]), st.float64),
            "utf8": (runs(["a", None, "a string past twelve bytes", ""]),
                     st.utf8),
            "date32": (runs([15900, None, 15901]), st.Date32())}


@pytest.mark.parametrize("name", list(_ree_cases()))
def test_run_end_on_card_matches_cpu(cuda, name):
    from arrowtpu_torch import ops
    from arrowtpu_torch.core import accessor

    data, dtype = _ree_cases()[name]
    idx = np.random.default_rng(4).integers(0, len(data), 2000)
    ok = np.random.default_rng(5).random(2000) > 0.05
    out = {}
    for d in ("cpu", cuda):
        c = pcol.from_pylist(data, dtype, device=d)
        with _build.launch_words() as words:
            r = ops.run_end_encode(c)
        if d == cuda:  # the row numbers' word
            assert ("K1", 4) in words, words
        out[d] = (r, ops.run_end_decode(r), ops.take_run(
            r, pcol.primitive(idx, st.int64, validity=ok, device=d)))
    (rc, dc, tc), (rg, dg, tg) = out["cpu"], out[cuda]
    assert rg.n_runs == rc.n_runs
    assert torch.equal(rg.run_ends.cpu(), rc.run_ends)
    for a, b in ((rg.values, rc.values), (dg, dc), (tg, tc)):
        if name == "utf8":
            assert list(accessor.iter_column(a)) == list(
                accessor.iter_column(b))
            continue
        av, aok, _ = column_to_numpy(a)
        bv, bok, _ = column_to_numpy(b)
        assert np.array_equal(aok, bok)
        if av.dtype.kind == "f":  # NaNs by their bits
            av, bv = av.view(np.uint64), bv.view(np.uint64)
        assert np.array_equal(av[aok], bv[bok])


def test_q43_on_card_against_oracle(cuda):
    """ClickBench query 43 over 300,000 rows of `hits` in primary-key
    order on the card, at offsets that reach rows: exact against
    q43_oracle, K1 at 4 bytes in the encodes and at 8 in the filter."""
    arrays = pentry.example_hits_pk_arrays(300_000)
    with _build.launch_words() as words:
        batch = pentry.hits_pk_batch(arrays, cuda)
    assert ("K1", 4) in words, words
    for offset, limit in ((0, 10), (500, 10), (0, 10**6)):
        with _build.launch_words() as words:
            got = pentry.q43_step(batch, offset, limit)
        pentry.check_q43(got, pentry.q43_oracle(arrays, offset, limit))
        assert ("K1", 8) in words, words


def test_cdata_round_trip_of_a_card_column(cuda):
    import ctypes

    from arrowtpu_torch.interop import cdata

    v = _instants(st.Timestamp("s", "Europe/Moscow"), 5000)
    valid = np.random.default_rng(6).random(len(v)) > 0.1
    cols = [pcol.primitive(v, st.Timestamp("s", "Europe/Moscow"),
                           validity=valid, device=cuda),
            pcol.from_pylist(["x", None, "a longer string than twelve"] * 9,
                             st.utf8, device=cuda),
            pcol.primitive(np.arange(100, dtype=np.uint32), st.uint32,
                           device=cuda)]
    for c in cols:
        schema, array = cdata.export_column(c, "c")
        back, field = cdata.import_column(ctypes.addressof(array),
                                          ctypes.addressof(schema), cuda)
        assert back.device.type == "cuda" and field.dtype == c.dtype
        assert back.to_pylist() == c.to_pylist()
    assert cdata.export_column(cols[0])[0].format == b"tss:Europe/Moscow"


def _validate_columns(device):
    """Malformed columns on `device` (test_torch_validate's), and good
    ones: {name: column}."""
    import dataclasses

    d = pcol.dictionary_encode_host(["x", "y", "x", None], device=device)
    s = pcol.string_view(["a-string-longer-than-twelve-bytes", "ok"],
                         device=device)
    views = s.views.clone()
    views[0, 3] = 10**8
    lv = pcol.list_view([[1, 2], [3]], device=device)
    words = [b"ok", b"\xff\xfe-not-utf8", "日本語".encode(), b"\xed\xa0\x80",
             b"\xf4\x90\x80\x80", "\U0010FFFF".encode()] * 700
    return {
        "strings": pcol.string_view(words[::3] + [None], device=device),
        "bad_utf8": pcol.string_view(words, st.utf8, device=device),
        "binary": pcol.string_view(words, st.binary, device=device),
        "bad_keys": dataclasses.replace(d, keys=dataclasses.replace(
            d.keys, values=torch.full_like(d.keys.values, 99))),
        "bad_views": dataclasses.replace(s, views=views),
        "bad_starts": dataclasses.replace(
            lv, starts=torch.full_like(lv.starts, 10**6)),
        "struct": pcol.struct_column(
            [{"a": 1, "s": "x"}, None, {"a": 3, "s": "zz"}], device=device)}


def test_validate_flags_on_card_match_cpu(cuda):
    from arrowtpu_torch.core import validate

    host, card = _validate_columns("cpu"), _validate_columns(cuda)
    for name in host:
        want = validate.validate_column(host[name])
        got = validate.validate_column(card[name])
        assert list(got) == list(want), name
        assert all(v.device.type == "cuda" for v in got.values())
        assert {k: bool(v) for k, v in got.items()} == {
            k: bool(v) for k, v in want.items()}, name
    rows = validate.utf8_invalid_rows(card["bad_utf8"],
                                      card["bad_utf8"].valid_bool())
    assert rows.cpu().tolist() == validate.utf8_invalid_rows(
        host["bad_utf8"], host["bad_utf8"].valid_bool()).tolist()


def test_lineitem_ipc_on_card_against_oracle(cuda):
    """A 200,000-row lineitem written as an IPC file and a stream, read
    onto the card with validate=True: the same rows, Q6 exact, any batch
    by the file's footer, and both corruptions raise."""
    import io

    from arrowtpu_torch.formats import ipc
    from arrowtpu_torch.ops.coalesce import slice_batch

    arrays = example_lineitem_arrays(0.0333)
    batch = lineitem_batch(arrays, cuda)
    data = pentry.lineitem_ipc(batch, 65536)
    got = pentry.read_lineitem_ipc(data, validate=True)
    assert got.device.type == "cuda"
    assert pentry.check_same_rows(got, batch, same_dictionary=False) == \
        batch.length
    check_q6(q6_step(got), arrays, q6_oracle(arrays))
    r = ipc.FileReader(data)
    pentry.check_same_rows(r.get_batch(2), slice_batch(batch, 131072, 65536),
                           same_dictionary=False)
    sink = io.BytesIO()
    pentry.lineitem_ipc(batch, 65536, stream=True, sink=sink)
    buf = sink.getbuffer()
    spans = ipc_spans.batch_buffers(buf)
    off, _ = spans[0]["l_comment"][2]
    saved = buf[off + 1]
    buf[off + 1] = 0xFF
    with pytest.raises(st.ValidationError, match=r"l_comment\.invalid_utf8"):
        pentry.read_lineitem_ipc(buf)
    assert pentry.read_lineitem_ipc(buf, validate=False).length == \
        batch.length
    buf[off + 1] = saved
    off, _ = spans[1]["l_shipmode"][1]
    buf[off:off + 4] = np.int32(7).tobytes()
    with pytest.raises(st.ValidationError,
                       match=r"l_shipmode\.dict_key_out_of_bounds"):
        pentry.read_lineitem_ipc(buf)


@pytest.mark.parametrize("offset", [1 << 30, -(1 << 30)])
def test_lineitem_ipc_bad_offset_raises_on_card(cuda, offset):
    """An l_comment offset past the data or below zero, read onto the
    card with validate=True: ValidationError names the decreasing offsets
    (checked on the host, ROADMAP C.3 fault 17); read without validate,
    the full check on the card names the views they give; and the card
    still works after it."""
    import io

    arrays = example_lineitem_arrays(0.0333)
    batch = lineitem_batch(arrays, cuda)
    sink = io.BytesIO()
    pentry.lineitem_ipc(batch, 65536, stream=True, sink=sink)
    buf = sink.getbuffer()
    off, _ = ipc_spans.batch_buffers(buf)[1]["l_comment"][1]
    buf[off + 400:off + 404] = np.int32(offset).tobytes()
    with pytest.raises(st.ValidationError,
                       match=r"l_comment\.offsets_decreasing$"):
        pentry.read_lineitem_ipc(buf)
    # read without validate, the full check on the card flags the views
    got = pipc.read_stream(buf, device=cuda)
    with pytest.raises(st.ValidationError,
                       match=r"^invalid array data in batch: "
                             r"l_comment\.view_out_of_bounds, "
                             r"l_comment\.negative_length$"):
        pval.check_batch(got[1])
    torch.cuda.synchronize()
    check_q6(q6_step(batch), arrays, q6_oracle(arrays))


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for y in x for t in _flat(y)]


def _held_to_plain(monkeypatch):
    """Every K1 / K2 wrapper call is computed again by the kernel's plain
    version on the same inputs and must equal it; -> [(kernel, word
    bytes)] of the calls."""
    calls = []
    for name, mod, attr, plain in (("K1", k1, "compact_planes",
                                    "compact_planes_plain"),
                                   ("K2", k2, "compact_planes_info",
                                    "compact_planes_info_plain")):
        def held(planes, keep, pre=None, out_rows=None, name=name,
                 real=getattr(mod, attr), plain=getattr(mod, plain)):
            got = real(planes, keep, pre, out_rows)
            a, b = _flat(got), _flat(plain(planes, keep, out_rows))
            assert len(a) == len(b) and all(
                torch.equal(x, y) for x, y in zip(a, b)), name
            calls.append((name, _build.word_bytes(planes[0])))
            return got
        monkeypatch.setattr(mod, attr, held)
    return calls


def test_parquet_scan_on_card_matches_cpu(cuda, monkeypatch):
    """`hits` in primary-key order, 300,000 rows, through the Parquet file
    of chip_smoke's phase 25 (row groups of 100,000 rows, 20,000-row
    pages): the same bytes written from the card, and each scan (query
    43's predicates pushed down; DontCountHits = 0 alone) gives on the
    card the CPU scan's columns and metrics, K1 at 4 and 8 bytes and K2 at
    one byte in its filters, every call held to plain; query 43 on the
    pruned scan exact against its oracle."""
    from arrowtpu_torch.entry import (check_q43, example_hits_pk_arrays,
                                      hits_from_parquet, hits_pk_parquet,
                                      q43_oracle, q43_predicates, q43_step)
    from arrowtpu_torch.formats import parquet_scan as ps

    arrays = example_hits_pk_arrays(300_000)
    data = hits_pk_parquet(arrays, rows=100_000, device=cuda)
    assert data == hits_pk_parquet(arrays, rows=100_000, device="cpu")
    calls = _held_to_plain(monkeypatch)
    for preds in (q43_predicates(), q43_predicates(all_four=False)):
        want, wm = ps.scan_parquet(data, predicates=preds, device="cpu")
        del calls[:]
        k1.launches = k2.launches = 0
        got, gm = ps.scan_parquet(data, predicates=preds, device=cuda)
        torch.cuda.synchronize()
        assert {("K1", 4), ("K1", 8), ("K2", 1)} <= set(calls), calls
        assert k1.launches >= 2 and k2.launches >= 1
        assert gm.asdict() == wm.asdict()
        for g, w in zip(got.columns, want.columns):
            _same_column(g, w)
    got, _ = ps.scan_parquet(data, predicates=q43_predicates(), device=cuda)
    check_q43(q43_step(hits_from_parquet(got), 10, 10),
              q43_oracle(arrays, 10, 10))


def test_parquet_scan_of_pages_cut_by_content_on_card(cuda, monkeypatch):
    """Pages cut by content, so their row ranges differ between columns:
    the pages of `b` and `s` kept for `a`'s selection hold rows it does
    not select, and the upload drops them with the filter on the card (K1
    at 8 bytes, held to plain); the scan gives the CPU scan's columns and
    metrics."""
    from arrowtpu_torch.formats import parquet as pq
    from arrowtpu_torch.formats import parquet_scan as ps
    from arrowtpu_torch.formats.parquet_cdc import CdcOptions

    rng = np.random.default_rng(5)
    n = 20_000
    a = np.arange(n, dtype=np.int64)
    b = rng.integers(-10**6, 10**6, n) * 2
    s = [f"r{v}" * (1 + v % 4) for v in rng.integers(0, 999, n).tolist()]
    batch = pbt.record_batch({
        "a": pcol.from_pylist(a.tolist(), st.int64, device="cpu"),
        "b": pcol.from_pylist(b.tolist(), st.int64, device="cpu"),
        "s": pcol.from_pylist(s, st.utf8, device="cpu")})
    data = pq.write_parquet([batch], props=pq.WriterProperties(
        write_page_index=True, dictionary_enabled=False,
        cdc_options=CdcOptions(1024, 4096)))
    preds = [ps.ColumnPredicate("a", "gt_eq", 3001),
             ps.ColumnPredicate("a", "lt", 7777)]
    want, wm = ps.scan_parquet(data, predicates=preds, device="cpu")
    calls = _held_to_plain(monkeypatch)
    in_upload = []
    real = ps.upload_columns

    def upload(pf, h, names):
        before = k1.launches
        out = real(pf, h, names)
        in_upload.append(k1.launches - before)
        return out
    monkeypatch.setattr(ps, "upload_columns", upload)
    k1.launches = k2.launches = 0
    got, gm = ps.scan_parquet(data, predicates=preds, device=cuda)
    torch.cuda.synchronize()
    assert sum(in_upload) >= 1 and ("K1", 8) in calls, (in_upload, calls)
    assert gm.asdict() == wm.asdict() and gm.pages_skipped > 0
    for g, w in zip(got.columns, want.columns):
        _same_column(g, w)
    keep = (a >= 3001) & (a < 7777)
    assert got["b"].to_pylist() == b[keep].tolist()
    assert got["s"].to_pylist() == [v for v, k in zip(s, keep) if k]


def test_short_string_past_the_data_raises_on_card(cuda):
    """ROADMAP C.3 fault 17 on the card: an IPC stream whose last utf8
    string of 5 bytes runs 3 bytes past the data raises ValidationError
    when read with validate=True; without it the column builds on the
    card from the data alone."""
    from arrowtpu_torch.formats import ipc
    from arrowtpu_torch.formats.layout import Node, layout_to_column

    bufs = [np.zeros(0, np.uint8), np.array([0, 3, 8], np.int32).view(
        np.uint8), np.frombuffer(b"abcde", np.uint8)]
    node = Node(2, 0, bufs, [])
    with pytest.raises(st.ValidationError, match=r"s\.offsets_out_of_bounds"):
        layout_to_column(node, st.utf8, cuda, validate=True, name="s")
    c = layout_to_column(node, st.utf8, cuda)
    assert c.device.type == "cuda" and c.to_pylist()[0] == "abc"
    batch = pbt.record_batch({"s": pcol.from_pylist(
        ["abc", "de"], st.utf8, device=cuda)})
    sink = bytearray(ipc.write_stream(batch))
    data_off = sink.rfind(b"abcde")
    off_at = sink.rfind(np.array([0, 3, 5], np.int32).tobytes(), 0,
                        data_off)
    sink[off_at + 8:off_at + 12] = np.int32(8).tobytes()
    with pytest.raises(st.ValidationError, match=r"s\.offsets_out_of_bounds"):
        ipc.read_stream(bytes(sink), validate=True, device=cuda)
    assert ipc.read_stream(bytes(sink), device=cuda)[0].length == 2


def _avro_files():
    """A flat OCF (hits' five columns in ClickHouse's types, 70,000 rows
    in two blocks) and a nested one (records, arrays, maps, an enum)."""
    import json

    from arrowtpu_torch.entry import HITS_COLUMNS, example_hits_arrays, \
        hits_batch
    from arrowtpu_torch.formats import avro

    flat = avro.write_avro(hits_batch(example_hits_arrays(70_000),
                                      device="cpu"))
    schema = {"type": "record", "name": "R", "fields": [
        {"name": "id", "type": "long"},
        {"name": "tags", "type": {"type": "array", "items": "string"}},
        {"name": "attrs", "type": {"type": "map",
                                   "values": ["null", "int"]}},
        {"name": "sub", "type": ["null", {
            "type": "record", "name": "S", "fields": [
                {"name": "x", "type": "int"},
                {"name": "y", "type": ["null", "string"]}]}]},
        {"name": "color", "type": {"type": "enum", "name": "C",
                                   "symbols": ["RED", "GREEN", "BLUE"]}}]}
    rows = [{"id": i, "tags": [f"t{j}" * (1 + i % 7) for j in range(i % 4)],
             "attrs": {f"k{j}": None if j == 1 else i * j
                       for j in range(i % 3)},
             "sub": None if i % 5 == 0 else {"x": i, "y": f"y{i % 17}"},
             "color": ["RED", "GREEN", "BLUE"][i % 3]} for i in range(3000)]
    body = bytearray()
    for row in rows:
        avro._encode_row(body, schema, row)
    blk = bytearray()
    avro.write_long(blk, len(rows))
    avro.write_long(blk, len(body))
    nested = (avro.ocf_header(json.dumps(schema), "null", b"S" * 16)
              + bytes(blk) + bytes(body) + b"S" * 16)
    return flat, nested, HITS_COLUMNS


def test_avro_on_card_matches_cpu(cuda):
    """An OCF read onto the card equals the same file read onto the CPU,
    through the flat native decoder and through the nested one."""
    from arrowtpu_torch.formats import avro

    flat, nested, names = _avro_files()
    for data in (flat, nested):
        got = avro.read_avro(data, device=cuda)
        want = avro.read_avro(data, device="cpu")
        assert got.device.type == cuda.type
        for g, w in zip(got.columns, want.columns):
            _same_column(g, w)
    assert avro.read_avro(flat, device=cuda).schema.names == names


def test_csv_on_card_matches_cpu(cuda):
    """`hits` as TSV (hits.tsv's layout) read under the hits schema in
    batches onto the card equals the same text read onto the CPU."""
    from arrowtpu_torch.entry import HITS_COLUMNS, HITS_TYPES, \
        example_hits_arrays, hits_batch
    from arrowtpu_torch.formats import csv

    text = csv.write_csv(hits_batch(example_hits_arrays(20_000), cuda),
                         delimiter="\t", has_header=False)
    schema = st.Schema(tuple(st.Field(n, HITS_TYPES[n], False)
                             for n in HITS_COLUMNS))
    opts = dict(schema=schema, delimiter="\t", has_header=False,
                batch_size=4096)
    got = csv.read_csv(text, device=cuda, **opts)
    want = csv.read_csv(text, device="cpu", **opts)
    for g, w in zip(got.columns, want.columns):
        _same_column(g, w)


def test_execute_select_on_card_matches_cpu(cuda):
    """A FlightSQL statement over `hits` on the card (cmp, and_kleene,
    filter_record_batch with K1 at 4 and 8 bytes, slice_batch), framed as
    DoGet frames it and decoded onto the card, equals the same on the
    CPU."""
    from arrowtpu_torch import flight, flightsql
    from arrowtpu_torch.entry import example_hits_arrays, hits_batch

    arrays = example_hits_arrays(200_000)
    sql = ("SELECT UserID, RegionID FROM hits WHERE AdvEngineID <> 0 "
           "AND RegionID < 300 LIMIT 100000")
    k1.launches = 0
    got = flightsql.execute_select({"hits": hits_batch(arrays, cuda)}, sql)
    torch.cuda.synchronize()
    assert k1.launches >= 1
    want = flightsql.execute_select({"hits": hits_batch(arrays, "cpu")}, sql)
    _, (back,) = flight.decode_batches(
        flight.encode_batches(got.schema, [got]), device=cuda)
    for g, b, w in zip(got.columns, back.columns, want.columns):
        _same_column(g, w)
        _same_column(b, w)
    keep = (arrays["AdvEngineID"] != 0) & (arrays["RegionID"] < 300)
    assert want["UserID"].to_pylist() == arrays["UserID"][keep].tolist()


def test_variant_get_fast_path_gives_the_typed_column_on_card(cuda):
    """variant_get of a fully shredded primitive path on a VariantColumn on
    the card is the shredded typed column itself (its own device tensor),
    with no row decoded; a residual path falls back to the host and equals
    the CPU's."""
    from arrowtpu_torch import variant
    from arrowtpu_torch.variant import get as vget

    vals = [{"a": i, "b": f"s{i}", "c": [i]} for i in range(300)] + [
        None, {"b": "only b"}]
    target = st.Struct((st.Field("a", st.int64), st.Field("b", st.utf8)))
    sh = variant.shred_variant(variant.variant_array(vals, cuda), target)
    real, made = vget.MetadataNames, []
    vget.MetadataNames = lambda m: made.append(m) or real(m)
    try:
        got = variant.variant_get(sh, ["a"], as_dtype=st.int64)
        assert not made
        typed = sh.typed_value.field("a").field("typed_value")
        assert got.values.data_ptr() == typed.values.data_ptr()
        assert got.device.type == "cuda"
        assert got.to_pylist() == [v.get("a") if v else None for v in vals]
        resid = variant.variant_get(sh, ["c", 0], as_dtype=st.int64)
        assert len(made) == 1 and resid.device.type == "cuda"
    finally:
        vget.MetadataNames = real
    cpu = variant.shred_variant(variant.variant_array(vals, "cpu"), target)
    assert resid.to_pylist() == variant.variant_get(
        cpu, ["c", 0], as_dtype=st.int64).to_pylist()


def test_cli_bench_on_card_holds_k1_to_plain(cuda, capsys):
    """`python -m arrowtpu_torch.cli bench` runs its filter on the card by
    default: K1 launches at 8 bytes, each call equal to the plain version,
    and the line names the card."""
    import json

    from arrowtpu_torch import cli

    real, calls = k1.compact_planes, []

    def held(planes, keep, pre=None, out_rows=None):
        got = real(planes, keep, pre, out_rows)
        want = k1.compact_planes_plain(planes, keep, out_rows)
        calls.append(all(torch.equal(a, b) for a, b in zip(got, want)))
        return got

    k1.launches = 0
    k1.compact_planes = held
    try:
        cli.main(["bench", "--rows", "300000"])
    finally:
        k1.compact_planes = real
    torch.cuda.synchronize()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device"] == torch.cuda.get_device_name(0)
    assert line["rows"] == 300_000 and line["seconds"] > 0
    assert k1.launches >= 1 and calls and all(calls)


def test_jsonbench_on_card_against_oracle(cuda):
    """A small JSONBench draw shredded onto the card: the five columns by
    the columnar path, and the five queries exact against the oracle."""
    from arrowtpu_torch.entry import (bluesky_batch, bluesky_variant,
                                      check_jsonbench, example_bluesky_docs,
                                      jsonbench_oracle, jsonbench_step)

    texts = example_bluesky_docs(5_000)
    batch = bluesky_batch(bluesky_variant(texts, cuda))
    assert batch.device.type == "cuda"
    want = jsonbench_oracle(texts)
    for q in range(1, 6):
        check_jsonbench(jsonbench_step(batch, q), want[q], q)
