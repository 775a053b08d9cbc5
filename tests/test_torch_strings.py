"""arrowtpu_torch's string byte matrix and string, fixed-size binary and
decimal sort keys against the JAX package on the same inputs.

The byte matrix, `from_byte_matrix` and the lengths; `encode_column`'s
planes; `sort_to_indices` / `lexsort_to_indices` / `rank` over string
keys with inline (at most 12 bytes) and arena strings, empty strings,
strings that differ only in trailing zero bytes, nulls, both directions
and null placements, and a long key that takes the grouped sort; fixed-size
binary and decimal keys.  Tolerance: exact (bytes, planes and indices
equal; index columns over their first `length` entries).  Every column has
N rows, so the JAX side compiles few shapes.
"""

import numpy as np
import pytest
import torch

import torch_parity as tp
import arrowtpu as at
from arrowtpu import config as jconfig
from arrowtpu import schema as jst
from arrowtpu.core import column as jcol
from arrowtpu.core import limbs as jl
from arrowtpu.ops import sortmod as jsort
from arrowtpu.ops import strings as jstr
from arrowtpu.rowformat import encode as jrf

import arrowtpu_torch as pt
from arrowtpu_torch import config as pconfig
from arrowtpu_torch import schema as pst
from arrowtpu_torch.core import column as pcol
from arrowtpu_torch.ops import sortmod as psort
from arrowtpu_torch.ops import strings as pstr
from arrowtpu_torch.rowformat import encode as prf
from arrowtpu_torch.rowformat import pack as prp

N = 300
ORDERS = [(False, True), (False, False), (True, True), (True, False)]
# short words, words differing only in trailing zero bytes, the empty
# string, multi-byte UTF-8, 12- and 13-byte strings (inline / arena)
SHORT = ["", "a", "a\0", "a\0\0", "ab", "b", "ba", "zz", "été",
         "twelve bytes", "thirteen byte", "é"]


def _strings(seed, words=SHORT, long_tail=0, nulls=0.1):
    """N strings drawn from `words`, plus `long_tail` random 20-40 byte
    strings over a small alphabet (ties in their first 16 bytes), with
    nulls."""
    rng = np.random.default_rng(seed)
    out = [words[i] for i in rng.integers(0, len(words), N)]
    for i in rng.choice(N, long_tail, replace=False):
        n = int(rng.integers(20, 41))
        out[i] = "prefix-sixteen-b" + "".join(rng.choice(list("ab\0"), n - 16))
    return [None if rng.random() < nulls else s for s in out]


def _pair(data, binary=False):
    jdt, pdt = (jst.binary, pst.binary) if binary else (jst.utf8, pst.utf8)
    if binary:
        data = [None if s is None else s.encode() for s in data]
    return (jcol.string_view(data, jdt),
            pcol.string_view(data, pdt, device="cpu"))


def _indices(jidx, pidx):
    n = int(jidx.length)
    assert pidx.length == n and str(pidx.dtype) == "int32"
    assert not pidx.values[n:].any()
    return np.asarray(jidx.values)[:n], pidx.values[:n].numpy()


def test_byte_matrix_and_round_trip_match_jax():
    jc, pc = _pair(_strings(1, long_tail=40))
    L = jstr.max_byte_length(jc)
    assert pstr.max_byte_length(pc) == L == 48
    jm, jlen = jstr.byte_matrix(jc, L)
    pm, plen = pstr.byte_matrix(pc, L)
    np.testing.assert_array_equal(pm[:N].numpy(), np.asarray(jm)[:N])
    np.testing.assert_array_equal(plen[:N].numpy(),
                                  np.asarray(jlen)[:N].view(np.int32))
    jr = jstr.from_byte_matrix(jm, jlen, jc.validity, jc.length, jc.dtype)
    pr = pstr.from_byte_matrix(pm, plen, pc.validity, pc.length, pc.dtype)
    tp.assert_column_equal(jr, pr, "round trip")
    np.testing.assert_array_equal(pr.views[:N].numpy(),
                                  np.asarray(jr.views)[:N].view(np.int32))
    assert pr.to_pylist() == pc.to_pylist()


def test_short_column_skips_the_arena():
    """A column bounded to 12 bytes reads only its views: its matrix is
    the same with the arena cleared."""
    _, pc = _pair(_strings(1))
    bound = pcol.StringViewColumn(pc.views, pc.arena.clone().fill_(7),
                                  pc.validity, pc.length, pc.dtype, 12)
    short = [s if s is None or len(s.encode()) <= 12 else None
             for s in pc.to_pylist()]
    _, ref = _pair(short)
    np.testing.assert_array_equal(
        pstr.byte_matrix(bound, 16)[0][:N].numpy() * (
            np.array([s is not None for s in short])[:, None]),
        pstr.byte_matrix(ref, 16)[0][:N].numpy())


def test_max_byte_length_without_bound_reads_back():
    _, pc = _pair(["a" * 17, None, "b"])
    unbounded = pcol.StringViewColumn(pc.views, pc.arena, pc.validity,
                                      pc.length, pc.dtype, None)
    assert pstr.max_byte_length(unbounded) == 32


def test_lengths_match_jax():
    data = _strings(1, long_tail=40)
    jc, pc = _pair(data)
    for fn in ("octet_length", "bit_length", "length"):
        tp.assert_column_equal(getattr(jstr, fn)(jc), getattr(pstr, fn)(pc),
                               fn)
    # binary counts bytes; a dictionary takes its values' lengths by key
    _, pb = _pair(data, binary=True)
    assert pstr.length(pb).to_pylist() == [
        None if s is None else len(s.encode()) for s in data]
    words = [w for w in SHORT if w]
    keys = [None if s is None else words[i % len(words)]
            for i, s in enumerate(data)]
    pd = pcol.dictionary_encode_host(
        keys, pst.Dictionary(pst.int32, pst.utf8), device="cpu")
    got = pstr.length(pd)
    assert got.to_pylist() == [None if k is None else len(k) for k in keys]
    tp.assert_zero_padding(got)


def _fsb_pair(seed, width=6):
    rng = np.random.default_rng(seed)
    pool = [bytes(rng.integers(0, 4, width, dtype=np.uint8))
            for _ in range(12)]
    data = [None if rng.random() < 0.1 else pool[i]
            for i in rng.integers(0, len(pool), N)]
    return (jcol.from_pylist(data, jst.FixedSizeBinary(width)),
            pcol.from_pylist(data, pst.FixedSizeBinary(width), device="cpu"))


def _decimal_pair(seed, n_limbs=4, scale=2):
    rng = np.random.default_rng(seed)
    step = 10 ** (8 * n_limbs) + 7  # values that fill the top limbs
    ints = rng.integers(-50, 50, N)
    valid = rng.random(N) > 0.1
    limbs = jl.split_ints([int(x) * step + int(x) % 7 for x in ints],
                          n_limbs)
    cls = {1: "Decimal32", 2: "Decimal64", 4: "Decimal128",
           8: "Decimal256"}[n_limbs]
    prec = {1: 9, 2: 18, 4: 38, 8: 76}[n_limbs]
    return (at.primitive(limbs, getattr(jst, cls)(prec, scale),
                         validity=tp.jbm.from_numpy_bools(valid)),
            pcol.primitive(limbs, getattr(pst, cls)(prec, scale),
                           validity=valid, device="cpu"))


@pytest.mark.parametrize("kind", ["string", "fixed_size_binary",
                                  "decimal128", "decimal256"])
def test_encode_planes_match_jax(kind):
    """The port's planes hold the JAX package's u32 plane values (the
    sentinel and every value plane), ascending and descending."""
    jc, pc = {"string": lambda: _pair(_strings(3, long_tail=10)),
              "fixed_size_binary": lambda: _fsb_pair(3),
              "decimal128": lambda: _decimal_pair(3, 4),
              "decimal256": lambda: _decimal_pair(3, 8)}[kind]()
    for desc in (False, True):
        jp = jrf.encode_column(jc, jconfig.SortOptions(desc, True))
        pp = prf.encode_column(pc, pconfig.SortOptions(desc, True))
        assert len(pp) == len(jp)
        for j, p in zip(jp, pp):
            got = p[:N].numpy()
            np.testing.assert_array_equal(
                got & 0xFFFFFFFF if desc else got,
                np.asarray(j)[:N].astype(np.int64))


def _host_order(data, descending, nulls_first):
    """The stable order of the strings' bytes per the options: bytes
    zero-padded to one width, then the length (Python's bytes order)."""
    width = max(len(s.encode()) for s in data if s is not None)

    def key(i):
        b = data[i].encode()
        padded = b.ljust(width, b"\0")
        if descending:
            return bytes(255 - x for x in padded), -len(b)
        return padded, len(b)

    rows = sorted((i for i, s in enumerate(data) if s is not None), key=key)
    nulls = [i for i, s in enumerate(data) if s is None]
    return nulls + rows if nulls_first else rows + nulls


def test_string_sort_to_indices_matches_jax():
    """Inline, arena and empty strings, trailing zero bytes and nulls,
    descending with nulls last, through the grouped sort (L = 48)."""
    jc, pc = _pair(_strings(4, long_tail=60))
    jo = jconfig.SortOptions(True, False)
    po = pconfig.SortOptions(True, False)
    want, got = _indices(jsort.sort_to_indices(jc, jo),
                         psort.sort_to_indices(pc, po))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("descending,nulls_first", ORDERS)
@pytest.mark.parametrize("case", ["short", "long"])
def test_string_sort_to_indices_matches_host_order(case, descending,
                                                  nulls_first):
    data = _strings(4, long_tail=60 if case == "long" else 0)
    _, pc = _pair(data)
    got = psort.sort_to_indices(
        pc, pconfig.SortOptions(descending, nulls_first)).values[:N].numpy()
    np.testing.assert_array_equal(got,
                                  _host_order(data, descending, nulls_first))


def test_long_key_takes_the_grouped_sort(monkeypatch):
    """A 48-byte key splits into a 16-byte prefix group and refinement
    groups; the grouped sort equals one sort over all the planes and
    numpy's stable argsort of the bytes."""
    data = _strings(5, long_tail=120, nulls=0.0)
    _, pc = _pair(data)
    groups = prf.encode_columns_grouped([pc])
    assert [len(g) for g in groups] == [5, 4, 4, 1]
    seen = []
    real = prp.sort_by_plane_groups
    monkeypatch.setattr(prp, "sort_by_plane_groups",
                        lambda *a: seen.append(a) or real(*a))
    got = psort.sort_to_indices(pc).values[:N].numpy()
    assert len(seen) == 1
    whole = prp.sort_permutation(prf.encode_column(pc), pc.capacity, N)
    np.testing.assert_array_equal(got, whole[:N].numpy())
    raw = np.array([s.encode() for s in data], dtype=object)
    np.testing.assert_array_equal(got, np.argsort(raw, kind="stable"))


def test_string_lexsort_matches_jax():
    rng = np.random.default_rng(6)
    js_, ps_ = _pair(_strings(6, long_tail=30))
    ints = rng.integers(0, 3, N)
    valid = rng.random(N) > 0.2
    ji, pi = (tp.jax_column(ints, valid, "int32"),
              tp.port_column(ints, valid, "int32"))
    jd, pd = _decimal_pair(6, 2)
    jo = [jconfig.SortOptions(True, False), jconfig.SortOptions(),
          jconfig.SortOptions(False, False)]
    po = [pconfig.SortOptions(True, False), pconfig.SortOptions(),
          pconfig.SortOptions(False, False)]
    want, got = _indices(jsort.lexsort_to_indices([ji, js_, jd], jo, 17),
                         psort.lexsort_to_indices([pi, ps_, pd], po, 17))
    np.testing.assert_array_equal(got, want)
    whole = psort.lexsort_to_indices([pi, ps_, pd], po)
    np.testing.assert_array_equal(whole.values[:17].numpy(), want)


@pytest.mark.parametrize("kind", ["fixed_size_binary", "decimal128"])
def test_binary_and_decimal_sort_match_jax(kind):
    jc, pc = _fsb_pair(7) if kind == "fixed_size_binary" else \
        _decimal_pair(7, 4)
    want, got = _indices(
        jsort.sort_to_indices(jc, jconfig.SortOptions(True, False)),
        psort.sort_to_indices(pc, pconfig.SortOptions(True, False)))
    np.testing.assert_array_equal(got, want)


def test_rank_matches_jax_and_partition_the_host():
    jc, pc = _pair(_strings(4))
    tp.assert_column_equal(jsort.rank(jc), psort.rank(pc), "rank")
    # partition of the column taken in sorted order: a group starts where
    # the string differs from the one before
    rows = psort.sort(pc).to_pylist()
    want = [i == 0 or rows[i] != rows[i - 1] for i in range(N)]
    assert psort.partition([psort.sort(pc)]).to_pylist() == want


def test_sort_batch_by_strings_and_decimals():
    """sort_batch is the lexsort's permutation applied by take."""
    _, pc = _pair(_strings(9, long_tail=25))
    _, pd = _decimal_pair(9, 4)
    pb = pt.record_batch({"s": pc, "d": pd})
    out = psort.sort_batch(pb, ["s", "d"])
    idx = psort.lexsort_to_indices([pc, pd]).values[:N].numpy()
    assert out["s"].to_pylist() == [pc.to_pylist()[i] for i in idx]
    assert out["d"].to_pylist() == [pd.to_pylist()[i] for i in idx]


def test_struct_and_list_keys_still_raise():
    """Struct and list-view keys sort now (tests/test_torch_rowconv.py);
    what still raises: a list of strings as a sort key (its elements are
    not primitive, as in the JAX package), and struct and list-view
    columns as hashed keys (no join or partition takes them)."""
    from arrowtpu_torch.rowformat import encode as penc

    st_ = pcol.from_pylist([{"a": 1}, {"a": 2}],
                           pst.Struct((pst.Field("a", pst.int64),)),
                           device="cpu")
    lv = pcol.from_pylist([[1], [2, 3]], pst.List(pst.int64), device="cpu")
    assert psort.sort_to_indices(st_).values[:2].tolist() == [0, 1]
    assert psort.sort_to_indices(lv).values[:2].tolist() == [0, 1]
    with pytest.raises(pst.ComputeError):
        psort.sort_to_indices(pcol.from_pylist([["b"], ["a", "c"]],
                                               pst.List(pst.utf8),
                                               device="cpu"))
    for c in (st_, lv):
        with pytest.raises(pst.ComputeError):
            penc.hash_planes_of([c])


def test_two_flag_keys_pack_to_one_word():
    """TPC-H Q1's keys, two one-letter strings (each a sentinel, four word
    planes and a length plane): only the first word of each varies, so the
    twelve planes pack to one int64 sort word."""
    rng = np.random.default_rng(10)
    flags = [pcol.string_view(list(rng.choice(list(alphabet), N)),
                              device="cpu")
             for alphabet in ("RAN", "OF")]
    planes = prf.encode_columns(flags)
    assert len(planes) == 12
    live = torch.arange(flags[0].capacity) < N
    assert len(prp.packed_words(planes, live)) == 1
