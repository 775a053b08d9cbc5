"""The skew path and chunked probes of arrowtpu_torch's
`distributed_hash_join`, and the exchange of a dictionary column, against
the JAX package's on the same numpy shards (`tests/torch_skew_cases.py`).

The JAX reference is a `jax.jit` program a case on a 4-device CPU mesh
(`parallel.shard_map_batches`), computed once per module; the port runs
every case in one spawn of four gloo ranks.  Tolerances, per rank:
  * `detect_hot_buckets`: the hot-bucket mask and the hot-row flags, bit
    for bit;
  * an unchunked skew join: exact (values below the length, values under
    nulls included; validity as bools; length; zero padding; a dictionary
    column's keys so, and its values the same strings): both packages put
    the cold rows first, in exchange order, then the hot rows in probe
    order;
  * the chunked join without skew ("chunks"): exact, as above: its probe
    shard has a capacity of 512 in both packages, so both cut the same
    four 128-row chunks;
  * the chunked skew join ("skew_chunks"): the same rows as a multiset
    (sorted over every column, validity included), the same length and
    zero padding: its filtered cold side has another capacity in each
    package (a granule of 64 rows here, 128 there), so the chunks cut at
    other rows and rows come in another order;
  * the join's duplicates and overflow flags: equal;
  * the dictionary exchange: the keys exact, the dictionary kept;
  * the other key and column classes (`torch_skew_cases`: the exchange
    of int64, Decimal128, utf8 and float64 columns, a group-by on a utf8
    key with a decimal sum, joins on a utf8 and a float64 key): exact,
    float64 columns by their bits,
    and a string view's len_bound by one rule (the port keeps the longest
    string of any rank, the JAX package its static bound or, after its
    exchange, that bound rounded up to its byte matrix's 16-byte width);
    the skew path on the utf8 key in two probe chunks, whose hot build
    rows carry a decimal and a utf8 payload through the replication: as
    multisets of rows (its filtered cold side's capacity differs).
Build keys are unique except in the "dups" case, whose N:M rows fit the
`out_capacity` both packages are given; no JAX exchange bucket overflows
(its capped buckets hold 256 rows of the 512, 128 of a 128-row chunk).

The in-process cases run the port alone: `entry.join_step` with the skew
path and chunks on Zipf shards against the numpy oracle, and the float32
rule of the hot test.
"""

import dataclasses

import numpy as np
import pytest


import torch_parity as tp
import torch_skew_cases as cases
from arrowtpu import parallel
from arrowtpu.core import batch as jbt
from arrowtpu.core import bitmap as jbm
from arrowtpu.core import column as jcol
from arrowtpu.parallel.distributed import detect_hot_buckets
from arrowtpu_torch import column_to_numpy
from arrowtpu_torch import entry as pe
from arrowtpu_torch.core import limbs as plimbs
from arrowtpu_torch.interop.numpy_bridge import batch_from_numpy
from arrowtpu_torch.parallel import distributed as pdist
from arrowtpu_torch.parallel import mesh as pmesh

N = cases.NDEV


def _jax_batch(arrays):
    return jbt.record_batch({name: tp.jax_column(v, ok, "int64")
                             for name, (v, ok) in arrays.items()})


def _jax_typed_batch(arrays):
    """A JAX-package batch of a torch_skew_cases shard (as
    `cases.port_batch` builds the port's)."""
    cols = {}
    for name, a in arrays.items():
        if isinstance(a, list):
            cols[name] = jcol.from_pylist(a, jcol.st.utf8)
        elif name == "d":
            cols[name] = jcol.primitive(
                plimbs.split_int64(a[0], 4), jcol.st.Decimal128(15, 2),
                validity=jbm.from_numpy_bools(a[1]), length=len(a[0]))
        else:
            cols[name] = tp.jax_column(a[0], a[1], str(a[0].dtype))
    return jbt.record_batch(cols)


def _jax_dictionary_batch(rank, proto, dtype):
    k, k_ok, keys, ok = cases.dictionary_shard(rank)
    d = jcol.DictionaryColumn(
        jcol.primitive(keys, jcol.st.int32, validity=jbm.from_numpy_bools(ok),
                       length=len(keys)),
        proto.values, proto.value_ranks, dtype)
    return jbt.record_batch({"k": tp.jax_column(k, k_ok, "int64"), "d": d})


@pytest.fixture(scope="module")
def jax_cases():
    """{case: per-rank result} of the JAX mesh, one `jax.jit` a case
    (`tp.jit`): XLA's compile time on the CPU grows faster than the
    program, so the cases compile in 57 s as eleven programs in turn and
    in 71 s as one."""
    inputs = {
        "lb": [_jax_batch(cases.probe_shard(r)) for r in range(N)],
        **{c: [_jax_batch(cases.build_shard(r, c)) for r in range(N)]
           for c in cases.BUILD_CASES},
        "mixed": [_jax_typed_batch(cases.mixed_shard(r)) for r in range(N)],
        "text": [_jax_typed_batch(cases.text_probe_shard(r, False))
                 for r in range(N)],
        "text_hot": [_jax_typed_batch(cases.text_probe_shard(r, True))
                     for r in range(N)],
        "text_build": [_jax_typed_batch(cases.text_build_shard(r))
                       for r in range(N)]}
    dtype = jcol.st.Dictionary(jcol.st.int32, jcol.st.utf8)
    proto = jcol.dictionary_encode_host(cases.WORDS, dtype)
    inputs["db"] = [_jax_dictionary_batch(r, proto, dtype) for r in range(N)]
    stacked = {name: parallel.stack_batches(b) for name, b in inputs.items()}
    skew = dict(skew_threshold=cases.THRESHOLD,
                hot_capacity=cases.HOT_CAPACITY)

    def join(probe, rb, on="k", **kw):
        out, info = parallel.distributed_hash_join(
            probe, rb, [on], num_partitions=N, axis_name="d", **kw)
        return out, info.duplicates, info.overflow

    def with_d(lb, db):
        return jbt.RecordBatch(
            jcol.st.Schema(tuple(lb.schema.fields) + (db.schema.field("d"),)),
            lb.columns + (db["d"],))

    # case: (its inputs, its body)
    bodies = {
        "hot": (("lb",), lambda lb: detect_hot_buckets(
            lb, ["k"], axis_name="d", threshold_frac=cases.THRESHOLD)),
        "skew": (("lb", "db", "unique"),
                 lambda lb, db, rb: join(with_d(lb, db), rb, **skew)),
        "skew_chunks": (("lb", "dups"), lambda lb, rb: join(
            lb, rb, **skew, probe_chunks=cases.CHUNKS,
            out_capacity=cases.OUT_CAPACITY)),
        "hot_overflow": (("lb", "overflow"),
                         lambda lb, rb: join(lb, rb, **skew)),
        "chunks": (("lb", "db", "unique"), lambda lb, db, rb: join(
            with_d(lb, db), rb, probe_chunks=cases.CHUNKS)),
        "dictionary": (("db",), lambda db: parallel.exchange(
            db, ["k"], axis_name="d", num_partitions=N)),
        "mixed_exchange": (("mixed",), lambda b: parallel.exchange(
            b, ["k"], axis_name="d", num_partitions=N)),
        "mixed_group_by": (("mixed",), lambda b: parallel.distributed_group_by(
            b, ["s"], cases.MIXED_AGGS, num_partitions=N, axis_name="d")),
        "text_join": (("text", "text_build"),
                      lambda lb, rb: join(lb, rb, "s")),
        "text_skew": (("text_hot", "text_build"), lambda lb, rb: join(
            lb, rb, "s", **skew, probe_chunks=2)),
        "float_join": (("text", "text_build"),
                       lambda lb, rb: join(lb, rb, "f")),
    }
    mesh = parallel.make_mesh(N)
    return {name: parallel.unstack_batches(tp.jit(
        lambda *a, body=body: parallel.shard_map_batches(body, mesh, *a))(
            *(stacked[i] for i in names)))
        for name, (names, body) in bodies.items()}


@pytest.fixture(scope="module")
def port_cases():
    """{case: per-rank result} of the port, four spawned gloo ranks."""
    per_rank = pmesh.run(cases.port_rank, N, "cpu")
    return {name: [r[name] for r in per_rank] for name in per_rank[0]}


def _rows(arrays):
    """The rows of [(values, valid) of each column] in one canonical
    order: sorted over every column's validity and value."""
    keys = [a for v, ok in arrays for a in (ok, v)]
    order = np.lexsort(keys[::-1])
    return [a[order] for a in keys]


def _assert_batch_equal(jb, pb):
    """Exact, a dictionary column by its keys and its strings."""
    assert [f.name for f in jb.schema.fields] == pb.schema.names
    for f in jb.schema.fields:
        j, p = jb[f.name], pb[f.name]
        if isinstance(j, jcol.DictionaryColumn):
            assert str(p.dtype) == str(j.dtype)
            tp.assert_column_equal(j.keys, p.keys, f"{f.name} keys")
            assert p.to_pylist() == j.to_pylist()
        else:
            tp.assert_column_equal(j, p, f.name)


def _assert_same_rows(jb, pb):
    """A chunked join's output: per rank the same rows as a multiset."""
    assert [f.name for f in jb.schema.fields] == pb.schema.names
    jcols = [tp.jax_to_numpy(jb[f.name]) for f in jb.schema.fields]
    pcols = [column_to_numpy(c) for c in pb.columns]
    assert [n for *_, n in pcols] == [n for *_, n in jcols]
    for f, c in zip(jb.schema.fields, pb.columns):
        assert str(c.dtype) == str(f.dtype)
        tp.assert_zero_padding(c)
    for got, want in zip(_rows([(v, ok) for v, ok, _ in pcols]),
                         _rows([(v, ok) for v, ok, _ in jcols])):
        np.testing.assert_array_equal(got, want)


def _assert_flags(jax_result, port_result):
    _, jdup, jovf = jax_result
    _, pdup, povf = port_result
    assert (pdup, povf) == (bool(jdup), bool(jovf))


def test_hot_buckets_match_the_jax_mesh(jax_cases, port_cases):
    for (jhot, jflag), (phot, pflag) in zip(jax_cases["hot"],
                                            port_cases["hot"]):
        np.testing.assert_array_equal(phot, np.asarray(jhot))
        np.testing.assert_array_equal(pflag, np.asarray(jflag))
    # the hot key's bucket and the null keys' bucket
    assert np.asarray(jax_cases["hot"][0][0]).sum() == 2


@pytest.mark.parametrize("case", ["skew", "hot_overflow"])
def test_skew_join_matches_the_jax_mesh_exactly(jax_cases, port_cases, case):
    for j, p in zip(jax_cases[case], port_cases[case]):
        _assert_batch_equal(j[0], p[0])
        _assert_flags(j, p)
    assert sum(p[0].length for p in port_cases[case]) > 0
    overflow = [p[2] for p in port_cases[case]]
    assert overflow == ([False, True, False, False] if case == "hot_overflow"
                        else [False] * N)


@pytest.mark.parametrize("case", ["skew_chunks", "chunks"])
def test_chunked_join_matches_the_jax_mesh_as_multisets(jax_cases,
                                                        port_cases, case):
    """"chunks" is held exactly (both packages cut the same chunks);
    "skew_chunks" as per-rank multisets."""
    for j, p in zip(jax_cases[case], port_cases[case]):
        if case == "chunks":
            _assert_batch_equal(j[0], p[0])
        else:
            _assert_same_rows(j[0], p[0])
        _assert_flags(j, p)
    dups = [p[1] for p in port_cases[case]]
    assert dups == [case == "skew_chunks"] * N
    assert sum(p[0].length for p in port_cases[case]) > 0


def _assert_typed_batch_equal(jb, pb):
    """Exact, as `tp.assert_batch_equal`, with float64 columns also by
    their bits (signed zeros, NaN payloads) and a string view's len_bound
    by this rule: the port keeps the longest string of every rank, the
    JAX package its static bound or, after its exchange, the byte
    matrix's width (that bound rounded up to 16 bytes)."""
    from arrowtpu_torch.core import column as pcol
    from arrowtpu_torch.ops.strings import matrix_width

    assert [f.name for f in jb.schema.fields] == pb.schema.names
    for f in jb.schema.fields:
        j, p = jb[f.name], pb[f.name]
        if isinstance(p, pcol.StringViewColumn):
            assert p.len_bound <= j.len_bound == matrix_width(j.len_bound) \
                or p.len_bound == j.len_bound, (p.len_bound, j.len_bound)
            assert matrix_width(p.len_bound) == matrix_width(j.len_bound)
            p = dataclasses.replace(p, len_bound=j.len_bound)
        tp.assert_column_equal(j, p, f.name)
        if str(p.dtype) == "float64":
            np.testing.assert_array_equal(
                column_to_numpy(p)[0].view(np.uint64),
                tp.jax_to_numpy(j)[0].view(np.uint64), err_msg=f.name)


def _typed_rows(b, pkg):
    """A batch's rows as sorted tuples of Python values (float64 as
    bits), for a multiset comparison of batches with string columns."""
    cols = []
    for c in b.columns:
        if str(c.dtype) == "float64":
            v, ok, n = (column_to_numpy(c) if pkg == "port"
                        else tp.jax_to_numpy(c))
            cols.append([int(x) if o else None
                         for x, o in zip(v.view(np.uint64), ok)])
        else:
            cols.append(c.to_pylist())
    return sorted(zip(*cols), key=repr)


TYPED_EXACT = ["mixed_exchange", "mixed_group_by", "text_join",
               "float_join"]


@pytest.mark.parametrize("case", TYPED_EXACT)
def test_typed_cases_match_the_jax_mesh_exactly(jax_cases, port_cases,
                                               case):
    """The exchange of (int64, Decimal128, utf8, float64) columns, the
    group-by on a utf8 key with a decimal sum, joins on a utf8 and on a
    float64 key: per rank, exact."""
    mixed = case.startswith("mixed")
    for j, p in zip(jax_cases[case], port_cases[case]):
        _assert_typed_batch_equal(j if mixed else j[0], p if mixed else p[0])
        if not mixed:
            _assert_flags(j, p)
    assert all((p if mixed else p[0]).length > 0
               for p in port_cases[case])


def test_text_skew_chunks_match_the_jax_mesh_as_multisets(jax_cases,
                                                         port_cases):
    """The skew path on a utf8 key in two probe chunks, its hot build
    rows' decimal and string payloads replicated (arenas rebased by
    rank): per rank the same rows as the JAX mesh's, as multisets (the
    filtered cold side's capacity differs, so the chunks cut at other
    rows), with equal lengths, flags and types, and zero padding."""
    for j, p in zip(jax_cases["text_skew"], port_cases["text_skew"]):
        jb, pb = j[0], p[0]
        assert [f.name for f in jb.schema.fields] == pb.schema.names
        assert [str(f.dtype) for f in jb.schema.fields] == [
            str(c.dtype) for c in pb.columns]
        for c in pb.columns:
            tp.assert_zero_padding(c)
        assert pb.length == int(jb.length) > 0
        assert _typed_rows(pb, "port") == _typed_rows(jb, "jax")
        _assert_flags(j, p)


def test_dictionary_exchange_matches_the_jax_mesh(jax_cases, port_cases):
    for j, (p, kept) in zip(jax_cases["dictionary"],
                            port_cases["dictionary"]):
        assert kept
        tp.assert_column_equal(j["k"], p["k"], "k")
        tp.assert_column_equal(j["d"].keys, p["d"].keys, "d keys")
        assert p["d"].to_pylist() == j["d"].to_pylist()


@pytest.fixture
def group():
    with pmesh.process_group(0, 1, "cpu") as g:
        yield g


@pytest.mark.parametrize("kw", [dict(skew_threshold=0.01, probe_chunks=4),
                                dict(skew_threshold=0.01),
                                dict(probe_chunks=4), {}])
def test_join_step_on_zipf_shards_against_the_oracle(group, kw):
    shards = pe.example_join_shards(0, 1, 4096, 512, key_range=640,
                                    key_nulls=0.05, rv_nulls=0.1,
                                    permute_build=True, zipf=1.0)
    left, right = (batch_from_numpy(a, device="cpu") for a in shards)
    assert pe.check_join_output([pe.join_step(left, right, group, **kw)],
                                pe.join_oracle([shards])) > 0


def test_zipf_keys_follow_the_inverse_cdf():
    """Key i is the first whose cumulative weight 1 / (j + 1) summed over
    j <= i exceeds the draw; key 0 carries 1 / H(key_range) of the rows."""
    u = np.random.default_rng(3).random(200_000)
    keys = pe.zipf_keys(u, 50, 1.0)
    cdf = np.cumsum(1.0 / np.arange(1, 51))
    cdf /= cdf[-1]
    np.testing.assert_array_equal(keys, np.searchsorted(cdf, u, "right"))
    assert abs((keys == 0).mean() - 1 / np.sum(1.0 / np.arange(1, 51))) < 0.01


def test_hot_test_compares_in_float32(group):
    """A bucket at the border: 63 rows of 90 at a threshold of 0.7.  In
    float64 0.7 * 90 is 62.99999999999999, so the bucket would be hot; in
    float32, as the JAX package compares, it is 63.0 and the bucket is
    not.  64 rows of 90 are hot either way."""
    for same, want in ((63, 0), (64, 1)):
        assert (same > np.float32(0.7) * np.float32(90)) == bool(want)
        assert same > 0.7 * 90
        k = np.concatenate([np.zeros(same, np.int64),
                            np.arange(1, 91 - same)])
        batch = batch_from_numpy({"k": (k, None)}, device="cpu")
        hot, flag = pdist.detect_hot_buckets(batch, ["k"], group=group,
                                             threshold_frac=0.7)
        assert int(hot.sum()) == want
        assert int(flag.sum()) == same * want
