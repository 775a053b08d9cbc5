"""arrowtpu_torch's batch utilities of the external sort against arrowtpu on
the same inputs: `interleave` (ops/concat.py) over every class it takes,
`merge_indices` / `merge_batches` (ops/merge.py), `slice_` / `slice_batch`
/ `BatchCoalescer` (ops/coalesce.py) and `equal_columns` / `equal_batches`
(ops/equal.py).

Tolerance: exact.  Columns are compared by `torch_parity.
assert_column_equal` (values under nulls included, validity as bools,
zero padding on the port's side), merge pairs as int32 arrays over their
length.  The packages pad to different capacities (64-row granule here,
128 there), so a row index reaches at most a source's padding in the
port's capacity, where both give a null row.  Equality is held to the JAX
package's answer on each class, with one differing value under a valid
row (False) and under a null row (True); floats compare by their bits in
the port (arrow-data's memcmp), so the float case avoids NaN and -0.0,
which the JAX package compares by value at 32 bits.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_parity as tp
from torch_parity import release_jax_caches  # noqa: F401
import arrowtpu as at
import arrowtpu.schema as js
from arrowtpu import ops as jops
from arrowtpu.config import SortOptions as JOpts
from arrowtpu.core import batch as jbt
from arrowtpu.core import bitmap as jbm
from arrowtpu.core import column as jcol
from arrowtpu.ops import coalesce as jco
from arrowtpu.ops import equal as jeq
from arrowtpu.ops import merge as jmerge
from arrowtpu.ops.concat import interleave as jinterleave

import arrowtpu_torch as pt
import arrowtpu_torch.schema as ps
from arrowtpu_torch import ops as pops
from arrowtpu_torch.config import SortOptions as POpts
from arrowtpu_torch.config import round_up
from arrowtpu_torch.core import batch as pbt
from arrowtpu_torch.core import column as pcol
from test_torch_nested import _values

LENGTHS = (50, 7, 90)  # three uneven sources
N = 120


def _pair(kind, seed, n):
    rng = np.random.default_rng(seed)
    jdt, pdt, vals = _values(kind, rng, n)
    return (jcol.from_pylist(vals, jdt),
            pcol.from_pylist(vals, pdt, device="cpu"), vals)


def _index_pair(values, valid):
    values = np.asarray(values, np.int32)
    return (at.primitive(values, js.int32,
                         validity=jbm.from_numpy_bools(valid),
                         length=len(values)),
            pt.primitive(values, ps.int32, validity=valid, device="cpu"))


def _indices(rng, n):
    """(source, row) index columns: rows mostly live, some on a source's
    padding within the port's capacity; nulls in both columns."""
    src = rng.integers(0, len(LENGTHS), n)
    lens = np.asarray(LENGTHS)[src]
    row = (rng.random(n) * lens).astype(np.int64)
    pad = rng.random(n) < 0.05
    row[pad] = np.minimum(lens[pad], np.array(
        [round_up(x) - 1 for x in lens[pad]]))
    return (_index_pair(src, rng.random(n) > 0.1),
            _index_pair(row, rng.random(n) > 0.1))


@pytest.mark.parametrize("kind", ["decimal128", "utf8", "date32", "timestamp",
                                  "fsb9"])
def test_interleave_matches_jax(kind):
    sources = [_pair(kind, i, n) for i, n in enumerate(LENGTHS)]
    (jsrc, psrc), (jrow, prow) = _indices(np.random.default_rng(9), N)
    got = pops.interleave([p for _, p, _ in sources], psrc, prow)
    want = jinterleave([j for j, _, _ in sources], jsrc, jrow)
    tp.assert_column_equal(want, got, kind)


def test_interleave_of_booleans_matches_jax():
    rng = np.random.default_rng(10)
    sources = [(rng.random(n) < 0.5, rng.random(n) > 0.2) for n in LENGTHS]
    (jsrc, psrc), (jrow, prow) = _indices(rng, N)
    got = pops.interleave([tp.port_column(v, ok, "bool")
                           for v, ok in sources], psrc, prow)
    want = jinterleave([tp.jax_column(v, ok, "bool") for v, ok in sources],
                       jsrc, jrow)
    tp.assert_column_equal(want, got, "bool")


SCHEMA = [("k", "int32"), ("s", "utf8"), ("d", "decimal128"), ("b", "bool")]


def _sorted_sources(by, opts):
    """Three uneven batches (k int32 with ties and nulls, s utf8, d
    Decimal128, b bool), each sorted by `by` under `opts` in the port, and
    the same rows as JAX batches (built from the sorted rows: a JAX sort
    compiles per column class)."""
    jbatches, pbatches = [], []
    for i, n in enumerate(LENGTHS):
        rng = np.random.default_rng(30 + i)
        cols, jdts = {}, {}
        for name, kind in SCHEMA:
            if kind == "int32":
                jdt, pdt, vals = js.int32, ps.int32, [
                    None if rng.random() < 0.2 else int(rng.integers(-3, 4))
                    for _ in range(n)]
            elif kind == "bool":
                jdt, pdt, vals = js.Boolean(), ps.bool_, [
                    None if rng.random() < 0.1 else bool(rng.random() < .5)
                    for _ in range(n)]
            else:
                jdt, pdt, vals = _values(kind, rng, n)
            cols[name] = pcol.from_pylist(vals, pdt, device="cpu")
            jdts[name] = jdt
        pb = pops.sort_batch(pbt.record_batch(cols), by,
                             [POpts(*o) for o in opts])
        pbatches.append(pb)
        jbatches.append(jbt.record_batch({
            name: jcol.from_pylist(pb[name].to_pylist(), jdts[name])
            for name, _ in SCHEMA}))
    return jbatches, pbatches


def _jax_merge(batches, by, options):
    """The JAX package's merge index and `merge_n` of every column, under
    one `jax.jit` (one compile in place of one a primitive)."""
    def merge(batches):
        pairs = jmerge.merge_indices([[b[n] for n in by] for b in batches],
                                     options)
        return pairs, [jmerge.merge_n([b.columns[j] for b in batches], *pairs)
                       for j in range(len(SCHEMA))]
    return tp.jit(merge)(batches)


def test_merge_matches_jax():
    by, opts = ["k", "s"], [(True, False), (False, True)]
    jbatches, pbatches = _sorted_sources(by, opts)
    jo, po = [JOpts(*o) for o in opts], [POpts(*o) for o in opts]
    jpairs, jmerged = _jax_merge(jbatches, by, jo)
    ppairs = pops.merge_indices([[b[n] for n in by] for b in pbatches], po)
    total = sum(LENGTHS)
    for jc, pc in zip(jpairs, ppairs):
        assert pc.length == total == int(jc.length)
        assert pc.capacity == round_up(total) and not pc.values[total:].any()
        np.testing.assert_array_equal(pc.values[:total].numpy(),
                                      np.asarray(jc.values)[:total])
    merged = pops.merge_batches(pbatches, by, po)
    for (name, _), jc in zip(SCHEMA, jmerged):
        tp.assert_column_equal(jc, merged[name], name)
        tp.assert_column_equal(jc, pops.merge_n([b[name] for b in pbatches],
                                                *ppairs), name)
    # earlier sources win ties, and the merge is the whole sort
    whole = pops.sort_batch(pops.concat_batches(pbatches), by, po)
    assert bool(pops.equal_batches(merged, whole))


def test_sorted_runs_step_is_one_sort():
    """entry.sorted_runs_step, the external sort of `chip_smoke.py` phase
    20 at a small size (lineitem less its two dictionary columns), equals
    one sort_batch of the whole."""
    from arrowtpu_torch import entry as pe

    li = pe.lineitem_batch(pe.example_lineitem_arrays(0.0005), "cpu")
    table = pbt.record_batch({n: li[n] for n in li.schema.names if n not in
                              ("l_shipinstruct", "l_shipmode")})
    by = ["l_shipdate", "l_extendedprice", "l_orderkey", "l_linenumber"]
    opts = [POpts(), POpts(True), POpts(), POpts()]
    merged, stages = pe.sorted_runs_step(table, by, opts, 3)
    assert [r.length for r in stages["sorted"]] == [
        r.length for r in stages["slices"]] and len(stages["slices"]) == 3
    assert merged.length == table.length
    assert bool(pops.equal_batches(merged, pops.sort_batch(table, by, opts)))


@pytest.mark.parametrize("kind", ["dictionary", "struct"])
def test_dictionary_and_struct_merges_raise(kind):
    sources = [_pair(kind, i, n) for i, n in enumerate(LENGTHS)]
    (jsrc, psrc), (jrow, prow) = _indices(np.random.default_rng(11), N)
    with pytest.raises(js.ComputeError):
        jinterleave([j for j, _, _ in sources], jsrc, jrow)
    with pytest.raises(ps.ComputeError):
        pops.interleave([p for _, p, _ in sources], psrc, prow)
    pbatches = [pbt.record_batch({"k": pt.primitive(
        np.arange(n), device="cpu"), "x": p}) for (_, p, _), n in
        zip(sources, LENGTHS)]
    with pytest.raises(ps.ComputeError):
        pops.merge_batches(pbatches, ["k"])


SLICED = ["utf8", "dictionary", "decimal64", "date32"]


@pytest.mark.parametrize("offset,length", [(0, 64), (17, 40), (100, 50),
                                           (130, 5)])
def test_slice_matches_jax(offset, length):
    for kind in SLICED:
        j, p, _ = _pair(kind, 12, N)
        got = pops.slice_(p, offset, length)
        tp.assert_column_equal(jco.slice_(j, offset, length), got, kind)
        assert got.capacity == round_up(max(got.length, 1))
    jn, pn = jcol.null_column(N), pt.null_column(N, device="cpu")
    tp.assert_column_equal(jco.slice_(jn, offset, length),
                           pops.slice_(pn, offset, length), "null")


def _batch_pair(seed, n):
    cols = {kind: _pair(kind, seed, n)[:2] for kind in ("utf8", "decimal128")}
    rng = np.random.default_rng(seed)
    v, ok = rng.integers(-9, 9, n), rng.random(n) > 0.2
    cols["i"] = (tp.jax_column(v, ok, "int64"), tp.port_column(v, ok,
                                                               "int64"))
    return (jbt.record_batch({k: c[0] for k, c in cols.items()}),
            pbt.record_batch({k: c[1] for k, c in cols.items()}))


def test_batch_coalescer_matches_jax():
    """Pushed batches of 50, 7 and 90 rows (the last through a mask),
    target 64: two full batches and a remainder of 19."""
    pairs = [_batch_pair(50 + i, n) for i, n in enumerate(LENGTHS)]
    keep = np.random.default_rng(13).random(LENGTHS[-1]) > 0.1
    jc = jco.BatchCoalescer(pairs[0][0].schema, 64)
    pc = pops.BatchCoalescer(pairs[0][1].schema, 64)
    for (jb, pb) in pairs[:-1]:
        jc.push_batch(jb)
        pc.push_batch(pb)
    jc.push_batch_with_filter(pairs[-1][0], at.boolean(keep))
    pc.push_batch_with_filter(pairs[-1][1], pt.boolean(keep, device="cpu"))
    got = []
    while (b := pc.next_completed_batch()) is not None:
        tp.assert_batch_equal(jc.next_completed_batch(), b)
        got.append(b.length)
    assert jc.next_completed_batch() is None
    rest = pc.finish()
    tp.assert_batch_equal(jc.finish(), rest)
    total = sum(LENGTHS[:-1]) + int(keep.sum())
    assert got == [64] * (total // 64) and rest.length == total % 64
    assert rest.capacity == round_up(rest.length)
    assert pc.finish() is None and jc.finish() is None


EQUAL_KINDS = ["utf8", "decimal128", "date32", "dictionary", "list",
               "struct", "fsl4", "fsb9"]


def _changed(kind, vals, i):
    """vals with row i (valid) given another value."""
    other = list(vals)
    j = next(k for k in range(i + 1, len(vals)) if vals[k] is not None
             and vals[k] != vals[i])
    other[i] = vals[j]
    return other


@pytest.mark.parametrize("kind", EQUAL_KINDS)
def test_equal_columns_matches_jax(kind):
    rng = np.random.default_rng(14)
    jdt, pdt, vals = _values(kind, rng, N)
    i = next(k for k, v in enumerate(vals) if v is not None)
    cases = {"same": (vals, True), "one valid row differs":
             (_changed(kind, vals, i), False)}
    for label, (other, want) in cases.items():
        ja, pa = jcol.from_pylist(vals, jdt), pcol.from_pylist(
            vals, pdt, device="cpu")
        # b built another way: taken through an identity index
        jb = jops.take(jcol.from_pylist(other, jdt),
                       at.primitive(np.arange(N, dtype=np.int32), js.int32))
        pb = pops.take(pcol.from_pylist(other, pdt, device="cpu"),
                       pt.primitive(np.arange(N, dtype=np.int32), ps.int32,
                                    device="cpu"))
        got = pops.equal_columns(pa, pb)
        assert got.shape == () and got.dtype == torch.bool
        assert bool(got) == bool(jeq.equal_columns(ja, jb)) == want, label


@pytest.mark.parametrize("kind", ["int64", "float64", "bool"])
def test_equal_under_null_rows_matches_jax(kind):
    """One differing value under a null row is equal; under a valid row
    not; another dtype is not."""
    rng = np.random.default_rng(15)
    v = (rng.random(N) < 0.5 if kind == "bool"
         else rng.integers(-9, 9, N).astype(kind))
    ok = rng.random(N) > 0.2
    null_row = int(np.flatnonzero(~ok)[0])
    valid_row = int(np.flatnonzero(ok)[0])
    for row, want in ((null_row, True), (valid_row, False)):
        w = v.copy()
        w[row] = ~w[row] if kind == "bool" else w[row] + 1
        got = pops.equal_columns(tp.port_column(v, ok, kind),
                                 tp.port_column(w, ok, kind))
        jgot = jeq.equal_columns(tp.jax_column(v, ok, kind),
                                 tp.jax_column(w, ok, kind))
        assert bool(got) == bool(jgot) == want
    if kind != "bool":
        other = "int32" if kind == "int64" else "float32"
        assert not bool(pops.equal_columns(
            tp.port_column(v, ok, kind),
            tp.port_column(v.astype(other), ok, other)))


def test_equal_batches_matches_jax():
    (ja, pa), (jb, pb) = _batch_pair(60, N), _batch_pair(60, N)
    assert bool(pops.equal_batches(pa, pb)) == bool(
        jeq.equal_batches(ja, jb)) is True
    (jc, pc) = _batch_pair(61, N)
    assert bool(pops.equal_batches(pa, pc)) == bool(
        jeq.equal_batches(ja, jc)) is False
    renamed = pbt.RecordBatch(ps.Schema(tuple(
        dataclasses.replace(f, name=f.name + "_") for f in pa.schema.fields)),
        pa.columns)
    assert not bool(pops.equal_batches(pa, renamed))
    # the float bits rule: NaN equals NaN, -0.0 does not equal +0.0
    f = np.array([np.nan, 0.0, 1.5])
    g = np.array([np.nan, -0.0, 1.5])
    ok = np.ones(3, bool)
    assert bool(pops.equal_columns(tp.port_column(f, ok, "float64"),
                                   tp.port_column(f, ok, "float64")))
    assert not bool(pops.equal_columns(tp.port_column(f, ok, "float64"),
                                       tp.port_column(g, ok, "float64")))


def test_interleave_of_runs_sharing_an_arena():
    """Runs sliced from one string column share its arena: the output
    keeps that arena (no copy) and reads the same strings."""
    _, p, vals = _pair("utf8", 16, N)
    runs = [pops.slice_(p, 0, 50), pops.slice_(p, 50, 7),
            pops.slice_(p, 57, 63)]
    starts = [0, 50, 57]
    rng = np.random.default_rng(17)
    src = rng.integers(0, 3, N)
    row = (rng.random(N) * np.array([50, 7, 63])[src]).astype(np.int64)
    got = pops.interleave(runs, pt.primitive(src, ps.int32, device="cpu"),
                          pt.primitive(row, ps.int32, device="cpu"))
    assert got.arena is p.arena
    assert got.to_pylist() == [vals[starts[s] + r] for s, r in zip(src, row)]
