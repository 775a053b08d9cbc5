"""arrowtpu_torch.formats.parquet_scan, parquet_push and parquet_record
against arrowtpu.formats and pyarrow.

Tolerance: exact.  RowSelection algebra gives the JAX package's selectors;
a scan with the same predicates gives the JAX scan's rows (values,
validity as bools, length, zero padding) and every ScanMetrics field, on
three schemas (the JAX filter compiles once a schema): sorted `a` with a
payload `b`, its projection to `b`, and a nullable `x`.  The overlapped
scan gives the sequential scan's rows and metrics, and an abandoned one
joins its producer (no timing is asserted).  The push decoder asks for
the JAX decoder's byte ranges, in order, and gives its batches;
`write_rows` writes the JAX bytes and `read_rows` reads its Rows.  Every
input is drawn from a seed with numpy.
"""

import threading

import numpy as np
import pytest

import torch_parity as tp
from torch_parity import release_jax_caches  # noqa: F401
import arrowtpu as at
from arrowtpu import ops as jops
from arrowtpu.formats import parquet as jpq
from arrowtpu.formats import parquet_cdc as jcdc
from arrowtpu.formats import parquet_push as jpush
from arrowtpu.formats import parquet_record as jrec
from arrowtpu.formats import parquet_scan as jsc

import arrowtpu_torch as pt
from arrowtpu_torch import ops as pops
from arrowtpu_torch.formats import parquet as ppq
from arrowtpu_torch.formats import parquet_cdc as pcdc
from arrowtpu_torch.formats import parquet_push as ppush
from arrowtpu_torch.formats import parquet_record as prec
from arrowtpu_torch.formats import parquet_scan as psc


def _selectors(sel):
    return [(s.row_count, s.skip) for s in sel.selectors]


def test_row_selection_algebra_against_jax():
    rng = np.random.default_rng(9)
    a, b = rng.random(600) < 0.4, rng.random(600) < 0.6
    ja, jb = jsc.RowSelection.from_mask(a), jsc.RowSelection.from_mask(b)
    pa_, pb_ = psc.RowSelection.from_mask(a), psc.RowSelection.from_mask(b)
    assert _selectors(pa_) == _selectors(ja)
    assert _selectors(pa_.intersection(pb_)) == _selectors(
        ja.intersection(jb))
    assert _selectors(pa_.union(pb_)) == _selectors(ja.union(jb))
    inner = rng.random(int(a.sum())) < 0.5
    assert _selectors(pa_.and_then(psc.RowSelection.from_mask(inner))) == \
        _selectors(ja.and_then(jsc.RowSelection.from_mask(inner)))
    for k in (0, 17, 300, 600, 700):
        ph, pt_ = pa_.split_off(k)
        jh, jt = ja.split_off(k)
        assert (_selectors(ph), _selectors(pt_)) == (_selectors(jh),
                                                     _selectors(jt))
    ranges = [(2, 5), (9, 40), (41, 50)]
    assert _selectors(psc.RowSelection.from_ranges(ranges, 64)) == \
        _selectors(jsc.RowSelection.from_ranges(ranges, 64))
    assert list(pa_.iter_ranges()) == list(ja.iter_ranges())
    np.testing.assert_array_equal(pa_.to_mask(650), ja.to_mask(650))
    assert (pa_.row_count(), pa_.total_rows(), pa_.selects_any()) == (
        ja.row_count(), ja.total_rows(), ja.selects_any())
    assert psc.RowSelection([psc.RowSelector.select(3),
                             psc.RowSelector.select(2),
                             psc.RowSelector.skip_(0),
                             psc.RowSelector.skip_(4)]) == \
        psc.RowSelection([psc.RowSelector(5, False),
                          psc.RowSelector(4, True)])


def _sorted_file(with_bloom=False, n_rows=4000, n_groups=4, cdc=False):
    """Sorted int64 `a` (min / max prune it) and payload `b` (even values
    over a wide range: only a bloom filter prunes an equality on it), the
    port's bytes equal to the JAX writer's.  With `cdc` the pages are cut
    by content, so `a`'s and `b`'s page boundaries differ."""
    rng = np.random.default_rng(5)
    a = np.arange(n_rows, dtype=np.int64)
    b = rng.integers(-10**6, 10**6, n_rows) * 2
    per = n_rows // n_groups
    kw = dict(data_page_row_limit=per // 4, write_page_index=True,
              dictionary_enabled=False,
              bloom_filter_columns=("b",) if with_bloom else ())
    out = []
    for mod, pkg in ((ppq, pt), (jpq, at)):
        if cdc:
            kw["cdc_options"] = (pcdc if mod is ppq else jcdc).CdcOptions(
                256, 1024)
        batches = [pkg.record_batch({
            "a": tp.port_column(a[g * per:(g + 1) * per], None, "int64")
            if pkg is pt else tp.jax_column(a[g * per:(g + 1) * per], None,
                                            "int64"),
            "b": tp.port_column(b[g * per:(g + 1) * per], None, "int64")
            if pkg is pt else tp.jax_column(b[g * per:(g + 1) * per], None,
                                            "int64")})
            for g in range(n_groups)]
        out.append(mod.write_parquet(batches,
                                     props=mod.WriterProperties(**kw)))
    assert out[0] == out[1]
    return out[0], a, b


def _nullable_file():
    vals = [i if i % 7 else None for i in range(1000)]
    props = dict(data_page_row_limit=250, write_page_index=True,
                 dictionary_enabled=False)
    jb = at.record_batch({"x": at.from_pylist(vals, at.schema.int64)})
    pb = pt.record_batch({"x": pt.from_pylist(vals, pt.schema.int64,
                                              device="cpu")})
    buf = ppq.write_parquet([pb], props=ppq.WriterProperties(**props))
    assert buf == jpq.write_parquet([jb], props=jpq.WriterProperties(**props))
    return buf


def _preds(mod, spec):
    return [mod.ColumnPredicate(*p) for p in spec]


SCANS = {
    "statistics": (False, None, [("a", "lt", 500)]),
    "page_index": (False, None, [("a", "eq", 1500)]),
    "bloom_filter": (True, None, [("b", "eq", 12345)]),
    "three_predicates": (False, None, [("a", "gt_eq", 700), ("a", "lt", 2100),
                                       ("b", "gt", 0)]),
    "projection": (False, ["b"], [("a", "lt", 10)]),
    "empty": (False, None, [("a", "lt", -5)]),
    "no_predicate": (False, None, []),
}


@pytest.mark.parametrize("case", list(SCANS))
def test_scan_rows_and_metrics_equal_jax(case):
    bloom, columns, spec = SCANS[case]
    buf, a, b = _sorted_file(with_bloom=bloom)
    jout, jm = jsc.scan_parquet(buf, columns, predicates=_preds(jsc, spec))
    pout, pm = psc.scan_parquet(buf, columns, predicates=_preds(psc, spec),
                                device="cpu")
    tp.assert_batch_equal(jout, pout)
    assert pm.asdict() == jm.asdict()
    keep = np.ones(len(a), bool)
    for col, op, v in spec:
        x = {"a": a, "b": b}[col]
        keep &= {"lt": x < v, "eq": x == v, "gt_eq": x >= v,
                 "gt": x > v}[op]
    for name in columns or ["a", "b"]:
        assert pout[name].to_pylist() == {"a": a, "b": b}[name][
            keep].tolist()


def test_scan_of_pages_cut_by_content_equals_jax():
    """Pages whose row ranges differ between columns: the pages of `b`
    kept for `a`'s selection hold rows it does not select, which the scan
    drops with the filter after the upload, as the JAX scan does."""
    buf, a, b = _sorted_file(n_groups=1, cdc=True)
    pf = ppq.ParquetFile(buf, device="cpu")
    firsts = {n: [r for (_, _, r) in pf.offset_index(0, n)]
              for n in ("a", "b")}
    assert firsts["a"] != firsts["b"], firsts
    spec = [("a", "gt_eq", 130), ("a", "lt", 2100)]
    jout, jm = jsc.scan_parquet(buf, predicates=_preds(jsc, spec))
    pout, pm = psc.scan_parquet(buf, predicates=_preds(psc, spec),
                                device="cpu")
    tp.assert_batch_equal(jout, pout)
    assert pm.asdict() == jm.asdict()
    assert pm.pages_skipped > 0
    keep = (a >= 130) & (a < 2100)
    assert pout["a"].to_pylist() == a[keep].tolist()
    assert pout["b"].to_pylist() == b[keep].tolist()


def test_scan_of_strings_in_pages_cut_by_content():
    """The same with a utf8 column, whose pages' rows differ from `a`'s
    too: the port's scan against numpy (the JAX scan's string filter is
    left out of this file to keep to its three schemas)."""
    rng = np.random.default_rng(6)
    a = np.arange(3000, dtype=np.int64)
    s = [f"r{v}" * (1 + v % 4) for v in rng.integers(0, 999, 3000).tolist()]
    buf = ppq.write_parquet([pt.record_batch({
        "a": tp.port_column(a, None, "int64"),
        "s": pt.from_pylist(s, pt.schema.utf8, device="cpu")})],
        props=ppq.WriterProperties(write_page_index=True,
                                   dictionary_enabled=False,
                                   cdc_options=pcdc.CdcOptions(256, 1024)))
    pf = ppq.ParquetFile(buf, device="cpu")
    assert [r for (_, _, r) in pf.offset_index(0, "a")] != \
        [r for (_, _, r) in pf.offset_index(0, "s")]
    pout, pm = psc.scan_parquet(buf, predicates=[
        psc.ColumnPredicate("a", "gt_eq", 301),
        psc.ColumnPredicate("a", "lt", 1777)], device="cpu")
    assert pm.pages_skipped > 0
    assert pout["a"].to_pylist() == list(range(301, 1777))
    assert pout["s"].to_pylist() == s[301:1777]


def test_scan_with_nulls_and_arrow_predicate():
    buf = _nullable_file()
    jout, jm = jsc.scan_parquet(buf, predicates=[
        jsc.ColumnPredicate("x", "lt", 100)])
    pout, pm = psc.scan_parquet(buf, predicates=[
        psc.ColumnPredicate("x", "lt", 100)], device="cpu")
    tp.assert_batch_equal(jout, pout)
    assert pm.asdict() == jm.asdict()
    jout, jm = jsc.scan_parquet(buf, predicates=[jsc.ArrowPredicate(
        ("x",), lambda bt: jops.gt(bt["x"], 900))])
    pout, pm = psc.scan_parquet(buf, predicates=[psc.ArrowPredicate(
        ("x",), lambda bt: pops.gt(bt["x"], 900))], device="cpu")
    tp.assert_batch_equal(jout, pout)
    assert pm.asdict() == jm.asdict()
    assert pout["x"].to_pylist() == [v for v in range(901, 1000) if v % 7]


def test_overlapped_scan_equals_sequential_and_releases_producer():
    buf, a, b = _sorted_file(n_rows=8000, n_groups=8)
    preds = [psc.ColumnPredicate("b", "gt", 0), psc.ColumnPredicate(
        "a", "lt", 7000)]
    want, wm = psc.scan_parquet(buf, predicates=preds, device="cpu")
    m = psc.ScanMetrics()
    got = list(psc.scan_batches_overlapped(buf, predicates=preds, metrics=m,
                                           device="cpu"))
    assert len(got) == 7
    rows = [v for batch in got for v in batch["a"].to_pylist()]
    assert rows == want["a"].to_pylist() == a[(b > 0) & (a < 7000)].tolist()
    assert m.asdict() == wm.asdict()
    before = threading.active_count()
    gen = psc.scan_batches_overlapped(buf, prefetch=1, device="cpu")
    next(gen)
    gen.close()  # GeneratorExit: the producer is stopped and joined
    assert threading.active_count() == before


def test_push_decoder_ranges_and_batches_equal_jax():
    """The decoder asks for the JAX decoder's byte ranges, in order, and
    a 1-of-2-column projection reads under 65 % of the file."""
    rng = np.random.default_rng(4)
    n = 5000
    batches = [pt.record_batch({
        "a": tp.port_column(rng.integers(0, 10**6, n), None, "int64"),
        "pad": tp.port_column(rng.integers(0, 10**6, n), None, "int64")})
        for _ in range(3)]
    buf = ppq.write_parquet(batches)
    reads = {"jax": [], "port": []}

    def reader(key):
        def read_fn(off, ln):
            reads[key].append((off, ln))
            return bytes(buf[off:off + ln])
        return read_fn

    jgot = list(jpush.decode_with_reader(reader("jax"), len(buf),
                                         columns=["a"]))
    pgot = list(ppush.decode_with_reader(reader("port"), len(buf),
                                         columns=["a"], device="cpu"))
    assert reads["port"] == reads["jax"]
    assert sum(ln for _, ln in reads["port"]) < 0.65 * len(buf)
    assert len(pgot) == 3
    for j, p in zip(jgot, pgot):
        tp.assert_batch_equal(j, p)
    dec = ppush.ParquetPushDecoder(len(buf), device="cpu")
    assert dec.try_decode() == ("needs_data", [(len(buf) - 8, 8)])


def test_rows_write_and_read_equal_jax():
    rng = np.random.default_rng(11)
    fields = [("i", "int64"), ("f", "float64"), ("s", "utf8"),
              ("b", "bool")]
    values = {"i": [None if k % 5 == 0 else int(v) for k, v in
                    enumerate(rng.integers(-100, 100, 300))],
              "f": rng.standard_normal(300).tolist(),
              "s": [f"r{int(v)}" for v in rng.integers(0, 30, 300)],
              "b": (rng.random(300) < 0.5).tolist()}
    rows = [[(k, values[k][r]) for k, _ in fields] for r in range(300)]

    def schema(mod):
        names = {"bool": "bool_" if mod is pt else "boolean"}
        return mod.schema.Schema(tuple(
            mod.schema.Field(k, getattr(mod.schema, names.get(t, t)))
            for k, t in fields))

    jbuf = jrec.write_rows([jrec.Row(r) for r in rows], schema(at))
    pbuf = prec.write_rows([prec.Row(r) for r in rows], schema(pt),
                           device="cpu")
    assert pbuf == jbuf
    prows = prec.read_rows(pbuf, device="cpu")
    jrows = jrec.read_rows(jbuf)
    assert [r.into_columns() for r in prows] == [r.into_columns()
                                                for r in jrows]
    assert [r.into_columns() for r in prows] == rows
    r0 = prows[0]
    assert (r0.get_string("s"), r0.get_bool("b")) == (values["s"][0],
                                                       values["b"][0])
    assert r0.to_json() == jrows[0].to_json()
    it = prec.RowIter(pbuf, columns=["s"], window=64, device="cpu")
    assert [r.get_string("s") for r in it] == values["s"]


def test_hits_parquet_q43_against_numpy():
    """chip_smoke's phase 25 at 200,000 rows on the CPU: `hits` in key
    order through `entry.hits_pk_parquet`, scanned with query 43's
    predicates pushed down: the rows numpy's mask selects, in order,
    row groups and pages pruned, and query 43 exact against its oracle;
    the full scan's rows too."""
    from arrowtpu_torch import entry as pe

    arrays = pe.example_hits_pk_arrays(200_000)
    data = pe.hits_pk_parquet(arrays, rows=50_000, device="cpu")
    lo, hi = (pe._days(d) for d in pe.Q43_DAYS)
    q43 = ((arrays["CounterID"] == pe.HITS_TOP_COUNTER)
           & (arrays["EventDate"] >= lo) & (arrays["EventDate"] <= hi)
           & (arrays["IsRefresh"] == 0) & (arrays["DontCountHits"] == 0))
    scans = []
    for preds, mask in ((pe.q43_predicates(), q43),
                        (pe.q43_predicates(all_four=False),
                         arrays["DontCountHits"] == 0)):
        out, m = psc.scan_parquet(data, predicates=preds, device="cpu")
        back = pe.hits_from_parquet(out)
        for name in pe.HITS_PK_COLUMNS:
            np.testing.assert_array_equal(
                back[name].values[:back.length].numpy().view(
                    arrays[name].dtype), arrays[name][mask])
        assert m.rows_matched == int(mask.sum())
        scans.append((back, m))
    back, m = scans[0]
    assert m.row_groups_pruned_statistics > 0 and m.pages_skipped > 0
    pe.check_q43(pe.q43_step(back, 10, 10), pe.q43_oracle(arrays, 10, 10))
