"""Filter, take and concat of arrowtpu_torch over every column class against
`arrowtpu.ops` on the same inputs: string views first (filter and take
of a string view raised in the port before), then decimals, temporal
types, intervals, fixed-size binary, dictionaries, list views (List and
Map), structs and fixed-size lists; run-end and union columns raise in
both packages.  Tolerance: exact (values under nulls, validity as bools,
lengths, zero padding; a concat's list-view starts, which depend on the
children's capacities, are compared as the rows they read)."""

import decimal

import numpy as np
import pytest

import torch_parity as tp
import arrowtpu.schema as js
from arrowtpu import ops as jops
from arrowtpu.config import TakeOptions as JTakeOptions
from arrowtpu.core import batch as jbt
from arrowtpu.core import column as jcol
from arrowtpu.ops.concat import concat as jconcat

import arrowtpu_torch.schema as ps
from arrowtpu_torch import ops as pops
from arrowtpu_torch.config import TakeOptions
from arrowtpu_torch.core import batch as pbt
from arrowtpu_torch.core import column as pcol
from arrowtpu_torch.ops.concat import concat as pconcat

D = decimal.Decimal
N = 120


def _strings(rng, n):
    """At most 12 bytes (inline) and longer (in the arena), and nulls."""
    words = ["", "a", "twelve bytes", "thirteen byte", "a string well past "
             "the inline twelve bytes", "ünïcödé"]
    return [None if rng.random() < 0.15 else
            words[rng.integers(len(words))] + "x" * int(rng.integers(0, 4))
            for _ in range(n)]


def _values(kind, rng, n):
    """(JAX dtype, port dtype, Python values with None) of a class."""
    nul = lambda: rng.random() < 0.1  # noqa: E731
    if kind == "utf8":
        return js.utf8, ps.utf8, _strings(rng, n)
    if kind == "binary":
        return js.binary, ps.binary, [
            None if s is None else s.encode() for s in _strings(rng, n)]
    if kind.startswith("decimal"):
        bits = int(kind[7:])
        nl = bits // 32
        cls = {1: "Decimal32", 2: "Decimal64", 4: "Decimal128",
               8: "Decimal256"}[nl]
        prec = {1: 9, 2: 18, 4: 38, 8: 76}[nl]
        lim = 10 ** (prec - 1)
        vals = [None if nul() else D(int(rng.integers(-2**62, 2**62))
                                     * int(rng.integers(1, 1 << 20)) % lim
                                     - lim // 2).scaleb(-2)
                for _ in range(n)]
        return getattr(js, cls)(prec, 2), getattr(ps, cls)(prec, 2), vals
    ints = lambda lo, hi: [None if nul() else int(rng.integers(lo, hi))  # noqa
                           for _ in range(n)]
    if kind == "date32":
        return js.Date32(), ps.Date32(), ints(-5000, 20000)
    if kind == "timestamp":
        return js.Timestamp("us"), ps.Timestamp("us"), ints(-2**60, 2**60)
    if kind == "time32":
        return js.Time32("ms"), ps.Time32("ms"), ints(0, 86_400_000)
    if kind == "duration":
        return js.Duration("ns"), ps.Duration("ns"), ints(-2**50, 2**50)
    if kind.startswith("interval"):
        unit = kind[9:]
        tup = {"year_month": lambda: int(rng.integers(-99, 99)),
               "day_time": lambda: (int(rng.integers(-9, 9)),
                                    int(rng.integers(-10**6, 10**6))),
               "month_day_nano": lambda: (int(rng.integers(-9, 9)),
                                          int(rng.integers(-9, 9)),
                                          int(rng.integers(-2**62, 2**62)))}
        return js.Interval(unit), ps.Interval(unit), [
            None if nul() else tup[unit]() for _ in range(n)]
    if kind.startswith("fsb"):
        w = int(kind[3:])
        return js.FixedSizeBinary(w), ps.FixedSizeBinary(w), [
            None if nul() else rng.bytes(w) for _ in range(n)]
    if kind == "dictionary":
        words = ["red", "green", "a longer dictionary word"]
        return (js.Dictionary(js.int32, js.utf8),
                ps.Dictionary(ps.int32, ps.utf8),
                [None if nul() else words[rng.integers(3)] for _ in range(n)])
    if kind == "list":
        return js.List(js.int64), ps.List(ps.int64), [
            None if nul() else [None if nul() else int(x) for x in
                                rng.integers(-50, 50, rng.integers(0, 6))]
            for _ in range(n)]
    if kind == "list_utf8":
        return js.List(js.utf8), ps.List(ps.utf8), [
            None if nul() else _strings(rng, int(rng.integers(0, 4)))
            for _ in range(n)]
    if kind == "map":
        return js.Map(js.utf8, js.int64), ps.Map(ps.utf8, ps.int64), [
            None if nul() else [(f"k{j}", None if nul() else j)
                                for j in range(int(rng.integers(0, 4)))]
            for _ in range(n)]
    if kind == "struct":
        strs = _strings(rng, n)
        return (js.Struct((js.Field("i", js.int32), js.Field("s", js.utf8),
                           js.Field("d", js.Decimal128(15, 2)))),
                ps.Struct((ps.Field("i", ps.int32), ps.Field("s", ps.utf8),
                           ps.Field("d", ps.Decimal128(15, 2)))),
                [None if nul() else {
                    "i": None if nul() else int(rng.integers(-9, 9)),
                    "s": strs[i],
                    "d": None if nul() else D(int(rng.integers(-999, 999)))
                    .scaleb(-2)} for i in range(n)])
    if kind.startswith("fsl"):
        size = int(kind[3:])
        return (js.FixedSizeList(js.float32, size),
                ps.FixedSizeList(ps.float32, size),
                [None if nul() else [None if nul() else float(x) for x in
                                     rng.integers(-9, 9, size)]
                 for _ in range(n)])
    raise ValueError(kind)


KINDS = ["utf8", "binary", "decimal32", "decimal64", "decimal128",
         "decimal256", "date32", "timestamp", "time32", "duration",
         "interval_year_month", "interval_day_time",
         "interval_month_day_nano", "fsb3", "fsb9", "fsb16", "fsb20", "fsb21",
         "dictionary", "list", "list_utf8", "map", "struct", "fsl1", "fsl4"]


def _pair(kind, seed, n=N):
    rng = np.random.default_rng(seed)
    jdt, pdt, vals = _values(kind, rng, n)
    return (jcol.from_pylist(vals, jdt),
            pcol.from_pylist(vals, pdt, device="cpu"), vals)


def _mask(seed, n=N, density=0.5, nulls=0.1):
    rng = np.random.default_rng(seed)
    keep = rng.random(n) < density
    valid = rng.random(n) > nulls
    return tp.jax_column(keep, valid, "bool"), tp.port_column(keep, valid,
                                                              "bool")


def test_string_view_filter_and_take_match_jax():
    """The repair: a string view through filter and take, strings of at
    most 12 bytes and longer ones, nulls, and an index past the end."""
    jc, pc, vals = _pair("utf8", 1)
    jm, pm = _mask(2)
    tp.assert_column_equal(jops.filter_(jc, jm), pops.filter_(pc, pm),
                           "filter")
    rng = np.random.default_rng(3)
    idx = rng.integers(0, N, 100)
    idx[[3, 17]] = [N, N + 40]  # past the end -> null
    ivalid = rng.random(100) > 0.1
    ji = tp.jax_column(idx, ivalid, "int64")
    pi = tp.port_column(idx, ivalid, "int64")
    got = pops.take(pc, pi)
    tp.assert_column_equal(jops.take(jc, ji), got, "take")
    assert got.to_pylist()[3] is None and got.to_pylist()[17] is None
    assert got.arena is pc.arena  # the arena is shared, not copied


@pytest.mark.parametrize("kind", KINDS)
def test_filter_matches_jax(kind):
    jc, pc, _ = _pair(kind, 10)
    jm, pm = _mask(11)
    tp.assert_column_equal(jops.filter_(jc, jm), pops.filter_(pc, pm), kind)


@pytest.mark.parametrize("kind", KINDS)
def test_take_matches_jax(kind):
    jc, pc, _ = _pair(kind, 20)
    rng = np.random.default_rng(21)
    idx = rng.integers(-3, N + 3, 100)
    ivalid = rng.random(100) > 0.1
    ji = tp.jax_column(idx, ivalid, "int32")
    pi = tp.port_column(idx, ivalid, "int32")
    tp.assert_column_equal(jops.take(jc, ji), pops.take(pc, pi), kind)


@pytest.mark.parametrize("kind", ["list", "map", "struct", "fsl4",
                                  "decimal128", "utf8", "interval_day_time"])
def test_concat_matches_jax(kind):
    """A map's concat is held to its inputs' rows alone: the JAX package
    concatenates a list view's children at whole capacities, and a
    struct child (a map's entries) then keeps only its live rows, so its
    rows after the first input read the wrong entries."""
    pairs = [_pair(kind, 30 + i, n) for i, n in enumerate((60, 1, 50))]
    pr = pconcat([p for _, p, _ in pairs])
    if kind != "map":
        jr = jconcat([j for j, _, _ in pairs])
        tp.assert_column_equal(jr, pr, kind, layout=False)
    tp.assert_zero_padding(pr)
    assert pr.to_pylist() == [v for _, _, vals in pairs for v in vals]


def test_filter_and_take_record_batch_of_nested_classes():
    """One plan over a batch of every class: one K1 launch per word size
    and plan on the card; here the same batch against the JAX package,
    and take's bounds flag in both."""
    kinds = ["decimal128", "decimal256", "date32", "utf8", "struct", "fsl4",
             "list", "dictionary", "fsb21"]
    jcols, pcols = {}, {}
    for i, kind in enumerate(kinds):
        jcols[kind], pcols[kind], _ = _pair(kind, 40 + i)
    jb, pb = jbt.record_batch(jcols), pbt.record_batch(pcols)
    jm, pm = _mask(50, density=0.3)
    tp.assert_batch_equal(jops.filter_record_batch(jb, jm),
                          pops.filter_record_batch(pb, pm))
    for idx, flag in (([0, 5, N - 1], False), ([0, N, 7], True)):
        ji = tp.jax_column(np.array(idx), None, "int64")
        pi = tp.port_column(np.array(idx), None, "int64")
        jr, jflag = jops.take_record_batch(jb, ji, JTakeOptions(True))
        pr, pflag = pops.take_record_batch(pb, pi, TakeOptions(True))
        assert pflag is bool(jflag) is flag
        tp.assert_batch_equal(jr, pr)
        jc, jf = jops.take(jb.columns[0], ji, JTakeOptions(True))
        pc, pf = pops.take(pb.columns[0], pi, TakeOptions(True))
        assert pf is bool(jf) is flag
        tp.assert_column_equal(jc, pc, "take check_bounds")


def test_null_index_is_in_bounds_for_check_bounds():
    jc, pc, _ = _pair("decimal64", 60, 10)
    idx, valid = np.array([1, 99, 2]), np.array([True, False, True])
    _, jf = jops.take(jc, tp.jax_column(idx, valid, "int64"),
                      JTakeOptions(True))
    _, pf = pops.take(pc, tp.port_column(idx, valid, "int64"),
                      TakeOptions(True))
    assert pf is bool(jf) is False


def _run_end_and_union(pkg_col, pkg_schema, device):
    kw = {} if device is None else {"device": device}
    ree = pkg_col.run_end_from_pylist([1, 1, 2, 2, 2], **kw)
    udt = pkg_schema.Union((pkg_schema.Field("a", pkg_schema.int64),),
                           (0,), "sparse")
    union = pkg_col.union_column([0, 0, 0, 0, 0],
                                 (pkg_col.from_pylist([1, 2, 3, 4, 5], **kw),),
                                 udt, **kw)
    return ree, union


@pytest.mark.parametrize("op", ["filter", "take", "concat"])
def test_run_end_and_union_raise_in_both(op):
    for (ree, union), ops_, concat, mask, idx, err in (
            (_run_end_and_union(jcol, js, None), jops, jconcat,
             tp.jax_column(np.ones(5, bool), None, "bool"),
             tp.jax_column(np.arange(3), None, "int32"), js.ComputeError),
            (_run_end_and_union(pcol, ps, "cpu"), pops, pconcat,
             tp.port_column(np.ones(5, bool), None, "bool"),
             tp.port_column(np.arange(3), None, "int32"), ps.ComputeError)):
        for c in (ree, union):
            with pytest.raises(err):
                if op == "filter":
                    ops_.filter_(c, mask)
                elif op == "take":
                    ops_.take(c, idx)
                else:
                    concat([c, c])
