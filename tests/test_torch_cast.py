"""arrowtpu_torch's ops.cast, ops.dictionary and ops.union against
arrowtpu's on the same numpy inputs.

Tolerance: exact.  Values below the length, validity as bools, zero
padding (the port's), dtypes; floats bit for bit (NaN by position).

  * `can_cast_types` over every pair of a list of types;
  * the numeric matrix (bool, int8, int64, uint16, uint32, uint64,
    float16, float32, float64) with `CastOptions(safe=True)`: every pair,
    its JAX side one `jax.jit` (one compile in place of 81 eager ones);
    values include uint64 above 2**63, negatives, NaN, inf and -0.0;
  * `safe=False` raises ComputeError where a valid row fails, and gives
    the safe result where none does;
  * the other branches: temporal, interval, fixed-size binary, decimal,
    nested (list, fixed-size list, struct, map), union and dictionary
    sources and targets, strings parsed and formatted on the host;
  * `garbage_collect_dictionary`, `merge_dictionary_values`,
    `union_extract` and `take_union`.

Where the JAX package is at fault, the port is held to Python (ROADMAP
C.3, fault 14): a float cast to a narrow integer compares the value with
the target's bound in the float's own type, where 2**31 - 1 rounds up to
2**31 in float32 and 65535 (uint16's max) to inf in float16, so float32
2**31 -> int32 and float16 inf -> int32 / uint16 / uint32 pass as valid
(saturated); the port fails them (a null under `safe`).  The matrix's
float values stay clear of those bounds.
"""

import decimal

import numpy as np
import pytest

import torch_parity as tp
from torch_parity import release_jax_caches  # noqa: F401
from arrowtpu import ops as jops
from arrowtpu import schema as jst
from arrowtpu.config import CastOptions as JCO
from arrowtpu.core import column as jcol
from arrowtpu.ops import castmod as jcast

import arrowtpu_torch as pt
from arrowtpu_torch import ops as pops
from arrowtpu_torch import schema as pst
from arrowtpu_torch.config import CastOptions as PCO
from arrowtpu_torch.core import column as pcol
from arrowtpu_torch.ops import castmod as pcast

N = 120
# int16, int32 and uint8 aside: they take int8's and uint16's paths
NUMERIC = ["bool", "int8", "int64", "uint16", "uint32", "uint64", "float16",
           "float32", "float64"]


def _jdt(name):
    return jst.boolean if name == "bool" else getattr(jst, name)


def _pdt(name):
    return pst.bool_ if name == "bool" else getattr(pst, name)


def _values(name, rng):
    if name == "bool":
        return rng.random(N) < 0.5
    dt = np.dtype(name)
    if dt.kind == "f":
        v = rng.normal(0, 3e4, N)
        v[:12] = [np.nan, -0.0, 0.0, np.inf, -np.inf, 70000.0, -129.5,
                  255.9, 2.0**63, -2.0**63, 2.0**64, -1e-8]
        if dt == np.float16:  # finite: no inf into narrow ints (fault 14)
            v = np.clip(v, -65504, 65504)
            v[[3, 4, 8, 9, 10]] = [127.0, -128.0, 65504, -32768.5, 255.5]
        return v.astype(dt)
    info = np.iinfo(dt)
    v = rng.integers(info.min, info.max, N, dtype=dt, endpoint=True)
    v[:4] = np.array([0, 1, info.max, info.min], dtype=object).astype(dt)
    v[4:8] = rng.integers(0, 300, 4).astype(dt)
    return v


def _sources():
    rng = np.random.default_rng(14)
    valid = rng.random(N) > 0.1
    return {n: (_values(n, rng), valid) for n in NUMERIC}


@pytest.fixture(scope="module")
def matrix():
    """{(source, target): (JAX column, port column)} under safe=True."""
    src = _sources()
    jcols = {n: tp.jax_column(v, ok, n) for n, (v, ok) in src.items()}

    @tp.jit
    def every_cast(cols):
        return {f"{s}>{d}": jcast.cast(cols[s], _jdt(d))
                for s in NUMERIC for d in NUMERIC}

    jout = every_cast(jcols)
    out = {}
    for s, (v, ok) in src.items():
        pc = tp.port_column(v, ok, s)
        for d in NUMERIC:
            out[(s, d)] = (jout[f"{s}>{d}"], pcast.cast(pc, _pdt(d)))
    return out


def _same(jc, pc, where):
    tp.assert_column_equal(jc, pc, where)
    jv, jok, _ = tp.jax_to_numpy(jc)
    pv, _, _ = pt.column_to_numpy(pc)
    if jv.dtype.kind == "f":
        num = ~np.isnan(jv) & jok
        np.testing.assert_array_equal(tp.bits_of(pv)[num],
                                      tp.bits_of(jv)[num], err_msg=where)


@pytest.mark.parametrize("source", NUMERIC)
def test_numeric_matrix_matches_jax(matrix, source):
    for d in NUMERIC:
        jc, pc = matrix[(source, d)]
        _same(jc, pc, f"{source} -> {d}")


TYPES = [jst.boolean, jst.int8, jst.uint64, jst.float16, jst.float64,
         jst.utf8, jst.binary, jst.Date32(), jst.Date64(),
         jst.Timestamp("ms"), jst.Time32("s"), jst.Time64("ns"),
         jst.Duration("us"), jst.Decimal128(15, 2), jst.Decimal32(9, 2),
         jst.Interval("year_month"), jst.Interval("day_time"),
         jst.Interval("month_day_nano"), jst.FixedSizeBinary(4),
         jst.List(jst.int32), jst.Struct((jst.Field("a", jst.int32),)),
         jst.Dictionary(jst.int32, jst.utf8), jst.Null(),
         jst.Map(jst.utf8, jst.int64),
         jst.Union((jst.Field("i", jst.int32), jst.Field("s", jst.utf8)),
                   (0, 1))]


def test_can_cast_types_matches_jax():
    from arrowtpu_torch.dtype_parse import parse_datatype

    def port(t):
        return parse_datatype(str(t))

    got = [[pcast.can_cast_types(port(a), port(b)) for b in TYPES]
           for a in TYPES]
    want = [[jcast.can_cast_types(a, b) for b in TYPES] for a in TYPES]
    assert got == want


@pytest.mark.parametrize("source,target,fails", [
    ("uint64", "int64", True), ("int64", "uint64", True),
    ("uint16", "uint64", False)])
def test_unsafe_casts_raise_where_a_valid_row_fails(source, target, fails):
    src = _sources()
    v, ok = src[source]
    jc, pc = tp.jax_column(v, ok, source), tp.port_column(v, ok, source)
    if fails:
        for cast, c, dt, opts in ((jcast.cast, jc, _jdt(target), JCO(False)),
                                  (pcast.cast, pc, _pdt(target),
                                   PCO(False))):
            with pytest.raises(pst.ComputeError if cast is pcast.cast
                               else jst.ComputeError):
                cast(c, dt, opts)
        return
    _same(jcast.cast(jc, _jdt(target), JCO(False)),
          pcast.cast(pc, _pdt(target), PCO(False)), target)


def test_float_bounds_follow_python_not_the_jax_package():
    """C.3 fault 14: float32 2**31 and float16 inf are outside int32, and
    float16 inf outside uint16; the JAX package lets them through."""
    f32 = np.array([2.0**31, 2.0**31 - 128, -2.0**31], np.float32)
    got = pcast.cast(pt.column_from_numpy(f32, None, device="cpu"),
                     pst.int32)
    assert got.to_pylist() == [None, 2**31 - 128, -2**31]
    f16 = np.array([np.inf, -np.inf, 65504.0], np.float16)
    for dt, want in ((pst.int32, [None, None, 65504]),
                     (pst.uint16, [None, None, 65504])):
        got = pcast.cast(pt.column_from_numpy(f16, None, device="cpu"), dt)
        assert got.to_pylist() == want


def _pair(values, dtype):
    """(JAX column, port column) of Python values."""
    from arrowtpu_torch.dtype_parse import parse_datatype

    if isinstance(dtype, jst.Null):
        return (jcol.null_column(len(values)),
                pt.null_column(len(values), device="cpu"))
    return (jcol.from_pylist(values, dtype),
            pt.from_pylist(values, parse_datatype(str(dtype)), device="cpu"))


def _rows(jc, pc):
    """Both columns' Python rows, equal."""
    assert str(jc.dtype) == str(pc.dtype)
    assert pc.to_pylist() == jc.to_pylist()


MS = 86_400_000
BRANCHES = [
    ([1_600_000_123_456, -86_400_001, None, 0], jst.Timestamp("ms"),
     [jst.Timestamp("s"), jst.Date32(), jst.Date64(), jst.utf8]),
    ([18_000, -1, None, 0], jst.Date32(),
     [jst.Date64(), jst.Timestamp("ns"), jst.int64]),
    ([MS * 3 + 5, -MS - 1, None], jst.Date64(), [jst.Date32()]),
    ([3_600, 0, None], jst.Time32("s"), [jst.Time64("us"),
                                        jst.Time32("ms")]),
    ([7_000_000, -3, None], jst.Duration("us"),
     [jst.Duration("ms"), jst.Interval("month_day_nano")]),
    ([(1, 2, 3_000_000), (0, 0, -5_000), None],
     jst.Interval("month_day_nano"), [jst.Duration("us")]),
    ([14, -3, None], jst.Interval("year_month"),
     [jst.Interval("month_day_nano"), jst.int8]),
    ([(2, 500), (-1, -7), None], jst.Interval("day_time"),
     [jst.Interval("month_day_nano")]),
    ([300, -2, None], jst.int32, [jst.Interval("year_month"),
                                  jst.Decimal128(15, 2)]),
    ([decimal.Decimal("12.345"), decimal.Decimal("-0.5"), None],
     jst.Decimal128(15, 3), [jst.Decimal32(9, 1), jst.int16,
                             jst.float32, jst.utf8]),
    ([1.25, -2.5, None], jst.float64, [jst.Decimal64(18, 2), jst.utf8]),
    (["12", "x", None, "-7"], jst.utf8,
     [jst.int16, jst.uint64, jst.float16, jst.boolean, jst.binary]),
    (["2013-07-01", None], jst.utf8, [jst.Date32(), jst.Timestamp("s")]),
    ([b"abcd", b"xy", None, b"wxyz"], jst.binary,
     [jst.FixedSizeBinary(4)]),
    ([b"abcdefghijklmnop", None], jst.FixedSizeBinary(16),
     [jst.binary, jst.utf8]),
    ([b"ab", None], jst.FixedSizeBinary(2), [jst.binary]),
    ([[1, 2], None, [3]], jst.List(jst.int32), [jst.List(jst.float16)]),
    ([[1, 2], None], jst.FixedSizeList(jst.int8, 2),
     [jst.FixedSizeList(jst.uint64, 2)]),
    ([{"a": 1, "b": "x"}, None], jst.Struct((jst.Field("a", jst.int8),
                                             jst.Field("b", jst.utf8))),
     [jst.Struct((jst.Field("a", jst.float32), jst.Field("b", jst.utf8)))]),
    ([[("k", 1)], None], jst.Map(jst.utf8, jst.int32),
     [jst.Map(jst.utf8, jst.int64)]),
    ([None, None], jst.Null(), [jst.int8, jst.utf8,
                                jst.Dictionary(jst.int32, jst.utf8)]),
    (["b", "a", None, "b"], jst.Dictionary(jst.int32, jst.utf8),
     [jst.utf8, jst.Dictionary(jst.int8, jst.binary)]),
    ([3, 1, None, 3], jst.int16, [jst.Dictionary(jst.int32, jst.int64)]),
]


_HOST = (jst.Utf8, jst.Binary, jst.Dictionary, jst.Null)


def _on_host(source, target) -> bool:
    """The JAX package casts strings and dictionaries on the host (not
    under `jax.jit`); fixed-size binary <-> binary runs on the device."""
    if isinstance(source, jst.FixedSizeBinary) or isinstance(
            target, jst.FixedSizeBinary):
        return False
    return isinstance(source, _HOST) or isinstance(target, _HOST)


@pytest.fixture(scope="module")
def jax_branches():
    """{(branch, target): the JAX package's cast}: the device casts of
    every branch under one `jax.jit`, the host ones eager."""
    cols = [_pair(v, src)[0] for v, src, _ in BRANCHES]
    device = [(i, j) for i, (_, src, ts) in enumerate(BRANCHES)
              for j, t in enumerate(ts) if not _on_host(src, t)]

    def run(cs):
        return {f"{i}/{j}": jcast.cast(cs[i], BRANCHES[i][2][j])
                for i, j in device}

    out = {tuple(map(int, k.split("/"))): v
           for k, v in tp.jit(run)(cols).items()}
    for i, (_, src, ts) in enumerate(BRANCHES):
        for j, t in enumerate(ts):
            if _on_host(src, t):
                out[(i, j)] = jcast.cast(cols[i], t)
    return out


@pytest.mark.parametrize("branch", range(len(BRANCHES)),
                         ids=[str(b[1]) for b in BRANCHES])
def test_cast_branches_match_jax(jax_branches, branch):
    from arrowtpu_torch.dtype_parse import parse_datatype

    values, source, targets = BRANCHES[branch]
    _, pc = _pair(values, source)
    for j, t in enumerate(targets):
        jo = jax_branches[(branch, j)]
        po = pcast.cast(pc, parse_datatype(str(t)))
        _rows(jo, po)
        if isinstance(po, pcol.PrimitiveColumn):
            tp.assert_column_equal(jo, po, f"{source} -> {t}")


def _union_pair(mode):
    children = ([1, 2, 3, 4], ["a", "b", "c", "d"]) if mode == "sparse" \
        else ([1, 2], ["a", "b", "c"])
    codes = [0, 1, 1, 0]
    offsets = [0, 0, 1, 1] if mode == "dense" else None
    jt = jst.Union((jst.Field("i", jst.int32), jst.Field("s", jst.utf8)),
                   (0, 1), mode)
    pt_ = pst.Union((pst.Field("i", pst.int32), pst.Field("s", pst.utf8)),
                    (0, 1), mode)
    ju = jcol.union_column(np.asarray(codes, np.int8),
                           [jcol.from_pylist(children[0], jst.int32),
                            jcol.from_pylist(children[1], jst.utf8)], jt,
                           offsets=None if offsets is None
                           else np.asarray(offsets, np.int32))
    pu = pcol.union_column(codes, [
        pt.from_pylist(children[0], pst.int32, device="cpu"),
        pt.from_pylist(children[1], pst.utf8, device="cpu")], pt_,
        offsets=offsets, device="cpu")
    return ju, pu


@pytest.mark.parametrize("mode", ["sparse", "dense"])
def test_union_extract_take_and_cast_match_jax(mode):
    ju, pu = _union_pair(mode)
    idx = [3, 0, 2]

    @tp.jit
    def run(u, i):
        return ([jops.union_extract(u, f) for f in ("i", "s")],
                jcast.cast(u, jst.int64), jops.take_union(u, i))

    extracted, cast_, taken = run(ju, jcol.from_pylist(idx, jst.int32))
    for field, jc in zip(("i", "s"), extracted):
        _rows(jc, pops.union_extract(pu, field))
    _rows(cast_, pcast.cast(pu, pst.int64))
    _rows(taken, pops.take_union(pu, pt.from_pylist(idx, pst.int32,
                                                    device="cpu")))
    with pytest.raises(pst.CastError):
        pcast.cast(pu, pst.Interval("day_time"))


def test_dictionary_maintenance_matches_jax():
    values = ["b", "a", None, "b", "c", "a"]
    jd, pd = _pair(values, jst.Dictionary(jst.int32, jst.utf8))
    keep = np.array([1, 0, 1, 1, 0, 0], bool)
    jg = tp.jit(lambda d, m: jops.garbage_collect_dictionary(
        jops.filter_(d, m)))(jd, jcol.boolean(keep))
    pg = pops.garbage_collect_dictionary(
        pops.filter_(pd, pt.boolean(keep, device="cpu")))
    _rows(jg, pg)
    _rows(jg.values, pg.values)
    jd2, pd2 = _pair(["c", "d", None], jst.Dictionary(jst.int32, jst.utf8))
    assert pops.should_merge_dictionary_values([pd, pd2])
    assert not pops.should_merge_dictionary_values([pd, pd])
    jm, jkeys = jops.merge_dictionary_values([jd, jd2])
    pm, pkeys = pops.merge_dictionary_values([pd, pd2])
    _rows(jm, pm)
    for jk, pk in zip(jkeys, pkeys):
        tp.assert_column_equal(jk, pk, "remapped keys")
