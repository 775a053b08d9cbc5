"""arrowtpu_torch's logical types, limb arithmetic, Python-value columns
and builders against the JAX package on the same inputs: every type's
string and its parse, `core/limbs.py` against `arrowtpu.core.limbs`
(wrapping, signs, N = 1, 2, 4, 8), `from_pylist` / `to_pylist` of every
column class, and the builders.  Tolerance: exact (limbs bit for bit)."""

import decimal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from torch_parity import release_jax_caches  # noqa: F401
import arrowtpu.schema as js
from arrowtpu import dtype_parse as jparse
from arrowtpu.core import builders as jbuild
from arrowtpu.core import column as jcol
from arrowtpu.core import limbs as jl

import arrowtpu_torch.schema as ps
from arrowtpu_torch import dtype_parse as pparse
from arrowtpu_torch.core import builders as pbuild
from arrowtpu_torch.core import column as pcol
from arrowtpu_torch.core import limbs as pl

D = decimal.Decimal


def _types(s):
    """The same list of types, built from either package's schema."""
    f = s.Field
    return [
        s.null, s.int8, s.int64, s.uint32, s.float32, s.float64, s.utf8,
        s.binary, s.Timestamp("ns", "UTC"), s.Timestamp(), s.Date32(),
        s.Date64(), s.Time32("s"), s.Time64("ns"), s.Duration("ms"),
        s.Decimal32(9, 2), s.Decimal64(18, 4), s.Decimal128(15, 2),
        s.Decimal256(76, 10), s.Interval("year_month"),
        s.Interval("day_time"), s.Interval(), s.FixedSizeBinary(9),
        s.Dictionary(s.int32, s.utf8), s.List(s.utf8),
        s.FixedSizeList(s.float32, 4), s.Map(s.utf8, s.int64),
        s.Struct((f("i", s.int32), f("s", s.List(s.Decimal128(15, 2))))),
        s.Union((f("a", s.int32), f("b", s.utf8)), (0, 1), "dense"),
        s.Union((f("a", s.int64),), (0,), "sparse"),
        s.RunEndEncoded(s.int32, s.utf8)]


@pytest.mark.parametrize("i", range(len(_types(ps))))
def test_type_strings_and_parse(i):
    pt_, jt = _types(ps)[i], _types(js)[i]
    assert str(pt_) == str(jt)
    assert pparse.parse_datatype(str(pt_)) == pt_
    assert str(jparse.parse_datatype(str(pt_))) == str(pt_)
    assert ps.words_per_row(pt_) == (
        js.decimal_limbs(jt) or (jt.n_words if isinstance(jt, js.Interval)
                                 else None)
        or (-(-jt.byte_width // 4) if isinstance(jt, js.FixedSizeBinary)
            else None))


def test_decimal_helpers_and_schema():
    for n in (1, 2, 4, 8):
        assert ps.MAX_DECIMAL_PRECISION[n] == js.MAX_DECIMAL_PRECISION[n]
        assert str(ps.decimal_for_limbs(n, 7, 3)) == str(
            js.decimal_for_limbs(n, 7, 3))
        assert ps.decimal_limbs(ps.decimal_for_limbs(n, 7, 3)) == n
    sch = ps.schema([("a", ps.int64), ps.Field("b", ps.utf8, False)])
    assert sch.names == ["a", "b"] and not sch.field("b").nullable
    assert sch.project(["b"]).names == ["b"]
    with pytest.raises(ps.SchemaError):
        ps.schema([("a", ps.int64), ("a", ps.utf8)])
    with pytest.raises(ps.SchemaError):
        ps.Interval("weeks")
    assert issubclass(ps.CastError, ps.ArrowTpuError)
    assert issubclass(ps.ValidationError, ps.ArrowTpuError)


# ---------------------------------------------------------------------------
# limbs
# ---------------------------------------------------------------------------


def _limb_inputs(n_limbs, seed):
    rng = np.random.default_rng(seed)
    top = 1 << (32 * n_limbs - 1)
    vals = [top - 1, -top, 0, -1, 1, top // 3, -(top // 7)]
    vals += [int.from_bytes(rng.bytes(4 * n_limbs), "little", signed=True)
             for _ in range(60)]
    vals += [int(x) for x in rng.integers(-1000, 1000, 20)]
    a = jl.split_ints(vals, n_limbs)
    b = jl.split_ints(vals[::-1], n_limbs)
    return a, b


def _port(x):
    return torch.from_numpy(x.view(np.int32).copy())


def _same(j, p, what):
    j = np.asarray(j)
    if j.dtype == np.uint32:
        j = j.view(np.int32)
    p = p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
    np.testing.assert_array_equal(p.astype(np.int64), j.astype(np.int64),
                                  err_msg=what)


BINARY = ["add", "sub", "mul_lo", "eq", "lt_unsigned", "lt_signed"]
UNARY = ["neg", "is_negative", "to_float", "sort_planes"]


@pytest.mark.parametrize("n_limbs", [1, 2, 4, 8])
@pytest.mark.parametrize("fn", BINARY + UNARY)
def test_limbs_match_jax(fn, n_limbs):
    a, b = _limb_inputs(n_limbs, n_limbs)
    if fn in BINARY:
        j = getattr(jl, fn)(jnp.asarray(a), jnp.asarray(b))
        p = getattr(pl, fn)(_port(a), _port(b))
    else:
        j = getattr(jl, fn)(jnp.asarray(a))
        p = getattr(pl, fn)(_port(a))
    if fn == "sort_planes":
        for x, y in zip(j, p):
            _same(x, y, fn)
    elif fn == "to_float":
        np.testing.assert_array_equal(p.numpy().view(np.int64),
                                      np.asarray(j).view(np.int64))
    else:
        _same(j, p, fn)


@pytest.mark.parametrize("n_limbs", [1, 2, 4, 8])
def test_limb_scaling_and_widths_match_jax(n_limbs):
    host, _ = _limb_inputs(n_limbs, 10 + n_limbs)
    a, pa = jnp.asarray(host), _port(host)
    _same(jl.mul_small(a, 4_000_000_007), pl.mul_small(pa, 4_000_000_007),
          "mul_small")
    q, r = pl.divmod_small_unsigned(pa, 65521)
    jq, jr = jl.divmod_small_unsigned(a, 65521)
    _same(jq, q, "divmod q")
    _same(jr, r, "divmod r")
    for k in (0, 1, 4, 5, 9):
        q, r = pl.divmod_pow10(pa, k)
        jq, jr = jl.divmod_pow10(a, k)
        _same(jq, q, f"divmod_pow10 q {k}")
        _same(jr, r, f"divmod_pow10 r {k}")
        _same(jl.mul_pow10(a, k), pl.mul_pow10(pa, k), f"mul_pow10 {k}")
    for m in (1, 2, 4, 8):
        if m >= n_limbs:
            _same(jl.widen(a, m), pl.widen(pa, m), "widen")
        if m <= n_limbs:
            _same(jl.narrow(a, m), pl.narrow(pa, m), "narrow")
            _same(jl.fits_in(a, m), pl.fits_in(pa, m), "fits_in")


def test_limb_host_conversions():
    vals = [0, -1, 5, -(2**127), 2**127 - 1, None, 10**30]
    np.testing.assert_array_equal(pl.split_ints(vals, 4),
                                  jl.split_ints(vals, 4))
    limbs = jl.split_ints(vals, 4)
    assert pl.join_ints(limbs) == jl.join_ints(limbs)
    assert pl.join_ints(limbs.view(np.int32)) == jl.join_ints(limbs)
    np.testing.assert_array_equal(pl.from_scalar(-7, 8),
                                  jl.from_scalar(-7, 8))
    i64 = np.array([0, -1, 2**62, -(2**63), 2**63 - 1], np.int64)
    for n in (1, 2, 4, 8):
        np.testing.assert_array_equal(
            pl.split_int64(i64, n), jl.split_ints([int(x) for x in i64], n))


# ---------------------------------------------------------------------------
# from_pylist / to_pylist of every class
# ---------------------------------------------------------------------------


def _pylists(s):
    """(dtype, values) pairs, the dtype from either package's schema."""
    return [
        (s.int64, [1, None, -5, 2**40]),
        (s.float32, [1.5, None, -2.25]),
        (s.Date32(), [0, 19000, None, -3]),
        (s.Timestamp("ns"), [1, None, 2**60]),
        (s.Time32("ms"), [0, 86_399_999, None]),
        (s.Decimal32(9, 2), [D("1.25"), None, D("-3.5"), 7]),
        (s.Decimal64(18, 4), [D("123456789.0123"), None, D("-0.0001")]),
        (s.Decimal128(38, 10), [D("1234567890123456789012.0123456789"),
                                None, D("-1e-10")]),
        (s.Decimal256(76, 10), [D("9" * 60), None, D("-" + "1" * 50)]),
        (s.Interval("year_month"), [12, None, -3]),
        (s.Interval("day_time"), [(1, 500), None, (-2, -1)]),
        (s.Interval(), [(1, 2, 3_000_000_000_000), None, (-1, -2, -3)]),
        (s.FixedSizeBinary(3), [b"abc", None, b"\x00\xff\x01"]),
        (s.FixedSizeBinary(16), [bytes(range(16)), None, b"x" * 16]),
        (s.bool_ if s is ps else s.boolean, [True, None, False]),
        (s.utf8, ["short", None, "a string longer than twelve bytes", ""]),
        (s.binary, [b"\x00\x01", None, b"y" * 20]),
        (s.List(s.int64), [[1, 2], None, [], [3, None]]),
        (s.List(s.utf8), [["a", "bb" * 10], None, []]),
        (s.Map(s.utf8, s.int64), [[("k", 1), ("j", None)], None, []]),
        (s.Struct((s.Field("i", s.int32), s.Field("s", s.utf8))),
         [{"i": 1, "s": "x"}, None, {"i": None, "s": "long long string"}]),
        (s.FixedSizeList(s.float32, 2), [[1.0, 2.0], None, [None, 3.0]]),
        (s.FixedSizeList(s.Decimal128(15, 2), 3),
         [[D("1.00"), None, D("2.50")], None]),
        (s.Dictionary(s.int32, s.utf8), ["b", "a", None, "b", "c"]),
        (None, [[1, 2], [3]]),
        (None, [{"x": 1.5, "y": "s"}]),
        (None, [None, None]),
    ]


@pytest.mark.parametrize("i", range(len(_pylists(ps))))
def test_from_pylist_and_to_pylist_match_jax(i):
    pdt, data = _pylists(ps)[i]
    jdt, _ = _pylists(js)[i]
    jc = jcol.from_pylist(data, jdt)
    pc = pcol.from_pylist(data, pdt, device="cpu")
    assert pc.to_pylist() == jc.to_pylist()
    tp.assert_column_equal(jc, pc, str(pdt))


def test_run_end_and_union_match_jax():
    data = [1, 1, 2, None, None, 3, 3, 3]
    jr = jcol.run_end_from_pylist(data)
    pr = pcol.run_end_from_pylist(data, device="cpu")
    assert pr.to_pylist() == jr.to_pylist() == data
    np.testing.assert_array_equal(pr.run_ends[:pr.n_runs].numpy(),
                                  np.asarray(jr.run_ends)[:int(jr.n_runs)])
    idx = np.arange(8)
    np.testing.assert_array_equal(
        pr.physical_index(torch.from_numpy(idx)).numpy(),
        np.asarray(jr.physical_index(idx)))
    with pytest.raises(ps.InvalidArgumentError):
        pcol.run_end_encoded([3, 2], pcol.from_pylist([1, 2], device="cpu"))
    for mode, offsets in (("sparse", None), ("dense", [0, 0, 1, 1])):
        jdt = js.Union((js.Field("a", js.int64), js.Field("b", js.utf8)),
                       (5, 7), mode)
        pdt = ps.Union((ps.Field("a", ps.int64), ps.Field("b", ps.utf8)),
                       (5, 7), mode)
        a, b = [1, 2, 3, 4], ["w", "x", "y", "z"]
        if mode == "dense":
            a, b = [1, 2], ["w", "x"]
        ju = jcol.union_column([5, 7, 5, 7], (jcol.from_pylist(a),
                                              jcol.from_pylist(b)),
                               jdt, offsets)
        pu = pcol.union_column([5, 7, 5, 7],
                               (pcol.from_pylist(a, device="cpu"),
                                pcol.from_pylist(b, device="cpu")),
                               pdt, offsets, device="cpu")
        assert pu.to_pylist() == ju.to_pylist()
        assert pu.child_by_type_id(7).to_pylist() == b
    with pytest.raises(ps.InvalidArgumentError):
        pcol.union_column([0], (pcol.from_pylist([1], device="cpu"),),
                          ps.Union((ps.Field("a", ps.int64),), (0,), "dense"),
                          device="cpu")


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["int32", "float64", "date32", "timestamp",
                                  "bool", "utf8", "dictionary"])
def test_builders_match_jax(kind):
    rng = np.random.default_rng(3)
    n = 300
    if kind in ("utf8", "dictionary"):
        words = ["alpha", "a much longer value string", "", "beta"]
        data = [None if rng.random() < 0.1 else words[rng.integers(4)]
                for _ in range(n)]
    elif kind == "bool":
        data = [None if rng.random() < 0.1 else bool(rng.random() < 0.5)
                for _ in range(n)]
    else:
        data = [None if rng.random() < 0.1 else
                (float(rng.random()) if kind == "float64"
                 else int(rng.integers(-10**6, 10**6))) for _ in range(n)]
    if kind == "bool":
        jb, pb = jbuild.BooleanBuilder(), pbuild.BooleanBuilder("cpu")
    elif kind == "utf8":
        jb, pb = jbuild.StringBuilder(), pbuild.StringBuilder(ps.utf8, "cpu")
    elif kind == "dictionary":
        jb = jbuild.StringDictionaryBuilder()
        pb = pbuild.StringDictionaryBuilder(device="cpu")
    else:
        jdt, pdt = {"int32": (js.int32, ps.int32),
                    "float64": (js.float64, ps.float64),
                    "date32": (js.Date32(), ps.Date32()),
                    "timestamp": (js.Timestamp("ns"), ps.Timestamp("ns"))
                    }[kind]
        jb = jbuild.PrimitiveBuilder(jdt)
        pb = pbuild.PrimitiveBuilder(pdt, device="cpu")
    for x in data:
        jb.append_option(x)
        pb.append_option(x)
    assert len(pb) == len(jb) == n
    jc, pc = jb.finish(), pb.finish()
    assert pc.to_pylist() == jc.to_pylist()
    if kind == "dictionary":
        np.testing.assert_array_equal(
            pc.value_ranks[:3].numpy(), np.asarray(jc.value_ranks)[:3])
    tp.assert_column_equal(jc, pc, kind)
    assert len(pb) == 0  # finish resets


def test_primitive_builder_takes_native_types_only():
    """As in the JAX package: a decimal or interval has no single dtype."""
    for jdt, pdt in ((js.Decimal128(20, 2), ps.Decimal128(20, 2)),
                     (js.Interval(), ps.Interval())):
        with pytest.raises(js.SchemaError):
            jbuild.PrimitiveBuilder(jdt)
        with pytest.raises(ps.SchemaError):
            pbuild.PrimitiveBuilder(pdt, device="cpu")


def test_record_batch_builder():
    sch = ps.schema([("a", ps.int64), ("f", ps.bool_), ("s", ps.utf8),
                     ("d", ps.Dictionary(ps.int32, ps.utf8))])
    b = pbuild.RecordBatchBuilder(sch, device="cpu")
    rows = [{"a": 1, "f": True, "s": "x", "d": "p"},
            {"a": None, "f": None, "s": None, "d": None},
            {"a": 3, "f": False, "s": "long string value", "d": "p"}]
    for r in rows:
        b.append_row(r)
    out = b.finish()
    assert out.length == 3 and out.schema == sch
    assert out.to_pydict() == {k: [r[k] for r in rows] for k in rows[0]}
