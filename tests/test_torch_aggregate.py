"""arrowtpu_torch's whole-column aggregates (ops.aggregate) against
arrowtpu.ops.aggregate on the same numpy inputs.

`sum_`, `product`, `min_`, `max_`, `bool_and`, `bool_or`, `count` and
`finalize` over integers (wrapping; uint64 above 2**63), floats (float16,
float32, float64 with NaN, inf and -0.0), booleans, a decimal and a
Date32, with nulls and with every row null.

Tolerance: the finalized Python values and the value's dtype are equal,
exactly for every integer, boolean, decimal and temporal result and for
float min and max (bit for bit: -0.0 apart from +0.0); a float sum or
product within a relative 1e-12 of the sum of the magnitudes (float64;
2**-10 at float16 and 2**-20 at float32), since torch and XLA add in
another order.  `has` equals the JAX package's, and the value stays on
the device until `finalize`.
"""

import decimal
import math
import struct

import numpy as np
import pytest
import torch

import torch_parity as tp
from arrowtpu import schema as jst
from arrowtpu.core import column as jcol
from arrowtpu.ops import aggregate as jag

from arrowtpu_torch import schema as pst
from arrowtpu_torch.core import column as pcol
from arrowtpu_torch.dtype_parse import parse_datatype
from arrowtpu_torch.ops import aggregate as pag

N = 120
# one dtype of each path: narrow signed, narrow unsigned (uint16 widened,
# uint32's path too), the 64-bit limb kinds, the floats, booleans (int16,
# int32 and uint8 take int8's and uint16's paths in both packages)
DTYPES = ["int8", "int64", "uint16", "uint32", "uint64", "float16",
          "float32", "float64", "bool"]
AGGS = ["sum_", "product", "min_", "max_"]
REL = {"float16": 2.0**-10, "float32": 2.0**-20, "float64": 1e-12}


def _values(name, rng):
    if name == "bool":
        return rng.random(N) < 0.7
    dt = np.dtype(name)
    if dt.kind == "f":
        v = rng.normal(0, 4, N).astype(dt)
        v[:3] = [-0.0, 1.5, -2.5]
        return v
    info = np.iinfo(dt)
    v = rng.integers(info.min, info.max, N, dtype=dt, endpoint=True)
    v[:2] = [info.max, info.max]
    return v


def _columns(name, mode):
    """(JAX, port) columns: with nulls, every row null, or NaN and inf
    (floats)."""
    rng = np.random.default_rng(DTYPES.index(name))
    v = _values(name, rng)
    valid = rng.random(N) > 0.2
    if mode == "all_null":
        valid = np.zeros(N, bool)
    if mode == "nan":
        v[5:8] = [np.nan, np.inf, -np.inf]
    return tp.jax_column(v, valid, name), tp.port_column(v, valid, name)


def _bits(x):
    if isinstance(x, float):
        return struct.pack("<d", x)
    return x


def _close(got, want, name, scale):
    if name in REL and not (math.isnan(want) or math.isinf(want)):
        assert abs(got - want) <= REL[name] * scale, (got, want)
    elif name in REL and math.isnan(want):
        assert math.isnan(got)
    else:
        assert got == want


CASES = ([(n, "nulls") for n in DTYPES]
         + [(n, "nan") for n in DTYPES if n.startswith("float")])


def _others():
    """(JAX, port) columns of a boolean, a Decimal128(15, 2) and a
    Date32, with nulls."""
    b = np.array([True, False, True, True])
    ok = np.array([True, True, False, True])
    rows = [decimal.Decimal("1.25"), None, decimal.Decimal("-3.50"),
            decimal.Decimal("99999999.99")]
    days = [100, 5, None, 20]
    zero = np.array([1.5, -0.0, 2.5], np.float16)
    return {"f16zero": (tp.jax_column(zero, None, "float16"),
                        tp.port_column(zero, None, "float16")),
            "bool4": (tp.jax_column(b, ok, "bool"),
                      tp.port_column(b, ok, "bool")),
            "decimal": (jcol.from_pylist(rows, jst.Decimal128(15, 2)),
                        pcol.from_pylist(rows, pst.Decimal128(15, 2),
                                         device="cpu")),
            "date32": (jcol.from_pylist(days, jst.Date32()),
                       pcol.from_pylist(days, pst.Date32(), device="cpu"))}


@pytest.fixture(scope="module")
def jax_results():
    """{(case, mode, agg): (value, has)} of the JAX package: the sums and
    products of every case under one `jax.jit`, the rest under another
    (XLA's compile time grows faster than the program: two mid-sized
    programs compile faster than one, or than one an aggregate)."""
    cols = {f"{n}/{m}": _columns(n, m)[0] for n, m in CASES}
    cols.update({f"{k}/-": v[0] for k, v in _others().items()})

    def wanted(key, agg):
        if key == "bool4/-":
            return agg != "product"
        if key.endswith("/-"):
            return agg in ("sum_", "min_", "max_")
        return agg not in ("bool_and", "bool_or")

    out = {}
    for aggs in (["sum_", "product"],
                 ["min_", "max_", "count", "bool_and", "bool_or"]):
        got = tp.jit(lambda cs, aggs=aggs: {
            f"{k}/{a}": getattr(jag, a)(c) for k, c in cs.items()
            for a in aggs if wanted(k, a)})(cols)
        out.update({tuple(k.split("/")): v for k, v in got.items()})
    return out


@pytest.mark.parametrize("name", DTYPES)
def test_with_no_valid_row_every_aggregate_is_none(name):
    """`has` is false and `finalize` gives None (the JAX package's
    Option::None), with the value left on the device."""
    _, pc = _columns(name, "all_null")
    for agg in AGGS:
        value, has = getattr(pag, agg)(pc)
        assert isinstance(value, torch.Tensor) and not bool(has)
        assert pag.finalize((value, has)) is None
    assert int(pag.count(pc)) == 0
    assert int(pag.count(pcol.null_column(7, device="cpu"))) == 0


@pytest.mark.parametrize("name,mode", CASES[:-3])
def test_aggregates_match_jax(jax_results, name, mode):
    jc, pc = _columns(name, mode)
    dtype = getattr(jst, "boolean" if name == "bool" else name)
    pdtype = parse_datatype(str(dtype))
    v, ok, _ = tp.jax_to_numpy(jc)
    scale = float(np.abs(v[ok].astype(np.float64)).sum()) if ok.any() else 0
    for agg in AGGS:
        jv, jh = jax_results[(name, mode, agg)]
        pv, ph = getattr(pag, agg)(pc)
        assert isinstance(pv, torch.Tensor) and isinstance(ph, torch.Tensor)
        assert bool(ph) == bool(jh), agg
        want = jag.finalize((jv, jh), dtype)
        got = pag.finalize((pv, ph), pdtype)
        if want is None:
            assert got is None
            continue
        if jv.shape == ():  # a native JAX scalar: its dtype too
            assert str(pv.dtype).split(".")[-1] == str(jv.dtype), agg
        if agg in ("sum_", "product"):
            _close(got, want, name, scale if agg == "sum_" else abs(want))
        else:
            assert _bits(got) == _bits(want), (agg, got, want)
    assert int(pag.count(pc)) == int(jax_results[(name, mode, "count")])


@pytest.mark.parametrize("name", ["float16", "float32", "float64"])
def test_float_min_max_with_nan_and_inf(jax_results, name):
    """float16 / float32 propagate NaN (jnp.min); float64 orders by
    total_cmp (NaN greatest), as the JAX package's limb planes do."""
    _, pc = _columns(name, "nan")
    for agg in ("min_", "max_"):
        want = jag.finalize(jax_results[(name, "nan", agg)],
                            getattr(jst, name))
        got = pag.finalize(getattr(pag, agg)(pc), getattr(pst, name))
        assert (math.isnan(got) and math.isnan(want)) or \
            _bits(got) == _bits(want), (agg, got, want)


def test_float16_min_keeps_negative_zero(jax_results):
    pc = _others()["f16zero"][1]
    want = jag.finalize(jax_results[("f16zero", "-", "min_")])
    got = pag.finalize(pag.min_(pc))
    assert _bits(got) == _bits(want) == _bits(-0.0)


def test_uint64_sum_wraps_and_orders_unsigned():
    """Held to Python (the JAX package agrees on the matrix's uint64
    columns): the sum wraps mod 2**64, min and max are unsigned."""
    u = np.array([2**64 - 1, 2**63, 5], np.uint64)
    pc = tp.port_column(u, None, "uint64")
    want = {"sum_": (2**64 - 1 + 2**63 + 5) % 2**64,
            "product": (2**64 - 1) * 2**63 * 5 % 2**64, "min_": 5,
            "max_": 2**64 - 1}
    for agg, w in want.items():
        assert pag.finalize(getattr(pag, agg)(pc), pst.uint64) == w, agg
        assert pag.finalize(getattr(pag, agg)(pc)) == w, agg


def test_booleans_decimals_and_dates_match_jax(jax_results):
    """bool_and / bool_or and a boolean's sum, min and max; a decimal's
    sum, min and max through ops/decimal (read with its type); a Date32's
    min and max typed int32, its sum int64."""
    dt = {"decimal": (jst.Decimal128(15, 2), pst.Decimal128(15, 2))}
    for key, (_, pc) in _others().items():
        if key == "f16zero":
            continue
        jdt, pdt = dt.get(key, (None, None))
        aggs = ("sum_", "min_", "max_") + (
            ("bool_and", "bool_or") if key == "bool4" else ())
        for agg in aggs:
            jv, jh = jax_results[(key, "-", agg)]
            pv, ph = getattr(pag, agg)(pc)
            assert pag.finalize((pv, ph), pdt) == \
                jag.finalize((jv, jh), jdt), (key, agg)
            if key == "date32":
                assert str(pv.dtype).split(".")[-1] == str(jv.dtype), agg
