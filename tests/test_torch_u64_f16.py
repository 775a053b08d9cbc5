"""uint64 and float16 columns through arrowtpu_torch's layers, against
arrowtpu on the same numpy inputs: the numpy bridge and the parity bridge,
numeric, cmp and bitwise ops, sort, the RowConverter, the key hash,
group-by (both engines), filter, take and concat.

Tolerance: exact.  Values below the length (those under nulls included),
validity as bools, zero padding; floats bit for bit (-0.0 apart from
+0.0; a NaN's payload aside where torch and XLA differ, compared by
position).  uint64 rows hold values of 2**63 and more; float16 rows hold
-0.0, inf and NaN.  Every column has N rows (the JAX package pads to 128).

Where the JAX package is at fault, the port is held to numpy, and the test
names the fault (ROADMAP C.3):
  11. a float16 group key comes back cast by value (`[1.5, -0.0]` as
      `[1.0, 0.0]`): the keys are held to numpy's distinct values, the
      grouping, order and aggregates to the JAX package's output of the
      same call;
  13. a uint64 column beside a float (column or Python scalar) keeps
      uint64, the float cut to an integer (`u + 1.5` is `u + 1`), or reads
      the uint64 bits as a float64; the port takes the float type and
      converts the uint64 by value, held to numpy.
"""

import functools

import numpy as np
import pytest

import torch_parity as tp
from torch_parity import release_jax_caches  # noqa: F401
from arrowtpu import ops as jops
from arrowtpu import schema as jst
from arrowtpu.core import column as jcol
from arrowtpu.ops.concat import concat as jconcat
from arrowtpu.ops import groupby as jgb
from arrowtpu.ops import sortmod as jsort
from arrowtpu.rowformat import decode as jdec
from arrowtpu.rowformat import encode as jenc
from arrowtpu.rowformat import hashing as jhash

import arrowtpu as at
import arrowtpu_torch as pt
from arrowtpu_torch import ops as pops
from arrowtpu_torch import schema as pst
from arrowtpu_torch.config import SortOptions as PSO
from arrowtpu_torch.ops.concat import concat as pconcat
from arrowtpu_torch.ops import groupby as pgb
from arrowtpu_torch.rowformat import decode as pdec
from arrowtpu_torch.rowformat import encode as penc
from arrowtpu_torch.rowformat import hashing as phash

N = 120
HALF = 2**63


def _u64(seed):
    """N uint64 values: corners, then half below and half above 2**63."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 2**64, N, dtype=np.uint64, endpoint=False)
    v[:8] = [0, 1, 7, HALF - 1, HALF, HALF + 1, 2**64 - 2, 2**64 - 1]
    return v


def _f16(seed):
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(N) * 100).astype(np.float16)
    v[:8] = [np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5, -2.5, 65504.0]
    return v


def _valid(seed):
    return np.random.default_rng(seed + 100).random(N) > 0.15


COLS = {"u": (_u64(1), _valid(1), "uint64"),
        "d": (_u64(2), None, "uint64"),
        "h": (_f16(3), _valid(3), "float16"),
        "g": (_f16(4), None, "float16"),
        "i": (np.random.default_rng(5).integers(-2**63, 2**63 - 1, N),
              None, "int64"),
        "s": (np.random.default_rng(6).integers(-2**31, 2**31 - 1, N,
                                                dtype=np.int32), None,
              "int32"),
        "f": ((np.random.default_rng(7).standard_normal(N) * 10
               ).astype(np.float32), None, "float32")}


def _jax(name):
    v, ok, dt = COLS[name]
    return tp.jax_column(v, ok, dt)


def _port(name):
    v, ok, dt = COLS[name]
    return tp.port_column(v, ok, dt)


def _assert_same(jc, pc, where):
    """assert_column_equal, then floats bit for bit where neither is NaN."""
    tp.assert_column_equal(jc, pc, where)
    jv, jok, _ = tp.jax_to_numpy(jc)
    pv, pok, _ = pt.column_to_numpy(pc)
    if jv.dtype.kind == "f":
        num = ~np.isnan(jv)
        np.testing.assert_array_equal(tp.bits_of(pv)[num],
                                      tp.bits_of(jv)[num], err_msg=where)


# ---------------------------------------------------------------------------
# the bridges
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["u", "h"])
def test_bridge_round_trips_bit_for_bit(name):
    v, ok, dt = COLS[name]
    pc = _port(name)
    back, valid, n = pt.column_to_numpy(pc)
    assert n == N and back.dtype == v.dtype
    np.testing.assert_array_equal(tp.bits_of(back), tp.bits_of(v))
    np.testing.assert_array_equal(valid, ok)
    py = [None if not k else (x if dt == "uint64" else float(x))
          for x, k in zip(v.tolist(), ok)]
    again = pt.from_pylist(py, getattr(pst, dt), device="cpu")
    got = again.to_pylist()
    assert [None if x is None else repr(x) for x in got] == \
        [None if x is None else repr(x) for x in py]
    _assert_same(_jax(name), pc, name)


# ---------------------------------------------------------------------------
# numeric, cmp, bitwise
# ---------------------------------------------------------------------------

# (op, a, b): names of COLS or Python scalars; the JAX package's result
# types (uint64 + int64 is int64, int64 + uint64 uint64, uint64 with a
# narrower integer uint64, float16 with an integer float16)
NUMERIC = [("add", "u", "d"), ("sub", "u", "d"), ("mul", "u", "d"),
           ("div", "u", "d"), ("rem", "u", "d"), ("div", "u", 7),
           ("rem", "u", 7), ("add", "u", "i"), ("add", "i", "u"),
           ("add", "u", "s"), ("sub", "u", 1), ("add", "h", "g"),
           ("mul", "h", "g"), ("div", "h", "g"), ("add", "h", 1),
           ("mul", "h", 1.5), ("add", "h", "f"), ("add", "h", "s")]


CHECKED = [("add_checked", "u", "d"), ("sub_checked", "u", "d"),
           ("mul_checked", "u", "d"), ("add_checked", "u", 0)]
CMP = [("gt", "u", "d"), ("lt_eq", "u", "d"), ("eq", "u", "d"),
       ("lt", "u", HALF), ("gt_eq", "u", 3), ("lt", "h", "g"),
       ("eq", "h", 0.0), ("gt", "h", 1.5), ("distinct", "u", "d"),
       ("not_distinct", "h", "g")]
BITWISE = [("shift_right", "d", "k"), ("shift_left", "d", "k"),
           ("bit_and", "u", "d"), ("bit_xor", "u", "d")]
COLS["k"] = (np.arange(N, dtype=np.uint64) % 70, None, "uint64")


def _operand(x, pkg):
    if not isinstance(x, str):
        return x
    return _jax(x) if pkg == "jax" else _port(x)


def _key(case):
    return "/".join(map(str, case))


@pytest.fixture(scope="module")
def jax_ops():
    """{case: the JAX package's result}: each list of cases one
    `jax.jit` (one compile in place of one eager compile an op)."""
    cols = {n: _jax(n) for n in COLS}
    out = {}
    for cases in (NUMERIC, CHECKED, CMP, BITWISE):
        def run(cs, cases=cases):
            def arg(x):
                return cs[x] if isinstance(x, str) else x
            return {_key(c): getattr(jops, c[0])(arg(c[1]), arg(c[2]))
                    for c in cases}
        out.update(tp.jit(run)(cols))
    out["bit_not"] = tp.jit(jops.bit_not)(cols["d"])
    return out


@pytest.mark.parametrize("op,a,b", NUMERIC,
                         ids=[f"{o}-{a}-{b}" for o, a, b in NUMERIC])
def test_numeric_matches_jax(jax_ops, op, a, b):
    po = getattr(pops, op)(_operand(a, "port"), _operand(b, "port"))
    _assert_same(jax_ops[_key((op, a, b))], po, f"{op}({a}, {b})")


@pytest.mark.parametrize("op,a,b", CHECKED,
                         ids=[f"{o}-{a}-{b}" for o, a, b in CHECKED])
def test_checked_ops_flag_unsigned_overflow(jax_ops, op, a, b):
    """The JAX package's flags, unsigned: a wrap in add or sub, a product
    that does not divide back."""
    jo, jf = jax_ops[_key((op, a, b))]
    po, pf = getattr(pops, op)(_port(a), _operand(b, "port"))
    _assert_same(jo, po, op)
    assert bool(pf) == bool(jf) == (b != 0)


def test_uint64_beside_a_float_is_held_to_numpy():
    """C.3 fault 13: the JAX package keeps uint64 beside a float scalar
    (u + 1.5 is u + 1) and reads the bits as a float64 beside a float64
    column; the port takes the float type and numpy's values."""
    u = COLS["d"][0]
    got = pops.add(_port("d"), 1.5)
    assert got.dtype == pst.float64
    np.testing.assert_array_equal(pt.column_to_numpy(got)[0], u + 1.5)
    f64 = pt.column_from_numpy(np.arange(N, dtype=np.float64), None,
                               device="cpu")
    got = pops.sub(_port("d"), f64)
    np.testing.assert_array_equal(pt.column_to_numpy(got)[0],
                                  u - np.arange(N, dtype=np.float64))


@pytest.mark.parametrize("op,a,b", CMP,
                         ids=[f"{o}-{a}-{b}" for o, a, b in CMP])
def test_comparisons_match_jax(jax_ops, op, a, b):
    po = getattr(pops, op)(_operand(a, "port"), _operand(b, "port"))
    tp.assert_column_equal(jax_ops[_key((op, a, b))], po, f"{op}({a}, {b})")


@pytest.mark.parametrize("op,a,b", BITWISE + [("bit_not", "d", None)],
                         ids=[o for o, _, _ in BITWISE] + ["bit_not"])
def test_bitwise_matches_jax(jax_ops, op, a, b):
    """Shift amounts in [0, 70): both packages take them mod 64 at 64
    bits; shift_right of uint64 is logical: (2**64 - 1) >> 1 = 2**63 - 1."""
    if op == "bit_not":
        jo, po = jax_ops["bit_not"], pops.bit_not(_port("d"))
    else:
        jo = jax_ops[_key((op, a, b))]
        po = getattr(pops, op)(_port(a), _port(b))
    _assert_same(jo, po, op)
    if op == "shift_right":
        assert pops.shift_right(_port("d"), 1).to_pylist()[7] == HALF - 1


# ---------------------------------------------------------------------------
# sort, RowConverter, hash
# ---------------------------------------------------------------------------


SORTS = [(name, desc) for name in ("u", "h") for desc in (False, True)]


@pytest.fixture(scope="module")
def jax_sorts():
    """{(column, descending): the JAX package's sort_to_indices}, all
    four under one `jax.jit`."""
    from arrowtpu.config import SortOptions as JSO

    def run(cols):
        return {f"{n}/{int(d)}": jsort.sort_to_indices(
            cols[n], JSO(descending=d)) for n, d in SORTS}

    got = tp.jit(run)({n: _jax(n) for n in ("u", "h")})
    return {(k[0], k[-1] == "1"): v for k, v in got.items()}


@pytest.mark.parametrize("name,desc", SORTS)
def test_sort_to_indices_matches_jax(jax_sorts, name, desc):
    """uint64 in unsigned order (2**63 and more last); float16 by Rust's
    total_cmp through float32, as the JAX package's planes order it."""
    pidx = pops.sort_to_indices(_port(name), PSO(descending=desc))
    tp.assert_column_equal(jax_sorts[(name, desc)], pidx, f"sort {name}")


def test_row_converter_round_trips_like_jax():
    cols = ["u", "h", "d", "g"]
    opts = [PSO(), PSO(descending=True), PSO(nulls_first=False),
            PSO(descending=True, nulls_first=False)]
    from arrowtpu.config import SortOptions as JSO

    jopts = [JSO(o.descending, o.nulls_first) for o in opts]

    @tp.jit
    def round_trip(columns):
        jconv = jdec.RowConverter(jopts)
        return jconv.convert_rows(jconv.convert_columns(columns), N)

    jback = round_trip([_jax(c) for c in cols])
    pconv = pdec.RowConverter(opts)
    pback = pconv.convert_rows(pconv.convert_columns(
        [_port(c) for c in cols]), N)
    for c, jc, pc in zip(cols, jback, pback):
        _assert_same(jc, pc, c)
        # and the input's valid rows, bit for bit
        v, ok, _ = COLS[c]
        ok = np.ones(N, bool) if ok is None else ok
        got = pt.column_to_numpy(pc)[0]
        np.testing.assert_array_equal(tp.bits_of(got)[ok],
                                      tp.bits_of(v)[ok])


@pytest.mark.parametrize("seed", [0, 7])
def test_hash_planes_match_jax(seed):
    """hash_planes_of gives the JAX package's u32 planes (uint64's hi, lo;
    float16's float32 key rebased), so a key hashes and partitions as
    there."""
    cols = ["u", "h", "g"]
    want = np.asarray(tp.jit(lambda cs: jhash.hash_planes(
        jenc.encode_columns(cs), seed=seed))([_jax(c) for c in cols]))[:N]
    got = phash.hash_planes(penc.hash_planes_of([_port(c) for c in cols]),
                            seed=seed)[:N].numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)


# ---------------------------------------------------------------------------
# group-by
# ---------------------------------------------------------------------------


def _group_batch(pkg):
    rng = np.random.default_rng(9)
    uk = (rng.integers(0, 6, N).astype(np.uint64) * np.uint64(2**61)
          + np.uint64(5))
    hk = np.array([1.5, 2.5, -0.0, 0.0, np.inf, np.nan], np.float16)[
        rng.integers(0, 6, N)]
    k = rng.integers(0, 5, N).astype(np.int32)
    cols = {"uk": (uk, None, "uint64"), "hk": (hk, None, "float16"),
            "k": (k, None, "int32"), "uv": COLS["u"], "hv": COLS["h"]}
    make = tp.jax_column if pkg == "jax" else tp.port_column
    lib = at if pkg == "jax" else pt
    return lib.record_batch({n: make(*c) for n, c in cols.items()}), cols


# uv's min and max are the value-ordered column's rows; hv's max a
# segmented extreme (the uint64 sum and mean: the dense test; each
# aggregate lengthens the JAX compile)
SORT_AGGS = [("uv", "min"), ("uv", "max"), ("hv", "sum"), ("hv", "max")]
DENSE_AGGS = [("uv", "sum"), ("uv", "min"), ("uv", "max"), ("uv", "mean")]


def _hk_order(v):
    """float16 group keys in the port's order: float32's total order."""
    import torch

    from arrowtpu_torch.rowformat.encode import float_key

    return float_key(torch.from_numpy(v)).numpy()


def test_group_by_uint64_and_float16_keys_and_values():
    """(uk uint64, hk float16) keys on the sort pipeline: the uint64 key,
    the grouping, the order and every aggregate (uint64 min and max
    unsigned; float16 sums and max) equal the JAX package's; the
    float16 key is held to numpy's
    distinct (uk, hk) pairs (C.3 fault 11)."""
    jb, cols = _group_batch("jax")
    pb, _ = _group_batch("port")
    keys = ["uk", "hk"]
    jo = jgb.group_by(jb, keys, SORT_AGGS)
    po = pgb.group_by(pb, keys, SORT_AGGS)
    assert jo.length == po.length
    for f in jo.schema.fields:
        if f.name != "hk":
            _assert_same(jo[f.name], po[f.name], f.name)
    uk, hk = cols["uk"][0], cols["hk"][0]
    pairs = np.unique(np.stack([uk.astype(np.int64) ^ np.int64(-2**63),
                                _hk_order(hk)]), axis=1)
    want_bits = hk.view(np.uint16)[[
        np.flatnonzero((_hk_order(hk) == b) & (uk.astype(np.int64)
                                               ^ np.int64(-2**63) == a))[0]
        for a, b in pairs.T]]
    got = pt.column_to_numpy(po["hk"])[0]
    np.testing.assert_array_equal(got.view(np.uint16), want_bits)
    wrong = tp.jax_to_numpy(jo["hk"])[0]
    assert not np.array_equal(tp.bits_of(wrong), want_bits)  # fault 11


@functools.partial(tp.jit, static_argnums=(1, 2))
def _jax_dense_group_by(batch, key, aggs):
    """The JAX package's dense engine, as its plan runs it, at 16 buckets
    (its dispatch compiles a cond over both engines, several times the
    compile; the output does not depend on the bucket count)."""
    import jax.numpy as jnp
    from arrowtpu.core import batch as jbt

    kc = batch[key]
    kmin = jnp.min(jnp.where(kc.valid_bool(), kc.values,
                             jnp.iinfo(kc.values.dtype).max))
    return jbt.RecordBatch(
        jgb._dense_out_schema(batch, [key], aggs),
        jgb._dense_group_by(batch, (key,), aggs, kmin, NB=16))


def test_dense_group_by_takes_uint64_values():
    """An int32 key in a small range takes the dense engine in both
    packages; uint64 values enter the kernel's plain version with their
    top bit flipped, so min and max are unsigned and the sum wraps."""
    jb, _ = _group_batch("jax")
    pb, _ = _group_batch("port")
    aggs = tuple(DENSE_AGGS)
    assert jgb._dense_eligible(jb, ("k",), aggs)
    assert pgb.plan_group_by(pb, ["k"], aggs).engine == "dense"
    tp.assert_batch_equal(_jax_dense_group_by(jb, "k", aggs),
                          pgb.group_by(pb, ["k"], aggs))


# ---------------------------------------------------------------------------
# filter, take, concat
# ---------------------------------------------------------------------------


def test_filter_take_concat_exchange_carry_both_types():
    """8-byte uint64 and 2-byte float16 planes through the filter (K1's
    plain version), take, concat and the exchange, with nulls."""
    names = ["u", "h", "g"]
    jb = at.record_batch({n: _jax(n) for n in names})
    pb = pt.record_batch({n: _port(n) for n in names})
    keep = np.random.default_rng(11).random(N) < 0.4
    jm, pm = at.boolean(keep), pt.boolean(keep, device="cpu")
    idx = np.random.default_rng(12).integers(-3, N + 3, N).astype(np.int64)
    ji = jcol.primitive(idx, jst.int64)
    pi = pt.column_from_numpy(idx, None, device="cpu")
    jf, jt, jc = tp.jit(lambda b, m, i: (
        jops.filter_record_batch(b, m), jops.take_record_batch(b, i),
        [jconcat([b[n], b[n]]) for n in names]))(jb, jm, ji)
    tp.assert_batch_equal(jf, pops.filter_record_batch(pb, pm))
    tp.assert_batch_equal(jt, pops.take_record_batch(pb, pi))
    for n, jcat in zip(names, jc):
        _assert_same(jcat, pconcat([_port(n), _port(n)]), n)
    # the exchange at one rank, hash-partitioned on the uint64 key: every
    # row back, bit for bit
    from arrowtpu_torch.entry import check_same_rows
    from arrowtpu_torch.parallel import mesh
    from arrowtpu_torch.parallel.shuffle import exchange

    with mesh.process_group(0, 1, "cpu") as group:
        assert check_same_rows(exchange(pb, ["u"], group), pb) == N
