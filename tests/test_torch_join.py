"""arrowtpu_torch's key hash, take and hash join against the JAX package's
on the same numpy inputs (every JAX join of the module under one
`jax.jit` on the CPU backend).  Tolerance: bit-exact (hashes; values below the length, values
under nulls included; validity as bools; length; zero padding; the join's
duplicates and overflow flags).

The key classes: integers, booleans, float32 / float64 (-0.0, +0.0, NaN
payloads, infinities), the temporal types, Decimal32-256, fixed-size
binary, dictionaries, string views (inline and arena strings, with and
without `len_bound`) and the null column hash as the JAX package hashes
them; an interval key raises (the JAX package's plane of an interval is
not one row a plane, which its hash does not take).  Two faults of the
JAX package are held to the right answer instead: string keys of two
widths (it encodes each side at its own width, so equal strings never
meet) and dictionary keys of two dictionaries (it compares each side's
value ranks, so different strings meet): the port joins the first as a
numpy oracle does and raises on the second."""

import dataclasses
import decimal

import numpy as np
import pytest

import torch_parity as tp
from torch_parity import release_jax_caches  # noqa: F401
from arrowtpu.core import batch as jbt
from arrowtpu.core import bitmap as jbm
from arrowtpu.core import column as jcol
from arrowtpu.ops import join as jjoin
from arrowtpu.ops.take import take as jax_take
from arrowtpu.ops.take import take_record_batch as jax_take_batch
from arrowtpu.rowformat import encode as jenc
from arrowtpu.rowformat import hashing as jhash
from arrowtpu import schema as jst
from arrowtpu_torch import null_column
from arrowtpu_torch import schema as pst
from arrowtpu_torch.core import batch as pbt
from arrowtpu_torch.core import column as pcol
from arrowtpu_torch.ops import join as pjoin
from arrowtpu_torch.ops.take import take, take_record_batch
from arrowtpu_torch.rowformat import encode as penc
from arrowtpu_torch.rowformat import hashing as phash

RANGES = {"int64": (-2**63, 2**63 - 1), "int32": (-2**31, 2**31 - 1),
          "int8": (-128, 128), "uint8": (0, 256), "bool": (0, 2)}


def _columns(rng, dtype, n, nulls, lo=None, hi=None):
    lo0, hi0 = RANGES[dtype]
    vals = rng.integers(lo0 if lo is None else lo, hi0 if hi is None else hi,
                        n)
    valid = rng.random(n) >= nulls if nulls else None
    return tp.jax_column(vals, valid, dtype), tp.port_column(vals, valid,
                                                             dtype)


N = 1000
WORDS = ["pear", "apple", "a word longer than twelve bytes", "", "fig",
         "twelve bytes", "thirteen byte"]
# the classes beyond int and bool: (JAX dtype, port dtype) of each, or a
# builder below
TYPES = {
    "date32": lambda s: s.Date32(), "date64": lambda s: s.Date64(),
    "time32": lambda s: s.Time32("ms"), "time64": lambda s: s.Time64("ns"),
    "timestamp": lambda s: s.Timestamp("us", "UTC"),
    "duration": lambda s: s.Duration("ms"),
    "decimal32": lambda s: s.Decimal32(9, 2),
    "decimal64": lambda s: s.Decimal64(18, 2),
    "decimal128": lambda s: s.Decimal128(15, 2),
    "decimal256": lambda s: s.Decimal256(76, 2),
    "fsb9": lambda s: s.FixedSizeBinary(9), "utf8": lambda s: s.utf8}
INTERVALS = {"year_month": 3, "day_time": (1, -2),
             "month_day_nano": (1, 2, -3)}


def _floats(rng, dtype, n):
    """n floats of `dtype` with -0.0, +0.0, infinities, NaNs of several
    payloads and signs, and repeats (as bits)."""
    np_dt, bits_dt = ((np.float64, np.uint64) if dtype == "float64"
                      else (np.float32, np.uint32))
    pool = rng.normal(size=24).astype(np_dt)
    pool[:5] = [0.0, -0.0, np.inf, -np.inf, np.nan]
    bits = pool.view(bits_dt)
    top = np.array(0x7FF8 << 48 if dtype == "float64" else 0x7FC0 << 16,
                   bits_dt)
    bits[5:8] = [top | 0x123, top | 0xABC, top | (bits_dt(1) << bits_dt(
        63 if dtype == "float64" else 31))]
    return pool[rng.integers(0, len(pool), n)]


def _pool(rng, kind, size, repeats=12):
    """`size` distinct Python values of a key class (strings of up to
    `repeats` + 1 parts)."""
    if kind in ("date32", "time32"):
        return rng.choice(86_400_000, size, replace=False).tolist()
    if kind in ("date64", "time64", "timestamp", "duration"):
        return (rng.choice(2**40, size, replace=False) - 2**39).tolist()
    if kind.startswith("decimal"):
        top = 10**7 if kind == "decimal32" else 10**15
        return [decimal.Decimal(int(x)).scaleb(-2)
                for x in rng.choice(2 * top, size, replace=False) - top]
    if kind == "fsb9":
        return [bytes([i % 256, i // 256]) + bytes(rng.integers(
            0, 256, 7, dtype=np.uint8)) for i in range(size)]
    if kind == "utf8":  # inline and arena strings, and their prefixes
        return [("k%d" % i) * int(rng.integers(0, repeats + 1)) + str(i)
                for i in range(size)]
    raise ValueError(kind)


def _pair(values, kind):
    """The JAX package's and the port's column of Python values."""
    return (jcol.from_pylist(values, TYPES[kind](jst)),
            pcol.from_pylist(values, TYPES[kind](pst), device="cpu"))


def _key_columns(rng, kind, n, nulls=0.2, draw=None, pool=None):
    """(JAX column, port column) of n keys of a class, `nulls` of them
    null; `draw` ((n,) indices) picks them from `pool` (by default a pool
    of 64 values of the class)."""
    valid = rng.random(n) >= nulls
    if kind in RANGES:
        return _columns(rng, kind, n, nulls)
    if kind in ("float32", "float64"):
        vals = _floats(rng, kind, n)
        return tp.jax_column(vals, valid, kind), tp.port_column(vals, valid,
                                                                kind)
    if kind == "null":
        return jcol.null_column(n), null_column(n, device="cpu")
    if kind == "dictionary":
        data = [WORDS[i] if ok else None
                for i, ok in zip(rng.integers(0, len(WORDS), n), valid)]
        return (jcol.dictionary_encode_host(data),
                pcol.dictionary_encode_host(data, device="cpu"))
    base = kind.removesuffix("_unbounded")
    pool = _pool(rng, base, 64) if pool is None else pool
    draw = rng.integers(0, len(pool), n) if draw is None else draw
    jc, pc = _pair([pool[i] if ok else None for i, ok in zip(draw, valid)],
                   base)
    if kind.endswith("_unbounded"):  # len_bound read back from the data
        jc, pc = (dataclasses.replace(jc, len_bound=None),
                  dataclasses.replace(pc, len_bound=None))
    return jc, pc


HASH_KINDS = ([["int64"], ["int32"], ["bool"], ["int8", "uint8"],
               ["int64", "bool"]]
              + [[k] for k in ("float64", "float32", "null", "dictionary",
                               "utf8_unbounded", *TYPES)]
              + [["utf8", "int64"], ["float64", "decimal128"]])


@pytest.mark.parametrize("seed", [0, 0x5157])
@pytest.mark.parametrize("dtypes", HASH_KINDS)
def test_hash_planes_match(dtypes, seed):
    """hash_planes_of + hash_planes against the JAX package's hash of its
    encode_columns, on nullable keys of every class and two-column keys."""
    rng = np.random.default_rng(len(dtypes) * 7 + seed)
    jcols, pcols = zip(*(_key_columns(rng, dt, N, 0.2) for dt in dtypes))
    want = np.asarray(jhash.hash_planes(jenc.encode_columns(list(jcols)),
                                        seed=seed))[:N]
    got = phash.hash_planes(penc.hash_planes_of(list(pcols)), seed=seed)
    np.testing.assert_array_equal(got.numpy()[:N], want.astype(np.int64))


@pytest.mark.parametrize("unit", sorted(INTERVALS))
def test_interval_keys_raise(unit):
    """An interval key: the JAX package's encode gives a (capacity, W)
    plane, which its null mask broadcasts to (capacity, capacity) (W = 1,
    year_month) or fails on (W = 2, 4); the port raises."""
    import arrowtpu_torch as pt

    vals = [INTERVALS[unit], None] * 32
    jc = jcol.from_pylist(vals, jst.Interval(unit))
    pc = pcol.from_pylist(vals, pst.Interval(unit), device="cpu")
    try:
        shape = jenc.encode_columns([jc])[1].shape
    except ValueError:  # (capacity, W) * (capacity,) does not broadcast
        shape = None
    assert shape in (None, (jc.capacity, jc.capacity))
    with pytest.raises(pt.schema.ComputeError):
        penc.hash_planes_of([pc])


# int64 indices outside the int32 range: both packages gather from the low
# 32 bits read as int32 and clipped, so the values under these null rows
# agree only if the port does the same
WIDE_INDICES = [0, 5, 2**31, 2**32 + 3, -1, 4096, 2**40 + 7, 17, 2**63 - 1,
                -2**63, 2**31 - 1, -2**31, -2**31 - 1, 2**32, 2**32 + 299,
                -2**32 + 5]


def _index_columns(rng, n_idx, src_len, dtype="int32"):
    """Indices over [-3, src_len + 40): null ones, negative ones and ones
    past the source's length (inside and past its capacity); as int64, the
    WIDE_INDICES among them too."""
    idx = rng.integers(-3, src_len + 40, n_idx)
    if dtype == "int64":
        idx[rng.choice(n_idx, len(WIDE_INDICES), replace=False)] = \
            WIDE_INDICES
    ok = rng.random(n_idx) > 0.15
    return tp.jax_column(idx, ok, dtype), tp.port_column(idx, ok, dtype)


@pytest.mark.parametrize("dtype,nulls,index_dtype", [
    pytest.param(dt, nulls, ix,
                 id=f"{dt}-{nulls}" + ("-int64_indices" if ix == "int64"
                                       else ""))
    for ix in ("int32", "int64")
    for dt, nulls in [("int64", 0.0), ("int64", 0.3), ("int32", 0.2),
                      ("bool", 0.2)]])
def test_take_matches(dtype, nulls, index_dtype):
    rng = np.random.default_rng(11)
    jc, pc = _columns(rng, dtype, 300, nulls)
    ji, pi = _index_columns(rng, 500, 300, index_dtype)
    tp.assert_column_equal(jax_take(jc, ji), take(pc, pi), dtype)


def test_take_null_column_and_record_batch():
    rng = np.random.default_rng(12)
    (ja, pa), (jb, pb) = (_columns(rng, "int64", 100, 0.1),
                          _columns(rng, "bool", 100, 0.0))
    ji, pi = _index_columns(rng, 70, 100)
    jbat = jbt.record_batch({"a": ja, "b": jb, "z": jcol.null_column(100)})
    pbat = pbt.record_batch({"a": pa, "b": pb,
                             "z": null_column(100, device="cpu")})
    tp.assert_batch_equal(jax_take_batch(jbat, ji),
                          take_record_batch(pbat, pi))


def _join_inputs(seed, n_left=400, n_right=150, key_nulls=0.1):
    """Probe keys over [0, 60), build keys over [0, 40) with duplicates
    (an N:M join), null keys on both sides, nulls in the payloads."""
    rng = np.random.default_rng(seed)
    spec_l = [("k", "int64", 0, 60, key_nulls), ("b", "bool", 0, 2, 0.0),
              ("lv", "int64", -10**6, 10**6, 0.2)]
    spec_r = [("k", "int64", 0, 40, key_nulls), ("b", "bool", 0, 2, 0.0),
              ("rv", "int32", -1000, 1000, 0.2)]
    out = []
    for spec, n in ((spec_l, n_left), (spec_r, n_right)):
        jcols, pcols = {}, {}
        for name, dt, lo, hi, nulls in spec:
            jcols[name], pcols[name] = _columns(rng, dt, n, nulls, lo, hi)
        out.append((jbt.record_batch(jcols), pbt.record_batch(pcols)))
    return out


def _check_join(case, jax_joins, on, how, out_capacity):
    """The port's join of the case's inputs against the JAX package's
    (computed with every other case of the module, `jax_joins`)."""
    (_, pl), (_, pr) = JOIN_CASES()[case][0]
    jout, jinfo = jax_joins[case]
    pout, pinfo = pjoin.hash_join(pl, pr, on, how=how,
                                  out_capacity=out_capacity)
    tp.assert_batch_equal(jout, pout)
    assert bool(pinfo.duplicates) == bool(jinfo.duplicates)
    assert bool(pinfo.overflow) == bool(jinfo.overflow)
    return pout, pinfo


def _unique_inputs():
    rng = np.random.default_rng(25)
    lk = rng.integers(0, 150, 400)
    rk = rng.permutation(100)
    return [(jbt.record_batch({"k": tp.jax_column(k, None, "int64")}),
             pbt.record_batch({"k": tp.port_column(k, None, "int64")}))
            for k in (lk, rk)]


def JOIN_CASES():
    """{case: (inputs, on, how, out_capacity)} of every join this module
    holds to the JAX package, built once."""
    cases = getattr(JOIN_CASES, "cases", None)
    if cases is None:
        cases = JOIN_CASES.cases = {
            **{f"n_to_m-{how}": (_join_inputs(21), ("k",), how, 4096)
               for how in ("inner", "left", "semi", "anti")},
            **{f"two_keys-{how}": (_join_inputs(22, key_nulls=0.05),
                                   ("k", "b"), how, 4096)
               for how in ("inner", "left")},
            "truncates": (_join_inputs(23), ("k",), "inner", 256),
            "default_capacity": (_join_inputs(24), ("k",), "left", 4096),
            "unique": (_unique_inputs(), ("k",), "inner", None),
            **{kind: (_typed_join_inputs(kind, 31), ("k",), "inner", 4096)
               for kind in JOIN_KEYS}}
    return cases


@pytest.fixture(scope="module")
def jax_joins():
    """{case: (batch, JoinInfo)} of the JAX package's hash_join on every
    case, under one `jax.jit` (one compile for the module)."""
    cases = JOIN_CASES()

    def body(inputs):
        return {name: jjoin.hash_join(*inputs[name], list(on), how=how,
                                      out_capacity=cap)
                for name, (_, on, how, cap) in cases.items()}

    return tp.jit(body)({name: (l[0], r[0])
                          for name, ((l, r), *_) in cases.items()})


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
def test_hash_join_n_to_m_with_null_keys(how, jax_joins):
    out, info = _check_join(f"n_to_m-{how}", jax_joins, ["k"], how, 4096)
    assert bool(info.duplicates) and out.length > 0


@pytest.mark.parametrize("how", ["inner", "left"])
def test_hash_join_two_key_columns(how, jax_joins):
    _check_join(f"two_keys-{how}", jax_joins, ["k", "b"], how, 4096)


def test_hash_join_out_capacity_truncates(jax_joins):
    """An output cut to out_capacity rows sets overflow in both."""
    out, info = _check_join("truncates", jax_joins, ["k"], "inner", 256)
    assert info.overflow and out.length == 256


def test_hash_join_default_capacity_is_the_whole_output(jax_joins):
    """The port sizes its output to the join's length (read back once)."""
    (_, pl), (_, pr) = JOIN_CASES()["default_capacity"][0]
    jout, _ = jax_joins["default_capacity"]
    pout, info = pjoin.hash_join(pl, pr, ["k"], how="left")
    assert not info.overflow and pout.capacity == -(-pout.length // 64) * 64
    tp.assert_batch_equal(jout, pout)


def test_unique_build_keys_have_no_duplicates(jax_joins):
    _check_join("unique", jax_joins, ["k"], "inner", None)


JOIN_KEYS = ["float64", "decimal128", "date64", "fsb9", "dictionary",
             "utf8"]


def _shared_dictionary(keys, valid):
    """A dictionary<int32, utf8> column of WORDS in each package, every
    column of one package over one dictionary."""
    protos = getattr(_shared_dictionary, "protos", None)
    if protos is None:
        protos = _shared_dictionary.protos = (
            jcol.dictionary_encode_host(WORDS),
            pcol.dictionary_encode_host(WORDS, device="cpu"))
    jp, pp = protos
    keys = keys.astype(np.int32)
    return (jcol.DictionaryColumn(
        jcol.primitive(keys, jst.int32, validity=jbm.from_numpy_bools(valid),
                       length=len(keys)), jp.values, jp.value_ranks, jp.dtype),
        pcol.DictionaryColumn(pcol.primitive(keys, pst.int32, validity=valid,
                                             device="cpu"),
                              pp.values, pp.value_ranks, pp.dtype))


def _typed_join_inputs(kind, seed, n_left=400, n_right=150):
    """Probe keys of a class drawn from the first 24 values of a pool,
    build keys from its first 16 (an N:M join), 10 % null keys on both
    sides, an int64 payload on the left and an int32 one on the right."""
    rng = np.random.default_rng(seed)
    if kind == "float64":
        pool = np.unique(_floats(rng, kind, 200).view(np.uint64)).view(
            np.float64)
    elif kind != "dictionary":  # strings of at most 14 bytes on both sides
        pool = _pool(rng, kind, 24, repeats=4)
    out = []
    for n, hi, payload, dt in ((n_left, 24, "lv", "int64"),
                               (n_right, 16, "rv", "int32")):
        draw = rng.integers(0, hi, n)
        valid = rng.random(n) >= 0.1
        if kind == "float64":
            vals = pool[draw]
            key = (tp.jax_column(vals, valid, kind),
                   tp.port_column(vals, valid, kind))
        elif kind == "dictionary":
            key = _shared_dictionary(draw % len(WORDS), valid)
        else:
            key = _key_columns(rng, kind, n, 0.1, draw, pool)
        pay = _columns(rng, dt, n, 0.2, -1000, 1000)
        out.append((jbt.record_batch({"k": key[0], payload: pay[0]}),
                    pbt.record_batch({"k": key[1], payload: pay[1]})))
    return out


@pytest.mark.parametrize("kind", JOIN_KEYS)
def test_hash_join_on_every_key_class(kind, jax_joins):
    """An N:M inner join on a float64 (signed zeros and NaNs by their
    bits), Decimal128, Date64, fixed-size binary, dictionary (one
    dictionary on both sides) and utf8 key, against the JAX package."""
    out, info = _check_join(kind, jax_joins, ["k"], "inner", 4096)
    assert out.length > 0 and bool(info.duplicates)


def _oracle_pairs(left_keys, right_keys):
    """(left row, right row) of an inner join on the host: probe rows in
    order, each one's build matches in row order; None keys never match."""
    return [(i, j) for i, a in enumerate(left_keys) if a is not None
            for j, b in enumerate(right_keys) if b == a]


def test_string_keys_of_two_widths_match_the_oracle():
    """Left keys of at most 12 bytes (a 16-byte matrix), right keys up to
    40 bytes (48): one width for both sides, so equal strings meet and
    the output is the host oracle's pairs.  (The JAX package encodes each
    side at its own width: left ["ab", "cd", "ef"] against right ["ab",
    "cd", "x" * 40] gives it 0 rows, against ["ab", "cd", "xy"] 2.)"""
    rng = np.random.default_rng(41)
    short = ["ab", "cd", "ef", "", "twelve bytes", "a"]
    long_ = short[:3] + ["x" * 40, "twelve bytes!", "y" * 13]
    lk = [None if rng.random() < 0.1 else short[i]
          for i in rng.integers(0, len(short), 300)]
    rk = [long_[i] for i in rng.integers(0, len(long_), 90)]
    left = pbt.record_batch({"k": pcol.from_pylist(lk, pst.utf8, "cpu"),
                             "i": tp.port_column(np.arange(300), None,
                                                 "int64")})
    right = pbt.record_batch({"k": pcol.from_pylist(rk, pst.utf8, "cpu"),
                              "j": tp.port_column(np.arange(90), None,
                                                  "int64")})
    assert [c.len_bound for c in (left["k"], right["k"])] == [12, 40]
    out, _ = pjoin.hash_join(left, right, ["k"])
    got = list(zip(out["i"].to_pylist(), out["j"].to_pylist()))
    want = _oracle_pairs(lk, rk)
    assert got == want and len(want) > 0
    three, _ = pjoin.hash_join(
        pbt.record_batch({"k": pcol.from_pylist(["ab", "cd", "ef"],
                                                pst.utf8, "cpu")}),
        pbt.record_batch({"k": pcol.from_pylist(["ab", "cd", "x" * 40],
                                                pst.utf8, "cpu"),
                          "r": tp.port_column(np.arange(3), None, "int64")}),
        ["k"])
    assert three["k"].to_pylist() == ["ab", "cd"]


def test_dictionary_keys_of_two_dictionaries_raise():
    """Left ["a", "b", "a"] against right ["b", "c"], each in its own
    dictionary: the ranks (a=0, b=1 | b=0, c=1) name other strings on the
    two sides (the JAX package joins a-b, b-c, a-b: 3 rows where 1 is
    right), so the port raises; equal dictionaries built apart join."""
    import arrowtpu_torch as pt

    def side(words):
        return pbt.record_batch({"k": pcol.dictionary_encode_host(
            words, device="cpu")})

    with pytest.raises(pt.schema.ComputeError):
        pjoin.hash_join(side(["a", "b", "a"]), side(["b", "c"]), ["k"])
    with pytest.raises(pt.schema.ComputeError):
        pjoin.hash_join(side(["a", "b"]),
                        pbt.record_batch({"k": pcol.from_pylist(
                            ["a"], pst.utf8, "cpu")}), ["k"])
    out, _ = pjoin.hash_join(side(["b", "a", "b"]), side(["b", "a"]),
                             ["k"], how="semi")
    assert out["k"].to_pylist() == ["b", "a", "b"]
