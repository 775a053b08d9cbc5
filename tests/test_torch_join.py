"""arrowtpu_torch's key hash, take and hash join against the JAX package's
on the same numpy inputs (the JAX join under `jax.jit` on the CPU
backend).  Tolerance: bit-exact (hashes; values below the length, values
under nulls included; validity as bools; length; zero padding; the join's
duplicates and overflow flags)."""

import jax
import numpy as np
import pytest

import torch_parity as tp
from arrowtpu.core import batch as jbt
from arrowtpu.core import column as jcol
from arrowtpu.ops import join as jjoin
from arrowtpu.ops.take import take as jax_take
from arrowtpu.ops.take import take_record_batch as jax_take_batch
from arrowtpu.rowformat import encode as jenc
from arrowtpu.rowformat import hashing as jhash
from arrowtpu_torch import null_column
from arrowtpu_torch.core import batch as pbt
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


@pytest.mark.parametrize("seed", [0, 0x5157])
@pytest.mark.parametrize("dtypes", [["int64"], ["int32"], ["bool"],
                                    ["int8", "uint8"], ["int64", "bool"]])
def test_hash_planes_match(dtypes, seed):
    rng = np.random.default_rng(len(dtypes) * 7 + seed)
    n = 1000
    jcols, pcols = zip(*(_columns(rng, dt, n, 0.2) for dt in dtypes))
    want = np.asarray(jhash.hash_planes(jenc.encode_columns(list(jcols)),
                                        seed=seed))[:n]
    got = phash.hash_planes(penc.hash_planes_of(list(pcols)), seed=seed)
    np.testing.assert_array_equal(got.numpy()[:n], want.astype(np.int64))


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


_jax_hash_join = jax.jit(jjoin.hash_join,
                         static_argnames=("on", "how", "out_capacity"))


def _check_join(left, right, on, how, out_capacity):
    (jl, pl), (jr, pr) = left, right
    jout, jinfo = _jax_hash_join(jl, jr, on=tuple(on), how=how,
                                 out_capacity=out_capacity)
    pout, pinfo = pjoin.hash_join(pl, pr, on, how=how,
                                  out_capacity=out_capacity)
    tp.assert_batch_equal(jout, pout)
    assert bool(pinfo.duplicates) == bool(jinfo.duplicates)
    assert bool(pinfo.overflow) == bool(jinfo.overflow)
    return pout, pinfo


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
def test_hash_join_n_to_m_with_null_keys(how):
    left, right = _join_inputs(21)
    out, info = _check_join(left, right, ["k"], how, 4096)
    assert bool(info.duplicates) and out.length > 0


@pytest.mark.parametrize("how", ["inner", "left"])
def test_hash_join_two_key_columns(how):
    left, right = _join_inputs(22, key_nulls=0.05)
    _check_join(left, right, ["k", "b"], how, 4096)


def test_hash_join_out_capacity_truncates():
    """An output cut to out_capacity rows sets overflow in both."""
    left, right = _join_inputs(23)
    out, info = _check_join(left, right, ["k"], "inner", 256)
    assert info.overflow and out.length == 256


def test_hash_join_default_capacity_is_the_whole_output():
    """The port sizes its output to the join's length (read back once)."""
    (jl, pl), (jr, pr) = _join_inputs(24)
    jout, _ = _jax_hash_join(jl, jr, on=("k",), how="left",
                             out_capacity=4096)
    pout, info = pjoin.hash_join(pl, pr, ["k"], how="left")
    assert not info.overflow and pout.capacity == -(-pout.length // 64) * 64
    tp.assert_batch_equal(jout, pout)


def test_unique_build_keys_have_no_duplicates():
    rng = np.random.default_rng(25)
    lk = rng.integers(0, 150, 400)
    rk = rng.permutation(100)
    jl, pl = (tp.jax_column(lk, None, "int64"), tp.port_column(lk, None,
                                                               "int64"))
    jr, pr = (tp.jax_column(rk, None, "int64"), tp.port_column(rk, None,
                                                               "int64"))
    _check_join((jbt.record_batch({"k": jl}), pbt.record_batch({"k": pl})),
                (jbt.record_batch({"k": jr}), pbt.record_batch({"k": pr})),
                ["k"], "inner", None)
