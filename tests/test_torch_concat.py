"""arrowtpu_torch's concat and concat_batches against the JAX package's
`arrowtpu.ops.concat` on the same numpy inputs: int32, int64, float64
(NaN and -0.0 among them) with and without nulls, bool, null, string
views (inline and long strings) and dictionary columns sharing one
dictionary; zero-length and single inputs; and the errors both raise.

Tolerance: bit-exact per column (values below the length, values under
nulls included; validity as bools; length; zero padding; float64 by its
bits).  String views are compared as strings, with their `len_bound`:
their arena offsets are rebased by arena capacities, which are the
packages' own (a granule of 64 bytes here, 128 there).  Output
capacities are the packages' own (here the length rounded up to 64)."""

import numpy as np
import pytest

import torch_parity as tp
from torch_parity import release_jax_caches  # noqa: F401
from arrowtpu import schema as jst
from arrowtpu.core import batch as jbt
from arrowtpu.core import column as jcol
from arrowtpu.ops.concat import concat as jax_concat
from arrowtpu.ops.concat import concat_batches as jax_concat_batches
from arrowtpu_torch import schema as pst
from arrowtpu_torch.core import batch as pbt
from arrowtpu_torch.core import column as pcol
from arrowtpu_torch.ops.concat import concat, concat_batches

# the inputs' lengths: several, a zero-length one among them, one alone,
# and none with a row
LENGTHS = {"mixed": (100, 0, 37, 64), "single": (70,), "empty": (0, 0)}


def _values(rng, dtype, n):
    if dtype == "float64":
        v = rng.standard_normal(n)
        v[::7] = np.nan
        v[3::11] = -0.0
        return v
    if dtype == "bool":
        return rng.random(n) < 0.5
    lo, hi = (-2**31, 2**31) if dtype == "int32" else (-2**62, 2**62)
    return rng.integers(lo, hi, n)


def _jax_input(v, valid, dtype):
    if len(v) or valid is None:
        return tp.jax_column(v, valid, dtype)
    # JAX columns take no empty bitmap: one null row, cut to length 0
    return tp.jax_column(np.zeros(1, v.dtype), np.zeros(1, bool),
                         dtype).with_length(0)


def _pairs(dtype, lengths, nulls):
    """(JAX column, port column) per input; with nulls = "some" only the
    second input has a bitmap."""
    rng = np.random.default_rng(len(lengths) * 31 + len(dtype))
    out = []
    for i, n in enumerate(lengths):
        valid = (rng.random(n) > 0.3
                 if nulls == "all" or (nulls == "some" and i == 1) else None)
        v = _values(rng, dtype, n)
        out.append((_jax_input(v, valid, dtype),
                    tp.port_column(v, valid, dtype)))
    return out


def _bits(v):
    return v.view(np.uint64) if v.dtype == np.float64 else v


def _assert_equal(jc, pc):
    jv, jok, jn = tp.jax_to_numpy(jc)
    pv, pok, pn = tp.pt.column_to_numpy(pc)
    assert (pn, str(pc.dtype)) == (jn, str(jc.dtype))
    assert pc.capacity == max(-(-pn // 64) * 64, 64)
    np.testing.assert_array_equal(pok, jok)
    np.testing.assert_array_equal(_bits(pv), _bits(jv))
    tp.assert_zero_padding(pc)
    assert (pc.validity is None) == (jc.validity is None)


@pytest.mark.parametrize("nulls", ["none", "some", "all"])
@pytest.mark.parametrize("lengths", sorted(LENGTHS))
@pytest.mark.parametrize("dtype", ["int32", "int64", "float64", "bool"])
def test_concat_matches(dtype, lengths, nulls):
    jcols, pcols = zip(*_pairs(dtype, LENGTHS[lengths], nulls))
    _assert_equal(jax_concat(list(jcols)), concat(list(pcols)))


def test_null_columns():
    got = concat([pcol.null_column(n, device="cpu") for n in (5, 0, 70)])
    want = jax_concat([jcol.null_column(n) for n in (5, 0, 70)])
    assert (got.length, got.capacity) == (int(want.length), 128)
    assert got.to_pylist() == want.to_pylist() == [None] * 75


STRINGS = [["pear", None, "a string longer than twelve", "", "fig"],
           [],
           ["thirteen bytes", None, "b", "another long string, 31 bytes"],
           ["x" * 40]]


@pytest.mark.parametrize("parts", [STRINGS, STRINGS[2:3], [[], []]])
def test_string_views(parts):
    got = concat([pcol.string_view(p, device="cpu") for p in parts])
    want = jax_concat([jcol.string_view(p) for p in parts])
    assert got.to_pylist() == want.to_pylist() == sum(parts, [])
    assert got.len_bound == want.len_bound
    assert (got.validity is None) == (want.validity is None)
    assert not got.views[got.length:].any()


def test_string_view_len_bound_none():
    a = pcol.string_view(["short"], device="cpu")
    b = pcol.StringViewColumn(a.views, a.arena, None, 1, a.dtype, None)
    assert concat([a, a]).len_bound == 5
    assert concat([a, b]).len_bound is None


def _dictionaries(proto_j, proto_p, lengths):
    out = []
    for i, n in enumerate(lengths):
        rng = np.random.default_rng(i)
        keys = rng.integers(0, 4, n).astype(np.int32)
        valid = rng.random(n) > 0.2
        out.append((
            jcol.DictionaryColumn(_jax_input(keys, valid, "int32"),
                                  proto_j.values, proto_j.value_ranks,
                                  proto_j.dtype),
            pcol.DictionaryColumn(tp.port_column(keys, valid, "int32"),
                                  proto_p.values, proto_p.value_ranks,
                                  proto_p.dtype)))
    return out


def test_dictionary_columns_sharing_one_dictionary():
    words = ["b", "a long dictionary word", None, "c", "a"]
    proto_j = jcol.dictionary_encode_host(words)
    proto_p = pcol.dictionary_encode_host(words, device="cpu")
    jcols, pcols = zip(*_dictionaries(proto_j, proto_p, (30, 0, 70)))
    want = jax_concat(list(jcols))
    got = concat(list(pcols))
    _assert_equal(want.keys, got.keys)
    assert got.values is proto_p.values
    assert got.to_pylist() == want.to_pylist()


def test_concat_batches_matches():
    parts = [_pairs(dt, (40, 0, 90), "all") for dt in ("int64", "bool")]
    jb = [jbt.record_batch({"a": parts[0][i][0], "b": parts[1][i][0]})
          for i in range(3)]
    pb = [pbt.record_batch({"a": parts[0][i][1], "b": parts[1][i][1]})
          for i in range(3)]
    want, got = jax_concat_batches(jb), concat_batches(pb)
    assert got.schema.names == ["a", "b"]
    for name in ("a", "b"):
        _assert_equal(want[name], got[name])


def test_errors_raise_in_both_packages():
    pi = tp.port_column(np.arange(3), None, "int64")
    pbool = tp.port_column(np.ones(3, bool), None, "bool")
    ji = tp.jax_column(np.arange(3), None, "int64")
    jbool = tp.jax_column(np.ones(3, bool), None, "bool")
    cases = [
        ([ji, jbool], [pi, pbool], "mixed column kinds"),
        ([], [], "no inputs"),
    ]
    words = ["x", "y"]
    jd = [jcol.dictionary_encode_host(words) for _ in range(2)]
    pd = [pcol.dictionary_encode_host(words, device="cpu") for _ in range(2)]
    cases.append((jd, pd, "distinct dictionaries"))
    for jargs, pargs, what in cases:
        with pytest.raises(jst.ComputeError, match=what):
            jax_concat(jargs)
        with pytest.raises(pst.ComputeError, match=what):
            concat(pargs)
    with pytest.raises(jst.SchemaError, match="schema mismatch"):
        jax_concat_batches([jbt.record_batch({"a": ji}),
                            jbt.record_batch({"b": ji})])
    with pytest.raises(pst.SchemaError, match="schema mismatch"):
        concat_batches([pbt.record_batch({"a": pi}),
                        pbt.record_batch({"b": pi})])
    with pytest.raises(pst.ComputeError, match="no inputs"):
        concat_batches([])
