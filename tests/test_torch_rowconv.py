"""arrowtpu_torch.rowformat.decode (RowConverter) and the struct / list-view
sort keys of rowformat/encode.py against arrowtpu on the same inputs.

The round trip runs over int8-int64, uint8-uint32, float32 / float64
(NaNs of both signs and payloads, +-0, +-inf), bool, date32, timestamp,
utf8 (inline and arena strings) and a dictionary, in the four option
pairs.  The planes are held three ways (plane packing is not part of the
contract, so they are not compared bit for bit with the JAX package's u32
planes): sorting by them gives `arrowtpu.ops` lexsort's order; decoding
them gives the input back exactly (floats by their bits, null rows zero);
and the decoded columns equal the JAX package's decode of its own planes
on every valid row (validity as bools; the JAX package decodes a null row
to the type's minimum, the port to zero).  Decimals are held to their
input alone: the JAX decoder has no decimal branch and raises (ROADMAP
C.3).  Struct and list-view sort keys (lists longer than LIST_SORT_BOUND
included) give the JAX package's indices exactly.  Every case has N rows,
so the JAX side compiles few shapes; its round trip runs under `jax.jit`
(one compile in place of one a primitive).
"""

import numpy as np
import pytest

import torch_parity as tp
import arrowtpu.schema as js
from arrowtpu.config import SortOptions as JOpts
from arrowtpu.core import column as jcol
from arrowtpu.ops import sortmod as jsort
from arrowtpu.rowformat.decode import RowConverter as JConverter

import arrowtpu_torch as pt
import arrowtpu_torch.schema as ps
from arrowtpu_torch.config import LIST_SORT_BOUND
from arrowtpu_torch.config import SortOptions as POpts
from arrowtpu_torch.core import column as pcol
from arrowtpu_torch.ops import sortmod as psort
from arrowtpu_torch.rowformat import pack as ppack
from arrowtpu_torch.rowformat.decode import RowConverter
from test_torch_nested import _values

N = 120
ORDERS = [(False, True), (False, False), (True, True), (True, False)]
NUMERIC = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
           "float32", "float64", "bool"]
CLASSES = ["date32", "timestamp", "utf8", "dictionary"]
F64 = np.array([0, 0x8000000000000000, 0x7FF0000000000000,
                0xFFF0000000000000, 0x7FF8000000000000, 0xFFF8000000000000,
                0x7FF0000000000001, 0xFFF0000000000123], np.uint64)
F32 = np.array([0, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000,
                0xFFC00000, 0x7F800001, 0xFF800123], np.uint32)


def _numeric(name, rng):
    if name == "bool":
        return rng.random(N) < 0.5
    if name.startswith("float"):
        v = np.round(rng.standard_normal(N) * 4, 1).astype(name)
        special = (F64 if name == "float64" else F32).view(name)
        v[rng.choice(N, 2 * len(special), replace=False)] = np.tile(special, 2)
        return v
    info = np.iinfo(name)
    v = rng.integers(max(info.min, -40), min(info.max, 40), N).astype(name)
    v[:2] = [info.min, info.max]
    return v


def _columns(seed):
    """(JAX columns, port columns): NUMERIC then CLASSES, ~15 % nulls."""
    rng = np.random.default_rng(seed)
    jcols, pcols = [], []
    for name in NUMERIC:
        vals, valid = _numeric(name, rng), rng.random(N) > 0.15
        jcols.append(tp.jax_column(vals, valid, name))
        pcols.append(tp.port_column(vals, valid, name))
    for kind in CLASSES:
        jdt, pdt, vals = _values(kind, rng, N)
        jcols.append(jcol.from_pylist(vals, jdt))
        pcols.append(pcol.from_pylist(vals, pdt, device="cpu"))
    return jcols, pcols


def _bits(v):
    if v.dtype.kind == "f":
        return v.view(np.uint64 if v.itemsize == 8 else np.uint32)
    return v


def _logical(c):
    """(valid bools, values under valid as Python values or bits)."""
    if isinstance(c, (pt.StringViewColumn, jcol.StringViewColumn)) or \
            isinstance(c, (pcol.DictionaryColumn, jcol.DictionaryColumn)):
        rows = c.to_pylist()
        return np.array([r is not None for r in rows]), rows
    if isinstance(c, pt.Column):
        vals, ok, _ = pt.column_to_numpy(c)
    else:
        vals, ok, _ = tp.jax_to_numpy(c)
    return ok, [x if o else None for x, o in zip(_bits(vals).tolist(), ok)]


def _rotated(k, n, cls):
    """Column i's options: ORDERS[(i + k) % 4], so each case covers the
    four option pairs."""
    return [cls(*ORDERS[(i + k) % 4]) for i in range(n)]


@pytest.mark.parametrize("k", range(4))
def test_round_trip_matches_input_and_jax(k):
    jcols, pcols = _columns(k)
    jopts, popts = _rotated(k, len(jcols), JOpts), _rotated(k, len(pcols),
                                                              POpts)
    rc = RowConverter(popts)
    planes = rc.convert_columns(pcols)
    back = rc.convert_rows(planes, N)
    jrc = JConverter(jopts)
    jback = tp.jit(lambda cs: jrc.convert_rows(jrc.convert_columns(cs),
                                                N))(jcols)
    for name, src, got, jgot in zip(NUMERIC + CLASSES, pcols, back, jback):
        assert str(got.dtype) == str(src.dtype), name
        tp.assert_zero_padding(got)
        assert _logical(got)[1] == _logical(src)[1], f"{name}: round trip"
        assert _logical(got)[1] == _logical(jgot)[1], f"{name}: JAX decode"
        if isinstance(got, pt.PrimitiveColumn):  # null rows decode to 0
            vals, ok, _ = pt.column_to_numpy(got)
            assert not _bits(vals)[~ok].any(), name
    if k:
        return
    # sorting by the planes gives the JAX package's order (one JAX sort,
    # over four of the columns: its compile time grows with the planes)
    pick = [NUMERIC.index("float64"), NUMERIC.index("uint32"),
            len(NUMERIC) + CLASSES.index("utf8"),
            len(NUMERIC) + CLASSES.index("dictionary")]
    sub = RowConverter([popts[i] for i in pick])
    perm = ppack.sort_permutation(sub.convert_columns(
        [pcols[i] for i in pick]), pcols[0].capacity, N)[:N]
    want = tp.jit(lambda cs: jsort.lexsort_to_indices(
        cs, [jopts[i] for i in pick]))([jcols[i] for i in pick])
    np.testing.assert_array_equal(perm.numpy(), np.asarray(want.values)[:N])


@pytest.mark.parametrize("descending,nulls_first", ORDERS)
def test_decimals_round_trip_to_their_input(descending, nulls_first):
    """Fault 9 of ROADMAP C.3: the JAX decoder reads a decimal's limbs as
    one int plane and raises; the port gives its input back."""
    rng = np.random.default_rng(7)
    kinds = ["decimal32", "decimal64", "decimal128", "decimal256"]
    pairs = [_values(k, rng, N) for k in kinds]
    pcols = [pcol.from_pylist(v, pdt, device="cpu") for _, pdt, v in pairs]
    rc = RowConverter([POpts(descending, nulls_first)] * len(kinds))
    back = rc.convert_rows(rc.convert_columns(pcols), N)
    for (_, _, vals), got in zip(pairs, back):
        assert got.to_pylist() == vals
        tp.assert_zero_padding(got)
    if (descending, nulls_first) == ORDERS[0]:
        jdt, _, vals = pairs[2]
        jrc = JConverter()
        with pytest.raises(js.ComputeError):
            jrc.convert_rows(jrc.convert_columns(
                [jcol.from_pylist(vals, jdt)]), N)


@pytest.mark.parametrize("kind", ["struct", "list", "interval_day_time"])
def test_unsupported_columns_raise(kind):
    rng = np.random.default_rng(8)
    _, pdt, vals = _values(kind, rng, N)
    with pytest.raises(ps.ComputeError):
        RowConverter().convert_columns([pcol.from_pylist(vals, pdt,
                                                         device="cpu")])


def _lists(rng):
    """Lists of 0-12 small ints with null lists and elements: many share
    their first LIST_SORT_BOUND elements and differ past them."""
    prefix = [int(x) for x in rng.integers(0, 2, LIST_SORT_BOUND)]
    out = []
    for _ in range(N):
        if rng.random() < 0.1:
            out.append(None)
            continue
        size = int(rng.integers(0, LIST_SORT_BOUND + 5))
        row = [None if rng.random() < 0.05 else int(x)
               for x in rng.integers(0, 3, size)]
        if rng.random() < 0.4 and size > LIST_SORT_BOUND:
            row[:LIST_SORT_BOUND] = prefix
        out.append(row)
    return js.List(js.int64), ps.List(ps.int64), out


def _key(kind, seed):
    """(JAX column, port column) of a list or struct sort key."""
    rng = np.random.default_rng(seed)
    if kind == "list":
        jdt, pdt, vals = _lists(rng)
    else:
        jdt, pdt, vals = _values("struct", rng, N)
    return (jcol.from_pylist(vals, jdt),
            pcol.from_pylist(vals, pdt, device="cpu"))


def _indices(jidx, pidx):
    n = int(jidx.length)
    assert pidx.length == n and not pidx.values[n:].any()
    np.testing.assert_array_equal(pidx.values[:n].numpy(),
                                  np.asarray(jidx.values)[:n])


def _host_key(kind, row):
    """The sort key of a valid row: a list's (present, element valid,
    element) triples up to LIST_SORT_BOUND, then its length; a struct's
    children in field order, each (valid, value), ascending nulls first."""
    if kind == "list":
        return tuple((1, 0, 0) if j < len(row) and row[j] is None else
                     (1, 1, row[j]) if j < len(row) else (0, 0, 0)
                     for j in range(LIST_SORT_BOUND)) + (len(row),)
    return tuple((0,) if v is None else (1, v.encode() if isinstance(v, str)
                                         else v) for v in row.values())


def _host_order(kind, rows, descending, nulls_first):
    """Stable order of the rows (Python's sort keeps equal rows in order,
    reversed too)."""
    valid = [i for i, r in enumerate(rows) if r is not None]
    nulls = [i for i, r in enumerate(rows) if r is None]
    valid = sorted(valid, key=lambda i: _host_key(kind, rows[i]),
                   reverse=descending)
    return nulls + valid if nulls_first else valid + nulls


@pytest.mark.parametrize("descending,nulls_first", ORDERS)
@pytest.mark.parametrize("kind", ["struct", "list"])
def test_struct_and_list_keys_sort_as_the_host(kind, descending,
                                               nulls_first):
    jc, pc = _key(kind, 20)
    got = psort.sort_to_indices(pc, POpts(descending, nulls_first))
    np.testing.assert_array_equal(got.values[:N].numpy(), _host_order(
        kind, pc.to_pylist(), descending, nulls_first))


KEY_SORTS = {"list": (True, False), "struct": (False, True)}


@pytest.fixture(scope="module")
def jax_key_sorts():
    """{kind: the JAX package's indices} of the struct and the list key,
    a `jax.jit` each (about 11 s each eagerly)."""
    return {kind: tp.jit(lambda c, o=JOpts(*opts): jsort.sort_to_indices(
        c, o))(_key(kind, 20)[0]) for kind, opts in KEY_SORTS.items()}


@pytest.mark.parametrize("kind,opts", list(KEY_SORTS.items()))
def test_struct_and_list_keys_sort_as_jax(kind, opts, jax_key_sorts):
    _, pc = _key(kind, 20)
    _indices(jax_key_sorts[kind], psort.sort_to_indices(pc, POpts(*opts)))


def test_list_rank_and_partition():
    """rank against the host order's ties; partition against the JAX
    package's on the host-sorted lists."""
    jdt, pdt, rows = _lists(np.random.default_rng(22))
    pc = pcol.from_pylist(rows, pdt, device="cpu")
    order = _host_order("list", rows, False, True)
    keys = [None if rows[i] is None else _host_key("list", rows[i])
            for i in order]
    last = {k: pos + 1 for pos, k in enumerate(keys)}
    want = np.zeros(N, np.int64)
    want[order] = [last[k] for k in keys]
    np.testing.assert_array_equal(psort.rank(pc).values[:N].numpy(), want)
    ordered = [rows[i] for i in order]
    tp.assert_column_equal(
        jsort.partition([jcol.from_pylist(ordered, jdt)]),
        psort.partition([pcol.from_pylist(ordered, pdt, device="cpu")]),
        "partition")
