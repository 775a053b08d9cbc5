"""arrowtpu_torch's LIKE family, regular expressions, substring,
concat_elements and case mapping (ops/strings.py) against arrowtpu.ops on
the same strings, and TPC-H Q19's pushed-down predicates (entry.py)
against the same predicates composed from arrowtpu.ops.

Tolerance: exact.  Booleans and validity as bools, length, zero padding;
string results by their views, strings and `len_bound`
(`torch_parity.assert_column_equal`).  The strings mix inline (at most 12
bytes) and arena ones, the empty string, multi-byte UTF-8 and nulls;
every column has N rows, so the JAX side compiles few shapes.
"""

import decimal

import numpy as np
import pytest

import test_torch_q14 as q14
import torch_parity as tp
from torch_parity import release_jax_caches  # noqa: F401
from arrowtpu import ops as jops
from arrowtpu import schema as jst
from arrowtpu.core import column as jcol
from arrowtpu.ops import strings as jstr

from arrowtpu_torch import entry as pe
from arrowtpu_torch import ops as pops
from arrowtpu_torch import schema as pst
from arrowtpu_torch.core import column as pcol
from arrowtpu_torch.ops import strings as pstr

N = 120
WORDS = ["PROMO BRUSHED TIN", "STANDARD ANODIZED BRASS", "promo plated",
         "forest green lace", "Brand#12", "Brand#23", "", "a%b", "a_b",
         "MEDIUM POLISHED STEEL", "dark green", "été", "ÉTÉ forest",
         "SM CASE", "x", "greengreen", "LARGE BRASS", "ab"]
# every compiled kind: eq, starts, ends, contains and the regex tail
PATTERNS = ["PROMO%", "%BRASS", "%green%", "Brand#12", "P_OMO%", "%a%b%",
            "", "%", "%%", "a\\%b", "été%", "MEDIUM POLISHED%"]
# one pattern of each kind, for the dictionary path
KINDS = ["PROMO%", "%BRASS", "%green%", "Brand#12", "P_OMO%", ""]


def _strings(seed, nulls=0.1):
    rng = np.random.default_rng(seed)
    out = [WORDS[i] for i in rng.integers(0, len(WORDS), N)]
    return [None if rng.random() < nulls else s for s in out]


def _pair(data):
    return (jcol.string_view(data, jst.utf8),
            pcol.string_view(data, pst.utf8, device="cpu"))


def _dict_pair(data):
    return (jcol.dictionary_encode_host(data),
            pcol.dictionary_encode_host(data, device="cpu"))


def test_compile_like_matches_jax():
    for p in PATTERNS + ["a%b%", "%%x", "x\\%", "_", "\\"]:
        j, q = jstr.compile_like(p), pstr.compile_like(p)
        assert (q.kind, q.payload) == (j.kind, j.payload), p


@pytest.mark.parametrize("dictionary", [False, True])
def test_like_family_matches_jax(dictionary):
    """like / nlike / ilike / nilike over every pattern kind, on views and
    on a dictionary (evaluated on its values, gathered by key)."""
    data = _strings(1)
    jc, pc = _dict_pair(data) if dictionary else _pair(data)
    for p in KINDS if dictionary else PATTERNS:
        for op in ("like", "nlike", "ilike", "nilike"):
            got = getattr(pops, op)(pc, p)
            tp.assert_column_equal(getattr(jops, op)(jc, p), got,
                                   f"{op} {p!r}")
    for op, arg in (("starts_with", "PROMO"), ("ends_with", "BRASS"),
                    ("contains", "green"), ("contains", ""),
                    ("ends_with", "a much longer suffix than any string")):
        tp.assert_column_equal(getattr(jops, op)(jc, arg),
                               getattr(pops, op)(pc, arg), f"{op} {arg!r}")


def test_like_on_arena_strings_and_no_nulls():
    """Strings of 13-40 bytes (in the arena), every row valid, patterns at
    the matrix's edges."""
    rng = np.random.default_rng(2)
    data = ["".join(rng.choice(list("ab "), int(n)))
            for n in rng.integers(13, 41, N)]
    jc, pc = _pair(data)
    for p in ("%ab", "ab%", "%aba%", "%" + data[0][-16:], data[3], "a_b%"):
        for op in ("like", "nlike", "ilike"):
            tp.assert_column_equal(getattr(jops, op)(jc, p),
                                   getattr(pops, op)(pc, p), f"{op} {p!r}")


@pytest.mark.parametrize("dictionary", [False, True])
def test_regexp_is_match_matches_jax(dictionary):
    """Unanchored search (LIKE's regex is anchored), on the host."""
    data = _strings(3)
    jc, pc = _dict_pair(data) if dictionary else _pair(data)
    for pattern, flags in (("green", ""), ("^Brand#[0-9]+$", ""),
                           ("promo", "i"), ("t.t", ""), ("", "")):
        tp.assert_column_equal(jops.regexp_is_match(jc, pattern, flags),
                               pops.regexp_is_match(pc, pattern, flags),
                               f"regexp {pattern!r} {flags!r}")


def test_substring_matches_jax():
    """Byte offsets (a cut inside a UTF-8 character is not a string the
    parity helper can decode, so the strings here are ASCII)."""
    jc, pc = _pair([s if s is None or s.isascii() else "ascii text"
                    for s in _strings(4)])
    for start, length in ((0, None), (2, 5), (-4, None), (-4, 2), (30, 3),
                          (0, 0), (5, 100), (-100, 3)):
        tp.assert_column_equal(jops.substring(jc, start, length),
                               pops.substring(pc, start, length),
                               f"substring({start}, {length})")


def test_concat_elements_matches_jax():
    (ja, pa), (jb, pb) = _pair(_strings(5)), _pair(_strings(6, nulls=0.2))
    tp.assert_column_equal(jops.concat_elements(ja, jb),
                           pops.concat_elements(pa, pb), "concat")
    tp.assert_column_equal(jops.concat_elements(jb, ja),
                           pops.concat_elements(pb, pa), "concat reversed")


def test_case_maps_match_jax():
    """ASCII columns map on the device (the matrix width as len_bound);
    a column with a non-ASCII byte maps on the host (full Unicode); a
    dictionary maps its values."""
    ascii_data = [s if s is None or s.isascii() else "plain" for s in
                  _strings(7)]
    for data in (ascii_data, _strings(8)):
        jc, pc = _pair(data)
        for op in ("lower", "upper"):
            tp.assert_column_equal(getattr(jops, op)(jc),
                                   getattr(pops, op)(pc), op)
    jd, pd = _dict_pair(ascii_data)
    got = pops.upper(pd)
    assert got.value_ranks is None
    tp.assert_column_equal(jops.upper(jd), got, "upper dictionary")


def test_string_ops_raise_on_non_strings():
    c = pcol.primitive(np.arange(4), device="cpu")
    for op in ("like", "ilike"):
        with pytest.raises(pst.ComputeError):
            getattr(pops, op)(c, "a%")
    with pytest.raises(pst.ComputeError):
        pops.substring(c, 1)


def _jax_dictionary(codes, words):
    return jcol.dictionary_encode_host([words[c] for c in codes])


def test_q19_pushdowns_match_jax():
    """The port's two pushed-down predicates against the same predicates
    composed from arrowtpu.ops on the same rows (the first 120 of each
    table, moved into the branches as in `_q19_rich`: one capacity for the
    columns and the dictionaries' values, so that JAX compiles one byte
    matrix a width)."""
    la, pa = q14._q19_rich(pe.example_lineitem_arrays(q14.SF),
                           pe.example_part_arrays(q14.SF))
    n = 120

    def head(arrays):  # a (bytes, starts, lengths) column keeps its bytes
        return {k: v[:n] if not isinstance(v, tuple) else
                (v[0], v[1][:n], v[2][:n]) for k, v in arrays.items()}
    la, pa = head(la), head(pa)
    port_li = pe.lineitem_batch(la, "cpu")
    port_pa = pe.part_batch(pa, "cpu")

    qty = jcol.from_pylist([decimal.Decimal(int(c)).scaleb(-2)
                            for c in la["l_quantity"]], jst.Decimal128(15, 2))
    mode = _jax_dictionary(la["l_shipmode"], pe.SHIPMODE)
    instr = _jax_dictionary(la["l_shipinstruct"], pe.SHIPINSTRUCT)
    jmode = jops.or_(jops.like(mode, "AIR"), jops.like(mode, "AIR REG"))
    want = jops.and_kleene(jops.and_kleene(
        jmode, jops.like(instr, "DELIVER IN PERSON")),
        jops.and_kleene(jops.gt_eq(qty, 1), jops.lt_eq(qty, 30)))
    tp.assert_column_equal(want, pe.q19_lineitem_predicate(port_li),
                           "lineitem pushdown")

    brand = jcol.string_view(q14._strings(pa, "p_brand"), jst.utf8)
    cont = jcol.string_view(q14._strings(pa, "p_container"), jst.utf8)
    size = tp.jax_column(pa["p_size"], None, "int32")
    branches = []
    for b, cs, _, smax in pe.Q19_BRANCHES:
        inside = jops.like(cont, cs[0])
        for c in cs[1:]:
            inside = jops.or_(inside, jops.like(cont, c))
        branches.append(jops.and_kleene(jops.and_kleene(
            jops.like(brand, b), inside), jops.and_kleene(
            jops.gt_eq(size, 1), jops.lt_eq(size, smax))))
    want = jops.or_kleene(jops.or_kleene(branches[0], branches[1]),
                          branches[2])
    got = pe.q19_part_predicate(port_pa)
    tp.assert_column_equal(want, got, "part pushdown")
    assert got.values_bool()[:n].any()
