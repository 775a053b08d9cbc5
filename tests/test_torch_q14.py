"""TPC-H `part` (Clause 4.2.3) and Q14 / Q19 over lineitem ⋈ part on the
port (arrowtpu_torch.entry), on the CPU at a small scale factor.

The generator against the clause's rules; `q14_step` and `q19_step`
against their numpy oracles (`q14_oracle`, `q19_oracle`: exact sums on
integer cents).  Q19's pushed-down predicates are held to arrowtpu.ops in
tests/test_torch_like.py, beside the LIKE cases whose JAX compiles they
share.  Tolerance: exact.
"""

import decimal

import numpy as np
import pytest

from arrowtpu_torch import entry as pe
from torch_parity import release_jax_caches  # noqa: F401

SF = 0.005  # 1,000 parts, about 30,000 lineitem rows


@pytest.fixture(scope="module")
def tables():
    la = pe.example_lineitem_arrays(SF)
    pa = pe.example_part_arrays(SF)
    return la, pa


def _strings(arrays, name):
    buf, starts, lens = pe.part_strings(arrays, name)
    raw = buf.tobytes()
    return [raw[s:s + n].decode() for s, n in zip(starts.tolist(),
                                                   lens.tolist())]


def test_part_follows_clause_4_2_3(tables):
    _, pa = tables
    n = int(SF * 200_000)
    assert pa["p_partkey"].tolist() == list(range(1, n + 1))
    names = _strings(pa, "p_name")
    for name in names:
        words = name.split(" ")
        assert len(words) == 5 and len(set(words)) == 5
        assert set(words) <= set(pe.PART_COLOURS) and len(name) <= 54
    brands, mfgrs = _strings(pa, "p_brand"), _strings(pa, "p_mfgr")
    for b, m in zip(brands, mfgrs):
        assert b[6] == m[-1] and "1" <= b[7] <= "5" and "1" <= b[6] <= "5"
    for t in _strings(pa, "p_type"):
        syl = t.split(" ")
        assert [s in p for s, p in zip(syl, pe.PART_TYPE_SYLLABLES)] == [
            True] * 3 and len(t) <= 25
    for c in _strings(pa, "p_container"):
        a, b = c.split(" ")
        assert (a in pe.PART_CONTAINER_SYLLABLES[0]
                and b in pe.PART_CONTAINER_SYLLABLES[1])
    assert pa["p_size"].min() >= 1 and pa["p_size"].max() <= 50
    comments = _strings(pa, "p_comment")
    assert all(5 <= len(c) <= 22 for c in comments)
    key = pa["p_partkey"]
    assert np.array_equal(pa["p_retailprice"],
                          90_000 + (key // 10) % 20_001 + 100 * (key % 1000))
    # lineitem's extended price is its quantity times this part's price
    la = tables[0]
    row = la["l_partkey"] - 1
    assert np.array_equal(la["l_extendedprice"],
                          la["l_quantity"] // 100 * pa["p_retailprice"][row])
    # the batch reads back as the host strings, NOT NULL
    batch = pe.part_batch(pa, "cpu")
    assert batch.schema.names == pe.PART_COLUMNS
    assert batch["p_name"].to_pylist() == names
    assert batch["p_type"].to_pylist() == _strings(pa, "p_type")
    assert all(batch[c].validity is None for c in pe.PART_COLUMNS)
    again = pe.example_part_arrays(SF)  # the seed fixes every draw
    for k in ("p_brand", "p_type", "p_size", "p_container"):
        assert np.array_equal(again[k], pa[k])
    assert _strings(again, "p_name") == names


def test_q14_matches_oracle(tables):
    la, pa = tables
    got = pe.q14_step(pe.lineitem_batch(la, "cpu"), pe.part_batch(pa, "cpu"))
    want = pe.q14_oracle(la, pa)
    assert want["rows"] > 0 and want["promo"] > 0
    pe.check_query(got, want, "Q14")
    assert isinstance(got["promo_revenue"], decimal.Decimal)


def _q19_rich(la, pa):
    """The tables with a third of the parts moved into Q19's branches and
    a third of the lineitem rows shipped by AIR, in person (so that every
    branch keeps rows at this scale)."""
    la, pa = dict(la), dict(pa)
    rng = np.random.default_rng(19)
    n = len(pa["p_partkey"])
    pick = rng.random(n) < 1 / 3
    branch = rng.integers(0, 3, n)
    for name in ("p_brand", "p_container", "p_size"):
        pa[name] = pa[name].copy()
    for i, (brand, containers, _, size) in enumerate(pe.Q19_BRANCHES):
        rows = pick & (branch == i)
        pa["p_brand"][rows] = pe.PART_BRANDS.index(brand)
        pa["p_container"][rows] = [
            pe.PART_CONTAINERS.index(containers[j])
            for j in rng.integers(0, 4, int(rows.sum()))]
        pa["p_size"][rows] = rng.integers(1, size + 3, int(rows.sum()))
    m = len(la["l_partkey"])
    air = rng.random(m) < 1 / 3
    la["l_shipmode"] = np.where(air, pe.SHIPMODE.index("AIR"),
                                la["l_shipmode"]).astype(np.int32)
    la["l_shipinstruct"] = np.where(
        air, pe.SHIPINSTRUCT.index(pe.Q19_SHIPINSTRUCT),
        la["l_shipinstruct"]).astype(np.int32)
    return la, pa


def test_q19_matches_oracle(tables):
    for la, pa in (tables, _q19_rich(*tables)):
        got = pe.q19_step(pe.lineitem_batch(la, "cpu"),
                          pe.part_batch(pa, "cpu"))
        pe.check_query(got, pe.q19_oracle(la, pa), "Q19")
    assert got["kept"] > 0 and got["rows"] > got["kept"]
