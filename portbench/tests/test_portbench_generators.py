"""The frozen generators hold their sources' laws: row counts, domains and
the rules between columns (TPC-H Clause 4.2.3; ClickBench's hits)."""

import json

import numpy as np
import torch

from portbench import harness
from portbench.data import hits, lineitem

CPU = torch.device("cpu")


def _config(name):
    return json.loads((harness.ROOT / "configs" / f"{name}.json").read_text())


def _lineitem(seed=5, scale=0.002):
    return lineitem.host_arrays(lineitem.generate(
        _config("tpch_sf10"), seed, CPU, scale))


def test_lineitem_follows_clause_4_2_3():
    a = _lineitem()
    n = lineitem.rows(a)
    orders = int(1_500_000 * 10 * 0.002)
    assert 1 * orders <= n <= 7 * orders
    assert abs(n / orders - 4) < 0.1       # 1-7 lines an order, mean 4
    okey = a["l_orderkey"]
    assert ((okey - 1) % 32 < 8).all() and (np.diff(okey) >= 0).all()
    first = np.r_[True, okey[1:] != okey[:-1]]
    assert (a["l_linenumber"][first] == 1).all()
    ship, commit, receipt = (a[c] for c in ("l_shipdate", "l_commitdate",
                                            "l_receiptdate"))
    assert ship.min() >= lineitem.days("1992-01-02")
    assert ship.max() <= lineitem.days("1998-12-01")
    assert ((receipt - ship >= 1) & (receipt - ship <= 30)).all()
    assert ((commit - ship >= 30 - 121) & (commit - ship <= 90 - 1)).all()
    qty, ext = a["l_quantity"], a["l_extendedprice"]
    assert (qty % 100 == 0).all() and qty.min() >= 100 and qty.max() <= 5000
    pk = a["l_partkey"]
    retail = 90_000 + (pk // 10) % 20_001 + 100 * (pk % 1000)
    assert (ext == qty // 100 * retail).all()
    assert a["l_discount"].min() >= 0 and a["l_discount"].max() <= 10
    assert a["l_tax"].min() >= 0 and a["l_tax"].max() <= 8
    parts, supps = 200_000 * 10 * 0.002, 10_000 * 10 * 0.002
    assert pk.min() >= 1 and pk.max() <= parts
    assert a["l_suppkey"].min() >= 1 and a["l_suppkey"].max() <= supps
    current = lineitem.days("1995-06-17")
    flag = np.frombuffer(b"RAN", np.uint8)[a["l_returnflag"]]
    assert (flag[receipt > current] == ord("N")).all()
    assert set(flag[receipt <= current].tolist()) == {ord("R"), ord("A")}
    status = np.frombuffer(b"OF", np.uint8)[a["l_linestatus"]]
    assert ((status == ord("O")) == (ship > current)).all()
    pool, start, length = a["l_comment"]
    assert length.min() >= 10 and length.max() <= 43
    assert (start >= 0).all() and (start + length <= len(pool)).all()
    assert set(np.unique(pool).tolist()) <= set(lineitem.LETTERS)


def test_lineitem_is_the_seeds():
    a, b, c = _lineitem(9), _lineitem(9), _lineitem(10)
    assert all(np.array_equal(a[k], b[k]) for k in lineitem.COLUMNS[:-1])
    assert not np.array_equal(a["l_shipdate"], c["l_shipdate"])


def test_hits_follows_its_laws():
    config = _config("clickbench_hits")
    assert config["rows"] == hits.ROWS == 99_997_497
    scale = 1e-3
    a = hits.host_arrays(hits.generate(config, 2**31 + 3, CPU, scale))
    rows = round(hits.ROWS * scale)
    assert hits.rows(a) == rows
    assert {k: v.dtype for k, v in a.items()} == {
        k: np.dtype(t) for k, t in hits.NUMPY_TYPES.items()}
    users = round(rows * hits.USERS / hits.ROWS)
    assert len(np.unique(a["UserID"])) == users   # every user appears
    assert (a["UserID"] >= 2**63).mean() > 0.3   # hashes over 64 bits
    regions = np.unique(a["RegionID"])
    assert len(regions) <= hits.REGIONS and regions.min() >= 1
    assert regions.max() < hits.REGION_ID_RANGE
    assert set(np.unique(a["ResolutionWidth"]).tolist()) <= set(hits.WIDTHS)
    adv = a["AdvEngineID"]
    assert 0.003 < (adv != 0).mean() < 0.012 and adv.max() <= 30
    d = a["EventDate"]
    assert d.min() >= hits.FIRST_DAY and d.max() < hits.FIRST_DAY + 31
