"""TPC-H's `orders` and `customer` (arrowtpu_torch.entry) against Clause
4.2.3, Q3 (Clause 2.4.3) on `device="cpu"` against its numpy oracle, and
the same query composed from `arrowtpu.ops` against the port's step.

`example_lineitem_arrays` is pinned by a digest taken before `orders` was
added, so that the orders generator, which replays its first draws, cannot
move the lineitem data every earlier oracle rests on.  The JAX side of Q3
takes 1 - l_discount through `arrowtpu.ops.decimal` (its `numeric.sub(1,
d)` gives untyped limbs, ROADMAP C.3) and groups on the Date32 key.
Tolerance: exact.
"""

import decimal
import hashlib

import numpy as np
import pytest

import torch_parity as tp
from torch_parity import release_jax_caches  # noqa: F401
import arrowtpu.schema as js
from arrowtpu import ops as jops
from arrowtpu.config import SortOptions as JOpts
from arrowtpu.core import batch as jbt
from arrowtpu.core import column as jcol
from arrowtpu.ops import decimal as jdec
from arrowtpu.ops import groupby as jgb

from arrowtpu_torch import entry as pe

LINEITEM_DIGEST = ("d87dccc86018cdcba9ebcbfe6001b3f3"
                   "c669f5a985519f7604f1dce31e0a154a")
SF = 0.01


@pytest.fixture(scope="module")
def tables():
    li = pe.example_lineitem_arrays(SF)
    return li, pe.example_orders_arrays(SF, lineitem=li), \
        pe.example_customer_arrays(SF)


def test_lineitem_arrays_are_unchanged(tables):
    h = hashlib.sha256()
    for k, v in sorted(tables[0].items()):
        for x in (v if isinstance(v, tuple) else (v,)):
            h.update(k.encode())
            h.update(str(x.dtype).encode())
            h.update(np.ascontiguousarray(x).tobytes())
    assert h.hexdigest() == LINEITEM_DIGEST


def _strings(arrays, name):
    pool, starts, lens = arrays[name]
    return [pool[s:s + n].tobytes() for s, n in zip(starts, lens)]


def test_orders_follow_clause_4_2_3(tables):
    li, o, _ = tables
    n = int(1_500_000 * SF)
    ok = o["o_orderkey"]
    assert len(ok) == n and np.all((ok - 1) % 32 < 8) and np.all(
        np.diff(ok) > 0)
    ck = o["o_custkey"]
    assert ck.min() >= 1 and ck.max() <= SF * 150_000 and not np.any(ck % 3
                                                                     == 0)
    date = o["o_orderdate"]
    assert date.min() >= pe._days("1992-01-01")
    assert date.max() <= pe._days("1998-12-31") - 151
    assert set(np.unique(o["o_orderpriority"])) <= set(range(5))
    assert o["o_clerk"].min() >= 1 and o["o_clerk"].max() <= SF * 1000
    assert not o["o_shippriority"].any()
    lens = o["o_comment"][2]
    assert lens.min() >= 19 and lens.max() <= 78
    # every line finds its order, ships after it, and sets its status and
    # total price
    row = np.searchsorted(ok, li["l_orderkey"])
    assert np.array_equal(ok[row], li["l_orderkey"])
    assert np.all(li["l_shipdate"] > date[row])
    shipped = np.bincount(row, li["l_linestatus"].astype(np.int64), n)
    lines = np.bincount(row, minlength=n)
    want = np.where(shipped == lines, 0, np.where(shipped == 0, 1, 2))
    assert np.array_equal(o["o_orderstatus"], want)
    total = np.zeros(n, np.int64)
    np.add.at(total, row, li["l_extendedprice"] * (100 + li["l_tax"])
              * (100 - li["l_discount"]))
    assert np.array_equal(o["o_totalprice"], (total + 5_000) // 10_000)
    b = pe.orders_batch(o, device="cpu")
    assert b.schema.names == pe.ORDERS_COLUMNS and b.length == n
    assert b["o_clerk"].to_pylist()[0] == "Clerk#%09d" % o["o_clerk"][0]
    assert b["o_orderstatus"].to_pylist()[:5] == [
        "FOP"[s] for s in o["o_orderstatus"][:5]]
    assert b["o_totalprice"].to_pylist()[0] == decimal.Decimal(
        int(o["o_totalprice"][0])).scaleb(-2)
    assert [s.encode() for s in b["o_comment"].to_pylist()[:50]] == \
        _strings(o, "o_comment")[:50]


def test_customer_follows_clause_4_2_3(tables):
    c = tables[2]
    n = int(SF * 150_000)
    assert np.array_equal(c["c_custkey"], np.arange(1, n + 1))
    nation = c["c_nationkey"]
    assert nation.min() >= 0 and nation.max() <= 24
    assert c["c_acctbal"].min() >= -99_999 and c["c_acctbal"].max() <= 999_999
    assert set(np.unique(c["c_mktsegment"])) <= set(range(5))
    for name, lo, hi in (("c_address", 10, 40), ("c_comment", 29, 116)):
        assert c[name][2].min() >= lo and c[name][2].max() <= hi
    b = pe.customer_batch(c, device="cpu")
    assert b.schema.names == pe.CUSTOMER_COLUMNS and b.length == n
    names, phones = b["c_name"].to_pylist(), b["c_phone"].to_pylist()
    assert names[:3] == ["Customer#%09d" % k for k in (1, 2, 3)]
    for k in range(0, n, 97):
        p = phones[k]
        assert len(p) == 15 and p[2] == p[6] == p[10] == "-"
        assert int(p[:2]) == nation[k] + 10 and p.replace("-", "").isdigit()
    assert b["c_mktsegment"].to_pylist()[:5] == [
        pe.MKTSEGMENTS[s] for s in c["c_mktsegment"][:5]]


def test_q3_step_matches_the_oracle():
    sf = 0.005
    li = pe.example_lineitem_arrays(sf)
    o = pe.example_orders_arrays(sf, lineitem=li)
    c = pe.example_customer_arrays(sf)
    got = pe.q3_step(pe.customer_batch(c, "cpu"), pe.orders_batch(o, "cpu"),
                     pe.lineitem_batch(li, "cpu"))
    want = pe.q3_oracle(c, o, li)
    out = pe.check_q3(got, want)
    assert len(out["rows"]) == pe.Q3_LIMIT and want["groups"] > pe.Q3_LIMIT


def _jax_decimal(cents):
    return jcol.from_pylist([decimal.Decimal(int(x)).scaleb(-2)
                             for x in cents], js.Decimal128(15, 2))


@tp.jit
def _jax_q3(customer, segment, orders, lineitem, shipdate):
    """Q3 composed from `arrowtpu.ops`: the filters, two hash joins with
    the port's build sides, revenue, the Date32-keyed group-by and the top
    ten, under one `jax.jit` (the package's capacities are static; one
    compile in place of one a primitive) -> (top ten, groups)."""
    day = pe._days(pe.Q3_DATE)
    cust = jops.filter_record_batch(customer,
                                    jops.strings.like(segment, pe.Q3_SEGMENT))
    ords = jops.filter_record_batch(orders, jops.lt(orders["o_orderdate"],
                                                    day))
    lines = jops.filter_record_batch(lineitem, jops.gt(shipdate, day))
    co, _ = jops.hash_join(ords, cust, ["o_custkey"], right_on=["c_custkey"])
    joined, _ = jops.hash_join(lines, co, ["l_orderkey"],
                               right_on=["o_orderkey"])
    revenue = jdec.mul(joined["l_extendedprice"],
                       jdec.neg(jdec.sub(joined["l_discount"], 1)))
    grouped = jgb.group_by(joined.project(list(pe.Q3_KEYS)).with_column(
        "revenue", revenue), pe.Q3_KEYS, [("revenue", "sum")])
    top = jops.sort_batch(grouped, ["sum_revenue", "o_orderdate"],
                          [JOpts(descending=True), JOpts()], limit=10)
    return top, grouped.length


def test_q3_matches_the_jax_package():
    """Q3 composed from `arrowtpu.ops` equals the port's step, row for
    row."""
    sf = 0.002
    li = pe.example_lineitem_arrays(sf)
    o = pe.example_orders_arrays(sf, lineitem=li)
    c = pe.example_customer_arrays(sf)
    top, groups = _jax_q3(
        jbt.record_batch({"c_custkey": jcol.from_pylist(
            c["c_custkey"].tolist(), js.int64)}),
        jcol.dictionary_encode_host([pe.MKTSEGMENTS[k]
                                     for k in c["c_mktsegment"]]),
        jbt.record_batch({
            "o_orderkey": jcol.from_pylist(o["o_orderkey"].tolist(),
                                           js.int64),
            "o_custkey": jcol.from_pylist(o["o_custkey"].tolist(), js.int64),
            "o_orderdate": jcol.from_pylist(o["o_orderdate"].tolist(),
                                            js.Date32()),
            "o_shippriority": jcol.from_pylist(
                o["o_shippriority"].tolist(), js.int32)}),
        jbt.record_batch({
            "l_orderkey": jcol.from_pylist(li["l_orderkey"].tolist(),
                                           js.int64),
            "l_extendedprice": _jax_decimal(li["l_extendedprice"]),
            "l_discount": _jax_decimal(li["l_discount"])}),
        jcol.from_pylist(li["l_shipdate"].tolist(), js.Date32()))
    got = pe.q3_step(pe.customer_batch(c, "cpu"), pe.orders_batch(o, "cpu"),
                     pe.lineitem_batch(li, "cpu"))
    assert got["groups"] == int(groups) > pe.Q3_LIMIT
    want = top.to_pydict()
    have = got["top"].to_pydict()
    assert {k: have[k] for k in want} == want
    assert pe.check_q3(got, pe.q3_oracle(c, o, li))
