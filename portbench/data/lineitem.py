"""TPC-H `lineitem` (v3.0.1, Clause 4.2.3), drawn on a device from a seed.

A frozen copy of the laws that `arrowtpu_torch.entry.example_lineitem_arrays`
follows, drawn with a `torch.Generator` on the device instead of numpy (the
random streams differ; the laws do not):

- 1,500,000 x SF orders with TPC-H's sparse order keys (the first 8 of
  every 32), 1-7 lines each; O_ORDERDATE uniform over [1992-01-01,
  1998-12-31 - 151 days];
- l_partkey uniform over [1, SF x 200,000]; l_suppkey by the spec's formula
  over S = SF x 10,000 suppliers and a uniform i in 0..3;
- l_quantity 1-50, l_discount 0.00-0.10, l_tax 0.00-0.08, l_extendedprice =
  quantity x the part's retail price (90,000 + (pk / 10) mod 20,001 + 100 x
  (pk mod 1,000) cents), all in cents of a Decimal(15, 2);
- l_shipdate = orderdate + [1, 121], l_commitdate = orderdate + [30, 90],
  l_receiptdate = shipdate + [1, 30] days;
- l_returnflag R or A at random where l_receiptdate <= CURRENTDATE
  (1995-06-17), else N; l_linestatus O where l_shipdate > CURRENTDATE,
  else F;
- l_shipinstruct and l_shipmode uniform over the spec's lists;
- l_comment 10-43 bytes, each a substring of one pool of random letters
  and spaces (300 MiB, as dbgen takes its comments from one text pool).

`generate` returns the columns as tensors on the device; `host_arrays`
turns them into the numpy arrays `arrowtpu_torch.entry.lineitem_batch`
takes (flags and dictionaries as codes, the comment as pool, starts and
lengths), which are also what the reference reads.
"""

from __future__ import annotations

import numpy as np
import torch

COLUMNS = ["l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
           "l_quantity", "l_extendedprice", "l_discount", "l_tax",
           "l_returnflag", "l_linestatus", "l_shipdate", "l_commitdate",
           "l_receiptdate", "l_shipinstruct", "l_shipmode", "l_comment"]
DECIMALS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")
# each flag's code indexes its alphabet
FLAGS = {"l_returnflag": b"RAN", "l_linestatus": b"OF"}
SHIPINSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE",
                "TAKE BACK RETURN"]
SHIPMODE = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
WORDS = {"l_shipinstruct": SHIPINSTRUCT, "l_shipmode": SHIPMODE}
TEXT_POOL_BYTES = 300 * 2**20
COMMENT_MAX = 43
LETTERS = b"abcdefghijklmnopqrstuvwxyz "


def days(iso: str) -> int:
    """An ISO date as days since 1970-01-01 (a Date32)."""
    return int(np.datetime64(iso, "D").astype(np.int64))


STARTDATE = days("1992-01-01")
ENDDATE = days("1998-12-31")
CURRENTDATE = days("1995-06-17")


def _ints(g, lo: int, hi: int, n: int, dtype=torch.int64):
    """n uniform integers in [lo, hi] on g's device."""
    return torch.randint(lo, hi + 1, (n,), generator=g, device=g.device,
                         dtype=dtype)


def generate(config: dict, seed: int, device, scale: float = 1.0) -> dict:
    """`lineitem` at the configuration's scale factor (times `scale`, which
    tests set below 1) -> {column: tensor on `device`}; the comment as
    "l_comment_pool" (uint8), "l_comment_start" (int64) and "l_comment_len"
    (int32)."""
    scale_factor = config["scale_factor"] * scale
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    orders = int(1_500_000 * scale_factor)
    lines = _ints(g, 1, 7, orders)
    order_of = torch.repeat_interleave(
        torch.arange(orders, device=device), lines)
    n = order_of.shape[0]
    first_line = torch.repeat_interleave(torch.cumsum(lines, 0) - lines, lines)
    odate = _ints(g, STARTDATE, ENDDATE - 151, orders, torch.int32)[order_of]
    parts, supps = int(scale_factor * 200_000), int(scale_factor * 10_000)
    pkey = _ints(g, 1, parts, n)
    i = _ints(g, 0, 3, n)
    qty = _ints(g, 1, 50, n)
    ship = odate + _ints(g, 1, 121, n, torch.int32)
    commit = odate + _ints(g, 30, 90, n, torch.int32)
    receipt = ship + _ints(g, 1, 30, n, torch.int32)
    randflag = _ints(g, 0, 1, n, torch.int8)
    pool_bytes = min(TEXT_POOL_BYTES, COMMENT_MAX * n + 64)
    letters = torch.tensor(list(LETTERS), dtype=torch.uint8, device=device)
    pool = letters[_ints(g, 0, len(LETTERS) - 1, pool_bytes)]
    clen = _ints(g, 10, COMMENT_MAX, n, torch.int32)
    u = torch.rand(n, generator=g, device=device, dtype=torch.float64)
    cstart = (u * (pool_bytes - clen)).to(torch.int64)
    retail = 90_000 + (pkey // 10) % 20_001 + 100 * (pkey % 1000)
    return {
        "l_orderkey": order_of // 8 * 32 + order_of % 8 + 1,
        "l_partkey": pkey,
        "l_suppkey": (pkey + i * (supps // 4 + (pkey - 1) // supps)) % supps
        + 1,
        "l_linenumber": (torch.arange(n, device=device) - first_line + 1
                         ).to(torch.int32),
        "l_quantity": qty * 100,
        "l_extendedprice": qty * retail,
        "l_discount": _ints(g, 0, 10, n),
        "l_tax": _ints(g, 0, 8, n),
        "l_returnflag": torch.where(receipt <= CURRENTDATE, randflag,
                                    2).to(torch.int8),
        "l_linestatus": (ship <= CURRENTDATE).to(torch.int8),
        "l_shipdate": ship, "l_commitdate": commit, "l_receiptdate": receipt,
        "l_shipinstruct": _ints(g, 0, len(SHIPINSTRUCT) - 1, n, torch.int32),
        "l_shipmode": _ints(g, 0, len(SHIPMODE) - 1, n, torch.int32),
        "l_comment_pool": pool, "l_comment_start": cstart,
        "l_comment_len": clen}


def host_arrays(columns: dict) -> dict:
    """The drawn tensors as the numpy arrays `entry.lineitem_batch` takes
    (each tensor is moved and dropped in turn, so the device holds one at a
    time less)."""
    out = {name: columns.pop(name).cpu().numpy()
           for name in COLUMNS if name != "l_comment"}
    out["l_comment"] = tuple(columns.pop(f"l_comment_{part}").cpu().numpy()
                             for part in ("pool", "start", "len"))
    return out


def rows(arrays: dict) -> int:
    return len(arrays["l_orderkey"])
