"""TPC-H Q6 (Clause 2.4.6), the forecasting revenue change, in plain
PyTorch, with the kept rows materialized as the timed step keeps them.

    SELECT sum(l_extendedprice * l_discount) FROM lineitem
    WHERE l_shipdate >= date DATE AND l_shipdate < date DATE + interval 1 year
      AND l_discount BETWEEN DISCOUNT - 0.01 AND DISCOUNT + 0.01
      AND l_quantity < QUANTITY

over the drawn `lineitem` arrays (portbench.data.lineitem), on the integer
cents and day numbers; the revenue an exact integer.  With `control` the
decimals are DOUBLE (cents / 100.0; the bounds DISCOUNT -+ 0.01 and the
revenue in float64), the step a faster engine would take; its answer has to
fail the comparison.

An answer is a dict: "count" (the kept rows), "revenue" (a Fraction), and
"columns": every column's kept rows on the device, in row order, in the
forms `portbench.queries.q6.read` gives the timed step's: int64 keys, the
line number, decimals as int64 cents, dates as int32 days, the flags as
their byte, the dictionaries as the index of the word in the spec's list,
the comment as a (rows, 43) byte matrix beside its lengths.
"""

from __future__ import annotations

from decimal import Decimal
from fractions import Fraction

import numpy as np
import torch

from portbench.data.lineitem import COMMENT_MAX, FLAGS

INTEGERS = ("l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
            "l_quantity", "l_extendedprice", "l_discount", "l_tax",
            "l_shipdate", "l_commitdate", "l_receiptdate", "l_shipinstruct",
            "l_shipmode")


def year_range(date: str) -> tuple:
    """[date, date + 1 year) as day numbers."""
    lo = np.datetime64(date, "D")
    year = lo.astype("datetime64[Y]")
    hi = (year + 1).astype("datetime64[D]") + (lo - year.astype(
        "datetime64[D]"))
    return int(lo.astype(np.int64)), int(hi.astype(np.int64))


def comment_matrix(pool, start, length, device) -> torch.Tensor:
    """(rows, COMMENT_MAX) bytes of each comment, zero past its length."""
    j = torch.arange(COMMENT_MAX, device=device)
    idx = (start[:, None] + j).clamp_(max=pool.shape[0] - 1)
    return torch.where(j < length[:, None], pool[idx], 0).to(torch.uint8)


def answer(arrays: dict, date: str, discount: str, quantity: int, device,
           control: bool = False) -> dict:
    def dev(name):
        return torch.as_tensor(arrays[name], device=device)

    lo, hi = year_range(date)
    ship, disc, qty = dev("l_shipdate"), dev("l_discount"), dev("l_quantity")
    if control:
        d = float(discount)
        df = disc.to(torch.float64) / 100.0
        mask = ((ship >= lo) & (ship < hi) & (df >= d - 0.01)
                & (df <= d + 0.01) & (qty.to(torch.float64) / 100.0
                                      < quantity))
    else:
        d = int(Decimal(discount).scaleb(2))
        mask = ((ship >= lo) & (ship < hi) & (disc >= d - 1)
                & (disc <= d + 1) & (qty < int(quantity) * 100))
    ext = dev("l_extendedprice")[mask]
    if control:
        revenue = Fraction(float((ext.to(torch.float64) / 100.0
                                  * (disc[mask].to(torch.float64) / 100.0)
                                  ).sum()))
    else:
        # each term is below 2**27 x 10, so an int64 sum of 6e7 is exact
        revenue = Fraction(int((ext * disc[mask]).sum()), 10**4)
    columns = {n: dev(n)[mask] for n in INTEGERS}
    for name, alphabet in FLAGS.items():
        columns[name] = torch.tensor(list(alphabet), dtype=torch.uint8,
                                     device=device)[dev(name)[mask].long()]
    pool, start, length = (torch.as_tensor(a, device=device)
                           for a in arrays["l_comment"])
    columns["l_comment_len"] = length[mask].to(torch.int64)
    columns["l_comment"] = comment_matrix(pool, start[mask],
                                          columns["l_comment_len"], device)
    return {"count": int(mask.sum()), "revenue": revenue, "columns": columns}
