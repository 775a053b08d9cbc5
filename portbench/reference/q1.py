"""TPC-H Q1 (Clause 2.4.1), the pricing summary report, in plain PyTorch.

    SELECT l_returnflag, l_linestatus, sum(l_quantity), sum(l_extendedprice),
           sum(l_extendedprice * (1 - l_discount)),
           sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)),
           avg(l_quantity), avg(l_extendedprice), avg(l_discount), count(*)
    FROM lineitem WHERE l_shipdate <= date '1998-12-01' - interval DELTA day
    GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus

over the drawn `lineitem` arrays (portbench.data.lineitem), on the integer
cents: each sum exact (int64 partial sums over blocks of rows, joined as
Python ints), each average float(sum) / count / 100.  With `control` the
prices are DOUBLE (cents / 100.0, products and sums in float64), the step a
faster engine would take; its answer has to fail the comparison.

An answer is a list of groups in flag order, each a dict: "key" (the two
flag bytes), "count", every sum as a Fraction of its exact value, every
average as a float.
"""

from __future__ import annotations

from fractions import Fraction

import torch

from portbench.data.lineitem import FLAGS, days

SUMS = ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge")
MEANS = {"avg_qty": "sum_qty", "avg_price": "sum_base_price",
         "avg_disc": "sum_disc"}
BLOCK = 1 << 20


def ship_limit(delta_days: int) -> int:
    return days("1998-12-01") - int(delta_days)


def _group_sums(gid: torch.Tensor, x: torch.Tensor, groups: int) -> list:
    """Exact per-group sums of an int64 column: int64 partial sums over
    blocks of BLOCK rows (each far below 2**63), joined as Python ints."""
    total = [0] * groups
    for lo in range(0, x.shape[0], BLOCK):
        part = torch.zeros(groups, dtype=torch.int64, device=x.device)
        part.index_add_(0, gid[lo:lo + BLOCK], x[lo:lo + BLOCK])
        for g, v in enumerate(part.tolist()):
            total[g] += v
    return total


def answer(arrays: dict, delta_days: int, device, control: bool = False
           ) -> list:
    col = {n: torch.as_tensor(arrays[n], device=device) for n in (
        "l_shipdate", "l_returnflag", "l_linestatus", "l_quantity",
        "l_extendedprice", "l_discount", "l_tax")}
    mask = col["l_shipdate"] <= ship_limit(delta_days)
    rf = torch.tensor(list(FLAGS["l_returnflag"]), device=device)[
        col["l_returnflag"][mask].long()]
    ls = torch.tensor(list(FLAGS["l_linestatus"]), device=device)[
        col["l_linestatus"][mask].long()]
    keys, gid = torch.unique(rf * 256 + ls, sorted=True, return_inverse=True)
    groups = keys.shape[0]
    qty, ext, disc, tax = (col[n][mask] for n in (
        "l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    counts = torch.bincount(gid, minlength=groups).tolist()
    if control:
        q, e, d, t = (x.to(torch.float64) / 100.0 for x in (qty, ext, disc,
                                                            tax))
        dp = e * (1 - d)
        terms = {"sum_qty": q, "sum_base_price": e, "sum_disc_price": dp,
                 "sum_charge": dp * (1 + t), "sum_disc": d}
        sums = {}
        for name, x in terms.items():
            s = torch.zeros(groups, dtype=torch.float64, device=device)
            s.index_add_(0, gid, x)
            sums[name] = [Fraction(v) for v in s.tolist()]
        means = {m: [float(sums[s][g]) / counts[g] for g in range(groups)]
                 for m, s in MEANS.items()}
    else:
        dp = ext * (100 - disc)
        terms = {"sum_qty": (qty, 2), "sum_base_price": (ext, 2),
                 "sum_disc_price": (dp, 4),
                 "sum_charge": (dp * (100 + tax), 6), "sum_disc": (disc, 2)}
        ints = {name: _group_sums(gid, x, groups)
                for name, (x, _) in terms.items()}
        sums = {name: [Fraction(v, 10**scale) for v in ints[name]]
                for name, (_, scale) in terms.items()}
        means = {m: [float(ints[s][g]) / counts[g] / 100
                     for g in range(groups)] for m, s in MEANS.items()}
    out = []
    for g, k in enumerate(keys.tolist()):
        row = {"key": (bytes([k >> 8]), bytes([k & 0xFF])),
               "count": counts[g]}
        row.update({name: sums[name][g] for name in SUMS})
        row.update({m: means[m][g] for m in MEANS})
        out.append(row)
    return out
