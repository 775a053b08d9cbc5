"""TPC-H Q6 through `arrowtpu_torch.entry.q6_step`, which materializes the
kept rows of all 16 columns beside the revenue: the timed call, the reading
of its output, and the comparison with `reference/q6.py`.

The revenue of every output of the window is compared; whole kept batches
(~1.15M rows of 16 columns, ~180 MB each on the card) are kept for SAMPLE
outputs, drawn from the seed over the window.  Numbers compared, each with
the limit 0 (an exact query):
- `q6_wrong_rows`: kept rows that differ from the reference in any column
  (every row, where the kept counts differ);
- `q6_revenue_gap`: the largest gap of the revenue, in units of 1e-4.
"""

from __future__ import annotations

from fractions import Fraction

import torch

from portbench.data.lineitem import COMMENT_MAX, FLAGS, WORDS
from portbench.queries import read_views, views_matrix
from portbench.reference import q6 as ref

TABLES = ("lineitem",)
LIMITS = {"q6_wrong_rows": 0, "q6_revenue_gap": 0}
SAMPLE = 8
DECIMALS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")


def run(entry, tables, params: dict):
    return entry.q6_step(tables["lineitem"], date=params["date"],
                         discount=params["discount"],
                         quantity=params["quantity"])


def light(out):
    """What is kept of every output: the revenue."""
    return None, out[1]


def _decimal_cents(c, n: int) -> torch.Tensor:
    """A Decimal128's (n, 4) int32 limbs -> int64; a value whose upper limbs
    are not the sign of the lower two reads as -2**63, which no cent is."""
    limbs = c.values[:n]
    low = limbs[:, 0].to(torch.int64) & 0xFFFFFFFF
    value = low | (limbs[:, 1].to(torch.int64) << 32)
    sign = torch.where(value < 0, -1, 0).to(torch.int32)
    fits = (limbs[:, 2] == sign) & (limbs[:, 3] == sign)
    return torch.where(fits, value, torch.iinfo(torch.int64).min)


def _word_index(c, n: int, words) -> torch.Tensor:
    """A dictionary column's keys -> the index in `words` of each row's
    value (-1 for a value not in the list)."""
    values = read_views(c.values, c.values.length)
    table = torch.tensor([words.index(v.decode()) if v.decode() in words
                          else -1 for v in values] or [-1],
                         dtype=torch.int64, device=c.keys.values.device)
    keys = c.keys.values[:n].to(torch.int64)
    ok = (keys >= 0) & (keys < len(values))
    return torch.where(ok, table[keys.clamp(0, max(len(values) - 1, 0))], -1)


def read(out) -> dict:
    kept, revenue = out
    answer = {"revenue": Fraction(revenue)}
    if kept is None:
        return answer
    n = kept.length
    columns = {}
    for name in kept.schema.names:
        c = kept[name]
        if c.validity is not None and not bool(_all_valid(c, n)):
            columns[name] = None  # a NOT NULL column read back with nulls
        elif name in DECIMALS:
            columns[name] = _decimal_cents(c, n)
        elif name in FLAGS:
            m, length = views_matrix(c, n, 1)
            columns[name] = torch.where(length == 1, m[:, 0], 0)
        elif name in WORDS:
            columns[name] = _word_index(c, n, WORDS[name])
        elif name == "l_comment":
            columns[name], columns["l_comment_len"] = views_matrix(
                c, n, COMMENT_MAX)
        else:
            columns[name] = c.values[:n]
    answer.update(count=n, columns=columns)
    return answer


def _all_valid(c, n: int) -> torch.Tensor:
    bits = torch.arange(n, device=c.validity.device)
    return ((c.validity[bits >> 3] >> (bits & 7)) & 1).bool().all()


def reference(arrays: dict, params: dict, device, control=False) -> dict:
    return ref.answer(arrays["lineitem"], params["date"], params["discount"],
                      params["quantity"], device, control)


def compare(got, want: dict) -> dict:
    if got is None:
        return {"q6_wrong_rows": max(want["count"], 1),
                "q6_revenue_gap": 0}
    gap = abs(got["revenue"] - want["revenue"]) * 10**4
    wrong = 0
    if "count" in got:
        if got["count"] != want["count"]:
            wrong = max(got["count"], want["count"])
        else:
            bad = torch.zeros(want["count"], dtype=torch.bool,
                              device=want["columns"]["l_orderkey"].device)
            for name, w in want["columns"].items():
                g = got["columns"].get(name)
                if g is None or g.shape != w.shape:
                    bad[:] = True
                    continue
                diff = g.to(torch.int64) != w.to(torch.int64)
                bad |= diff if diff.dim() == 1 else diff.any(1)
            wrong = int(bad.sum())
    return {"q6_wrong_rows": wrong, "q6_revenue_gap": float(gap)}
