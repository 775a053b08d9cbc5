"""TPC-H Q1 through `arrowtpu_torch.entry.q1_step`: the timed call, the
reading of its output batch, and the comparison with `reference/q1.py`.

Every output of the window is kept (four rows each) and compared.  Numbers
compared, each with the limit 0 (an exact query):
- `q1_wrong_values`: group keys, counts, sums and averages that differ
  from the reference (averages bit for bit), and groups missing or extra;
- `q1_sum_gap`: the largest gap of a sum, in units of 1e-6.
"""

from __future__ import annotations

from fractions import Fraction

import torch

from portbench.queries import read_views
from portbench.reference import q1 as ref

TABLES = ("lineitem",)
LIMITS = {"q1_wrong_values": 0, "q1_sum_gap": 0}
SAMPLE = None
KEYS = ("l_returnflag", "l_linestatus")


def run(entry, tables, params: dict):
    return entry.q1_step(tables["lineitem"], delta_days=params["delta_days"])


def light(out):
    return out


def read(out) -> list:
    """The output batch as reference/q1.py's answer: its rows in order,
    each flag resolved to its bytes, each sum's limbs joined to an integer
    and scaled by the column's type."""
    n = out.length
    cols = dict(zip(out.schema.names, out.columns))
    keys = [read_views(cols[k], n) for k in KEYS]
    fields = {}
    for name in ref.SUMS:
        c = cols[name]
        fields[name] = [Fraction(v, 10**c.dtype.scale)
                        for v in join_limbs(c.values[:n])]
    for name in ref.MEANS:
        fields[name] = cols[name].values[:n].to(torch.float64).tolist()
    counts = cols["count_order"].values[:n].tolist()
    rows = []
    for i in range(n):
        row = {"key": (keys[0][i], keys[1][i]), "count": counts[i]}
        row.update({name: values[i] for name, values in fields.items()})
        rows.append(row)
    return rows


def join_limbs(limbs: torch.Tensor) -> list:
    """(n, k) int32 limbs, least significant first -> signed Python ints."""
    words = limbs.cpu().to(torch.int64) & 0xFFFFFFFF
    k = words.shape[1]
    out = []
    for row in words.tolist():
        u = sum(w << (32 * j) for j, w in enumerate(row))
        out.append(u - (1 << 32 * k) if u >> (32 * k - 1) else u)
    return out


def reference(arrays: dict, params: dict, device, control=False) -> list:
    return ref.answer(arrays["lineitem"], params["delta_days"], device,
                      control)


def compare(got, want: list) -> dict:
    if got is None:  # an output that could not be read
        return {"q1_wrong_values": len(want) * 10, "q1_sum_gap": 0}
    wrong = abs(len(got) - len(want))
    gap = Fraction(0)
    for g, w in zip(got, want):
        for field, value in w.items():
            wrong += g[field] != value
            if field in ref.SUMS:
                gap = max(gap, abs(g[field] - value))
    return {"q1_wrong_values": wrong, "q1_sum_gap": float(gap * 10**6)}
