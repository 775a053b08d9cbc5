"""The one generator of traffic: a mix's data file, read into the closed
loop's queries.

A mix (`traffic/<name>.json`) names its launch (a module in `launch/`: the
processes and clients that drive the window) and lists query entries: the
query kind (a module in `queries/`, which names the tables it reads), its
weight, and how each parameter is drawn: `{"value": v}` a constant, `{"choice": [...]}` one of a list,
`{"uniform_int": [lo, hi]}` an integer in [lo, hi].  `param_sets` is how
many parameter sets each entry draws from the seed (one where every
parameter is a constant).  An item is one entry with one parameter set,
repeated `weight` times; the loop runs a seeded permutation of the items,
over and over, so every seed runs the same items, in another order.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np


@dataclasses.dataclass(frozen=True)
class Item:
    query: str        # the query kind, a module of portbench/queries
    params: tuple     # ((name, value), ...), sorted by name

    @property
    def kwargs(self) -> dict:
        return dict(self.params)

    def label(self) -> str:
        return self.query + "(" + ", ".join(
            f"{k}={v}" for k, v in self.params) + ")"


def _draw(rule: dict, rng):
    (kind, arg), = rule.items()
    if kind == "value":
        return arg
    if kind == "choice":
        return arg[int(rng.integers(len(arg)))]
    if kind == "uniform_int":
        lo, hi = arg
        return int(rng.integers(lo, hi + 1))
    raise ValueError(f"unknown parameter rule {kind!r}")


def load(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def items(mix: dict, seed: int) -> list:
    """The mix's distinct items, drawn from `seed`, in the mix's order."""
    rng = np.random.default_rng([int(seed), 1])
    out = []
    for entry in mix["queries"]:
        rules = entry.get("params", {})
        constant = all("value" in r for r in rules.values())
        sets = 1 if constant else int(mix.get("param_sets", 1))
        for _ in range(sets):
            params = tuple(sorted((k, _draw(r, rng))
                                  for k, r in rules.items()))
            out.append((Item(entry["query"], params),
                        int(entry.get("weight", 1))))
    return out


def order(mix: dict, seed: int) -> list:
    """One cycle of the loop: every item `weight` times, in an order drawn
    from `seed`."""
    cycle = [item for item, weight in items(mix, seed) for _ in range(weight)]
    perm = np.random.default_rng([int(seed), 2]).permutation(len(cycle))
    return [cycle[i] for i in perm]
