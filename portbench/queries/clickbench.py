"""ClickBench's queries through `arrowtpu_torch.entry.clickbench_step`
(`params["q"]` is the step's own number, 1-8 for queries.sql's 2-5, 7-9
and 17: `entry.CLICKBENCH_QUERIES`): the timed call and
the comparison with `reference/clickbench.py`.  The step ends in its result
on the host, so every output of the window is kept and compared.

Number compared, with the limit 0 (exact queries):
- `cb_wrong_values`: result values that differ from the reference (a
  count, or each (key, count) pair of a top list, and pairs missing or
  extra).
"""

from __future__ import annotations

from portbench.reference import clickbench as ref

TABLES = ("hits",)
LIMITS = {"cb_wrong_values": 0}
SAMPLE = None


def run(entry, tables, params: dict):
    return entry.clickbench_step(tables["hits"], params["q"])


def light(out):
    return out


def read(out):
    if isinstance(out, list):
        return [(int(k), int(c)) for k, c in out]
    return int(out)


def reference(arrays: dict, params: dict, device, control=False):
    return ref.answer(arrays["hits"], params["q"], device, control)


def compare(got, want) -> dict:
    if got is None:
        wrong = len(want) if isinstance(want, list) else 1
    elif isinstance(want, list):
        wrong = abs(len(got) - len(want)) + sum(
            g != w for g, w in zip(got, want))
    else:
        wrong = int(got != want)
    return {"cb_wrong_values": wrong}
