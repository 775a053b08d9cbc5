"""Each reference agrees with the port's step on the CPU at a tiny scale,
for every query and parameter set of each mix; each cell's control (the
reference in the precision below the configuration's) and each fault of
the timed path make `correct` false."""

import decimal
import json
import time

import pytest
import torch

from portbench import harness, mix

CPU = torch.device("cpu")
BENCH = json.loads((harness.REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SCALE = 4e-4


def _tables(cell, seed):
    arrays = {t: g.host_arrays(g.generate(cell.config, seed, CPU, SCALE))
              for t, g in cell.generators.items()}
    return arrays


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port(name, seed):
    from arrowtpu_torch import entry

    cell = harness.Cell(name)
    arrays = _tables(cell, seed)
    for item, _ in mix.items(cell.mix, seed):
        q = cell.queries[item.query]
        batches = {t: getattr(entry, cell.config["tables"][t]["batch"])(
            arrays[t], CPU) for t in q.TABLES}
        got = q.read(q.run(entry, batches, item.kwargs))
        want = q.reference(arrays, item.kwargs, CPU)
        assert all(v == 0 for v in q.compare(got, want).values()), item


# parameter sets on which the DOUBLE control goes wrong (Q6's bounds
# 0.06 + 0.01 < 0.07 in float64 drop the rows at 7 %)
CONTROL_ITEMS = {
    "tpch_sf10.q1": [("q1", {"delta_days": 90})],
    "tpch_sf10.q6": [("q6", {"date": "1994-01-01", "discount": "0.06",
                             "quantity": 24})],
    "clickbench_hits.groupby": [("clickbench", {"q": 8})],
}


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    cell = harness.Cell(name)
    arrays = _tables(cell, 11)
    for query, params in CONTROL_ITEMS[name]:
        q = cell.queries[query]
        control = q.reference(arrays, params, CPU, control=True)
        exact = q.reference(arrays, params, CPU)
        numbers = q.compare(control, exact)
        assert any(numbers[k] > q.LIMITS[k] for k in numbers), numbers


def _stale(step):
    first = []

    def stale(batch, *args, **kwargs):
        if not first:
            first.append(step(batch, *args, **kwargs))
        return first[0]
    return stale


def _half(step):
    def half(batch, *args, **kwargs):
        from arrowtpu_torch import ops
        return step(ops.slice_batch(batch, 0, batch.length // 2), *args,
                    **kwargs)
    return half


def _altered(step):
    def altered(batch, *args, **kwargs):
        out = step(batch, *args, **kwargs)
        if isinstance(out, tuple) and len(out) == 2:     # Q6
            return out[0], out[1] + decimal.Decimal("0.0001")
        if isinstance(out, int):
            return out + 1
        if isinstance(out, list):
            return [(k, c + 1) for k, c in out]
        out.columns[-1].values[0] += 1                   # Q1's count
        return out
    return altered


STEPS = {"tpch_sf10.q1": "q1_step", "tpch_sf10.q6": "q6_step",
         "clickbench_hits.groupby": "clickbench_step"}


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    from arrowtpu_torch import entry

    monkeypatch.setattr(entry, STEPS[name], fault(getattr(entry, STEPS[name])))
    result = harness.run_cell(harness.Cell(name), 21, 0.3, False, CPU,
                              time.perf_counter(), scale=SCALE)
    assert result["correct"] is False, result["checks"]
