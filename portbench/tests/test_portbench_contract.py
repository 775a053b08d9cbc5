"""The run's contract: no module of JAX or of the JAX package in a run, no
module of the port in the reference, the result line's keys, and no result
without a card."""

import ast
import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness

BENCH = json.loads((harness.REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]

RUN_AND_LIST = """
import sys, time
sys.path.insert(0, {repo!r})
import torch
from portbench import harness
harness.run_cell(harness.Cell({name!r}), 4, 0.2, {trace},
                 torch.device("cpu"), time.perf_counter(), scale=2e-4)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


@pytest.mark.parametrize("name", CELLS)
def test_a_run_loads_no_jax(name):
    code = RUN_AND_LIST.format(repo=str(harness.REPO), name=name, trace=True)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True).stdout
    tops = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert "arrowtpu_torch" in tops
    assert not tops & harness.FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    code = (f"import sys; sys.path.insert(0, {str(harness.REPO)!r})\n"
            "import portbench.reference.q1, portbench.reference.q6, "
            "portbench.reference.clickbench\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    tops = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert not tops & (harness.FORBIDDEN | {"arrowtpu_torch"})
    for path in (harness.ROOT / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            assert not any(n.split(".")[0] in harness.FORBIDDEN
                           | {"arrowtpu_torch"} for n in names), path


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line_has_the_contracts_keys(trace):
    name = "tpch_sf10.q6"
    result = harness.run_cell(harness.Cell(name), 8, 0.2, trace,
                              torch.device("cpu"), time.perf_counter(),
                              scale=2e-4)
    line = json.loads(json.dumps(result))
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == want
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"} | (
        {"busy_s", "window_s"} if trace else set())
    cell = harness.Cell(name)
    allowed = {m["name"] for m in (cell.per_layer if trace
                                   else cell.end_to_end)}
    assert line["metrics"] and set(line["metrics"]) <= allowed
    if not trace:
        assert set(line["metrics"]) == allowed
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_no_result_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    run = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.REPO, capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and run.stdout == ""


def test_no_result_without_the_port(tmp_path):
    """A checkout of BENCHMARK.json and portbench/ alone fails at once."""
    import shutil

    shutil.copy(harness.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path.insert(0, '.')\n"
            "import torch\nfrom portbench import harness\n"
            f"harness.run_cell(harness.Cell({CELLS[0]!r}), 1, 0.1, False, "
            "torch.device('cpu'), time.perf_counter(), scale=1e-4)")
    run = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and "arrowtpu_torch" in run.stderr


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card):
    run = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "tpch_sf10.q6",
         "--seed", "5", "--seconds", "2", "--trace", "0"],
        cwd=harness.REPO, capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stderr[-4000:]
    line = json.loads(run.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
