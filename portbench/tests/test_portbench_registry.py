"""Every cell of BENCHMARK.json resolves to its files by name, and a mix, a
table with a query that reads two tables, and per-layer metrics, each
added as files of their own in a copy, are found with no other file
edited."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench import harness

BENCH = json.loads((harness.REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]

RUN = """
import json, sys, time
sys.path.insert(0, ".")
sys.path.insert(1, {repo!r})
import torch
from portbench import harness
result = harness.run_cell(harness.Cell({name!r}), 7, {seconds}, {trace},
                          torch.device("cpu"), time.perf_counter(),
                          scale={scale})
print(json.dumps(result))
"""


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = harness.Cell(name)
    assert cell.config["name"] == name.split(".")[0]
    assert cell.queries and cell.generators and callable(cell.launch.run)
    for q in cell.queries.values():
        assert callable(q.run) and callable(q.reference) and q.LIMITS
        assert set(q.TABLES) <= set(cell.config["tables"])
    names = [m["name"] for m in cell.end_to_end + cell.per_layer]
    assert "setup_s" in names and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m).read)


def _copy(tmp_path):
    shutil.copy(harness.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def _add(tmp, key, entry):
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    bench[key].append(entry)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))


def _write(tmp, path, text):
    (tmp / "portbench" / path).write_text(text)


def _run(tmp, name, trace=False, scale=1e-4, seconds=0.2):
    code = RUN.format(repo=str(harness.REPO), name=name, trace=trace,
                      scale=scale, seconds=seconds)
    run = subprocess.run([sys.executable, "-c", code], cwd=tmp,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def test_a_mix_added_as_data_is_found(tmp_path):
    tmp = _copy(tmp_path)
    _write(tmp, "traffic/distinct.json", json.dumps({
        "launch": "one_client", "param_sets": 1, "queries": [
            {"query": "clickbench", "weight": 2, "params": {"q": {"value": 4}}},
            {"query": "clickbench", "weight": 1,
             "params": {"q": {"value": 8}}}]}))
    _add(tmp, "workloads", {
        "name": "clickbench_hits.distinct", "config": "clickbench_hits",
        "traffic": "distinct", "chips": 1, "why": "a test's mix"})
    result = _run(tmp, "clickbench_hits.distinct", seconds=1.0)
    assert result["correct"] and result["attempted"] >= 3


PART = '''
from arrowtpu_torch import entry   # a stand-in for a frozen copy of the laws

def generate(config, seed, device, scale=1.0):
    return entry.example_part_arrays(config["scale_factor"] * scale,
                                     seed % 2**31)

def host_arrays(columns):
    return columns

def rows(arrays):
    return len(arrays["p_partkey"])

def batch(entry, arrays, device):   # the generator's own way in
    return entry.part_batch(arrays, device)
'''

PAIR = '''
TABLES = ("lineitem", "part")
LIMITS = {"pair_wrong": 0}
SAMPLE = None

def run(entry, tables, params):
    return tables["lineitem"].length, tables["part"].length

def light(out):
    return out

def read(out):
    return out

def reference(arrays, params, device, control=False):
    return len(arrays["lineitem"]["l_orderkey"]), len(arrays["part"]["p_partkey"])

def compare(got, want):
    return {"pair_wrong": int(got != want)}
'''


def test_a_query_over_two_tables_added_as_files_is_found(tmp_path):
    """A generator (with its own way into the port) and a query over two
    tables: the cell draws both, the query gets both batches, the reference
    both tables' arrays, and its rows are the two tables' rows."""
    tmp = _copy(tmp_path)
    _write(tmp, "data/part.py", PART)
    _write(tmp, "queries/pair.py", PAIR)
    _write(tmp, "traffic/pair.json", json.dumps({
        "launch": "one_client", "param_sets": 1,
        "queries": [{"query": "pair", "weight": 1, "params": {}}]}))
    _add(tmp, "workloads", {"name": "tpch_sf10.pair", "config": "tpch_sf10",
                            "traffic": "pair", "chips": 1,
                            "why": "a test's mix"})
    result = _run(tmp, "tpch_sf10.pair", scale=1e-4)
    assert result["correct"] and result["checks"]["pair_wrong"]["value"] == 0
    assert result["metrics"]["rows_per_s"]["value"] > 0


METERED = '''
ENTRY = "arrowtpu_torch.kernels.compact3:compact_planes"
KERNELS = ("tile_compact_kernel", "compact16_kernel")

def call_bytes(planes, keep, *args, **kwargs):
    return lambda: int(keep.shape[0])

def read(t):
    k = t.meters["k1_rows_per_query"]
    return k.bytes / t.queries if k.calls else None
'''

SPANNED = '''
SPANS = "arrowtpu_torch.ops.filter"

def read(t):
    return t.span_ms[SPANS] / t.span_queries if t.span_count[SPANS] else None
'''


def test_per_layer_metrics_added_as_files_are_read(tmp_path):
    """A kernel's meter and a package's spans, each one file and one entry:
    the harness meters the entry and wraps the package it names."""
    tmp = _copy(tmp_path)
    _write(tmp, "metrics/k1_rows_per_query.py", METERED)
    _write(tmp, "metrics/filter_ms_per_query.py", SPANNED)
    for name, source in (("k1_rows_per_query", "program_counter"),
                         ("filter_ms_per_query", "program_span")):
        _add(tmp, "per_layer", {
            "name": name, "unit": "x", "better": "lower", "source": source,
            "layer": "test", "moves": "rows_per_s",
            "workloads": ["tpch_sf10.q6"]})
    result = _run(tmp, "tpch_sf10.q6", trace=True, scale=2e-4)
    assert result["correct"]
    assert result["metrics"]["k1_rows_per_query"]["value"] > 0
    assert result["metrics"]["filter_ms_per_query"]["value"] > 0
    assert "ops_ms_per_query" in result["metrics"]
