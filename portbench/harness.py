"""The benchmark of `arrowtpu_torch`: one run of one cell.

Everything that belongs to a cell is found by name from `BENCHMARK.json`:
the configuration's file (`configs/<config>.json`: its tables, each with
the generator in `data/` and the entry function that builds its batch),
the traffic mix (`traffic/<traffic>.json`, read by `mix.py`), the launch
the mix names (`launch/<launch>.py`: the processes and clients that drive
the window), the query kinds the mix names (`queries/<query>.py`, each
naming the tables it reads, with its reference in `reference/`) and one
reader a metric (`metrics/<metric>.py`; a kernel's metric names the entry
it meters, a layer's the package its spans wrap).

`run_cell`, one process on one device: the tables the cell's queries read
drawn on the device from the seed, moved to the host and handed to the
port's batch builders; every item of the mix run once (warm-up: the
kernels are built or loaded here); then a closed loop with one client runs
the mix's seeded order of items over and over for `seconds` (trace 0: the
end-to-end metrics), or (trace 1: the per-layer metrics) for whole cycles
under torch.profiler and then for whole cycles with the spans.  After the
window: the peak memory is read, the outputs are read back, the program's
state is freed, and the plain reference answers each item; `correct` holds
each number compared to its limit.
"""

from __future__ import annotations

import argparse
import collections
import functools
import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
import traceback
import types
from pathlib import Path

import numpy as np
import torch

from portbench import devtrace, mix as mixes
from portbench.spans import PORT, Spans

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "arrowtpu"}
TRACE_SECONDS = 4.0     # a traced window: whole cycles of the mix, >= this
TRACE_ATTEMPTS = 5      # traced windows tried for one that lost no launch
PORT_COUNTERS = (("kernels.compact3", "launches"),
                 ("kernels.compact", "launches"),
                 ("kernels.compact2", "launches"),
                 ("kernels.dense_agg", "launches"),
                 ("kernels._build", "count_launches"))


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def load_file(path: Path):
    """A module from a file whose name may hold dots."""
    spec = importlib.util.spec_from_file_location(
        "portbench_file_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """A workload of BENCHMARK.json and every file it names."""

    def __init__(self, name: str, repo: Path = REPO):
        bench = json.loads((repo / "BENCHMARK.json").read_text())
        work = {w["name"]: w for w in bench["workloads"]}[name]
        conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
        self.name, self.chips, self.repo = name, work["chips"], repo
        self.root = repo / ROOT.name
        self.config = json.loads((repo / conf["file"]).read_text())
        self.mix = mixes.load(self.root / "traffic" / f"{work['traffic']}.json")
        self.launch = importlib.import_module(
            f"portbench.launch.{self.mix['launch']}")
        self.end_to_end = bench["end_to_end"]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m["workloads"]]
        self.queries = {q["query"]: importlib.import_module(
            f"portbench.queries.{q['query']}") for q in self.mix["queries"]}
        self.tables = sorted({t for q in self.queries.values()
                              for t in q.TABLES})
        self.generators = {t: importlib.import_module(
            f"portbench.data.{self.config['tables'][t]['generator']}")
            for t in self.tables}
        self.readers = {}

    def reader(self, metric: dict):
        name = metric["name"]
        if name not in self.readers:
            self.readers[name] = load_file(self.root / "metrics" / f"{name}.py")
        return self.readers[name]


def _mark(device):
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _elapsed_ms(a, b) -> float:
    return a.elapsed_time(b) if isinstance(a, torch.cuda.Event) \
        else (b - a) * 1e3


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Outputs:
    """Every output of the window, for the comparison after it: whole for a
    query kind with SAMPLE None, else whole for a reservoir sample of
    SAMPLE outputs drawn from the seed and light (`light(out)`) for the
    rest."""

    def __init__(self, queries: dict, seed: int):
        self.queries = queries
        self.rng = np.random.default_rng([int(seed), 3])
        self.records = []     # [item, output]
        self.full = {}        # query kind -> indices of whole outputs kept
        self.seen = {}

    def add(self, item, out) -> None:
        q = self.queries[item.query]
        self.records.append([item, out])
        if q.SAMPLE is None:
            return
        seen = self.seen[item.query] = self.seen.get(item.query, 0) + 1
        full = self.full.setdefault(item.query, [])
        if len(full) < q.SAMPLE:
            full.append(len(self.records) - 1)
            return
        slot = int(self.rng.integers(seen))
        if slot < q.SAMPLE:
            old = full[slot]
            self.records[old][1] = q.light(self.records[old][1])
            full[slot] = len(self.records) - 1
        else:
            self.records[-1][1] = q.light(out)


class Meters:
    """The calls of the port's kernel entries that per-layer metrics name (a
    metric's module gives ENTRY, "module:function", KERNELS, the names of
    the kernels the entry launches that count, and `call_bytes(*args,
    **kwargs)`, the call's bytes or a function of none that gives them once
    the query is done).  Each call is counted, its bytes reckoned, and run
    inside a "pb:kernel:<metric>" annotation, by which the trace finds the
    kernels it launched."""

    def __init__(self, modules: dict):
        self.modules = modules          # metric -> its module
        self.pending, self.restore = [], []
        self.reset()

    def reset(self) -> None:
        self.calls = {m: 0 for m in self.modules}
        self.bytes = {m: 0 for m in self.modules}

    def _wrap(self, metric, mod, fn):
        from torch.profiler import record_function

        tag = f"pb:kernel:{metric}"

        @functools.wraps(fn)
        def metered(*args, **kwargs):
            self.pending.append((metric, mod.call_bytes(*args, **kwargs)))
            with record_function(tag):
                return fn(*args, **kwargs)
        return metered

    def install(self) -> None:
        for metric, mod in self.modules.items():
            owner, name = mod.ENTRY.split(":")
            fn = getattr(importlib.import_module(owner), name)
            metered = self._wrap(metric, mod, fn)
            for m in port_modules():
                for attr, obj in list(vars(m).items()):
                    if obj is fn:
                        setattr(m, attr, metered)
                        self.restore.append((m, attr, fn))

    def uninstall(self) -> None:
        for m, attr, fn in reversed(self.restore):
            setattr(m, attr, fn)
        self.restore.clear()

    def settle(self) -> None:
        for metric, nbytes in self.pending:
            self.calls[metric] += 1
            self.bytes[metric] += nbytes() if callable(nbytes) else nbytes
        self.pending.clear()


def port_modules() -> list:
    return [m for k, m in list(sys.modules.items())
            if (k == PORT or k.startswith(PORT + ".")) and m is not None]


def port_launches() -> dict:
    return {f"{mod}.{attr}": getattr(
        importlib.import_module(f"{PORT}.{mod}"), attr)
        for mod, attr in PORT_COUNTERS}


def _run_one(run, item, stats, outputs, device):
    """One query: -> (start mark, end mark), or None where it raised."""
    stats["attempted"] += 1
    start = _mark(device)
    try:
        out = run(item)
    except Exception:  # a failed query counts, and the run goes on
        stats["failed"] += 1
        if stats["failed"] == 1:
            log(f"query {item.label()} failed:\n{traceback.format_exc()}")
        _sync(device)
        return None
    end = _mark(device)
    _sync(device)
    outputs.add(item, out)
    return start, end


def timed_window(cycle, run, seconds, outputs, item_rows, device) -> dict:
    stats = {"attempted": 0, "failed": 0}
    marks, done = [], 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    while time.perf_counter() < deadline:
        item = cycle[i % len(cycle)]
        i += 1
        m = _run_one(run, item, stats, outputs, device)
        if m is not None:
            marks.append(m)
            done += item_rows[item]
    window_s = time.perf_counter() - t0
    return {**stats, "window_s": window_s, "rows": done,
            "completed": len(marks),
            "latencies_ms": [_elapsed_ms(a, b) for a, b in marks]}


def _cycles(cycle, seconds, each):
    """Whole cycles of the mix, `each(item)` on each item, until
    min(seconds, TRACE_SECONDS) have passed."""
    t0 = time.perf_counter()
    while True:
        for item in cycle:
            each(item)
        if time.perf_counter() - t0 >= min(seconds, TRACE_SECONDS):
            return


def profiled_window(cell, cycle, run, seconds, outputs, device, stats):
    """Whole cycles under torch.profiler, each query inside a "pb:query"
    annotation, the metered kernel entries wrapped (no spans: their cost
    would read as the device's idle time).  Tried again, up to
    TRACE_ATTEMPTS times, where the profiler's count of the port's kernels
    differs from the port's counters; `lost` says whether the last window
    still differs."""
    from torch.profiler import ProfilerActivity, profile, record_function

    meters = Meters({m["name"]: cell.reader(m) for m in cell.per_layer
                     if hasattr(cell.reader(m), "ENTRY")})
    meters.install()
    try:
        for attempt in range(TRACE_ATTEMPTS):
            meters.reset()
            before, queries = port_launches(), [0]

            def each(item):
                with record_function("pb:query"):
                    queries[0] += _run_one(run, item, stats, outputs,
                                           device) is not None
                meters.settle()

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _cycles(cycle, seconds, each)
            after = port_launches()
            launched = {k: after[k] - before[k] for k in after}
            events = prof.profiler.kineto_results.events()
            if attempt == 0:
                kinds = collections.Counter(map(devtrace.kind, events))
                log(f"trace: {len(events)} events, by kind {dict(kinds)}")
            trace = devtrace.Trace(events, {m: meters.modules[m].KERNELS
                                            for m in meters.modules})
            seen = sum(trace.port_kernels.values())
            lost = (seen != sum(launched.values())
                    or trace.queries != queries[0])
            log(f"profiled window {attempt + 1}: {queries[0]} queries, "
                f"{trace.kernels} kernels; the port's kernels: trace "
                f"{seen}, counters {launched}; metered launches "
                f"{trace.meter_launches}; device clock offset "
                f"{trace.offset_ns} ns"
                + (f"; LAUNCHES LOST: in the trace {dict(trace.port_kernels)}"
                   if lost else ""))
            if not lost:
                break
    finally:
        meters.uninstall()
    return types.SimpleNamespace(
        queries=queries[0], trace=trace, lost=lost,
        meters={m: types.SimpleNamespace(
            calls=meters.calls[m], bytes=meters.bytes[m],
            ms=trace.meter_ms[m], launches=trace.meter_launches[m])
            for m in meters.modules})


def spanned_window(cell, cycle, run, seconds, outputs, device, stats):
    """Whole cycles with the spans of the packages that per-layer metrics
    name, and no profiler."""
    packages = {cell.reader(m).SPANS for m in cell.per_layer
                if hasattr(cell.reader(m), "SPANS")}
    spans = Spans(device, packages)
    span_ms = {p: 0.0 for p in packages}
    span_count = {p: 0 for p in packages}
    queries = [0]

    def each(item):
        queries[0] += _run_one(run, item, stats, outputs, device) is not None
        ms, count = spans.take()
        for p in packages:
            span_ms[p] += ms[p]
            span_count[p] += count[p]

    spans.install()
    try:
        _cycles(cycle, seconds, each)
    finally:
        spans.uninstall()
    log(f"spanned window: {queries[0]} queries, spans {span_count}")
    return types.SimpleNamespace(span_queries=queries[0], span_ms=span_ms,
                                 span_count=span_count)


def traced_window(cell, cycle, run, seconds, outputs, device) -> dict:
    """The profiled window, then the spanned one."""
    stats = {"attempted": 0, "failed": 0}
    prof = profiled_window(cell, cycle, run, seconds, outputs, device, stats)
    spanned = spanned_window(cell, cycle, run, seconds, outputs, device,
                             stats)
    return {**stats, "lost": prof.lost, "trace": prof.trace,
            "reading": types.SimpleNamespace(**vars(prof), **vars(spanned))}


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def build_table(cell: Cell, table: str, entry, arrays: dict, device):
    """A table's batch, built by the port from the drawn arrays: by its
    generator's own `batch(entry, arrays, device)` where it has one (a table
    that reaches the port through a file or a stream), else by the entry
    function the configuration names."""
    gen = cell.generators[table]
    if hasattr(gen, "batch"):
        return gen.batch(entry, arrays, device)
    return getattr(entry, cell.config["tables"][table]["batch"])(arrays,
                                                                 device)


def on_device(arrays: dict, device) -> dict:
    """A table's host arrays on `device` (uint64 as its int64 bits), for
    the reference."""
    def up(a):
        if a.dtype == np.uint64:
            a = a.view(np.int64)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {k: tuple(map(up, v)) if isinstance(v, tuple) else up(v)
            for k, v in arrays.items()}


def compare(cell: Cell, outputs: Outputs, answers: dict, failed: int):
    """-> (correct, checks): each number compared, its worst reading over
    the outputs beside its limit."""
    limits = {k: v for q in cell.queries.values() for k, v in q.LIMITS.items()}
    worst = {k: 0 for k in limits}
    for item, got in outputs.records:
        for k, v in cell.queries[item.query].compare(
                got, answers[item]).items():
            worst[k] = max(worst[k], v)
    log(f"answers compared: {len(outputs.records)}")
    checks = {"failed_queries": {"value": failed, "limit": 0}}
    checks.update({k: {"value": worst[k], "limit": limits[k]} for k in worst})
    correct = (failed == 0 and len(outputs.records) >= 1
               and all(worst[k] <= limits[k] for k in worst))
    return correct, checks


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, scale: float = 1.0) -> dict:
    cycle = mixes.order(cell.mix, seed)
    items = list(dict.fromkeys(cycle))
    arrays, rows = {}, {}
    for table, gen in cell.generators.items():
        arrays[table] = gen.host_arrays(gen.generate(cell.config, seed,
                                                     device, scale))
        rows[table] = gen.rows(arrays[table])
    _sync(device)
    log(f"setup: {rows} rows drawn and on the host at "
        f"{time.perf_counter() - t_start:.2f} s")
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    from arrowtpu_torch import entry

    tables = {t: build_table(cell, t, entry, arrays[t], device)
              for t in cell.tables}
    _sync(device)
    log(f"setup: batches built at {time.perf_counter() - t_start:.2f} s")

    def run(item):
        return cell.queries[item.query].run(entry, tables, item.kwargs)

    for item in items:  # warm-up: every item once
        run(item)
        _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"setup: {len(items)} items warmed up at {setup_s:.2f} s")
    outputs = Outputs(cell.queries, seed)
    if trace:
        window = traced_window(cell, cycle, run, seconds, outputs, device)
    else:
        item_rows = {item: sum(rows[t] for t in cell.queries[
            item.query].TABLES) for item in items}
        window = timed_window(cycle, run, seconds, outputs, item_rows, device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    for rec in outputs.records:
        item = rec[0]
        try:
            rec[1] = cell.queries[item.query].read(rec[1])
        except Exception:  # an output that cannot be read is wrong
            log(f"output of {item.label()} unreadable:\n"
                f"{traceback.format_exc()}")
            rec[1] = None
    del tables, run
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    on_card = {t: on_device(a, device) for t, a in arrays.items()}
    answers = {item: cell.queries[item.query].reference(
        on_card, item.kwargs, device) for item in items}
    log(f"reference: {len(items)} answers in "
        f"{time.perf_counter() - t_ref:.2f} s")
    correct, checks = compare(cell, outputs, answers, window["failed"])

    metrics = {}
    if trace:
        reading = window["reading"]
        wanted = cell.per_layer
        if window["lost"]:
            log("every profiled window lost launches: the metrics read "
                "from the trace are left out")
            wanted = [m for m in wanted if m["source"] != "device_trace"]
    else:
        reading = types.SimpleNamespace(setup_s=setup_s, **window)
        wanted = cell.end_to_end
    for m in wanted:
        value = cell.reader(m).read(reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics, "device": dev}
    if trace:
        tr = window["trace"]
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops,
                               "idle_gaps": tr.idle_gaps}
    result["checks"] = checks
    return result


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv, t_start: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    cell = Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count()} available: no result")
        return 2
    result = cell.launch.run(cell, args.seed, args.seconds, bool(args.trace),
                             t_start)
    found = forbidden_modules()
    if found:
        log(f"modules loaded that the port may not load: {found}: no result")
        return 3
    log(f"card: {power_limit()}")
    for k, m in result["metrics"].items():
        log(f"metric {k}: {m['value']} {m['unit']}")
    for k, c in result["checks"].items():
        log(f"check {k}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0
