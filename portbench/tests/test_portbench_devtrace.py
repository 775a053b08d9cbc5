"""The reading of a trace, on made-up events: the queries' windows, the
device's busy time, the port's kernels, a meter's kernels by the launches
inside its annotations, and the idle gaps by what the host was doing; and
a run whose profiled windows all lose launches leaves out the metrics read
from the trace."""

import time

import pytest
import torch

from portbench import devtrace, harness


class Event:
    def __init__(self, kind, name, start, end, corr=0):
        self.kind, self.n, self.s, self.e, self.c = kind, name, start, end, corr

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self.kind in (
            "kernel", "gpu_memcpy") else torch.autograd.DeviceType.CPU)

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.e - self.s

    def correlation_id(self):
        return self.c


EVENTS = [
    Event("user_annotation", "pb:query", 0, 1000),
    Event("user_annotation", "pb:kernel:k1", 10, 60),
    Event("cuda_runtime", "cudaLaunchKernel", 20, 25, 1),
    Event("cuda_runtime", "cudaLaunchKernel", 30, 35, 2),
    Event("cpu_op", "aten::nonzero", 500, 560, 1),      # an op's own id
    Event("kernel", "void tile_compact_kernel<unsigned int, 0, 4>(int)",
          100, 300, 1),
    Event("kernel", "void compact16_kernel<1, 4>(int)", 300, 350, 2),
    Event("cuda_runtime", "cudaMemcpyAsync", 350, 362, 3),  # starts at once
    Event("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 350, 360, 3),
    Event("user_annotation", "pb:kernel:dense", 650, 700),
    Event("cuda_runtime", "cuLaunchKernel", 660, 670, 4),
    Event("kernel", "void dense_agg_kernel<2>(int)", 700, 900, 4),
    Event("user_annotation", "pb:query", 2000, 2500),
    Event("cuda_runtime", "cudaLaunchKernel", 2010, 2015, 5),
    Event("kernel", "void tile_counts_kernel(int)", 2100, 2200, 5),
    Event("kernel", "elementwise_kernel", 2200, 2300, 6),
    Event("cuda_runtime", "cudaLaunchKernel", 2020, 2025, 7),
    Event("kernel", "void tile_compact_kernel<unsigned char, 0, 4>(int)",
          2300, 2400, 7),                               # K2's: no meter
    Event("kernel", "void tile_counts_kernel(int)", 1500, 1600, 8),  # between
]
METERS = {"k1": ("tile_compact_kernel", "compact16_kernel"),
          "dense": ("dense_agg_kernel",)}


def test_trace_reading():
    t = devtrace.Trace(EVENTS, METERS)
    assert t.queries == 2 and t.window_s == pytest.approx(1500e-9)
    assert t.offset_ns == 0
    assert t.busy_s == pytest.approx(760e-9)
    assert t.kernels == 6 and sum(t.port_kernels.values()) == 6
    assert t.port_kernels["void tile_counts_kernel"] == 2
    assert t.meter_launches == {"k1": 2, "dense": 1}
    assert t.meter_ms == pytest.approx({"k1": 250e-6, "dense": 200e-6})
    assert t.device_ops[0] == ["void tile_compact_kernel<unsigned int, 0, 4>",
                               pytest.approx(200e-9)]
    gaps = dict(t.idle_gaps)
    assert gaps == pytest.approx({
        "query / aten::nonzero": 340e-9,
        "query / python": 300e-9,
        "kernel:k1 / python": 100e-9})


def test_the_device_clocks_offset_is_taken_out():
    """The device's times read late (or early) by an offset: the reading is
    the same as with none."""
    want = devtrace.Trace(EVENTS, METERS)
    for shift in (700, -40):
        moved = [Event(e.kind, e.n, e.s + shift, e.e + shift, e.c)
                 if e.kind in ("kernel", "gpu_memcpy") else e for e in EVENTS]
        t = devtrace.Trace(moved, METERS)
        assert t.offset_ns == shift
        assert (t.busy_s, t.kernels, t.meter_ms, t.idle_gaps) == (
            want.busy_s, want.kernels, want.meter_ms, want.idle_gaps)


def test_a_launch_outside_the_meter_does_not_count():
    events = [e for e in EVENTS if e.n != "pb:kernel:k1"]
    t = devtrace.Trace(events, METERS)
    assert t.meter_launches["k1"] == 0 and t.meter_ms["k1"] == 0


def test_a_lost_window_leaves_out_the_trace_metrics(monkeypatch):
    """Where every profiled window's count of the port's kernels differs
    from the port's counters, the metrics read from the trace are left out
    and those of the spans stay."""
    cell = harness.Cell("tpch_sf10.q6")
    sources = {m["name"]: m["source"] for m in cell.per_layer}
    result = harness.run_cell(cell, 9, 0.2, True, torch.device("cpu"),
                              time.perf_counter(), scale=2e-4)
    assert "device_idle_share" in result["metrics"]
    ticks = iter(range(10**6))
    monkeypatch.setattr(harness, "port_launches", lambda: {
        k: next(ticks) for k in ("a", "b")})
    lossy = harness.run_cell(harness.Cell("tpch_sf10.q6"), 9, 0.2, True,
                             torch.device("cpu"), time.perf_counter(),
                             scale=2e-4)
    assert lossy["metrics"]
    assert all(sources[k] != "device_trace" for k in lossy["metrics"])
    assert "ops_ms_per_query" in lossy["metrics"]
