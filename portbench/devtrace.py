"""The device's side of a traced window, read from torch.profiler's events
(Kineto's, as the profiler hands them over: no file is written).

Only the queries count: the harness wraps each query, from its call to the
synchronize after its return, in a "pb:query" annotation, and whatever it
does between queries (settling the meters' byte counts) lies outside.  The
profiler puts the device's times on the host's clock with an offset that
moves from process to process (seen on the card: a query's last kernels
read after its synchronize); `Trace` takes the least lag from a launch to
its kernel or copy as that offset and moves the device's times back by it,
so that the quickest launch is taken to start at once.  Within the
queries' intervals `Trace` gives:
- `window_s`, their summed length, and `busy_s`, the union of the device's
  kernel, copy and memset intervals inside them;
- `kernels`, the kernels launched; and `port_kernels`, by name, the
  port's hand-written kernels (PORT_KERNELS) anywhere in the trace, for the
  check that no launch was lost (a kernel that the profiler's clock puts
  just outside its query still counts there);
- `meter_ms` and `meter_launches`, by meter: the device time and the count
  of the kernels, of the names the meter gives, whose launch (the CUDA
  runtime or driver call that has the kernel's correlation id) lies inside
  one of the meter's "pb:kernel:<meter>" annotations;
- `device_ops` and `idle_gaps` for the result's breakdown: device time by
  operation, and idle time by what the host was doing (the innermost "pb:"
  annotation over the gap, else "query", and the innermost host operation,
  else "python": the port's own Python between operations);
- `device` and `host`, the events inside the queries, for readers to come:
  (start ns, end ns, name, kind) and (start ns, end ns, name).
"""

from __future__ import annotations

import bisect
import collections

import torch

PORT_KERNELS = ("tile_compact_kernel", "compact16_kernel",
                "tile_counts_kernel", "dense_agg_kernel")
COPIES = ("Memcpy", "Memset")
TOP = 10


def kind(e) -> str:
    """An event's kind by its device and name (the profiler's own activity
    type is not in every torch version): "annotation" (a "pb:" span on the
    host; its device-side copy is dropped), "copy", "kernel" or "host"."""
    name = e.name()
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        if name.startswith("pb:"):
            return "device annotation"
        return "copy" if name.startswith(COPIES) else "kernel"
    return "annotation" if name.startswith("pb:") else "host"


def _short(name: str) -> str:
    """A kernel's name without anonymous namespaces and its argument list,
    at most 100 characters."""
    name = name.replace("(anonymous namespace)::", "")
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:100]


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clip(intervals, windows) -> list:
    """The parts of (start, end) intervals inside the sorted, disjoint
    windows."""
    starts = [w[0] for w in windows]
    out = []
    for s, e in intervals:
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        while i < len(windows) and windows[i][0] < e:
            lo, hi = max(s, windows[i][0]), min(e, windows[i][1])
            if lo < hi:
                out.append((lo, hi))
            i += 1
    return out


def _inside(t, windows, starts) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t < windows[i][1]


def _innermost(points, spans) -> list:
    """For each sorted point, the name of the innermost (latest started)
    span over it, or None: a sweep with a stack of open spans."""
    spans = sorted(spans)
    out, stack, j = [], [], 0
    for t in points:
        while j < len(spans) and spans[j][0] <= t:
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        live = [s for s in reversed(stack) if s[1] >= t]
        out.append(live[0][2] if live else None)
    return out


def _launch_times(host, device) -> dict:
    """correlation id -> the start of the CUDA runtime or driver call that
    launched it (host events named cu*)."""
    wanted = {d[4] for d in device}
    out = {}
    for s, _, name, corr in host:
        if corr in wanted and name.startswith("cu"):
            out.setdefault(corr, s)
    return out


class Trace:
    def __init__(self, events, meters=None):
        """`meters`: {meter: kernel name parts}, for `meter_ms` and
        `meter_launches`."""
        meters = meters or {}
        device, queries, spans, host = [], [], [], []
        for e in events:
            what = kind(e)
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
            if what in ("kernel", "copy"):
                device.append((start, end, e.name(), what, e.correlation_id()))
            elif what == "annotation":
                if e.name() == "pb:query":
                    queries.append((start, end))
                else:
                    spans.append((start, end, e.name()[3:]))
            elif what == "host":
                host.append((start, end, e.name(), e.correlation_id()))
        launched = _launch_times(host, device)
        lags = [d[0] - launched[d[4]] for d in device if d[4] in launched]
        self.offset_ns = min(lags) if lags else 0
        device = [(d[0] - self.offset_ns, d[1] - self.offset_ns) + d[2:]
                  for d in device]
        self.windows = [tuple(w) for w in _union(queries)]
        starts = [w[0] for w in self.windows]
        self.queries = len(queries)
        self.window_s = sum(e - s for s, e in self.windows) / 1e9
        inside = sorted((d for d in device if _inside(d[0], self.windows,
                                                      starts)),
                        key=lambda d: d[0])
        busy = _union(_clip([d[:2] for d in device], self.windows))
        self.busy_s = sum(e - s for s, e in busy) / 1e9
        kernels = [d for d in inside if d[3] == "kernel"]
        self.kernels = len(kernels)
        self.port_kernels = collections.Counter(
            _short(d[2]) for d in device
            if d[3] == "kernel" and any(k in d[2] for k in PORT_KERNELS))
        self.meter_ms = {m: 0.0 for m in meters}
        self.meter_launches = {m: 0 for m in meters}
        for m, names in meters.items():
            tagged = [(s, e) for s, e, n in spans if n == f"kernel:{m}"]
            for d in kernels:
                at = launched.get(d[4])
                if (at is not None and any(k in d[2] for k in names)
                        and any(s <= at <= e for s, e in tagged)):
                    self.meter_ms[m] += (d[1] - d[0]) / 1e6
                    self.meter_launches[m] += 1
        by_op = collections.Counter()
        for s, e, name, _, _ in inside:
            by_op[_short(name)] += (e - s) / 1e9
        self.device_ops = [[n, s] for n, s in by_op.most_common(TOP)]
        gaps = []
        for w in self.windows:
            cursor = w[0]
            for s, e in _clip(busy, [w]):
                if s > cursor:
                    gaps.append((cursor, s))
                cursor = max(cursor, e)
            if cursor < w[1]:
                gaps.append((cursor, w[1]))
        mids = sorted(((s + e) // 2, e - s) for s, e in gaps)
        points = [m for m, _ in mids]
        labels = zip(_innermost(points, spans),
                     _innermost(points, [h[:3] for h in host]))
        by_gap = collections.Counter()
        for (span, op), (_, length) in zip(labels, mids):
            by_gap[f"{span or 'query'} / {op or 'python'}"] += length / 1e9
        self.idle_gaps = [[n, s] for n, s in by_gap.most_common(TOP)]
        self.device = [d[:4] for d in inside]
        self.host = [h[:3] for h in host if _inside(h[0], self.windows,
                                                    starts)]
