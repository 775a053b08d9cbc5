"""Spans around the calls into the port's packages that per-layer metrics
name (a metric's module gives SPANS, a package or module of the port),
recorded from the benchmark's side: no file of the program is edited.

`install` wraps every public function defined under a named package, and
puts the wrapper in place of the function in every loaded module of the
port that holds it, so a call through `ops.x`, `gb.x`, `rf.x` or a name
imported into `entry` opens a span.  A span is timed by CUDA events on the
current stream (by the host clock on the CPU, in tests).  Its self time is
its length less its direct children's (spans of any package), and counts
for every named package that holds its function; `take` returns each
package's self time and forgets the spans.
"""

from __future__ import annotations

import functools
import importlib
import inspect
import pkgutil
import sys
import time

import torch

PORT = "arrowtpu_torch"


class _HostMark:
    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_ms(self, other) -> float:
        return (other.t - self.t) * 1e3


class _CudaMark:
    def __init__(self):
        self.ev = torch.cuda.Event(enable_timing=True)
        self.ev.record()

    def elapsed_ms(self, other) -> float:
        return self.ev.elapsed_time(other.ev)


def _modules(package: str) -> list:
    pkg = importlib.import_module(package)
    mods = [pkg]
    for info in pkgutil.iter_modules(getattr(pkg, "__path__", [])):
        mods.append(importlib.import_module(f"{package}.{info.name}"))
    return mods


def _under(module: str, package: str) -> bool:
    return module == package or module.startswith(package + ".")


class Spans:
    def __init__(self, device: torch.device, packages):
        self.packages = sorted(set(packages))
        self.mark = _CudaMark if device.type == "cuda" else _HostMark
        self.records = []   # [packages, start mark, end mark, parent index]
        self.stack = []
        self.restore = []

    def _wrap(self, fn, packages: tuple):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            rec = [packages, None, None, self.stack[-1] if self.stack else -1]
            self.records.append(rec)
            self.stack.append(len(self.records) - 1)
            rec[1] = self.mark()
            try:
                return fn(*args, **kwargs)
            finally:
                rec[2] = self.mark()
                self.stack.pop()
        return spanned

    def install(self) -> None:
        wrapped = {}
        for package in self.packages:
            for mod in _modules(package):
                for name, obj in vars(mod).items():
                    if (inspect.isfunction(obj) and not name.startswith("_")
                            and _under(obj.__module__, package)
                            and id(obj) not in wrapped):
                        held = tuple(p for p in self.packages
                                     if _under(obj.__module__, p))
                        wrapped[id(obj)] = (obj, self._wrap(obj, held))
        for mod in [m for k, m in list(sys.modules.items())
                    if _under(k, PORT) and m is not None]:
            for name, obj in list(vars(mod).items()):
                if id(obj) in wrapped and wrapped[id(obj)][0] is obj:
                    setattr(mod, name, wrapped[id(obj)][1])
                    self.restore.append((mod, name, obj))

    def uninstall(self) -> None:
        for mod, name, obj in reversed(self.restore):
            setattr(mod, name, obj)
        self.restore.clear()

    def take(self):
        """-> ({package: self time in ms}, {package: spans}) of the spans
        closed since the last call (the stream must have passed their end
        marks)."""
        dur = [r[1].elapsed_ms(r[2]) for r in self.records]
        own = list(dur)
        for i, r in enumerate(self.records):
            if r[3] >= 0:
                own[r[3]] -= dur[i]
        out = {p: 0.0 for p in self.packages}
        count = {p: 0 for p in self.packages}
        for r, ms in zip(self.records, own):
            for p in r[0]:
                out[p] += ms
                count[p] += 1
        self.records.clear()
        return out, count
