"""Memory accounting and opt-in execution metrics.

Counterpart of `arrowtpu/utils/metrics.py`: `buffer_memory_size` sums the
bytes of every tensor a column or batch holds (each tensor once, however
often it is reached: a string view's arena, a dictionary's values);
`TrackingMemoryPool` accounts claimed bytes per tag; `Metrics` holds
counters a reader or kernel can bump.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict

import torch

from ..core import batch as bt


def _tensors(x, seen: Dict[int, torch.Tensor]):
    if isinstance(x, torch.Tensor):
        seen.setdefault(id(x), x)
    elif isinstance(x, (tuple, list)):
        for y in x:
            _tensors(y, seen)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _tensors(getattr(x, f.name), seen)


def buffer_memory_size(x) -> int:
    """Total bytes of the tensors reachable from a column or batch."""
    seen: Dict[int, torch.Tensor] = {}
    _tensors(x, seen)
    return sum(t.numel() * t.element_size() for t in seen.values())


class TrackingMemoryPool:
    """Accounts bytes claimed per tag."""

    def __init__(self):
        self._lock = threading.Lock()
        self._used: Dict[str, int] = {}

    def claim(self, tag: str, x) -> int:
        n = buffer_memory_size(x) if not isinstance(x, int) else x
        with self._lock:
            self._used[tag] = self._used.get(tag, 0) + n
        return n

    def release(self, tag: str, nbytes: int):
        with self._lock:
            self._used[tag] = max(0, self._used.get(tag, 0) - nbytes)

    def used(self, tag: str = None) -> int:
        with self._lock:
            if tag is not None:
                return self._used.get(tag, 0)
            return sum(self._used.values())


@dataclasses.dataclass
class Metrics:
    """Opt-in counters."""

    records_read: int = 0
    bytes_read: int = 0
    batches_decoded: int = 0
    predicate_rows_pruned: int = 0

    def record_batch(self, batch: bt.RecordBatch):
        self.records_read += int(batch.length)
        self.bytes_read += buffer_memory_size(batch)
        self.batches_decoded += 1
