"""The dense-range GROUP BY aggregate, in CUDA.

Counterpart of what XLA fuses from `arrowtpu/ops/groupby.py`'s dense-range
engine (`_dense_group_by`'s bucket presence counts and
`_dense_agg_column`'s per-bucket count, sum, min and max): not a Pallas
kernel there, about NB masked reductions per output that XLA fuses into one
pass over the rows.  Here it is `dense_agg_kernel` (`csrc/dense_agg.cu`,
whose header gives the design and the bound on the card): one launch on a
persistent grid, 4 rows a thread a step, shared-memory buckets a block
(sums as two 32-bit atomic halves with a carry), merged into a per-device,
per-stream accumulator (`_accumulator`) by the blocks' global atomics; the
last block writes the output and resets the accumulator.

Contract: a key column (int8/16/32 or uint8/16/32, (capacity,) values and
an optional LSB validity bitmap), `kmin` as a one-element int64 tensor on
the key's device, `off` (1 when the key is nullable, else 0), the bucket
count `nb` and the live length `n`; per value column an integer tensor of
any width with an optional validity bitmap.  A row below `n` falls in
bucket `key - kmin + off` when its key is valid and in bucket 0 when it is
null; a bucket outside [0, nb) drops the row.  A value counts where it is
valid.  -> (rows, stats): rows (nb,) int64, the rows in each bucket; stats
(C, 4, nb) int64, per column its valid count, sum (wrapping mod 2**64),
min and max (INT64_MAX and INT64_MIN where the count is 0), in the
column's order (unsigned columns are at most 32 bits wide, so int64 holds
them in order).

A CPU tensor takes `dense_aggregate_plain` (bincount, index_add_ and
scatter_reduce); a CUDA tensor launches the kernel or raises.  `launches`
counts the kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from . import _build
from ..core import bitmap as bm

CODES = {torch.int8: 0, torch.int16: 1, torch.int32: 2, torch.int64: 3,
         torch.uint8: 4, torch.uint16: 5, torch.uint32: 6}
KEY_DTYPES = (torch.int8, torch.int16, torch.int32, torch.uint8,
              torch.uint16, torch.uint32)
MAX_COLS = 8          # value columns per launch (kMaxCols)
MAX_BUCKETS = 4096    # kMaxBuckets
# shared memory a block may use for its buckets: nb * (28 C + 4) bytes
SMEM_BUDGET = 200 * 1024

_I64 = torch.iinfo(torch.int64)

launches = 0

Value = Tuple[torch.Tensor, Optional[torch.Tensor]]


def _check(key, key_validity, kmin, off, nb, n, values: Sequence[Value]):
    if key.dim() != 1 or key.dtype not in KEY_DTYPES:
        raise ValueError(f"key of dtype {key.dtype}: the kernel takes 8- to "
                         "32-bit integer keys")
    if not 1 <= nb <= MAX_BUCKETS or off not in (0, 1):
        raise ValueError(f"nb={nb}, off={off}: nb in [1, {MAX_BUCKETS}], "
                         "off 0 or 1")
    if not 0 <= n <= key.shape[0]:
        raise ValueError(f"length {n} outside [0, {key.shape[0]}]")
    if kmin.dtype != torch.int64 or kmin.numel() != 1 \
            or kmin.device != key.device:
        raise ValueError("kmin must be one int64 on the key's device")
    for t, valid in [(key, key_validity)] + list(values):
        if t.dim() != 1 or t.shape[0] < n or t.device != key.device \
                or not t.is_contiguous():
            raise ValueError("columns must be contiguous 1-D tensors of at "
                             "least n rows on the key's device")
        if t.dtype not in CODES:
            raise ValueError(f"value of dtype {t.dtype}: the kernel takes "
                             "integer columns")
        if valid is not None and (
                valid.dtype != torch.uint8 or valid.dim() != 1
                or valid.shape[0] * 8 < n or valid.device != key.device
                or not valid.is_contiguous()):
            raise ValueError("a validity must be a contiguous uint8 LSB "
                             "bitmap of at least n bits")


def dense_aggregate_plain(key: torch.Tensor,
                          key_validity: Optional[torch.Tensor],
                          kmin: torch.Tensor, off: int, nb: int, n: int,
                          values: Sequence[Value]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: bucket ids, then bincount, index_add_ and
    scatter_reduce per column."""
    _check(key, key_validity, kmin, off, nb, n, values)
    dev = key.device
    b = key[:n].to(torch.int64) - kmin.reshape(()) + off
    if key_validity is not None:
        b = torch.where(bm.unpack(key_validity)[:n], b, 0)
    inb = (b >= 0) & (b < nb)
    rows = torch.bincount(b[inb], minlength=nb)
    stats = torch.empty((len(values), 4, nb), dtype=torch.int64, device=dev)
    for c, (v, valid) in enumerate(values):
        ok = inb if valid is None else inb & bm.unpack(valid)[:n]
        bb, x = b[ok], v[:n].to(torch.int64)[ok]
        stats[c, 0] = torch.bincount(bb, minlength=nb)
        stats[c, 1] = torch.zeros(nb, dtype=torch.int64,
                                  device=dev).index_add_(0, bb, x)
        stats[c, 2] = torch.full((nb,), _I64.max, device=dev).scatter_reduce_(
            0, bb, x, "amin")
        stats[c, 3] = torch.full((nb,), _I64.min, device=dev).scatter_reduce_(
            0, bb, x, "amax")
    return rows, stats


def cols_per_launch(nb: int) -> int:
    """How many value columns one launch takes at `nb` buckets: as many as
    the shared-memory budget holds, at most MAX_COLS, at least one."""
    return max(1, min(MAX_COLS, (SMEM_BUDGET - 4 * nb) // (28 * nb)))


# the kernel's accumulators, one per (device, stream): int64 words of
# (1 + 4 MAX_COLS) rows of MAX_BUCKETS (rows; per column count, sum, min,
# max) at the identity, then the ticket word at 0.  Each launch leaves its
# accumulator so; launches on one stream run in turn.
_accs = {}


def _accumulator(device: torch.device) -> torch.Tensor:
    """The accumulator of `device`'s current stream, made on first use."""
    handle = (device.index, torch.cuda.current_stream(device).cuda_stream)
    acc = _accs.get(handle)
    if acc is None:
        words = _build.library().arrowtpu_dense_agg_acc_words()
        acc = torch.zeros(words, dtype=torch.int64, device=device)
        stats = acc[MAX_BUCKETS:words - 1].view(MAX_COLS, 4, MAX_BUCKETS)
        stats[:, 2] = _I64.max
        stats[:, 3] = _I64.min
        _accs[handle] = acc
    return acc


def dense_aggregate(key: torch.Tensor, key_validity: Optional[torch.Tensor],
                    kmin: torch.Tensor, off: int, nb: int, n: int,
                    values: Sequence[Value]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (rows (nb,) int64, stats (C, 4, nb) int64) as the module's
    contract states.  One launch for up to `cols_per_launch(nb)` value
    columns (one for BASELINE config 4)."""
    global launches
    if key.device.type == "cpu":
        return dense_aggregate_plain(key, key_validity, kmin, off, nb, n,
                                     values)
    _build.require_cuda(key, "dense_agg.dense_aggregate")
    _check(key, key_validity, kmin, off, nb, n, values)
    values = list(values)
    step = cols_per_launch(nb)
    parts: List[torch.Tensor] = []
    rows = None
    lib = _build.library()
    with torch.cuda.device(key.device):
        acc = _accumulator(key.device)
        for i in range(0, max(len(values), 1), step):
            chunk = values[i:i + step]
            out = torch.empty((1 + 4 * len(chunk), nb), dtype=torch.int64,
                              device=key.device)
            codes = (ctypes.c_int * len(chunk))(
                *[CODES[v.dtype] for v, _ in chunk])
            _build._check(lib.arrowtpu_dense_agg(
                CODES[key.dtype], key.data_ptr(),
                None if key_validity is None else key_validity.data_ptr(),
                kmin.data_ptr(), off, nb, n, len(chunk),
                _build.plane_ptrs([v for v, _ in chunk]),
                _build.plane_ptrs([ok for _, ok in chunk]), codes,
                acc.data_ptr(), out.data_ptr(), _build._stream(key)),
                "dense_agg_kernel")
            launches += 1
            if rows is None:
                rows = out[0]
            parts.append(out[1:].view(len(chunk), 4, nb))
    return rows, parts[0] if len(parts) == 1 else torch.cat(parts)
