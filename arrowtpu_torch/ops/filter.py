"""Filter: masked compaction of columns and record batches.

Counterpart of `arrowtpu/ops/filter.py`.  A `FilterPlan` is built once per
mask (a null predicate row selects nothing) and applied to any number of
columns.  Every plane moves through a hand-written CUDA kernel on the card,
grouped so that one launch serves all planes of a kind:

  * 4- and 8-byte planes (int32 / int64 / float values) -> K1,
    kernels/compact3.py;
  * byte planes (bool values, validity, int8 / uint8) -> K2 in u8 mode,
    kernels/compact.py;
  * 2-byte planes widen to 4 bytes for K1 and narrow back.

A whole batch thus costs one K1 and one K2 launch, where the JAX package
launches per column.  The tile offsets of the keep mask are computed once,
in `build_plan`, and shared by every launch.

Output columns have length = the plan's count, read back once when the
plan is built, and the port's own capacity: that count rounded up to the
capacity granule (the JAX package keeps the input capacity).  So the
kernels write only the kept rows and a short zero tail, and everything
downstream of a selective filter works on the kept rows alone.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from .. import schema as st
from ..config import round_up
from ..core import batch as bt
from ..core import bitmap as bm
from ..core import column as col
from ..kernels import compact as k2
from ..kernels import compact3 as k1


@dataclasses.dataclass(frozen=True)
class FilterPlan:
    """A selection computed once.

    `folded_validity` is the mask's validity bitmap, which `build_plan`
    ANDed into `keep`: a column whose validity IS that object has every
    kept row valid, so its output needs no bitmap and its validity plane
    is not compacted at all."""

    keep: torch.Tensor  # (capacity,) bool
    count: int
    offs: torch.Tensor  # tile offsets of keep (kernels/_build.tile_offsets)
    folded_validity: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.keep.shape[0]

    @property
    def out_capacity(self) -> int:
        return round_up(max(self.count, 1))


def build_plan(mask: col.BooleanColumn) -> FilterPlan:
    if not isinstance(mask, col.BooleanColumn):
        raise st.ComputeError("filter mask must be a BooleanColumn")
    keep_bits = mask.values
    if mask.validity is not None:
        keep_bits = keep_bits & mask.validity  # null predicate -> false
    keep = bm.unpack(bm.clip(keep_bits, mask.length))
    offs = k1.tile_offsets(keep)
    return FilterPlan(keep, int(offs[-1]), offs, mask.validity)


def compact_planes(planes: List[torch.Tensor], plan: FilterPlan
                   ) -> List[torch.Tensor]:
    """Compact (capacity,) planes of any fixed-width dtype by the plan into
    (out_capacity,) planes, one kernel launch per dtype; results in input
    order."""
    by_dtype: dict = {}
    for i, p in enumerate(planes):
        by_dtype.setdefault(p.dtype, []).append(i)
    out: List[Optional[torch.Tensor]] = [None] * len(planes)
    keep, offs, rows = plan.keep, plan.offs, plan.out_capacity
    for dt, idx in by_dtype.items():
        group = [planes[i] for i in idx]
        if dt.itemsize == 1:
            res, _ = k2.compact_planes_info(group, keep, offs, rows)
        elif dt.itemsize == 2:
            wide = [p.to(torch.int32) for p in group]
            res = [r.to(dt) for r in k1.compact_planes(wide, keep, offs, rows)]
        else:
            res = k1.compact_planes(group, keep, offs, rows)
        for i, r in zip(idx, res):
            out[i] = r
    return out


def _validity_plane(c: col.Column, plan: FilterPlan):
    if c.validity is None or c.validity is plan.folded_validity:
        # no bitmap, or one the plan folded into keep: every kept row is
        # valid, so there is nothing to compact
        return None
    return bm.unpack(c.validity)


def _planes_of(c: col.Column, plan: FilterPlan):
    """-> (planes to compact, rebuild(compacted planes) -> column)."""
    if c.capacity != plan.capacity:
        raise st.ComputeError("filter: capacity mismatch")
    n = plan.count
    if isinstance(c, col.NullColumn):
        return [], lambda outs: col.NullColumn(n, plan.out_capacity, c.device)
    if isinstance(c, col.DictionaryColumn):  # the keys; values are shared
        planes, rebuild = _planes_of(c.keys, plan)
        return planes, lambda outs: dataclasses.replace(c, keys=rebuild(outs))
    valid = _validity_plane(c, plan)
    extra = [] if valid is None else [valid]

    def validity(outs):
        return None if valid is None else bm.pack(outs[1])

    if isinstance(c, col.BooleanColumn):
        return [c.values_bool()] + extra, lambda outs: col.BooleanColumn(
            bm.pack(outs[0]), validity(outs), n)
    if isinstance(c, col.PrimitiveColumn):
        return [c.values] + extra, lambda outs: col.PrimitiveColumn(
            outs[0], validity(outs), n, c.dtype)
    raise st.ComputeError(f"filter: unsupported column {type(c).__name__}")


def _apply(columns, plan: FilterPlan) -> List[col.Column]:
    parts = [_planes_of(c, plan) for c in columns]
    flat = [p for planes, _ in parts for p in planes]
    outs = compact_planes(flat, plan)
    result, at = [], 0
    for planes, rebuild in parts:
        result.append(rebuild(outs[at:at + len(planes)]))
        at += len(planes)
    return result


def apply_plan(c: col.Column, plan: FilterPlan) -> col.Column:
    return _apply([c], plan)[0]


def filter_(c: col.Column, mask: col.BooleanColumn) -> col.Column:
    return apply_plan(c, build_plan(mask))


def filter_record_batch(batch: bt.RecordBatch,
                        mask: col.BooleanColumn) -> bt.RecordBatch:
    """One plan, all columns."""
    plan = build_plan(mask)
    return bt.RecordBatch(batch.schema, tuple(_apply(batch.columns, plan)))
