"""Filter: masked compaction of columns and record batches.

Counterpart of `arrowtpu/ops/filter.py`.  A `FilterPlan` is built once per
mask (a null predicate row selects nothing) and applied to any number of
columns.  Every plane moves through a hand-written CUDA kernel on the card,
grouped by its word size, so that one launch serves all planes of a size:

  * 4-, 8- and 16-byte words -> K1, kernels/compact3.py: int32 / float32 /
    Date32 values and dictionary keys as 4-byte words, int64 / float64 /
    temporal values and (n, 2) int32 rows (Decimal64, interval day_time)
    as 8-byte words, and (n, 4) int32 rows (Decimal128, interval
    month_day_nano, string views) as one 16-byte word a row, with no
    transpose;
  * byte planes (bool values, validity, int8 / uint8) -> K2 in u8 mode,
    kernels/compact.py;
  * 2-byte planes widen to 4 bytes for K1 and narrow back;
  * wider rows: a Decimal256 (or any row of a multiple of 4 words) is
    that many 16-byte words under the keep mask repeated per row (the form
    the JAX package gives a fixed-size list's child); a fixed-size binary
    of another width goes through one 4-byte plane per word, transposed
    in and out (the slow form).

A whole batch thus costs one launch per word size, where the JAX package
launches per column.  The tile offsets of the keep mask are computed once,
in `build_plan`, and shared by every launch; a repeated mask (a
fixed-size list's child, a wide row) gets its own, once.

Nested columns: a list view compacts its (start, size) pairs and shares
its child; a struct compacts each child and its own validity in the same
grouped launches; a fixed-size list compacts its child under the mask
repeated `size` times.  Run-end and union columns raise, as in the JAX
package.  A string view's arena never moves: it is shared untouched.

Output columns have length = the plan's count, read back once when the
plan is built, and the port's own capacity: that count rounded up to the
capacity granule (the JAX package keeps the input capacity).  So the
kernels write only the kept rows and a short zero tail, and everything
downstream of a selective filter works on the kept rows alone.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from .. import schema as st
from ..config import round_up
from ..core import batch as bt
from ..core import bitmap as bm
from ..core import column as col
from ..kernels import _build
from ..kernels import compact as k2
from ..kernels import compact3 as k1


@dataclasses.dataclass(frozen=True)
class FilterPlan:
    """A selection computed once.

    `folded_validity` is the mask's validity bitmap, which `build_plan`
    ANDed into `keep`: a column whose validity IS that object has every
    kept row valid, so its output needs no bitmap and its validity plane
    is not compacted at all.  `rows` overrides the output capacity (a
    repeated plan's is its parent's times the repeat)."""

    keep: torch.Tensor  # (capacity,) bool
    count: int
    offs: torch.Tensor  # tile offsets of keep (kernels/_build.tile_offsets)
    folded_validity: Optional[torch.Tensor] = None
    rows: Optional[int] = None
    _repeats: Dict[int, "FilterPlan"] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    @property
    def capacity(self) -> int:
        return self.keep.shape[0]

    @property
    def out_capacity(self) -> int:
        return round_up(max(self.count, 1)) if self.rows is None else self.rows

    def repeated(self, r: int) -> "FilterPlan":
        """The plan of each row's keep repeated r times (r rows a row), its
        output capacity r times this one's; made once per r."""
        if r == 1:
            return self
        if r not in self._repeats:
            keep = self.keep.repeat_interleave(r)
            self._repeats[r] = FilterPlan(keep, self.count * r,
                                          k1.tile_offsets(keep), None,
                                          self.out_capacity * r)
        return self._repeats[r]


def build_plan(mask: col.BooleanColumn) -> FilterPlan:
    if not isinstance(mask, col.BooleanColumn):
        raise st.ComputeError("filter mask must be a BooleanColumn")
    keep_bits = mask.values
    if mask.validity is not None:
        keep_bits = keep_bits & mask.validity  # null predicate -> false
    keep = bm.unpack(bm.clip(keep_bits, mask.length))
    offs = k1.tile_offsets(keep)
    return FilterPlan(keep, int(offs[-1]), offs, mask.validity)


# ---------------------------------------------------------------------------
# planes: each as a word of one size, moved by one launch per size and plan
# ---------------------------------------------------------------------------

_WORD_VIEW = {4: torch.int32, 8: torch.int64}


def _word_of(p: torch.Tensor):
    """A (n,) or (n, k) plane as the kernels' word: -> (word bytes, the
    plane viewed as (n,) words of that size, or (n, 4) int32 for 16; a
    2-byte word rides as 4)."""
    w = _build.word_bytes(p)
    if w == 2:  # no 2-byte kernel: the bits widened to a 4-byte word
        return 4, p.contiguous().view(torch.int16).reshape(
            p.shape[0]).to(torch.int32)
    if w == 16:
        return w, p.view(torch.int32).reshape(p.shape[0], 4)
    if w == 1:
        return w, p.view(torch.uint8).reshape(p.shape[0])
    return w, p.contiguous().view(_WORD_VIEW[w]).reshape(p.shape[0])


def _unword(out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A compacted word plane back in `like`'s dtype and row shape."""
    if _build.word_bytes(like) == 2:
        out = out.to(torch.int16)
    return out.view(like.dtype).reshape((out.shape[0],) + tuple(like.shape[1:]))


def compact_planes(planes: List[torch.Tensor], plan: FilterPlan
                   ) -> List[torch.Tensor]:
    """Compact (capacity,) or (capacity, k) planes of any fixed width by the
    plan into out_capacity-row planes, one kernel launch per word size;
    results in input order."""
    return _compact([(p, plan) for p in planes])


def _compact(items) -> List[torch.Tensor]:
    """[(plane, plan)] -> compacted planes in input order: planes of one
    plan and one word size share a launch."""
    groups: dict = {}
    out: List[Optional[torch.Tensor]] = [None] * len(items)
    for i, (p, plan) in enumerate(items):
        word, plane = _word_of(p)
        groups.setdefault((id(plan), word), (plan, []))[1].append((i, plane))
    for (_, word), (plan, members) in groups.items():
        keep, offs, rows = plan.keep, plan.offs, plan.out_capacity
        group = [plane for _, plane in members]
        if word == 1:
            res, _ = k2.compact_planes_info(group, keep, offs, rows)
        else:
            res = k1.compact_planes(group, keep, offs, rows)
        for (i, _), r in zip(members, res):
            out[i] = _unword(r, items[i][0])
    return out


def _row_planes(values: torch.Tensor, plan: FilterPlan):
    """A (capacity, W) int32 value -> ([(plane, plan)], rebuild(outs) ->
    compacted values): one plane of W words for W in {1, 2, 4}; W a
    multiple of 4 -> W / 4 16-byte words a row under the plan repeated;
    otherwise W 4-byte planes, transposed in and out (the slow form)."""
    cap, w = values.shape
    if w in (1, 2, 4):
        return [(values, plan)], lambda outs: outs[0]
    if w % 4 == 0:
        r = w // 4
        sub = plan.repeated(r)
        return ([(values.reshape(cap * r, 4), sub)],
                lambda outs: outs[0].reshape(-1, w))
    cols = list(values.t().contiguous())
    return ([(c, plan) for c in cols],
            lambda outs: torch.stack(outs, dim=1))


def _validity_plane(c: col.Column, plan: FilterPlan):
    if c.validity is None or c.validity is plan.folded_validity:
        # no bitmap, or one the plan folded into keep: every kept row is
        # valid, so there is nothing to compact
        return None
    return bm.unpack(c.validity)


def _planes_of(c: col.Column, plan: FilterPlan):
    """-> ([(plane, plan)] to compact, rebuild(compacted planes) ->
    column)."""
    if c.capacity != plan.capacity:
        raise st.ComputeError("filter: capacity mismatch")
    n = plan.count
    if isinstance(c, col.NullColumn):
        return [], lambda outs: col.NullColumn(n, plan.out_capacity, c.device)
    if isinstance(c, col.DictionaryColumn):  # the keys; values are shared
        items, rebuild = _planes_of(c.keys, plan)
        return items, lambda outs: dataclasses.replace(c, keys=rebuild(outs))
    if isinstance(c, (col.RunEndColumn, col.UnionColumn)):
        raise st.ComputeError(f"filter: unsupported column {type(c).__name__}")
    valid = _validity_plane(c, plan)
    extra = [] if valid is None else [(valid, plan)]

    def validity(outs):
        return None if valid is None else bm.pack(outs[-1])

    if isinstance(c, col.BooleanColumn):
        return [(c.values_bool(), plan)] + extra, lambda outs: \
            col.BooleanColumn(bm.pack(outs[0]), validity(outs), n)
    if isinstance(c, col.StringViewColumn):
        # the views compacted as 16-byte words; the arena shared untouched
        return [(c.views, plan)] + extra, lambda outs: col.StringViewColumn(
            outs[0], c.arena, validity(outs), n, c.dtype, c.len_bound)
    if isinstance(c, col.PrimitiveColumn):
        if c.values.dim() == 2:
            items, rows = _row_planes(c.values, plan)
            k = len(items)
            return items + extra, lambda outs: col.PrimitiveColumn(
                rows(outs[:k]), validity(outs), n, c.dtype)
        return [(c.values, plan)] + extra, lambda outs: col.PrimitiveColumn(
            outs[0], validity(outs), n, c.dtype)
    if isinstance(c, col.ListViewColumn):
        # the (start, size) pairs; the child is shared
        return ([(c.starts, plan), (c.sizes, plan)] + extra,
                lambda outs: col.ListViewColumn(outs[0], outs[1], c.child,
                                                validity(outs), n, c.dtype))
    if isinstance(c, col.StructColumn):
        parts = [_planes_of(ch, plan) for ch in c.children]
        items = [it for its, _ in parts for it in its]

        def rebuild_struct(outs):
            children, at = [], 0
            for its, rebuild in parts:
                children.append(rebuild(outs[at:at + len(its)]))
                at += len(its)
            return col.StructColumn(tuple(children), validity(outs), n,
                                    c.dtype)
        return items + extra, rebuild_struct
    if isinstance(c, col.FixedSizeListColumn):
        # the child under the mask repeated `size` times
        items, rebuild = _planes_of(c.child, plan.repeated(c.dtype.size))
        k = len(items)
        return items + extra, lambda outs: col.FixedSizeListColumn(
            rebuild(outs[:k]), validity(outs), n, c.dtype)
    raise st.ComputeError(f"filter: unsupported column {type(c).__name__}")


def _apply(columns, plan: FilterPlan) -> List[col.Column]:
    parts = [_planes_of(c, plan) for c in columns]
    flat = [it for items, _ in parts for it in items]
    outs = _compact(flat)
    result, at = [], 0
    for items, rebuild in parts:
        result.append(rebuild(outs[at:at + len(items)]))
        at += len(items)
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
