"""GROUP BY with SUM / COUNT / MIN / MAX / MEAN.

Counterpart of `arrowtpu/ops/groupby.py`, with its two engines behind one
API and the same choice between them on every input:

  * the dense-range engine (`_dense_group_by`) for a single integer key of
    at most 32 bits with integer value columns (`_dense_eligible`, the
    reference's rule: a key held in one plane there) whose live, valid
    keys span fewer than `DENSE_GROUPBY_BUCKETS - off` values (off is 1
    when the key has a validity bitmap: bucket 0 is then the null group).
    One hand-written kernel (kernels/dense_agg.py) gives every bucket's
    rows, count, sum, min and max in one pass; outputs are the present
    buckets in key order, the null group first with key value 0.
  * the sort pipeline (`_sort_group_by`) for every other schema and range.

`group_by` reads the key's min and max back once to choose, as the
reference's `_group_by_dispatch` does inside jit; `plan_group_by` probes
once and returns a `GroupByPlan` fixed to one engine (and to half or all of
the buckets), valid under the reference's contract: the same schema and
key ranges within the probed one.

The reference's u32-lane arithmetic has no counterpart here: the dense
engine's 8-bit chunk sums, biased 16-bit pieces and tile picks
(`_dense_agg_column`'s narrow and general branches, `_dense_pick_tile`,
`_chunk_bits`) and the sort pipeline's `narrow_sums` /
`_segment_sum_narrow` all compute a sum mod 2**64 out of 32-bit pieces.
The port sums in native int64, which wraps mod 2**64 and so gives the same
results; the plan carries nothing the TPU alone needs.

Sort pipeline:

  * Key columns encode to order-preserving planes (rowformat/encode.py:
    integers, booleans, floats by their total order, dictionaries by
    value rank, decimals by their limbs, fixed-size binary and string
    views by their bytes) and rows sort by them, live rows first, ties by
    row index (rowformat/pack.py).  So -0.0 and +0.0, and NaNs of other
    payloads, form groups of their own, as in the reference.
  * Value-ordered tie-break: when min/max aggregates exist, the first
    such column's planes (nulls LAST) ride as extra sort keys, so within a
    group values ascend: min is the group's first row, max its last valid
    row.  These planes do not split groups.
  * Group boundaries come from adjacent key-plane inequality; `is_last`
    marks each group's last row.
  * COUNT and integer SUM are differences of int64 prefix sums (exact mod
    2**64) taken at `is_last`; value columns without nulls share one
    count.  A float SUM is the reference's prefix difference: an f64
    cumsum read at each group's last row minus its value at the previous
    group's last row.  A decimal SUM is one int64 prefix sum per 32-bit
    limb (exact below 2**31 rows), differenced the same way, its carries
    then folded into N limbs mod 2**(32 N) (`_decimal_agg`; the
    reference's 8-bit chunk cumsums are the TPU's).
  * Per-group values are extracted by compacting sorted planes with the
    boundary / is_last masks through K1 (kernels/compact3.py): one call
    for everything read at group starts, one for everything read at group
    ends, one launch per word size (`_Extract`).  Floats move as their
    bits; a string key's views and a Decimal128's limbs as one 16-byte
    word a row.

Null keys form their own group (first: nulls sort first); null values are
skipped by every aggregate.  The output's length is the number of groups
(read back once), its capacity that number rounded up to the capacity
granule (the JAX package keeps the input capacity), and rows past the
length are zero.
Output dtypes follow the JAX package: count -> int64 without validity;
sum / min / max -> the column's dtype (narrow integer sums wrap; boolean
values aggregate as int32; a decimal sum keeps its limb count and scale at
the width's largest precision); mean -> float64 (a decimal's:
to_float(sum) / max(count, 1) / 10**scale); sum / min / max / mean are
null for a group with no valid value.  A string key's output shares its
input's arena.  String values raise under every aggregate, as in the
reference; temporal and interval columns are not ported as keys or
values yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from .. import config
from .. import schema as st
from ..config import SortOptions, round_up
from ..core import batch as bt
from ..core import bitmap as bm
from ..core import column as col
from ..core import limbs as lb
from ..kernels import compact3 as k1
from ..kernels import dense_agg as dk
from ..rowformat import encode as rf
from ..rowformat import pack as rp
from .take import gather_rows

AGGS = ("sum", "count", "min", "max", "mean")

# widened to int64 before any comparison or reduction (schema.py)
_WIDEN = (torch.uint16, torch.uint32)


class _Extract:
    """Planes to compact by one mask, gathered for as few K1 launches as
    their word sizes allow (one launch per word size): int64 planes
    (floats as their bits) and (n, W) int32 rows.  A row of one word is a
    4-byte word, of two an int64, of four one 16-byte word (a string view,
    a Decimal128), of eight two 16-byte words (a Decimal256)."""

    def __init__(self):
        self.planes: List[torch.Tensor] = []
        self.out: List[torch.Tensor] = []

    def add(self, plane: torch.Tensor):
        """-> a handle that reads the plane's compacted rows after run."""
        if plane.dim() == 1:
            return self._put([_bits(plane)]), None
        W = plane.shape[1]
        if W == 2:
            parts = [plane.contiguous().view(torch.int64).reshape(-1)]
        elif W == 8:
            parts = [plane[:, :4].contiguous(), plane[:, 4:].contiguous()]
        else:
            parts = [plane.contiguous()]
        return self._put(parts), W

    def _put(self, parts) -> range:
        first = len(self.planes)
        self.planes += parts
        return range(first, len(self.planes))

    def run(self, mask: torch.Tensor, rows: int) -> "_Extract":
        self.out = [None] * len(self.planes)
        by_word = {}
        for i, p in enumerate(self.planes):
            by_word.setdefault((p.dtype, tuple(p.shape[1:])), []).append(i)
        for ix in by_word.values():
            got = k1.compact_planes([self.planes[i] for i in ix], mask,
                                    out_rows=rows)
            for i, g in zip(ix, got):
                self.out[i] = g
        self.planes = []
        return self

    def __getitem__(self, handle) -> torch.Tensor:
        ix, W = handle
        parts = [self.out[i] for i in ix]
        if W is None:
            return parts[0]
        if W == 2:
            return parts[0].view(torch.int32).reshape(-1, 2)
        return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def _bits(v: torch.Tensor) -> torch.Tensor:
    """A plane as int64 words that K1 moves: integers widened, floats as
    their bits (float32 sign-extended)."""
    if v.dtype == torch.float64:
        return v.view(torch.int64)
    if v.dtype == torch.float32:
        return v.view(torch.int32).to(torch.int64)
    return v.to(torch.int64)


def _from_bits(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.float64:
        return w.view(torch.float64)
    if dtype == torch.float32:
        return w.to(torch.int32).view(torch.float32)
    return w.to(dtype)


def _order_key(v: torch.Tensor) -> torch.Tensor:
    """int64 whose signed order is the values' order (floats: total)."""
    return rf.float_key(v) if v.dtype.is_floating_point else v.to(torch.int64)


def _from_order_key(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of _order_key (float_key is its own inverse on the
    bits; a float32 key is sign-extended, so bit 63 is its sign too)."""
    if dtype.is_floating_point:
        low = 0x7FFFFFFFFFFFFFFF if dtype == torch.float64 else 0x7FFFFFFF
        return _from_bits(k ^ ((k >> 63) & low), dtype)
    return k.to(dtype)


def _is_int(c) -> bool:
    return isinstance(c, col.PrimitiveColumn) and isinstance(c.dtype, st.Int)


def _is_decimal(c) -> bool:
    return (isinstance(c, col.PrimitiveColumn)
            and st.decimal_limbs(c.dtype) is not None)


def _is_key(c) -> bool:
    """The JAX package's key columns (`_column_operands`), less its
    temporal and interval keys."""
    return (isinstance(c, (col.BooleanColumn, col.DictionaryColumn,
                           col.StringViewColumn))
            or _is_decimal(c) or (isinstance(c, col.PrimitiveColumn) and
                                  isinstance(c.dtype, (st.Int, st.Float,
                                                       st.FixedSizeBinary))))


def _is_value(c) -> bool:
    return (isinstance(c, col.BooleanColumn) or _is_decimal(c)
            or (isinstance(c, col.PrimitiveColumn)
                and isinstance(c.dtype, (st.Int, st.Float))))


def _check(batch, keys, aggs):
    if not keys:
        raise st.ComputeError("group by: no key columns")
    for k in keys:
        c = batch[k]
        if not _is_key(c):
            raise st.ComputeError(
                f"group by: key {k!r} of type {c.dtype} is not supported")
    for name, agg in aggs:
        if agg not in AGGS:
            raise st.ComputeError(f"unknown aggregate {agg!r}")
        c = batch[name]
        if not _is_value(c):
            raise st.ComputeError(
                f"aggregate on {name!r} of type {c.dtype} is not supported")


def _normalize(keys, aggs):
    return tuple(keys), tuple((str(n), str(a)) for n, a in aggs)


def group_by(batch: bt.RecordBatch, keys: Sequence[str],
             aggs: Sequence[Tuple[str, str]]) -> bt.RecordBatch:
    """aggs: [(column, agg)] with agg in AGGS.  Output columns: the keys,
    then '<agg>_<column>' per aggregate.  A dense-eligible schema reads
    its key range back once and takes the dense engine when the range
    fits the buckets, as the reference's dispatch does."""
    keys, aggs = _normalize(keys, aggs)
    _check(batch, keys, aggs)
    probe = _dense_probe(batch, keys, aggs)
    if probe is None:
        return _sort_group_by(batch, keys, aggs)
    return _dense_group_by(batch, keys, aggs, probe[0],
                           config.DENSE_GROUPBY_BUCKETS)


@dataclasses.dataclass(frozen=True)
class GroupByPlan:
    """A group-by fixed to one engine by `plan_group_by`'s probe: the dense
    engine at `buckets` buckets, or (buckets 0) the sort pipeline.  Each
    call recomputes the key's min on the device (no read-back); the dense
    engine reads back its group count once."""

    keys: Tuple[str, ...]
    aggs: Tuple[Tuple[str, str], ...]
    buckets: int

    @property
    def engine(self) -> str:
        return "dense" if self.buckets else "sort"

    def __call__(self, batch: bt.RecordBatch) -> bt.RecordBatch:
        _check(batch, self.keys, self.aggs)
        if not self.buckets:
            return _sort_group_by(batch, self.keys, self.aggs)
        kmin = _key_bounds(batch[self.keys[0]], with_max=False)[0]
        return _dense_group_by(batch, self.keys, self.aggs, kmin,
                               self.buckets)


def plan_group_by(batch: bt.RecordBatch, keys: Sequence[str],
                  aggs: Sequence[Tuple[str, str]]) -> GroupByPlan:
    """Probe the batch's key range once (one read-back) and fix the
    engine, as the reference's `plan_group_by` does: a dense-eligible
    schema whose range is under `DENSE_GROUPBY_BUCKETS - off` takes the
    dense engine, at half the buckets when the range is under half of them
    less `off`; every other input the sort pipeline.  The plan is valid for
    batches with the same schema whose key range lies within the probed
    one; `group_by` stays the per-call path."""
    keys, aggs = _normalize(keys, aggs)
    _check(batch, keys, aggs)
    probe = _dense_probe(batch, keys, aggs)
    if probe is None:
        return GroupByPlan(keys, aggs, 0)
    _, rng, off = probe
    half = max(config.DENSE_GROUPBY_BUCKETS // 2, 2)
    return GroupByPlan(keys, aggs, half if rng < half - off
                       else config.DENSE_GROUPBY_BUCKETS)


# ---------------------------------------------------------------------------
# the dense-range engine
# ---------------------------------------------------------------------------


def _dense_eligible(batch, keys, aggs) -> bool:
    """The reference's rule (`_dense_eligible`): one integer key held in
    one plane there (at most 32 bits; its int64 is a limb pair) and
    integer value columns of any width."""
    if len(keys) != 1:
        return False
    kc = batch[keys[0]]
    if not (_is_int(kc) and kc.dtype.bits <= 32):
        return False
    return all(a in AGGS and _is_int(batch[n]) for n, a in aggs)


def _dense_probe(batch, keys, aggs):
    """The reference's dispatch: for a dense-eligible schema whose key
    range (one read-back) is under DENSE_GROUPBY_BUCKETS - off, (the key's
    min as a 0-d device tensor, max - min, off); else None (the sort
    pipeline).  No valid key gives a negative range: the dense engine."""
    if not _dense_eligible(batch, keys, aggs):
        return None
    kc = batch[keys[0]]
    lo, hi = _key_bounds(kc)
    kmin, kmax = torch.stack([lo, hi]).tolist()
    off = _off(kc)
    if kmax - kmin >= config.DENSE_GROUPBY_BUCKETS - off:
        return None
    return lo, kmax - kmin, off


def _off(kc) -> int:
    """1 when the key has a validity bitmap (bucket 0 is the null group)."""
    return 0 if kc.validity is None else 1


def _key_bounds(kc: col.PrimitiveColumn, with_max: bool = True):
    """0-d int64 min (and max) of the live, valid keys, left on the device;
    with none, the dtype's max (and min), as the reference's probe gives
    them."""
    kv = kc.values
    info = torch.iinfo(kv.dtype)
    if kv.dtype in _WIDEN:
        kv = kv.to(torch.int64)
    if kc.validity is None:
        kv = kv[:kc.length]
        if kc.length == 0:
            bounds = [torch.tensor(info.max, device=kv.device),
                      torch.tensor(info.min, device=kv.device)]
        else:
            bounds = list(torch.aminmax(kv)) if with_max else [kv.amin()]
    else:
        valid = kc.valid_bool()
        bounds = [torch.where(valid, kv, info.max).amin()]
        if with_max:
            bounds.append(torch.where(valid, kv, info.min).amax())
    return [b.to(torch.int64) for b in bounds[:1 + with_max]]


def _dense_group_by(batch, keys, aggs, kmin: torch.Tensor,
                    nb: int) -> bt.RecordBatch:
    """The dense engine: every bucket's aggregates from one kernel, then
    the present buckets placed in key order (`_place`)."""
    kc = batch[keys[0]]
    off = _off(kc)
    names = sorted({name for name, _ in aggs})
    rows, stats = dk.dense_aggregate(
        kc.values, kc.validity, kmin, off, nb, batch.length,
        [(batch[n].values, batch[n].validity) for n in names])
    present = rows > 0
    groups = int(present.sum())
    out_cap = round_up(max(groups, 1))
    # the present buckets in bucket (= key) order
    sel = torch.sort((~present).to(torch.uint8), stable=True).indices[:groups]

    def place(values, dtype):
        out = torch.zeros(out_cap, dtype=dtype, device=values.device)
        out[:groups] = values[sel].to(dtype)
        return out

    def place_valid(bools):
        return bm.pack(place(bools, torch.bool))

    ids = torch.arange(nb, device=rows.device)
    kvals = kmin + ids - off
    key_validity = None
    if off:
        kvals = torch.where(ids == 0, 0, kvals)
        key_validity = place_valid(ids != 0)
    fields = [st.Field(keys[0], kc.dtype)]
    cols = [col.PrimitiveColumn(place(kvals, kc.values.dtype), key_validity,
                                groups, kc.dtype)]
    for name, agg in aggs:
        c = batch[name]
        cnt, total, lo, hi = stats[names.index(name)]
        has = cnt > 0
        if agg == "count":
            out = col.PrimitiveColumn(place(cnt, torch.int64), None, groups,
                                      st.int64)
        elif agg == "mean":
            mean = total.to(torch.float64) / cnt.clamp(min=1).to(
                torch.float64)
            out = col.PrimitiveColumn(place(mean, torch.float64),
                                      place_valid(has), groups, st.float64)
        else:
            best = {"sum": total, "min": torch.where(has, lo, 0),
                    "max": torch.where(has, hi, 0)}[agg]
            out = col.PrimitiveColumn(place(best, c.values.dtype),
                                      place_valid(has), groups, c.dtype)
        fields.append(st.Field(f"{agg}_{name}", out.dtype))
        cols.append(out)
    return bt.RecordBatch(st.Schema(tuple(fields)), tuple(cols))


# ---------------------------------------------------------------------------
# the sort pipeline
# ---------------------------------------------------------------------------


def _shift_down(t: torch.Tensor, fill) -> torch.Tensor:
    """t[i-1] at i, `fill` at 0."""
    return torch.cat([torch.full((1,), fill, dtype=t.dtype, device=t.device),
                      t[:-1]])


def _shift_up(t: torch.Tensor, fill) -> torch.Tensor:
    """t[i+1] at i, `fill` at the end."""
    return torch.cat([t[1:], torch.full((1,), fill, dtype=t.dtype,
                                        device=t.device)])


def _value_rows(c) -> torch.Tensor:
    """A value column's per-row values: booleans as int32, as the
    reference aggregates them (`_segment_agg_narrow`); uint16 / uint32
    widened to int64 (torch cannot index them on the card)."""
    if isinstance(c, col.BooleanColumn):
        return c.values_bool().to(torch.int32)
    return c.values.to(torch.int64) if c.values.dtype in _WIDEN else c.values


def _out_dtype(c) -> torch.dtype:
    """The torch dtype of a value column's sum, min and max."""
    return torch.int32 if isinstance(c, col.BooleanColumn) else c.values.dtype


def _key_rows(c) -> torch.Tensor:
    """What a key column's output is rebuilt from: its values (a
    dictionary's keys into its values, a string's views), widened as in
    _value_rows."""
    if isinstance(c, col.BooleanColumn):
        return c.values_bool()
    if isinstance(c, col.DictionaryColumn):
        return c.keys.values
    if isinstance(c, col.StringViewColumn):
        return c.views
    return _value_rows(c)


def _rebuild_key(c, at, validity, groups):
    if isinstance(c, col.BooleanColumn):
        return col.BooleanColumn(bm.pack(at != 0), validity, groups)
    if isinstance(c, col.DictionaryColumn):
        keys = col.PrimitiveColumn(at.to(c.keys.values.dtype), validity,
                                   groups, c.keys.dtype)
        return col.DictionaryColumn(keys, c.values, c.value_ranks, c.dtype)
    if isinstance(c, col.StringViewColumn):  # the arena is shared
        return col.StringViewColumn(at, c.arena, validity, groups, c.dtype,
                                    c.len_bound)
    if at.dim() == 2:
        return col.PrimitiveColumn(at, validity, groups, c.dtype)
    return col.PrimitiveColumn(_from_bits(at, c.values.dtype), validity,
                               groups, c.dtype)


def _sort_group_by(batch, keys, aggs) -> bt.RecordBatch:
    key_cols = [batch[k] for k in keys]
    cap, length = batch.capacity, batch.length
    device = key_cols[0].device

    key_planes, split_planes = [], []
    for c in key_cols:
        planes = rf.encode_column(c)
        key_planes += planes
        # the sentinel of a key without nulls is 1 on every live row
        split_planes += planes[1:] if c.validity is None else planes
    minmax = [nm for nm, a in aggs if a in ("min", "max")]
    vo_name = minmax[0] if minmax else None
    vo_planes = (rf.encode_column(batch[vo_name], SortOptions(nulls_first=False))
                 if vo_name else [])
    perm = rp.sort_permutation(key_planes + vo_planes, cap, length)
    del key_planes, vo_planes

    iota = torch.arange(cap, device=device)
    live = iota < length
    boundary = torch.zeros(cap, dtype=torch.bool, device=device)
    for p in split_planes:  # key planes only: value planes must not split
        sp = p[perm]
        boundary |= sp != _shift_down(sp, 0)
    del split_planes
    boundary[0] = True
    boundary &= live
    num_groups = int(boundary.sum())
    out_cap = round_up(max(num_groups, 1))
    next_b = _shift_up(boundary, True)
    is_last = (next_b | (iota == length - 1)) & live
    glive = iota[:out_cap] < num_groups

    starts, lasts = _Extract(), _Extract()
    key_ix = []
    for c in key_cols:
        vals = gather_rows(_key_rows(c), perm)
        valid = c.valid_bool()[perm] if c.validity is not None else None
        key_ix.append((starts.add(vals),
                       None if valid is None else starts.add(valid)))

    # per value column: its sorted validity and values; a column without
    # nulls is valid on exactly the live rows, which sort first, so all
    # such columns share one count
    sorted_ok, sorted_vals, cnt_ix, sum_ix = {}, {}, {}, {}
    top_ix = None  # each group's last sorted row, for float sums
    float_cs = {}
    for name, agg in aggs:
        c = batch[name]
        if name not in sorted_ok:
            sorted_ok[name] = (live if c.validity is None
                               else c.valid_bool()[perm])
            sorted_vals[name] = gather_rows(_value_rows(c), perm)
            cnt_key = name if c.validity is not None else None
            if cnt_key not in cnt_ix:
                cnt_ix[cnt_key] = lasts.add(sorted_ok[name].cumsum(0))
        ok, v = sorted_ok[name], sorted_vals[name]
        if agg not in ("sum", "mean") or name in sum_ix:
            continue
        if v.dim() == 2:  # decimal limbs: int64 prefix sums of each limb
            sum_ix[name] = [lasts.add(torch.where(
                ok, lb.unsigned(v[:, j]), 0).cumsum(0))
                for j in range(v.shape[1])]
        elif v.dtype.is_floating_point:
            float_cs[name] = torch.where(ok, v.to(torch.float64),
                                         0.0).cumsum(0)
            if top_ix is None:
                top_ix = lasts.add(iota)
            sum_ix[name] = None
        else:
            vz = torch.where(ok, v.to(torch.int64), 0)
            sum_ix[name] = lasts.add(vz.cumsum(0))

    # value-ordered column: min is the group's first row
    vo_min = (starts.add(sorted_vals[vo_name]) if (vo_name, "min") in aggs
              else None)
    vo_max = None
    if (vo_name, "max") in aggs:
        # one row per group: its last VALID row (values ascend, nulls
        # last), or, for an all-null group, its first row
        ok = sorted_ok[vo_name]
        vo_max_mask = (ok & (next_b | ~_shift_up(ok, False))) | (boundary & ~ok)
        vo_max = _Extract()
        vo_max_h = vo_max.add(sorted_vals[vo_name])
        vo_max.run(vo_max_mask, out_cap)

    starts.run(boundary, out_cap)
    lasts.run(is_last, out_cap)

    def group_sums(h):
        tops = lasts[h]
        return torch.where(glive, tops - _shift_down(tops, 0), 0)

    def float_sums(name):
        # the reference's prefix difference, cs[last_g] - cs[last_{g-1}]
        # (rows past the groups read row 0 and are zeroed after)
        cs, top = float_cs[name], lasts[top_ix]
        prev = torch.where(iota[:out_cap] == 0, 0.0,
                           cs[_shift_down(top, 0)])
        return torch.where(glive, cs[top] - prev, 0.0)

    fields, cols = [], []
    for k, c, (vi, oi) in zip(keys, key_cols, key_ix):
        validity = None if oi is None else bm.pack(starts[oi] != 0)
        fields.append(st.Field(k, c.dtype))
        cols.append(_rebuild_key(c, starts[vi], validity, num_groups))

    counts = {key: group_sums(h) for key, h in cnt_ix.items()}
    for name, agg in aggs:
        c = batch[name]
        cnt = counts[name if c.validity is not None else None]
        vo_rows = None  # the value-ordered column's min / max rows
        if name == vo_name and agg in ("min", "max"):
            vo_rows = starts[vo_min] if agg == "min" else vo_max[vo_max_h]
        if agg == "count":
            out = col.PrimitiveColumn(cnt, None, num_groups, st.int64)
        elif _is_decimal(c):
            out = _decimal_agg(c, agg, cnt, group_sums, sum_ix.get(name),
                               sorted_ok[name], sorted_vals[name], boundary,
                               out_cap, num_groups, vo_rows)
        else:
            out = _native_agg(c, agg, cnt, sorted_ok[name],
                              sorted_vals[name], boundary, out_cap,
                              num_groups, vo_rows,
                              lambda: (float_sums(name)
                                       if name in float_cs
                                       else group_sums(sum_ix[name])))
        fields.append(st.Field(f"{agg}_{name}", out.dtype))
        cols.append(out)
    return bt.RecordBatch(st.Schema(tuple(fields)), tuple(cols))


def _native_agg(c, agg, cnt, ok, vals, boundary, out_cap, num_groups,
                vo_rows, sums) -> col.PrimitiveColumn:
    """sum / mean / min / max of an integer, float or boolean column: the
    sum from `sums()` (the prefix differences), min and max the value-
    ordered column's rows (`vo_rows`) or a segmented extreme."""
    vdt, odt = vals.dtype, _out_dtype(c)
    out_dt = st.int32 if isinstance(c, col.BooleanColumn) else c.dtype
    has = cnt > 0
    has_v = bm.pack(has)
    if agg in ("sum", "mean"):
        s = sums()
        if agg == "sum":
            return col.PrimitiveColumn(s.to(odt), has_v, num_groups, out_dt)
        mean = s.to(torch.float64) / cnt.clamp(min=1).to(torch.float64)
        return col.PrimitiveColumn(mean, has_v, num_groups, st.float64)
    if vo_rows is not None:
        best = _from_bits(vo_rows, vdt)
    else:
        best = _from_order_key(_segment_extreme(
            boundary, ok, [_order_key(vals)], agg, out_cap)[0], vdt)
    best = torch.where(has, best, 0).to(odt)
    return col.PrimitiveColumn(best, has_v, num_groups, out_dt)


def _decimal_agg(c, agg, cnt, group_sums, sum_hs, ok, limbs, boundary,
                 out_cap, num_groups, vo_best) -> col.PrimitiveColumn:
    """A decimal column's aggregate (the reference's
    `_segment_agg_decimal`): the sum keeps the limb count and the scale at
    the width's largest precision, carried out of the limbs' int64 group
    sums mod 2**(32 N); the mean is float64, to_float(sum) / max(count, 1)
    / 10**scale in that order; min and max are limb rows, of the value-
    ordered column (`vo_best`, already extracted) or, for another column,
    the lexicographic extreme of its order planes in each group."""
    nl = st.decimal_limbs(c.dtype)
    has = cnt > 0
    has_v = bm.pack(has)
    if agg in ("sum", "mean"):
        out, carry = [], 0
        for h in sum_hs:
            t = group_sums(h) + carry
            out.append(t & 0xFFFFFFFF)
            carry = t >> 32
        s = lb.stack_u32(out)
        if agg == "mean":
            mean = lb.to_float(s) / cnt.clamp(min=1).to(torch.float64)
            return col.PrimitiveColumn(lb.over_pow10(mean, c.dtype.scale),
                                       has_v, num_groups, st.float64)
        return col.PrimitiveColumn(
            s, has_v, num_groups, st.decimal_for_limbs(
                nl, st.MAX_DECIMAL_PRECISION[nl], c.dtype.scale))
    if vo_best is None:
        vo_best = lb.from_order_planes(_segment_extreme(
            boundary, ok, lb.order_planes(limbs), agg, out_cap))
    best = torch.where(has[:, None], vo_best, 0)
    return col.PrimitiveColumn(best, has_v, num_groups, c.dtype)


def _segment_extreme(boundary, ok, planes, agg, rows) -> List[torch.Tensor]:
    """Per-group lexicographic min/max of int64 planes (most significant
    first) over the valid rows of a column that is not the value-ordered
    one (groups are contiguous in sorted order): a segmented reduction of
    each plane in turn over the rows still tied on the planes before it.
    A group with no valid row gets the int64 extreme (the callers zero
    it)."""
    big = torch.iinfo(torch.int64)
    ident = big.max if agg == "min" else big.min
    gid = boundary.cumsum(0) - 1
    cand = ok
    best = []
    for p in planes:
        out = torch.full((rows,), ident, dtype=torch.int64, device=p.device)
        out = out.scatter_reduce(0, gid[cand], p[cand],
                                 "amin" if agg == "min" else "amax")
        best.append(out)
        cand = cand & (p == out[gid.clamp(max=rows - 1)])
    return best
