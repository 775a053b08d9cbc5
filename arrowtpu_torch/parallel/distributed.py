"""Distributed operators: hash join and group-by over a process group.

Counterpart of `arrowtpu/parallel/distributed.py`, called by every rank
of the group with its own shard:

  distributed_hash_join = exchange(right) + exchange(left) + local join
  distributed_group_by  = local partial aggregation + exchange(partials
                          by key) + final re-aggregation (sum of sums,
                          sum of counts, min of mins, max of maxes; mean
                          as sum and count, divided after the merge)

Skew (BASELINE config 5's skewed-key join, `skew_threshold`): a global
histogram of the probe keys over 4096 hashed buckets (one all_reduce)
marks the buckets that hold more than the threshold's share of all probe
rows.  Rows of hot buckets, on both sides, leave the exchange: their build
rows are replicated to every rank (one all_gather a plane) and their probe
rows join where they are, so a Zipf head does not flood one rank.  The
cold rows take the normal exchange.  Both sides are split by the filter
(`_filter_bool`: K1 for the word planes, K2 for the byte planes).

Chunked probes (`probe_chunks`): the build side is exchanged and its table
built once; the probe side is cut into row chunks, each exchanged, probed
and joined in turn on one stream (no chunk's exchange overlaps another's
probe), and the outputs are concatenated.  A chunk is a view of the
batch's rows (no copy).  Chunks cut at the port's capacity: where it
differs from the JAX package's, so do the chunks, and a rank's output
holds the same rows in another order.

Keys and columns of every class the exchange carries (parallel/shuffle.py:
integers, floats, booleans, temporal types, decimals, intervals,
fixed-size binary, dictionaries, string views) take every path: a string
key is encoded at one width on both sides and every rank (`_key_widths`:
one all_reduce(MAX) a join), so a string hashes to one rank and one skew
bucket whatever side or rank holds it; the replicated hot build rows
carry string views with their arenas (offsets rebased by rank) and
multi-word values; a chunk of a string view shares its arena.  A
dictionary key needs one dictionary on both sides (`ops/join.check_dictionaries`).

Output column names are the JAX package's (`sum_rv`, `count_rv`, ...).
As in `ops/join.py`, a local join without `out_capacity` holds every
match, so `overflow` is set only when `out_capacity` cuts an output or
when the hot build rows exceed `hot_capacity`.  A `mean` of a decimal
column raises ComputeError (the JAX package's mean raises on every
input).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import schema as st
from ..config import round_up
from ..core import batch as bt
from ..core import bitmap as bm
from ..core import column as col
from ..core import u64
from ..ops import groupby as gb
from ..ops import join as jn
from ..ops.concat import concat_batches
from ..ops.filter import filter_record_batch
from ..ops.strings import byte_bound, matrix_width
from ..ops.take import take_record_batch
from ..rowformat import encode as rf
from ..rowformat import hashing as hsh
from . import shuffle
from .mesh import Group

_HOT_SEED = 0x517E  # the JAX package's skew-histogram hash seed
HOT_BUCKETS = 4096


def default_hot_capacity(right: bt.RecordBatch) -> int:
    """The hot build rows a rank may replicate unless `hot_capacity` is
    given: a quarter of the build capacity, at least 128 rows."""
    return round_up(max(right.capacity // 4, 128))


def _shrink(batch: bt.RecordBatch, new_cap: int) -> bt.RecordBatch:
    """The first `new_cap` rows of a front-packed batch (take of an
    arange); the capacity is new_cap rounded up to the granule."""
    if new_cap >= batch.capacity:
        return batch
    idx = col.PrimitiveColumn(
        torch.arange(round_up(new_cap), dtype=torch.int32,
                     device=batch.device),
        None, min(batch.length, new_cap), st.int32)
    return take_record_batch(batch, idx)


def _filter_bool(batch: bt.RecordBatch, keep: torch.Tensor
                 ) -> bt.RecordBatch:
    """The live rows of `batch` where the (capacity,) bool `keep` is set:
    one filter plan for every column (on the card one K1 launch for the
    word planes and one K2 launch for the byte planes)."""
    live = bm.row_mask_bool(batch.capacity, batch.length, batch.device)
    mask = col.BooleanColumn(bm.pack(keep & live), None, batch.length)
    return filter_record_batch(batch, mask)


def _replicate(batch: bt.RecordBatch, group: Group) -> bt.RecordBatch:
    """Every rank's rows on every rank, in rank order: each rank's planes
    padded to the ranks' largest capacity and gathered, one all_gather a
    plane (a multi-word value as (n, W) rows).  A string view gathers its
    views and its arena, padded to the ranks' largest arena, and an arena
    string's offset moves by its rank times that arena; its `len_bound` is
    the ranks' largest.  The capacities, arenas and string bounds are one
    all_reduce(MAX) and one read-back.  Dead and padding rows become null
    rows (harmless on a build side: a null key never matches); the length
    is the whole gathered capacity."""
    views = [c for c in batch.columns if isinstance(c, col.StringViewColumn)]
    sizes = torch.stack(
        [torch.tensor(batch.capacity, device=batch.device)]
        + [torch.tensor(c.arena.shape[0], device=batch.device)
           for c in views] + [byte_bound(c) for c in views]).to(torch.int64)
    dist.all_reduce(sizes, op=dist.ReduceOp.MAX)
    cap, *rest = sizes.tolist()  # read-back
    strings = iter(zip(rest[:len(views)], rest[len(views):]))
    n = group.world_size
    total = cap * n

    def gather(plane: torch.Tensor, rows: int) -> torch.Tensor:
        if plane.dtype == torch.bool:
            return gather(plane.to(torch.uint8), rows) != 0
        padded = torch.zeros((rows,) + plane.shape[1:], dtype=plane.dtype,
                             device=plane.device)
        padded[:plane.shape[0]] = plane
        out = torch.empty((rows * n,) + plane.shape[1:], dtype=plane.dtype,
                          device=plane.device)
        dist.all_gather_into_tensor(out, padded)
        return out

    cols = []
    for c in batch.columns:
        ok = bm.pack(gather(c.valid_bool(), cap))
        if isinstance(c, col.PrimitiveColumn):
            cols.append(col.PrimitiveColumn(gather(c.values, cap), ok, total,
                                            c.dtype))
        elif isinstance(c, col.BooleanColumn):
            cols.append(col.BooleanColumn(
                bm.pack(gather(c.values_bool(), cap)), ok, total))
        elif isinstance(c, col.StringViewColumn):
            arena_cap, bound = next(strings)
            v = gather(c.views, cap)
            rank = torch.arange(total, device=v.device) // cap
            shift = torch.where(v[:, 0] > 12, rank * arena_cap, 0)
            v[:, 3] = ((v[:, 3].to(torch.int64) & 0xFFFFFFFF) + shift).to(
                torch.int32)
            cols.append(col.StringViewColumn(
                v, gather(c.arena, arena_cap), ok, total, c.dtype, bound))
        else:
            raise st.ComputeError(
                f"replicate: unsupported column {type(c).__name__}")
    return bt.RecordBatch(batch.schema, tuple(cols))


def _key_widths(left: bt.RecordBatch, right: bt.RecordBatch,
                on: Sequence[str]) -> List[Optional[int]]:
    """Per key: the byte-matrix width a string key is encoded at on both
    sides and every rank, from the longest string of either side on any
    rank (one all_reduce(MAX) and one read-back when a key is a string);
    else None.  Checks dictionary keys (`ops/join.check_dictionaries`)."""
    lcols, rcols = [left[k] for k in on], [right[k] for k in on]
    jn.check_dictionaries(lcols, rcols)
    bounds = shuffle.shared_bounds(lcols + rcols)
    n = len(on)
    return [None if bounds[i] is None else
            matrix_width(max(bounds[i], bounds[n + i])) for i in range(n)]


def _hot_buckets_of(batch: bt.RecordBatch, on: Sequence[str],
                    num_buckets: int, widths=None) -> torch.Tensor:
    """(capacity,) int64 skew bucket of each row's key."""
    planes = rf.hash_planes_of([batch[k] for k in on], widths)
    return hsh.hash_planes(planes, seed=_HOT_SEED) % num_buckets


def _hot_rows(batch: bt.RecordBatch, on: Sequence[str],
              hot: torch.Tensor, widths=None) -> torch.Tensor:
    """(capacity,) bool: the live rows whose key's bucket is hot."""
    live = bm.row_mask_bool(batch.capacity, batch.length, batch.device)
    return hot[_hot_buckets_of(batch, on, hot.shape[0], widths)] & live


def detect_hot_buckets(batch: bt.RecordBatch, on: Sequence[str], *,
                       group: Group, threshold_frac: float,
                       num_buckets: int = HOT_BUCKETS, widths=None):
    """Global hashed key histogram -> ((num_buckets,) bool hot-bucket
    mask, this rank's (capacity,) bool hot-row flag).  A bucket is hot
    when its global row count exceeds threshold_frac of the global row
    count, compared in float32 as the JAX package does (a false positive
    only replicates a few more build rows).  Null keys are live rows and
    all fall in one bucket.  One all_reduce of the histogram and the live
    count together.  A string key hashes at `widths` (parallel to `on`),
    by default at the ranks' longest string (one more all_reduce)."""
    if widths is None:
        widths = [None if b is None else matrix_width(b)
                  for b in shuffle.shared_bounds([batch[k] for k in on])]
    live = bm.row_mask_bool(batch.capacity, batch.length, batch.device)
    hb = _hot_buckets_of(batch, on, num_buckets, widths)
    counts = torch.bincount(torch.where(live, hb, num_buckets),
                            minlength=num_buckets + 1)
    counts[num_buckets] = live.sum()  # the dead rows' bin -> the live count
    dist.all_reduce(counts)
    frac = torch.tensor(threshold_frac, dtype=torch.float32,
                        device=counts.device)
    hot = counts[:num_buckets].to(torch.float32) > (
        frac * counts[num_buckets].to(torch.float32))
    return hot, hot[hb] & live


def _row_chunks(batch: bt.RecordBatch, k: int) -> List[bt.RecordBatch]:
    """The batch cut into at most k chunks of rows, as the JAX package
    cuts them (a step of ceil(capacity / k) rounded up to the granule)
    but at the port's capacity; each chunk is a view of its rows."""
    cap = batch.capacity
    step = round_up(-(-cap // k))
    return [bt.RecordBatch(batch.schema, tuple(
        _slice(c, lo, min(step, cap - lo),
               min(max(batch.length - lo, 0), step)) for c in batch.columns))
            for lo in range(0, cap, step)]


def _slice(c: col.Column, lo: int, n: int, length: int) -> col.Column:
    """Rows [lo, lo + n) of `c` as a column of capacity n and the given
    length (lo and n multiples of the granule, so bitmaps cut at bytes;
    rows past the length are the source's padding, already zero)."""
    bits = slice(lo // 8, (lo + n) // 8)
    validity = None if c.validity is None else c.validity[bits]
    if isinstance(c, col.NullColumn):
        return col.NullColumn(length, n, c.device)
    if isinstance(c, col.PrimitiveColumn):
        return col.PrimitiveColumn(c.values[lo:lo + n], validity, length,
                                   c.dtype)
    if isinstance(c, col.BooleanColumn):
        return col.BooleanColumn(c.values[bits], validity, length)
    if isinstance(c, col.DictionaryColumn):  # the keys; values are shared
        return dataclasses.replace(c, keys=_slice(c.keys, lo, n, length))
    if isinstance(c, col.StringViewColumn):  # the views; the arena is shared
        return dataclasses.replace(c, views=c.views[lo:lo + n],
                                   validity=validity, length=length)
    raise st.ComputeError(f"chunk: unsupported column {type(c).__name__}")


def _or_info(infos: Sequence[jn.JoinInfo]) -> jn.JoinInfo:
    dup = infos[0].duplicates
    for i in infos[1:]:
        dup = dup | i.duplicates
    return jn.JoinInfo(dup, any(i.overflow for i in infos))


def _probe_join(table: jn.HashTable, left: bt.RecordBatch,
                right: bt.RecordBatch, on: Sequence[str], *, how: str,
                out_capacity: Optional[int]):
    """Local join of `left` against a table built once from `right`
    (the chunked-probe path)."""
    match, _ = jn.probe_table(table, [left[k] for k in on])
    return jn.join_matches(left, right, on, table, match, how=how,
                           out_capacity=out_capacity)


def _skew_join(left, right, on, widths, *, group, how, out_capacity,
               threshold, hot_capacity, probe_chunks):
    """The skew path of distributed_hash_join: hot buckets from the probe
    side's histogram split both sides; the cold rows join through the
    exchange, the hot build rows (at most hot_capacity) are replicated
    and joined with the hot probe rows where they are; -> the cold output,
    then the hot output."""
    hot, l_hot_mask = detect_hot_buckets(left, on, group=group,
                                         threshold_frac=threshold,
                                         widths=widths)
    r_hot_mask = _hot_rows(right, on, hot, widths)
    cold_out, cold_info = _exchange_join(
        _filter_bool(left, ~l_hot_mask), _filter_bool(right, ~r_hot_mask),
        on, widths, group=group, how=how, out_capacity=out_capacity,
        probe_chunks=probe_chunks)
    hcap = hot_capacity or default_hot_capacity(right)
    r_hot = _filter_bool(right, r_hot_mask)
    hot_overflow = r_hot.length > hcap  # the filter read its count back
    r_hot_all = _replicate(_shrink(r_hot, hcap), group)
    hot_out, hot_info = jn.hash_join(_filter_bool(left, l_hot_mask),
                                     r_hot_all, on, how=how,
                                     out_capacity=out_capacity)
    info = _or_info([cold_info, hot_info])
    return (concat_batches([cold_out, hot_out]),
            jn.JoinInfo(info.duplicates, info.overflow or hot_overflow))


def _exchange_join(left, right, on, widths, *, group, how, out_capacity,
                   probe_chunks):
    """Both sides through the exchange, their string keys at `widths`,
    then the local join (of the probe side in `probe_chunks` chunks)."""
    r_ex = shuffle.exchange(right, on, group, widths)
    if probe_chunks <= 1:
        l_ex = shuffle.exchange(left, on, group, widths)
        return jn.hash_join(l_ex, r_ex, on, how=how,
                            out_capacity=out_capacity)
    table = jn.build_table([r_ex[k] for k in on], widths)
    outs = [_probe_join(table, shuffle.exchange(chunk, on, group, widths),
                        r_ex, on, how=how, out_capacity=out_capacity)
            for chunk in _row_chunks(left, probe_chunks)]
    return concat_batches([o for o, _ in outs]), _or_info(
        [i for _, i in outs])


def distributed_hash_join(left: bt.RecordBatch, right: bt.RecordBatch,
                          on: Sequence[str], *, group: Group,
                          how: str = "inner",
                          out_capacity: Optional[int] = None,
                          skew_threshold: Optional[float] = None,
                          hot_capacity: Optional[int] = None,
                          probe_chunks: int = 1):
    """Both sides hash-partitioned on the join key over the group, then
    joined locally: equal keys meet on one rank because both exchanges
    use the same hash (and a string key the same width, `_key_widths`).
    -> (batch, JoinInfo).

    skew_threshold (e.g. 0.01): keys of buckets above this share of the
    global probe rows skip the exchange; their build rows (at most
    hot_capacity a rank, by default a quarter of the build capacity) are
    replicated and their probe rows join locally.  probe_chunks > 1
    exchanges and joins the probe side in that many chunks against one
    build table."""
    widths = _key_widths(left, right, on)
    if skew_threshold is not None:
        return _skew_join(left, right, on, widths, group=group, how=how,
                          out_capacity=out_capacity,
                          threshold=skew_threshold,
                          hot_capacity=hot_capacity,
                          probe_chunks=probe_chunks)
    return _exchange_join(left, right, on, widths, group=group, how=how,
                          out_capacity=out_capacity,
                          probe_chunks=probe_chunks)


_MERGE = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}


def distributed_group_by(batch: bt.RecordBatch, keys: Sequence[str],
                         aggs: Sequence[Tuple[str, str]], *,
                         group: Group) -> bt.RecordBatch:
    """Two-phase grouped aggregation; `mean` is a local sum and count,
    finalized after the merge."""
    local_aggs, finalizers = [], []
    for name, agg in aggs:
        if agg == "mean" and st.decimal_limbs(batch[name].dtype) is not None:
            raise st.ComputeError(
                f"distributed mean of decimal column {name!r}: not supported")
        if agg == "mean":
            local_aggs += [(name, "sum"), (name, "count")]
            finalizers.append((f"mean_{name}", "mean", name))
        elif agg in _MERGE:
            local_aggs.append((name, agg))
            finalizers.append((f"{agg}_{name}", agg, name))
        else:
            raise st.ComputeError(f"unknown aggregate {agg!r}")
    local_aggs = list(dict.fromkeys(local_aggs))  # mean may repeat sum/count

    partial = gb.group_by(batch, keys, local_aggs)
    merged_in = shuffle.exchange(partial, keys, group)
    merged = gb.group_by(merged_in, keys, [
        (f"{agg}_{name}", _MERGE[agg]) for name, agg in local_aggs])
    # merged columns are named e.g. sum_sum_v, sum_count_v, min_min_v
    fields = [merged.schema.field(k) for k in keys]
    cols = [merged[k] for k in keys]
    for out_name, agg, name in finalizers:
        if agg == "mean":
            c = _mean(merged[f"sum_sum_{name}"], merged[f"sum_count_{name}"])
        else:
            c = merged[f"{_MERGE[agg]}_{agg}_{name}"]
        fields.append(st.Field(out_name, c.dtype))
        cols.append(c)
    return bt.RecordBatch(st.Schema(tuple(fields)), tuple(cols))


def _mean(s: col.PrimitiveColumn, n: col.PrimitiveColumn
          ) -> col.PrimitiveColumn:
    """sum / max(count, 1) in float64, null where either input is null or
    the count is 0 (the JAX package's finalizer)."""
    live = bm.row_mask_bool(s.capacity, s.length, s.device)
    total = (u64.to_float(s.values) if st.is_u64(s.dtype)
             else s.values.to(torch.float64))
    values = total / n.values.clamp(min=1).to(torch.float64)
    ok = s.valid_bool() & n.valid_bool() & (n.values > 0)
    return col.PrimitiveColumn(torch.where(live, values, 0.0), bm.pack(ok),
                               s.length, st.float64)
