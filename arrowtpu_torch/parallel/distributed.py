"""Distributed operators: hash join and group-by over a process group.

Counterpart of `arrowtpu/parallel/distributed.py`, called by every rank
of the group with its own shard:

  distributed_hash_join = exchange(right) + exchange(left) + local join
  distributed_group_by  = local partial aggregation + exchange(partials
                          by key) + final re-aggregation (sum of sums,
                          sum of counts, min of mins, max of maxes; mean
                          as sum and count, divided after the merge)

Output column names are the JAX package's (`sum_rv`, `count_rv`, ...).
Not ported yet: the skew path (`skew_threshold`: `detect_hot_buckets`,
`_replicate`, `_filter_bool`) and chunked probes (`probe_chunks`), which
need `ops/concat.py`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .. import schema as st
from ..core import batch as bt
from ..core import bitmap as bm
from ..core import column as col
from ..ops import groupby as gb
from ..ops import join as jn
from . import shuffle
from .mesh import Group


def distributed_hash_join(left: bt.RecordBatch, right: bt.RecordBatch,
                          on: Sequence[str], *, group: Group,
                          how: str = "inner",
                          out_capacity: Optional[int] = None):
    """Both sides hash-partitioned on the join key over the group, then
    joined locally: equal keys meet on one rank because both exchanges
    use the same hash.  -> (batch, JoinInfo)."""
    r_ex = shuffle.exchange(right, on, group)
    l_ex = shuffle.exchange(left, on, group)
    return jn.hash_join(l_ex, r_ex, on, how=how, out_capacity=out_capacity)


_MERGE = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}


def distributed_group_by(batch: bt.RecordBatch, keys: Sequence[str],
                         aggs: Sequence[Tuple[str, str]], *,
                         group: Group) -> bt.RecordBatch:
    """Two-phase grouped aggregation; `mean` is a local sum and count,
    finalized after the merge."""
    local_aggs, finalizers = [], []
    for name, agg in aggs:
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
    values = s.values.to(torch.float64) / n.values.clamp(min=1).to(
        torch.float64)
    ok = s.valid_bool() & n.valid_bool() & (n.values > 0)
    return col.PrimitiveColumn(torch.where(live, values, 0.0), bm.pack(ok),
                               s.length, st.float64)
