"""The driver entry points: the flagship step and the distributed step.

`step` is the counterpart of `__graft_entry__.entry()`:

    mask     = (a > b) AND (c % 7 == 0)       Kleene nulls (BASELINE config 2)
    filtered = filter_record_batch(batch, mask)               (config 1)
    result   = group_by(filtered, k; sum v, count v, min v)   (config 4)

`example_arrays` draws the five int64 columns from numpy with the JAX
package's seed order (a, b, c, k, v), so with `null_density=0` the values
equal `__graft_entry__._example_batch`; the null masks are drawn after the
values (`null_density` on a, b and v, half of it on c, as BASELINE's
configs 2 and 4 use).  `key_card` is the number of distinct keys.

`join_step` is one rank's part of `__graft_entry__.dryrun_multichip`'s
step (config 5): hash-partition exchange of both sides, hash join, and a
two-phase group-by; with `skew_threshold` and `probe_chunks` it takes
the skew path and chunked probes of config 5's skewed-key join.
`example_join_shards` draws a rank's shards as the dryrun does (or with
Zipf probe keys, `zipf`), `join_oracle` / `check_join_output` hold the
step's output to a host oracle, and `dryrun_multichip(n)` runs the dryrun
on n ranks.  `group_by_shards` runs the two-phase group-by alone on n ranks.

`agg_step` is BASELINE config 4 as `bench.py` config4_hash_agg runs it:
a plan from `plan_group_by` (`agg_plan`), then sum, count and min of an
int64 value by an int32 key.  `example_agg_arrays` draws the bench's data
(at 100 keys the plan takes the dense-range engine, at 1,000,000 the sort
pipeline), and `agg_oracle` / `check_agg` hold the output to numpy:
keys, sums, counts and mins, all exact.

`q6_step` is TPC-H Q6 (Clause 2.4.6) with the kept rows materialized:
its predicate on a Date32 and two Decimal128(15, 2) columns, then
`filter_record_batch` of all 16 `lineitem` columns (BASELINE config 1 over
a schema users run: keys, decimals, dates, string views, dictionaries) and
the revenue, sum(l_extendedprice * l_discount), by decimal limb
arithmetic.  `example_lineitem_arrays` draws `lineitem` by Clause 4.2.3,
`lineitem_batch` builds its batch on the card, and `q6_oracle` /
`check_q6` hold the step to numpy, every kept column and the revenue
exactly.

`q1_step` is TPC-H Q1 (Clause 2.4.1, the pricing summary report): the
predicate on l_shipdate, `filter_record_batch` of the six columns Q1 reads,
disc_price and charge by decimal limb arithmetic, the group-by of the two
one-letter string flags (four decimal sums, three means, a count) and the
sort by the flags.  `q1_oracle` / `check_q1` hold it to numpy on the
integer cents: the sums exactly, the means bit for bit.

`q14_step` and `q19_step` are TPC-H Q14 (Clause 2.4.14, the promotion
effect) and Q19 (Clause 2.4.19, discounted revenue) over lineitem ⋈
part, the predicate layer at full size: date compares and a filter,
`hash_join` with part as the build side, l_extendedprice * (1 -
l_discount) through `ops.numeric`, Q14's `zip_(p_type LIKE 'PROMO%',
disc_price, 0)`, and Q19's pushed-down conjuncts (`like` on the
dictionaries, decimal compares, `or_kleene` of `and_kleene` chains on
part) with the whole predicate applied again after the join; both return
exact decimal sums.  `example_part_arrays` draws `part` by Clause 4.2.3
(the same retail price formula as lineitem's extended price),
`part_batch` builds it on the card (strings as utf8 views), and
`q14_oracle` / `q19_oracle` / `check_query` hold the steps to numpy.

`text_join_batches` carries config 5's join step on a text key: k as
TPC-H's c_name, "Customer#%09d" (18 bytes, in the arena; `text_keys`), on
both sides and rv as a Decimal128(15, 2), so `join_step` runs the string
hash, the exchange of string views and decimals, string-key probing and a
decimal partial sum through the exchange; `check_text_join_output` reads
the keys and sums back to integers and holds them to `join_oracle`.
`lineitem_exchange` hash-partitions `lineitem` on l_orderkey (the shuffle
ahead of a lineitem-orders join; at one rank `check_same_rows` holds it
to its input, row for row), and `q1_distributed_step` runs Q1's sums and
count as a distributed group-by (`check_q1` with `Q1_DISTRIBUTED_AGGS`).

`q3_step` is TPC-H Q3 (Clause 2.4.3, shipping priority) over customer ⋈
orders ⋈ lineitem: three filters (`like` on the c_mktsegment dictionary,
date compares), two `hash_join`s (customer, then the joined orders, as the
build side), revenue through `ops.numeric`, a `group_by` on (l_orderkey,
o_orderdate, o_shippriority) with a Date32 key, and the top ten by
`sort_batch`.  `example_orders_arrays` / `orders_batch` and
`example_customer_arrays` / `customer_batch` draw TPC-H's `orders` (the
order keys and dates that `example_lineitem_arrays` drew) and `customer`
by Clause 4.2.3; `q3_oracle` / `check_q3` hold the step to numpy.
`sorted_runs_step` is an ORDER BY run as an external sort runs it: the
batch cut into runs (`slice_batch`), each sorted (`sort_batch`), the runs
merged (`merge_batches`).

`clickbench_step(batch, q)` runs ClickBench's query q (1-8, by its text
in ClickBench's queries.sql, `CLICKBENCH_QUERIES`) over `hits`: COUNT
with a filter, SUM of a UInt8 cast to uint64, AVGs of a cast to float64
(uint64 by hi * 2**32 + lo), COUNT(DISTINCT) as group counts of uint64
keys, MIN / MAX of a Date32, the filtered group-by and the top tens,
each ending on the host.  `example_hits_arrays` draws the five columns
these queries read in ClickHouse's types (UserID uint64, RegionID uint32,
ResolutionWidth uint16, AdvEngineID uint8, EventDate Date32) by the
published table's laws at its 99,997,497 rows, `hits_batch` builds them
on the card, and `clickbench_oracle` / `check_clickbench` hold the steps
to numpy.

`lineitem_ipc` writes a lineitem batch as an Arrow IPC file (or stream)
of `rows_per_batch`-row record batches (`slice_batch`), the way an engine
hands a table to another; `read_lineitem_ipc` reads it back onto the card,
by default with `validate=True` (the UTF-8 check over every l_comment, the
key bounds of the two dictionaries), into one batch (`concat_batches`),
on which `q6_step` runs as on any lineitem batch.  `check_same_rows(...,
same_dictionary=False)` holds the round trip to the batch written, its
dictionaries by their values.

`jsonbench_step(batch, q)` runs JSONBench's query q (1-5, by its text
for ClickHouse, `JSONBENCH_QUERIES`) over Bluesky events read from a
shredded Variant column: `example_bluesky_docs` draws the events as JSON
texts in Jetstream's shape, `bluesky_variant` parses, encodes and shreds
them to JSONBENCH_SHRED (host work, as in the JAX package), and
`bluesky_batch` takes the five columns the queries read by
`variant_get`'s columnar path; the queries are `like` compares, Kleene
ANDs, filters, group-bys (Q2's distinct users as two), `date_part` and
`sort_batch`, each ending in its rows on the host.  `jsonbench_oracle` /
`check_jsonbench` hold them to the texts parsed by Python's `json`.

`lexsort_step` is BASELINE config 3 (`bench.py` config3_lexsort): the
lexsort of (int32, float64, dictionary-utf8) columns.
`example_lexsort_columns` draws them as the bench does, and
`check_lexsort` holds an index to the stable order on the host without a
host sort.
"""

from __future__ import annotations

import dataclasses
import decimal as _pydec
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import ops
from . import schema as st
from .config import resolve_device, round_up
from .core import batch as bt
from .core import bitmap as bm
from .core import column as col
from .interop.numpy_bridge import (batch_from_numpy, column_from_numpy,
                                   column_to_numpy, decimal_from_int64,
                                   resolve_views, string_view_from_numpy)
from .ops import groupby as gb
from .parallel.distributed import distributed_group_by, distributed_hash_join
from .parallel.mesh import Group, run
from .parallel.shuffle import exchange

Arrays = Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]]


def example_arrays(n: int = 4096, seed: int = 0, null_density: float = 0.0,
                   key_card: int = 64) -> Arrays:
    """{name: (int64 values, valid bools or None)} for a, b, c, k, v."""
    rng = np.random.default_rng(seed)
    values = {"a": rng.integers(-1000, 1000, n),
              "b": rng.integers(-1000, 1000, n),
              "c": rng.integers(0, 10**6, n),
              "k": rng.integers(0, key_card, n),
              "v": rng.integers(-100, 100, n)}
    density = {"a": null_density, "b": null_density,
               "c": null_density / 2, "v": null_density}
    valid = {name: (rng.random(n) > d if null_density > 0 else None)
             for name, d in density.items()}
    return {name: (vals, valid.get(name)) for name, vals in values.items()}


def example_batch(n: int = 4096, seed: int = 0, null_density: float = 0.0,
                  key_card: int = 64, device=None) -> bt.RecordBatch:
    return batch_from_numpy(example_arrays(n, seed, null_density, key_card),
                            device=resolve_device(device))


def step(batch: bt.RecordBatch) -> bt.RecordBatch:
    mask = ops.and_kleene(ops.gt(batch["a"], batch["b"]),
                          ops.eq(ops.rem(batch["c"], 7), 0))
    filtered = ops.filter_record_batch(batch, mask)
    return gb.group_by(filtered, ["k"],
                       [("v", "sum"), ("v", "count"), ("v", "min")])


def entry(device=None):
    """-> (step, (batch,)): the flagship step and its 4096-row example
    batch, on the card unless `device` says otherwise."""
    return step, (example_batch(device=resolve_device(device)),)


# ---------------------------------------------------------------------------
# the distributed step: exchange -> hash join -> two-phase group-by
# ---------------------------------------------------------------------------


def join_step(left: bt.RecordBatch, right: bt.RecordBatch, group: Group,
              *, skew_threshold: Optional[float] = None,
              probe_chunks: int = 1) -> bt.RecordBatch:
    """One rank's part of `__graft_entry__.dryrun_multichip`'s step (BASELINE
    config 5): both sides hash-partitioned on k and joined, then sum and
    count of rv by k in two phases.  `skew_threshold` and `probe_chunks`
    go to `distributed_hash_join` (the skew path and chunked probes); the
    defaults are the dryrun's step."""
    joined, _ = distributed_hash_join(
        left, right, ["k"], group=group, skew_threshold=skew_threshold,
        probe_chunks=probe_chunks)
    return distributed_group_by(joined, ["k"], [("rv", "sum"),
                                                ("rv", "count")],
                                group=group)


def example_join_shards(rank: int, world_size: int, probe_rows: int = 256,
                        build_rows: int = 32, seed: int = 0, *,
                        key_range: int = 200, key_nulls: float = 0.0,
                        rv_nulls: float = 0.0, permute_build: bool = False,
                        zipf: Optional[float] = None, device="cpu"
                        ) -> Tuple[Arrays, Arrays]:
    """Rank `rank`'s probe shard {k, v} and build shard {k, rv}, drawn
    with numpy as `__graft_entry__.dryrun_multichip` draws them (the
    defaults are its shapes, and with seed 0 its values): probe keys
    uniform in [0, key_range), v in [-50, 50); build keys unique across
    ranks, rank r holding [r * build_rows, (r + 1) * build_rows) (or, with
    `permute_build`, its slice of one seeded permutation of all build
    keys), rv in [0, 10**6).  Null masks, when asked for, are drawn after
    the values: `key_nulls` on the probe key, `rv_nulls` on rv.

    With `zipf` = s, probe key i in [0, key_range) has probability
    proportional to 1 / (i + 1)**s instead: a uniform draw in [0, 1) per
    row, mapped by the inverse of the keys' cumulative distribution (a
    search of the float64 CDF, which `device` runs; the keys are the same
    on every device)."""
    r = np.random.default_rng(seed + rank)
    if zipf is None:
        k = r.integers(0, key_range, probe_rows)
    else:
        k = zipf_keys(r.random(probe_rows), key_range, zipf, device)
    v = r.integers(-50, 50, probe_rows)
    k_ok = r.random(probe_rows) >= key_nulls if key_nulls else None
    rb = np.random.default_rng(seed + 1000 + rank)
    rv = rb.integers(0, 10**6, build_rows)
    rv_ok = rb.random(build_rows) >= rv_nulls if rv_nulls else None
    lo, hi = rank * build_rows, (rank + 1) * build_rows
    if permute_build:
        ks = np.random.default_rng(seed + 2000).permutation(
            world_size * build_rows)[lo:hi]
    else:
        ks = np.arange(lo, hi, dtype=np.int64)
    return ({"k": (k, k_ok), "v": (v, None)}, {"k": (ks, None),
                                               "rv": (rv, rv_ok)})


def zipf_keys(u: np.ndarray, key_range: int, s: float,
              device="cpu") -> np.ndarray:
    """Keys in [0, key_range) from uniforms `u` in [0, 1), key i with
    probability proportional to 1 / (i + 1)**s: the first key whose
    cumulative probability exceeds u (the CDF summed in numpy's order,
    searched with torch on `device`)."""
    cdf = np.cumsum(1.0 / np.arange(1, key_range + 1, dtype=np.float64)**s)
    cdf /= cdf[-1]
    keys = torch.searchsorted(torch.from_numpy(cdf).to(device),
                              torch.from_numpy(u).to(device), right=True)
    return keys.cpu().numpy()


def join_oracle(shards) -> Dict[str, np.ndarray]:
    """The step's answer from every rank's (probe, build) arrays, on the
    host: for each key on both sides (build keys unique), count = the
    probe rows of k with a valid key, times whether rv[k] is valid; sum =
    count * rv[k], null where count is 0.  -> {k, sum, sum_valid, count},
    ascending by k."""
    pk = np.concatenate([k if ok is None else k[ok]
                         for (k, ok) in (l["k"] for l, _ in shards)])
    bk = np.concatenate([r["k"][0] for _, r in shards])
    rv = np.concatenate([r["rv"][0] for _, r in shards])
    rv_ok = np.concatenate([np.ones(len(r["rv"][0]), bool)
                            if r["rv"][1] is None else r["rv"][1]
                            for _, r in shards])
    size = int(max(pk.max(initial=-1), bk.max(initial=-1))) + 1
    if (bk < 0).any() or (pk < 0).any() or np.bincount(
            bk, minlength=1).max() > 1:
        raise ValueError("the oracle takes unique, non-negative build keys "
                         "and non-negative probe keys")
    probe_count = np.bincount(pk, minlength=size)
    by_key = np.zeros(size, np.int64)
    by_key[bk] = rv
    ok_by_key = np.zeros(size, bool)
    ok_by_key[bk] = rv_ok
    on_build = np.zeros(size, bool)
    on_build[bk] = True
    keys = np.nonzero(on_build & (probe_count > 0))[0]
    count = probe_count[keys] * ok_by_key[keys]
    return {"k": keys, "sum": count * by_key[keys], "sum_valid": count > 0,
            "count": count}


def check_join_output(outputs: Sequence[bt.RecordBatch], want) -> int:
    """Raise AssertionError unless the per-rank outputs of `join_step`
    together equal `join_oracle`'s answer, every key on one rank only.
    -> the number of groups."""
    names = ["k", "sum_rv", "count_rv"]
    parts = {n: [column_to_numpy(out[n]) for out in outputs] for n in names}
    for out in outputs:
        if out.schema.names != names:
            raise AssertionError(f"output columns {out.schema.names}")
    k = np.concatenate([v for v, _, _ in parts["k"]])
    if len(np.unique(k)) != len(k):
        raise AssertionError("a key was produced by two ranks")
    order = np.argsort(k, kind="stable")
    got = {n: (np.concatenate([v for v, _, _ in parts[n]])[order],
               np.concatenate([ok for _, ok, _ in parts[n]])[order])
           for n in names}
    if not np.array_equal(got["k"][0], want["k"]):
        extra = np.setdiff1d(got["k"][0], want["k"])[:5]
        missing = np.setdiff1d(want["k"], got["k"][0])[:5]
        raise AssertionError(f"group keys differ: extra={extra.tolist()} "
                             f"missing={missing.tolist()}")
    if not (got["k"][1].all() and got["count_rv"][1].all()):
        raise AssertionError("a key or a count is null")
    if not np.array_equal(got["count_rv"][0], want["count"]):
        raise AssertionError("counts differ from the oracle")
    if not np.array_equal(got["sum_rv"][1], want["sum_valid"]):
        raise AssertionError("sum validity differs from the oracle")
    ok = want["sum_valid"]
    if not np.array_equal(got["sum_rv"][0][ok], want["sum"][ok]):
        raise AssertionError("sums differ from the oracle")
    return len(k)


# ---------------------------------------------------------------------------
# config 4: the planned hash aggregate
# ---------------------------------------------------------------------------

AGG_AGGS = [("v", "sum"), ("v", "count"), ("v", "min")]
AGG_COLUMNS = ["k", "sum_v", "count_v", "min_v"]


def example_agg_arrays(n: int = 4096, cardinality: int = 100,
                       seed: int = 3) -> Arrays:
    """BASELINE config 4's data, drawn as `bench.py` config4_hash_agg draws
    it: an int32 key uniform in [0, cardinality), then an int64 value in
    [-1000, 1000); no nulls."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, cardinality, n, dtype=np.int32)
    vals = rng.integers(-1000, 1000, n)
    return {"k": (keys, None), "v": (vals, None)}


def example_agg_batch(n: int = 4096, cardinality: int = 100, seed: int = 3,
                      device=None) -> bt.RecordBatch:
    return batch_from_numpy(example_agg_arrays(n, cardinality, seed),
                            device=resolve_device(device))


def agg_plan(batch: bt.RecordBatch) -> gb.GroupByPlan:
    """The bench's plan: one probe of the key range fixes the engine."""
    return gb.plan_group_by(batch, ["k"], AGG_AGGS)


def agg_step(plan: gb.GroupByPlan, batch: bt.RecordBatch) -> bt.RecordBatch:
    """Config 4's step: the planned group-by of sum, count and min of v by
    k."""
    return plan(batch)


def agg_oracle(arrays: Arrays) -> Dict[str, np.ndarray]:
    """Per key (ascending) the sum, count and min of v, in numpy; the keys
    must be non-negative and nothing null, as in the bench's data."""
    (k, k_ok), (v, v_ok) = arrays["k"], arrays["v"]
    if k_ok is not None or v_ok is not None or (len(k) and k.min() < 0):
        raise ValueError("the oracle takes non-negative keys and no nulls")
    count = np.bincount(k)
    keys = np.flatnonzero(count)
    sums = np.zeros(len(count), np.int64)
    np.add.at(sums, k, v)
    mins = np.full(len(count), np.iinfo(np.int64).max)
    np.minimum.at(mins, k, v)
    return {"k": keys, "sum_v": sums[keys], "count_v": count[keys],
            "min_v": mins[keys]}


def check_agg(out: bt.RecordBatch, want: Dict[str, np.ndarray]) -> int:
    """Raise AssertionError unless `agg_step`'s output equals `agg_oracle`'s
    answer exactly: the groups in key order, sum and min valid in every
    group, key and count without validity, zeros past the length.  -> the
    number of groups."""
    if out.schema.names != AGG_COLUMNS:
        raise AssertionError(f"output columns {out.schema.names}")
    g = len(want["k"])
    if out.length != g:
        raise AssertionError(f"{out.length} groups, oracle {g}")
    for name in AGG_COLUMNS:
        c = out[name]
        vals, ok, _ = column_to_numpy(c)
        if not np.array_equal(vals, want[name]):
            raise AssertionError(f"{name}: values differ from the oracle")
        if c.values[g:].any():
            raise AssertionError(f"{name}: padding past the length not zero")
        if (c.validity is None) != (name in ("k", "count_v")) or not ok.all():
            raise AssertionError(f"{name}: validity differs from the oracle")
        if c.validity is not None and bm.unpack(c.validity)[g:].any():
            raise AssertionError(f"{name}: validity past the length set")
    return g


# ---------------------------------------------------------------------------
# config 3: lexsort over (Int32, Float64, dictionary Utf8)
# ---------------------------------------------------------------------------


def example_lexsort_arrays(n: int, seed: int = 2):
    """BASELINE config 3's data, drawn in `bench.py` config3_lexsort's numpy
    order: -> (i32 in [-100, 100), float64 standard normals rounded to 2
    places (so -0.0 and +0.0 both occur), dictionary keys in [0, 1000), the
    1000 dictionary words "w%03d" in a seeded permuted order)."""
    rng = np.random.default_rng(seed)
    i32 = rng.integers(-100, 100, n, dtype=np.int32)
    f64 = np.round(rng.standard_normal(n), 2)
    keys = rng.integers(0, 1000, n, dtype=np.int32)
    words = [f"w{i:03d}" for i in rng.permutation(1000)]
    return i32, f64, keys, words


def lexsort_columns(i32, f64, keys, words, device=None) -> List[col.Column]:
    """The three sort columns of config 3 from host arrays: int32, float64,
    and keys into the dictionary of `words` (ranks by string order)."""
    device = resolve_device(device)
    dtype = st.Dictionary(st.int32, st.utf8)
    proto = col.dictionary_encode_host(words, dtype, device=device)
    return [col.primitive(i32, st.int32, device=device),
            col.primitive(f64, st.float64, device=device),
            col.DictionaryColumn(col.primitive(keys, st.int32, device=device),
                                 proto.values, proto.value_ranks, dtype)]


def example_lexsort_columns(n: int = 4096, seed: int = 2,
                            device=None) -> List[col.Column]:
    return lexsort_columns(*example_lexsort_arrays(n, seed), device=device)


def lexsort_step(columns: Sequence[col.Column]) -> col.PrimitiveColumn:
    """Config 3's step: the int32 index column sorting the rows by the
    columns, ascending, nulls first."""
    return ops.lexsort_to_indices(columns)


def lexsort_keys(i32, f64, keys, words):
    """The host's sort keys of config 3's rows: (i32, the float64 bits
    mapped to uint64 in total order (`bench.py`'s map), each row's word
    rank in string order)."""
    ub = f64.view(np.uint64)
    f64key = np.where(ub >> np.uint64(63) == 0,
                      ub | np.uint64(0x8000000000000000), ~ub)
    order = np.argsort(np.asarray(words, dtype=object), kind="stable")
    word_rank = np.empty(len(words), np.int64)
    word_rank[order] = np.arange(len(words))
    return i32, f64key, word_rank[keys]


def check_lexsort(idx: np.ndarray, sort_keys) -> None:
    """Raise AssertionError unless `idx` is the stable lexicographic order
    of the rows by `sort_keys` (most significant first): a permutation of
    [0, n) under which the key tuples never decrease and equal tuples keep
    increasing row ids.  For a stable sort that is the same as equality
    with np.lexsort, and needs no host sort."""
    n = len(sort_keys[0])
    idx = np.asarray(idx)
    if idx.shape != (n,) or (n and (idx.min() < 0 or idx.max() >= n)):
        raise AssertionError(f"index of shape {idx.shape} is not in [0, {n})")
    if n and np.bincount(idx, minlength=n).max() != 1:
        raise AssertionError("the index is not a permutation")
    later, tied = None, None
    for key in (*sort_keys, np.arange(n)):
        k = key[idx]
        gt, eq = k[1:] > k[:-1], k[1:] == k[:-1]
        later = gt if later is None else later | (tied & gt)
        tied = eq if tied is None else tied & eq
    if not later.all():
        raise AssertionError(
            f"rows out of order at sorted positions "
            f"{np.flatnonzero(~later)[:5].tolist()}")


def _to_host(out: bt.RecordBatch) -> bt.RecordBatch:
    return bt.RecordBatch(out.schema, tuple(
        column_from_numpy(*column_to_numpy(c), dtype=c.dtype, device="cpu")
        for c in out.columns))


def _dryrun_rank(group: Group, world_size: int):
    """One rank of `dryrun_multichip`: its shards, the step, the result
    as host arrays."""
    left, right = example_join_shards(group.rank, world_size)
    return _to_host(join_step(batch_from_numpy(left, device=group.device),
                              batch_from_numpy(right, device=group.device),
                              group))


def _group_by_rank(group: Group, shards: Sequence[Arrays], keys, aggs):
    batch = batch_from_numpy(shards[group.rank], device=group.device)
    return _to_host(distributed_group_by(batch, keys, aggs, group=group))


def group_by_shards(shards: Sequence[Arrays], keys: Sequence[str],
                    aggs: Sequence[Tuple[str, str]], device=None
                    ) -> List[bt.RecordBatch]:
    """`distributed_group_by` on len(shards) ranks (one per card, or gloo
    processes with device="cpu"), rank r holding `shards[r]`; -> each
    rank's result, on the host."""
    return run(_group_by_rank, len(shards), resolve_device(device), shards,
               list(keys), list(aggs))


def dryrun_multichip(n: int, device=None) -> int:
    """`__graft_entry__.dryrun_multichip(n)` on n ranks (one per card, or
    gloo processes with device="cpu"): the dryrun's tiny shards, the full
    distributed step, the result held exactly against its host oracle.
    -> the number of groups."""
    outputs = run(_dryrun_rank, n, resolve_device(device), n)
    want = join_oracle([example_join_shards(r, n) for r in range(n)])
    groups = check_join_output(outputs, want)
    print(f"dryrun_multichip({n}): ok, {groups} groups, values exact vs "
          "host oracle")
    return groups


# ---------------------------------------------------------------------------
# TPC-H Q6 over lineitem: decimals, dates and strings through the filter
# ---------------------------------------------------------------------------

LINEITEM_COLUMNS = [
    "l_orderkey", "l_partkey", "l_suppkey", "l_linenumber", "l_quantity",
    "l_extendedprice", "l_discount", "l_tax", "l_returnflag", "l_linestatus",
    "l_shipdate", "l_commitdate", "l_receiptdate", "l_shipinstruct",
    "l_shipmode", "l_comment"]
LINEITEM_DECIMALS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")
LINEITEM_DATES = ("l_shipdate", "l_commitdate", "l_receiptdate")
# the one-character flags: each row's code indexes its alphabet
LINEITEM_FLAGS = {"l_returnflag": b"RAN", "l_linestatus": b"OF"}
# TPC-H 4.2.2.13's lists, held as dictionaries of utf8
SHIPINSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE",
                "TAKE BACK RETURN"]
SHIPMODE = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
DECIMAL_15_2 = st.Decimal128(15, 2)
# dbgen draws every comment as a substring of one text pool of 300 MB
TEXT_POOL_BYTES = 300 * 2**20


def _days(iso: str) -> int:
    return int(np.datetime64(iso, "D").astype(np.int64))


def example_lineitem_arrays(sf: float = 1.0, seed: int = 6) -> dict:
    """lineitem at scale factor `sf` by TPC-H Clause 4.2.3's rules, drawn
    in numpy with no loop over rows: 1,500,000 x sf orders with the sparse
    order keys (the first 8 of every 32), 1-7 lines each; part keys in [1,
    sf x 200,000], supplier keys by the spec's formula (S = sf x 10,000);
    quantity 1-50, discount 0.00-0.10, tax 0.00-0.08, extended price =
    quantity x the part's retail price, all in cents; ship, commit and
    receipt dates from the order date; return flag and line status
    against CURRENTDATE 1995-06-17; ship instructions and modes from the
    spec's lists; comments of 10-43 bytes, each a substring of one text
    pool (as dbgen takes them).  -> {name: array}, flags and dictionaries
    as codes, the comment as its pool, starts and lengths."""
    rng = np.random.default_rng(seed)
    orders = int(1_500_000 * sf)
    lines = rng.integers(1, 8, orders, dtype=np.int8)
    n = int(lines.sum(dtype=np.int64))
    order_of = np.repeat(np.arange(orders, dtype=np.int64), lines)
    first_line = np.repeat(np.cumsum(lines, dtype=np.int64) - lines, lines)
    okey = order_of // 8 * 32 + order_of % 8 + 1
    start, end = _days("1992-01-01"), _days("1998-12-31") - 151
    odate = rng.integers(start, end + 1, orders, dtype=np.int32)[order_of]
    parts, supps = int(sf * 200_000), int(sf * 10_000)
    pkey = rng.integers(1, parts + 1, n, dtype=np.int64)
    i = rng.integers(0, 4, n, dtype=np.int64)
    skey = (pkey + i * (supps // 4 + (pkey - 1) // supps)) % supps + 1
    qty = rng.integers(1, 51, n, dtype=np.int64)
    retail = 90_000 + (pkey // 10) % 20_001 + 100 * (pkey % 1000)
    ship = odate + rng.integers(1, 122, n, dtype=np.int32)
    commit = odate + rng.integers(30, 91, n, dtype=np.int32)
    receipt = ship + rng.integers(1, 31, n, dtype=np.int32)
    current = _days("1995-06-17")
    returnflag = np.where(receipt <= current,
                          rng.integers(0, 2, n, dtype=np.int8), 2)
    pool_bytes = min(TEXT_POOL_BYTES, 43 * n + 64)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)
    pool = letters[rng.integers(0, 27, pool_bytes, dtype=np.uint8)]
    clen = rng.integers(10, 44, n, dtype=np.int32)
    cstart = (rng.random(n) * (pool_bytes - clen)).astype(np.int64)
    return {
        "l_orderkey": okey, "l_partkey": pkey, "l_suppkey": skey,
        "l_linenumber": (np.arange(n, dtype=np.int64) - first_line + 1
                         ).astype(np.int32),
        "l_quantity": qty * 100, "l_extendedprice": qty * retail,
        "l_discount": rng.integers(0, 11, n, dtype=np.int64),
        "l_tax": rng.integers(0, 9, n, dtype=np.int64),
        "l_returnflag": returnflag.astype(np.int8),
        "l_linestatus": (ship <= current).astype(np.int8),
        "l_shipdate": ship, "l_commitdate": commit, "l_receiptdate": receipt,
        "l_shipinstruct": rng.integers(0, len(SHIPINSTRUCT), n,
                                       dtype=np.int32),
        "l_shipmode": rng.integers(0, len(SHIPMODE), n, dtype=np.int32),
        "l_comment": (pool, cstart, clen)}


def _words_dictionary(codes: np.ndarray, words: Sequence[str], device):
    """Dictionary<int32, utf8> of `words` with the given keys."""
    values = col.string_view(list(words), st.utf8, device)
    order = np.argsort(np.asarray(words, dtype=object), kind="stable")
    ranks = np.zeros(values.capacity, np.int32)
    ranks[:len(words)][order] = np.arange(len(words), dtype=np.int32)
    return col.DictionaryColumn(
        col.primitive(torch.from_numpy(codes).to(device), st.int32),
        values, torch.from_numpy(ranks).to(device),
        st.Dictionary(st.int32, st.utf8))


def lineitem_batch(arrays: dict, device=None) -> bt.RecordBatch:
    """The 16-column lineitem batch (NOT NULL, as TPC-H declares it): int64
    keys, an int32 line number, four Decimal128(15, 2) columns, three
    Date32 columns, the flags as utf8 views, ship instructions and modes
    as dictionaries of utf8, the comment as a utf8 view over its pool."""
    device = resolve_device(device)
    cols = {}
    for name in LINEITEM_COLUMNS:
        a = arrays[name]
        if name in LINEITEM_DECIMALS:
            cols[name] = decimal_from_int64(a, DECIMAL_15_2, device=device)
        elif name in LINEITEM_DATES:
            cols[name] = col.primitive(torch.from_numpy(a).to(device),
                                       st.Date32())
        elif name in LINEITEM_FLAGS:
            alphabet = np.frombuffer(LINEITEM_FLAGS[name], np.uint8)
            cols[name] = string_view_from_numpy(
                alphabet, a.astype(np.int64), np.ones(len(a), np.int32),
                device=device)
        elif name == "l_shipinstruct":
            cols[name] = _words_dictionary(a, SHIPINSTRUCT, device)
        elif name == "l_shipmode":
            cols[name] = _words_dictionary(a, SHIPMODE, device)
        elif name == "l_comment":
            cols[name] = string_view_from_numpy(*a, device=device)
        else:
            cols[name] = col.primitive(torch.from_numpy(a).to(device))
    return bt.record_batch(cols)


Q6_DATE, Q6_DISCOUNT, Q6_QUANTITY = "1994-01-01", "0.06", 24


def q6_predicate(batch: bt.RecordBatch, date: str = Q6_DATE,
                 discount: str = Q6_DISCOUNT,
                 quantity: int = Q6_QUANTITY) -> col.BooleanColumn:
    """l_shipdate >= date AND l_shipdate < date + 1 year AND l_discount
    BETWEEN discount - 0.01 AND discount + 0.01 AND l_quantity <
    quantity, on the card (Kleene AND of five comparisons)."""
    lo = np.datetime64(date, "D")
    hi = (lo.astype("datetime64[Y]") + 1).astype("datetime64[D]") + (
        lo - lo.astype("datetime64[Y]").astype("datetime64[D]"))
    d = _pydec.Decimal(discount)
    ship, disc = batch["l_shipdate"], batch["l_discount"]
    terms = [ops.gt_eq(ship, int(lo.astype(np.int64))),
             ops.lt(ship, int(hi.astype(np.int64))),
             ops.gt_eq(disc, d - _pydec.Decimal("0.01")),
             ops.lt_eq(disc, d + _pydec.Decimal("0.01")),
             ops.lt(batch["l_quantity"], quantity)]
    mask = terms[0]
    for t in terms[1:]:
        mask = ops.and_kleene(mask, t)
    return mask


def q6_step(batch: bt.RecordBatch, date: str = Q6_DATE,
            discount: str = Q6_DISCOUNT, quantity: int = Q6_QUANTITY):
    """TPC-H Q6 (Clause 2.4.6) with the whole kept row materialized: the
    predicate, `filter_record_batch` of all 16 columns by its one plan,
    and sum(l_extendedprice * l_discount) over the kept rows.  -> (the
    filtered batch, the revenue as a Decimal)."""
    from .ops import decimal as dec

    kept = ops.filter_record_batch(
        batch, q6_predicate(batch, date, discount, quantity))
    product = dec.mul(kept["l_extendedprice"], kept["l_discount"])
    limbs, _ = dec.sum_(product)
    return kept, dec.to_decimal(limbs, product.dtype.scale)


def q6_oracle(arrays: dict, date: str = Q6_DATE, discount: str = Q6_DISCOUNT,
              quantity: int = Q6_QUANTITY) -> dict:
    """Q6 on the host: the same predicate in numpy on the integer cents and
    day numbers; -> {"mask": kept rows, "revenue": the exact sum in units
    of 1e-4 (a Python int)}."""
    lo = np.datetime64(date, "D")
    hi = (lo.astype("datetime64[Y]") + 1).astype("datetime64[D]") + (
        lo - lo.astype("datetime64[Y]").astype("datetime64[D]"))
    d = int(_pydec.Decimal(discount).scaleb(2))
    ship, disc = arrays["l_shipdate"], arrays["l_discount"]
    mask = ((ship >= lo.astype(np.int64)) & (ship < hi.astype(np.int64))
            & (disc >= d - 1) & (disc <= d + 1)
            & (arrays["l_quantity"] < quantity * 100))
    revenue = int((arrays["l_extendedprice"][mask] * disc[mask]).sum())
    return {"mask": mask, "revenue": revenue}


def check_q6(out, arrays: dict, want: dict) -> int:
    """Hold q6_step's output to the oracle, exactly: the length; every
    column's kept rows (integers and dates as values, decimals as limbs,
    views resolved to bytes, dictionaries by key with the dictionary
    shared); no validity and zero padding; the revenue as an integer in
    units of 1e-4.  -> the kept row count."""
    from .core import limbs as lb

    kept, revenue = out
    mask = want["mask"]
    count = int(mask.sum())
    if kept.length != count:
        raise AssertionError(f"{kept.length} rows kept, oracle {count}")
    for name in LINEITEM_COLUMNS:
        c, a = kept[name], arrays[name]
        if c.validity is not None:
            raise AssertionError(f"{name}: a NOT NULL column has a bitmap")
        if isinstance(c, col.DictionaryColumn):
            got, expect = c.keys.values, a[mask]
            if c.keys.validity is not None:
                raise AssertionError(f"{name}: keys have a bitmap")
        elif isinstance(c, col.StringViewColumn):
            got = c.views
            if name == "l_comment":
                pool, starts, lengths = a
                width = 43
                idx = starts[mask][:, None] + np.arange(width)
                expect = np.where(np.arange(width) < lengths[mask][:, None],
                                  pool[np.minimum(idx, len(pool) - 1)], 0)
            else:
                width = 1
                expect = np.frombuffer(LINEITEM_FLAGS[name],
                                       np.uint8)[a[mask]][:, None]
            resolved, _ = resolve_views(c.views[:count].cpu().numpy(),
                                        c.arena.cpu().numpy(), width)
            if not np.array_equal(resolved, expect):
                raise AssertionError(f"{name}: kept strings differ")
        elif name in LINEITEM_DECIMALS:
            got = c.values
            expect = lb.split_int64(a[mask], 4).view(np.int32)
        else:
            got, expect = c.values, a[mask]
        host = got.cpu().numpy()
        if not isinstance(c, col.StringViewColumn) and not np.array_equal(
                host[:count], expect):
            raise AssertionError(f"{name}: kept values differ")
        if host[count:].any():
            raise AssertionError(f"{name}: padding past the length not zero")
    got_rev = int(revenue.scaleb(4))
    if got_rev != want["revenue"]:
        raise AssertionError(f"revenue {got_rev} != oracle {want['revenue']}"
                             " (units of 1e-4)")
    return count


Q1_DELTA_DAYS = 90  # the validation value of Clause 2.4.1.4
Q1_KEYS = ["l_returnflag", "l_linestatus"]
Q1_READS = ("l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
            "l_discount", "l_tax")
# the query's output columns after the keys: (its name, the group_by
# aggregate that computes it)
Q1_AGGS = [("sum_qty", ("l_quantity", "sum")),
           ("sum_base_price", ("l_extendedprice", "sum")),
           ("sum_disc_price", ("disc_price", "sum")),
           ("sum_charge", ("charge", "sum")),
           ("avg_qty", ("l_quantity", "mean")),
           ("avg_price", ("l_extendedprice", "mean")),
           ("avg_disc", ("l_discount", "mean")),
           ("count_order", ("l_quantity", "count"))]
# each sum's scale; each mean's sum (every averaged column has scale 2)
Q1_SUMS = {"sum_qty": 2, "sum_base_price": 2, "sum_disc_price": 4,
           "sum_charge": 6}
Q1_MEANS = {"avg_qty": "sum_qty", "avg_price": "sum_base_price",
            "avg_disc": "sum_disc"}


def q1_date(delta_days: int = Q1_DELTA_DAYS) -> int:
    """date '1998-12-01' - interval delta_days day, as a Date32."""
    return _days("1998-12-01") - delta_days


def q1_predicate(batch: bt.RecordBatch, delta_days: int = Q1_DELTA_DAYS
                 ) -> col.BooleanColumn:
    return ops.lt_eq(batch["l_shipdate"], q1_date(delta_days))


def q1_prices(kept: bt.RecordBatch):
    """-> (disc_price = l_extendedprice * (1 - l_discount), charge =
    disc_price * (1 + l_tax)), by decimal limb arithmetic: Decimal128
    (16, 2) for 1 - l_discount, then (32, 4) and (38, 6)."""
    from .ops import decimal as dec

    disc_price = dec.mul(kept["l_extendedprice"],
                         dec.neg(dec.sub(kept["l_discount"], 1)))
    return disc_price, dec.mul(disc_price, dec.add(kept["l_tax"], 1))


def q1_group(kept: bt.RecordBatch, disc_price, charge) -> bt.RecordBatch:
    """The group-by of Q1 by the two flags, its outputs named as the
    query names them."""
    grouped = gb.group_by(
        bt.record_batch({**{n: kept[n] for n in Q1_READS},
                         "disc_price": disc_price, "charge": charge}),
        Q1_KEYS, [agg for _, agg in Q1_AGGS])
    names = Q1_KEYS + [name for name, _ in Q1_AGGS]
    return bt.RecordBatch(st.Schema(tuple(
        st.Field(n, c.dtype) for n, c in zip(names, grouped.columns))),
        grouped.columns)


def q1_step(batch: bt.RecordBatch, delta_days: int = Q1_DELTA_DAYS
            ) -> bt.RecordBatch:
    """TPC-H Q1 (Clause 2.4.1, the pricing summary report): the predicate
    l_shipdate <= 1998-12-01 - delta_days, `filter_record_batch` of the
    six columns the query reads, the two prices, the group-by of the flags
    (four sums, three means, a count) and `sort_batch` by the flags."""
    kept = ops.filter_record_batch(
        bt.record_batch({n: batch[n] for n in Q1_READS}),
        q1_predicate(batch, delta_days))
    return ops.sort_batch(q1_group(kept, *q1_prices(kept)), Q1_KEYS)


def q1_oracle(arrays: dict, delta_days: int = Q1_DELTA_DAYS) -> dict:
    """Q1 on the host in numpy on the integer cents: {"keys": the groups'
    flag pairs as bytes in sorted order, each sum as a Python int of its
    unscaled value, each mean as float(sum) / count / 10**scale, the
    counts, "mask": the rows the predicate keeps}.  Each group's sums are
    int64, held below 2**62 by a bound on their terms."""
    mask = arrays["l_shipdate"] <= q1_date(delta_days)
    flags = [np.frombuffer(LINEITEM_FLAGS[n], np.uint8)[arrays[n][mask]]
             for n in Q1_KEYS]
    key = flags[0].astype(np.int64) * 256 + flags[1]
    groups, inv = np.unique(key, return_inverse=True)
    qty, ext, disc, tax = (arrays[n][mask] for n in LINEITEM_DECIMALS)
    disc_price = ext * (100 - disc)
    terms = {"sum_qty": qty, "sum_base_price": ext,
             "sum_disc_price": disc_price,
             "sum_charge": disc_price * (100 + tax), "sum_disc": disc}
    want = {"keys": [(bytes([g >> 8]), bytes([g & 0xFF]))
                     for g in groups.tolist()],
            "count_order": [], "mask": mask,
            **{name: [] for name in terms}}
    for g in range(len(groups)):
        rows = inv == g
        count = int(rows.sum())
        want["count_order"].append(count)
        for name, x in terms.items():
            part = x[rows]
            if int(np.abs(part).max()) * count >= 2**62:
                raise OverflowError(f"{name}: an int64 sum may overflow")
            want[name].append(int(part.sum()))
    for mean, total in Q1_MEANS.items():
        want[mean] = [float(s) / c / 10**2
                      for s, c in zip(want[total], want["count_order"])]
    del want["sum_disc"]
    return want


def check_q1(out: bt.RecordBatch, arrays: dict, want: dict,
             aggs=Q1_AGGS) -> int:
    """Hold q1_step's output (or `q1_distributed_step`'s, `aggs` then its
    aggregates) to the oracle, exactly: the groups in flag order, the
    flags resolved to bytes, each sum's limbs as an integer and its type
    (Decimal128(38, s)), the means bit for bit, the counts; no null row
    and zero padding.  -> the rows counted."""
    from .core import limbs as lb

    n = len(want["keys"])
    names = Q1_KEYS + [name for name, _ in aggs]
    if out.schema.names != names:
        raise AssertionError(f"columns {out.schema.names}, expected {names}")
    if out.length != n:
        raise AssertionError(f"{out.length} groups, oracle {n}")
    for i, name in enumerate(Q1_KEYS):
        c = out[name]
        got, _ = resolve_views(c.views[:n].cpu().numpy(),
                               c.arena.cpu().numpy(), 1)
        expect = np.array([[k[i][0]] for k in want["keys"]], np.uint8)
        if not np.array_equal(got, expect):
            raise AssertionError(f"{name}: {got.ravel().tobytes()} != "
                                 f"{expect.ravel().tobytes()}")
    for name, c in zip(names, out.columns):
        host = (c.views if isinstance(c, col.StringViewColumn)
                else c.values).cpu().numpy()
        if c.validity is not None and not bm.to_numpy_bools(
                c.validity, c.capacity)[:n].all():
            raise AssertionError(f"{name}: a group is null")
        if host[n:].any() or (c.validity is not None and bm.to_numpy_bools(
                c.validity, c.capacity)[n:].any()):
            raise AssertionError(f"{name}: padding past the length not zero")
        if name in Q1_SUMS:
            dtype = st.Decimal128(38, Q1_SUMS[name])
            if c.dtype != dtype:
                raise AssertionError(f"{name}: {c.dtype}, expected {dtype}")
            if lb.join_ints(host[:n]) != want[name]:
                raise AssertionError(f"{name}: {lb.join_ints(host[:n])} != "
                                     f"{want[name]}")
        elif name in Q1_MEANS:
            if c.dtype != st.float64 or not np.array_equal(
                    host[:n].view(np.uint64),
                    np.array(want[name], np.float64).view(np.uint64)):
                raise AssertionError(f"{name}: {host[:n]} != {want[name]}")
        elif name == "count_order" and host[:n].tolist() != want[name]:
            raise AssertionError(f"counts {host[:n]} != {want[name]}")
    return sum(want["count_order"])


# Q1 as a distributed query: its sums and count merged across the exchange
# (the means stay with q1_step)
Q1_DISTRIBUTED_AGGS = [(name, agg) for name, agg in Q1_AGGS
                       if agg[1] != "mean"]


def q1_distributed_step(batch: bt.RecordBatch, group: Group,
                        delta_days: int = Q1_DELTA_DAYS) -> bt.RecordBatch:
    """TPC-H Q1 on one rank's part of `lineitem`: the predicate, the filter
    and the prices as `q1_step` computes them, then `distributed_group_by`
    of the flags (the four sums and count_order, partial on every rank,
    merged after the exchange of the partial groups) and the sort by the
    flags."""
    kept = ops.filter_record_batch(
        bt.record_batch({n: batch[n] for n in Q1_READS}),
        q1_predicate(batch, delta_days))
    disc_price, charge = q1_prices(kept)
    grouped = distributed_group_by(
        bt.record_batch({**{n: kept[n] for n in Q1_READS},
                         "disc_price": disc_price, "charge": charge}),
        Q1_KEYS, [agg for _, agg in Q1_DISTRIBUTED_AGGS], group=group)
    names = Q1_KEYS + [name for name, _ in Q1_DISTRIBUTED_AGGS]
    return ops.sort_batch(bt.RecordBatch(st.Schema(tuple(
        st.Field(n, c.dtype) for n, c in zip(names, grouped.columns))),
        grouped.columns), Q1_KEYS)


def lineitem_exchange(batch: bt.RecordBatch, group: Group) -> bt.RecordBatch:
    """`lineitem` hash-partitioned on l_orderkey over the group: the
    shuffle ahead of a lineitem-orders join, every column class of the
    batch through the exchange."""
    return exchange(batch, ["l_orderkey"], group)


def check_same_rows(got: bt.RecordBatch, want: bt.RecordBatch, *,
                    same_dictionary: bool = True) -> int:
    """Raise AssertionError unless `got` holds `want`'s rows in order,
    bit for bit, on the device: the length, every row's validity, values
    (a multi-word value's words, a float's bits), a dictionary's keys and
    its dictionary (the same values object; with `same_dictionary=False`,
    as after a round trip through a file, equal values), a string view's
    bytes, length and len_bound; and zero padding past the length.  -> the
    row count."""
    from .ops.strings import byte_matrix, max_byte_length

    n = want.length
    if got.schema.names != want.schema.names or got.length != n:
        raise AssertionError(f"{got.schema.names} x {got.length} rows, "
                             f"expected {want.schema.names} x {n}")
    for name in want.schema.names:
        g, w = got[name], want[name]
        if g.dtype != w.dtype or g.length != n:
            raise AssertionError(f"{name}: {g.dtype} x {g.length}")
        if not torch.equal(g.valid_bool()[:n], w.valid_bool()[:n]) or (
                g.valid_bool()[n:].any()):
            raise AssertionError(f"{name}: validity differs")
        if isinstance(w, col.DictionaryColumn):
            if g.values is not w.values and (
                    same_dictionary
                    or g.values.to_pylist() != w.values.to_pylist()):
                raise AssertionError(f"{name}: the dictionary was not kept")
            g, w = g.keys, w.keys
        if isinstance(w, col.StringViewColumn):
            L = max_byte_length(w)
            (gm, gl), (wm, wl) = byte_matrix(g, L), byte_matrix(w, L)
            same = (torch.equal(gm[:n], wm[:n]) and torch.equal(gl[:n], wl[:n])
                    and g.len_bound == w.len_bound)
            tail = g.views[n:]
        elif isinstance(w, col.BooleanColumn):
            same = torch.equal(g.values_bool()[:n], w.values_bool()[:n])
            tail = g.values_bool()[n:]
        else:
            gv, wv = g.values, w.values
            if gv.is_floating_point():  # by their bits: NaN, -0.0
                bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
                    gv.element_size()]
                gv, wv = gv.view(bits), wv.view(bits)
            same = torch.equal(gv[:n], wv[:n])
            tail = gv[n:]
        if not same:
            raise AssertionError(f"{name}: rows differ")
        if tail.any():
            raise AssertionError(f"{name}: padding past the length not zero")
    return n


# ---------------------------------------------------------------------------
# lineitem through an Arrow IPC file: untrusted input, validated on the card
# ---------------------------------------------------------------------------


def lineitem_ipc(batch: bt.RecordBatch, rows_per_batch: int,
                 compression: Optional[str] = None, stream: bool = False,
                 sink=None) -> Optional[bytes]:
    """`batch` as an IPC file (or stream) of `rows_per_batch`-row record
    batches, the last one short: bytes, or written to `sink`."""
    from .formats import ipc
    from .ops.coalesce import slice_batch

    parts = [slice_batch(batch, i, rows_per_batch)
             for i in range(0, max(batch.length, 1), rows_per_batch)]
    write = ipc.write_stream if stream else ipc.write_file
    return write(parts, batch.schema, sink, compression=compression)


def read_lineitem_ipc(data, validate: bool = True, device=None
                      ) -> bt.RecordBatch:
    """An IPC file or stream (told apart by the file's magic) read onto
    `device`, every record batch checked by `core/validate.py` when
    `validate`, then concatenated into one batch."""
    from .formats import ipc
    from .ops.concat import concat_batches

    view = memoryview(data)
    read = ipc.read_file if view[:6] == ipc.MAGIC else ipc.read_stream
    return concat_batches(read(view, validate=validate, device=device))


# ---------------------------------------------------------------------------
# config 5's join step on a text key: TPC-H's c_name
# ---------------------------------------------------------------------------

TEXT_KEY_PREFIX = b"Customer#"
TEXT_KEY_DIGITS = 9
TEXT_KEY_BYTES = len(TEXT_KEY_PREFIX) + TEXT_KEY_DIGITS  # 18: out of line


def text_keys(keys: np.ndarray, valid: np.ndarray = None,
              device=None, prefix: bytes = TEXT_KEY_PREFIX
              ) -> col.StringViewColumn:
    """TPC-H's c_name of each key, "Customer#%09d" % k (Clause 4.2.3; 18
    bytes, so every string lives in the arena), or another prefix's
    ("Clerk#%09d", 15 bytes), as a utf8 view column built on `device`: the
    arena holds row i's bytes at width * i; a null key (`valid` False) is a
    null row with a zero view."""
    device = resolve_device(device)
    width = len(prefix) + TEXT_KEY_DIGITS
    k = torch.from_numpy(np.ascontiguousarray(keys, dtype=np.int64)).to(
        device)
    n = k.shape[0]
    cap = round_up(max(n, 1))
    p10 = 10 ** torch.arange(TEXT_KEY_DIGITS - 1, -1, -1, device=device)
    digits = (k[:, None] // p10 % 10 + ord("0")).to(torch.uint8)
    head = torch.tensor(list(prefix), dtype=torch.uint8, device=device)
    rows = torch.cat([head.expand(n, -1), digits], dim=1)
    arena = torch.zeros(round_up(max(n * width, 1)),
                        dtype=torch.uint8, device=device)
    arena[:n * width] = rows.reshape(-1)
    ok = (torch.ones(n, dtype=torch.bool, device=device) if valid is None
          else torch.from_numpy(np.asarray(valid, bool)).to(device))
    views = torch.zeros((cap, 4), dtype=torch.int32, device=device)
    views[:n, 0] = torch.where(ok, width, 0)
    views[:n, 1] = torch.where(ok, rows[:, :4].contiguous().view(
        torch.int32)[:, 0], 0)
    views[:n, 3] = torch.where(ok, torch.arange(
        n, dtype=torch.int32, device=device) * width, 0)
    validity = (None if valid is None or np.asarray(valid).all()
                else bm.from_numpy_bools(np.asarray(valid, bool), cap, device))
    return col.StringViewColumn(views, arena, validity, n, st.utf8, width)


def text_join_batches(shards: Tuple[Arrays, Arrays], device=None
                      ) -> Tuple[bt.RecordBatch, bt.RecordBatch]:
    """`example_join_shards`' probe and build shards with k carried as
    its text (`text_keys`) on both sides and rv as a Decimal128(15, 2)
    (rv / 100): -> (probe {k, v}, build {k, rv})."""
    device = resolve_device(device)
    left, right = shards
    (k, k_ok), (v, v_ok) = left["k"], left["v"]
    (bk, bk_ok), (rv, rv_ok) = right["k"], right["rv"]
    return (bt.record_batch({"k": text_keys(k, k_ok, device),
                             "v": column_from_numpy(v, v_ok, len(v),
                                                    device=device)}),
            bt.record_batch({"k": text_keys(bk, bk_ok, device),
                             "rv": decimal_from_int64(rv, DECIMAL_15_2,
                                                      rv_ok, device)}))


def _text_output_as_ints(out: bt.RecordBatch) -> bt.RecordBatch:
    """A text join step's output with k read back to its integer (the
    strings checked to be "Customer#" and nine digits) and sum_rv's
    Decimal128 limbs to the int64 it holds (checked to sign-extend)."""
    from .ops.strings import byte_matrix

    n = out.length
    kc, sc = out["k"], out["sum_rv"]
    mat, lens = byte_matrix(kc, 32)
    live = kc.valid_bool()[:n]
    body = mat[:n, :TEXT_KEY_BYTES]
    prefix = torch.tensor(list(TEXT_KEY_PREFIX), dtype=torch.uint8,
                          device=mat.device)
    digits = body[:, len(TEXT_KEY_PREFIX):].to(torch.int64) - ord("0")
    good = ((lens[:n] == TEXT_KEY_BYTES)
            & (body[:, :len(TEXT_KEY_PREFIX)] == prefix).all(dim=1)
            & ((digits >= 0) & (digits <= 9)).all(dim=1))
    if not bool((good | ~live).all()):
        raise AssertionError("a group key is not Customer# and nine digits")
    p10 = 10 ** torch.arange(TEXT_KEY_DIGITS - 1, -1, -1,
                             device=mat.device)
    keys = torch.zeros(kc.capacity, dtype=torch.int64, device=mat.device)
    keys[:n] = torch.where(live, (digits * p10).sum(dim=1), 0)
    limbs = sc.values
    low = limbs[:, :2].contiguous().view(torch.int64)[:, 0]
    sign = torch.where(low < 0, -1, 0).to(torch.int32)[:, None]
    if not bool((limbs[:, 2:] == sign).all()):
        raise AssertionError("a sum does not fit int64")
    return bt.record_batch({
        "k": col.PrimitiveColumn(keys, kc.validity, n, st.int64),
        "sum_rv": col.PrimitiveColumn(low.clone(), sc.validity, n, st.int64),
        "count_rv": out["count_rv"]})


def check_text_join_output(outputs: Sequence[bt.RecordBatch], want) -> int:
    """`check_join_output` for `join_step` on `text_join_batches`: each
    rank's text keys read back to their integers and its decimal sums to
    integers of cents, then held to `join_oracle` exactly.  -> the number
    of groups."""
    for out in outputs:
        if (out.schema.field("k").dtype != st.utf8
                or out.schema.field("sum_rv").dtype != st.Decimal128(38, 2)):
            raise AssertionError(f"output types {out.schema}")
    return check_join_output([_text_output_as_ints(o) for o in outputs],
                             want)


# ---------------------------------------------------------------------------
# TPC-H part, and Q14 and Q19 over lineitem ⋈ part: the predicate layer
# ---------------------------------------------------------------------------

# Clause 4.2.2.13's lists
PART_COLOURS = (
    "almond antique aquamarine azure beige bisque black blanched blue blush "
    "brown burlywood burnished chartreuse chiffon chocolate coral "
    "cornflower cornsilk cream cyan dark deep dim dodger drab firebrick "
    "floral forest frosted gainsboro ghost goldenrod green grey honeydew "
    "hot indian ivory khaki lace lavender lawn lemon light lime linen "
    "magenta maroon medium metallic midnight mint misty moccasin navajo "
    "navy olive orange orchid pale papaya peach peru pink plum powder puff "
    "purple red rose rosy royal saddle salmon sandy seashell sienna sky "
    "slate smoke snow spring steel tan thistle tomato turquoise violet "
    "wheat white yellow").split()
PART_TYPE_SYLLABLES = (
    ("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"),
    ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"),
    ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER"))
PART_CONTAINER_SYLLABLES = (
    ("SM", "LG", "MED", "JUMBO", "WRAP"),
    ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"))
# each string column's words, indexed by the code `example_part_arrays`
# draws: type (s1 * 25 + s2 * 5 + s3), container (s1 * 8 + s2), brand
# ((M - 1) * 5 + N - 1; the manufacturer is M)
PART_TYPES = [f"{a} {b} {c}" for a in PART_TYPE_SYLLABLES[0]
              for b in PART_TYPE_SYLLABLES[1] for c in PART_TYPE_SYLLABLES[2]]
PART_CONTAINERS = [f"{a} {b}" for a in PART_CONTAINER_SYLLABLES[0]
                   for b in PART_CONTAINER_SYLLABLES[1]]
PART_BRANDS = [f"Brand#{m}{n}" for m in range(1, 6) for n in range(1, 6)]
PART_MFGRS = [f"Manufacturer#{m}" for m in range(1, 6)]
PART_COLUMNS = ["p_partkey", "p_name", "p_mfgr", "p_brand", "p_type",
                "p_size", "p_container", "p_retailprice", "p_comment"]
# the coded string columns: (name, words)
PART_WORDS = {"p_mfgr": PART_MFGRS, "p_brand": PART_BRANDS,
              "p_type": PART_TYPES, "p_container": PART_CONTAINERS}


def _word_pool(words: Sequence[str]):
    """-> (the words' bytes back to back, each word's start, its length)."""
    raw = [w.encode() for w in words]
    lens = np.array([len(w) for w in raw], np.int64)
    return (np.frombuffer(b"".join(raw), np.uint8),
            np.cumsum(lens) - lens, lens)


def _distinct_draws(rng, n: int, k: int, m: int) -> np.ndarray:
    """(n, k) int: k distinct values of [0, m) a row, uniform, with no loop
    over rows: the j-th draw is uniform over the m - j values left, then
    stepped past the smaller draws already taken."""
    out = np.zeros((n, k), np.int64)
    for j in range(k):
        r = rng.integers(0, m - j, n)
        for taken in np.sort(out[:, :j], axis=1).T:
            r += r >= taken
        out[:, j] = r
    return out


def _name_strings(words: np.ndarray):
    """(n, 5) colour indices -> (bytes, starts, lengths) of the names, the
    five words joined by spaces (vectorized over rows)."""
    pool, wstart, wlen = _word_pool(PART_COLOURS)
    lens = wlen[words]  # (n, 5)
    row_len = lens.sum(axis=1) + words.shape[1] - 1
    starts = np.cumsum(row_len) - row_len
    buf = np.full(int(row_len.sum()), ord(" "), np.uint8)
    at = starts.copy()
    for j in range(words.shape[1]):
        for c in range(int(wlen.max())):
            ok = lens[:, j] > c
            buf[at[ok] + c] = pool[wstart[words[ok, j]] + c]
        at += lens[:, j] + 1
    return buf, starts, row_len


def example_part_arrays(sf: float = 1.0, seed: int = 7) -> dict:
    """part at scale factor `sf` by TPC-H Clause 4.2.3, drawn in numpy with
    no loop over rows: p_partkey 1..sf x 200,000; p_name five distinct
    colours of Clause 4.2.2.13 joined by spaces; manufacturer M and brand
    N in 1..5; a type and a container from the syllable lists; size
    1..50; the retail price (90000 + (key / 10) % 20001 + 100 x (key %
    1000)) cents, the formula `example_lineitem_arrays` prices with; a
    5-22 byte comment from a text pool.  -> {name: array}: the key, the
    size and the price in cents as arrays, p_mfgr / p_brand / p_type /
    p_container as codes into their word lists (`PART_WORDS`), p_name and
    p_comment as (bytes, starts, lengths)."""
    rng = np.random.default_rng(seed)
    n = int(sf * 200_000)
    key = np.arange(1, n + 1, dtype=np.int64)
    mfgr = rng.integers(0, 5, n, dtype=np.int64)
    brand = mfgr * 5 + rng.integers(0, 5, n, dtype=np.int64)
    ptype = rng.integers(0, len(PART_TYPES), n, dtype=np.int64)
    container = rng.integers(0, len(PART_CONTAINERS), n, dtype=np.int64)
    size = rng.integers(1, 51, n, dtype=np.int32)
    names = _name_strings(_distinct_draws(rng, n, 5, len(PART_COLOURS)))
    pool_bytes = 22 * n + 64
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)
    pool = letters[rng.integers(0, 27, pool_bytes, dtype=np.uint8)]
    clen = rng.integers(5, 23, n, dtype=np.int32)
    cstart = (rng.random(n) * (pool_bytes - clen)).astype(np.int64)
    return {"p_partkey": key, "p_name": names, "p_mfgr": mfgr,
            "p_brand": brand, "p_type": ptype, "p_size": size,
            "p_container": container,
            "p_retailprice": 90_000 + (key // 10) % 20_001 + 100 * (
                key % 1000),
            "p_comment": (pool, cstart, clen)}


def part_strings(arrays: dict, name: str) -> Tuple[np.ndarray, np.ndarray,
                                                    np.ndarray]:
    """A part string column's (bytes, starts, lengths): a coded column's
    rows point into its word pool."""
    if name in PART_WORDS:
        pool, wstart, wlen = _word_pool(PART_WORDS[name])
        codes = arrays[name]
        return pool, wstart[codes], wlen[codes]
    return arrays[name]


def part_batch(arrays: dict, device=None) -> bt.RecordBatch:
    """The 9-column part batch (NOT NULL): int64 key, the strings as utf8
    views (over their word pools, or the names' and comments' bytes), an
    int32 size, a Decimal128(15, 2) retail price."""
    device = resolve_device(device)
    cols = {}
    for name in PART_COLUMNS:
        if name == "p_partkey":
            cols[name] = col.primitive(
                torch.from_numpy(arrays[name]).to(device))
        elif name == "p_size":
            cols[name] = col.primitive(
                torch.from_numpy(arrays[name]).to(device), st.int32)
        elif name == "p_retailprice":
            cols[name] = decimal_from_int64(arrays[name], DECIMAL_15_2,
                                            device=device)
        else:
            cols[name] = string_view_from_numpy(*part_strings(arrays, name),
                                                device=device)
    return bt.record_batch(cols)


def _disc_price(batch: bt.RecordBatch):
    """l_extendedprice * (1 - l_discount) through `ops.numeric` (the
    decimal on the right of the `sub`): Decimal128(32, 4)."""
    return ops.mul(batch["l_extendedprice"], ops.sub(1, batch["l_discount"]))


def _month_range(date: str) -> Tuple[int, int]:
    lo = np.datetime64(date, "D")
    hi = (lo.astype("datetime64[M]") + 1).astype("datetime64[D]") + (
        lo - lo.astype("datetime64[M]").astype("datetime64[D]"))
    return int(lo.astype(np.int64)), int(hi.astype(np.int64))


def _sum_decimal(c: col.PrimitiveColumn) -> _pydec.Decimal:
    from .ops import decimal as dec

    limbs, _ = dec.sum_(c)
    return dec.to_decimal(limbs, c.dtype.scale)


Q14_DATE = "1995-09-01"  # the validation value of Clause 2.4.14.3
Q14_READS = ("l_partkey", "l_extendedprice", "l_discount")


def q14_predicate(lineitem: bt.RecordBatch, date: str = Q14_DATE
                  ) -> col.BooleanColumn:
    lo, hi = _month_range(date)
    ship = lineitem["l_shipdate"]
    return ops.and_kleene(ops.gt_eq(ship, lo), ops.lt(ship, hi))


def q14_step(lineitem: bt.RecordBatch, part: bt.RecordBatch,
             date: str = Q14_DATE) -> dict:
    """TPC-H Q14 (Clause 2.4.14, the promotion effect): the month's
    lineitem rows (`filter_record_batch` of the three columns the query
    reads), `hash_join` with part (the build side) on l_partkey =
    p_partkey, disc_price = l_extendedprice * (1 - l_discount) by
    `ops.numeric`, promo = zip_(p_type LIKE 'PROMO%', disc_price, 0), and
    their exact sums.  -> {"rows": the joined rows, "promo" and "total":
    the sums (Decimal, scale 4), "promo_revenue": 100.00 * promo / total
    as a Decimal (40 digits)}."""
    kept = ops.filter_record_batch(
        bt.record_batch({n: lineitem[n] for n in Q14_READS}),
        q14_predicate(lineitem, date))
    joined, _ = ops.hash_join(
        kept, bt.record_batch({n: part[n] for n in ("p_partkey", "p_type")}),
        ["l_partkey"], right_on=["p_partkey"])
    disc_price = _disc_price(joined)
    promo = ops.zip_(ops.like(joined["p_type"], "PROMO%"), disc_price, 0)
    return _q14_result(joined.length, _sum_decimal(promo),
                       _sum_decimal(disc_price))


def _q14_result(rows: int, promo: _pydec.Decimal, total: _pydec.Decimal
                ) -> dict:
    with _pydec.localcontext(_pydec.Context(prec=40)):
        share = (_pydec.Decimal("100.00") * promo / total if total
                 else None)
    return {"rows": rows, "promo": promo, "total": total,
            "promo_revenue": share}


def q14_oracle(lineitem: dict, part: dict, date: str = Q14_DATE) -> dict:
    """Q14 in numpy on the integer cents (each part is row key - 1, as
    `example_part_arrays` numbers them): q14_step's result."""
    lo, hi = _month_range(date)
    ship = lineitem["l_shipdate"]
    mask = (ship >= lo) & (ship < hi)
    pk = lineitem["l_partkey"][mask]
    if not np.array_equal(part["p_partkey"][pk - 1], pk):
        raise AssertionError("a part key is not its row + 1")
    price = lineitem["l_extendedprice"][mask] * (
        100 - lineitem["l_discount"][mask])
    promo_type = PART_TYPE_SYLLABLES[0].index("PROMO")
    promo = (part["p_type"][pk - 1] // 25) == promo_type
    return _q14_result(int(mask.sum()),
                       _pydec.Decimal(int(price[promo].sum())).scaleb(-4),
                       _pydec.Decimal(int(price.sum())).scaleb(-4))


# Clause 2.4.19.3's validation parameters: (brand, containers, quantity,
# the largest size) of each branch; both branches' ship modes and
# instruction.  'AIR REG' is kept as the query writes it: dbgen's mode is
# 'REG AIR', so only 'AIR' matches.
Q19_BRANCHES = (
    ("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"), 1, 5),
    ("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"), 10, 10),
    ("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"), 20, 15))
Q19_SHIPMODES = ("AIR", "AIR REG")
Q19_SHIPINSTRUCT = "DELIVER IN PERSON"
Q19_LINEITEM = ("l_partkey", "l_quantity", "l_extendedprice", "l_discount",
                "l_shipmode", "l_shipinstruct")
Q19_PART = ("p_partkey", "p_brand", "p_container", "p_size")


def _all(terms):
    mask = terms[0]
    for t in terms[1:]:
        mask = ops.and_kleene(mask, t)
    return mask


def _any(terms, op=None):
    op = op or ops.or_kleene
    mask = terms[0]
    for t in terms[1:]:
        mask = op(mask, t)
    return mask


def _between(c, lo, hi):
    return ops.and_kleene(ops.gt_eq(c, lo), ops.lt_eq(c, hi))


def q19_lineitem_predicate(batch: bt.RecordBatch) -> col.BooleanColumn:
    """The lineitem-only conjuncts, pushed down: l_shipmode IN (...) and
    l_shipinstruct = ... by `like` on the dictionaries (evaluated once per
    dictionary value), l_quantity in [1, 30], the union of the branches'
    ranges, by decimal compares."""
    lo = min(q for _, _, q, _ in Q19_BRANCHES)
    hi = max(q for _, _, q, _ in Q19_BRANCHES) + 10
    mode = _any([ops.like(batch["l_shipmode"], m) for m in Q19_SHIPMODES],
                ops.or_)
    return _all([mode, ops.like(batch["l_shipinstruct"], Q19_SHIPINSTRUCT),
                 _between(batch["l_quantity"], lo, hi)])


def _part_branch(batch, brand, containers, size):
    inside = _any([ops.like(batch["p_container"], c) for c in containers],
                  ops.or_)
    return _all([ops.like(batch["p_brand"], brand), inside,
                 _between(batch["p_size"], 1, size)])


def q19_part_predicate(batch: bt.RecordBatch) -> col.BooleanColumn:
    """The part-only disjunction, pushed down: or_kleene of the three
    branches' and_kleene chains (p_brand by `like`'s eq matcher,
    p_container IN (...) by `or_` of eq matches, p_size BETWEEN)."""
    return _any([_part_branch(batch, b, cs, s)
                 for b, cs, _, s in Q19_BRANCHES])


def q19_joined_predicate(batch: bt.RecordBatch) -> col.BooleanColumn:
    """The whole three-way predicate on joined rows (its key equality
    holds by the join)."""
    mode = _any([ops.like(batch["l_shipmode"], m) for m in Q19_SHIPMODES],
                ops.or_)
    common = ops.and_kleene(
        mode, ops.like(batch["l_shipinstruct"], Q19_SHIPINSTRUCT))
    return ops.and_kleene(common, _any([
        ops.and_kleene(_part_branch(batch, b, cs, s),
                       _between(batch["l_quantity"], q, q + 10))
        for b, cs, q, s in Q19_BRANCHES]))


def q19_step(lineitem: bt.RecordBatch, part: bt.RecordBatch) -> dict:
    """TPC-H Q19 (Clause 2.4.19, discounted revenue), planned as usual:
    the lineitem and part conjuncts pushed down as one filter each, the
    `hash_join` (part the build side), the whole predicate again on the
    joined rows, and the exact sum of l_extendedprice * (1 - l_discount).
    -> {"rows": joined rows, "kept": rows passing the whole predicate,
    "revenue": Decimal, scale 4}."""
    li = ops.filter_record_batch(
        bt.record_batch({n: lineitem[n] for n in Q19_LINEITEM}),
        q19_lineitem_predicate(lineitem))
    pa = ops.filter_record_batch(
        bt.record_batch({n: part[n] for n in Q19_PART}),
        q19_part_predicate(part))
    joined, _ = ops.hash_join(li, pa, ["l_partkey"], right_on=["p_partkey"])
    kept = ops.filter_record_batch(joined, q19_joined_predicate(joined))
    return {"rows": joined.length, "kept": kept.length,
            "revenue": _sum_decimal(_disc_price(kept))}


def q19_oracle(lineitem: dict, part: dict) -> dict:
    """Q19 in numpy on codes and integer cents: q19_step's result."""
    modes = [SHIPMODE.index(m) for m in Q19_SHIPMODES if m in SHIPMODE]
    qty = lineitem["l_quantity"]
    lmask = (np.isin(lineitem["l_shipmode"], modes)
             & (lineitem["l_shipinstruct"]
                == SHIPINSTRUCT.index(Q19_SHIPINSTRUCT))
             & (qty >= 100) & (qty <= 3000))
    pk = lineitem["l_partkey"][lmask]
    q = qty[lmask]
    row = pk - 1
    brand, cont, size = (part[n][row] for n in ("p_brand", "p_container",
                                                "p_size"))
    pmask = np.zeros(len(part["p_partkey"]), bool)
    whole = np.zeros(len(pk), bool)
    for b, cs, qlo, smax in Q19_BRANCHES:
        codes = [PART_CONTAINERS.index(c) for c in cs]
        branch = lambda br, co, sz: ((br == PART_BRANDS.index(b))  # noqa
                                     & np.isin(co, codes) & (sz >= 1)
                                     & (sz <= smax))
        pmask |= branch(part["p_brand"], part["p_container"], part["p_size"])
        whole |= (branch(brand, cont, size) & (q >= qlo * 100)
                  & (q <= (qlo + 10) * 100))
    price = (lineitem["l_extendedprice"][lmask]
             * (100 - lineitem["l_discount"][lmask]))
    return {"rows": int(pmask[row].sum()), "kept": int(whole.sum()),
            "revenue": _pydec.Decimal(int(price[whole].sum())).scaleb(-4)}


def check_query(got: dict, want: dict, name: str) -> dict:
    """Raise unless every entry of a query step's result equals the
    oracle's."""
    for key, value in want.items():
        if got[key] != value:
            raise AssertionError(f"{name}: {key} {got[key]} != oracle "
                                 f"{value}")
    return got


# ---------------------------------------------------------------------------
# TPC-H Q3 over customer, orders and lineitem; the external sort
# ---------------------------------------------------------------------------

ORDER_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
                    "5-LOW"]
MKTSEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD",
               "MACHINERY"]
ORDERS_COLUMNS = ["o_orderkey", "o_custkey", "o_orderstatus", "o_totalprice",
                  "o_orderdate", "o_orderpriority", "o_clerk",
                  "o_shippriority", "o_comment"]
CUSTOMER_COLUMNS = ["c_custkey", "c_name", "c_address", "c_nationkey",
                    "c_phone", "c_acctbal", "c_mktsegment", "c_comment"]
ORDER_STATUS = b"FOP"
CLERK_PREFIX = b"Clerk#"
TEXT_LETTERS = b"abcdefghijklmnopqrstuvwxyz "
ADDRESS_LETTERS = (b"0123456789abcdefghijklmnopqrstuvwxyz"
                   b"ABCDEFGHIJKLMNOPQRSTUVWXYZ ,")


def _pool_strings(rng, n: int, lo: int, hi: int, letters: bytes) -> tuple:
    """n strings of lo..hi bytes, each a substring of one pool of random
    `letters` (as dbgen takes its text): (pool, starts, lengths)."""
    pool_bytes = min(TEXT_POOL_BYTES, hi * n + 64)
    alphabet = np.frombuffer(letters, np.uint8)
    pool = alphabet[rng.integers(0, len(alphabet), pool_bytes,
                                 dtype=np.uint8)]
    lens = rng.integers(lo, hi + 1, n, dtype=np.int32)
    starts = (rng.random(n) * (pool_bytes - lens)).astype(np.int64)
    return pool, starts, lens


def example_orders_arrays(sf: float = 1.0, seed: int = 6,
                          lineitem: dict = None) -> dict:
    """TPC-H's `orders` at scale factor `sf` by Clause 4.2.3, in numpy with
    no loop over rows, for the lineitem of `example_lineitem_arrays(sf,
    seed)`: the order keys and dates are that generator's (its first two
    draws replayed from `seed`), so every l_orderkey finds its order and
    l_shipdate > o_orderdate.  o_orderstatus is F where all of the order's
    lines have l_linestatus F, O where all have O, else P; o_totalprice is
    the exact sum of l_extendedprice * (100 + l_tax) * (100 - l_discount)
    over its lines (cents x 10**4), rounded half up to cents.  Both come
    from `lineitem` (drawn here when None).  The rest from a second
    generator: o_custkey in [1, sf x 150,000], never a multiple of 3 (a
    third of the customers have no order, as dbgen does it), the priority
    uniform over the five, o_clerk "Clerk#%09d" over [1, sf x 1,000],
    o_shippriority 0, o_comment 19-78 bytes of one text pool.  -> {name:
    array}: the status as codes into "FOP", the priority as codes, the
    clerk as its number, the comment as (pool, starts, lengths)."""
    rng = np.random.default_rng(seed)
    orders = int(1_500_000 * sf)
    lines = rng.integers(1, 8, orders, dtype=np.int8)
    start, end = _days("1992-01-01"), _days("1998-12-31") - 151
    odate = rng.integers(start, end + 1, orders, dtype=np.int32)
    if lineitem is None:
        lineitem = example_lineitem_arrays(sf, seed)
    ends = np.cumsum(lines, dtype=np.int64)
    firsts = ends - lines
    shipped = np.add.reduceat(lineitem["l_linestatus"].astype(np.int64),
                              firsts)
    status = np.where(shipped == lines, 0, np.where(shipped == 0, 1, 2))
    price = (lineitem["l_extendedprice"] * (100 + lineitem["l_tax"])
             * (100 - lineitem["l_discount"]))
    total = (np.add.reduceat(price, firsts) + 5_000) // 10_000
    ids = np.arange(orders, dtype=np.int64)
    more = np.random.default_rng((seed, 4))
    customers = int(sf * 150_000)
    u = more.integers(0, customers - customers // 3, orders, dtype=np.int64)
    return {
        "o_orderkey": ids // 8 * 32 + ids % 8 + 1,
        "o_custkey": u // 2 * 3 + u % 2 + 1,
        "o_orderstatus": status.astype(np.int8),
        "o_totalprice": total,
        "o_orderdate": odate,
        "o_orderpriority": more.integers(0, len(ORDER_PRIORITIES), orders,
                                         dtype=np.int32),
        "o_clerk": more.integers(1, max(int(sf * 1_000), 1) + 1, orders,
                                 dtype=np.int64),
        "o_shippriority": np.zeros(orders, np.int32),
        "o_comment": _pool_strings(more, orders, 19, 78, TEXT_LETTERS)}


def orders_batch(arrays: dict, device=None) -> bt.RecordBatch:
    """The nine-column orders batch (NOT NULL): int64 keys, the status as
    a one-letter utf8 view, o_totalprice a Decimal128(15, 2), o_orderdate
    a Date32, the priority a dictionary of utf8, o_clerk and o_comment
    utf8 views, o_shippriority int32."""
    device = resolve_device(device)
    n = len(arrays["o_orderkey"])
    status = np.frombuffer(ORDER_STATUS, np.uint8)
    return bt.record_batch({
        "o_orderkey": col.primitive(torch.from_numpy(
            arrays["o_orderkey"]).to(device)),
        "o_custkey": col.primitive(torch.from_numpy(
            arrays["o_custkey"]).to(device)),
        "o_orderstatus": string_view_from_numpy(
            status, arrays["o_orderstatus"].astype(np.int64),
            np.ones(n, np.int32), device=device),
        "o_totalprice": decimal_from_int64(arrays["o_totalprice"],
                                           DECIMAL_15_2, device=device),
        "o_orderdate": col.primitive(torch.from_numpy(
            arrays["o_orderdate"]).to(device), st.Date32()),
        "o_orderpriority": _words_dictionary(arrays["o_orderpriority"],
                                             ORDER_PRIORITIES, device),
        "o_clerk": text_keys(arrays["o_clerk"], device=device,
                             prefix=CLERK_PREFIX),
        "o_shippriority": col.primitive(torch.from_numpy(
            arrays["o_shippriority"]).to(device)),
        "o_comment": string_view_from_numpy(*arrays["o_comment"],
                                            device=device)})


def example_customer_arrays(sf: float = 1.0, seed: int = 6) -> dict:
    """TPC-H's `customer` at scale factor `sf` by Clause 4.2.3 (sf x
    150,000 rows), in numpy with no loop over rows: c_custkey 1..n; c_name
    "Customer#%09d" of the key (built by `text_keys`); c_address 10-40
    bytes and c_comment 29-116 bytes, each a substring of a pool;
    c_nationkey in [0, 24]; c_phone "CC-NNN-NNN-NNNN" with CC = nationkey
    + 10; c_acctbal in [-999.99, 9999.99] (cents); c_mktsegment uniform
    over the five segments (codes).  -> {name: array}; the strings as
    (pool, starts, lengths)."""
    rng = np.random.default_rng((seed, 3))
    n = int(sf * 150_000)
    nation = rng.integers(0, 25, n, dtype=np.int64)
    digits = rng.integers(0, 10, (n, 10), dtype=np.uint8) + ord("0")
    phone = np.full((n, 15), ord("-"), np.uint8)
    phone[:, 0] = (nation + 10) // 10 + ord("0")
    phone[:, 1] = (nation + 10) % 10 + ord("0")
    phone[:, [3, 4, 5, 7, 8, 9, 11, 12, 13, 14]] = digits
    return {
        "c_custkey": np.arange(1, n + 1, dtype=np.int64),
        "c_address": _pool_strings(rng, n, 10, 40, ADDRESS_LETTERS),
        "c_nationkey": nation,
        "c_phone": (phone.reshape(-1), np.arange(n, dtype=np.int64) * 15,
                    np.full(n, 15, np.int32)),
        "c_acctbal": rng.integers(-99_999, 1_000_000, n, dtype=np.int64),
        "c_mktsegment": rng.integers(0, len(MKTSEGMENTS), n, dtype=np.int32),
        "c_comment": _pool_strings(rng, n, 29, 116, TEXT_LETTERS)}


def customer_batch(arrays: dict, device=None) -> bt.RecordBatch:
    """The eight-column customer batch (NOT NULL): int64 keys, utf8 views,
    c_acctbal a Decimal128(15, 2), c_mktsegment a dictionary of utf8."""
    device = resolve_device(device)
    return bt.record_batch({
        "c_custkey": col.primitive(torch.from_numpy(
            arrays["c_custkey"]).to(device)),
        "c_name": text_keys(arrays["c_custkey"], device=device),
        "c_address": string_view_from_numpy(*arrays["c_address"],
                                            device=device),
        "c_nationkey": col.primitive(torch.from_numpy(
            arrays["c_nationkey"]).to(device)),
        "c_phone": string_view_from_numpy(*arrays["c_phone"], device=device),
        "c_acctbal": decimal_from_int64(arrays["c_acctbal"], DECIMAL_15_2,
                                        device=device),
        "c_mktsegment": _words_dictionary(arrays["c_mktsegment"],
                                          MKTSEGMENTS, device),
        "c_comment": string_view_from_numpy(*arrays["c_comment"],
                                            device=device)})


# Clause 2.4.3.3's validation parameters
Q3_SEGMENT, Q3_DATE = "BUILDING", "1995-03-15"
Q3_CUSTOMER = ("c_custkey",)
Q3_ORDERS = ("o_orderkey", "o_custkey", "o_orderdate", "o_shippriority")
Q3_LINEITEM = ("l_orderkey", "l_extendedprice", "l_discount")
Q3_KEYS = ["l_orderkey", "o_orderdate", "o_shippriority"]
Q3_LIMIT = 10


def _pick(batch: bt.RecordBatch, names) -> bt.RecordBatch:
    return bt.record_batch({n: batch[n] for n in names})


def q3_filters(customer: bt.RecordBatch, orders: bt.RecordBatch,
               lineitem: bt.RecordBatch, segment: str = Q3_SEGMENT,
               date: str = Q3_DATE):
    """Q3's three pushed-down filters: customer on c_mktsegment = segment
    (`like` on the dictionary: one match a dictionary value), orders on
    o_orderdate < date, lineitem on l_shipdate > date, each the columns
    the query reads."""
    day = _days(date)
    return (ops.filter_record_batch(_pick(customer, Q3_CUSTOMER), ops.like(
                customer["c_mktsegment"], segment)),
            ops.filter_record_batch(_pick(orders, Q3_ORDERS),
                                    ops.lt(orders["o_orderdate"], day)),
            ops.filter_record_batch(_pick(lineitem, Q3_LINEITEM),
                                    ops.gt(lineitem["l_shipdate"], day)))


def q3_joins(cust: bt.RecordBatch, ords: bt.RecordBatch,
             li: bt.RecordBatch) -> bt.RecordBatch:
    """customer ⋈ orders on custkey (customer the build side), then
    lineitem ⋈ that on orderkey (the orders side the build side)."""
    co, _ = ops.hash_join(ords, cust, ["o_custkey"], right_on=["c_custkey"])
    joined, _ = ops.hash_join(li, co, ["l_orderkey"],
                              right_on=["o_orderkey"])
    return joined


def q3_group(joined: bt.RecordBatch) -> bt.RecordBatch:
    """revenue = l_extendedprice * (1 - l_discount) through `ops.numeric`
    (a Decimal128(32, 4)), summed by (l_orderkey, o_orderdate,
    o_shippriority): the Date32 key on the sort pipeline."""
    revenue = _disc_price(joined)
    return gb.group_by(bt.record_batch({
        **{k: joined[k] for k in Q3_KEYS}, "revenue": revenue}),
        Q3_KEYS, [("revenue", "sum")])


def q3_top(grouped: bt.RecordBatch) -> bt.RecordBatch:
    """ORDER BY revenue DESC, o_orderdate LIMIT 10."""
    from .config import SortOptions

    return ops.sort_batch(grouped, ["sum_revenue", "o_orderdate"],
                          [SortOptions(descending=True), SortOptions()],
                          limit=Q3_LIMIT)


def q3_step(customer: bt.RecordBatch, orders: bt.RecordBatch,
            lineitem: bt.RecordBatch, segment: str = Q3_SEGMENT,
            date: str = Q3_DATE) -> dict:
    """TPC-H Q3 (Clause 2.4.3): the three filters, the two joins, the
    revenue and its group-by, the top ten.  -> {"joined": rows joined,
    "groups": groups, "top": the ten rows (l_orderkey, o_orderdate,
    o_shippriority, sum_revenue)}."""
    grouped = q3_group(q3_joins(*q3_filters(customer, orders, lineitem,
                                            segment, date)))
    return {"groups": grouped.length, "top": q3_top(grouped)}


def q3_oracle(customer: dict, orders: dict, lineitem: dict,
              segment: str = Q3_SEGMENT, date: str = Q3_DATE) -> dict:
    """Q3 in numpy on codes and integer units of 10**-4 (each order's
    lines sum into its row: an order key maps back to its row, each
    customer key is its row + 1).  -> {"groups", "top": {column: array of
    the first ten rows}, "tied": the (key, date, priority, revenue) rows
    that tie with the tenth on (revenue, date), as a set}."""
    day = _days(date)
    building = customer["c_mktsegment"] == MKTSEGMENTS.index(segment)
    okeys = orders["o_orderkey"]
    order_ok = (orders["o_orderdate"] < day) & building[
        orders["o_custkey"] - 1]
    lk = lineitem["l_orderkey"]
    row = (lk - 1) // 32 * 8 + (lk - 1) % 32
    if not np.array_equal(okeys[row], lk):
        raise AssertionError("an order key is not at its row")
    line_ok = (lineitem["l_shipdate"] > day) & order_ok[row]
    revenue = np.zeros(len(okeys), np.int64)
    np.add.at(revenue, row[line_ok], lineitem["l_extendedprice"][line_ok]
              * (100 - lineitem["l_discount"][line_ok]))
    groups = np.flatnonzero(revenue)
    rev, odate = revenue[groups], orders["o_orderdate"][groups]
    order = np.lexsort((odate, -rev))
    top = groups[order[:Q3_LIMIT]]

    def rows(ix):
        return {"l_orderkey": okeys[ix], "o_orderdate":
                orders["o_orderdate"][ix], "o_shippriority":
                orders["o_shippriority"][ix], "sum_revenue": revenue[ix]}

    tied = set()
    if len(top) == Q3_LIMIT:
        last = top[-1]
        same = groups[(rev == revenue[last]) & (odate == orders[
            "o_orderdate"][last])]
        tied = set(zip(*[v.tolist() for v in rows(same).values()]))
    return {"groups": int(len(groups)), "top": rows(top), "tied": tied}


def check_q3(got: dict, want: dict) -> dict:
    """Raise unless q3_step's result equals the oracle's: the group count
    and the ten rows in order, exactly; rows that tie with the tenth on
    (revenue, date) are compared as a set (any of them may come last)."""
    from .core import limbs as lb

    if got["groups"] != want["groups"]:
        raise AssertionError(f"Q3: {got['groups']} groups != oracle "
                             f"{want['groups']}")
    top = got["top"]
    units = lb.join_ints(top["sum_revenue"].values[:top.length].cpu().numpy())
    have = list(zip(*[top[k].values[:top.length].cpu().tolist()
                      for k in Q3_KEYS], units))
    wanted = list(zip(*[want["top"][k].tolist() for k in Q3_KEYS
                        + ["sum_revenue"]]))
    if len(have) != len(wanted) or any(
            top[k].null_count() for k in Q3_KEYS + ["sum_revenue"]):
        raise AssertionError(f"Q3: {len(have)} rows (or nulls) != oracle "
                             f"{len(wanted)}")
    for i, (h, w) in enumerate(zip(have, wanted)):
        if h != w and not (h in want["tied"] and w in want["tied"]):
            raise AssertionError(f"Q3: row {i} {h} != oracle {w}")
    return {"groups": got["groups"], "rows": have,
            "tied_with_tenth": len(want["tied"])}


def sorted_runs_step(batch: bt.RecordBatch, by: Sequence[str],
                     options=None, runs: int = 8):
    """An ORDER BY over a table larger than a batch, as an external sort
    runs it: the batch cut into `runs` slices (`slice_batch`), each sorted
    (`sort_batch`), then the sorted runs merged (`merge_batches`).  ->
    (the merged batch, {"slices": the runs as cut, "sorted": each run
    sorted}) for timing the stages."""
    n = batch.length
    size = -(-n // runs)
    slices = [ops.slice_batch(batch, i * size, size) for i in range(runs)]
    ordered = [ops.sort_batch(s, by, options) for s in slices]
    return (ops.merge_batches(ordered, by, options),
            {"slices": slices, "sorted": ordered})


# ---------------------------------------------------------------------------
# ClickBench's `hits`: uint64 and the whole-column aggregates
# ---------------------------------------------------------------------------

HITS_ROWS = 99_997_497  # the published table
# the published table's distinct UserIDs; a smaller draw keeps the ratio
HITS_USERS = 17_630_976
HITS_REGIONS = 4_000
HITS_COLUMNS = ["UserID", "RegionID", "ResolutionWidth", "AdvEngineID",
                "EventDate"]
HITS_TYPES = {"UserID": st.uint64, "RegionID": st.uint32,
              "ResolutionWidth": st.uint16, "AdvEngineID": st.uint8,
              "EventDate": st.Date32()}
HITS_ADV_SHARE = 0.006  # rows with an AdvEngineID other than 0
HITS_ADV_ENGINES = 30
HITS_WIDTHS = [1366, 1920, 1280, 1024, 1600, 1440, 1536, 1680, 1360, 1400,
               1152, 1280, 2560, 800, 1093, 1344, 1050, 1200, 360, 320,
               375, 414, 768, 980, 1138, 1903, 1097, 1855, 2048, 1017]
HITS_FIRST_DAY = "2013-07-01"
HITS_DAYS = 31
CLICKBENCH_QUERIES = {
    1: "SELECT COUNT(*) FROM hits WHERE AdvEngineID <> 0;",
    2: "SELECT SUM(AdvEngineID), COUNT(*), AVG(ResolutionWidth) FROM hits;",
    3: "SELECT AVG(UserID) FROM hits;",
    4: "SELECT COUNT(DISTINCT UserID) FROM hits;",
    5: "SELECT MIN(EventDate), MAX(EventDate) FROM hits;",
    6: "SELECT AdvEngineID, COUNT(*) FROM hits WHERE AdvEngineID <> 0 "
       "GROUP BY AdvEngineID ORDER BY COUNT(*) DESC;",
    7: "SELECT RegionID, COUNT(DISTINCT UserID) AS u FROM hits GROUP BY "
       "RegionID ORDER BY u DESC LIMIT 10;",
    8: "SELECT UserID, COUNT(*) FROM hits GROUP BY UserID ORDER BY "
       "COUNT(*) DESC LIMIT 10;",
}
CLICKBENCH_LIMIT = 10


def _zipf_index(rng, n: int, k: int, power: float) -> np.ndarray:
    """n draws in [0, k), heavy at 0: floor(k * u**power)."""
    u = rng.random(n)
    u **= power
    u *= k
    return u.astype(np.int64)


def example_hits_arrays(rows: int = HITS_ROWS, seed: int = 14) -> dict:
    """ClickBench's `hits`, the five columns queries 1-8 read, drawn from
    `seed` by the published table's laws (ClickHouse's types, NOT NULL):
    UserID a random 64-bit hash of one of HITS_USERS users scaled to the
    rows (half of the hashes 2**63 or more), rows per user heavy-tailed
    (every step-th row a permutation of the users, so each appears; the
    rest floor(users * u**2)); RegionID one of HITS_REGIONS ids, Zipf-like
    (u**3); ResolutionWidth one of HITS_WIDTHS (common screens, weights
    1/rank); AdvEngineID 0 on all but HITS_ADV_SHARE of the rows, else one
    of 1..HITS_ADV_ENGINES (weights 1/rank); EventDate a day of July 2013.
    -> {name: numpy array}."""
    rng = np.random.default_rng(seed)
    users = max(1, round(rows * HITS_USERS / HITS_ROWS))
    table = rng.integers(0, 2**64, users, dtype=np.uint64, endpoint=False)
    idx = _zipf_index(rng, rows, users, 2.0)
    step = max(rows // users, 1)
    idx[::step][:users] = rng.permutation(users)[:len(idx[::step])]
    user_id = table[idx]
    del idx
    regions = rng.choice(np.arange(1, 2**15, dtype=np.uint32), HITS_REGIONS,
                         replace=False)
    region = regions[_zipf_index(rng, rows, HITS_REGIONS, 3.0)]
    wp = 1.0 / np.arange(1, len(HITS_WIDTHS) + 1)
    width_cdf = np.cumsum(wp / wp.sum())
    widths = np.asarray(HITS_WIDTHS, np.uint16)
    width = widths[np.minimum(np.searchsorted(width_cdf, rng.random(rows)),
                              len(widths) - 1)]
    ap = 1.0 / np.arange(1, HITS_ADV_ENGINES + 1)
    adv_cdf = np.cumsum(ap / ap.sum())
    adv = np.zeros(rows, np.uint8)
    has = np.flatnonzero(rng.random(rows) < HITS_ADV_SHARE)
    adv[has] = 1 + np.minimum(np.searchsorted(adv_cdf, rng.random(len(has))),
                              HITS_ADV_ENGINES - 1)
    date = (_days(HITS_FIRST_DAY) + rng.integers(0, HITS_DAYS, rows)
            ).astype(np.int32)
    return {"UserID": user_id, "RegionID": region, "ResolutionWidth": width,
            "AdvEngineID": adv, "EventDate": date}


def hits_batch(arrays: dict, device=None) -> bt.RecordBatch:
    """The `hits` arrays as a batch on `device` (the card by default), each
    column in its ClickHouse type (uint64 as its int64 bits)."""
    return bt.record_batch({
        n: column_from_numpy(arrays[n], None, dtype=HITS_TYPES[n],
                             device=device) for n in HITS_COLUMNS})


def _mean(total, n: torch.Tensor) -> float:
    """sum / count: the float64 sum divided by the count as a device
    tensor (never a host scalar, which the card's division would turn into
    a multiply by the reciprocal)."""
    value, has = total
    return ops.finalize((value / n.to(torch.float64), has))


def _top(grouped: bt.RecordBatch, key: str, count: str,
         limit: Optional[int]) -> list:
    """ORDER BY count DESC, key ASC [LIMIT limit] -> [(key, count)] on
    the host."""
    from .config import SortOptions

    top = ops.sort_batch(grouped, [count, key],
                         [SortOptions(descending=True), SortOptions()],
                         limit=limit)
    return list(zip(top[key].to_pylist(), top[count].to_pylist()))


def clickbench_step(batch: bt.RecordBatch, q: int):
    """ClickBench query q (1-8, `CLICKBENCH_QUERIES`) over a `hits` batch,
    ending in its result on the host: an int (1, 4), a tuple (2: SUM,
    COUNT, AVG; 5: MIN, MAX as days), a float (3) or [(key, count)]
    (6-8).  SUM(AdvEngineID) casts the UInt8 to uint64 first, the AVGs
    cast to float64 (uint64 by hi * 2**32 + lo) and divide the sum by the
    count on the device; COUNT(DISTINCT ...) is a group count."""
    if q == 1:
        return ops.finalize(ops.sum_(ops.neq(batch["AdvEngineID"], 0)))
    if q == 2:
        adv, rw = batch["AdvEngineID"], batch["ResolutionWidth"]
        n = ops.count(rw)
        return (ops.finalize(ops.sum_(ops.cast(adv, st.uint64))),
                int(n), _mean(ops.sum_(ops.cast(rw, st.float64)), n))
    if q == 3:
        uid = batch["UserID"]
        return _mean(ops.sum_(ops.cast(uid, st.float64)), ops.count(uid))
    if q == 4:
        return gb.group_by(_pick(batch, ["UserID"]), ["UserID"], []).length
    if q == 5:
        d = batch["EventDate"]
        return ops.finalize(ops.min_(d)), ops.finalize(ops.max_(d))
    if q == 6:
        adv = batch["AdvEngineID"]
        kept = ops.filter_record_batch(_pick(batch, ["AdvEngineID"]),
                                       ops.neq(adv, 0))
        grouped = gb.group_by(kept, ["AdvEngineID"],
                              [("AdvEngineID", "count")])
        return _top(grouped, "AdvEngineID", "count_AdvEngineID", None)
    if q == 7:
        pairs = gb.group_by(_pick(batch, ["RegionID", "UserID"]),
                            ["RegionID", "UserID"], [])
        grouped = gb.group_by(pairs, ["RegionID"], [("UserID", "count")])
        return _top(grouped, "RegionID", "count_UserID", CLICKBENCH_LIMIT)
    if q == 8:
        grouped = gb.group_by(_pick(batch, ["UserID"]), ["UserID"],
                              [("UserID", "count")])
        return _top(grouped, "UserID", "count_UserID", CLICKBENCH_LIMIT)
    raise ValueError(f"no ClickBench query {q}")


def _top_pairs(keys: np.ndarray, counts: np.ndarray,
               limit: Optional[int]) -> list:
    order = np.lexsort((keys, -counts.astype(np.int64)))
    order = order if limit is None else order[:limit]
    return list(zip(keys[order].tolist(), counts[order].tolist()))


def _distinct(x: np.ndarray) -> np.ndarray:
    """x's distinct values, ascending: one np.sort and a pass (np.unique
    without counts hashes in numpy 2.3, minutes over 1e8 distinct
    values)."""
    s = np.sort(x)
    return s[np.diff(s, prepend=~s[:1]) != 0]


def _region_user_pairs(region: np.ndarray, uid: np.ndarray,
                       users: np.ndarray):
    """-> (the distinct (RegionID, UserID) pairs as uint64s, RegionID's
    width in bits): RegionID in the top bits, then UserID less as many low
    bits when that prefix still tells the users apart (checked: one sort),
    else UserID's index in `users` (an argsort, slower)."""
    bits = max(int(region.max()).bit_length(), 1)
    user = uid >> np.uint64(bits)
    if len(_distinct(user)) != len(users):
        user = np.unique(uid, return_inverse=True)[1].astype(
            np.uint64).reshape(-1)
    return _distinct((region.astype(np.uint64) << np.uint64(64 - bits))
                     | user), bits


def clickbench_oracle(arrays: dict, q=None):
    """ClickBench queries in numpy on the `hits` arrays: query q's result
    as `clickbench_step` gives it, or (q None) {q: result} for all eight,
    sharing one np.unique of UserID.  Sums are exact integers (AVG(UserID)
    the exact mean, from the 32-bit halves summed in int64, rounded once);
    COUNT(DISTINCT RegionID, UserID) packs each pair into one uint64
    (`_region_user_pairs`).  Only sorts: no argsort and no hash set of
    the 1e8 rows."""
    qs = sorted(CLICKBENCH_QUERIES) if q is None else [q]
    adv, uid = arrays["AdvEngineID"], arrays["UserID"]
    n = len(uid)
    out = {}
    if any(x in qs for x in (4, 7, 8)):
        users, counts = np.unique(uid, return_counts=True)
    for x in qs:
        if x == 1:
            out[x] = int(np.count_nonzero(adv))
        elif x == 2:
            rw = int(arrays["ResolutionWidth"].sum(dtype=np.int64))
            out[x] = (int(adv.sum(dtype=np.uint64)), n, rw / n)
        elif x == 3:
            hi = (uid >> np.uint64(32)).astype(np.int64).sum()
            lo = (uid & np.uint64(0xFFFFFFFF)).astype(np.int64).sum()
            out[x] = ((int(hi) << 32) + int(lo)) / n
        elif x == 4:
            out[x] = len(users)
        elif x == 5:
            d = arrays["EventDate"]
            out[x] = (int(d.min()), int(d.max()))
        elif x == 6:
            per_engine = np.bincount(adv[adv != 0], minlength=256)
            keys = np.flatnonzero(per_engine)
            out[x] = _top_pairs(keys, per_engine[keys], None)
        elif x == 7:
            pairs, bits = _region_user_pairs(arrays["RegionID"], uid, users)
            # the pairs are sorted, so are their regions: count the runs
            region = pairs >> np.uint64(64 - bits)
            starts = np.flatnonzero(np.diff(region, prepend=~region[:1]))
            u = np.diff(np.append(starts, len(region)))
            out[x] = _top_pairs(region[starts], u, CLICKBENCH_LIMIT)
        elif x == 8:
            out[x] = _top_pairs(users, counts, CLICKBENCH_LIMIT)
    return out if q is None else out[q]


def check_clickbench(got, want, q: int):
    """Raise unless query q's result equals the oracle's: exactly, but
    AVG(UserID) within a relative 1e-12 of the exact mean (a float64 sum
    of 1e8 values in another order)."""
    if q == 3:
        if not abs(got - want) <= 1e-12 * abs(want):
            raise AssertionError(f"ClickBench Q3: {got!r} != {want!r}")
    elif got != want:
        raise AssertionError(f"ClickBench Q{q}: {got!r} != {want!r}")
    return got


# ---------------------------------------------------------------------------
# ClickBench's `hits` in primary-key order: run-end encoding, zoned time
# ---------------------------------------------------------------------------

HITS_PK_COLUMNS = ["CounterID", "EventDate", "EventTime", "IsRefresh",
                   "DontCountHits"]
HITS_TZ = "Europe/Moscow"  # ClickHouse's DateTime of the published table
HITS_PK_TYPES = {"CounterID": st.uint32, "EventDate": st.Date32(),
                 "EventTime": st.Timestamp("s", HITS_TZ),
                 "IsRefresh": st.uint8, "DontCountHits": st.uint8}
HITS_RUN_COLUMNS = ("CounterID", "EventDate")  # the primary key's lead
# Moscow time was UTC+4 from 2011-03-27 to 2014-10-26 (Federal Law 107-FZ
# of 2011-06-03 and 248-FZ of 2014-07-21), so all through July 2013
MSK_2013_OFFSET_S = 4 * 3600
HITS_COUNTERS = 4_000
HITS_TOP_COUNTER = 62  # query 43's counter, the most frequent
HITS_COUNTER_ZIPF = 1.0
HITS_COUNTER_ID_RANGE = 200_000
# the share of rows set, of 256: IsRefresh 6.25 %, DontCountHits 3.1 %
HITS_REFRESH_OF_256 = 16
HITS_DONT_COUNT_OF_256 = 8
# the daily curve: relative hits per hour of Moscow time, 00 to 23
HITS_HOUR_WEIGHTS = (3, 2, 1, 1, 1, 1, 2, 4, 7, 9, 10, 10, 10, 10, 10, 10,
                     10, 9, 9, 9, 8, 7, 6, 4)
Q43 = ("SELECT DATE_TRUNC('minute', EventTime) AS M, COUNT(*) AS PageViews "
       "FROM hits WHERE CounterID = 62 AND EventDate >= '2013-07-14' AND "
       "EventDate <= '2013-07-15' AND IsRefresh = 0 AND DontCountHits = 0 "
       "GROUP BY DATE_TRUNC('minute', EventTime) ORDER BY "
       "DATE_TRUNC('minute', EventTime) LIMIT 10 OFFSET 1000;")
Q43_DAYS = ("2013-07-14", "2013-07-15")
Q43_OFFSET = 1000
Q43_LIMIT = 10


def example_hits_pk_arrays(rows: int = HITS_ROWS, seed: int = 15) -> dict:
    """The five columns ClickBench's query 43 reads, drawn from `seed` in
    the table's primary-key order (CounterID, EventDate, ...) by
    construction, never sorted: HITS_COUNTERS counter ids (62 and others
    drawn below HITS_COUNTER_ID_RANGE), their rows Zipf(HITS_COUNTER_ZIPF)
    by a rank (62 first, the others' ranks a permutation), each counter's
    rows spread over the days of July 2013 uniformly; EventTime a second
    of its row's Moscow day by HITS_HOUR_WEIGHTS and uniform within the
    hour, in no order inside a (counter, day) run, as UTC seconds;
    EventDate its Moscow date; IsRefresh and DontCountHits 1 on
    HITS_REFRESH_OF_256 / HITS_DONT_COUNT_OF_256 of 256 rows.
    -> {name: numpy array} (CounterID uint32, EventDate int32 days,
    EventTime int64 seconds, the flags uint8)."""
    rng = np.random.default_rng(seed)
    others = rng.choice(np.arange(1, HITS_COUNTER_ID_RANGE - 1, dtype=np.uint32),
                        HITS_COUNTERS - 1, replace=False)
    others[others >= HITS_TOP_COUNTER] += 1  # never 62
    ids = np.sort(np.append(others, np.uint32(HITS_TOP_COUNTER)))
    rank = np.empty(HITS_COUNTERS, np.int64)
    top = int(np.searchsorted(ids, HITS_TOP_COUNTER))
    rank[top] = 1
    rank[np.arange(HITS_COUNTERS) != top] = 2 + rng.permutation(
        HITS_COUNTERS - 1)
    weights = rank.astype(np.float64) ** -HITS_COUNTER_ZIPF
    per_counter = rng.multinomial(rows, weights / weights.sum())
    per_run = rng.multinomial(per_counter, np.full(HITS_DAYS, 1 / HITS_DAYS))
    runs = per_run.reshape(-1)
    counter = np.repeat(np.repeat(ids, HITS_DAYS), runs)
    days = _days(HITS_FIRST_DAY) + np.arange(HITS_DAYS, dtype=np.int32)
    date = np.repeat(np.tile(days, HITS_COUNTERS), runs).astype(np.int32)
    w = np.asarray(HITS_HOUR_WEIGHTS, np.float64)
    hour_of = np.minimum(np.searchsorted(
        np.cumsum(w / w.sum()), (np.arange(2**16) + 0.5) / 2**16),
        len(w) - 1).astype(np.int64)
    local = date.astype(np.int64) * 86_400
    local += hour_of[rng.integers(0, 2**16, rows, dtype=np.uint16)] * 3600
    local += rng.integers(0, 3600, rows, dtype=np.int32)
    local -= MSK_2013_OFFSET_S
    refresh = (rng.integers(0, 256, rows, dtype=np.uint8)
               < HITS_REFRESH_OF_256).view(np.uint8)
    dont = (rng.integers(0, 256, rows, dtype=np.uint8)
            < HITS_DONT_COUNT_OF_256).view(np.uint8)
    return {"CounterID": counter, "EventDate": date, "EventTime": local,
            "IsRefresh": refresh, "DontCountHits": dont}


def hits_pk_batch(arrays: dict, device=None) -> bt.RecordBatch:
    """The primary-key `hits` columns as a batch on `device` (the card by
    default): CounterID and EventDate run-end encoded there by
    `ops.run_end_encode`, the rest plain.  The batch's columns differ in
    capacity (an encoded column's is its run count), so read the row
    capacity from a plain column."""
    device = resolve_device(device)
    cols = []
    for name in HITS_PK_COLUMNS:
        c = column_from_numpy(arrays[name], None, dtype=HITS_PK_TYPES[name],
                              device=device)
        cols.append(ops.run_end_encode(c) if name in HITS_RUN_COLUMNS else c)
    fields = tuple(st.Field(n, c.dtype, False)
                   for n, c in zip(HITS_PK_COLUMNS, cols))
    return bt.RecordBatch(st.Schema(fields), tuple(cols))


def runs_predicate(c: col.RunEndColumn, on_runs: col.BooleanColumn,
                   rows: int) -> col.BooleanColumn:
    """A predicate computed on a run-end column's runs (one row a run),
    decoded to a row mask of `rows` capacity."""
    return ops.run_end_decode_to(
        col.RunEndColumn(c.run_ends, on_runs, c.length,
                         st.RunEndEncoded(st.int32, st.bool_)), rows)


def _on_rows(c: col.Column, predicate, rows: int) -> col.BooleanColumn:
    """predicate(values) of a run-end column computed on its runs and
    decoded to rows; of a plain column, on its rows."""
    if isinstance(c, col.RunEndColumn):
        return runs_predicate(c, predicate(c.values), rows)
    return predicate(c)


def q43_mask(batch: bt.RecordBatch) -> col.BooleanColumn:
    """Query 43's WHERE: CounterID and EventDate compared on their runs and
    decoded to rows (on their rows where they are plain), ANDed with
    IsRefresh = 0 and DontCountHits = 0."""
    rows = batch["EventTime"].capacity
    lo, hi = (_days(d) for d in Q43_DAYS)
    on_counter = _on_rows(batch["CounterID"],
                          lambda v: ops.eq(v, HITS_TOP_COUNTER), rows)
    in_days = _on_rows(batch["EventDate"], lambda v: ops.and_(
        ops.gt_eq(v, lo), ops.lt_eq(v, hi)), rows)
    flags = ops.and_(ops.eq(batch["IsRefresh"], 0),
                     ops.eq(batch["DontCountHits"], 0))
    return ops.and_(ops.and_(on_counter, in_days), flags)


def minute_trunc(t: col.PrimitiveColumn) -> col.PrimitiveColumn:
    """DATE_TRUNC('minute', t) of a Timestamp("s") column in its zone:
    t less its local second.  Exact where the zone's offsets are whole
    minutes, which is checked on the offsets the rows' span meets."""
    n = t.length
    if n and t.dtype.tz:
        lo, hi = t.values[:n].aminmax()
        offsets = ops.temporal.offsets_between(t.dtype.tz, int(lo), int(hi))
        if np.any(offsets % 60):
            raise st.ComputeError(f"{t.dtype.tz}: an offset of the rows' "
                                  "span is not a whole minute")
    sec = ops.date_part(t, "second")
    return col.PrimitiveColumn(t.values - sec.values.to(torch.int64),
                               t.validity, n, t.dtype)


def q43_result(batch: bt.RecordBatch, offset: int = Q43_OFFSET,
               limit: int = Q43_LIMIT) -> bt.RecordBatch:
    """Query 43 on a `hits_pk_batch`, ending in its rows on the device:
    (M, PageViews), ascending M, rows [offset, offset + limit)."""
    kept = ops.filter_(batch["EventTime"], q43_mask(batch))
    grouped = gb.group_by(bt.record_batch({"M": minute_trunc(kept)}), ["M"],
                          [("M", "count")])
    top = ops.slice_batch(ops.sort_batch(grouped, ["M"],
                                         limit=offset + limit), offset, limit)
    return bt.RecordBatch(st.schema([("M", top["M"].dtype),
                                     ("PageViews", st.int64)]), top.columns)


def q43_step(batch: bt.RecordBatch, offset: int = Q43_OFFSET,
             limit: int = Q43_LIMIT) -> list:
    """Query 43's result on the host: [(M as UTC seconds, PageViews)]."""
    out = q43_result(batch, offset, limit)
    return list(zip(out["M"].to_pylist(), out["PageViews"].to_pylist()))


def q43_oracle(arrays: dict, offset: int = Q43_OFFSET,
               limit: int = Q43_LIMIT) -> list:
    """Query 43 in numpy on the arrays, with MSK_2013_OFFSET_S for the
    local minute."""
    lo, hi = (_days(d) for d in Q43_DAYS)
    date = arrays["EventDate"]
    mask = ((arrays["CounterID"] == HITS_TOP_COUNTER) & (date >= lo)
            & (date <= hi) & (arrays["IsRefresh"] == 0)
            & (arrays["DontCountHits"] == 0))
    t = arrays["EventTime"][mask]
    minutes, counts = np.unique(t - (t + MSK_2013_OFFSET_S) % 60,
                                return_counts=True)
    return list(zip(minutes[offset:offset + limit].tolist(),
                    counts[offset:offset + limit].tolist()))


def check_q43(got: list, want: list) -> list:
    if got != want:
        raise AssertionError(f"ClickBench Q43: {got!r} != {want!r}")
    return got


# `hits` as a Parquet file: the reference writer's defaults for the row
# group (max_row_group_size) and the data page (data_page_row_count_limit)
HITS_PARQUET_ROW_GROUP = 1 << 20
HITS_PARQUET_PAGE_ROWS = 20_000
# the writer keeps no Arrow schema and labels a timestamp microseconds:
# EventTime goes in as Timestamp("us") and comes back cast to its zone
HITS_PARQUET_TIME = st.Timestamp("us")


def hits_parquet_props(**kw):
    """WriterProperties of `hits` in Parquet: statistics, the page index
    and a bloom filter on CounterID, dictionaries on, uncompressed."""
    from .formats.parquet import WriterProperties

    return WriterProperties(**{
        "data_page_row_limit": HITS_PARQUET_PAGE_ROWS,
        "write_page_index": True, "bloom_filter_columns": ("CounterID",),
        "dictionary_enabled": True, "statistics_enabled": True,
        "compression": "none", **kw})


def hits_pk_parquet(arrays: dict, rows: int = HITS_PARQUET_ROW_GROUP,
                    device=None) -> bytes:
    """The primary-key `hits` columns (`example_hits_pk_arrays`) as a
    Parquet file in host memory, one row group of `rows` rows: the plain
    columns built on `device` (NOT NULL, as in ClickHouse's create.sql),
    EventTime cast there to HITS_PARQUET_TIME, then written a row group's
    slice at a time, with `hits_parquet_props()`."""
    from .formats.parquet import write_parquet
    from .ops.coalesce import slice_batch

    cols = []
    for name in HITS_PK_COLUMNS:
        c = column_from_numpy(arrays[name], None, dtype=HITS_PK_TYPES[name],
                              device=device)
        cols.append(ops.cast(c, HITS_PARQUET_TIME) if name == "EventTime"
                    else c)
    batch = bt.RecordBatch(st.Schema(tuple(
        st.Field(n, c.dtype, False) for n, c in zip(HITS_PK_COLUMNS, cols))),
        tuple(cols))
    parts = [slice_batch(batch, r0, rows)
             for r0 in range(0, max(batch.length, 1), rows)]
    return write_parquet(parts, None, hits_parquet_props())


def q43_predicates(all_four: bool = True) -> list:
    """Query 43's WHERE as Parquet scan predicates (CounterID, the two
    EventDate bounds, IsRefresh, DontCountHits); with all_four=False only
    DontCountHits = 0."""
    from .formats.parquet_scan import ColumnPredicate as P

    lo, hi = (_days(d) for d in Q43_DAYS)
    last = [P("DontCountHits", "eq", 0)]
    if not all_four:
        return last
    return [P("CounterID", "eq", HITS_TOP_COUNTER),
            P("EventDate", "gt_eq", lo), P("EventDate", "lt_eq", hi),
            P("IsRefresh", "eq", 0)] + last


def hits_from_parquet(batch: bt.RecordBatch) -> bt.RecordBatch:
    """A batch scanned from `hits_pk_parquet`'s file with EventTime cast
    back to Timestamp("s", HITS_TZ): the columns `q43_step` reads."""
    t = HITS_PK_TYPES["EventTime"]
    cols = tuple(ops.cast(c, t) if f.name == "EventTime" else c
                 for f, c in zip(batch.schema.fields, batch.columns))
    return bt.RecordBatch(st.Schema(tuple(
        st.Field(f.name, t if f.name == "EventTime" else f.dtype, f.nullable)
        for f in batch.schema.fields)), cols)


# ---------------------------------------------------------------------------
# JSONBench: Bluesky events as a shredded Variant column
# ---------------------------------------------------------------------------

JSONBENCH_DOCS = 1_000_000  # JSONBench's 1m size
JSONBENCH_USERS = 300_000  # distinct dids at JSONBENCH_DOCS documents
JSONBENCH_USER_POWER = 2.5  # a document's user floor(users * u**2.5)
JSONBENCH_KINDS = (("commit", 0.95), ("identity", 0.03), ("account", 0.02))
JSONBENCH_OPERATIONS = (("create", 0.88), ("delete", 0.10), ("update", 0.02))
# about ten app.bsky collections, a share by rank**-1.5 in this order
JSONBENCH_COLLECTIONS = (
    "app.bsky.feed.like", "app.bsky.graph.follow", "app.bsky.feed.post",
    "app.bsky.feed.repost", "app.bsky.graph.block", "app.bsky.actor.profile",
    "app.bsky.graph.listitem", "app.bsky.feed.threadgate",
    "app.bsky.graph.list", "app.bsky.feed.postgate")
JSONBENCH_COLLECTION_POWER = 1.5
JSONBENCH_FIRST_US = 1_732_147_200_000_000  # 2024-11-21T00:00:00Z
JSONBENCH_DAY_US = 86_400_000_000
JSONBENCH_WORDS = (
    "the", "a", "bluesky", "post", "today", "new", "just", "love", "this",
    "good", "morning", "art", "photo", "music", "game", "news", "read",
    "thread", "world", "people", "time", "first", "open", "web", "feed")
# the typed_value that JSONBench's five queries read; every other field
# (rev, rkey, record, cid, identity, account) stays in the residual
JSONBENCH_SHRED = st.Struct((
    st.Field("kind", st.utf8), st.Field("did", st.utf8),
    st.Field("time_us", st.int64),
    st.Field("commit", st.Struct((st.Field("operation", st.utf8),
                                  st.Field("collection", st.utf8))))))
JSONBENCH_COLUMNS = {"kind": (("kind",), st.utf8),
                     "did": (("did",), st.utf8),
                     "time_us": (("time_us",), st.int64),
                     "operation": (("commit", "operation"), st.utf8),
                     "collection": (("commit", "collection"), st.utf8)}
JSONBENCH_QUERIES = {
    1: "SELECT data.commit.collection AS event, count() AS count FROM "
       "bluesky GROUP BY event ORDER BY count DESC;",
    2: "SELECT data.commit.collection AS event, count() AS count, "
       "uniqExact(data.did) AS users FROM bluesky WHERE data.kind = "
       "'commit' AND data.commit.operation = 'create' GROUP BY event ORDER "
       "BY count DESC;",
    3: "SELECT data.commit.collection AS event, toHour(fromUnixTimestamp64"
       "Micro(data.time_us)) as hour_of_day, count() AS count FROM bluesky "
       "WHERE data.kind = 'commit' AND data.commit.operation = 'create' AND "
       "data.commit.collection in ['app.bsky.feed.post', "
       "'app.bsky.feed.repost', 'app.bsky.feed.like'] GROUP BY event, "
       "hour_of_day ORDER BY hour_of_day, event;",
    4: "SELECT data.did::String as user_id, min(fromUnixTimestamp64Micro("
       "data.time_us)) as first_post_ts FROM bluesky WHERE data.kind = "
       "'commit' AND data.commit.operation = 'create' AND "
       "data.commit.collection = 'app.bsky.feed.post' GROUP BY user_id "
       "ORDER BY first_post_ts ASC LIMIT 3;",
    5: "SELECT data.did::String as user_id, date_diff('milliseconds', "
       "min(fromUnixTimestamp64Micro(data.time_us)), max(fromUnixTimestamp64"
       "Micro(data.time_us))) AS activity_span FROM bluesky WHERE data.kind "
       "= 'commit' AND data.commit.operation = 'create' AND "
       "data.commit.collection = 'app.bsky.feed.post' GROUP BY user_id "
       "ORDER BY activity_span DESC LIMIT 3;",
}
JSONBENCH_Q3_COLLECTIONS = ("app.bsky.feed.post", "app.bsky.feed.repost",
                            "app.bsky.feed.like")
JSONBENCH_POST = "app.bsky.feed.post"
JSONBENCH_LIMIT = 3
_B32 = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz234567", np.uint8)


def _b32_strings(rng, n: int, k: int) -> List[str]:
    """n random strings of k base32 letters (atproto's alphabet)."""
    raw = _B32[rng.integers(0, 32, (n, k), dtype=np.uint8)]
    return np.ascontiguousarray(raw).view(f"S{k}").ravel().astype(
        f"U{k}").tolist()


def _draw(rng, n: int, shares) -> np.ndarray:
    """n indices into `shares` ((name, share) pairs) by their shares."""
    p = np.asarray([s for _, s in shares], np.float64)
    return rng.choice(len(p), n, p=p / p.sum())


def example_bluesky_docs(docs: int = JSONBENCH_DOCS, seed: int = 19
                         ) -> List[str]:
    """JSONBench's Bluesky events (Jetstream's published JSON shape) drawn
    from `seed` by this repository's laws, in time order, one JSON text a
    document: `did` one of users (JSONBENCH_USERS scaled to the documents,
    each "did:plc:" and 24 base32 letters) heavy-tailed (floor(users *
    u**JSONBENCH_USER_POWER)); `time_us` uniform over one day from
    JSONBENCH_FIRST_US, sorted; `kind` by JSONBENCH_KINDS; a commit's
    `operation` by JSONBENCH_OPERATIONS and `collection` by rank**-1.5
    over JSONBENCH_COLLECTIONS, with `rev`, `rkey` (13-letter TIDs) and,
    unless deleted, `record` (its fields by collection: a like's or
    repost's subject {cid, uri}, a post's langs and 3-12 words of text, a
    follow's or block's subject did) and `cid`; identity and account
    events carry their own objects."""
    rng = np.random.default_rng(seed)
    users = max(1, round(docs * JSONBENCH_USERS / JSONBENCH_DOCS))
    dids = ["did:plc:" + s for s in _b32_strings(rng, users, 24)]
    who = (rng.random(docs) ** JSONBENCH_USER_POWER * users).astype(np.int64)
    other = rng.integers(0, users, docs)
    time_us = np.sort(JSONBENCH_FIRST_US + rng.integers(
        0, JSONBENCH_DAY_US, docs, dtype=np.int64))
    iso = [s + "Z" for s in np.datetime_as_string(
        time_us.astype("datetime64[us]").astype("datetime64[ms]"),
        unit="ms").tolist()]
    kind = _draw(rng, docs, JSONBENCH_KINDS)
    op = _draw(rng, docs, JSONBENCH_OPERATIONS)
    w = np.arange(1, len(JSONBENCH_COLLECTIONS) + 1,
                  dtype=np.float64) ** -JSONBENCH_COLLECTION_POWER
    coll = rng.choice(len(w), docs, p=w / w.sum())
    rev, rkey, rkey2 = (_b32_strings(rng, docs, 11) for _ in range(3))
    cid, cid2 = (_b32_strings(rng, docs, 52) for _ in range(2))
    n_words = rng.integers(3, 13, docs)
    words = rng.integers(0, len(JSONBENCH_WORDS), (docs, 12))
    active = rng.random(docs) < 0.9
    out = []
    for i in range(docs):
        did, t = dids[who[i]], int(time_us[i])
        head = f'{{"did":"{did}","time_us":{t},'
        if kind[i] == 1:
            out.append(
                head + f'"kind":"identity","identity":{{"did":"{did}",'
                f'"handle":"user{who[i]}.bsky.social","seq":{i},'
                f'"time":"{iso[i]}"}}}}')
            continue
        if kind[i] == 2:
            out.append(
                head + f'"kind":"account","account":{{"active":'
                f'{"true" if active[i] else "false"},"did":"{did}",'
                f'"seq":{i},"time":"{iso[i]}"}}}}')
            continue
        c = JSONBENCH_COLLECTIONS[coll[i]]
        operation = JSONBENCH_OPERATIONS[op[i]][0]
        commit = (f'"rev":"3l{rev[i]}","operation":"{operation}",'
                  f'"collection":"{c}","rkey":"3l{rkey[i]}"')
        if operation != "delete":
            record = f'"$type":"{c}","createdAt":"{iso[i]}"'
            if coll[i] in (0, 3):  # like, repost
                record += (f',"subject":{{"cid":"bafyrei{cid2[i]}","uri":'
                           f'"at://{dids[other[i]]}/app.bsky.feed.post/'
                           f'3l{rkey2[i]}"}}')
            elif coll[i] == 2:  # post
                text = " ".join(JSONBENCH_WORDS[x]
                                for x in words[i, :n_words[i]])
                record += f',"langs":["en"],"text":"{text}"'
            elif coll[i] in (1, 4):  # follow, block
                record += f',"subject":"{dids[other[i]]}"'
            commit += f',"record":{{{record}}},"cid":"bafyrei{cid[i]}"'
        out.append(head + f'"kind":"commit","commit":{{{commit}}}}}')
    return out


def bluesky_variant(texts: List[str], device=None):
    """The JSON texts as a Variant column on `device` (None: the card),
    parsed and encoded on the host (`variant.batch_json_to_variant`), then
    shredded to JSONBENCH_SHRED (`variant.shred_variant`).  -> the
    shredded VariantColumn."""
    from . import variant

    vc = variant.batch_json_to_variant(texts, resolve_device(device))
    return variant.shred_variant(vc, JSONBENCH_SHRED)


def bluesky_batch(vc) -> bt.RecordBatch:
    """The five columns JSONBench's queries read, by `variant_get` of
    their paths as their types (JSONBENCH_COLUMNS): on a column shredded
    to JSONBENCH_SHRED each is a typed column of the shredded form itself
    (the columnar path), with no row decoded."""
    from . import variant

    return bt.record_batch({
        name: variant.variant_get(vc, list(path), as_dtype=dtype)
        for name, (path, dtype) in JSONBENCH_COLUMNS.items()})


def _equals(c: col.Column, text: str) -> col.BooleanColumn:
    """c = 'text' (a string literal with no LIKE wildcard, matched as the
    pattern it is)."""
    if "%" in text or "_" in text:
        raise ValueError(f"{text!r} holds a LIKE wildcard")
    return ops.like(c, text)


def _created(batch: bt.RecordBatch) -> col.BooleanColumn:
    """kind = 'commit' AND commit.operation = 'create' (Kleene)."""
    return ops.and_kleene(_equals(batch["kind"], "commit"),
                          _equals(batch["operation"], "create"))


def _rows(batch: bt.RecordBatch, names) -> list:
    return list(zip(*(batch[n].to_pylist() for n in names)))


def jsonbench_step(batch: bt.RecordBatch, q: int) -> list:
    """JSONBench query q (1-5, `JSONBENCH_QUERIES`) over `bluesky_batch`'s
    columns on their device, ending in its rows on the host.  Ties in
    ORDER BY are broken by the event (nulls first) or the user id,
    ascending, as `jsonbench_oracle` breaks them.
      1: [(collection or None, count)]
      2: [(collection, count, users)]: the (collection, did) pairs with
         their counts, then those counts' sum and count by collection (two
         group-bys)
      3: [(collection, hour, count)]: the hour of time_us as a UTC
         microsecond timestamp (`date_part`)
      4: [(did, first time_us)]
      5: [(did, span in ms)]: floor(max / 1000) - floor(min / 1000), as
         ClickHouse's date_diff('milliseconds') counts."""
    from .config import SortOptions

    desc, asc = SortOptions(descending=True), SortOptions()
    if q == 1:
        g = gb.group_by(_pick(batch, ["collection", "time_us"]),
                        ["collection"], [("time_us", "count")])
        top = ops.sort_batch(g, ["count_time_us", "collection"], [desc, asc])
        return _rows(top, ["collection", "count_time_us"])
    created = _created(batch)
    if q == 2:
        kept = ops.filter_record_batch(
            _pick(batch, ["collection", "did", "time_us"]), created)
        pairs = gb.group_by(kept, ["collection", "did"],
                            [("time_us", "count")])
        g = gb.group_by(pairs, ["collection"], [("count_time_us", "sum"),
                                                ("count_time_us", "count")])
        top = ops.sort_batch(g, ["sum_count_time_us", "collection"],
                             [desc, asc])
        return _rows(top, ["collection", "sum_count_time_us",
                           "count_count_time_us"])
    if q == 3:
        coll = batch["collection"]
        listed = _equals(coll, JSONBENCH_Q3_COLLECTIONS[0])
        for name in JSONBENCH_Q3_COLLECTIONS[1:]:
            listed = ops.or_kleene(listed, _equals(coll, name))
        kept = ops.filter_record_batch(
            _pick(batch, ["collection", "time_us"]),
            ops.and_kleene(created, listed))
        stamp = dataclasses.replace(kept["time_us"],
                                    dtype=st.Timestamp("us"))
        hours = bt.record_batch({"collection": kept["collection"],
                                 "hour": ops.date_part(stamp, "hour")})
        g = gb.group_by(hours, ["collection", "hour"], [("hour", "count")])
        top = ops.sort_batch(g, ["hour", "collection"], [asc, asc])
        return _rows(top, ["collection", "hour", "count_hour"])
    if q in (4, 5):
        kept = ops.filter_record_batch(
            _pick(batch, ["did", "time_us"]),
            ops.and_kleene(created, _equals(batch["collection"],
                                            JSONBENCH_POST)))
        g = gb.group_by(kept, ["did"], [("time_us", "min"),
                                        ("time_us", "max")])
        if q == 4:
            top = ops.sort_batch(g, ["min_time_us", "did"], [asc, asc],
                                 limit=JSONBENCH_LIMIT)
            return _rows(top, ["did", "min_time_us"])
        span = ops.sub(ops.div(g["max_time_us"], 1000),
                       ops.div(g["min_time_us"], 1000))
        spans = bt.record_batch({"did": g["did"], "span": span})
        top = ops.sort_batch(spans, ["span", "did"], [desc, asc],
                             limit=JSONBENCH_LIMIT)
        return _rows(top, ["did", "span"])
    raise ValueError(f"no JSONBench query {q}")


def _ordered(rows, key, limit=None) -> list:
    rows = sorted(rows, key=key)
    return rows if limit is None else rows[:limit]


def jsonbench_oracle(texts: List[str], q=None):
    """JSONBench's queries over the JSON texts, parsed by Python's `json`
    (no part of `variant/`), in plain Python: query q's rows as
    `jsonbench_step` gives them, or (q None) {q: rows} for all five, the
    texts parsed once."""
    import json as _json

    qs = sorted(JSONBENCH_QUERIES) if q is None else [q]
    by_coll: Dict[Optional[str], int] = {}
    created = []  # (collection, did, time_us) of the created commits
    for text in texts:
        d = _json.loads(text)
        commit = d.get("commit")
        c = commit["collection"] if commit else None
        by_coll[c] = by_coll.get(c, 0) + 1
        if d["kind"] == "commit" and commit["operation"] == "create":
            created.append((c, d["did"], d["time_us"]))
    out = {}
    for x in qs:
        if x == 1:
            out[x] = _ordered(by_coll.items(), lambda r: (
                -r[1], r[0] is not None, r[0] or ""))
        elif x == 2:
            count: Dict[str, int] = {}
            users: Dict[str, set] = {}
            for c, did, _ in created:
                count[c] = count.get(c, 0) + 1
                users.setdefault(c, set()).add(did)
            out[x] = _ordered([(c, n, len(users[c]))
                               for c, n in count.items()],
                              lambda r: (-r[1], r[0]))
        elif x == 3:
            cells: Dict[Tuple[str, int], int] = {}
            for c, _, t in created:
                if c in JSONBENCH_Q3_COLLECTIONS:
                    key = (c, t // 3_600_000_000 % 24)
                    cells[key] = cells.get(key, 0) + 1
            out[x] = _ordered([(c, h, n) for (c, h), n in cells.items()],
                              lambda r: (r[1], r[0]))
        else:
            lo: Dict[str, int] = {}
            hi: Dict[str, int] = {}
            for c, did, t in created:
                if c == JSONBENCH_POST:
                    lo[did] = min(lo.get(did, t), t)
                    hi[did] = max(hi.get(did, t), t)
            if x == 4:
                out[x] = _ordered(lo.items(), lambda r: (r[1], r[0]),
                                  JSONBENCH_LIMIT)
            else:
                out[x] = _ordered(
                    [(did, hi[did] // 1000 - lo[did] // 1000) for did in lo],
                    lambda r: (-r[1], r[0]), JSONBENCH_LIMIT)
    return out if q is None else out[q]


def check_jsonbench(got, want, q: int):
    """Raise unless query q's rows equal the oracle's, exactly."""
    if got != want:
        raise AssertionError(f"JSONBench Q{q}: {got!r} != {want!r}")
    return got
