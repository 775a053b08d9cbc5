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

`lexsort_step` is BASELINE config 3 (`bench.py` config3_lexsort): the
lexsort of (int32, float64, dictionary-utf8) columns.
`example_lexsort_columns` draws them as the bench does, and
`check_lexsort` holds an index to the stable order on the host without a
host sort.
"""

from __future__ import annotations

import decimal as _pydec
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import ops
from . import schema as st
from .config import resolve_device
from .core import batch as bt
from .core import bitmap as bm
from .core import column as col
from .interop.numpy_bridge import (batch_from_numpy, column_from_numpy,
                                   column_to_numpy, decimal_from_int64,
                                   resolve_views, string_view_from_numpy)
from .ops import groupby as gb
from .parallel.distributed import distributed_group_by, distributed_hash_join
from .parallel.mesh import Group, run

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


def check_q1(out: bt.RecordBatch, arrays: dict, want: dict) -> int:
    """Hold q1_step's output to the oracle, exactly: the groups in flag
    order, the flags resolved to bytes, each sum's limbs as an integer and
    its type (Decimal128(38, s)), the means bit for bit, the counts; no
    null row and zero padding.  -> the rows counted."""
    from .core import limbs as lb

    n = len(want["keys"])
    names = Q1_KEYS + [name for name, _ in Q1_AGGS]
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
