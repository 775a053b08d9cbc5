"""The shards of the skew-join parity cases (`tests/test_torch_skew.py`)
and the port's side of them, as one module-level rank function for
`parallel.mesh.run`.  It imports only numpy and the port, so that the
spawned ranks start without JAX.

Every rank holds 512 probe rows: about half of them carry the hot key 7,
8 % have a null key (all nulls hash to one bucket, which is hot too), the
rest spread over 60 keys.  The "skew" and "chunks" cases' probe sides
also carry the dictionary column d of `dictionary_shard` (a payload that
the skew path filters and the chunks cut).  Build sides, 15 distinct keys a rank:
  * "unique": keys unique across ranks, rv 20 % null;
  * "dups": one more row a rank, repeating the hot key 7 (on rank 3) and
    the cold keys 40 and 41, and one key that matches nothing;
  * "overflow": 256 rows a rank; rank 1's 241 extra rows have null keys,
    so its hot build rows exceed HOT_CAPACITY (the others' extra keys
    match nothing).

The cases over other key and column classes (`mixed_shard`,
`text_probe_shard`, `text_build_shard`):
  * "mixed_exchange" / "mixed_group_by": a batch of (k int64, d
    Decimal128(15, 2), s utf8 of 0-16 bytes, inline and arena, f float64
    with signed zeros and NaNs), nulls in every column, exchanged on k,
    and grouped by s with d's sum and count;
  * "text_join" / "text_chunks" / "text_skew": a join on a utf8 key of
    4-14 bytes (both sides' matrices 16 bytes wide, as the JAX package
    needs to meet equal strings), the probe side uniform over 60 keys or,
    for the skew path, half of it on the hot key's string; the build side
    carries a Decimal128 and a utf8 payload of up to 16 bytes, which the
    skew path replicates with its arena;
  * "float_join": the same shards joined on a float64 key (one value per
    key string, -0.0, +0.0 and NaNs among them).
"""

import numpy as np

from arrowtpu_torch import schema as pst
from arrowtpu_torch.core import column as pcol
from arrowtpu_torch.core import batch as pbt
from arrowtpu_torch.interop.numpy_bridge import batch_from_numpy
from arrowtpu_torch.parallel import distributed as pdist
from arrowtpu_torch.parallel import shuffle as pshuffle

NDEV = 4
PROBE_ROWS = 512
HOT_KEY = 7
THRESHOLD = 0.05
HOT_CAPACITY = 128
OUT_CAPACITY = 2048  # room for the N:M rows of "dups" in both packages
CHUNKS = 4
WORDS = ["pear", "apple", "a word longer than twelve bytes", "", "fig"]
BUILD_CASES = ("unique", "dups", "overflow")
# the join keys of the text and float cases: 60 strings of 4-14 bytes
# (inline and arena) and a float64 for each, NaNs and signed zeros among
# them; HOT_KEY's is the skewed one
TEXT_KEYS = ["key%d" % i + "-x" * (i % 5) for i in range(60)]
FLOAT_KEYS = np.concatenate([[0.0, -0.0, np.nan, np.inf, -np.inf],
                             np.arange(55) / 8 - 3])
FLOAT_KEYS.view(np.uint64)[5] = 0x7FF8000000000ABC  # another NaN payload
MIXED_STRINGS = ["", "fig", "twelve bytes", "thirteen byte",
                 "sixteen bytes ok", "é" * 7]
# the mixed batch's group-by: d's aggregates
MIXED_AGGS = [("d", "sum"), ("d", "count")]


def probe_shard(rank):
    rng = np.random.default_rng(70 + rank)
    n = PROBE_ROWS
    k = np.where(rng.random(n) < 0.5, HOT_KEY, rng.integers(0, 60, n))
    v = rng.integers(-1000, 1000, n)
    return {"k": (k, rng.random(n) > 0.08), "v": (v, None)}


def build_shard(rank, case):
    keys = np.arange(15 * rank, 15 * rank + 15)
    ok = None
    if case == "dups":
        keys = np.append(keys, (1000, 40, 41, HOT_KEY)[rank])
    elif case == "overflow":
        keys = np.append(keys, 1000 + 241 * rank + np.arange(241))
        if rank == 1:
            ok = np.arange(len(keys)) < 15
    rng = np.random.default_rng(90 + rank)
    return {"k": (keys, ok),
            "rv": (rng.integers(0, 10**6, len(keys)),
                   rng.random(len(keys)) > 0.2)}


def dictionary_shard(rank):
    """The exchanged batch's arrays: a partition key k uniform over 60
    keys (so that no capped JAX bucket overflows), 8 % null, and keys into
    WORDS for the dictionary column d, 10 % null."""
    rng = np.random.default_rng(110 + rank)
    n = PROBE_ROWS
    return (rng.integers(0, 60, n), rng.random(n) > 0.08,
            rng.integers(0, len(WORDS), n).astype(np.int32),
            rng.random(n) > 0.1)


def mixed_shard(rank):
    """{name: (values, valid)}: k over 60 keys (8 % null), d cents (10 %
    null), s from MIXED_STRINGS (10 % null; as a list with None), f from
    FLOAT_KEYS (10 % null)."""
    rng = np.random.default_rng(130 + rank)
    n = PROBE_ROWS
    s_ok = rng.random(n) > 0.1
    return {"k": (rng.integers(0, 60, n), rng.random(n) > 0.08),
            "d": (rng.integers(-10**9, 10**9, n), rng.random(n) > 0.1),
            "s": [MIXED_STRINGS[i] if ok else None for i, ok in
                  zip(rng.integers(0, len(MIXED_STRINGS), n), s_ok)],
            "f": (FLOAT_KEYS[rng.integers(0, 60, n)], rng.random(n) > 0.1)}


def text_probe_shard(rank, hot):
    """{s: key strings (list, None for a null), f: the keys' floats, v}:
    uniform over the 60 keys, or half of the rows on HOT_KEY's (`hot`);
    8 % null keys."""
    rng = np.random.default_rng(150 + rank)
    n = PROBE_ROWS
    i = rng.integers(0, 60, n)
    if hot:
        i = np.where(rng.random(n) < 0.5, HOT_KEY, i)
    ok = rng.random(n) > 0.08
    return {"s": [TEXT_KEYS[j] if o else None for j, o in zip(i, ok)],
            "f": (FLOAT_KEYS[i], ok), "v": (rng.integers(-1000, 1000, n),
                                           None)}


def text_build_shard(rank):
    """{s, f: keys 15 * rank .. 15 * rank + 14 (unique across ranks), d:
    cents (20 % null), t: a utf8 payload of up to 16 bytes}."""
    rng = np.random.default_rng(170 + rank)
    i = np.arange(15 * rank, 15 * rank + 15)
    return {"s": [TEXT_KEYS[j] for j in i], "f": (FLOAT_KEYS[i], None),
            "d": (rng.integers(0, 10**9, 15), rng.random(15) > 0.2),
            "t": [MIXED_STRINGS[j % len(MIXED_STRINGS)][:14] + str(j)
                  for j in i]}


def port_batch(arrays, device):
    """A port batch of a shard: (values, valid) int64 / float64 arrays,
    "d" as Decimal128(15, 2) cents, string lists as utf8."""
    from arrowtpu_torch.interop.numpy_bridge import (column_from_numpy,
                                                    decimal_from_int64)

    cols = {}
    for name, a in arrays.items():
        if isinstance(a, list):
            cols[name] = pcol.from_pylist(a, pst.utf8, device)
        elif name == "d":
            cols[name] = decimal_from_int64(a[0], pst.Decimal128(15, 2),
                                            a[1], device)
        else:
            cols[name] = column_from_numpy(a[0], a[1], device=device)
    return pbt.record_batch(cols)


def port_rank(group):
    """The port's side of every case on one rank -> {case: result}."""
    dev = group.device
    left = batch_from_numpy(probe_shard(group.rank), device=dev)
    rights = {case: batch_from_numpy(build_shard(group.rank, case),
                                     device=dev) for case in BUILD_CASES}
    hot, flag = pdist.detect_hot_buckets(left, ["k"], group=group,
                                         threshold_frac=THRESHOLD)
    dtype = pst.Dictionary(pst.int32, pst.utf8)
    proto = pcol.dictionary_encode_host(WORDS, dtype, device=dev)
    k, k_ok, keys, ok = dictionary_shard(group.rank)
    d = pcol.DictionaryColumn(pcol.primitive(keys, pst.int32, validity=ok,
                                             device=dev),
                              proto.values, proto.value_ranks, dtype)
    left_d = pbt.record_batch({"k": left["k"], "v": left["v"], "d": d})

    def join(right, probe=left, **kw):
        out, info = pdist.distributed_hash_join(probe, rights[right], ["k"],
                                                group=group, **kw)
        return out, bool(info.duplicates), info.overflow

    skew = dict(skew_threshold=THRESHOLD, hot_capacity=HOT_CAPACITY)
    ex = pshuffle.exchange(pbt.record_batch({
        "k": pcol.primitive(k, validity=k_ok, device=dev), "d": d}), ["k"],
        group)
    mixed = port_batch(mixed_shard(group.rank), dev)
    text = {hot: port_batch(text_probe_shard(group.rank, hot), dev)
            for hot in (False, True)}
    text_build = port_batch(text_build_shard(group.rank), dev)

    def typed_join(on, hot, **kw):
        out, info = pdist.distributed_hash_join(text[hot], text_build, [on],
                                                group=group, **kw)
        return out, bool(info.duplicates), info.overflow

    return {
        "mixed_exchange": pshuffle.exchange(mixed, ["k"], group),
        "mixed_group_by": pdist.distributed_group_by(mixed, ["s"],
                                                     MIXED_AGGS, group=group),
        "text_join": typed_join("s", False),
        "text_chunks": typed_join("s", False, probe_chunks=2),
        "text_skew": typed_join("s", True, **skew, probe_chunks=2),
        "float_join": typed_join("f", False),
        "hot": (hot.numpy(), flag.numpy()),
        "skew": join("unique", left_d, **skew),
        "skew_chunks": join("dups", **skew, probe_chunks=CHUNKS,
                            out_capacity=OUT_CAPACITY),
        "hot_overflow": join("overflow", **skew),
        "chunks": join("unique", left_d, probe_chunks=CHUNKS),
        "dictionary": (ex, ex["d"].values is proto.values),
    }
