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
    return {
        "hot": (hot.numpy(), flag.numpy()),
        "skew": join("unique", left_d, **skew),
        "skew_chunks": join("dups", **skew, probe_chunks=CHUNKS,
                            out_capacity=OUT_CAPACITY),
        "hot_overflow": join("overflow", **skew),
        "chunks": join("unique", left_d, probe_chunks=CHUNKS),
        "dictionary": (ex, ex["d"].values is proto.values),
    }
