"""ClickBench's queries over `hits` in plain PyTorch, by their text in
ClickBench's queries.sql (numbered as `entry.clickbench_step` numbers
them; queries.sql's own number in brackets):

    4 (5): SELECT COUNT(DISTINCT UserID) FROM hits;
    6 (8): SELECT AdvEngineID, COUNT(*) FROM hits WHERE AdvEngineID <> 0
           GROUP BY AdvEngineID ORDER BY COUNT(*) DESC;
    7 (9): SELECT RegionID, COUNT(DISTINCT UserID) AS u FROM hits
           GROUP BY RegionID ORDER BY u DESC LIMIT 10;
    8 (17): SELECT UserID, COUNT(*) FROM hits GROUP BY UserID
            ORDER BY COUNT(*) DESC LIMIT 10;

over the drawn `hits` arrays (portbench.data.hits), with ties in an ORDER
BY broken by the key ascending (UserID as unsigned).  COUNT(DISTINCT) is
exact over all 64 bits.  With `control` UserID keeps its low 32 bits (the
step a sort of 32-bit keys would take); its answer has to fail the
comparison.

An answer is an int (4) or a list of (key, count) pairs of Python ints.
"""

from __future__ import annotations

import numpy as np
import torch

LIMIT = 10
SIGN = -(1 << 63)


def _top(keys: torch.Tensor, counts: torch.Tensor, limit, unsigned=False):
    """ORDER BY count DESC, key ASC [LIMIT limit] -> [(key, count)]."""
    order_key = keys ^ SIGN if unsigned else keys
    by_key = torch.sort(order_key, stable=True).indices
    by_count = torch.sort(counts[by_key], descending=True, stable=True).indices
    pick = by_key[by_count]
    if limit is not None:
        pick = pick[:limit]
    ks = keys[pick].tolist()
    if unsigned:
        ks = [k & (2**64 - 1) for k in ks]
    return list(zip(ks, counts[pick].tolist()))


def answer(arrays: dict, q: int, device, control: bool = False):
    def dev(name):
        a = arrays[name]
        if isinstance(a, np.ndarray) and a.dtype == np.uint64:
            a = a.view(np.int64)
        return torch.as_tensor(a, device=device).to(torch.int64)

    if q == 6:
        adv = dev("AdvEngineID")
        counts = torch.bincount(adv[adv != 0], minlength=256)
        keys = torch.nonzero(counts).flatten()
        return _top(keys, counts[keys], None)
    uid = dev("UserID")
    if control:
        uid = uid & 0xFFFFFFFF
    if q == 4:
        return int(torch.unique(uid).shape[0])
    if q == 8:
        users, counts = torch.unique(uid, return_counts=True)
        return _top(users, counts, LIMIT, unsigned=True)
    if q == 7:
        _, user = torch.unique(uid, return_inverse=True)
        del uid
        pairs = torch.unique((dev("RegionID") << 32) | user)
        regions, u = torch.unique_consecutive(pairs >> 32, return_counts=True)
        return _top(regions, u, LIMIT)
    raise ValueError(f"no reference for ClickBench query {q}")
