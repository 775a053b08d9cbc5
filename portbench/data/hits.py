"""ClickBench's `hits`, the five columns that its queries.sql's queries
2-5, 7-9 and 17 read (`entry.clickbench_step`'s q 1-8), drawn on a
device from a seed.

A frozen copy of the laws that `arrowtpu_torch.entry.example_hits_arrays`
follows (ClickHouse's types from ClickBench's create.sql, NOT NULL), drawn
with a `torch.Generator` on the device instead of numpy:

- UserID (UInt64): a table of random 64-bit hashes, one per user, 17,630,976
  users at the published 99,997,497 rows (the ratio kept at other sizes);
  every (rows // users)-th row takes a permutation of the users, so each
  appears, and the rest floor(users x u**2), heavy-tailed;
- RegionID (UInt32): one of 4,000 distinct ids from [1, 2**15), the id of
  rank floor(4000 x u**3);
- ResolutionWidth (UInt16): one of 30 common screen widths, weights 1/rank;
- AdvEngineID (UInt8): 0 on all but 0.6 % of the rows, else one of 1-30,
  weights 1/rank;
- EventDate (Date): a day of July 2013, uniform.

`generate` returns tensors on the device (UserID as its int64 bits);
`host_arrays` gives the numpy arrays `arrowtpu_torch.entry.hits_batch`
takes (UserID as uint64), which the reference reads too.
"""

from __future__ import annotations

import numpy as np
import torch

ROWS = 99_997_497
USERS = 17_630_976
REGIONS = 4_000
REGION_ID_RANGE = 2**15
ADV_SHARE = 0.006
ADV_ENGINES = 30
WIDTHS = [1366, 1920, 1280, 1024, 1600, 1440, 1536, 1680, 1360, 1400,
          1152, 1280, 2560, 800, 1093, 1344, 1050, 1200, 360, 320,
          375, 414, 768, 980, 1138, 1903, 1097, 1855, 2048, 1017]
FIRST_DAY = int(np.datetime64("2013-07-01", "D").astype(np.int64))
DAYS = 31
COLUMNS = ["UserID", "RegionID", "ResolutionWidth", "AdvEngineID",
           "EventDate"]
NUMPY_TYPES = {"UserID": np.uint64, "RegionID": np.uint32,
               "ResolutionWidth": np.uint16, "AdvEngineID": np.uint8,
               "EventDate": np.int32}


def _rank_draw(g, n: int, k: int, power: float) -> torch.Tensor:
    """n draws in [0, k), heavy at 0: floor(k * u**power)."""
    u = torch.rand(n, generator=g, device=g.device, dtype=torch.float64)
    return (u.pow_(power).mul_(k)).to(torch.int64).clamp_(max=k - 1)


def _by_weight(g, n: int, k: int) -> torch.Tensor:
    """n draws in [0, k) with weights 1/(rank + 1)."""
    w = 1.0 / torch.arange(1, k + 1, dtype=torch.float64, device=g.device)
    cdf = torch.cumsum(w / w.sum(), 0)
    u = torch.rand(n, generator=g, device=g.device, dtype=torch.float64)
    return torch.searchsorted(cdf, u).clamp_(max=k - 1)


def generate(config: dict, seed: int, device, scale: float = 1.0) -> dict:
    """`hits` at the configuration's rows (times `scale`, which tests set
    below 1) -> {column: tensor on `device`}."""
    rows = max(1, round(config["rows"] * scale))
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    users = max(1, round(rows * USERS / ROWS))
    halves = torch.randint(0, 2**32, (2, users), generator=g, device=device,
                           dtype=torch.int64)
    table = (halves[0] << 32) | halves[1]
    idx = _rank_draw(g, rows, users, 2.0)
    step = max(rows // users, 1)
    every = idx[::step][:users]
    every.copy_(torch.randperm(users, generator=g, device=device)[
        :every.shape[0]])
    user_id = table[idx]
    del idx
    ids = torch.randperm(REGION_ID_RANGE - 1, generator=g, device=device)
    regions = (ids[:REGIONS] + 1).to(torch.int32)
    region = regions[_rank_draw(g, rows, REGIONS, 3.0)]
    widths = torch.tensor(WIDTHS, dtype=torch.int32, device=device)
    width = widths[_by_weight(g, rows, len(WIDTHS))]
    has = torch.rand(rows, generator=g, device=device,
                     dtype=torch.float64) < ADV_SHARE
    adv = torch.where(has, 1 + _by_weight(g, rows, ADV_ENGINES), 0)
    date = FIRST_DAY + torch.randint(0, DAYS, (rows,), generator=g,
                                     device=device, dtype=torch.int32)
    return {"UserID": user_id, "RegionID": region, "ResolutionWidth": width,
            "AdvEngineID": adv, "EventDate": date}


def host_arrays(columns: dict) -> dict:
    """The drawn tensors as numpy arrays in ClickHouse's types."""
    out = {}
    for name in COLUMNS:
        host = columns.pop(name).cpu().numpy()
        out[name] = (host.view(np.uint64) if name == "UserID"
                     else host.astype(NUMPY_TYPES[name]))
    return out


def rows(arrays: dict) -> int:
    return len(arrays["UserID"])
