"""Temporal kernels: date_part extraction.

Counterpart of `arrowtpu/ops/temporal.py`: `date_part(column, part)` for
Date32, Date64, Timestamp (with and without a time zone), Duration,
Time32 and Time64, and `year` ... `second`.  Everything is int64 with floor
division and remainder (`torch.div(..., rounding_mode="floor")`,
`torch.remainder`), so instants before 1970 decompose as the JAX package
decomposes them (Date64 -1 ms is 23:59:59.999 of 1969-12-31).  Days to
(year, month, day) is the civil-from-days algorithm (Howard Hinnant's
public-domain date algorithms), as in the JAX package.

Two differences by design:

  * a zone is applied by one `torch.searchsorted` of the rows' UTC seconds
    over the zone's transition times and one gather of the offsets
    (`tzdb.zone_table`); the JAX package adds one term a transition
    (`base + sum_i delta_i * [t >= T_i]`, 562 passes over the rows for
    America/New_York).  The two agree wherever the transitions ascend,
    which `_zone` asserts when it builds a zone's tables;
  * a timestamp or duration in s, ms or us splits into days and time of
    day from its own unit's value.  The JAX package widens it to
    nanoseconds in 64 bits first, which wraps outside 1677-2262 (ROADMAP
    C.3, fault 15); inside that range the two agree.

Results are Int32 with the input's validity; rows past the length are 0.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import schema as st
from ..core import column as col
from . import tzdb

# DatePart names, in the JAX package's order
PARTS = (
    "year", "quarter", "month", "week", "day", "day_of_week_sunday0",
    "day_of_week_monday0", "day_of_year", "hour", "minute", "second",
    "millisecond", "microsecond", "nanosecond",
)
_TIME_PARTS = ("hour", "minute", "second", "millisecond", "microsecond",
               "nanosecond")
_PER_SECOND = {"s": 1, "ms": 10**3, "us": 10**6, "ns": 10**9}
_DAY_S = 86_400
_DAY_MS = 86_400_000


def _floor_div(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


@functools.lru_cache(maxsize=64)
def _zone(tz: str, device: torch.device):
    """The zone's (transition seconds int64, offsets int64) on `device`,
    made once per zone and device; the transitions must not descend, or
    a search would not give the JAX package's sum."""
    times, offs = tzdb.zone_table(tz)
    if np.any(np.diff(times) < 0):
        raise st.ComputeError(f"tz {tz!r}: transition times descend")
    return (torch.from_numpy(np.ascontiguousarray(times, np.int64)).to(device),
            torch.from_numpy(offs.astype(np.int64)).to(device))


def utc_offsets(sec_utc: torch.Tensor, tz: str) -> torch.Tensor:
    """Each UTC second's offset east of UTC under `tz`, in seconds (int64):
    one search of the transitions, one gather."""
    times, offs = _zone(tz, sec_utc.device)
    if times.numel() == 0:
        return offs[0].expand(sec_utc.shape)
    return offs[torch.searchsorted(times, sec_utc.contiguous(), right=True)]


def offsets_between(tz: str, lo_sec: int, hi_sec: int) -> np.ndarray:
    """The offsets (seconds east of UTC) `tz` gives to instants in
    [lo_sec, hi_sec], from its table on the host."""
    times, offs = tzdb.zone_table(tz)
    a, b = np.searchsorted(times, [lo_sec, hi_sec], side="right")
    return offs[a:b + 1]


def _days_and_time(c: col.PrimitiveColumn):
    """-> (days since 1970-01-01 int64, nanoseconds of the day int64), in
    local time for a zoned timestamp."""
    dt, v = c.dtype, c.values.to(torch.int64)
    if isinstance(dt, st.Date32):
        return v, torch.zeros_like(v)
    if isinstance(dt, st.Date64):
        days = _floor_div(v, _DAY_MS)
        return days, (v - days * _DAY_MS) * 10**6
    if isinstance(dt, (st.Timestamp, st.Duration)):
        per_s = _PER_SECOND[dt.unit]
        if isinstance(dt, st.Timestamp) and dt.tz:
            v = v + utc_offsets(_floor_div(v, per_s), dt.tz) * per_s
        per_day = _DAY_S * per_s
        days = _floor_div(v, per_day)
        return days, (v - days * per_day) * (10**9 // per_s)
    if isinstance(dt, (st.Time32, st.Time64)):
        return torch.zeros_like(v), v * (10**9 // _PER_SECOND[dt.unit])
    raise st.ComputeError(f"date_part: not a temporal column ({dt})")


_CUM_DAYS = np.concatenate(
    [[0], np.cumsum([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30])])


@functools.lru_cache(maxsize=8)
def _cum_days(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_CUM_DAYS.astype(np.int64)).to(device)


def _civil_from_days(days: torch.Tensor):
    """days since 1970-01-01 (int64) -> (year, month, day, day of year)."""
    z = days + 719468
    era = _floor_div(z, 146097)
    doe = z - era * 146097  # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)  # [0, 365]
    mp = (5 * doy + 2) // 153  # [0, 11], March = 0
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    leap = ((torch.remainder(y, 4) == 0) & (torch.remainder(y, 100) != 0)
            ) | (torch.remainder(y, 400) == 0)
    day_of_year = _cum_days(days.device)[m - 1] + d + (leap & (m > 2))
    return y, m, d, day_of_year


def _part(days: torch.Tensor, ns: torch.Tensor, part: str) -> torch.Tensor:
    if part in _TIME_PARTS:
        sec = _floor_div(ns, 10**9)
        subsec = ns - sec * 10**9
        return {"hour": lambda: _floor_div(sec, 3600),
                "minute": lambda: torch.remainder(_floor_div(sec, 60), 60),
                "second": lambda: torch.remainder(sec, 60),
                "millisecond": lambda: _floor_div(subsec, 10**6),
                "microsecond": lambda: _floor_div(subsec, 10**3),
                "nanosecond": lambda: subsec}[part]()
    if part in ("day_of_week_sunday0", "day_of_week_monday0"):
        sun0 = torch.remainder(days + 4, 7)  # 1970-01-01 was a Thursday
        return sun0 if part == "day_of_week_sunday0" else torch.remainder(
            sun0 + 6, 7)
    if part == "week":  # ISO week: the week of this week's Thursday
        thursday = days - torch.remainder(days + 3, 7) + 3
        return (_civil_from_days(thursday)[3] - 1) // 7 + 1
    y, m, d, doy = _civil_from_days(days)
    return {"year": y, "quarter": (m - 1) // 3 + 1, "month": m, "day": d,
            "day_of_year": doy}[part]


def date_part(c: col.PrimitiveColumn, part: str) -> col.PrimitiveColumn:
    """`part` (one of PARTS) of each row as Int32; millisecond,
    microsecond and nanosecond are the sub-second remainder in that unit."""
    if part not in PARTS:
        raise st.ComputeError(f"unknown date part {part!r} (have {PARTS})")
    days, ns = _days_and_time(c)
    out = _part(days, ns, part).to(torch.int32)
    out[c.length:] = 0
    return col.PrimitiveColumn(out, c.validity, c.length, st.int32)


def year(c):
    return date_part(c, "year")


def month(c):
    return date_part(c, "month")


def day(c):
    return date_part(c, "day")


def hour(c):
    return date_part(c, "hour")


def minute(c):
    return date_part(c, "minute")


def second(c):
    return date_part(c, "second")
