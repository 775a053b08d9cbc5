"""date_part of every temporal type in arrowtpu_torch.ops.temporal against
arrowtpu.ops.temporal, and the zone tables of arrowtpu_torch.ops.tzdb
against arrowtpu.ops.tzdb.

The JAX package's date_part costs seconds a call on the CPU (its 64-bit
arithmetic runs on u32 limb pairs, traced op by op), so each part is held
in the two halves it is made of there: per type, the port's split of each
row into (days since 1970, nanoseconds of the day) against the JAX
package's `_to_days_and_subsec_ns` (a timestamp or duration in s, ms or us
given to it in nanoseconds, which is its own first step); then every part of the port on every
type against the JAX package's date_part of one Date32 column of all the
types' days (the day parts) and one Time64("ns") column of all their times
of day (the time parts), which is what its date_part of each type
computes from that split.  Zones: Europe/Moscow and +05:45 through the JAX
split, with instants on both sides of every Moscow transition since 1900;
the other zones by their tables (`zone_table`, `offsets_for`) and the
port's search against the JAX package's sum over the table, in numpy.

Fault 15 (ROADMAP C.3): the JAX package widens s, ms and us instants to
nanoseconds in 64 bits, which wraps outside 1677-2262, so instants there
are held to Python's datetime instead.

Tolerance: exact; validity is the input's, rows past the length are 0.
"""

import datetime as dt

import numpy as np
import pytest

import arrowtpu.schema as js
from arrowtpu.core import column as jcol
from arrowtpu.core import wide as jwd
from arrowtpu.ops import temporal as jt
from arrowtpu.ops import tzdb as jtz

import torch_parity  # noqa: F401  (one torch thread a worker)
from torch_parity import release_jax_caches  # noqa: F401
import arrowtpu_torch.schema as ps
from arrowtpu_torch.core import column as pcol
from arrowtpu_torch.ops import temporal as pt_
from arrowtpu_torch.ops import tzdb as ptz

N = 300
# nanosecond-range instants (1700 to 2250) in seconds
_SPAN_S = (-8_520_000_000, 8_800_000_000)
MOSCOW_T = jtz.zone_table("Europe/Moscow")[0]


def _draw(rng, lo, hi, unit_per_s=1, near=()):
    """N instants in [lo, hi) seconds in a unit, `near` first, then -1, 0
    and 1 last."""
    v = rng.integers(lo, hi, N, dtype=np.int64) * unit_per_s \
        + rng.integers(0, unit_per_s, N)
    near = np.asarray(near, np.int64)[:N - 3]
    v[:len(near)] = near
    v[N - 3:] = [-1, 0, 1]
    return v


def _cases():
    rng = np.random.default_rng(15)
    around = np.stack([MOSCOW_T - 1, MOSCOW_T, MOSCOW_T + 1], 1).reshape(-1)
    around = around[around > -2_208_988_800]  # since 1900
    out = {}
    for unit, per_s in (("s", 1), ("ms", 10**3), ("us", 10**6),
                        ("ns", 10**9)):
        out[f"ts_{unit}"] = (js.Timestamp(unit), ps.Timestamp(unit),
                             _draw(rng, *_SPAN_S, per_s))
    # a Duration takes the Timestamp path in both packages: one unit
    out["dur_ms"] = (js.Duration("ms"), ps.Duration("ms"),
                     _draw(rng, -10**9, 10**9, 10**3))
    out["ts_ms_moscow"] = (js.Timestamp("ms", "Europe/Moscow"),
                           ps.Timestamp("ms", "Europe/Moscow"),
                           _draw(rng, *_SPAN_S, 10**3, around * 10**3))
    out["ts_s_545"] = (js.Timestamp("s", "+05:45"),
                       ps.Timestamp("s", "+05:45"), _draw(rng, *_SPAN_S))
    out["date64"] = (js.Date64(), ps.Date64(), _draw(rng, *_SPAN_S, 10**3))
    out["date32"] = (js.Date32(), ps.Date32(),
                     rng.integers(-100_000, 100_000, N).astype(np.int32))
    out["time32_s"] = (js.Time32("s"), ps.Time32("s"),
                       rng.integers(0, 86_400, N).astype(np.int32))
    out["time32_ms"] = (js.Time32("ms"), ps.Time32("ms"),
                        rng.integers(0, 86_400_000, N).astype(np.int32))
    out["time64_us"] = (js.Time64("us"), ps.Time64("us"),
                        rng.integers(0, 86_400 * 10**6, N))
    out["time64_ns"] = (js.Time64("ns"), ps.Time64("ns"),
                        rng.integers(0, 86_400 * 10**9, N))
    valid = rng.random(N) > 0.1
    return out, valid


CASES, VALID = _cases()


_UNIT_NS = {"s": 10**9, "ms": 10**6, "us": 10**3, "ns": 1}


def _as_split(jdt, v):
    """A case as the JAX package's split reads it: a timestamp or duration
    as its nanoseconds (the JAX package's own first step, exact in this
    range), so that one split call serves every unit."""
    if isinstance(jdt, (js.Timestamp, js.Duration)):
        return js.Timestamp("ns", getattr(jdt, "tz", None)), \
            v * _UNIT_NS[jdt.unit]
    return jdt, v


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's split of every case (one call per split type),
    then its date_part of all the days as one Date32 column and of all the
    times of day as one Time64("ns") column: ({part: values}, {case:
    (days, ns)})."""
    groups = {}
    for name, (jdt, _, v) in CASES.items():
        sdt, sv = _as_split(jdt, v)
        _, names, vals = groups.setdefault(str(sdt), (sdt, [], []))
        names.append(name)
        vals.append(sv)
    split = {}
    rows = len(CASES) * N  # one shape for every call: eager JAX compiles
    for sdt, names, vals in groups.values():  # each op once per shape
        v = np.concatenate(vals)
        v = np.concatenate([v, np.zeros(rows - len(v), v.dtype)])
        days, ns = jt._to_days_and_subsec_ns(jcol.primitive(v, sdt))
        days = np.asarray(days).astype(np.int64)
        ns = jwd.join_numpy(np.asarray(ns), np.int64)
        for i, name in enumerate(names):
            split[name] = (days[i * N:(i + 1) * N], ns[i * N:(i + 1) * N])
    days = np.concatenate([split[n][0] for n in CASES]).astype(np.int32)
    ns = np.concatenate([split[n][1] for n in CASES])
    dcol = jcol.primitive(days, js.Date32())
    tcol = jcol.primitive(ns, js.Time64("ns"))
    parts = {}
    for part in jt.PARTS:
        c = tcol if part in pt_._TIME_PARTS else dcol
        parts[part] = np.asarray(jt.date_part(c, part).values)[:len(days)]
    return parts, split


def _port(name):
    _, pdt, v = CASES[name]
    return pcol.primitive(v, pdt, validity=VALID, device="cpu")


@pytest.mark.parametrize("name", list(CASES))
def test_split_matches_jax(jax_side, name):
    days, ns = pt_._days_and_time(_port(name))
    want_days, want_ns = jax_side[1][name]
    np.testing.assert_array_equal(days[:N].numpy(), want_days)
    np.testing.assert_array_equal(ns[:N].numpy(), want_ns)


@pytest.mark.parametrize("name", list(CASES))
def test_every_part_matches_jax(jax_side, name):
    at = list(CASES).index(name) * N
    c = _port(name)
    for part in pt_.PARTS:
        out = pt_.date_part(c, part)
        assert str(out.dtype) == "int32" and out.length == N
        np.testing.assert_array_equal(
            out.values[:N].numpy(), jax_side[0][part][at:at + N],
            err_msg=f"{name} {part}")
        np.testing.assert_array_equal(out.valid_bool()[:N].numpy(), VALID)
        assert not out.values[N:].any()


def test_accessors_and_unknown_part():
    c = _port("ts_s_545")
    for f in (pt_.year, pt_.month, pt_.day, pt_.hour, pt_.minute,
              pt_.second):
        assert f(c).to_pylist() == pt_.date_part(c, f.__name__).to_pylist()
    with pytest.raises(ps.ComputeError):
        pt_.date_part(c, "fortnight")
    with pytest.raises(ps.ComputeError):
        pt_.date_part(pcol.primitive(np.arange(3), ps.int64, device="cpu"),
                      "year")


def _datetime_parts(t: dt.datetime):
    iso = t.isocalendar()
    return {"year": t.year, "quarter": (t.month - 1) // 3 + 1,
            "month": t.month, "week": iso[1], "day": t.day,
            "day_of_week_sunday0": t.isoweekday() % 7,
            "day_of_week_monday0": t.weekday(),
            "day_of_year": t.timetuple().tm_yday, "hour": t.hour,
            "minute": t.minute, "second": t.second,
            "millisecond": t.microsecond // 1000,
            "microsecond": t.microsecond, "nanosecond": t.microsecond * 1000}


@pytest.mark.parametrize("unit", ["s", "ms", "us"])
def test_outside_the_nanosecond_range_held_to_datetime(unit):
    """Fault 15: 1500 and 2500 (and the ends of datetime's range) from the
    unit's own value; the JAX package wraps these, so Python's datetime
    is the oracle."""
    per_s = {"s": 1, "ms": 10**3, "us": 10**6}[unit]
    epoch = dt.datetime(1970, 1, 1)
    when = [dt.datetime(1500, 6, 1, 13, 14, 15, 123456),
            dt.datetime(2500, 6, 1, 1, 2, 3, 999999),
            dt.datetime(1, 1, 1), dt.datetime(9999, 12, 31, 23, 59, 59),
            dt.datetime(1677, 9, 21), dt.datetime(2262, 4, 12)]
    when = [w.replace(microsecond=w.microsecond // (10**6 // per_s)
                      * (10**6 // per_s)) for w in when]
    vals = np.array([(w - epoch) // dt.timedelta(microseconds=10**6 // per_s)
                     for w in when], np.int64)
    # the zone's case leaves out the ends, which +05:45 would carry past
    for tz, rows in ((None, slice(None)), ("+05:45", [0, 1, 4, 5])):
        shift = dt.timedelta(minutes=345 if tz else 0)
        c = pcol.primitive(vals[rows], ps.Timestamp(unit, tz), device="cpu")
        for part in pt_.PARTS:
            want = [_datetime_parts(w + shift)[part]
                    for w in np.array(when, object)[rows]]
            assert pt_.date_part(c, part).to_pylist() == want, (unit, tz,
                                                                part)


ZONES = ["Europe/Moscow", "America/New_York", "Australia/Lord_Howe",
         "+05:45", "UTC", "Europe/London", "Asia/Kolkata",
         "America/Sao_Paulo", "Pacific/Apia", "Asia/Kathmandu"]


@pytest.mark.parametrize("tz", ZONES)
def test_zone_table_matches_jax(tz):
    times, offs = ptz.zone_table(tz)
    jtimes, joffs = jtz.zone_table(tz)
    np.testing.assert_array_equal(times, jtimes)
    np.testing.assert_array_equal(offs, joffs)
    assert times.dtype == np.int64 and offs.dtype == np.int32
    base, t, d = ptz.offsets_for(tz)
    jbase, jt_times, jd = jtz.offsets_for(tz)
    assert base == jbase
    np.testing.assert_array_equal(t, jt_times)
    np.testing.assert_array_equal(d, jd)
    # the port's one search equals the JAX package's sum over the table
    probe = np.concatenate([times - 1, times, times + 1,
                            np.array([-2**40, 0, 2**40])])
    import torch

    got = pt_.utc_offsets(torch.from_numpy(probe), tz).numpy()
    want = base + (d[None, :] * (probe[:, None] >= t[None, :])).sum(1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bad", ["Nowhere", "Mars/Olympus_Mons",
                                 "../etc/passwd", "/etc/localtime",
                                 "+25:00", ""])
def test_bad_zone_names_raise(bad):
    with pytest.raises(ps.ArrowTpuError):
        ptz.zone_table(bad)
    with pytest.raises(js.ArrowTpuError):
        jtz.zone_table(bad)
