"""Timezone database: TZif (RFC 8536) parser + fixed-offset parsing.

Counterpart of `arrowtpu/ops/tzdb.py`, host code in numpy: a zone becomes
a small static table of (UTC transition second, offset in effect from
it), read from the host's TZif files (/usr/share/zoneinfo and its usual
alternatives).  Fixed offsets ("+HH:MM", "+HHMM", "+HH:MM:SS") parse
without a file.  Version 2+ blocks (64-bit transition times) are used
when present.  Instants beyond the last explicit transition are governed
by the version-2+ footer's POSIX TZ string (RFC 8536 section 3.3):
recurring DST transitions are synthesized through year
_FOOTER_HORIZON_YEAR and appended to the table, so slim-format tzdata and
far-future instants get correct offsets.  The offset before the first
transition is that of the first non-DST type (RFC 8536 section 3.2).

`zone_table` and `offsets_for` return the JAX package's arrays; the port
applies a zone with one search of the table (ops/temporal.py), where the
JAX package sums one term per transition.
"""

from __future__ import annotations

import functools
import os
import struct
from typing import Tuple

import numpy as np

from .. import schema as st

_ZONEINFO_DIRS = (
    "/usr/share/zoneinfo",
    "/usr/lib/zoneinfo",
    "/etc/zoneinfo",
)


def _parse_fixed(tz: str):
    """'+HH:MM' / '-HH:MM' / '+HH:MM:SS' / '+HHMM' fixed offsets ->
    seconds east of UTC, or None."""
    if not tz or tz[0] not in "+-":
        return None
    sign = 1 if tz[0] == "+" else -1
    body = tz[1:]
    parts = body.split(":")
    try:
        if len(parts) == 1 and len(body) == 4:  # +HHMM
            h, m, s = int(body[:2]), int(body[2:]), 0
        else:
            h = int(parts[0])
            m = int(parts[1]) if len(parts) > 1 else 0
            s = int(parts[2]) if len(parts) > 2 else 0
    except ValueError:
        return None
    if h > 23 or m > 59 or s > 59:
        return None
    return sign * (h * 3600 + m * 60 + s)


_FOOTER_HORIZON_YEAR = 2200


def _parse_posix_tz(tzstr: str):
    """RFC 8536 §3.3 / POSIX TZ string: returns
    (std_utoff, dst_utoff|None, start_rule, end_rule) where each rule is
    (kind, a, b, c, seconds) with kind in {'M', 'J', 'n'}.  POSIX offsets
    are west-positive; returned utoffs are east-positive (UT offsets)."""
    s = tzstr.strip()
    if not s or s.startswith(":"):
        return None
    pos = 0

    def name():
        nonlocal pos
        if pos < len(s) and s[pos] == "<":
            end = s.find(">", pos)
            if end < 0:
                return None
            nm = s[pos + 1:end]
            pos = end + 1
            return nm
        p0 = pos
        while pos < len(s) and (s[pos].isalpha()):
            pos += 1
        return s[p0:pos] if pos > p0 else None

    def offset(default=None):
        """[+-]hh[:mm[:ss]] -> seconds, or default when absent."""
        nonlocal pos
        p0 = pos
        sign = 1
        if pos < len(s) and s[pos] in "+-":
            sign = -1 if s[pos] == "-" else 1
            pos += 1
        d0 = pos
        while pos < len(s) and s[pos].isdigit():
            pos += 1
        if pos == d0:
            pos = p0
            return default
        h = int(s[d0:pos])
        m = sec = 0
        for slot in range(2):
            if pos < len(s) and s[pos] == ":":
                pos += 1
                d0 = pos
                while pos < len(s) and s[pos].isdigit():
                    pos += 1
                v = int(s[d0:pos] or "0")
                if slot == 0:
                    m = v
                else:
                    sec = v
        return sign * (h * 3600 + m * 60 + sec)

    def rule():
        nonlocal pos
        if pos < len(s) and s[pos] == ",":
            pos += 1
        if pos >= len(s):
            return None
        if s[pos] == "M":
            pos += 1
            parts = []
            for i in range(3):
                d0 = pos
                while pos < len(s) and s[pos].isdigit():
                    pos += 1
                parts.append(int(s[d0:pos]))
                if i < 2:
                    if pos >= len(s) or s[pos] != ".":
                        return None
                    pos += 1
            kind, a, b, c = "M", parts[0], parts[1], parts[2]
        elif s[pos] == "J":
            pos += 1
            d0 = pos
            while pos < len(s) and s[pos].isdigit():
                pos += 1
            kind, a, b, c = "J", int(s[d0:pos]), 0, 0
        else:
            d0 = pos
            while pos < len(s) and s[pos].isdigit():
                pos += 1
            if pos == d0:
                return None
            kind, a, b, c = "n", int(s[d0:pos]), 0, 0
        t = 2 * 3600
        if pos < len(s) and s[pos] == "/":
            pos += 1
            t = offset(default=2 * 3600)
        return (kind, a, b, c, t)

    if name() is None:
        return None
    std = offset()
    if std is None:
        return None
    std_ut = -std  # POSIX west-positive -> UT offset
    if pos >= len(s) or s[pos] == ",":
        return std_ut, None, None, None
    if name() is None:
        return None
    dst = offset(default=std - 3600)  # default: one hour ahead of std
    dst_ut = -dst
    start = rule()
    end = rule()
    if start is None or end is None:
        # "std offset dst" with no rules: US rules implied historically;
        # treat as M3.2.0,M11.1.0 (current US law, what glibc does)
        start = ("M", 3, 2, 0, 2 * 3600)
        end = ("M", 11, 1, 0, 2 * 3600)
    return std_ut, dst_ut, start, end


def _rule_local_epoch_days(year: int, rule) -> int:
    """Days from 1970-01-01 to the rule's local date in `year`."""
    import datetime as _dt

    kind, a, b, c, _t = rule
    if kind == "M":
        # day c (0=Sunday) of week b (1..5, 5=last) of month a
        first = _dt.date(year, a, 1)
        # Python weekday(): Monday=0..Sunday=6; POSIX day: Sunday=0
        first_dow = (first.weekday() + 1) % 7
        day1 = 1 + (c - first_dow) % 7 + (b - 1) * 7
        if a == 12:
            ndays = 31
        else:
            ndays = (_dt.date(year, a + 1, 1) - first).days
        while day1 > ndays:
            day1 -= 7
        d = _dt.date(year, a, day1)
    elif kind == "J":
        # Jn: 1-based day, Feb 29 never counted
        d = _dt.date(year, 1, 1) + _dt.timedelta(days=a - 1)
        if a >= 60 and _dt.date(year, 3, 1).toordinal() - _dt.date(
                year, 1, 1).toordinal() == 60:
            d += _dt.timedelta(days=1)  # leap year: skip Feb 29
    else:
        # n: 0-based day counting Feb 29
        d = _dt.date(year, 1, 1) + _dt.timedelta(days=a)
    return (d - _dt.date(1970, 1, 1)).days


def _footer_transitions(tzstr: str, after: int, last_off: int):
    """Synthesize (times, offsets) past `after` from the footer TZ string.
    Returns (int64 times[], int32 offsets[]) where offsets[i] applies at
    t >= times[i]; empty when the footer has no DST rules."""
    parsed = _parse_posix_tz(tzstr)
    if parsed is None:
        return np.zeros(0, np.int64), np.zeros(0, np.int32)
    std_ut, dst_ut, start, end = parsed
    if dst_ut is None:
        if std_ut != last_off:
            return (np.array([after + 1], np.int64),
                    np.array([std_ut], np.int32))
        return np.zeros(0, np.int64), np.zeros(0, np.int32)
    import datetime as _dt

    y0 = _dt.datetime.fromtimestamp(max(min(after, 2**40), -2**40),
                                    _dt.timezone.utc).year
    times, offs = [], []
    for year in range(y0, _FOOTER_HORIZON_YEAR + 1):
        # start rule's local time is in STD; end rule's in DST
        t_start = (_rule_local_epoch_days(year, start) * 86400
                   + start[4] - std_ut)
        t_end = (_rule_local_epoch_days(year, end) * 86400
                 + end[4] - dst_ut)
        for t, off in sorted(((t_start, dst_ut), (t_end, std_ut))):
            if t > after:
                times.append(t)
                offs.append(off)
    return np.asarray(times, np.int64), np.asarray(offs, np.int32)


def _read_tzif(path: str):
    """RFC 8536: returns (transition_times int64[], offsets int32[]) where
    offsets[i] applies to t >= times[i-1] (offsets[0] = before the first
    transition)."""
    with open(path, "rb") as f:
        data = f.read()

    def parse_block(buf, off, tsize, tfmt):
        (isutcnt, isstdcnt, leapcnt, timecnt, typecnt, charcnt,
         ) = struct.unpack_from(">6I", buf, off + 20)
        p = off + 44
        times = np.frombuffer(buf, tfmt, timecnt, p).astype(np.int64)
        p += timecnt * tsize
        idx = np.frombuffer(buf, np.uint8, timecnt, p)
        p += timecnt
        utoffs = np.zeros(typecnt, np.int32)
        isdst = np.zeros(typecnt, np.bool_)
        for i in range(typecnt):
            utoff, dst, _di = struct.unpack_from(">iBB", buf, p + 6 * i)
            utoffs[i] = utoff
            isdst[i] = bool(dst)
        p += typecnt * 6 + charcnt + leapcnt * (tsize + 4)
        p += isstdcnt + isutcnt
        return times, idx, utoffs, isdst, p

    if data[:4] != b"TZif":
        raise st.ArrowTpuError(f"tz: not a TZif file: {path}")
    version = data[4:5]
    times, idx, utoffs, isdst, end = parse_block(data, 0, 4, ">i4")
    footer = b""
    if version in (b"2", b"3", b"4") and end < len(data) \
            and data[end : end + 4] == b"TZif":
        times, idx, utoffs, isdst, end2 = parse_block(data, end, 8, ">i8")
        # RFC 8536 §3.3: "\n" TZ-string "\n" footer after the v2+ block
        tail = data[end2:]
        if tail.startswith(b"\n"):
            nl = tail.find(b"\n", 1)
            if nl > 0:
                footer = tail[1:nl]

    if len(utoffs) == 0:
        raise st.ArrowTpuError(f"tz: no types in {path}")
    # initial offset (before the first transition): the first non-DST
    # type per RFC 8536 §3.2 (type 0 is wrong
    # for zones whose first listed type is a DST type)
    std_types = np.flatnonzero(~isdst)
    init = utoffs[std_types[0]] if std_types.size else utoffs[0]
    seq = utoffs[idx] if len(idx) else np.zeros(0, np.int32)
    offs = np.concatenate([[init], seq]).astype(np.int32)
    if footer:
        last_t = int(times[-1]) if len(times) else -(2**62)
        ft, fo = _footer_transitions(footer.decode("ascii", "replace"),
                                     last_t, int(offs[-1]))
        if ft.size:
            times = np.concatenate([times, ft])
            offs = np.concatenate([offs, fo]).astype(np.int32)
    return times, offs


@functools.lru_cache(maxsize=256)
def zone_table(tz: str) -> Tuple[np.ndarray, np.ndarray]:
    """(transition UTC seconds int64[], per-interval offsets int32[]);
    offsets has len(times)+1 entries (offsets[0] = before times[0]).

    Raises ArrowTpuError for unknown zones."""
    fixed = _parse_fixed(tz)
    if fixed is not None:
        return np.zeros(0, np.int64), np.array([fixed], np.int32)
    if tz in ("UTC", "utc", "Etc/UTC", "Z", "+00:00"):
        return np.zeros(0, np.int64), np.array([0], np.int32)
    if "/" not in tz and tz not in ("GMT", "EST", "MST", "HST", "CET",
                                    "EET", "MET", "WET"):
        raise st.ArrowTpuError(f"tz: unknown timezone {tz!r}")
    if ".." in tz or tz.startswith("/"):
        raise st.ArrowTpuError(f"tz: bad timezone name {tz!r}")
    for d in _ZONEINFO_DIRS:
        path = os.path.join(d, tz)
        if os.path.exists(path):
            return _read_tzif(path)
    raise st.ArrowTpuError(f"tz: timezone {tz!r} not in host tzdata")


def offsets_for(tz: str):
    """(base offset int32, transition seconds int64[], deltas int32[]):
    offset(t) = base + sum_i deltas[i] * [t >= times[i]]."""
    times, offs = zone_table(tz)
    base = int(offs[0])
    deltas = np.diff(offs).astype(np.int32)
    return base, times, deltas
