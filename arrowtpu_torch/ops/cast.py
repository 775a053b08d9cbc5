"""Type casts: `can_cast_types` and `cast` with `CastOptions`.

Counterpart of `arrowtpu/ops/cast.py`, branch for branch:

  * numeric, boolean and temporal-as-integer casts run on the device with
    exact range checks: a value the target cannot hold (out of range, a
    negative into an unsigned type, NaN into an integer) is a null under
    `CastOptions(safe=True)`, its value zeroed, and raises ComputeError
    under `safe=False` (one read-back).  Float targets never fail
    (float32 70000.0 -> float16 is inf).  uint64 reads its int64 bits as
    unsigned: to a float it is `hi * 2**32 + lo` (`core/u64.to_float`,
    one rounding, then the narrower float's own rounding, as the JAX
    package does); int64 -> uint64 and uint64 -> int64 fail on the same
    bits, the top one;
  * temporal to temporal: unit changes multiply (wrapping) or divide
    (truncating; toward minus infinity for a timestamp or Date64 to a
    date), dates and timestamps by the day's milliseconds;
  * intervals: year_month or day_time -> month_day_nano, month_day_nano
    <-> duration (a row with months or days fails), integers <->
    year_month;
  * fixed-size binary <-> binary / utf8 (a string of another length
    fails);
  * decimals through `ops/decimal` (`rescale`, `to_int`, `from_int`,
    `to_float`, `from_float`, `to_string`, `from_string`);
  * nested casts child by child (list, fixed-size list, struct by
    position, map entries);
  * a union source: the first child whose type is the target, else the
    first castable one, extracted (`ops/union.union_extract`) and cast;
    no cast to a union;
  * a dictionary source casts its values and keeps its keys when the
    target is a dictionary, else decodes (`dictionary_decode`: the values
    taken by key); a dictionary target encodes on the host
    (`dictionary_encode`);
  * string parse and format run on the host, as in the JAX package.

A failed cast of a row that is null anyway leaves the row null, its value
zeroed.  Unsupported pairs raise CastError.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt

import numpy as np
import torch

from .. import schema as st
from ..config import CastOptions
from ..core import bitmap as bm
from ..core import column as col
from ..core import u64
from .numeric import raise_if

_INTISH = (st.Timestamp, st.Date32, st.Date64, st.Time32, st.Time64,
           st.Duration)
_UNIT_NS = {"s": 10**9, "ms": 10**6, "us": 10**3, "ns": 1}
_MS_PER_DAY = 86_400_000


def _is_numeric(d: st.DataType) -> bool:
    return isinstance(d, (st.Int, st.Float)) or st.decimal_limbs(d) is not None


def _storage_int(dt: st.DataType) -> st.DataType:
    """The integer type a temporal type stores as."""
    if isinstance(dt, (st.Date32, st.Time32)):
        return st.int32
    return st.int64


def can_cast_types(from_dt: st.DataType, to_dt: st.DataType) -> bool:
    """Whether `cast` takes the pair (the JAX package's table)."""
    if from_dt == to_dt or isinstance(from_dt, st.Null):
        return True
    if isinstance(from_dt, st.Dictionary):
        return can_cast_types(from_dt.value, to_dt)
    if isinstance(to_dt, st.Dictionary):
        return can_cast_types(from_dt, to_dt.value)
    if isinstance(from_dt, st.Union):
        return any(f.dtype == to_dt or can_cast_types(f.dtype, to_dt)
                   for f in from_dt.fields)
    if isinstance(to_dt, st.Union):
        return False
    if isinstance(from_dt, st.Map) and isinstance(to_dt, st.Map):
        return (can_cast_types(from_dt.key, to_dt.key)
                and can_cast_types(from_dt.item, to_dt.item))
    if isinstance(from_dt, st.Interval) or isinstance(to_dt, st.Interval):
        return _interval_pair(from_dt, to_dt)
    if isinstance(to_dt, st.FixedSizeBinary):
        return isinstance(from_dt, (st.Binary, st.Utf8))
    if isinstance(from_dt, st.FixedSizeBinary):
        return isinstance(to_dt, (st.Binary, st.Utf8))
    numericish = lambda d: _is_numeric(d) or isinstance(d, st.Boolean)
    stringish = lambda d: isinstance(d, (st.Utf8, st.Binary))
    if numericish(from_dt) and numericish(to_dt):
        return True
    if stringish(from_dt) and stringish(to_dt):
        return True
    if stringish(to_dt) and not isinstance(from_dt, st.Struct):
        return True
    if stringish(from_dt) and (numericish(to_dt)
                               or isinstance(to_dt, _INTISH)):
        return True
    if isinstance(from_dt, _INTISH) and isinstance(to_dt, _INTISH):
        date, time = (st.Date32, st.Date64), (st.Time32, st.Time64)
        if isinstance(from_dt, st.Timestamp):
            return isinstance(to_dt, (st.Timestamp,) + date + time)
        if isinstance(from_dt, date):
            return isinstance(to_dt, (st.Timestamp,) + date)
        if isinstance(from_dt, time):
            return isinstance(to_dt, time)
        return isinstance(from_dt, st.Duration) and isinstance(to_dt,
                                                               st.Duration)
    if isinstance(from_dt, _INTISH) and _is_numeric(to_dt):
        return True
    return _is_numeric(from_dt) and isinstance(to_dt, _INTISH)


def _interval_pair(from_dt, to_dt) -> bool:
    fi, ti = isinstance(from_dt, st.Interval), isinstance(to_dt, st.Interval)
    return bool(
        (fi and from_dt.unit in ("year_month", "day_time") and ti
         and to_dt.unit == "month_day_nano")
        or (fi and from_dt.unit == "month_day_nano"
            and isinstance(to_dt, st.Duration))
        or (isinstance(from_dt, st.Duration) and ti
            and to_dt.unit == "month_day_nano")
        or (isinstance(from_dt, st.Int) and ti and to_dt.unit == "year_month")
        or (fi and from_dt.unit == "year_month" and isinstance(to_dt,
                                                               st.Int)))


# ---------------------------------------------------------------------------
# the numeric plane: (kind, values), kind in narrow | i64 | u64 | f64
# ---------------------------------------------------------------------------


def _numeric_repr(c: col.Column):
    """-> (kind, values): uint16 / uint32 widened to int64 (torch on the
    card does not compute on them; the values are the same)."""
    if isinstance(c, col.BooleanColumn):
        return "narrow", c.values_bool().to(torch.uint8)
    if isinstance(c, col.PrimitiveColumn) and c.values.dim() == 1:
        v = c.values
        if st.is_u64(c.dtype):
            return "u64", v
        if v.dtype == torch.int64:
            return "i64", v
        if v.dtype == torch.float64:
            return "f64", v
        if v.dtype in (torch.uint16, torch.uint32):
            return "narrow", v.to(torch.int64)
        return "narrow", v
    raise st.CastError(f"not a numeric column: {type(c).__name__}")


def _as_float64(kind: str, v: torch.Tensor) -> torch.Tensor:
    return u64.to_float(v) if kind == "u64" else v.to(torch.float64)


def _int_range(tdt: torch.dtype):
    info = torch.iinfo(tdt)
    return info.min, info.max


def _float_to_int(v: torch.Tensor, lo: int, hi: int):
    """trunc(v) in float64 and the rows outside [lo, hi] or NaN, compared
    exactly (a bound of at most 32 bits is a float64; the JAX package
    compares in the value's own float type, where 2**31 - 1 rounds up to
    2**31 in float32 and 65535 to inf in float16, and lets those values
    through: ROADMAP C.3)."""
    t = torch.trunc(v.to(torch.float64))
    return t, ~((t >= lo) & (t <= hi)) | torch.isnan(t)


def _to_target(kind: str, vals: torch.Tensor, to_dt: st.DataType):
    """-> (the target's values, zero where a row fails; the rows that
    fail, or None)."""
    if isinstance(to_dt, st.Float):
        src = vals if kind == "narrow" else _as_float64(kind, vals)
        return src.to(to_dt.to_torch()), None
    if st.is_u64(to_dt) or to_dt == st.int64:
        unsigned = st.is_u64(to_dt)
        if vals.is_floating_point():
            t = torch.trunc(vals.to(torch.float64))
            if unsigned:
                bad = (t < 0) | ~(t < 2.0**64) | torch.isnan(t)
                return u64.from_float(torch.where(bad, 0.0, t)), bad
            bad = (~(t.abs() < 2.0**63) | torch.isnan(t)) & ~(t == -2.0**63)
            return torch.where(bad, 0.0, t).to(torch.int64), bad
        v = vals.to(torch.int64)
        if kind == "narrow":
            # a negative into uint64 (a narrow int64 is a widened uint16 /
            # uint32: never negative)
            signed = vals.dtype.is_signed and vals.dtype != torch.int64
            if not (unsigned and signed):
                return v, None
        elif (kind == "u64") == unsigned:
            return vals, None
        bad = v < 0  # a negative into uint64; i64 <-> u64: the top bit
        return torch.where(bad, 0, v), bad
    lo, hi = _int_range(to_dt.to_torch())
    tdt = to_dt.to_torch()
    if vals.is_floating_point():
        t, bad = _float_to_int(vals, lo, hi)
        return torch.where(bad, 0, t).to(torch.int64).to(tdt), bad
    v = vals.to(torch.int64)
    bad = (v < lo) | (v > hi)
    if kind == "u64":
        bad = bad | (v < 0)
    return torch.where(bad, 0, v).to(tdt), bad


def _apply_bad(c: col.Column, bad, options: CastOptions, ctx: str):
    """A failure mask folded into the validity (safe) or raised."""
    if bad is None:
        return c.validity
    live = bad & c.valid_bool()
    if not options.safe:
        raise_if(live.any(), f"cast failure: {ctx}")
        return c.validity
    return bm.pack(c.valid_bool() & ~live)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def cast(c: col.Column, to_dt: st.DataType,
         options: CastOptions = CastOptions()) -> col.Column:
    """`c` as `to_dt` (see the module docstring)."""
    from_dt = c.dtype
    if from_dt == to_dt:
        return c
    if isinstance(c, col.NullColumn):
        return _all_null(to_dt, c.length, c.device)
    if isinstance(c, col.DictionaryColumn):
        if isinstance(to_dt, st.Dictionary):
            return col.DictionaryColumn(
                c.keys, cast(c.values, to_dt.value, options), None, to_dt)
        return cast(dictionary_decode(c), to_dt, options)
    if isinstance(to_dt, st.Dictionary):
        return dictionary_encode(cast(c, to_dt.value, options), to_dt)
    if isinstance(c, col.UnionColumn):
        from .union import union_extract

        exact = [f for f in c.dtype.fields if f.dtype == to_dt]
        castable = exact or [f for f in c.dtype.fields
                             if can_cast_types(f.dtype, to_dt)]
        if not castable:
            raise st.CastError(f"union has no child castable to {to_dt}")
        return cast(union_extract(c, castable[0].name), to_dt, options)
    if isinstance(to_dt, st.Union):
        raise st.CastError("casting to a union is not supported")
    if (isinstance(c, col.ListViewColumn) and isinstance(c.dtype, st.Map)
            and isinstance(to_dt, st.Map)):
        return dataclasses.replace(
            c, child=cast(c.child, to_dt.entry_struct, options), dtype=to_dt)
    if isinstance(from_dt, st.Interval) or isinstance(to_dt, st.Interval):
        out = _cast_interval(c, to_dt, options)
        if out is None:
            raise st.CastError(f"cast {from_dt} -> {to_dt} unsupported")
        return out
    if isinstance(to_dt, st.FixedSizeBinary) and isinstance(
            c, col.StringViewColumn):
        return _binary_to_fsb(c, to_dt, options)
    if isinstance(from_dt, st.FixedSizeBinary) and isinstance(
            to_dt, (st.Binary, st.Utf8)):
        return _fsb_to_binary(c, to_dt)
    nested = _cast_nested(c, to_dt, options)
    if nested is not None:
        return nested
    if (st.decimal_limbs(from_dt) is not None
            or st.decimal_limbs(to_dt) is not None):
        return _cast_decimal(c, to_dt, options)
    if isinstance(c, col.StringViewColumn):
        if isinstance(to_dt, (st.Utf8, st.Binary)):
            return dataclasses.replace(c, dtype=to_dt)  # the same views
        return _cast_string_to(c, to_dt, options)
    if isinstance(to_dt, (st.Utf8, st.Binary)):
        return _cast_to_string(c, to_dt)
    if isinstance(from_dt, _INTISH) and isinstance(to_dt, _INTISH):
        return _cast_temporal(c, to_dt)
    return _cast_numeric(c, to_dt, options)


def _cast_nested(c, to_dt, options):
    if isinstance(c, col.ListViewColumn) and isinstance(to_dt, st.List):
        return dataclasses.replace(
            c, child=cast(c.child, to_dt.value, options), dtype=to_dt)
    if isinstance(c, col.FixedSizeListColumn) and isinstance(
            to_dt, st.FixedSizeList):
        if to_dt.size != c.dtype.size:
            raise st.CastError("fixed_size_list size mismatch")
        return dataclasses.replace(
            c, child=cast(c.child, to_dt.value, options), dtype=to_dt)
    if isinstance(c, col.StructColumn) and isinstance(to_dt, st.Struct):
        if len(to_dt.fields) != len(c.children):
            raise st.CastError("struct field count mismatch")
        return col.StructColumn(
            tuple(cast(ch, f.dtype, options)
                  for ch, f in zip(c.children, to_dt.fields)),
            c.validity, c.length, to_dt)
    return None


def _cast_decimal(c, to_dt, options):
    from . import decimal as dec

    from_dt = c.dtype
    if st.decimal_limbs(from_dt) is not None:
        if st.decimal_limbs(to_dt) is not None:
            return dec.rescale(c, to_dt, safe=options.safe)
        if to_dt == st.int64:
            return dec.to_int(c, to_dt, safe=options.safe)
        if isinstance(to_dt, st.Int):
            return cast(dec.to_int(c, st.int64, safe=options.safe), to_dt,
                        options)
        if isinstance(to_dt, st.Float):
            out = dec.to_float(c)
            return out if to_dt.bits == 64 else cast(out, to_dt, options)
        if isinstance(to_dt, (st.Utf8, st.Binary)):
            return dec.to_string(c)
    elif isinstance(c, col.StringViewColumn):
        return dec.from_string(c, to_dt)
    elif isinstance(from_dt, st.Int):
        return dec.from_int(c, to_dt)
    elif isinstance(from_dt, st.Float):
        return dec.from_float(c, to_dt)
    raise st.CastError(f"cast {from_dt} -> {to_dt} unsupported")


def _cast_numeric(c, to_dt, options):
    kind, vals = _numeric_repr(c)
    if isinstance(to_dt, st.Boolean):
        return col.BooleanColumn(bm.pack(vals != 0), c.validity, c.length)
    if not (_is_numeric(to_dt) or isinstance(to_dt, _INTISH)):
        raise st.CastError(f"cannot cast {c.dtype} -> {to_dt}")
    target = _storage_int(to_dt) if isinstance(to_dt, _INTISH) else to_dt
    out, bad = _to_target(kind, vals, target)
    validity = _apply_bad(c, bad, options, f"{c.dtype}->{to_dt}")
    return col.PrimitiveColumn(out, validity, c.length, to_dt)


# ---------------------------------------------------------------------------
# intervals, fixed-size binary, temporal
# ---------------------------------------------------------------------------


def _unit_factor(from_unit: str, to_unit: str):
    """(multiplier, divisor) converting a value between units."""
    a, b = _UNIT_NS[from_unit], _UNIT_NS[to_unit]
    return (a // b, 1) if a >= b else (1, b // a)


def _scale(v: torch.Tensor, mult: int, div: int, floor: bool = False):
    """v * mult / div in int64, wrapping; the division truncates (or
    floors)."""
    v = v.to(torch.int64)
    if mult != 1:
        v = v * mult
    if div != 1:
        v = torch.div(v, div, rounding_mode="floor" if floor else "trunc")
    return v


def _halves(v: torch.Tensor) -> torch.Tensor:
    """Integers -> (n, 2) int32 words: the int64 value's low and high
    32 bits."""
    return v.to(torch.int64).contiguous().view(torch.int32).reshape(-1, 2)


def _cast_interval(c, to_dt, options):
    from_dt = c.dtype
    fi, ti = isinstance(from_dt, st.Interval), isinstance(to_dt, st.Interval)
    cap, dev = c.capacity, c.device
    z = torch.zeros(cap, dtype=torch.int64, device=dev)

    def mdn(months, days, nanos):
        vals = torch.cat([_halves(months)[:, :1], _halves(days)[:, :1],
                          _halves(nanos)], dim=1)
        return col.PrimitiveColumn(vals, c.validity, c.length, to_dt)

    if fi and ti and to_dt.unit == "month_day_nano":
        if from_dt.unit == "year_month":
            return mdn(c.values[:, 0], z, z)
        if from_dt.unit == "day_time":
            return mdn(z, c.values[:, 0], _scale(c.values[:, 1], 10**6, 1))
        return None
    if fi and isinstance(to_dt, st.Duration):
        if from_dt.unit != "month_day_nano":
            return None
        bad = (c.values[:, 0] != 0) | (c.values[:, 1] != 0)
        nanos = c.values[:, 2:4].contiguous().view(torch.int64).reshape(-1)
        out = _scale(nanos, 1, _UNIT_NS[to_dt.unit])
        validity = _apply_bad(c, bad, options,
                              f"{from_dt}->{to_dt} (months/days nonzero)")
        return col.PrimitiveColumn(torch.where(bad, 0, out), validity,
                                   c.length, to_dt)
    if isinstance(from_dt, st.Duration) and ti:
        if to_dt.unit != "month_day_nano":
            return None
        return mdn(z, z, _scale(c.values, _UNIT_NS[from_dt.unit], 1))
    if isinstance(from_dt, st.Int) and ti and to_dt.unit == "year_month":
        return col.PrimitiveColumn(_halves(c.values)[:, :1].contiguous(),
                                   c.validity, c.length, to_dt)
    if fi and from_dt.unit == "year_month" and isinstance(to_dt, st.Int):
        src = col.PrimitiveColumn(c.values[:, 0].contiguous(), c.validity,
                                  c.length, st.int32)
        return cast(src, to_dt, options)
    return None


def _binary_to_fsb(c: col.StringViewColumn, to_dt: st.FixedSizeBinary,
                   options: CastOptions) -> col.PrimitiveColumn:
    """Binary / utf8 -> fixed-size binary; another length fails."""
    from .strings import byte_matrix

    bw = to_dt.byte_width
    nw = -(-bw // 4)
    mat, lens = byte_matrix(c, max(nw, 1) * 4)
    bad = (lens != bw) & c.valid_bool()
    validity = _apply_bad(c, bad, options,
                          f"{c.dtype}->{to_dt} (length != {bw})")
    words = mat.view(torch.int32)[:, :nw]
    return col.PrimitiveColumn(torch.where(bad[:, None], 0, words),
                               validity, c.length, to_dt)


def _fsb_to_binary(c: col.PrimitiveColumn, to_dt) -> col.StringViewColumn:
    """Fixed-size binary -> binary / utf8 views over an arena of the
    words' bytes."""
    bw = c.dtype.byte_width
    cap, nw = c.values.shape
    arena = c.values.contiguous().view(torch.uint8).reshape(-1)
    views = torch.zeros((cap, 4), dtype=torch.int32, device=c.device)
    views[:, 0] = bw
    if bw <= 12:
        views[:, 1:1 + min(nw, 3)] = c.values[:, :3]
    else:
        views[:, 1] = c.values[:, 0]
        views[:, 3] = torch.arange(cap, dtype=torch.int32,
                                   device=c.device) * (nw * 4)
    views[c.length:] = 0
    return col.StringViewColumn(views, arena, c.validity, c.length, to_dt,
                                bw)


def _cast_temporal(c: col.PrimitiveColumn, to_dt) -> col.PrimitiveColumn:
    from_dt = c.dtype
    v = c.values.to(torch.int64)
    date, time = (st.Date32, st.Date64), (st.Time32, st.Time64)

    def out(values):
        return col.PrimitiveColumn(values.to(to_dt.to_torch()), c.validity,
                                   c.length, to_dt)

    if isinstance(from_dt, st.Timestamp) and isinstance(to_dt, st.Timestamp):
        return out(_scale(v, *_unit_factor(from_dt.unit, to_dt.unit)))
    if isinstance(from_dt, st.Timestamp) and isinstance(to_dt, date):
        ms = _scale(v, *_unit_factor(from_dt.unit, "ms"), floor=True)
        days = _scale(ms, 1, _MS_PER_DAY, floor=True)
        return out(days if isinstance(to_dt, st.Date32)
                   else _scale(days, _MS_PER_DAY, 1))
    if isinstance(from_dt, st.Date32) and isinstance(to_dt, st.Date64):
        return out(_scale(v, _MS_PER_DAY, 1))
    if isinstance(from_dt, st.Date64) and isinstance(to_dt, st.Date32):
        return out(_scale(v, 1, _MS_PER_DAY, floor=True))
    if isinstance(from_dt, date) and isinstance(to_dt, st.Timestamp):
        ms = _scale(v, _MS_PER_DAY, 1) if isinstance(from_dt,
                                                     st.Date32) else v
        return out(_scale(ms, *_unit_factor("ms", to_dt.unit)))
    if isinstance(from_dt, time) and isinstance(to_dt, time):
        return out(_scale(v, *_unit_factor(from_dt.unit, to_dt.unit)))
    if isinstance(from_dt, st.Duration) and isinstance(to_dt, st.Duration):
        return out(_scale(v, *_unit_factor(from_dt.unit, to_dt.unit)))
    raise st.CastError(f"unsupported temporal cast {from_dt} -> {to_dt}")


def _all_null(to_dt: st.DataType, n: int, device) -> col.Column:
    if isinstance(to_dt, st.Null):
        return col.null_column(n, device)
    if isinstance(to_dt, st.Dictionary):
        return col.dictionary_encode_host([None] * n, to_dt, device)
    return col.from_pylist([None] * n, to_dt, device)


# ---------------------------------------------------------------------------
# strings (on the host, as in the JAX package)
# ---------------------------------------------------------------------------


def _format_value(v, dt: st.DataType) -> str:
    if isinstance(dt, st.Boolean):
        return "true" if v else "false"
    if isinstance(dt, st.Float):
        return repr(float(v))
    return str(v)


def _cast_to_string(c: col.Column, to_dt) -> col.StringViewColumn:
    out = [None if v is None else _format_value(v, c.dtype)
           for v in c.to_pylist()]
    if isinstance(to_dt, st.Binary):
        out = [None if s is None else s.encode() for s in out]
    return col.string_view(out, to_dt, c.device)


def _parse_one(s: str, dt: st.DataType):
    if isinstance(dt, st.Int):
        return int(s.strip())
    if isinstance(dt, st.Float):
        return float(s)
    if isinstance(dt, st.Boolean):
        ls = s.strip().lower()
        if ls in ("true", "t", "1"):
            return True
        if ls in ("false", "f", "0"):
            return False
        raise ValueError(s)
    if isinstance(dt, st.Timestamp):
        ts = _dt.datetime.fromisoformat(s.replace("Z", "+00:00"))
        if ts.tzinfo is None:
            ts = ts.replace(tzinfo=_dt.timezone.utc)
        delta = ts - _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
        ns = ((delta.days * 86400 + delta.seconds) * 10**9
              + delta.microseconds * 1000)
        return ns // _UNIT_NS[dt.unit]
    if isinstance(dt, st.Date32):
        return (_dt.date.fromisoformat(s) - _dt.date(1970, 1, 1)).days
    raise st.CastError(f"cannot parse string as {dt}")


def _cast_string_to(c: col.StringViewColumn, to_dt,
                    options: CastOptions) -> col.Column:
    out = []
    for v in c.to_pylist():
        if v is None:
            out.append(None)
            continue
        if isinstance(v, bytes):
            v = v.decode("utf-8", errors="replace")
        try:
            out.append(_parse_one(v, to_dt))
        except (ValueError, OverflowError):
            if not options.safe:
                raise st.CastError(f"cannot cast {v!r} to {to_dt}")
            out.append(None)
    if isinstance(to_dt, st.Int):
        info = np.iinfo(col.numpy_dtype(to_dt))
        checked = []
        for v in out:
            if v is not None and not int(info.min) <= v <= int(info.max):
                if not options.safe:
                    raise st.CastError(f"{v} out of range for {to_dt}")
                v = None
            checked.append(v)
        out = checked
    return col.from_pylist(out, to_dt, c.device)


# ---------------------------------------------------------------------------
# dictionaries
# ---------------------------------------------------------------------------


def dictionary_decode(c: col.DictionaryColumn) -> col.Column:
    """A dictionary as a plain column: the values taken by key, null where
    the key or its value is."""
    from .take import take

    keys = dataclasses.replace(c.keys, validity=None)
    out = take(c.values, keys)
    if c.keys.validity is None:
        return out
    valid = c.keys.valid_bool() & out.valid_bool()
    if isinstance(out, col.DictionaryColumn):
        return dataclasses.replace(out, keys=dataclasses.replace(
            out.keys, validity=bm.pack(valid)))
    return dataclasses.replace(out, validity=bm.pack(valid))


def dictionary_encode(c: col.Column, to_dt: st.Dictionary = None
                      ) -> col.DictionaryColumn:
    """A plain column as a dictionary, interned on the host in first-seen
    order."""
    if to_dt is None:
        to_dt = st.Dictionary(st.int32, c.dtype)
    return col.dictionary_encode_host(c.to_pylist(), to_dt, c.device)
