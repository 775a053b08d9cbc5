"""JSON <-> Variant.

Counterpart of `arrowtpu/variant/json.py` (arrow-rs's parquet-variant-json
crate, to_json.rs `variant_to_json` / from_json.rs `json_to_variant`, and
parquet-variant-compute's batch forms), the same text: temporal values as
RFC 3339 strings, decimals as plain numbers, binary as base64, a UUID in
its hyphenated form.  One repair: a decimal that is not integral is
written as its exact digits, where the JAX package writes float(v)
(ROADMAP C.3 fault 21).  Host work, as in both packages: the batch forms
parse or print every row in Python.
"""

from __future__ import annotations

import base64
import datetime as _dt
import decimal as _dec
import json as _json
import uuid as _uuid
from typing import Any, List, Optional

from .. import schema as st
from . import encoding as enc
from .array import VariantColumn, valid_rows, variant_array


class _Number(str):
    """A number's JSON text, written as it is."""


def _dumps(v: Any) -> str:
    """json.dumps(v, separators=(",", ":")) of `_jsonable`'s tree, with
    each _Number written as its text."""
    if type(v) is _Number:
        return str(v)
    if isinstance(v, dict):
        return "{" + ",".join(_json.dumps(k) + ":" + _dumps(x)
                              for k, x in v.items()) + "}"
    if isinstance(v, list):
        return "[" + ",".join(_dumps(x) for x in v) + "]"
    return _json.dumps(v)


def _jsonable(v: Any) -> Any:
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, float):
        return v
    if isinstance(v, enc.VariantFloat):
        return v.value
    if isinstance(v, _dec.Decimal):
        # a plain number, no exponent notation (to_json.rs's decimal
        # path): an integral value as its int, any other as its exact
        # digits (the JAX package writes float(v), which rounds past 17
        # digits and writes small or large values with an exponent:
        # ROADMAP C.3 fault 21)
        if v == v.to_integral_value():
            return int(v)
        return _Number(format(v.normalize(), "f"))
    if isinstance(v, _dt.datetime):
        return v.isoformat()
    if isinstance(v, _dt.date):
        return v.isoformat()
    if isinstance(v, _dt.time):
        return v.isoformat()
    if isinstance(v, enc.VariantTsNanos):
        base = (_dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
                + _dt.timedelta(microseconds=v.nanos / 1000))
        if not v.utc:
            base = base.replace(tzinfo=None)
        return base.isoformat()
    if isinstance(v, _uuid.UUID):
        return str(v)
    if isinstance(v, (bytes, bytearray)):
        return base64.b64encode(bytes(v)).decode("ascii")
    if isinstance(v, dict):
        return {k: _jsonable(sub) for k, sub in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(sub) for sub in v]
    raise st.ArrowTpuError(f"variant_to_json: {type(v).__name__}")


def variant_to_json(v: Any) -> str:
    """One decoded variant value -> JSON text (to_json.rs)."""
    return _dumps(_jsonable(v))


def json_to_variant(text: str) -> Any:
    """JSON text -> a Python value encodable as a variant (from_json.rs:
    numbers parse to the narrowest int or double, objects/arrays nest).
    Top-level JSON `null` maps to the explicit Variant::Null value."""
    v = _json.loads(text)
    return enc.VARIANT_NULL if v is None else v


def batch_variant_to_json(vc: VariantColumn) -> List[Optional[str]]:
    """VariantColumn -> JSON strings (parquet-variant-compute
    to_json.rs::batch_variant_to_json_string): null ROWS stay None,
    Variant::Null VALUES render as the text "null"."""
    n = vc.length
    valid = valid_rows(vc.inner, n)
    vals = vc.to_pylist()
    return [variant_to_json(vals[i]) if valid[i] else None
            for i in range(n)]


def batch_json_to_variant(texts: List[Optional[str]],
                          device=None) -> VariantColumn:
    """JSON strings -> a VariantColumn on `device`, None: the card
    (from_json.rs::batch_json_to_variant)."""
    return variant_array(
        [None if t is None else json_to_variant(t) for t in texts], device)
