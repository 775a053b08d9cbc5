"""Variant shredding and unshredding (parquet-format VariantShredding.md).

Counterpart of `arrowtpu/variant/shred.py` (arrow-rs's
parquet-variant-compute shred_variant.rs, `shred_variant`: cast an
unshredded VariantArray to a shredding schema, moving the values that
match into `typed_value` columns and leaving a residual in `value`;
unshred_variant.rs: reassemble the unshredded binary form).

Row semantics (the spec's table):
  * top level: typed_value non-null -> a shredded row (`value` null
    unless it holds a partially shredded object's residual);
    typed_value null -> `value` holds the variant bytes.
  * an object field group {value, typed_value}: typed non-null -> the
    shredded field; value non-null -> the field's unshredded bytes; both
    null -> the field is MISSING from the object.
  * a partially shredded object: the top-level `value` is an object of
    only the fields NOT in the shredding schema.

The rows are decoded and encoded on the host; each typed_value column and
its validity is built once, from the whole column's host values, on the
variant column's device, where columnar compute (filters, aggregation,
variant_get) then runs without touching the bytes.
"""

from __future__ import annotations

import datetime as _dt
from typing import Any, List, Optional, Tuple

import numpy as np

from .. import schema as st
from ..config import round_up
from ..core import column as col
from . import encoding as enc
from .array import MetadataNames, VariantColumn, from_parts, valid_rows

_MISSING = object()


def _shreds_as(v: Any, dtype: st.DataType) -> bool:
    """Does value v shred into a typed_value of `dtype` losslessly?"""
    if isinstance(dtype, st.Int):
        if not dtype.signed or isinstance(v, bool) or not isinstance(v, int):
            return False
        return -(1 << (dtype.bits - 1)) <= v < (1 << (dtype.bits - 1))
    if isinstance(dtype, st.Float):
        if dtype.bits == 64:
            return isinstance(v, float)
        return isinstance(v, enc.VariantFloat)
    if isinstance(dtype, st.Boolean):
        return isinstance(v, bool)
    if isinstance(dtype, st.Utf8):
        return isinstance(v, str)
    if isinstance(dtype, st.Binary):
        return isinstance(v, (bytes, bytearray))
    if isinstance(dtype, st.Date32):
        return isinstance(v, _dt.date) and not isinstance(v, _dt.datetime)
    if isinstance(dtype, st.Timestamp):
        if dtype.unit != "us":
            return False
        if not isinstance(v, _dt.datetime):
            return False
        return (v.tzinfo is not None) == (dtype.tz is not None)
    if isinstance(dtype, st.Struct):
        return isinstance(v, dict)
    return False


def _to_storage(v: Any, dtype: st.DataType) -> Any:
    if isinstance(dtype, st.Float) and dtype.bits == 32:
        return v.value
    if isinstance(dtype, st.Timestamp):
        return enc._ts_micros(v)
    if isinstance(dtype, st.Date32):
        return (v - _dt.date(1970, 1, 1)).days
    if isinstance(dtype, st.Binary):
        return bytes(v)
    return v


def _from_storage(v: Any, dtype: st.DataType) -> Any:
    if isinstance(dtype, st.Float) and dtype.bits == 32:
        return enc.VariantFloat(float(v))
    if isinstance(dtype, st.Timestamp):
        base = (_dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
                + _dt.timedelta(microseconds=int(v)))
        return base if dtype.tz is not None else base.replace(tzinfo=None)
    if isinstance(dtype, st.Date32):
        return _dt.date(1970, 1, 1) + _dt.timedelta(days=int(v))
    return v


def _shred_rows(rows: List[Any], dtype: st.DataType, fid, device) -> Tuple[
        Any, List[Optional[bytes]]]:
    """-> (the typed column of `dtype`: a StructColumn for a struct, else
    the storage values with None for a row that does not shred,
           the residual value bytes with None for a shredded row).
    A row is _MISSING (the field is absent) or a decoded value."""
    if isinstance(dtype, st.Struct):
        per_field_rows = {f.name: [] for f in dtype.fields}
        top_resid: List[Optional[bytes]] = []
        typed_valid: List[bool] = []
        for v in rows:
            if v is _MISSING or not isinstance(v, dict):
                for f in dtype.fields:
                    per_field_rows[f.name].append(_MISSING)
                typed_valid.append(False)
                top_resid.append(
                    None if v is _MISSING else enc.encode_value(v, fid))
                continue
            typed_valid.append(True)
            extra = {k: sub for k, sub in v.items()
                     if k not in per_field_rows}
            for f in dtype.fields:
                per_field_rows[f.name].append(v.get(f.name, _MISSING))
            top_resid.append(enc.encode_value(extra, fid) if extra else None)
        children = []
        for f in dtype.fields:
            f_typed, f_resid = _shred_rows(per_field_rows[f.name], f.dtype,
                                           fid, device)
            children.append(_field_group(f_typed, f_resid, f.dtype, device))
        valid = np.asarray(typed_valid, bool)
        tv = col.StructColumn(
            tuple(children),
            col._host_validity(valid, round_up(max(len(rows), 1)), device),
            len(rows),
            st.Struct(tuple(st.Field(f.name, c.dtype, True)
                            for f, c in zip(dtype.fields, children))))
        return tv, top_resid
    typed: List[Any] = []
    residual: List[Optional[bytes]] = []
    for v in rows:
        if v is not _MISSING and _shreds_as(v, dtype):
            typed.append(_to_storage(v, dtype))
            residual.append(None)
        else:
            typed.append(None)
            residual.append(
                None if v is _MISSING else enc.encode_value(v, fid))
    return typed, residual


def _typed_column(typed, dtype: st.DataType, device) -> col.Column:
    if isinstance(dtype, st.Struct):
        return typed  # already a StructColumn from the recursion
    return col.from_pylist(typed, dtype, device)


def _field_group(typed, residual: List[Optional[bytes]],
                 dtype: st.DataType, device) -> col.StructColumn:
    """The per-field group struct {value, typed_value}."""
    value_col = col.string_view(residual, st.binary, device)
    tv_col = _typed_column(typed, dtype, device)
    return col.StructColumn(
        (value_col, tv_col), None, value_col.length,
        st.Struct((st.Field("value", st.binary, True),
                   st.Field("typed_value", tv_col.dtype, True))))


def _decode_rows(vc: VariantColumn, valid: np.ndarray,
                names_into: Optional[set] = None) -> List[Any]:
    """Every row of an unshredded column decoded on the host (_MISSING for
    a null row), the value and metadata columns read back once each;
    `names_into` collects every object key met."""
    vals = vc.value_bytes()
    names_for = MetadataNames(vc.metadata)
    rows: List[Any] = []
    for i in range(vc.length):
        if not valid[i] or vals[i] is None:
            rows.append(_MISSING)
            continue
        v = enc.decode_value(vals[i], names_for(i))
        if names_into is not None:
            enc.collect_field_names(v, names_into)
        rows.append(v)
    return rows


def shred_variant(vc: VariantColumn, target: st.DataType) -> VariantColumn:
    """Shred an unshredded VariantColumn to the target typed_value dtype
    (arrow-rs shred_variant.rs::shred_variant), on the column's device.
    The values that do not match the target stay in `value` (partial or
    imperfect shredding, as the spec allows)."""
    n = vc.length
    device = vc.device
    valid = valid_rows(vc.inner, n)
    all_names: set = set()
    rows = _decode_rows(vc, valid, all_names)
    ordered = sorted(all_names)
    fid = {nm: i for i, nm in enumerate(ordered)}
    meta_out = enc.build_metadata(ordered)

    typed, residual = _shred_rows(rows, target, fid, device)
    tv_col = _typed_column(typed, target, device)
    metadata_col = col.string_view([meta_out] * n, st.binary, device)
    value_col = col.string_view(residual, st.binary, device)
    return from_parts(metadata_col, value_col, tv_col,
                      validity=None if valid.all() else valid)


def unshred_variant(vc: VariantColumn) -> VariantColumn:
    """The unshredded binary form again (arrow-rs
    unshred_variant.rs::unshred_variant): typed_value and the residual
    `value` bytes merged back into one value buffer a row."""
    from .array import variant_array

    n = vc.length
    valid = valid_rows(vc.inner, n)
    merged = _merge_typed(vc.value, vc.typed_value, n,
                          MetadataNames(vc.metadata))
    out_rows = [None if (not valid[i] or merged[i] is _MISSING)
                else merged[i] for i in range(n)]
    va = variant_array(out_rows, vc.device)
    if not valid.all():
        va = from_parts(va.metadata, va.value, validity=valid)
    return va


def _merge_typed(value_col: Optional[col.Column],
                 typed_col: Optional[col.Column], n: int,
                 names_for) -> List[Any]:
    """A row: _MISSING or its decoded Python value, by the group
    semantics."""
    vals = value_col.to_pylist() if value_col is not None else [None] * n
    if typed_col is None:
        return [_MISSING if vals[i] is None
                else enc.decode_value(vals[i], names_for(i))
                for i in range(n)]
    t_valid = valid_rows(typed_col, n)
    if isinstance(typed_col, col.StructColumn) and all(
            isinstance(f.dtype, st.Struct)
            and [g.name for g in f.dtype.fields] == ["value", "typed_value"]
            for f in typed_col.dtype.fields):
        # an object typed_value: its children are {value, typed_value}
        field_merged = {}
        for f, ch in zip(typed_col.dtype.fields, typed_col.children):
            sub_value, sub_typed = ch.children
            field_merged[f.name] = _merge_typed(sub_value, sub_typed, n,
                                                names_for)
        out = []
        for i in range(n):
            if not t_valid[i]:
                out.append(_MISSING if vals[i] is None
                           else enc.decode_value(vals[i], names_for(i)))
                continue
            obj = {}
            if vals[i] is not None:  # a partially shredded object
                resid = enc.decode_value(vals[i], names_for(i))
                if isinstance(resid, dict):
                    obj.update(resid)
            for name, rows in field_merged.items():
                if rows[i] is not _MISSING:
                    obj[name] = rows[i]
            out.append(obj)
        return out
    # a primitive typed_value leaf
    dtype = typed_col.dtype
    typed_py = typed_col.to_pylist()
    out = []
    for i in range(n):
        if t_valid[i] and typed_py[i] is not None:
            out.append(_from_storage(typed_py[i], dtype))
        elif vals[i] is not None:
            out.append(enc.decode_value(vals[i], names_for(i)))
        else:
            out.append(_MISSING)
    return out
