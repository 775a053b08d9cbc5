"""variant_get: path extraction from a VariantColumn.

Counterpart of `arrowtpu/variant/get.py` (arrow-rs's
parquet-variant-compute variant_get.rs, `variant_get` with
`GetOptions { path, as_type }` and its shredded path steps;
parquet-variant path.rs: object field names and list indices).

When the path is shredded all the way to a primitive typed_value whose
residual is all null, extraction is purely columnar: the result is the
typed column itself, on its device, its validity ANDed with the rows'
(one bitmap AND), and no metadata or value byte is read.  Every other
path falls back to decoding the rows on the host, as arrow-rs's row
builder does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Union

from .. import schema as st
from ..core import bitmap as bm
from ..core import column as col
from .array import MetadataNames, VariantColumn, valid_rows
from .shred import _MISSING, _merge_typed, _shreds_as, _to_storage

PathElement = Union[str, int]


def _is_group(dtype: st.DataType) -> bool:
    return (isinstance(dtype, st.Struct)
            and [f.name for f in dtype.fields] == ["value", "typed_value"])


def _shredded_step(typed: Optional[col.Column], elem: PathElement):
    """One path step through the shredded representation: the child
    {value, typed_value} group column, "missing" when the field is not in
    the shredding schema (its residual may hold it), or None when the step
    is not shredded (the caller falls back to the bytes)."""
    if typed is None or not isinstance(elem, str):
        return None
    if not isinstance(typed, col.StructColumn):
        return None
    if not all(_is_group(f.dtype) for f in typed.dtype.fields):
        return None
    for f, ch in zip(typed.dtype.fields, typed.children):
        if f.name == elem:
            return ch
    return "missing"


def variant_get(vc: VariantColumn, path: Sequence[PathElement],
                as_dtype: Optional[st.DataType] = None):
    """`path` extracted from every row, on the column's device.

    as_dtype=None -> a VariantColumn of the sub-values (missing -> null).
    as_dtype=T    -> a typed column (a value T cannot hold losslessly
                     becomes null: arrow-rs's safe cast mode).
    """
    n = vc.length
    value_col: Optional[col.Column] = vc.value
    typed_col: Optional[col.Column] = vc.typed_value
    consumed = 0
    shred_missing = False
    for elem in path:
        step = _shredded_step(typed_col, elem)
        if step is None:
            break
        if step == "missing":
            shred_missing = True
            break
        value_col, typed_col = step.children
        consumed += 1

    if (consumed == len(path) and typed_col is not None
            and not isinstance(typed_col, col.StructColumn)
            and as_dtype is not None and typed_col.dtype == as_dtype
            and value_col is not None and _all_null(value_col, n)):
        return _mask_validity(typed_col, vc.inner.validity)

    valid = valid_rows(vc.inner, n)
    rows = _merge_typed(value_col, typed_col, n, MetadataNames(vc.metadata))
    remaining = () if shred_missing else tuple(path[consumed:])
    out: List[Any] = []
    for i in range(n):
        v = rows[i]
        if not valid[i] or v is _MISSING:
            out.append(_MISSING)
            continue
        if shred_missing:
            # the residual object may still hold the field
            v = (v.get(path[consumed], _MISSING) if isinstance(v, dict)
                 else _MISSING)
            if v is not _MISSING:
                for elem in path[consumed + 1:]:
                    v = _step_py(v, elem)
                    if v is _MISSING:
                        break
        else:
            for elem in remaining:
                v = _step_py(v, elem)
                if v is _MISSING:
                    break
        out.append(v)

    if as_dtype is None:
        from .array import variant_array

        return variant_array([None if v is _MISSING else v for v in out],
                             vc.device)
    typed_out = [
        _to_storage(v, as_dtype)
        if v is not _MISSING and _shreds_as(v, as_dtype) else None
        for v in out
    ]
    return col.from_pylist(typed_out, as_dtype, vc.device)


def _step_py(v: Any, elem: PathElement) -> Any:
    if isinstance(elem, str):
        if isinstance(v, dict) and elem in v:
            return v[elem]
        return _MISSING
    if isinstance(v, list) and 0 <= elem < len(v):
        return v[elem]
    return _MISSING


def _all_null(c: col.Column, n: int) -> bool:
    """Every row of c is null (one count read back from its device)."""
    if c.validity is None:
        return n == 0
    return int(bm.count_set_bits(c.validity)) == 0


def _mask_validity(c: col.Column, rows) -> col.Column:
    """c itself when every row is valid, else c with its validity ANDed
    with the rows' bitmap on its device (the values' storage shared)."""
    if rows is None:
        return c
    return dataclasses.replace(c, validity=bm.union(c.validity, rows))
