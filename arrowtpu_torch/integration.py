"""The Arrow JSON integration-test format ("archery" format).

Counterpart of `arrowtpu/integration.py`, the same documents (arrow-rs's
arrow-integration-test crate, lib.rs `ArrowJson`, `record_batch_from_json`,
`array_from_json`; datatype.rs `data_type_to_json`): the
cross-implementation conformance format of apache/arrow's archery harness.
The top-level document:

    {"schema": {"fields": [FIELD...]},
     "dictionaries": [{"id": N, "data": {"count": N, "columns": [...]}}],
     "batches": [{"count": N, "columns": [COLUMN...]}]}

COLUMN = {"name", "count", "VALIDITY": [0/1...], "DATA"/"OFFSET"/
"TYPE_ID", "children": [...]}; 64-bit integers and decimals are JSON
strings, binary is UPPERCASE hex, intervals are objects per unit.

It transcodes at the logical value level (the columns are views and
arenas, so offsets are made on write and dropped on read: the format's
offsets are derived data, not state of their own); a round trip is
checked logically (`ops.equal_batches`), as arrow-rs compares batches.
Columns read from a document go onto `device` (None: the card).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import schema as st
from .config import resolve_device, round_up
from .core import batch as bt
from .core import bitmap as bm
from .core import column as col
from .core.column import from_pylist

_UNIT_TO_JSON = {"s": "SECOND", "ms": "MILLISECOND", "us": "MICROSECOND",
                 "ns": "NANOSECOND"}
_UNIT_FROM_JSON = {v: k for k, v in _UNIT_TO_JSON.items()}
_IV_TO_JSON = {"year_month": "YEAR_MONTH", "day_time": "DAY_TIME",
               "month_day_nano": "MONTH_DAY_NANO"}
_IV_FROM_JSON = {v: k for k, v in _IV_TO_JSON.items()}


# ---------------------------------------------------------------------------
# DataType <-> JSON type object (datatype.rs data_type_to_json)
# ---------------------------------------------------------------------------


def datatype_to_json(dt: st.DataType) -> Dict[str, Any]:
    if isinstance(dt, st.Null):
        return {"name": "null"}
    if isinstance(dt, st.Boolean):
        return {"name": "bool"}
    if isinstance(dt, st.Int):
        return {"name": "int", "bitWidth": dt.bits, "isSigned": dt.signed}
    if isinstance(dt, st.Float):
        prec = {16: "HALF", 32: "SINGLE", 64: "DOUBLE"}[dt.bits]
        return {"name": "floatingpoint", "precision": prec}
    if isinstance(dt, st.Utf8):
        return {"name": "utf8"}
    if isinstance(dt, st.Binary):
        return {"name": "binary"}
    if isinstance(dt, st.FixedSizeBinary):
        return {"name": "fixedsizebinary", "byteWidth": dt.byte_width}
    if st.decimal_limbs(dt) is not None:
        return {"name": "decimal", "precision": dt.precision,
                "scale": dt.scale, "bitWidth": st.decimal_limbs(dt) * 32}
    if isinstance(dt, st.Date32):
        return {"name": "date", "unit": "DAY"}
    if isinstance(dt, st.Date64):
        return {"name": "date", "unit": "MILLISECOND"}
    if isinstance(dt, st.Time32):
        return {"name": "time", "bitWidth": 32,
                "unit": _UNIT_TO_JSON[dt.unit]}
    if isinstance(dt, st.Time64):
        return {"name": "time", "bitWidth": 64,
                "unit": _UNIT_TO_JSON[dt.unit]}
    if isinstance(dt, st.Timestamp):
        out = {"name": "timestamp", "unit": _UNIT_TO_JSON[dt.unit]}
        if dt.tz:
            out["timezone"] = dt.tz
        return out
    if isinstance(dt, st.Duration):
        return {"name": "duration", "unit": _UNIT_TO_JSON[dt.unit]}
    if isinstance(dt, st.Interval):
        return {"name": "interval", "unit": _IV_TO_JSON[dt.unit]}
    if isinstance(dt, st.List):
        return {"name": "list"}
    if isinstance(dt, st.FixedSizeList):
        return {"name": "fixedsizelist", "listSize": dt.size}
    if isinstance(dt, st.Struct):
        return {"name": "struct"}
    if isinstance(dt, st.Map):
        return {"name": "map", "keysSorted": False}
    if isinstance(dt, st.Union):
        ids = list(dt.type_ids) or list(range(len(dt.fields)))
        return {"name": "union", "mode": dt.mode.upper(), "typeIds": ids}
    if isinstance(dt, st.RunEndEncoded):
        return {"name": "runendencoded"}
    raise st.ArrowTpuError(f"integration: unsupported dtype {dt}")


def _decimal_from_bits(bits: int, precision: int, scale: int) -> st.DataType:
    return {32: st.Decimal32, 64: st.Decimal64, 128: st.Decimal128,
            256: st.Decimal256}[bits](precision, scale)


def datatype_from_json(t: Dict[str, Any],
                       children: List[st.Field]) -> st.DataType:
    name = t["name"]
    if name == "null":
        return st.null
    if name == "bool":
        return st.bool_
    if name == "int":
        return st.Int(t["bitWidth"], signed=t["isSigned"])
    if name == "floatingpoint":
        return st.Float({"HALF": 16, "SINGLE": 32, "DOUBLE": 64}
                        [t["precision"]])
    if name in ("utf8", "largeutf8", "utf8view"):
        return st.utf8  # view/large forms normalize to the engine's Utf8
    if name in ("binary", "largebinary", "binaryview"):
        return st.binary
    if name == "fixedsizebinary":
        return st.FixedSizeBinary(t["byteWidth"])
    if name == "decimal":
        return _decimal_from_bits(t.get("bitWidth", 128), t["precision"],
                                  t["scale"])
    if name == "date":
        return st.Date32() if t["unit"] == "DAY" else st.Date64()
    if name == "time":
        unit = _UNIT_FROM_JSON[t["unit"]]
        return st.Time32(unit) if t["bitWidth"] == 32 else st.Time64(unit)
    if name == "timestamp":
        return st.Timestamp(_UNIT_FROM_JSON[t["unit"]], t.get("timezone"))
    if name == "duration":
        return st.Duration(_UNIT_FROM_JSON[t["unit"]])
    if name == "interval":
        return st.Interval(_IV_FROM_JSON[t["unit"]])
    if name in ("list", "largelist", "listview", "largelistview"):
        return st.List(children[0].dtype)
    if name == "fixedsizelist":
        return st.FixedSizeList(children[0].dtype, t["listSize"])
    if name == "struct":
        return st.Struct(tuple(children))
    if name == "map":
        entry = children[0].dtype  # struct<key, value>
        return st.Map(entry.fields[0].dtype, entry.fields[1].dtype)
    if name == "union":
        return st.Union(tuple(children), tuple(t.get("typeIds", ())),
                        t["mode"].lower())
    if name == "runendencoded":
        return st.RunEndEncoded(children[0].dtype, children[1].dtype)
    raise st.ArrowTpuError(f"integration: unknown type name {name!r}")


# ---------------------------------------------------------------------------
# Field / Schema
# ---------------------------------------------------------------------------


def _child_fields(dt: st.DataType) -> List[st.Field]:
    if isinstance(dt, st.List):
        return [st.Field("item", dt.value)]
    if isinstance(dt, st.FixedSizeList):
        return [st.Field("item", dt.value)]
    if isinstance(dt, st.Map):
        return [st.Field("entries", dt.entry_struct, False)]
    if isinstance(dt, st.Struct):
        return list(dt.fields)
    if isinstance(dt, st.Union):
        return list(dt.fields)
    if isinstance(dt, st.RunEndEncoded):
        return [st.Field("run_ends", dt.run_end, False),
                st.Field("values", dt.value)]
    return []


def field_to_json(f: st.Field, dict_ids: Dict[int, int]) -> Dict[str, Any]:
    dt = f.dtype
    out: Dict[str, Any] = {"name": f.name, "nullable": bool(f.nullable)}
    if isinstance(dt, st.Dictionary):
        kdt = dt.key
        out["type"] = datatype_to_json(dt.value)
        out["children"] = [field_to_json(c, dict_ids)
                           for c in _child_fields(dt.value)]
        out["dictionary"] = {
            "id": dict_ids[id(f)],
            "indexType": {"name": "int", "bitWidth": kdt.bits,
                          "isSigned": kdt.signed},
            "isOrdered": False,
        }
        return out
    out["type"] = datatype_to_json(dt)
    out["children"] = [field_to_json(c, dict_ids) for c in _child_fields(dt)]
    return out


def field_from_json(obj: Dict[str, Any]) -> st.Field:
    children = [field_from_json(c) for c in obj.get("children", [])]
    dt = datatype_from_json(obj["type"], children)
    d = obj.get("dictionary")
    if d is not None:
        it = d["indexType"]
        dt = st.Dictionary(st.Int(it["bitWidth"], signed=it["isSigned"]), dt)
    return st.Field(obj["name"], dt, obj.get("nullable", True))


# ---------------------------------------------------------------------------
# Column -> JSON (logical values -> format physical encodings)
# ---------------------------------------------------------------------------


def _hex(b: bytes) -> str:
    return b.hex().upper()


def _validity_and_values(c: col.Column):
    vals = c.to_pylist()
    validity = [0 if v is None else 1 for v in vals]
    return validity, vals


def _offsets_of(lengths: List[int], large: bool):
    offs = [0]
    for n in lengths:
        offs.append(offs[-1] + n)
    return [str(o) for o in offs] if large else offs


def column_to_json(name: str, f_dt: st.DataType, c: col.Column,
                   dict_batches: List[Dict[str, Any]],
                   dict_ids: Dict[int, int], field_obj=None) -> Dict[str, Any]:
    n = c.length
    out: Dict[str, Any] = {"name": name, "count": n}

    if isinstance(c, col.NullColumn):
        return out

    if isinstance(c, col.DictionaryColumn):
        # keys column here; values go to the dictionaries section
        kv = c.keys.values[:n].cpu().numpy()
        validity = ([1] * n if c.keys.validity is None else
                    bm.to_numpy_bools(c.keys.validity, n).astype(int)
                    .tolist())
        out["VALIDITY"] = validity
        out["DATA"] = [int(x) for x in kv]
        did = dict_ids[id(field_obj)] if field_obj is not None else \
            len(dict_batches)
        vals_col = column_to_json("DICT", f_dt.value, c.values,
                                  dict_batches, dict_ids)
        dict_batches.append({
            "id": did,
            "data": {"count": c.values.length,
                     "columns": [vals_col]},
        })
        return out

    validity, vals = _validity_and_values(c)
    dt = f_dt

    if isinstance(c, col.UnionColumn):
        tids = c.type_id_arr[:n].cpu().tolist()
        out["TYPE_ID"] = [int(t) for t in tids]
        if c.offsets is not None:
            out["OFFSET"] = c.offsets[:n].cpu().tolist()
        out["children"] = [
            column_to_json(fld.name, fld.dtype, ch, dict_batches, dict_ids)
            for fld, ch in zip(dt.fields, c.children)
        ]
        return out

    if isinstance(c, col.RunEndColumn):
        n_runs = c.values.length
        ends = c.run_ends[:n_runs].cpu().numpy()
        ends_col: Dict[str, Any] = {
            "name": "run_ends", "count": n_runs,
            "VALIDITY": [1] * n_runs,
            "DATA": [int(e) for e in ends],
        }
        out["children"] = [
            ends_col,
            column_to_json("values", dt.value, c.values,
                           dict_batches, dict_ids),
        ]
        return out

    out["VALIDITY"] = validity

    if isinstance(dt, st.Boolean):
        out["DATA"] = [bool(v) if v is not None else False for v in vals]
    elif isinstance(dt, st.Int) and dt.bits == 64:
        out["DATA"] = [str(int(v)) if v is not None else "0" for v in vals]
    elif isinstance(dt, st.Int):
        out["DATA"] = [int(v) if v is not None else 0 for v in vals]
    elif isinstance(dt, st.Float):
        out["DATA"] = [float(v) if v is not None else 0.0 for v in vals]
    elif isinstance(dt, st.Utf8):
        strs = [v if v is not None else "" for v in vals]
        out["OFFSET"] = _offsets_of(
            [len(s.encode()) for s in strs], large=False)
        out["DATA"] = strs
    elif isinstance(dt, st.Binary):
        bs = [bytes(v) if v is not None else b"" for v in vals]
        out["OFFSET"] = _offsets_of([len(b) for b in bs], large=False)
        out["DATA"] = [_hex(b) for b in bs]
    elif isinstance(dt, st.FixedSizeBinary):
        out["DATA"] = [_hex(bytes(v)) if v is not None
                       else "00" * dt.byte_width for v in vals]
    elif st.decimal_limbs(dt) is not None:
        out["DATA"] = [
            str(int(v.scaleb(dt.scale))) if v is not None else "0"
            for v in vals]
    elif isinstance(dt, (st.Date64, st.Time64, st.Timestamp, st.Duration)):
        out["DATA"] = [str(int(v)) if v is not None else "0" for v in vals]
    elif isinstance(dt, (st.Date32, st.Time32)):
        out["DATA"] = [int(v) if v is not None else 0 for v in vals]
    elif isinstance(dt, st.Interval):
        if dt.unit == "year_month":
            out["DATA"] = [int(v) if v is not None else 0 for v in vals]
        elif dt.unit == "day_time":
            out["DATA"] = [
                {"days": v[0], "milliseconds": v[1]} if v is not None
                else {"days": 0, "milliseconds": 0} for v in vals]
        else:
            out["DATA"] = [
                {"months": v[0], "days": v[1], "nanoseconds": v[2]}
                if v is not None
                else {"months": 0, "days": 0, "nanoseconds": 0}
                for v in vals]
    elif isinstance(dt, st.Map):
        assert isinstance(c, col.ListViewColumn)
        sizes = [len(v) if v is not None else 0 for v in vals]
        out["OFFSET"] = _offsets_of(sizes, large=False)
        flat = [e for v in vals if v is not None for e in v]
        entries = from_pylist(
            [{"key": k, "value": x} for k, x in flat], dt.entry_struct,
            c.device)
        out["children"] = [column_to_json("entries", dt.entry_struct,
                                          entries, dict_batches, dict_ids)]
    elif isinstance(dt, st.List):
        sizes = [len(v) if v is not None else 0 for v in vals]
        out["OFFSET"] = _offsets_of(sizes, large=False)
        flat = [e for v in vals if v is not None for e in v]
        child = from_pylist(flat or [None], dt.value, c.device)
        ccol = column_to_json("item", dt.value, child, dict_batches,
                              dict_ids)
        if not flat:
            ccol["count"] = 0
            for k in ("VALIDITY", "DATA", "OFFSET"):
                if k in ccol and isinstance(ccol[k], list):
                    ccol[k] = []
        out["children"] = [ccol]
    elif isinstance(dt, st.FixedSizeList):
        flat = []
        for v in vals:
            flat.extend(v if v is not None else [None] * dt.size)
        child = from_pylist(flat or [None], dt.value, c.device)
        out["children"] = [column_to_json("item", dt.value, child,
                                          dict_batches, dict_ids)]
    elif isinstance(dt, st.Struct):
        assert isinstance(c, col.StructColumn)
        out["children"] = [
            column_to_json(fld.name, fld.dtype, ch, dict_batches, dict_ids)
            for fld, ch in zip(dt.fields, c.children)
        ]
    else:
        raise st.ArrowTpuError(f"integration: cannot serialize {dt}")
    return out


# ---------------------------------------------------------------------------
# JSON -> Column (via logical values)
# ---------------------------------------------------------------------------


def _json_values(obj: Dict[str, Any], dt: st.DataType,
                 dictionaries: Dict[int, Any],
                 field_obj: Optional[Dict[str, Any]] = None) -> List[Any]:
    """Decode a JSON column object into a python value list."""
    n = obj["count"]
    validity = obj.get("VALIDITY") or [1] * n
    data = obj.get("DATA")

    if isinstance(dt, st.Null):
        return [None] * n

    def mask(v):
        return [x if ok else None for x, ok in zip(v, validity)]

    if isinstance(dt, st.Boolean):
        return mask([bool(x) if not isinstance(x, str) else x in ("1", "true")
                     for x in data])
    if isinstance(dt, st.Int):
        return mask([int(x) for x in data])
    if isinstance(dt, st.Float):
        return mask([float(x) for x in data])
    if isinstance(dt, st.Utf8):
        return mask([str(x) for x in data])
    if isinstance(dt, st.Binary):
        return mask([bytes.fromhex(x) for x in data])
    if isinstance(dt, st.FixedSizeBinary):
        return mask([bytes.fromhex(x) for x in data])
    if st.decimal_limbs(dt) is not None:
        import decimal as _d

        with _d.localcontext(_d.Context(prec=80)):
            return mask([_d.Decimal(int(x)).scaleb(-dt.scale)
                         for x in data])
    if isinstance(dt, (st.Date32, st.Date64, st.Time32, st.Time64,
                       st.Timestamp, st.Duration)):
        return mask([int(x) for x in data])
    if isinstance(dt, st.Interval):
        if dt.unit == "year_month":
            return mask([int(x) for x in data])
        if dt.unit == "day_time":
            return mask([(int(x["days"]), int(x["milliseconds"]))
                         for x in data])
        return mask([(int(x["months"]), int(x["days"]),
                      int(x["nanoseconds"])) for x in data])
    if isinstance(dt, st.Map):
        offs = [int(o) for o in obj["OFFSET"]]
        entries = _json_values(obj["children"][0], dt.entry_struct,
                               dictionaries)
        out = []
        for i in range(n):
            if not validity[i]:
                out.append(None)
            else:
                out.append([(e["key"], e["value"])
                            for e in entries[offs[i]:offs[i + 1]]])
        return out
    if isinstance(dt, st.List):
        offs = [int(o) for o in obj["OFFSET"]]
        child = _json_values(obj["children"][0], dt.value, dictionaries)
        return [child[offs[i]:offs[i + 1]] if validity[i] else None
                for i in range(n)]
    if isinstance(dt, st.FixedSizeList):
        child = _json_values(obj["children"][0], dt.value, dictionaries)
        return [child[i * dt.size:(i + 1) * dt.size] if validity[i]
                else None for i in range(n)]
    if isinstance(dt, st.Struct):
        kids = {
            f.name: _json_values(c, f.dtype, dictionaries)
            for f, c in zip(dt.fields, obj.get("children", []))
        }
        names = [f.name for f in dt.fields]
        return [
            {nm: kids[nm][i] for nm in names} if validity[i] else None
            for i in range(n)
        ]
    raise st.ArrowTpuError(f"integration: cannot parse values for {dt}")


def column_from_json(obj: Dict[str, Any], f: st.Field,
                     dictionaries: Dict[int, Any],
                     field_json: Optional[Dict[str, Any]] = None,
                     device=None) -> col.Column:
    device = resolve_device(device)
    dt = f.dtype
    n = obj["count"]
    if isinstance(dt, st.Null):
        return col.null_column(n, device)
    if isinstance(dt, st.Dictionary):
        did = field_json["dictionary"]["id"]
        dcols = dictionaries[did]["data"]["columns"][0]
        values = column_from_json(
            dcols, st.Field("values", dt.value), dictionaries, device=device)
        validity = obj.get("VALIDITY") or [1] * n
        cap = round_up(max(n, 1))
        kv = np.zeros(cap, np.int32)
        kv[:n] = [int(x) for x in obj["DATA"]]
        kvalid = (bm.from_numpy_bools(np.array(validity, bool), cap, device)
                  if not all(validity) else None)
        keys = col.PrimitiveColumn(torch.from_numpy(kv).to(device), kvalid,
                                   n, st.int32)
        return col.DictionaryColumn(keys, values, None, dt)
    if isinstance(dt, st.Union):
        children = [
            column_from_json(c, fld, dictionaries, device=device)
            for fld, c in zip(dt.fields, obj["children"])
        ]
        offsets = None
        if dt.mode == "dense":
            offsets = [int(o) for o in obj["OFFSET"]]
        return col.union_column(obj["TYPE_ID"], children, dt,
                                offsets=offsets, length=n, device=device)
    if isinstance(dt, st.RunEndEncoded):
        ends = [int(x) for x in obj["children"][0]["DATA"]]
        values = column_from_json(obj["children"][1],
                                  st.Field("values", dt.value),
                                  dictionaries, device=device)
        return col.run_end_encoded(np.asarray(ends, np.int32), values,
                                   dtype=dt)
    vals = _json_values(obj, dt, dictionaries, field_json)
    return from_pylist(vals, dt, device)


# ---------------------------------------------------------------------------
# Document level
# ---------------------------------------------------------------------------


def to_json(batches: List[bt.RecordBatch]) -> Dict[str, Any]:
    """RecordBatches -> archery JSON document (arrow-rs ArrowJson)."""
    if not batches:
        raise st.ArrowTpuError("integration: need at least one batch")
    schema = batches[0].schema
    dict_ids: Dict[int, int] = {}
    next_id = 0
    for f in schema.fields:
        if isinstance(f.dtype, st.Dictionary):
            dict_ids[id(f)] = next_id
            next_id += 1
    fields_json = [field_to_json(f, dict_ids) for f in schema.fields]
    dict_batches: List[Dict[str, Any]] = []
    out_batches = []
    for b_i, b in enumerate(batches):
        cols = []
        later: List[Dict[str, Any]] = []
        for f, c in zip(schema.fields, b.columns):
            cols.append(column_to_json(f.name, f.dtype, c,
                                       dict_batches if b_i == 0 else later,
                                       dict_ids, field_obj=f))
        # the document has ONE dictionaries section keyed by id; batches
        # past the first must share batch 0's dictionaries exactly (the
        # IPC delta-dictionary mechanism has no JSON counterpart):
        # dropping a differing dictionary would round-trip wrong data
        by_id = {d["id"]: d["data"] for d in dict_batches}
        for d in later:
            if d["data"] != by_id.get(d["id"]):
                raise st.ArrowTpuError(
                    "integration: dictionary for id %r differs across "
                    "batches; archery JSON documents require one shared "
                    "dictionary per id" % d["id"])
        out_batches.append(
            {"count": b.length,
             "columns": cols})
    doc: Dict[str, Any] = {"schema": {"fields": fields_json},
                           "batches": out_batches}
    if dict_batches:
        doc["dictionaries"] = dict_batches
    return doc


def from_json(doc: Dict[str, Any], device=None
              ) -> Tuple[st.Schema, List[bt.RecordBatch]]:
    """archery JSON document -> (Schema, RecordBatches on `device`)."""
    device = resolve_device(device)
    fields_json = doc["schema"]["fields"]
    fields = [field_from_json(f) for f in fields_json]
    schema = st.Schema(tuple(fields))
    dictionaries = {d["id"]: d for d in doc.get("dictionaries", [])}
    batches = []
    for b in doc["batches"]:
        cols = tuple(
            column_from_json(cobj, f, dictionaries, field_json=fj,
                             device=device)
            for cobj, f, fj in zip(b["columns"], fields, fields_json)
        )
        batches.append(bt.RecordBatch(schema, cols))
    return schema, batches


def write_json_file(batches: List[bt.RecordBatch], path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_json(batches), f)


def read_json_file(path: str, device=None
                   ) -> Tuple[st.Schema, List[bt.RecordBatch]]:
    with open(path) as f:
        return from_json(json.load(f), device)
