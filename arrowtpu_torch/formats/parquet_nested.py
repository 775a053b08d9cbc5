"""Parquet nested schemas: Dremel definition / repetition levels.

Counterpart of `arrowtpu/formats/parquet_nested.py`, the same levels and
schema elements, after the reference's
  * writer shredding, parquet/src/arrow/arrow_writer/levels.rs:79
    calculate_array_levels: nested columns -> per-leaf (def, rep, values)
    streams;
  * reader assembly, parquet/src/arrow/record_reader/mod.rs +
    definition_levels.rs: level streams -> nested columns (here the port's
    list-view, struct and, for map entries, struct columns);
  * schema conversion, parquet/src/arrow/schema/complex.rs (LIST / MAP
    3-level structure, struct groups).

The level math is vectorized numpy, one repeat / cumsum / bincount pass a
nesting level, on the host; the assembled columns land on a device with
one host-to-device copy a buffer.

Level semantics (parquet LogicalTypes.md):
  optional group <f> (LIST) { repeated group list { <element> } }
    null list -> def d;  empty -> d+1;  element slot -> d+2 (+1 more if
    the optional element is non-null); elements after the first repeat at
    rep = parent_max_rep + 1.
  optional group <f> (MAP) { repeated group key_value {
    required key; optional value } }: a list of the 2-field entry struct.
  optional group <f> { children }: a struct, def + 1 when present.
Fixed-size lists are written as LIST (parquet has no fixed-size
repetition) and read back as lists, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .. import schema as st
from ..config import round_up
from ..core import bitmap as bm
from ..core import column as col
from .geospatial import GEO_CRS_KEY, GEO_KEY

I32 = np.int32

# the field metadata key of the JAX package's extension module
EXTENSION_NAME_KEY = "ARROW:extension:name"


@dataclasses.dataclass
class LeafStream:
    """One parquet leaf column of a (possibly) nested field."""

    path: List[str]
    dtype: st.DataType          # primitive / string leaf type
    nullable: bool              # the leaf's own optional flag
    max_def: int
    max_rep: int
    def_levels: np.ndarray      # (n_entries,) int32
    rep_levels: np.ndarray      # (n_entries,) int32
    values: Any                 # array or list of bytes: defined slots only
    num_entries: int


@dataclasses.dataclass
class _Frame:
    row: np.ndarray     # index into the current node's rows
    d: np.ndarray       # definition level accumulated so far
    r: np.ndarray       # repetition level of each entry
    alive: np.ndarray   # still defined at this depth


def _np_valid_full(c: col.Column) -> np.ndarray:
    """Validity over the full capacity (frames index arbitrary rows); no
    bitmap is every row valid, as in the JAX package."""
    cap = c.capacity
    if getattr(c, "validity", None) is None:
        return np.ones(cap, bool)
    return bm.to_numpy_bools(c.validity, cap)


def is_nested(dt: st.DataType) -> bool:
    return isinstance(dt, (st.List, st.Map, st.Struct, st.FixedSizeList))


def shred_column(name: str, c: col.Column, nullable: bool) -> List[LeafStream]:
    """Dremel shredding: a nested column -> its leaf streams (levels.rs:79)."""
    n = int(c.length)
    frame = _Frame(np.arange(n, dtype=np.int64), np.zeros(n, I32),
                   np.zeros(n, I32), np.ones(n, bool))
    return _shred(c, c.dtype, nullable, frame, [name], 0, 0)


def _f_idx(f: _Frame, cap: int) -> np.ndarray:
    return np.clip(f.row, 0, max(cap - 1, 0)).astype(np.int64)


def _shred(c: col.Column, dt: st.DataType, nullable: bool, f: _Frame,
           path: List[str], d: int, r: int) -> List[LeafStream]:
    if isinstance(c, col.DictionaryColumn):
        from .parquet import _decode_dict

        return _shred(_decode_dict(c), dt.value if isinstance(
            dt, st.Dictionary) else dt, nullable, f, path, d, r)

    if isinstance(c, col.FixedSizeListColumn):
        size = c.dtype.size
        return _shred_list(c.child, dt.value, (f.row * size).astype(np.int64),
                           np.full(f.row.shape, size, I32), _np_valid_full(c),
                           nullable, f, path, d, r, element_name="element",
                           group_name="list")

    if isinstance(c, col.ListViewColumn):
        rows = _f_idx(f, c.capacity)
        starts = c.starts.cpu().numpy().astype(np.int64)[rows]
        sizes = c.sizes.cpu().numpy().astype(np.int64)[rows]
        valid = _np_valid_full(c)
        if isinstance(c.dtype, st.Map):
            return _shred_list(c.child, c.dtype.entry_struct, starts, sizes,
                               valid, nullable, f, path, d, r,
                               element_name="key_value", group_name=None,
                               element_nullable=False)
        return _shred_list(c.child, c.dtype.value, starts, sizes, valid,
                           nullable, f, path, d, r, element_name="element",
                           group_name="list")

    if isinstance(c, col.StructColumn):
        valid = _np_valid_full(c)
        dv = valid[_f_idx(f, c.capacity)] & f.alive if nullable else f.alive
        f2 = _Frame(f.row, (f.d + (dv if nullable else 0)).astype(I32), f.r,
                    f.alive & dv if nullable else f.alive)
        out: List[LeafStream] = []
        for fld, ch in zip(c.dtype.fields, c.children):
            out.extend(_shred(ch, fld.dtype, fld.nullable, f2,
                              path + [fld.name], d + (1 if nullable else 0),
                              r))
        return out

    # ---- leaf ----
    rows_c = _f_idx(f, c.capacity)
    leaf_ok = f.alive & _np_valid_full(c)[rows_c]
    defs = (f.d + (leaf_ok if nullable else 0)).astype(I32)
    if not nullable and not bool(np.all(leaf_ok | ~f.alive)):
        raise st.ArrowTpuError(f"parquet: nulls in non-nullable leaf {path}")
    values = _leaf_values(c, rows_c[leaf_ok])
    leaf_dt = dt.value if isinstance(dt, st.Dictionary) else dt
    return [LeafStream(path, leaf_dt, nullable, d + (1 if nullable else 0), r,
                       defs, f.r.astype(I32), values, len(defs))]


def _shred_list(child: col.Column, elem_dt: st.DataType,
                starts: np.ndarray, sizes: np.ndarray, valid_full: np.ndarray,
                nullable: bool, f: _Frame, path: List[str], d: int, r: int,
                element_name: str, group_name: Optional[str],
                element_nullable: bool = True) -> List[LeafStream]:
    valid = valid_full[_f_idx(f, len(valid_full))] & f.alive
    szs = np.where(valid, sizes, 0).astype(np.int64)
    nonempty = valid & (szs > 0)
    cnt = np.where(nonempty, szs, 1)
    idx = np.repeat(np.arange(len(f.row)), cnt)
    ends = np.cumsum(cnt)
    within = np.arange(int(ends[-1]) if len(ends) else 0) - (ends - cnt)[idx]
    new_d = (f.d[idx] + (valid[idx].astype(I32) if nullable else 0)
             + nonempty[idx].astype(I32))
    rep_level = r + 1
    new_r = np.where(within == 0, f.r[idx], I32(rep_level)).astype(I32)
    f2 = _Frame(starts[idx] + within, new_d.astype(I32), new_r,
                nonempty[idx])
    nd = d + (1 if nullable else 0) + 1   # list present, element exists
    if isinstance(elem_dt, st.Struct) and group_name is None:
        # map entries: the key_value group is REQUIRED repeated; recurse
        # into the entry struct's fields directly
        out: List[LeafStream] = []
        for fld, ch in zip(elem_dt.fields, child.children):
            out.extend(_shred(ch, fld.dtype, fld.nullable, f2,
                              path + [element_name, fld.name], nd,
                              rep_level))
        return out
    return _shred(child, elem_dt, element_nullable, f2,
                  path + ([group_name] if group_name else []) + [element_name],
                  nd, rep_level)


def _leaf_values(c: col.Column, rows: np.ndarray):
    """Values of the given rows (fully defined leaf slots, in order)."""
    if isinstance(c, col.BooleanColumn):
        return c.values_bool().cpu().numpy()[rows]
    if isinstance(c, col.StringViewColumn):
        views = c.views.cpu().numpy().view(np.uint32)
        arena = c.arena.cpu().numpy()
        out = []
        for i in rows.tolist():
            ln = int(views[i, 0])
            if ln <= 12:
                out.append(views[i, 1:4].tobytes()[:ln])
            else:
                off = int(views[i, 3])
                out.append(arena[off:off + ln].tobytes())
        return out
    if isinstance(c, col.PrimitiveColumn):
        from .parquet import physical_width

        vals = c.values.cpu().numpy()
        if st.is_u64(c.dtype):
            vals = vals.view(np.uint64)
        elif vals.ndim == 2:
            vals = vals.view(np.uint32)
        return physical_width(vals[rows])
    raise st.ArrowTpuError(
        f"parquet: unsupported leaf column {type(c).__name__}")


# ---------------------------------------------------------------------------
# assembly (reader): leaf level streams -> nested column
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LeafData:
    """A decoded leaf chunk: level streams + values (reader side)."""

    defs: np.ndarray
    reps: np.ndarray
    values: Any
    dtype: st.DataType
    nullable: bool
    max_def: int


def assemble_column(field: st.Field, leaves: List[LeafData], num_rows: int,
                    device) -> col.Column:
    """Dremel assembly (record_reader/mod.rs): level streams -> a column
    on `device`."""
    views = [(lf, np.arange(len(lf.defs))) for lf in leaves]
    return _assemble(field.dtype, field.nullable, views, 0, 0, num_rows,
                     device)


def _assemble(dt: st.DataType, nullable: bool,
              views: List[Tuple[LeafData, np.ndarray]], d: int, r: int,
              num_slots: int, device) -> col.Column:
    """views: per leaf, (LeafData, the entry indices of this node's
    entries)."""
    if isinstance(dt, st.Struct):
        dp = d + (1 if nullable else 0)
        children = []
        used = 0
        for fld in dt.fields:
            n_leaves = leaf_count(fld.dtype)
            children.append(_assemble(fld.dtype, fld.nullable,
                                      views[used:used + n_leaves], dp, r,
                                      num_slots, device))
            used += n_leaves
        lf, sel = views[0]
        validity = (_pack_validity(_slot_defs(lf, sel, r) >= dp, num_slots,
                                   device) if nullable else None)
        return col.StructColumn(tuple(children), validity, num_slots, dt)

    if isinstance(dt, (st.List, st.Map)):
        dp = d + (1 if nullable else 0)   # list present
        de = dp + 1                        # element slot exists
        re_ = r + 1
        lf0, sel0 = views[0]
        reps = lf0.reps[sel0]
        defs = lf0.defs[sel0]
        inst_mask = reps <= r
        ninst = int(inst_mask.sum())
        inst_def = defs[inst_mask]
        inst_id = np.cumsum(inst_mask) - 1
        elem_mask = (reps <= re_) & (defs >= de)
        sizes = np.bincount(inst_id[elem_mask], minlength=ninst).astype(I32)
        null_inst = inst_def < dp if nullable else np.zeros(ninst, bool)
        sizes = np.where(null_inst, 0, sizes).astype(I32)
        ends = np.cumsum(sizes)
        # child entries: everything that belongs to an element slot
        child_views = [(lf, sel[lf.defs[sel] >= de]) for lf, sel in views]
        n_elems = int(ends[-1]) if ninst else 0
        if isinstance(dt, st.Map):
            child = _assemble(dt.entry_struct, False, child_views, de, re_,
                              n_elems, device)
        else:
            child = _assemble(dt.value, True, child_views, de, re_, n_elems,
                              device)
        cap = round_up(max(num_slots, 1))
        starts_p = np.zeros(cap, I32)
        sizes_p = np.zeros(cap, I32)
        starts_p[:ninst] = ends - sizes
        sizes_p[:ninst] = sizes
        validity = (_pack_validity(~null_inst, num_slots, device)
                    if nullable else None)
        return col.ListViewColumn(torch.from_numpy(starts_p).to(device),
                                  torch.from_numpy(sizes_p).to(device),
                                  child, validity, num_slots, dt)

    # leaf: the values are stored for fully defined entries in entry
    # order; map each selected entry to its value's ordinal
    lf, sel = views[0]
    present = lf.defs[sel] >= lf.max_def
    ordinal = np.cumsum(lf.defs >= lf.max_def) - 1
    return _build_leaf(dt, nullable, present, ordinal[sel[present]],
                       lf.values, len(sel), device)


def leaf_count(dt: st.DataType) -> int:
    if isinstance(dt, st.Struct):
        return sum(leaf_count(f.dtype) for f in dt.fields)
    if isinstance(dt, (st.List, st.FixedSizeList)):
        return leaf_count(dt.value)
    if isinstance(dt, st.Map):
        return leaf_count(dt.key) + leaf_count(dt.item)
    return 1


def _slot_defs(lf: LeafData, sel: np.ndarray, r: int) -> np.ndarray:
    return lf.defs[sel][lf.reps[sel] <= r]


def _pack_validity(ok: np.ndarray, num_slots: int, device):
    cap = round_up(max(num_slots, 1))
    padded = np.zeros(cap, bool)
    padded[:len(ok)] = ok
    return bm.from_numpy_bools(padded, cap, device)


def _build_leaf(dt: st.DataType, nullable: bool, present: np.ndarray,
                take: np.ndarray, values: Any, num_slots: int,
                device) -> col.Column:
    if isinstance(values, list):
        from .parquet import byte_arrays_column

        return byte_arrays_column([values[t] for t in take.tolist()],
                                  present, dt, device)
    vals = np.asarray(values)
    full = np.zeros(num_slots, vals.dtype if vals.size else np.int64)
    full[present] = vals[take]
    validity = present if nullable else None
    if isinstance(dt, st.Boolean):
        return col.boolean(full.astype(bool), validity=validity,
                           length=num_slots, device=device)
    return col.primitive(full.astype(col.numpy_dtype(dt)), dt,
                         validity=validity, length=num_slots, device=device)


# ---------------------------------------------------------------------------
# schema elements (thrift tree) for nested fields
# ---------------------------------------------------------------------------

CONV_MAP, CONV_LIST = 2, 3
REP_REQUIRED, REP_OPTIONAL, REP_REPEATED = 0, 1, 2


def count_schema_elements(dt: st.DataType) -> int:
    if isinstance(dt, st.Struct):
        return 1 + sum(count_schema_elements(f.dtype) for f in dt.fields)
    if isinstance(dt, (st.List, st.FixedSizeList)):
        return 2 + count_schema_elements(dt.value)
    if isinstance(dt, st.Map):
        return (2 + count_schema_elements(dt.key)
                + count_schema_elements(dt.item))
    return 1


def write_schema_elements(w, name: str, dt: st.DataType, nullable: bool,
                          logical=None):
    """Emit this field's SchemaElement subtree (thrift writer `w`).

    `logical="variant"` annotates a struct group with the VARIANT
    logicalType (SchemaElement field 10, union member 16 VariantType with
    specification_version=1; reference parquet/src/basic.rs); a
    (kind, crs) pair of `geospatial.geo_annotation` annotates a leaf as
    GEOMETRY or GEOGRAPHY."""
    from .parquet import _physical

    rep = REP_OPTIONAL if nullable else REP_REQUIRED
    if isinstance(dt, st.Struct):
        w.struct_begin()
        w.field_i32(3, rep)
        w.field_string(4, name)
        w.field_i32(5, len(dt.fields))
        if logical == "variant":
            w.field_struct(10)
            w.struct_begin()
            w.field_struct(16)  # LogicalType union: VARIANT
            w.struct_begin()
            # specification_version (1: optional i8) is a BYTE field
            w._field_header(1, 3)  # CT_BYTE
            w.buf.append(1)  # version 1
            w.struct_end()
            w.struct_end()
        w.struct_end()
        for f in dt.fields:
            write_schema_elements(w, f.name, f.dtype, f.nullable)
        return
    if isinstance(dt, (st.List, st.FixedSizeList, st.Map)):
        is_map = isinstance(dt, st.Map)
        w.struct_begin()
        w.field_i32(3, rep)
        w.field_string(4, name)
        w.field_i32(5, 1)
        w.field_i32(6, CONV_MAP if is_map else CONV_LIST)
        w.struct_end()
        w.struct_begin()
        w.field_i32(3, REP_REPEATED)
        w.field_string(4, "key_value" if is_map else "list")
        w.field_i32(5, 2 if is_map else 1)
        w.struct_end()
        if is_map:
            write_schema_elements(w, "key", dt.key, False)
            write_schema_elements(w, "value", dt.item, True)
        else:
            write_schema_elements(w, "element", dt.value, True)
        return
    phys, conv = _physical(dt)
    w.struct_begin()
    w.field_i32(1, phys)
    nl = st.decimal_limbs(dt)
    if nl is not None and nl >= 4:
        w.field_i32(2, nl * 4)  # FLBA type_length
    w.field_i32(3, rep)
    w.field_string(4, name)
    if conv is not None:
        w.field_i32(6, conv)
    if nl is not None:
        w.field_i32(7, dt.scale)
        w.field_i32(8, dt.precision)
    if isinstance(logical, tuple):
        # GEOMETRY (union id 17) / GEOGRAPHY (18) with an optional crs
        # (reference parquet/src/basic.rs:289-297)
        kind, crs = logical
        w.field_struct(10)
        w.struct_begin()
        w.field_struct(17 if kind == "geometry" else 18)
        w.struct_begin()
        if crs:
            w.field_string(1, crs)
        w.struct_end()
        w.struct_end()
    w.struct_end()


def _name(e: dict) -> str:
    v = e[4]
    return v.decode("utf-8") if isinstance(v, (bytes, bytearray)) else v


def parse_schema_tree(elems: List[dict], i: int) -> Tuple[st.Field, int, List]:
    """Parse one field's subtree starting at elems[i].  -> (field, next
    index, leaves [(max_def, max_rep, dtype, nullable, type_length)])."""
    from .parquet import _logical

    e = elems[i]
    name = _name(e)

    def walk(i: int, d: int, r: int) -> Tuple[st.DataType, bool, int, List]:
        e = elems[i]
        rep = e.get(3, 0)
        opt = rep == REP_OPTIONAL
        repeated = rep == REP_REPEATED
        nchild = e.get(5)
        conv = e.get(6)
        d2 = d + (1 if opt else 0) + (1 if repeated else 0)
        r2 = r + (1 if repeated else 0)
        if not nchild:
            dt = _logical(e[1], conv, e)
            return dt, opt, i + 1, [(d2, r2, dt, opt, e.get(2))]
        if conv == CONV_LIST:
            # group (LIST) { repeated group { element } }
            dt_el, _, nxt, leaves = walk(i + 2, d2 + 1, r2 + 1)
            return st.List(dt_el), opt, nxt, leaves
        if conv == CONV_MAP:
            kdt, _, j, kl = walk(i + 2, d2 + 1, r2 + 1)
            vdt, _, nxt, vl = walk(j, d2 + 1, r2 + 1)
            return st.Map(kdt, vdt), opt, nxt, kl + vl
        # plain struct group
        fields = []
        leaves: List = []
        j = i + 1
        for _ in range(nchild):
            subname = _name(elems[j])
            sdt, sopt, j, sl = walk(j, d2, r2)
            fields.append(st.Field(subname, sdt, sopt))
            leaves.extend(sl)
        return st.Struct(tuple(fields)), opt, j, leaves

    dt, opt, nxt, leaves = walk(i, 0, 0)
    logical = e.get(10)
    if isinstance(logical, dict):
        if 16 in logical:
            # VARIANT (basic.rs thrift id 16) -> the arrow.parquet.variant
            # extension annotation on the field
            return (st.Field(name, dt, opt, ((EXTENSION_NAME_KEY,
                                              "arrow.parquet.variant"),)),
                    nxt, leaves)
        if 17 in logical or 18 in logical:
            # GEOMETRY / GEOGRAPHY -> the geospatial annotation and its crs
            kind = "geometry" if 17 in logical else "geography"
            sub = logical.get(17, logical.get(18)) or {}
            md = ((GEO_KEY, kind),)
            crs = sub.get(1)
            if crs:
                md += ((GEO_CRS_KEY, crs.decode("utf-8") if isinstance(
                    crs, (bytes, bytearray)) else crs),)
            return st.Field(name, dt, opt, md), nxt, leaves
    return st.Field(name, dt, opt), nxt, leaves
