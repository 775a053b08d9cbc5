"""Parquet scan pushdown: RowSelection algebra, RowFilter predicates, and
statistics / bloom-filter / page-index pruning on read.

Counterpart of `arrowtpu/formats/parquet_scan.py`, the same rows and the
same `ScanMetrics`, after the reference's
  * RowSelection / RowSelector run-length algebra,
    parquet/src/arrow/arrow_reader/selection/mod.rs:118 (and_then :291,
    intersection :214, union :244, from_filters :160);
  * RowFilter / ArrowPredicate, arrow_reader/filter.rs:29: predicates
    evaluated in order over their own columns, before the rest decode;
  * row-group pruning by statistics (arrow_reader/statistics.rs:1463) and
    bloom filters, page pruning by the column and offset index;
  * ArrowReaderMetrics (arrow_reader/metrics.rs:119), here ScanMetrics.

The scan plan (selections, pruning, which pages to decode) is metadata
arithmetic on the host, and so is the decode (`decode_row_group`: the
kept pages to numpy).  The data plane runs on the scan's device
(`ParquetFile.device`, the card unless the caller asks for the CPU):
`upload_columns` builds the columns with one host-to-device copy a buffer
and drops with `ops.filter.filter_` the rows a kept page holds outside
the page selection, as the JAX scan does; `evaluate_predicates` evaluates each
predicate with `ops.cmp` and reads its mask back once (`.cpu()`, where the
JAX package calls `jax.device_get`), and `filter_row_group` compacts the
surviving rows with `ops.filter.filter_record_batch` (K1 and K2 on the
card).  `scan_batches_overlapped` decodes row groups on a producer thread,
host work only, while the caller's thread uploads and filters.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import schema as st
from ..core import batch as bt


# ---------------------------------------------------------------------------
# RowSelection (run-length algebra; reference selection/mod.rs:118)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RowSelector:
    """A run of rows to select or skip (reference RowSelector)."""

    row_count: int
    skip: bool

    @staticmethod
    def select(n: int) -> "RowSelector":
        return RowSelector(n, False)

    @staticmethod
    def skip_(n: int) -> "RowSelector":
        return RowSelector(n, True)


class RowSelection:
    """Ordered run-length selection over a row range."""

    def __init__(self, selectors: Sequence[RowSelector] = ()):
        self.selectors: Tuple[RowSelector, ...] = tuple(
            s for s in _normalize(selectors) if s.row_count > 0)

    @staticmethod
    def select_all(n: int) -> "RowSelection":
        return RowSelection([RowSelector.select(n)])

    @staticmethod
    def skip_all(n: int) -> "RowSelection":
        return RowSelection([RowSelector.skip_(n)])

    @staticmethod
    def from_mask(mask: np.ndarray) -> "RowSelection":
        """Boolean mask -> run-length selection (reference from_filters,
        selection/mod.rs:160)."""
        mask = np.asarray(mask, bool)
        if mask.size == 0:
            return RowSelection()
        change = np.nonzero(np.diff(mask))[0] + 1
        bounds = np.concatenate([[0], change, [mask.size]]).tolist()
        return RowSelection([RowSelector(b - a, not bool(mask[a]))
                             for a, b in zip(bounds[:-1], bounds[1:])])

    @staticmethod
    def from_ranges(ranges: Sequence[Tuple[int, int]],
                    total: int) -> "RowSelection":
        """Sorted, non-overlapping [start, end) ranges -> selection
        (reference from_consecutive_ranges)."""
        sels: List[RowSelector] = []
        pos = 0
        for a, b in ranges:
            if a > pos:
                sels.append(RowSelector.skip_(a - pos))
            sels.append(RowSelector.select(b - a))
            pos = b
        if pos < total:
            sels.append(RowSelector.skip_(total - pos))
        return RowSelection(sels)

    def row_count(self) -> int:
        """Selected rows."""
        return sum(s.row_count for s in self.selectors if not s.skip)

    def total_rows(self) -> int:
        return sum(s.row_count for s in self.selectors)

    def selects_any(self) -> bool:
        return any(not s.skip and s.row_count for s in self.selectors)

    def to_mask(self, total: Optional[int] = None) -> np.ndarray:
        n = total if total is not None else self.total_rows()
        out = np.zeros(n, bool)
        pos = 0
        for s in self.selectors:
            if not s.skip:
                out[pos:pos + s.row_count] = True
            pos += s.row_count
        if pos < n:
            out[pos:] = True  # past the selection: selected (ref. trails)
        return out

    def iter_ranges(self):
        pos = 0
        for s in self.selectors:
            if not s.skip:
                yield (pos, pos + s.row_count)
            pos += s.row_count

    def and_then(self, other: "RowSelection") -> "RowSelection":
        """Compose: `other` is expressed over THIS selection's selected
        rows (reference and_then, selection/mod.rs:291)."""
        assert other.total_rows() == self.row_count(), (
            other.total_rows(), self.row_count())
        mask = self.to_mask(self.total_rows())
        out = np.zeros(self.total_rows(), bool)
        out[np.nonzero(mask)[0]] = other.to_mask(self.row_count())
        return RowSelection.from_mask(out)

    def intersection(self, other: "RowSelection") -> "RowSelection":
        n = max(self.total_rows(), other.total_rows())
        return RowSelection.from_mask(self.to_mask(n) & other.to_mask(n))

    def union(self, other: "RowSelection") -> "RowSelection":
        n = max(self.total_rows(), other.total_rows())
        return RowSelection.from_mask(self.to_mask(n) | other.to_mask(n))

    def split_off(self, row_count: int
                  ) -> Tuple["RowSelection", "RowSelection"]:
        """The first `row_count` total rows, and the rest (reference
        split_off)."""
        head: List[RowSelector] = []
        tail: List[RowSelector] = []
        remaining = row_count
        for s in self.selectors:
            if remaining <= 0:
                tail.append(s)
            elif s.row_count <= remaining:
                head.append(s)
                remaining -= s.row_count
            else:
                head.append(RowSelector(remaining, s.skip))
                tail.append(RowSelector(s.row_count - remaining, s.skip))
                remaining = 0
        return RowSelection(head), RowSelection(tail)

    def __eq__(self, other):
        return (isinstance(other, RowSelection)
                and self.selectors == other.selectors)

    def __repr__(self):
        return "RowSelection(%s)" % ", ".join(
            f"{'skip' if s.skip else 'sel'}({s.row_count})"
            for s in self.selectors)


def _normalize(selectors):
    out: List[RowSelector] = []
    for s in selectors:
        if out and out[-1].skip == s.skip:
            out[-1] = RowSelector(out[-1].row_count + s.row_count, s.skip)
        else:
            out.append(s)
    return out


# ---------------------------------------------------------------------------
# predicates
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ColumnPredicate:
    """A (column op literal) predicate: it prunes by min / max statistics
    and bloom filters, and is evaluated on rows with `ops.cmp`."""

    column: str
    op: str  # eq, ne, lt, lt_eq, gt, gt_eq
    value: object

    def may_match_range(self, mn, mx, null_count=None) -> bool:
        """Can a row in [mn, mx] satisfy the predicate?  A None bound is
        unknown: the rows must be read."""
        if mn is None or mx is None:
            return True
        v = self.value
        try:
            if self.op == "eq":
                return mn <= v <= mx
            if self.op == "ne":
                return not (mn == v == mx)
            if self.op == "lt":
                return mn < v
            if self.op == "lt_eq":
                return mn <= v
            if self.op == "gt":
                return mx > v
            if self.op == "gt_eq":
                return mx >= v
        except TypeError:
            return True
        return True

    def evaluate(self, batch: bt.RecordBatch):
        """The row mask, on the batch's device."""
        from ..ops import cmp as oc

        fn = {"eq": oc.eq, "ne": oc.neq, "lt": oc.lt, "lt_eq": oc.lt_eq,
              "gt": oc.gt, "gt_eq": oc.gt_eq}[self.op]
        return fn(batch[self.column], self.value)


@dataclasses.dataclass
class ArrowPredicate:
    """A general predicate: its columns and a callable giving a
    BooleanColumn (reference ArrowPredicateFn, filter.rs:100)."""

    columns: Tuple[str, ...]
    fn: Callable[[bt.RecordBatch], object]

    def may_match_range(self, mn, mx, null_count=None) -> bool:
        return True  # opaque: cannot prune

    def evaluate(self, batch: bt.RecordBatch):
        return self.fn(batch)


def _pred_columns(p) -> Tuple[str, ...]:
    return (p.column,) if isinstance(p, ColumnPredicate) else tuple(p.columns)


@dataclasses.dataclass
class RowFilter:
    """Ordered predicates (reference RowFilter, filter.rs:29): each reads
    only its own columns and narrows the selection before the next."""

    predicates: List[object]


@dataclasses.dataclass
class ScanMetrics:
    """reference ArrowReaderMetrics, metrics.rs:119."""

    row_groups_total: int = 0
    row_groups_pruned_statistics: int = 0
    row_groups_pruned_bloom_filter: int = 0
    pages_total: int = 0
    pages_skipped: int = 0
    bytes_decompressed: int = 0
    rows_decoded: int = 0
    rows_matched: int = 0
    predicate_evaluations: int = 0

    def asdict(self):
        return dataclasses.asdict(self)

    def add(self, deltas: Dict[str, int]) -> None:
        for k, v in deltas.items():
            setattr(self, k, getattr(self, k) + v)


# ---------------------------------------------------------------------------
# pruning
# ---------------------------------------------------------------------------


def prune_row_groups(pf, predicates: Sequence[object],
                     metrics: Optional[ScanMetrics] = None) -> List[int]:
    """The row groups that may hold matching rows, by chunk statistics
    and (for equality predicates) bloom filters."""
    metrics = metrics if metrics is not None else ScanMetrics()
    keep = []
    for rg in range(len(pf.row_groups)):
        ok = True
        for p in predicates:
            if not isinstance(p, ColumnPredicate):
                continue
            stats = pf.statistics(rg, p.column)
            if stats is not None and not _may_match(p, stats):
                metrics.row_groups_pruned_statistics += 1
                ok = False
                break
            if p.op == "eq" and not pf.bloom_might_contain(rg, p.column,
                                                           p.value):
                metrics.row_groups_pruned_bloom_filter += 1
                ok = False
                break
        if ok:
            keep.append(rg)
    return keep


def _may_match(p: ColumnPredicate, stats) -> bool:
    v = p.value
    if isinstance(v, str):
        v = v.encode()
    if isinstance(v, bytes):
        p = ColumnPredicate(p.column, p.op, v)
    return p.may_match_range(stats.get("min"), stats.get("max"))


def page_selection(pf, rg: int, predicates: Sequence[object],
                   num_rows: int) -> Optional[RowSelection]:
    """A RowSelection from the column index (each page's min / max) and
    offset index (each page's first row) of every predicate column; None
    when no predicate column has a page index (read everything)."""
    from .parquet import decode_stat

    sel: Optional[RowSelection] = None
    for p in predicates:
        if not isinstance(p, ColumnPredicate):
            continue
        ci = pf.column_index(rg, p.column)
        oi = pf.offset_index(rg, p.column)
        if ci is None or oi is None:
            continue
        phys = pf._chunk_meta(rg, p.column)[1]
        firsts = [row for (_, _, row) in oi]
        bounds = firsts[1:] + [num_rows]
        ranges = []
        for k in range(len(firsts)):
            if ci["null_pages"][k]:
                mm = (None, None)
            else:
                mm = (decode_stat(ci["min_values"][k], phys),
                      decode_stat(ci["max_values"][k], phys))
            if p.may_match_range(*mm):
                ranges.append((firsts[k], bounds[k]))
        psel = RowSelection.from_ranges(_merge_ranges(ranges), num_rows)
        sel = psel if sel is None else sel.intersection(psel)
    return sel


def _merge_ranges(ranges):
    out = []
    for a, b in ranges:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


# ---------------------------------------------------------------------------
# the host half of a row group's scan: decode
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HostColumn:
    """One column of a row group decoded on the host, its rows those of
    the kept pages: a flat chunk's values and valid bools, or a nested
    field's leaves; `keep`, which of those rows the selection keeps (None:
    all); and the metrics its decode adds."""

    field: st.Field
    phys: int
    rows: int
    values: object = None
    valid: Optional[np.ndarray] = None
    leaves: Optional[list] = None
    keep: Optional[np.ndarray] = None
    deltas: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class HostRowGroup:
    """A row group's scan state after its host decode."""

    rg: int
    num_rows: int
    sel: Optional[RowSelection]
    columns: Dict[str, HostColumn]
    deltas: Dict[str, int] = dataclasses.field(default_factory=dict)
    skipped: bool = False   # every page of a predicate column excluded


def _count_pages(pf, rg: int, column: str) -> int:
    oi = pf.offset_index(rg, column)
    return len(oi) if oi is not None else 1


def _names(pf, columns) -> List[str]:
    return list(columns or pf.schema.names)


def _pred_names(preds) -> List[str]:
    out: List[str] = []
    for p in preds:
        for c in _pred_columns(p):
            if c not in out:
                out.append(c)
    return out


def decode_row_group(pf, rg: int, columns, preds, *, projection: bool
                     ) -> HostRowGroup:
    """Decode a row group's predicate columns on the host, page-skipped by
    the page index, and with `projection` its other projected columns
    too (else `finish_row_group` decodes them once a row survives)."""
    num_rows = pf.row_groups[rg][3]
    sel = page_selection(pf, rg, preds, num_rows) if preds else None
    h = HostRowGroup(rg, num_rows, sel, {})
    if sel is not None and not sel.selects_any():
        pages = sum(_count_pages(pf, rg, n) for n in _names(pf, columns))
        h.deltas = {"pages_total": pages, "pages_skipped": pages}
        h.skipped = True
        return h
    wanted = _pred_names(preds)
    if projection:
        wanted += [n for n in _names(pf, columns) if n not in wanted]
    for name in wanted:
        h.columns[name] = decode_column(pf, rg, name, sel)
    return h


def decode_column(pf, rg: int, name: str, sel: Optional[RowSelection]
                  ) -> HostColumn:
    """Decode one column chunk on the host, skipping the pages with no
    selected row (page row ranges from the offset index), then keep the
    selected rows; a nested column, or one without an offset index,
    decodes whole."""
    from .parquet_nested import LeafData, is_nested, leaf_count

    fi = pf.schema.index_of(name)
    field = pf.schema.fields[fi]
    start = pf._field_leaf_start[fi]
    num_rows = pf.row_groups[rg][3]
    chunk = pf.row_groups[rg][1][start]
    phys = chunk[3][1]
    if is_nested(field.dtype):
        leaves = []
        for k in range(leaf_count(field.dtype)):
            md, mr, ldt, lnull, ltl = pf._leaf_info[start + k]
            defs, reps, values = pf._read_chunk_levels(
                pf.row_groups[rg][1][start + k], md, mr, tl=ltl, rg_idx=rg,
                col_ord=start + k)
            leaves.append(LeafData(defs, reps, values, ldt, lnull, md))
        return HostColumn(field, phys, num_rows, leaves=leaves,
                          deltas={"rows_decoded": num_rows})
    oi = pf.offset_index(rg, name)
    if sel is None or oi is None:
        data = pf.decode_chunk(rg, start, field.nullable)
        out = HostColumn(field, phys, num_rows, data.values, data.valid,
                         deltas={"pages_total": _count_pages(pf, rg, name),
                                 "rows_decoded": num_rows})
        # a selection, and this column has no offset index: decode all,
        # then drop the unselected rows
        return out if sel is None else _keep_rows(out, sel.to_mask(num_rows))
    keep_pages = _pages_with_selected_rows(oi, sel, num_rows)
    values, valid, rows_dec, nbytes = _decode_pages(pf, chunk, oi,
                                                    keep_pages, field, start)
    out = HostColumn(field, phys, rows_dec, values, valid, deltas={
        "pages_total": len(oi), "pages_skipped": len(oi) - sum(keep_pages),
        "rows_decoded": rows_dec, "bytes_decompressed": nbytes})
    # the decoded rows are those of the kept pages: keep the selected ones
    page_mask = np.zeros(num_rows, bool)
    firsts = [row for (_, _, row) in oi] + [num_rows]
    for k, kept in enumerate(keep_pages):
        if kept:
            page_mask[firsts[k]:firsts[k + 1]] = True
    return _keep_rows(out, sel.to_mask(num_rows)[page_mask])


def _keep_rows(h: HostColumn, mask: np.ndarray) -> HostColumn:
    """`h` with the rows under `mask` to keep: `upload_columns` drops the
    others with the filter on the device."""
    return h if mask.all() else dataclasses.replace(h, keep=mask)


def _pages_with_selected_rows(oi, sel: RowSelection, num_rows: int):
    firsts = [row for (_, _, row) in oi] + [num_rows]
    mask = sel.to_mask(num_rows)
    return [bool(mask[firsts[k]:firsts[k + 1]].any()) for k in range(len(oi))]


def _decode_pages(pf, chunk, oi, keep_pages, field, leaf_start):
    """Decode only the kept data pages (the dictionary page always).
    -> (values per page, valid bools, rows, bytes decompressed)."""
    from . import thrift
    from .parquet import _decompress

    cm = chunk[3]
    phys, codec = cm[1], cm[4]
    tl = pf._leaf_info[leaf_start][4]
    view = pf._view
    nbytes = 0

    def page_at(pos):
        r = thrift.Reader(view, pos)
        hdr = r.read_struct()
        body = _decompress(codec, view[r.pos:r.pos + hdr[3]], hdr[2])
        return hdr, body, r.pos + hdr[3]

    dictionary = None
    dict_off = cm.get(11)
    if dict_off is not None:  # the dictionary page precedes the data pages
        hdr, body, _ = page_at(dict_off)
        nbytes += hdr[2]
        dictionary = pf._decode_dict_page(body, phys, hdr[7][1], tl=tl)
    values, valid_parts = [], []
    rows = 0
    for k, (off, _size, _first) in enumerate(oi):
        if not keep_pages[k]:
            continue
        hdr, body, nxt = page_at(off)
        if hdr[1] == 2:  # a leading dictionary page shares the offset list
            dictionary = pf._decode_dict_page(body, phys, hdr[7][1], tl=tl)
            hdr, body, _ = page_at(nxt)
        nbytes += hdr[2]
        nvals = hdr[5][1]
        vals, defs, _ = pf._decode_data_page(
            body, phys, hdr[5][2], nvals, dictionary,
            1 if field.nullable else 0, 0, tl=tl)
        values.append(vals)
        valid_parts.append(defs == 1 if defs is not None
                           else np.ones(nvals, bool))
        rows += nvals
    valid = (np.concatenate(valid_parts) if valid_parts
             else np.zeros(0, bool))
    return values, valid, rows, nbytes


# ---------------------------------------------------------------------------
# the device half: upload, predicates, filter
# ---------------------------------------------------------------------------


def upload_columns(pf, h: HostRowGroup, names: Sequence[str]) -> dict:
    """The named host columns as columns on the scan's device, each
    column's unselected rows dropped there with the filter."""
    from ..core import column as col
    from ..ops.filter import filter_
    from .parquet import _assemble
    from .parquet_nested import assemble_column

    out = {}
    for name in names:
        c = h.columns[name]
        if c.leaves is not None:
            out[name] = assemble_column(c.field, c.leaves, c.rows, pf.device)
        else:
            out[name] = _assemble(c.values, c.valid, c.phys, c.field.dtype,
                                  c.rows, pf.device)
        if c.keep is not None:
            out[name] = filter_(out[name], col.boolean(
                torch.from_numpy(c.keep), device=pf.device))
    return out


def evaluate_predicates(pf, h: HostRowGroup, preds, cols: dict,
                        m: ScanMetrics) -> np.ndarray:
    """Each predicate evaluated in order on the decoded rows, its mask
    read back once -> the row group's surviving rows (host bools)."""
    from .parquet import equalize

    names = _pred_names(preds)
    base = (h.sel.to_mask(h.num_rows) if h.sel is not None
            else np.ones(h.num_rows, bool))
    rows = np.nonzero(base)[0]
    pb = bt.RecordBatch(
        st.Schema(tuple(pf.schema.fields[pf.schema.index_of(n)]
                        for n in names)),
        equalize([cols[n] for n in names]))
    surviving = base.copy()
    for p in preds:
        mcol = p.evaluate(pb)
        m.predicate_evaluations += 1
        ok = (mcol.valid_bool() & mcol.values_bool())[:len(rows)].cpu()
        inner = np.zeros(h.num_rows, bool)
        inner[rows] = ok.numpy()   # decoded row -> the row group's row
        surviving &= inner
    return surviving


def filter_row_group(pf, h: HostRowGroup, names: Sequence[str], cols: dict,
                     surviving: Optional[np.ndarray]) -> bt.RecordBatch:
    """The projected columns as a batch, compacted to the surviving rows
    by the engine's filter on the device (None: no predicate, no filter)."""
    from ..core import column as ccol
    from ..ops import filter as flt
    from .parquet import equalize

    batch = bt.RecordBatch(
        st.Schema(tuple(pf.schema.fields[pf.schema.index_of(n)]
                        for n in names)),
        equalize([cols[n] for n in names]))
    if surviving is None:
        return batch
    fine = surviving[h.sel.to_mask(h.num_rows)] if h.sel is not None \
        else surviving
    mask = np.zeros(batch.columns[0].capacity, bool)
    mask[:fine.size] = fine
    return flt.filter_record_batch(batch, ccol.boolean(mask,
                                                       device=pf.device))


def finish_row_group(pf, h: HostRowGroup, columns, preds, m: ScanMetrics
                     ) -> Optional[bt.RecordBatch]:
    """A decoded row group through its device half: upload, predicates,
    filter; the projection's metrics count only once a row survives, as
    the JAX scan decodes it only then.  -> the batch, or None when no row
    survives."""
    m.add(h.deltas)
    if h.skipped:
        return None
    pred_names = _pred_names(preds)
    for name in pred_names:
        m.add(h.columns[name].deltas)
    cols = upload_columns(pf, h, pred_names)
    surviving = None
    if preds:
        surviving = evaluate_predicates(pf, h, preds, cols, m)
        m.rows_matched += int(surviving.sum())
        if not surviving.any():
            return None
    names = _names(pf, columns)
    rest = [n for n in names if n not in cols]
    for name in rest:
        if name not in h.columns:
            h.columns[name] = decode_column(pf, h.rg, name, h.sel)
        m.add(h.columns[name].deltas)
    cols.update(upload_columns(pf, h, rest))
    return filter_row_group(pf, h, names, cols, surviving)


# ---------------------------------------------------------------------------
# selective scan
# ---------------------------------------------------------------------------


def _open(source, device):
    from .parquet import ParquetFile

    return source if isinstance(source, ParquetFile) else ParquetFile(
        source, device=device)


def _plan(pf, preds, metrics):
    m = metrics if metrics is not None else ScanMetrics()
    m.row_groups_total = len(pf.row_groups)
    keep = (prune_row_groups(pf, preds, m) if preds
            else list(range(len(pf.row_groups))))
    return m, keep


def scan_parquet(source, columns: Optional[List[str]] = None, *,
                 predicates: Sequence[object] = (),
                 metrics: Optional[ScanMetrics] = None, device=None):
    """Read with pushdown: row-group pruning (statistics + bloom), page
    pruning (column / offset index), page-skipping decode, predicates on
    the device and a final device filter.  `source` is a ParquetFile or
    what one takes (its columns land on `device`, None: the card).
    -> (RecordBatch, ScanMetrics)."""
    pf = _open(source, device)
    preds = list(predicates)
    m, keep_rgs = _plan(pf, preds, metrics)
    out_batches = []
    for rg in keep_rgs:
        h = decode_row_group(pf, rg, columns, preds, projection=False)
        b = finish_row_group(pf, h, columns, preds, m)
        if b is not None:
            out_batches.append(b)
    if not out_batches:
        from ..core import column as ccol

        fields = tuple(pf.schema.fields[pf.schema.index_of(n)]
                       for n in _names(pf, columns))
        return bt.RecordBatch(st.Schema(fields), tuple(
            ccol.from_pylist([], f.dtype, pf.device) for f in fields)), m
    if len(out_batches) == 1:
        return out_batches[0], m
    from ..ops.concat import concat_batches

    return concat_batches(out_batches), m


# ---------------------------------------------------------------------------
# IO / compute overlap (reference async_reader/mod.rs:704-868 prefetch
# state machine)
# ---------------------------------------------------------------------------


def scan_batches_overlapped(source, columns: Optional[List[str]] = None, *,
                            predicates: Sequence[object] = (),
                            metrics: Optional[ScanMetrics] = None,
                            prefetch: int = 2, device=None):
    """An iterator of per-row-group RecordBatches: row groups N+1 ..
    N+prefetch decode on a producer thread (host work only: framing,
    decompression, level and value decode) while the caller's thread
    uploads, evaluates and filters row group N on the device.  Abandoning
    the iterator stops the producer and joins it."""
    import queue
    import threading

    pf = _open(source, device)
    preds = list(predicates)
    m, keep_rgs = _plan(pf, preds, metrics)

    q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        """A bounded put that gives up once the consumer has gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for rg in keep_rgs:
                if stop.is_set() or not put(decode_row_group(
                        pf, rg, columns, preds, projection=True)):
                    return
            put(end)
        except BaseException as e:  # handed to the consumer
            put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, BaseException):
                raise item
            b = finish_row_group(pf, item, columns, preds, m)
            if b is not None:
                yield b
    finally:
        # done or abandoned (GeneratorExit lands here): release the
        # producer, drain what is in flight, and join it
        stop.set()
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join()
