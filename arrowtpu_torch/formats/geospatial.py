"""Geospatial WKB statistics for Parquet GEOMETRY / GEOGRAPHY columns.

Counterpart of `arrowtpu/formats/geospatial.py`, after arrow-rs's
parquet-geospatial crate (bounding.rs:39 GeometryBounder, interval.rs:152
wraparound intervals) and the parquet crate's GeospatialStatistics
(ColumnMetaData field 17, BoundingBox fields 1-8, thrift/mod.rs:121).

The WKB parser follows the OGC spec: ISO type codes (XYZ +1000, XYM
+2000, XYZM +3000), both byte orders, and EWKB's Z / M / SRID flags.
Coordinates accumulate into x / y / z / m intervals on the host while a
chunk is written: statistics are metadata, not device work.

Wraparound bounding: a chunk whose features sit at the far left and the
far right of [-180, 180] is better described by a box whose xmin > xmax
(crossing the antimeridian).  Each contiguous point sequence's x interval
goes to a left, mid or right bucket against the hint's midpoint; the
box wraps only when nothing crosses the midpoint and the wrapped box is
strictly narrower than the Cartesian union.
"""

from __future__ import annotations

import dataclasses
import math
import struct
from typing import List, Optional, Tuple

from .. import schema as st

# the field metadata keys that carry the annotation
GEO_KEY = "parquet.geospatial"     # "geometry" | "geography"
GEO_CRS_KEY = "parquet.geospatial.crs"

_INF = float("inf")


def geometry_field(name: str, crs: Optional[str] = None,
                   geography: bool = False,
                   nullable: bool = True) -> st.Field:
    """A Binary field annotated as GEOMETRY (or GEOGRAPHY) WKB."""
    md = ((GEO_KEY, "geography" if geography else "geometry"),)
    if crs:
        md += ((GEO_CRS_KEY, crs),)
    return st.Field(name, st.binary, nullable, md)


def geo_annotation(field: st.Field) -> Optional[Tuple[str, Optional[str]]]:
    """(kind, crs) of a field annotated as geospatial, else None."""
    md = dict(field.metadata)
    kind = md.get(GEO_KEY)
    return None if kind is None else (kind, md.get(GEO_CRS_KEY))


# ---------------------------------------------------------------------------
# intervals (interval.rs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Interval:
    lo: float = _INF
    hi: float = -_INF

    def is_empty(self) -> bool:
        return self.lo > self.hi

    def update(self, v: float) -> None:
        if math.isnan(v):
            return
        if v < self.lo:
            self.lo = v
        if v > self.hi:
            self.hi = v

    def merge(self, other: "Interval") -> None:
        if other.is_empty():
            return
        self.update(other.lo)
        self.update(other.hi)

    def contains_interval(self, other: "Interval") -> bool:
        if other.is_empty():
            return True
        return self.lo <= other.lo and other.hi <= self.hi

    @property
    def mid(self) -> float:
        return (self.lo + self.hi) / 2

    @property
    def width(self) -> float:
        return 0.0 if self.is_empty() else self.hi - self.lo


# ---------------------------------------------------------------------------
# WKB parsing
# ---------------------------------------------------------------------------

_EWKB_Z = 0x80000000
_EWKB_M = 0x40000000
_EWKB_SRID = 0x20000000


def _parse_header(buf: bytes, p: int) -> Tuple[int, int, bool, bool, str, int]:
    """-> (iso_type_code, base_type, has_z, has_m, endian, next_pos)."""
    if p >= len(buf):
        raise st.ArrowTpuError("wkb: truncated header")
    order = buf[p]
    if order == 0:
        e = ">"
    elif order == 1:
        e = "<"
    else:
        raise st.ArrowTpuError(f"wkb: bad byte order {order}")
    (raw,) = struct.unpack_from(e + "I", buf, p + 1)
    p += 5
    has_z = bool(raw & _EWKB_Z)
    has_m = bool(raw & _EWKB_M)
    if raw & _EWKB_SRID:
        p += 4  # skip EWKB SRID
    code = raw & 0x0FFFFFFF
    base = code % 1000
    dims = code // 1000
    if dims == 1:
        has_z = True
    elif dims == 2:
        has_m = True
    elif dims == 3:
        has_z = has_m = True
    elif dims != 0:
        raise st.ArrowTpuError(f"wkb: bad geometry type {raw}")
    if not 1 <= base <= 7:
        raise st.ArrowTpuError(f"wkb: unsupported geometry type {base}")
    iso = base + 1000 * ((1 if has_z else 0) + (2 if has_m else 0))
    return iso, base, has_z, has_m, e, p


class GeometryBounder:
    """Accumulates per-value WKB bounds (bounding.rs:39)."""

    def __init__(self, wraparound_hint: Optional[Tuple[float, float]] = None):
        self.x_left = Interval()
        self.x_mid = Interval()
        self.x_right = Interval()
        self.y = Interval()
        self.z = Interval()
        self.m = Interval()
        self.geometry_types: set = set()
        self.hint = (Interval(wraparound_hint[0], wraparound_hint[1])
                     if wraparound_hint else Interval())

    # -- final bounds ------------------------------------------------------
    def x(self) -> Tuple[float, float]:
        """(xmin, xmax); xmin > xmax encodes a wraparound box."""
        out_all = Interval()
        out_all.merge(self.x_left)
        out_all.merge(self.x_mid)
        out_all.merge(self.x_right)
        if (not self.x_mid.is_empty() or self.hint.is_empty()
                or not self.hint.contains_interval(out_all)
                or self.x_left.is_empty() or self.x_right.is_empty()):
            return out_all.lo, out_all.hi
        # true wraparound width: right part up to hint.hi + left part
        # from hint.lo (the wraparound interval is (x_right.lo, x_left.hi))
        wrap_width = ((self.x_left.hi - self.hint.lo)
                      + (self.hint.hi - self.x_right.lo))
        if out_all.width < wrap_width:
            return out_all.lo, out_all.hi
        return self.x_right.lo, self.x_left.hi

    def types_sorted(self) -> List[int]:
        return sorted(self.geometry_types)

    # -- accumulation ------------------------------------------------------
    def update_wkb(self, wkb: bytes) -> None:
        self._geom(bytes(wkb), 0, top=True)

    def _update_x_interval(self, x: Interval) -> None:
        if x.is_empty():
            return
        if self.hint.is_empty():
            self.x_left.merge(x)
        elif x.hi < self.hint.mid:
            self.x_left.merge(x)
        elif x.lo > self.hint.mid:
            self.x_right.merge(x)
        else:
            self.x_mid.merge(x)

    def _points(self, buf: bytes, p: int, n: int, ncoord: int, e: str,
                has_z: bool, has_m: bool) -> int:
        """One contiguous point sequence: per-sequence x interval (the
        bounding.rs visit_intervals granularity), direct y/z/m merges."""
        need = n * ncoord * 8
        if p + need > len(buf):
            raise st.ArrowTpuError("wkb: truncated coordinates")
        vals = struct.unpack_from(e + "d" * (n * ncoord), buf, p)
        xi = Interval()
        for i in range(n):
            c = vals[i * ncoord:(i + 1) * ncoord]
            xi.update(c[0])
            self.y.update(c[1])
            k = 2
            if has_z:
                self.z.update(c[k])
                k += 1
            if has_m:
                self.m.update(c[k])
        self._update_x_interval(xi)
        return p + need

    def _geom(self, buf: bytes, p: int, top: bool = False) -> int:
        iso, base, has_z, has_m, e, p = _parse_header(buf, p)
        if top:
            self.geometry_types.add(iso)
        ncoord = 2 + (1 if has_z else 0) + (1 if has_m else 0)
        if base == 1:  # point (empty point = all-NaN coords)
            return self._points(buf, p, 1, ncoord, e, has_z, has_m)
        if base == 2:  # linestring
            (n,) = struct.unpack_from(e + "I", buf, p)
            return self._points(buf, p + 4, n, ncoord, e, has_z, has_m)
        if base == 3:  # polygon: rings
            (nr,) = struct.unpack_from(e + "I", buf, p)
            p += 4
            for _ in range(nr):
                (n,) = struct.unpack_from(e + "I", buf, p)
                p = self._points(buf, p + 4, n, ncoord, e, has_z, has_m)
            return p
        # multi-* / geometrycollection: nested full WKB values
        (n,) = struct.unpack_from(e + "I", buf, p)
        p += 4
        for _ in range(n):
            p = self._geom(buf, p)
        return p


@dataclasses.dataclass
class BoundingBox:
    """ColumnMetaData geospatial bbox (thrift/mod.rs BoundingBox 1-8)."""

    xmin: float
    xmax: float
    ymin: float
    ymax: float
    zmin: Optional[float] = None
    zmax: Optional[float] = None
    mmin: Optional[float] = None
    mmax: Optional[float] = None


@dataclasses.dataclass
class GeospatialStatistics:
    """thrift GeospatialStatistics: 1: bbox, 2: geospatial_types."""

    bbox: Optional[BoundingBox]
    geospatial_types: Optional[List[int]]


def compute_statistics(values: List[Optional[bytes]],
                       lon_lat_hint: bool = True
                       ) -> Optional[GeospatialStatistics]:
    """Bound a chunk's WKB values (reference column writer's geometry
    statistics accumulation, parquet/src/geospatial/accumulator.rs).
    Unparseable values disable statistics for the chunk (the reference's
    fallback), never fail the write."""
    b = GeometryBounder(wraparound_hint=(-180.0, 180.0)
                        if lon_lat_hint else None)
    saw = False
    try:
        for v in values:
            if v is None:
                continue
            b.update_wkb(v)
            saw = True
    except st.ArrowTpuError:
        return None
    if not saw:
        return GeospatialStatistics(None, [])
    xmin, xmax = b.x()
    if b.y.is_empty():
        bbox = None
    else:
        bbox = BoundingBox(
            xmin, xmax, b.y.lo, b.y.hi,
            None if b.z.is_empty() else b.z.lo,
            None if b.z.is_empty() else b.z.hi,
            None if b.m.is_empty() else b.m.lo,
            None if b.m.is_empty() else b.m.hi)
    return GeospatialStatistics(bbox, b.types_sorted())


# ---------------------------------------------------------------------------
# thrift (de)serialization + pruning
# ---------------------------------------------------------------------------


def write_geo_stats_thrift(w, stats: GeospatialStatistics) -> None:
    """Emit the GeospatialStatistics struct body on thrift writer `w`."""
    from . import thrift

    w.struct_begin()
    if stats.bbox is not None:
        bb = stats.bbox
        w.field_struct(1)
        w.struct_begin()
        w.field_double(1, bb.xmin)
        w.field_double(2, bb.xmax)
        w.field_double(3, bb.ymin)
        w.field_double(4, bb.ymax)
        for fid, v in ((5, bb.zmin), (6, bb.zmax), (7, bb.mmin),
                       (8, bb.mmax)):
            if v is not None:
                w.field_double(fid, v)
        w.struct_end()
    if stats.geospatial_types is not None:
        w.field_list(2, thrift.CT_I32, len(stats.geospatial_types))
        for t in stats.geospatial_types:
            w.elem_i32(t)
    w.struct_end()


def parse_geo_stats(d: dict) -> GeospatialStatistics:
    """Parsed-thrift dict -> GeospatialStatistics."""
    bbox = None
    bb = d.get(1)
    if bb is not None:
        bbox = BoundingBox(bb[1], bb[2], bb[3], bb[4], bb.get(5),
                           bb.get(6), bb.get(7), bb.get(8))
    types = d.get(2)
    return GeospatialStatistics(bbox, list(types) if types is not None
                                else None)


def bbox_might_intersect(stats: GeospatialStatistics,
                         xmin: float, xmax: float,
                         ymin: float, ymax: float) -> bool:
    """Pruning predicate: False means no geometry in the chunk can
    intersect the query window (handles wraparound xmin > xmax)."""
    if stats.bbox is None:
        return True  # no information -> cannot prune
    bb = stats.bbox
    if ymax < bb.ymin or ymin > bb.ymax:
        return False
    if bb.xmin <= bb.xmax:
        return not (xmax < bb.xmin or xmin > bb.xmax)
    # wraparound: chunk covers [xmin_w, 180] U [-180, xmax_w]
    return xmax >= bb.xmin or xmin <= bb.xmax
