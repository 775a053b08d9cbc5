"""arrowtpu_torch's geospatial statistics (formats/geospatial.py) and the
Parquet GEOMETRY / GEOGRAPHY columns of its writer and reader, against
the JAX package's on the same numpy-made WKB values.

Tolerance: exact.  The bounder's intervals, the wraparound box and the
type set of every case, `compute_statistics`, the thrift bytes of a
GeospatialStatistics and its parse equal the JAX package's; a GEOMETRY
or GEOGRAPHY column written by the port's Parquet writer has the JAX
writer's bytes, and each package reads the other's annotation and
statistics (and pyarrow the values).
"""

import dataclasses
import io
import struct

import numpy as np
import pyarrow.parquet as pq
import pytest

from arrowtpu import schema as js
from arrowtpu.core import batch as jbt
from arrowtpu.core import column as jcol
from arrowtpu.formats import geospatial as jgeo
from arrowtpu.formats import parquet as jpq
from arrowtpu.formats import thrift as jthrift

from arrowtpu_torch import schema as ps
from arrowtpu_torch.core import batch as pbt
from arrowtpu_torch.core import column as pcol
from arrowtpu_torch.formats import geospatial as pgeo
from arrowtpu_torch.formats import parquet as ppq
from arrowtpu_torch.formats import thrift as pthrift
from torch_parity import assert_batch_equal, release_jax_caches  # noqa: F401


def point(x, y, z=None, m=None, big=False):
    e = ">" if big else "<"
    coords = [x, y] + [v for v in (z, m) if v is not None]
    code = 1 + (1000 if z is not None else 0) + (2000 if m is not None
                                                  else 0)
    return (b"\x00" if big else b"\x01") + struct.pack(
        f"{e}I{len(coords)}d", code, *coords)


def linestring(pts, big=False):
    e = ">" if big else "<"
    return (b"\x00" if big else b"\x01") + struct.pack(
        f"{e}II{2 * len(pts)}d", 2, len(pts), *np.ravel(pts))


def polygon(rings):
    out = b"\x01" + struct.pack("<II", 3, len(rings))
    for ring in rings:
        out += struct.pack(f"<I{2 * len(ring)}d", len(ring), *np.ravel(ring))
    return out


def multi(code, parts):
    return b"\x01" + struct.pack("<II", code, len(parts)) + b"".join(parts)


def ewkb_point_z(x, y, z, srid=4326):
    return b"\x01" + struct.pack("<IIddd", 1 | 0x80000000 | 0x20000000,
                                 srid, x, y, z)


def _values(seed, n=300):
    """WKB of every geometry class and both byte orders, with nulls."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x, y = rng.uniform(-180, 180), rng.uniform(-90, 90)
        pts = rng.uniform(-50, 50, (int(rng.integers(1, 5)), 2)) + (x, y)
        out.append([
            None, point(x, y), point(x, y, z=rng.normal(), big=True),
            point(x, y, m=rng.normal()), linestring(pts, big=i % 2 == 1),
            polygon([pts.tolist() + [pts[0].tolist()]]),
            multi(4, [point(*p) for p in pts]),
            multi(7, [point(x, y), linestring(pts)]),
            ewkb_point_z(x, y, rng.normal())][i % 9])
    return out


CASES = {
    "mixed": lambda: _values(0),
    "antimeridian": lambda: [point(179.0, 0.0), point(-179.5, 1.0),
                             linestring([(178.0, 2.0), (179.9, 3.0)])],
    "cartesian tighter": lambda: [point(-10.0, 0.0), point(20.0, 0.0)],
    "all null": lambda: [None, None],
    "truncated": lambda: [point(1.0, 2.0), point(3.0, 4.0)[:-3]],
}


def _as_dict(stats):
    return None if stats is None else dataclasses.asdict(stats)


@pytest.mark.parametrize("case", sorted(CASES))
def test_statistics_equal_jax(case):
    values = CASES[case]()
    for hint in (True, False):
        assert _as_dict(pgeo.compute_statistics(values, hint)) == \
            _as_dict(jgeo.compute_statistics(values, hint))
    bounders = [m.GeometryBounder((-180.0, 180.0)) for m in (jgeo, pgeo)]
    for v in values:
        if v is None:
            continue
        got = []
        for b in bounders:
            try:
                b.update_wkb(v)
                got.append(None)
            except Exception as e:  # the truncated case: both raise
                got.append(type(e).__name__)
        assert got[0] == got[1]
    j, p = bounders
    assert p.x() == j.x() and p.types_sorted() == j.types_sorted()
    for name in ("x_left", "x_mid", "x_right", "y", "z", "m"):
        assert dataclasses.astuple(getattr(p, name)) == \
            dataclasses.astuple(getattr(j, name)), name


def test_thrift_bytes_and_parse_equal():
    for case in ("mixed", "antimeridian", "all null"):
        values = CASES[case]()
        jw, pw = jthrift.Writer(), pthrift.Writer()
        jgeo.write_geo_stats_thrift(jw, jgeo.compute_statistics(values))
        pgeo.write_geo_stats_thrift(pw, pgeo.compute_statistics(values))
        assert pw.bytes() == jw.bytes(), case
        parsed = pthrift.Reader(pw.bytes()).read_struct()
        assert _as_dict(pgeo.parse_geo_stats(parsed)) == _as_dict(
            jgeo.compute_statistics(values)), case
    wrapped = {1: {1: 179.0, 2: -179.5, 3: 0.0, 4: 3.0}}
    plain = {1: {1: 100.0, 2: 120.0, 3: 10.0, 4: 20.0}}
    for window in ((90, 110, 0, 30), (179.5, 180, -1, 4), (-10, 10, -1, 1),
                   (90, 110, 40, 50), (-180, -179.6, 0, 1)):
        for d in (wrapped, plain):
            assert pgeo.bbox_might_intersect(pgeo.parse_geo_stats(d),
                                             *window) == \
                jgeo.bbox_might_intersect(jgeo.parse_geo_stats(d), *window)


def _files(values, geography=False, crs=None):
    jf = jgeo.geometry_field("g", crs=crs, geography=geography)
    pf = pgeo.geometry_field("g", crs=crs, geography=geography)
    n = np.arange(len(values), dtype=np.int64)
    jb = jbt.RecordBatch(js.Schema((jf, js.Field("n", js.int64))), (
        jcol.string_view(values, js.binary), jcol.primitive(n, js.int64)))
    pb = pbt.RecordBatch(ps.Schema((pf, ps.Field("n", ps.int64))), (
        pcol.string_view(values, ps.binary, "cpu"),
        pcol.primitive(n, ps.int64, device="cpu")))
    return jpq.write_parquet(jb), ppq.write_parquet(pb)


@pytest.mark.parametrize("kind", [(False, "OGC:CRS84"), (True, None)],
                         ids=["geometry", "geography"])
def test_parquet_geometry_column_bytes_and_stats(kind):
    geography, crs = kind
    values = CASES["mixed"]()
    jdata, pdata = _files(values, geography, crs)
    assert pdata == jdata
    want = jgeo.compute_statistics(values)
    for data in (jdata, pdata):
        pf = ppq.ParquetFile(data, device="cpu")
        jf = jpq.ParquetFile(data)
        assert pgeo.geo_annotation(pf.schema.fields[0]) == \
            jgeo.geo_annotation(jf.schema.fields[0]) == (
                "geography" if geography else "geometry", crs)
        assert _as_dict(pf.geo_statistics(0, "g")) == _as_dict(want)
        assert _as_dict(jf.geo_statistics(0, "g")) == _as_dict(want)
        assert pf.geo_statistics(0, "n") is None
        assert_batch_equal(jf.read(), pf.read())
    assert pq.read_table(io.BytesIO(pdata)).column("g").to_pylist() == \
        values


def test_parquet_unparseable_wkb_writes_no_statistics():
    jdata, pdata = _files(CASES["truncated"]())
    assert pdata == jdata
    assert ppq.ParquetFile(pdata, device="cpu").geo_statistics(0, "g") is None
