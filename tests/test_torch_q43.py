"""ClickBench's query 43 over `hits` in primary-key order
(`arrowtpu_torch.entry`: `example_hits_pk_arrays`, `hits_pk_batch`,
`q43_step`) on the CPU at 20,000 rows, against numpy and the JAX package.

  * the draw: its sha256 at this size, the primary-key order, the Moscow
    dates (EventDate is the date of EventTime at MSK's +4 h of 2013);
  * `hits_pk_batch`'s encodes: the runs equal numpy's boundaries and the
    JAX package's `run_end_encode` of the same columns (one `jax.jit`),
    and decode back bit for bit; `take_run` equal to numpy's gather;
  * the invariant: date_part year, month and day of EventTime under
    Europe/Moscow equal those of EventDate on every row;
  * the WHERE computed on the runs equal to the same predicates on the
    decoded columns, and the minute key equal to the JAX package's
    date_part(second) of the kept rows (eager, its zone loop unjitted);
  * the query against `q43_oracle` at the published OFFSET 1000 LIMIT 10
    (empty at this size: fewer than 1,010 minutes) and at offsets that
    reach rows, all groups included.  The group-by on a Timestamp key is
    held to the JAX package by tests/test_torch_temporal_groupby.py.

Tolerance: exact.
"""

import functools
import hashlib

import numpy as np
import pytest

import arrowtpu.schema as js
from arrowtpu.core import column as jcol
from arrowtpu.ops import ree as jree
from arrowtpu.ops import temporal as jt

import torch_parity as tp
from torch_parity import release_jax_caches  # noqa: F401
from arrowtpu_torch import entry as pe
from arrowtpu_torch import ops as pops
from arrowtpu_torch.core import column as pcol
import arrowtpu_torch.schema as ps

ROWS = 20_000
DIGEST = "f961cf3f0183260960f3746786664928c1f65d4a3192151484913bcbe561e0dc"


@functools.lru_cache(maxsize=None)
def _data():
    arrays = pe.example_hits_pk_arrays(ROWS)
    return arrays, pe.hits_pk_batch(arrays, device="cpu")


def test_draw_digest_order_and_dates():
    a, _ = _data()
    h = hashlib.sha256()
    for k in pe.HITS_PK_COLUMNS:
        h.update(np.ascontiguousarray(a[k]).tobytes())
    assert h.hexdigest() == DIGEST
    key = a["CounterID"].astype(np.int64) << 32 | a["EventDate"]
    assert (np.diff(key) >= 0).all()
    assert ((a["EventTime"] + pe.MSK_2013_OFFSET_S) // 86_400
            == a["EventDate"]).all()
    assert np.bincount(a["CounterID"]).argmax() == pe.HITS_TOP_COUNTER
    assert [str(f.dtype) for f in _data()[1].schema.fields] == [
        "run_end_encoded<int32,uint32>", "run_end_encoded<int32,date32>",
        "timestamp[s,Europe/Moscow]", "uint8", "uint8"]


@functools.lru_cache(maxsize=None)
def _jax_runs():
    a, _ = _data()
    cols = (jcol.primitive(a["CounterID"], js.uint32),
            jcol.primitive(a["EventDate"], js.Date32()))
    out = tp.jit(lambda cs: [jree.run_end_encode(c) for c in cs])(cols)
    return {name: (np.asarray(r.run_ends), np.asarray(r.values.values),
                   int(r.values.length))
            for name, r in zip(pe.HITS_RUN_COLUMNS, out)}


@pytest.mark.parametrize("name", pe.HITS_RUN_COLUMNS)
def test_encodes_match_numpy_and_jax(name):
    a, b = _data()
    r = b[name]
    x = a[name]
    starts = np.flatnonzero(np.diff(x)) + 1
    ends = np.append(starts, len(x))
    assert r.n_runs == len(ends)
    np.testing.assert_array_equal(r.run_ends[:r.n_runs].numpy(), ends)
    np.testing.assert_array_equal(
        pcol.Column.valid_bool(r.values)[:r.n_runs].numpy(), True)
    np.testing.assert_array_equal(
        tp.pt.column_to_numpy(r.values)[0], x[np.append(0, starts)])
    j_ends, j_values, j_runs = _jax_runs()[name]
    assert j_runs == r.n_runs
    np.testing.assert_array_equal(j_ends[:j_runs], ends)
    np.testing.assert_array_equal(j_values[:j_runs].view(x.dtype),
                                  x[np.append(0, starts)])
    back = pops.run_end_decode_to(r, b["EventTime"].capacity)
    np.testing.assert_array_equal(tp.pt.column_to_numpy(back)[0], x)
    assert tp.pt.column_to_numpy(back)[1].all()
    idx = np.random.default_rng(1).integers(0, ROWS, 3000)
    ok = np.random.default_rng(2).random(3000) > 0.01
    got = pops.take_run(r, pcol.primitive(idx, ps.int64, validity=ok,
                                          device="cpu"))
    vals, valid, _ = tp.pt.column_to_numpy(got)
    np.testing.assert_array_equal(valid, ok)
    np.testing.assert_array_equal(vals[ok], x[idx[ok]])


def test_moscow_dates_of_event_time_are_event_date():
    _, b = _data()
    t = b["EventTime"]
    d = pops.run_end_decode_to(b["EventDate"], t.capacity)
    for part in ("year", "month", "day"):
        assert pops.date_part(t, part).to_pylist() == \
            pops.date_part(d, part).to_pylist(), part


def test_run_predicates_equal_the_decoded_predicates():
    a, b = _data()
    lo, hi = (pe._days(d) for d in pe.Q43_DAYS)
    want = ((a["CounterID"] == pe.HITS_TOP_COUNTER)
            & (a["EventDate"] >= lo) & (a["EventDate"] <= hi)
            & (a["IsRefresh"] == 0) & (a["DontCountHits"] == 0))
    mask = pe.q43_mask(b)
    assert mask.length == ROWS and want.sum() > 100
    np.testing.assert_array_equal(tp.pt.column_to_numpy(mask)[0], want)


def test_minute_key_matches_jax():
    _, b = _data()
    kept = pops.filter_(b["EventTime"], pe.q43_mask(b))
    n = kept.length
    jc = jcol.primitive(kept.values[:n].numpy(),
                        js.Timestamp("s", pe.HITS_TZ))
    second = np.asarray(jt.date_part(jc, "second").values)[:n]
    got = pe.minute_trunc(kept)
    np.testing.assert_array_equal(got.values[:n].numpy(),
                                  kept.values[:n].numpy() - second)
    assert got.dtype == kept.dtype


@pytest.mark.parametrize("offset,limit", [(pe.Q43_OFFSET, pe.Q43_LIMIT),
                                          (0, 10), (40, 10), (0, 10**6)])
def test_q43_against_oracle(offset, limit):
    a, b = _data()
    got = pe.check_q43(pe.q43_step(b, offset, limit),
                       pe.q43_oracle(a, offset, limit))
    assert len(got) == min(limit, max(len(pe.q43_oracle(a, 0, 10**6))
                                      - offset, 0))
    out = pe.q43_result(b, offset, limit)
    assert out.schema.names == ["M", "PageViews"]
    assert str(out["M"].dtype) == "timestamp[s,Europe/Moscow]"


def test_zone_offsets_must_be_whole_minutes():
    t = pcol.primitive(np.array([-2_000_000_000, 0], np.int64),
                       ps.Timestamp("s", "Europe/Moscow"), device="cpu")
    with pytest.raises(ps.ComputeError):  # LMT +2:30:17 before 1880
        pe.minute_trunc(pcol.primitive(np.array([-3_000_000_000], np.int64),
                                       t.dtype, device="cpu"))
    assert pe.minute_trunc(pcol.primitive(
        np.array([1_373_792_461], np.int64), t.dtype,
        device="cpu")).to_pylist() == [1_373_792_460]
