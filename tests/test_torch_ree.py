"""Run-end encoding in arrowtpu_torch.ops.ree against arrowtpu.ops.ree on
the same inputs: `run_end_encode` (the runs' ends and values, NaN runs and
null runs included, and the padding run ends), `run_end_decode` /
`run_end_decode_to` and `take_run` (int64 indices with nulls) over int32,
int64, uint32, float64 with NaNs, bool and Date32 columns with nulls.
The JAX side is one `jax.jit` of every case.

String views: the JAX package's encode raises on them (its `distinct`
takes no string column), so the port's string runs are held to the runs
of the Python list (`run_end_from_pylist`).

Tolerance: exact (values under nulls included); the port's run ends and
values have the capacity of the run count rounded up to its granule, the
JAX package's the input's, so rows are compared up to the run count and
each package's padding run ends are held to max(length, 1).
"""

import functools

import numpy as np
import pytest

import arrowtpu.schema as js
from arrowtpu.core import column as jcol
from arrowtpu.ops import ree as jree

import torch_parity as tp
import arrowtpu_torch.schema as ps
from arrowtpu_torch import ops as pops
from arrowtpu_torch.core import column as pcol

N = 200
NAN = float("nan")


def _runs(rng, pool, n=N):
    """n values in runs of 1-6 rows, each run's value drawn from pool."""
    out = []
    while len(out) < n:
        out += [pool[int(rng.integers(len(pool)))]] * int(rng.integers(1, 7))
    return out[:n]


def _cases():
    rng = np.random.default_rng(7)
    return {
        "int32": (js.int32, ps.int32, _runs(rng, [1, 2, None, -5])),
        "int64": (js.int64, ps.int64, _runs(rng, [2**40, -1, None, 3])),
        "uint32": (js.uint32, ps.uint32, _runs(rng, [62, 2**32 - 1, 0])),
        "float64": (js.float64, ps.float64,
                    [1.0, NAN, NAN, None, None, 2.0]
                    + _runs(rng, [NAN, 0.5, None, -0.0, 0.0], N - 6)),
        "bool": (js.boolean, ps.bool_, _runs(rng, [True, False, None])),
        "date32": (js.Date32(), ps.Date32(), _runs(rng, [15900, 15901,
                                                         None])),
    }


CASES = _cases()
IDX = np.random.default_rng(8).integers(0, N, 150)
IDX_VALID = np.random.default_rng(9).random(150) > 0.1
CAP = 256  # the JAX decode's static capacity


@functools.lru_cache(maxsize=None)
def _jax_results():
    """{case: (run_ends, values, decoded, taken)} from one jax.jit."""
    cols = {k: jcol.from_pylist(v, jdt) for k, (jdt, _, v) in CASES.items()}
    idx = tp.jax_column(IDX, IDX_VALID, "int64")

    @tp.jit
    def run(cols, idx):
        out = {}
        for k, c in cols.items():
            r = jree.run_end_encode(c)
            out[k] = (r.run_ends, r.values, jree.run_end_decode_to(r, CAP),
                      jree.take_run(r, idx))
        return out
    return run(cols, idx)


def _port(name):
    _, pdt, v = CASES[name]
    return pcol.from_pylist(v, pdt, device="cpu")


@pytest.mark.parametrize("name", list(CASES))
def test_encode_matches_jax(name):
    ends, values, _, _ = _jax_results()[name]
    r = pops.run_end_encode(_port(name))
    n_runs = r.n_runs
    assert n_runs == int(values.length)
    assert r.length == N and str(r.dtype) == str(
        js.RunEndEncoded(js.int32, CASES[name][0]))
    np.testing.assert_array_equal(r.run_ends[:n_runs].numpy(),
                                  np.asarray(ends)[:n_runs])
    assert (r.run_ends[n_runs:] == N).all()
    assert (np.asarray(ends)[n_runs:] == N).all()
    tp.assert_column_equal(values, r.values, f"{name} values")


@pytest.mark.parametrize("name", list(CASES))
def test_decode_and_take_run_match_jax(name):
    _, _, decoded, taken = _jax_results()[name]
    c = _port(name)
    r = pops.run_end_encode(c)
    tp.assert_column_equal(decoded, pops.run_end_decode(r), f"{name} decode",
                           rows=N)
    back, want = (tp.pt.column_to_numpy(x) for x in (pops.run_end_decode(r),
                                                     c))
    np.testing.assert_array_equal(back[1], want[1])
    np.testing.assert_array_equal(tp.bits_of(back[0])[want[1]],
                                  tp.bits_of(want[0])[want[1]])
    assert pops.run_end_decode_to(r, 512).capacity == 512
    idx = pcol.primitive(IDX, ps.int64, validity=IDX_VALID, device="cpu")
    tp.assert_column_equal(taken, pops.take_run(r, idx), f"{name} take_run")


def test_nan_and_null_runs():
    r = pops.run_end_encode(_port("float64"))
    assert r.run_ends[:4].tolist() == [1, 3, 5, 6]
    assert r.values.to_pylist()[:3] == [1.0, pytest.approx(NAN, nan_ok=True),
                                        None]


@pytest.mark.parametrize("data", [
    ["a", "a", "a long string, past 12 bytes", "a long string, past 12 bytes",
     None, None, "a", "", "", "b"],
    [None] * 5, ["only"], []])
def test_string_runs_held_to_the_python_runs(data):
    c = pcol.from_pylist(data, ps.utf8, device="cpu")
    r = pops.run_end_encode(c)
    want = pcol.run_end_from_pylist(data, ps.utf8, device="cpu")
    assert r.n_runs == want.n_runs
    assert r.run_ends[:r.n_runs].tolist() == want.run_ends[:want.n_runs
                                                           ].tolist()
    assert (r.run_ends[r.n_runs:] == max(len(data), 1)).all()
    assert r.values.to_pylist() == want.values.to_pylist()
    assert pops.run_end_decode(r).to_pylist() == data


def test_empty_column_pads_with_one():
    r = pops.run_end_encode(pcol.from_pylist([], ps.int32, device="cpu"))
    assert r.n_runs == 0 and r.length == 0 and (r.run_ends == 1).all()
    assert pops.run_end_decode(r).length == 0
