"""ClickBench's queries 1-8 over a small `hits` on the CPU, against
`entry.clickbench_oracle` (numpy), through the port's entry points
(`example_hits_arrays`, `hits_batch`, `clickbench_step`).

Tolerance: exact, but AVG(UserID) within a relative 1e-12 of the exact
mean (a float64 sum in another order; `entry.check_clickbench`).  The
draw's sha256 at 20,000 rows pins the generator, so that the chip's run
at 99,997,497 rows draws the table this test knows.  No JAX: the JAX
package has no ClickBench path; its ops are held to the port's in
test_torch_u64_f16.py, test_torch_cast.py and test_torch_aggregate.py.
"""

import hashlib

import numpy as np
import pytest

from arrowtpu_torch import entry as pe
from arrowtpu_torch import schema as pst
from torch_parity import release_jax_caches  # noqa: F401

ROWS = 20_000
DRAW_SHA256 = ("4e8352d6b5084097f2aa17020460319b"
               "374a48ead951a651a986919479db524b")


@pytest.fixture(scope="module")
def hits():
    arrays = pe.example_hits_arrays(ROWS)
    return arrays, pe.hits_batch(arrays, device="cpu"), \
        pe.clickbench_oracle(arrays)


def test_the_draw_is_pinned_and_follows_the_laws(hits):
    arrays, batch, _ = hits
    h = hashlib.sha256()
    for n in pe.HITS_COLUMNS:
        h.update(n.encode())
        h.update(np.ascontiguousarray(arrays[n]).tobytes())
    assert h.hexdigest() == DRAW_SHA256
    assert [str(f.dtype) for f in batch.schema.fields] == [
        "uint64", "uint32", "uint16", "uint8", "date32"]
    assert all(batch[n].validity is None for n in pe.HITS_COLUMNS)
    uid = arrays["UserID"]
    assert 0.3 < np.mean(uid >= np.uint64(2**63)) < 0.7
    users = round(ROWS * pe.HITS_USERS / pe.HITS_ROWS)
    assert len(np.unique(uid)) == users
    assert 0.99 < np.mean(arrays["AdvEngineID"] == 0) < 0.999
    assert arrays["ResolutionWidth"].max() <= 2560
    assert np.ptp(arrays["EventDate"]) == pe.HITS_DAYS - 1


@pytest.mark.parametrize("q", sorted(pe.CLICKBENCH_QUERIES))
def test_query_matches_the_oracle(hits, q):
    _, batch, want = hits
    got = pe.clickbench_step(batch, q)
    pe.check_clickbench(got, want[q], q)
    if q in (7, 8):
        assert len(got) == pe.CLICKBENCH_LIMIT


def test_avg_user_id_is_the_correctly_rounded_cast():
    """AVG(UserID) casts each uint64 to float64 by hi * 2**32 + lo (one
    rounding, also above 2**63), so a column of one value averages to
    that value's float64."""
    v = np.full(64, 2**64 - 2**11 - 1, np.uint64)  # rounds up to 2**64
    batch = pe.hits_batch({**{n: np.zeros(64, a.dtype) for n, a in
                              pe.example_hits_arrays(64).items()},
                           "UserID": v}, device="cpu")
    assert pe.clickbench_step(batch, 3) == float(2**64 - 2**11 - 1)
    assert pe.HITS_TYPES["UserID"] == pst.uint64
