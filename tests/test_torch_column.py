"""arrowtpu_torch's bitmaps, columns and numpy bridge: LSB bitmaps against
numpy's packbits, and columns against the JAX package's `to_pylist` and
`null_count` on the same numpy inputs.  Tolerance: exact."""

import numpy as np
import pytest
import torch

import torch_parity as tp
from torch_parity import release_jax_caches  # noqa: F401
import arrowtpu_torch as pt
from arrowtpu_torch.core import bitmap as bm


@pytest.mark.parametrize("n", [8, 64, 1000 * 8])
def test_bitmap_is_arrow_lsb(n):
    rng = np.random.default_rng(n)
    bools = rng.random(n) < 0.4
    packed = bm.pack(torch.from_numpy(bools))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.packbits(bools, bitorder="little"))
    np.testing.assert_array_equal(bm.unpack(packed).numpy(), bools)
    assert int(bm.count_set_bits(packed)) == int(bools.sum())
    np.testing.assert_array_equal(bm.to_numpy_bools(packed, n), bools)


def test_row_mask_and_clip():
    mask = bm.row_mask(64, 13, "cpu")
    np.testing.assert_array_equal(bm.unpack(mask).numpy(), np.arange(64) < 13)
    full = bm.all_valid(64, "cpu")
    assert torch.equal(bm.clip(full, 13), mask)
    assert bm.clip(full, 64) is full


@pytest.mark.parametrize("dtype", ["int64", "int32", "uint8", "bool"])
@pytest.mark.parametrize("nulls", [0.0, 0.3])
def test_to_pylist_and_null_count_match_jax(dtype, nulls):
    rng = np.random.default_rng(1)
    n = 300
    vals = rng.integers(0, 100, n) if dtype != "bool" else rng.random(n) < 0.5
    valid = rng.random(n) > nulls if nulls else None
    jc = tp.jax_column(vals, valid, dtype)
    pc = tp.port_column(vals, valid, dtype)
    assert pc.to_pylist() == jc.to_pylist()
    assert pc.null_count() == int(jc.null_count())
    assert pc.capacity == 320  # the port's granule: 64 rows
    tp.assert_column_equal(jc, pc, dtype)


def test_primitive_zeroes_rows_past_length():
    vals = torch.arange(1, 101, dtype=torch.int64)
    c = pt.primitive(vals, validity=torch.ones(100, dtype=torch.bool),
                     length=40)
    assert c.length == 40 and c.capacity == 128
    assert c.to_pylist() == list(range(1, 41))
    tp.assert_zero_padding(c)
    with pytest.raises(pt.schema.InvalidArgumentError):
        pt.primitive(vals, length=101)


def test_numpy_bridge_round_trip():
    rng = np.random.default_rng(2)
    vals = rng.integers(-5, 5, 77)
    valid = rng.random(77) > 0.2
    c = pt.column_from_numpy(vals, valid, device="cpu")
    got_vals, got_valid, n = pt.column_to_numpy(c)
    assert n == 77 and str(c.dtype) == "int64"
    np.testing.assert_array_equal(got_vals, vals)
    np.testing.assert_array_equal(got_valid, valid)
    batch = pt.batch_from_numpy({"x": (vals, valid), "y": (vals, None)},
                                device="cpu")
    assert batch.schema.names == ["x", "y"] and batch.length == 77
    assert batch["y"].validity is None


def test_null_column():
    c = pt.null_column(70, device="cpu")
    assert c.to_pylist() == [None] * 70 and c.null_count() == 70
    assert c.capacity == 128 and not c.valid_bool().any()


def test_host_data_needs_a_device_or_the_card():
    if torch.cuda.is_available():
        pytest.skip("only meaningful without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.primitive(np.arange(4))
