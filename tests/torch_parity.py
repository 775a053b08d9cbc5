"""Helpers for the parity tests that hold arrowtpu_torch against arrowtpu.

Both packages get the same numpy arrays; results cross back as numpy
(values, valid bools, length), so neither package's physical layout (the
JAX sublane-major bitmaps and u32 limb pairs, the port's LSB bitmaps and
native int64) enters a comparison.  Every comparison here is exact: the
port has no floating-point arithmetic except the mean, whose int64 sum
and count are exact and whose one division rounds the same way in both.
Float64 columns cross as values (the JAX package's limb pairs joined by
`wide.join_numpy`); a test that must tell -0.0 from +0.0, or one NaN
payload from another, compares their bits.
"""

import numpy as np
import torch

import arrowtpu as at
from arrowtpu.core import bitmap as jbm
from arrowtpu.core import column as jcol
from arrowtpu.core import wide

import arrowtpu_torch as pt
from arrowtpu_torch.core import bitmap as pbm

# The tests run in several worker processes beside JAX's emulated CPU mesh,
# and the port's parity cases are a few thousand rows: one torch thread a
# process keeps the workers from oversubscribing the cores.
TORCH_THREADS = 1
torch.set_num_threads(TORCH_THREADS)

_NP = {"int8": np.int8, "int16": np.int16, "int32": np.int32,
       "int64": np.int64, "uint8": np.uint8, "uint16": np.uint16,
       "uint32": np.uint32, "float32": np.float32, "float64": np.float64}


def jax_column(values, valid, dtype_name):
    """A JAX-package column from numpy values and valid bools (or None)."""
    n = len(values)
    validity = None if valid is None else jbm.from_numpy_bools(valid)
    if dtype_name == "bool":
        return at.boolean(np.asarray(values, bool), validity=validity)
    dt = getattr(at.schema, dtype_name)
    return at.primitive(np.asarray(values, _NP[dtype_name]), dt,
                        validity=validity, length=n)


def port_column(values, valid, dtype_name):
    dt = pt.schema.bool_ if dtype_name == "bool" else getattr(pt.schema,
                                                              dtype_name)
    return pt.column_from_numpy(values, valid, len(values), dt, device="cpu")


def jax_to_numpy(c):
    """-> (values[:length], valid bools[:length], length)."""
    n = int(c.length)
    if isinstance(c, jcol.NullColumn):
        return np.zeros(n, np.int8), np.zeros(n, bool), n
    if isinstance(c, jcol.BooleanColumn):
        vals = jbm.to_numpy_bools(c.values, n)
    elif c.wide is not None:
        npdt = {"i64": np.int64, "u64": np.uint64, "f64": np.float64}[c.wide]
        vals = wide.join_numpy(np.asarray(c.values)[:n], npdt)
    else:
        vals = np.asarray(c.values)[:n]
    valid = (np.ones(n, bool) if c.validity is None
             else jbm.to_numpy_bools(c.validity, n))
    return vals, valid, n


def assert_zero_padding(c):
    """Port column: value and validity bits past the length are 0."""
    n = c.length
    if isinstance(c, pt.NullColumn):
        return
    if isinstance(c, pt.BooleanColumn):
        assert not pbm.unpack(c.values)[n:].any(), "value bits past length"
    else:
        assert not c.values[n:].any(), "values past length are not zero"
    if c.validity is not None:
        assert not pbm.unpack(c.validity)[n:].any(), "validity past length"


def assert_column_equal(jc, pc, where=""):
    """Exact: length, dtype, validity as bools, values at every row below
    the length (values under nulls included), zero padding."""
    jv, jok, jn = jax_to_numpy(jc)
    pv, pok, pn = pt.column_to_numpy(pc)
    assert jn == pn, f"{where}: length {pn} != {jn}"
    assert str(jc.dtype) == str(pc.dtype), f"{where}: dtype"
    np.testing.assert_array_equal(pok, jok, err_msg=f"{where}: validity")
    np.testing.assert_array_equal(pv, jv, err_msg=f"{where}: values")
    assert_zero_padding(pc)


def assert_batch_equal(jb, pb):
    assert [f.name for f in jb.schema.fields] == pb.schema.names
    for f in jb.schema.fields:
        assert_column_equal(jb[f.name], pb[f.name], f.name)
