"""Helpers for the parity tests that hold arrowtpu_torch against arrowtpu.

Both packages get the same numpy arrays; results cross back as numpy
(values, valid bools, length), so neither package's physical layout (the
JAX sublane-major bitmaps and u32 limb pairs, the port's LSB bitmaps and
native int64) enters a comparison.  Every comparison here is exact: the
port has no floating-point arithmetic except the mean, whose int64 sum
and count are exact and whose one division rounds the same way in both.
Float64 and uint64 columns cross as values (the JAX package's (capacity,
2) u32 limb pairs joined by `wide.join_numpy`; the port's uint64 bits read
as numpy uint64), float16 as numpy float16; a test that must tell -0.0
from +0.0, or one NaN payload from another, compares their bits
(`bits_of`).
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

# The references run on a few thousand rows, so LLVM's optimizations cost
# more compile time than they save (XLA's HLO passes still run): about a
# fifth less CPU time for the skew cases' mesh programs.
REFERENCE_COMPILER_OPTIONS = {"xla_backend_optimization_level": 0}

_NP = {"int8": np.int8, "int16": np.int16, "int32": np.int32,
       "int64": np.int64, "uint8": np.uint8, "uint16": np.uint16,
       "uint32": np.uint32, "uint64": np.uint64, "float16": np.float16,
       "float32": np.float32, "float64": np.float64}


def jit(fn=None, **kw):
    """`jax.jit` with REFERENCE_COMPILER_OPTIONS, for the JAX references
    (as a decorator too, bare or under functools.partial)."""
    import jax

    if fn is None:
        return lambda f: jit(f, **kw)
    return jax.jit(fn, compiler_options=REFERENCE_COMPILER_OPTIONS, **kw)


def jax_column(values, valid, dtype_name):
    """A JAX-package column from numpy values and valid bools (or None)."""
    n = len(values)
    validity = None if valid is None else jbm.from_numpy_bools(valid)
    if dtype_name == "bool":
        return at.boolean(np.asarray(values, bool), validity=validity)
    dt = getattr(at.schema, dtype_name)
    return at.primitive(np.asarray(values, _NP[dtype_name]), dt,
                        validity=validity, length=n)


def bits_of(values):
    """A float array's bits as unsigned integers of its width (other
    arrays as they are), for comparisons that tell -0.0 from +0.0."""
    values = np.asarray(values)
    if values.dtype.kind == "f":
        return values.view(f"u{values.dtype.itemsize}")
    return values


def port_column(values, valid, dtype_name):
    dt = pt.schema.bool_ if dtype_name == "bool" else getattr(pt.schema,
                                                              dtype_name)
    return pt.column_from_numpy(values, valid, len(values), dt, device="cpu")


def jax_to_numpy(c, rows=None):
    """-> (values[:length], valid bools[:length], length); `rows`, when
    given, takes that many rows in place of the length.  Decimals,
    intervals and fixed-size binary: (n, W) uint32 words."""
    n = int(c.length) if rows is None else rows
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
    """Port column: value and validity bits past the length are 0 (a
    nested column's own arrays and its children's, recursively)."""
    from arrowtpu_torch.core import column as pcol

    n = c.length
    if isinstance(c, pt.NullColumn):
        return
    if isinstance(c, pcol.DictionaryColumn):
        return assert_zero_padding(c.keys)
    if isinstance(c, pt.BooleanColumn):
        assert not pbm.unpack(c.values)[n:].any(), "value bits past length"
    elif isinstance(c, pcol.StringViewColumn):
        assert not c.views[n:].any(), "views past length are not zero"
    elif isinstance(c, pcol.ListViewColumn):
        assert not c.starts[n:].any() and not c.sizes[n:].any()
    elif isinstance(c, pcol.StructColumn):
        for ch in c.children:
            assert ch.length == n
            assert_zero_padding(ch)
    elif isinstance(c, pcol.FixedSizeListColumn):
        assert c.child.length == n * c.dtype.size
        assert_zero_padding(c.child)
    else:
        assert not c.values[n:].any(), "values past length are not zero"
    if c.validity is not None:
        assert not pbm.unpack(c.validity)[n:].any(), "validity past length"


def _valid_rows(c, n, pkg):
    bits = c.validity
    if bits is None:
        return np.ones(n, bool)
    return (jbm if pkg == "jax" else pbm).to_numpy_bools(bits, n)


def assert_column_equal(jc, pc, where="", rows=None, layout=True):
    """Exact: length, dtype, validity as bools, values at every row below
    the length (values under nulls included), zero padding.  Nested
    classes compare recursively: string views by their words (a long
    string's arena offset aside) and their strings, dictionaries by keys
    and values, list views by (start, size) and child, structs by child,
    fixed-size lists by the child's first length * size rows.  `rows`
    compares that many rows in place of the lengths; `layout=False` skips
    what depends on child or arena capacities (a concat's list-view starts
    and child), comparing the rows' Python values instead."""
    from arrowtpu.core import column as jc_
    from arrowtpu_torch.core import column as pcol

    jn = int(jc.length) if rows is None else rows
    pn = pc.length if rows is None else rows
    assert jn == pn, f"{where}: length {pn} != {jn}"
    assert str(jc.dtype) == str(pc.dtype), f"{where}: dtype"
    assert type(jc).__name__ == type(pc).__name__, f"{where}: class"
    if rows is None:
        assert_zero_padding(pc)
    if isinstance(pc, pcol.DictionaryColumn):
        assert_column_equal(jc.keys, pc.keys, f"{where}.keys", rows)
        assert_column_equal(jc.values, pc.values, f"{where}.values")
        return
    if not isinstance(pc, (pcol.StringViewColumn, pcol.ListViewColumn,
                           pcol.StructColumn, pcol.FixedSizeListColumn)):
        jv, jok, _ = jax_to_numpy(jc, rows)
        pv, pok, _ = pt.column_to_numpy(pc)
        if rows is not None:
            pv, pok = pv[:rows], pok[:rows]
        np.testing.assert_array_equal(pok, jok, err_msg=f"{where}: validity")
        np.testing.assert_array_equal(pv, jv, err_msg=f"{where}: values")
        return
    n = jn
    np.testing.assert_array_equal(_valid_rows(pc, n, "port"),
                                  _valid_rows(jc, n, "jax"),
                                  err_msg=f"{where}: validity")
    if isinstance(pc, pcol.StringViewColumn):
        jv = np.asarray(jc.views)[:n].view(np.int32)
        pv = pc.views[:n].numpy()
        np.testing.assert_array_equal(pv[:, :3], jv[:, :3],
                                      err_msg=f"{where}: views")
        inline = pv[:, 0] <= 12
        np.testing.assert_array_equal(pv[inline, 3], jv[inline, 3],
                                      err_msg=f"{where}: inline views")
        assert pc.to_pylist()[:n] == jc.to_pylist()[:n], f"{where}: strings"
        assert pc.len_bound == jc.len_bound, f"{where}: len_bound"
    elif isinstance(pc, pcol.ListViewColumn):
        np.testing.assert_array_equal(pc.sizes[:n].numpy(),
                                      np.asarray(jc.sizes)[:n],
                                      err_msg=f"{where}: sizes")
        if layout:
            np.testing.assert_array_equal(pc.starts[:n].numpy(),
                                          np.asarray(jc.starts)[:n],
                                          err_msg=f"{where}: starts")
            assert_column_equal(jc.child, pc.child, f"{where}.child")
        else:
            assert pc.to_pylist()[:n] == jc.to_pylist()[:n], f"{where}: rows"
    elif isinstance(pc, pcol.StructColumn):
        for f, jch, pch in zip(pc.dtype.fields, jc.children, pc.children):
            assert_column_equal(jch, pch, f"{where}.{f.name}", rows)
    else:
        size = pc.dtype.size
        assert_column_equal(jc.child, pc.child, f"{where}.child", n * size)


def assert_batch_equal(jb, pb):
    assert [f.name for f in jb.schema.fields] == pb.schema.names
    for f in jb.schema.fields:
        assert_column_equal(jb[f.name], pb[f.name], f.name)
