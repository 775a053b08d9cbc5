"""arrowtpu_torch.extension and arrowtpu_torch.tensor against arrowtpu's.

Tolerance: exact.  The cases of tests/test_schema_ext.py for the
extension types (the registry, the canonical types' storage and metadata,
an unknown extension passed through, a plain field) give equal fields and
lookups in both packages (compared through their fields' names, storage
types as text and metadata); a Tensor built from the same numpy array in
both packages (row- and column-major, int32 / float32 / int64 / uint64 /
float64, with names) has the same shape, strides, names, element values and
`to_numpy`; the port's 64-bit values are native (no limb pairs) on the
device asked for.  A FixedShapeTensor column's rows viewed as one Tensor
(`tensor.from_fixed_shape_tensor`) equal numpy's reshape, and with a
permutation numpy's transpose.
"""

import json

import numpy as np
import pytest
import torch

from torch_parity import release_jax_caches  # noqa: F401
from arrowtpu import extension as jext
from arrowtpu import schema as js
from arrowtpu import tensor as jtn

import arrowtpu_torch as pt
from arrowtpu_torch import extension as pext
from arrowtpu_torch import schema as ps
from arrowtpu_torch import tensor as ptn
from arrowtpu_torch.core import column as pcol
from arrowtpu_torch.formats import parquet_nested as pnest


def test_package_exports():
    import arrowtpu as at

    for name in ("extension", "tensor", "Tensor", "make_tensor",
                 "integration", "variant", "dtype_parse", "parse_datatype"):
        assert hasattr(at, name) and hasattr(pt, name), name
    assert pt.Tensor is ptn.Tensor and pt.make_tensor is ptn.tensor
    assert pt.parse_datatype(str(ps.FixedSizeList(ps.float32, 4))) == \
        ps.FixedSizeList(ps.float32, 4)


def _field_text(f):
    return (f.name, str(f.dtype), f.nullable, f.metadata)


def _cases(ext, s):
    return {
        "uuid": ext.Uuid(),
        "json": ext.Json(),
        "json_meta": ext.Json('{"k": 1}'),
        "bool8": ext.Bool8(),
        "opaque": ext.Opaque(s.int64, "vendor.thing", "acme"),
        "fixed_shape": ext.FixedShapeTensor(s.float32, (2, 3)),
        "fixed_shape_perm": ext.FixedShapeTensor(s.int32, (2, 3, 4),
                                                 (2, 0, 1), ("a", "b", "c")),
        "variable_shape": ext.VariableShapeTensor(s.float64, 3),
    }


@pytest.mark.parametrize("name", sorted(_cases(pext, ps)))
def test_extension_fields_and_lookups_equal(name):
    je, pe_ = _cases(jext, js)[name], _cases(pext, ps)[name]
    jf, pf = jext.extension_field("x", je), pext.extension_field("x", pe_)
    assert _field_text(pf) == _field_text(jf)
    jgot, pgot = jext.REGISTRY.lookup(jf), pext.REGISTRY.lookup(pf)
    assert type(pgot).__name__ == type(jgot).__name__
    assert (pgot.name, str(pgot.storage), pgot.metadata) == \
        (jgot.name, str(jgot.storage), jgot.metadata)
    assert pgot == pe_
    if name.startswith("fixed_shape"):
        assert pgot.shape == jgot.shape
    if name == "opaque":
        assert json.loads(pgot.metadata)["vendor_name"] == "acme"


def test_unknown_plain_and_bad_storage():
    for ext, s in ((jext, js), (pext, ps)):
        f = s.Field("x", s.int32, True,
                    ((ext.EXTENSION_NAME_KEY, "com.example.custom"),))
        got = ext.REGISTRY.lookup(f)
        assert got.name == "com.example.custom" and got.storage == s.int32
        assert ext.REGISTRY.lookup(s.Field("x", s.int32)) is None
        bad = s.Field("id", s.FixedSizeBinary(8), True,
                      ((ext.EXTENSION_NAME_KEY, "arrow.uuid"),))
        with pytest.raises(s.SchemaError):
            ext.REGISTRY.lookup(bad)
    # one definition of the key: the Parquet modules take the port's
    assert pnest.EXTENSION_NAME_KEY is pext.EXTENSION_NAME_KEY == \
        jext.EXTENSION_NAME_KEY


ARRAYS = {
    "i32": np.arange(12, dtype=np.int32).reshape(3, 4),
    "f32": np.arange(6, dtype=np.float32).reshape(2, 3) / 3,
    "i64": (np.arange(24, dtype=np.int64) * (1 << 40) - 5).reshape(2, 3, 4),
    "u64": (np.arange(4, dtype=np.uint64) + np.uint64(2**63)).reshape(2, 2),
    "f64": np.linspace(-1, 1, 10).reshape(5, 2),
}


@pytest.mark.parametrize("name", sorted(ARRAYS))
@pytest.mark.parametrize("column_major", [False, True])
def test_tensor_equal(name, column_major):
    a = ARRAYS[name]
    names = tuple(f"d{i}" for i in range(a.ndim))
    jt = jtn.tensor(a, names=names, column_major=column_major)
    ptt = ptn.tensor(a, names=names, column_major=column_major,
                     device="cpu")
    assert str(ptt.dtype) == str(jt.dtype)
    assert (ptt.shape, ptt.strides, ptt.names) == \
        (jt.shape, jt.strides, jt.names)
    assert ptt.is_row_major() == jt.is_row_major()
    assert ptt.is_column_major() == jt.is_column_major()
    assert ptt.dim_name(0) == jt.dim_name(0) == "d0"
    assert ptt.data.dim() == 1 and ptt.data.device.type == "cpu"
    got, want = ptt.to_numpy(), jt.to_numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, a)
    idx = tuple(s - 1 for s in a.shape)
    v = ptt.value(idx).item()
    if name == "u64":
        v = int(np.int64(v).view(np.uint64))
    assert v == a[idx]


def test_tensor_validation_and_device():
    for tn, s in ((jtn, js), (ptn, ps)):
        data = np.zeros(2, np.int32)
        data = data if tn is jtn else torch.from_numpy(data)
        with pytest.raises(s.InvalidArgumentError):
            tn.Tensor(data, s.int32, (3, 3), (3, 1))
    t = pt.make_tensor(np.arange(4, dtype=np.int64), device="cpu")
    assert t.dtype == ps.int64 and t.data.dtype == torch.int64
    with pytest.raises(RuntimeError, match="CUDA"):  # the card by default
        pt.make_tensor(np.arange(4))


@pytest.mark.parametrize("perm", [None, (1, 0)])
def test_fixed_shape_tensor_column_as_tensor(perm):
    rng = np.random.default_rng(5)
    rows = [list(map(float, rng.standard_normal(4).astype(np.float32)))
            for _ in range(37)]
    c = pcol.from_pylist(rows, ps.FixedSizeList(ps.float32, 4), "cpu")
    ext = pext.REGISTRY.lookup(pext.extension_field(
        "t", pext.FixedShapeTensor(ps.float32, (2, 2), perm)))
    t = ptn.from_fixed_shape_tensor(c, ext)
    want = np.asarray(rows, np.float32).reshape(37, 2, 2)
    if perm is not None:
        want = want.transpose(0, 2, 1)
    assert t.shape == (37, 2, 2) and t.data.data_ptr() == \
        c.child.values.data_ptr()
    np.testing.assert_array_equal(t.to_numpy(), want)
    np.testing.assert_array_equal(t.as_strided().numpy(), want)
    with pytest.raises(ps.InvalidArgumentError):
        ptn.from_fixed_shape_tensor(c, pext.FixedShapeTensor(ps.float32,
                                                             (3,)))
