"""Tensor: an n-dimensional dense value container.

Counterpart of `arrowtpu/tensor.py` (arrow-rs arrow/src/tensor.rs: a
buffer with shape, strides and dimension names, row / column-major
predicates).  The buffer is a flat torch tensor on an explicit device;
strides are element strides.  A 64-bit value is native int64 / float64
(uint64 as its int64 bits, as columns hold it), not the JAX package's
(n, 2) u32 limb pairs."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import schema as st
from .config import resolve_device
from .core import column as col


def _row_major_strides(shape) -> Tuple[int, ...]:
    out, acc = [], 1
    for s in reversed(shape):
        out.append(acc)
        acc *= s
    return tuple(reversed(out))


def _col_major_strides(shape) -> Tuple[int, ...]:
    out, acc = [], 1
    for s in shape:
        out.append(acc)
        acc *= s
    return tuple(out)


def _size(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


@dataclasses.dataclass(frozen=True)
class Tensor:
    """arrow-rs tensor.rs Tensor<T>: data + shape + strides + names."""

    data: torch.Tensor  # flat (n,), at least the shape's size
    dtype: st.DataType
    shape: Tuple[int, ...]
    strides: Tuple[int, ...]
    names: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        n = _size(self.shape)
        if self.data.shape[0] < n:
            raise st.InvalidArgumentError(
                f"tensor data has {self.data.shape[0]} elements, shape needs {n}"
            )
        if len(self.strides) != len(self.shape):
            raise st.InvalidArgumentError("strides rank != shape rank")
        if self.names is not None and len(self.names) != len(self.shape):
            raise st.InvalidArgumentError("names rank != shape rank")

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return _size(self.shape)

    def is_contiguous(self) -> bool:
        return self.is_row_major() or self.is_column_major()

    def is_row_major(self) -> bool:
        return self.strides == _row_major_strides(self.shape)

    def is_column_major(self) -> bool:
        return self.strides == _col_major_strides(self.shape)

    def dim_name(self, i: int) -> Optional[str]:
        return self.names[i] if self.names else None

    def value(self, index) -> torch.Tensor:
        flat = sum(i * s for i, s in zip(index, self.strides))
        return self.data[flat]

    def as_strided(self) -> torch.Tensor:
        """The values as a torch view of the shape, on the device (no
        copy)."""
        return self.data.as_strided(self.shape, self.strides)

    def to_numpy(self) -> np.ndarray:
        flat = self.data[: self.size].cpu().numpy()
        if st.is_u64(self.dtype):
            flat = flat.view(np.uint64)
        if self.is_row_major():
            return flat.reshape(self.shape)
        return np.lib.stride_tricks.as_strided(
            flat, self.shape, tuple(s * flat.itemsize for s in self.strides)
        ).copy()


def tensor(values, dtype: st.DataType = None, names=None,
           column_major: bool = False, device=None) -> Tensor:
    """A Tensor from a host array (arrow-rs Tensor::try_new,
    new_row_major / new_column_major) on `device` (None: the card)."""
    arr = np.asarray(values)
    if dtype is None:
        dtype = (st.uint64 if arr.dtype == np.uint64
                 else st.from_torch(torch.from_numpy(arr[:0].copy()).dtype))
    shape = arr.shape
    if column_major:
        flat = arr.flatten(order="F")
        strides = _col_major_strides(shape)
    else:
        flat = arr.ravel()
        strides = _row_major_strides(shape)
    flat = flat.astype(col.numpy_dtype(dtype))
    if st.is_u64(dtype):
        flat = flat.view(np.int64)
    data = torch.from_numpy(np.ascontiguousarray(flat)).to(
        resolve_device(device))
    return Tensor(data, dtype, tuple(shape), strides,
                  tuple(names) if names else None)


def from_fixed_shape_tensor(c: col.FixedSizeListColumn, ext,
                            names=None) -> Tensor:
    """The rows of a `FixedShapeTensor` extension column (storage
    fixed_size_list<T, prod(shape)>) as one Tensor of shape (length,
    *shape) over the child's values, on the column's device, no copy: an
    element's dimensions laid out by the extension's permutation (the
    identity when it has none).  Null rows keep their storage's values."""
    import json as _json

    if c.dtype != ext.storage:
        raise st.InvalidArgumentError(
            f"{ext.NAME} over {ext.storage}, got a {c.dtype} column")
    meta = _json.loads(ext.metadata)
    shape = tuple(int(s) for s in meta["shape"])
    perm = meta.get("permutation") or list(range(len(shape)))
    physical = _row_major_strides([shape[p] for p in perm])
    strides = [0] * len(shape)
    for i, p in enumerate(perm):
        strides[p] = physical[i]
    child = c.child
    if not isinstance(child, col.PrimitiveColumn) or child.values.dim() != 1:
        raise st.InvalidArgumentError(
            f"{ext.NAME}: a tensor of {child.dtype} values is not supported")
    return Tensor(child.values[: c.length * c.dtype.size], child.dtype,
                  (c.length,) + shape, (c.dtype.size,) + tuple(strides),
                  tuple(names) if names else None)
