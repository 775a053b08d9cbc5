"""arrowtpu_torch: the arrowtpu engine on PyTorch and CUDA (NVIDIA H100).

A port of the JAX package `arrowtpu`, which stays beside it as the
reference the port is held against.  Plain tensor code is PyTorch; the
TPU's Pallas kernels become hand-written CUDA kernels (`kernels/`,
`csrc/`), built with nvcc at first use; the distributed layer
(`parallel/`) runs over torch.distributed.  This package never imports JAX
or `arrowtpu`.  Entry points run on the card unless given `device="cpu"`.
"""

from . import config, entry, ops, parallel, schema
from . import dtype_parse, extension, integration, tensor, variant
from .dtype_parse import parse_datatype
from .tensor import Tensor
from .tensor import tensor as make_tensor
from .core import bitmap
from .core.batch import RecordBatch, record_batch
from .core.column import (BooleanColumn, Column, DictionaryColumn,
                          FixedSizeListColumn, ListViewColumn, NullColumn,
                          PrimitiveColumn, RunEndColumn, StringViewColumn,
                          StructColumn, UnionColumn, boolean, from_pylist,
                          null_column, primitive)
from .interop.numpy_bridge import (batch_from_numpy, column_from_numpy,
                                   column_to_numpy)

__all__ = ["config", "entry", "ops", "parallel", "schema", "bitmap",
           "dtype_parse", "extension", "integration", "tensor", "variant",
           "parse_datatype", "Tensor", "make_tensor",
           "RecordBatch", "record_batch", "BooleanColumn", "Column", "NullColumn",
           "PrimitiveColumn", "boolean", "null_column", "primitive",
           "DictionaryColumn", "FixedSizeListColumn", "ListViewColumn",
           "RunEndColumn", "StringViewColumn", "StructColumn", "UnionColumn",
           "from_pylist",
           "batch_from_numpy", "column_from_numpy", "column_to_numpy"]
