"""Conversions at the host boundary: numpy, the Arrow C Data Interface
and pyarrow (imported only when a pyarrow function is called)."""

from .pyarrow_bridge import (column_from_pa, column_to_pa, dtype_from_pa,
                             dtype_to_pa, from_pyarrow, schema_from_pa,
                             schema_to_pa, to_pyarrow)

__all__ = ["column_from_pa", "column_to_pa", "dtype_from_pa", "dtype_to_pa",
           "from_pyarrow", "schema_from_pa", "schema_to_pa", "to_pyarrow"]
