"""Compute operators on columns and record batches."""

from .boolean import and_kleene
from .cmp import distinct, eq, gt, gt_eq, lt, lt_eq, neq, not_distinct
from .concat import concat, concat_batches
from .filter import apply_plan, build_plan, filter_, filter_record_batch
from .groupby import group_by
from .join import hash_join
from .numeric import rem
from . import sort as sortmod
from .sort import (lexsort_to_indices, partition, partition_ranges, rank,
                   sort, sort_batch, sort_to_indices)
from .take import take, take_record_batch

__all__ = ["and_kleene", "distinct", "eq", "gt", "gt_eq", "lt", "lt_eq",
           "neq", "not_distinct", "concat", "concat_batches",
           "apply_plan", "build_plan", "filter_", "filter_record_batch",
           "group_by", "hash_join", "rem", "take", "take_record_batch",
           "lexsort_to_indices", "partition", "partition_ranges", "rank",
           "sort", "sort_batch", "sort_to_indices", "sortmod"]
