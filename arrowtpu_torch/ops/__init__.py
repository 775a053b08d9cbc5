"""Compute operators on columns and record batches."""

from . import (aggregate, arity, bitwise, boolean, coalesce, equal, merge,
               numeric, strings, zip as zipmod)
from . import cast as castmod, dictionary as dictmod, union as unionmod
from . import ree, temporal
from .aggregate import (bool_and, bool_or, count, finalize, max_, min_,
                        product, sum_)
from .cast import can_cast_types, cast, dictionary_decode, dictionary_encode
from .dictionary import (garbage_collect_dictionary, merge_dictionary_values,
                         should_merge_dictionary_values)
from .union import take_union, union_extract
from .bitwise import bit_and, bit_not, bit_or, bit_xor, shift_left, shift_right
from .boolean import (and_, and_kleene, and_not, is_not_null, is_null, not_,
                      or_, or_kleene, xor)
from .cmp import distinct, eq, gt, gt_eq, lt, lt_eq, neq, not_distinct
from .coalesce import BatchCoalescer, slice_, slice_batch
from .concat import concat, concat_batches, interleave
from .equal import equal_batches, equal_columns
from .filter import apply_plan, build_plan, filter_, filter_record_batch
from .groupby import group_by
from .join import hash_join
from .merge import merge_batches, merge_indices, merge_n
from .ree import run_end_decode, run_end_decode_to, run_end_encode, take_run
from .temporal import date_part
from .numeric import (add, add_checked, div, div_checked, mul, mul_checked,
                      neg, raise_if, rem, rem_checked, sub, sub_checked)
from . import sort as sortmod
from .sort import (lexsort_to_indices, partition, partition_ranges, rank,
                   sort, sort_batch, sort_to_indices)
from .strings import (bit_length, concat_elements, contains, ends_with,
                      ilike, length, like, lower, nilike, nlike,
                      octet_length, regexp_is_match, starts_with, substring,
                      upper)
from .take import take, take_record_batch
from .zip import nullif, shift, zip_

__all__ = ["aggregate", "arity", "bitwise", "boolean", "coalesce", "equal",
           "merge", "numeric", "strings", "zipmod", "castmod", "dictmod",
           "unionmod", "ree", "temporal", "run_end_decode",
           "run_end_decode_to", "run_end_encode", "take_run", "date_part",
           "bool_and", "bool_or", "count", "finalize", "max_",
           "min_", "product", "sum_", "can_cast_types", "cast",
           "dictionary_decode", "dictionary_encode",
           "garbage_collect_dictionary", "merge_dictionary_values",
           "should_merge_dictionary_values", "take_union", "union_extract",
           "BatchCoalescer", "slice_",
           "slice_batch", "interleave", "equal_batches", "equal_columns",
           "merge_batches", "merge_indices", "merge_n",
           "bit_and", "bit_not", "bit_or", "bit_xor", "shift_left",
           "shift_right", "and_", "and_kleene", "and_not", "is_not_null",
           "is_null", "not_", "or_", "or_kleene", "xor", "distinct", "eq",
           "gt", "gt_eq", "lt", "lt_eq", "neq", "not_distinct", "concat",
           "concat_batches", "apply_plan", "build_plan", "filter_",
           "filter_record_batch", "group_by", "hash_join", "add",
           "add_checked", "div", "div_checked", "mul", "mul_checked", "neg",
           "raise_if", "rem", "rem_checked", "sub", "sub_checked", "take",
           "take_record_batch", "lexsort_to_indices", "partition",
           "partition_ranges", "rank", "sort", "sort_batch",
           "sort_to_indices", "sortmod", "bit_length", "concat_elements",
           "contains", "ends_with", "ilike", "length", "like", "lower",
           "nilike", "nlike", "octet_length", "regexp_is_match",
           "starts_with", "substring", "upper", "nullif", "shift", "zip_"]
