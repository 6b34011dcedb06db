"""Tools over models and parameter trees: the per-block profiler
(``profiler``), NaN hunting (``debug_nan``) and int8 weight-only
quantisation for serving (``surgery``)."""

from .debug_nan import (
    check_model_params,
    check_tensors,
    enable_nan_debug,
    find_nan_block,
    nan_guard,
)
from .profiler import (
    BlockProfile,
    aggregate_levels,
    get_model_profile,
    profile_blocks,
    report_prof,
    report_tree,
)
from .surgery import (
    QuantizedLinear,
    dequantize_int8,
    int8_matmul,
    quantize_int8,
    quantize_params_int8,
    replace_params,
)

__all__ = ["BlockProfile", "QuantizedLinear", "aggregate_levels",
           "check_model_params", "check_tensors", "dequantize_int8",
           "enable_nan_debug", "find_nan_block", "get_model_profile",
           "int8_matmul", "nan_guard", "profile_blocks", "quantize_int8",
           "quantize_params_int8", "replace_params", "report_prof",
           "report_tree"]
