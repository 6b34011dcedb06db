"""Tools over models and parameter trees: the per-block profiler
(``profiler``), NaN hunting (``debug_nan``) and int8 weight-only
quantisation for serving (``surgery``); and over run artifacts: the A/B
parity diff of two RUNREPORTs (``parity_diff``) and the bench-round
trend gate (``bench_trend``), each also a command
(``python -m torchdistpackage_tpu_torch.tools.<name>``), whose functions
this package hands out on first use (importing the two modules here
would make ``python -m`` run a module already imported)."""

import importlib

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

#: the artifact tools' functions, by the module that defines them
_LAZY = {"load_run": "parity_diff", "dtype_shift": "parity_diff",
         "comm_axis_shift": "parity_diff", "load_rounds": "bench_trend",
         "trend": "bench_trend"}


def __getattr__(name):
    if name in _LAZY:
        module = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["BlockProfile", "QuantizedLinear", "aggregate_levels",
           "comm_axis_shift", "dtype_shift", "load_rounds", "load_run",
           "trend",
           "check_model_params", "check_tensors", "dequantize_int8",
           "enable_nan_debug", "find_nan_block", "get_model_profile",
           "int8_matmul", "nan_guard", "profile_blocks", "quantize_int8",
           "quantize_params_int8", "replace_params", "report_prof",
           "report_tree"]
