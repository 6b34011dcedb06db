"""Tools over models and parameter trees: the per-block profiler
(``profiler``), NaN hunting (``debug_nan``) and int8 weight-only
quantisation for serving (``surgery``); over run artifacts: the A/B
parity diff of two RUNREPORTs (``parity_diff``) and the bench-round
trend gate (``bench_trend``); and for planning: the planner's command
line (``autoplan``), the kernels' tile and split-width tuner
(``flash_tune``) and the SLURM babysitter (``slurm_job_monitor``).  Each
of the last five is also a command
(``python -m torchdistpackage_tpu_torch.tools.<name>``), whose functions
this package hands out on first use (importing those modules here would
make ``python -m`` run a module already imported)."""

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
         "trend": "bench_trend", "launch_job": "slurm_job_monitor",
         "determine_job_is_alive": "slurm_job_monitor",
         "monitor_job": "slurm_job_monitor",
         "tune_flash_blocks": "flash_tune",
         "tune_paged_params": "flash_tune"}


def __getattr__(name):
    if name in _LAZY:
        module = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["BlockProfile", "QuantizedLinear", "aggregate_levels",
           "comm_axis_shift", "determine_job_is_alive", "dtype_shift",
           "launch_job", "load_rounds", "load_run", "monitor_job", "trend",
           "tune_flash_blocks", "tune_paged_params",
           "check_model_params", "check_tensors", "dequantize_int8",
           "enable_nan_debug", "find_nan_block", "get_model_profile",
           "int8_matmul", "nan_guard", "profile_blocks", "quantize_int8",
           "quantize_params_int8", "replace_params", "report_prof",
           "report_tree"]
