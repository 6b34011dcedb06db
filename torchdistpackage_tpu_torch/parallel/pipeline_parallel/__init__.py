"""Pipeline parallelism over a pipe process group — the port's
counterpart of ``torchdistpackage_tpu/parallel/pipeline_parallel``:
the partitioners and stage stacks, the fill-drain schedule, 1F1B
(classic and interleaved), zero-bubble and heterogeneous stages, every
schedule MPMD over point-to-point messages (``pipeline_sched``)."""

from .hetero import ShapeDtype, bus_pack, bus_unpack, make_heterogeneous_stage
from .pipeline_helper import (
    balanced_stage_stack,
    flat_and_partition,
    param_count,
    partition_balanced,
    partition_uniform,
    pipe_split_flags,
    stack_stage_params,
    stacked_param_specs,
    unstack_stage_params,
)
from .pipeline_sched import (
    is_first_stage,
    is_last_stage,
    last_stage_value,
    last_stats,
    pipeline_1f1b,
    pipeline_forward,
    pipeline_loss,
    ring_slots,
    shift_left,
    shift_right,
    stage_index,
)
from .zero_bubble import pipeline_zb_1f1b, zb_schedule_ticks

__all__ = [
    "ShapeDtype", "balanced_stage_stack", "bus_pack", "bus_unpack",
    "flat_and_partition", "is_first_stage", "is_last_stage",
    "last_stage_value", "last_stats", "make_heterogeneous_stage",
    "param_count", "partition_balanced", "partition_uniform",
    "pipe_split_flags", "pipeline_1f1b", "pipeline_forward",
    "pipeline_loss", "pipeline_zb_1f1b", "ring_slots", "shift_left",
    "shift_right", "stack_stage_params", "stacked_param_specs",
    "stage_index", "unstack_stage_params", "zb_schedule_ticks",
]
