"""The transformer block's math (serial; tensor parallelism is queued),
residual dropout and the remat modes."""

from .layers import (
    RematMode,
    TransformerConfig,
    apply_rope,
    attention_partial,
    block_forward,
    block_rope_cache,
    checkpoint_block,
    compute_qkv,
    core_attention,
    dense,
    dropout,
    grad_taps,
    init_block_params,
    init_norm_params,
    layer_norm,
    mlp_partial,
    offload_advice,
    rms_norm,
    rope_cache,
    scan_blocks,
)

__all__ = [
    "RematMode", "TransformerConfig", "apply_rope", "attention_partial",
    "block_forward", "block_rope_cache", "checkpoint_block", "compute_qkv",
    "core_attention", "dense", "dropout", "grad_taps", "init_block_params",
    "init_norm_params", "layer_norm", "mlp_partial", "offload_advice",
    "rms_norm", "rope_cache", "scan_blocks",
]
