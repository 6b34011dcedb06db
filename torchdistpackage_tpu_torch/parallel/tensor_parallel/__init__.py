"""The transformer block's math (serial; tensor parallelism is queued)."""

from .layers import (
    TransformerConfig,
    apply_rope,
    compute_qkv,
    dense,
    init_block_params,
    init_norm_params,
    layer_norm,
    mlp_partial,
    rms_norm,
    rope_cache,
)

__all__ = [
    "TransformerConfig", "apply_rope", "compute_qkv", "dense",
    "init_block_params", "init_norm_params", "layer_norm", "mlp_partial",
    "rms_norm", "rope_cache",
]
