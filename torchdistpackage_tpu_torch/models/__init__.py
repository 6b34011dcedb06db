"""Model families: the GPT / Llama config, init, the cached block, the
training loss, the pipelined GPT steps and KV-cache generation (``generate``,
``speculative_generate``, ``beam_generate``); the MoE family's config,
per-block init, presets, training loss and MoE 1F1B; the Vision
Transformer and its MoE family (``vit``, ``vit_moe``)."""

from .convert import params_from_jax, vit_params_from_jax
from .generate import (
    beam_generate,
    forward_cached,
    forward_cached_moe,
    generate,
    init_kv_cache,
    speculative_generate,
)
from .gpt import (
    GPTConfig,
    deinterleave_stage_params,
    gpt_embed,
    gpt_forward,
    gpt_head,
    gpt_hidden,
    gpt_interleaved_param_specs,
    gpt_loss,
    gpt_param_specs,
    gpt_pipeline_1f1b,
    gpt_pipeline_loss,
    gpt_pipeline_zb,
    init_gpt_params,
    interleave_stage_params,
    llama_config,
    mistral_7b_config,
    mixtral_8x7b_config,
    pipe_slab,
    shard_gpt_params,
)
from .gpt_moe import (
    gpt_moe_forward,
    gpt_moe_loss,
    gpt_moe_param_specs,
    gpt_moe_pipeline_1f1b,
    gpt_moe_pipeline_param_specs,
    init_gpt_moe_params,
    is_moe_block,
    moe_block_forward,
    moe_block_stack,
    moe_blocks_param_specs,
    moe_layer_config,
    moe_stage_params,
    moe_stage_pattern,
    shard_moe_params,
)
from .vit import (
    ViTConfig,
    init_vit_params,
    patchify,
    vit_embed,
    vit_forward,
    vit_loss,
    vit_param_specs,
    vit_pipeline_1f1b,
    vit_pool_logits,
)
from .vit_moe import (
    init_vit_moe_params,
    vit_moe_forward,
    vit_moe_loss,
    vit_moe_param_specs,
)

__all__ = ["GPTConfig", "beam_generate", "deinterleave_stage_params",
           "forward_cached", "forward_cached_moe", "generate", "gpt_embed",
           "gpt_forward", "gpt_head", "gpt_hidden", "gpt_moe_forward",
           "gpt_moe_loss", "gpt_moe_param_specs", "gpt_moe_pipeline_1f1b",
           "gpt_moe_pipeline_param_specs",
           "gpt_interleaved_param_specs", "gpt_loss", "gpt_param_specs",
           "gpt_pipeline_1f1b", "gpt_pipeline_loss", "gpt_pipeline_zb",
           "init_gpt_moe_params", "init_gpt_params", "init_kv_cache",
           "interleave_stage_params", "is_moe_block", "llama_config",
           "mistral_7b_config", "mixtral_8x7b_config", "moe_block_forward",
           "moe_block_stack", "moe_blocks_param_specs", "moe_layer_config",
           "moe_stage_params", "moe_stage_pattern",
           "params_from_jax", "pipe_slab", "shard_gpt_params",
           "shard_moe_params", "speculative_generate", "ViTConfig",
           "init_vit_moe_params", "init_vit_params", "patchify",
           "vit_embed", "vit_forward", "vit_loss", "vit_moe_forward",
           "vit_moe_loss", "vit_moe_param_specs", "vit_param_specs",
           "vit_params_from_jax", "vit_pipeline_1f1b", "vit_pool_logits"]
