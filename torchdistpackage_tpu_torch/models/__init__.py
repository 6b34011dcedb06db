"""Model families: the GPT / Llama config, init, the cached block, the
training loss, the pipelined GPT steps and KV-cache generation (``generate``,
``speculative_generate``, ``beam_generate``); the MoE family's config,
per-block init and presets."""

from .convert import params_from_jax
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
    init_gpt_moe_params,
    is_moe_block,
    moe_layer_config,
    shard_moe_params,
)

__all__ = ["GPTConfig", "beam_generate", "deinterleave_stage_params",
           "forward_cached", "forward_cached_moe", "generate", "gpt_embed",
           "gpt_forward", "gpt_head", "gpt_hidden",
           "gpt_interleaved_param_specs", "gpt_loss", "gpt_param_specs",
           "gpt_pipeline_1f1b", "gpt_pipeline_loss", "gpt_pipeline_zb",
           "init_gpt_moe_params", "init_gpt_params", "init_kv_cache",
           "interleave_stage_params", "is_moe_block", "llama_config",
           "mistral_7b_config", "mixtral_8x7b_config", "moe_layer_config",
           "params_from_jax", "pipe_slab", "shard_gpt_params",
           "shard_moe_params", "speculative_generate"]
