"""Model families: the GPT / Llama config, init and the cached block."""

from .convert import params_from_jax
from .gpt import (
    GPTConfig,
    gpt_head,
    init_gpt_params,
    llama_config,
    mistral_7b_config,
)

__all__ = ["GPTConfig", "gpt_head", "init_gpt_params", "llama_config",
           "mistral_7b_config", "params_from_jax"]
