"""Model families: the GPT / Llama config, init, the cached block and the
training loss."""

from .convert import params_from_jax
from .gpt import (
    GPTConfig,
    gpt_embed,
    gpt_forward,
    gpt_head,
    gpt_hidden,
    gpt_loss,
    init_gpt_params,
    llama_config,
    mistral_7b_config,
)

__all__ = ["GPTConfig", "gpt_embed", "gpt_forward", "gpt_head",
           "gpt_hidden", "gpt_loss", "init_gpt_params", "llama_config",
           "mistral_7b_config", "params_from_jax"]
