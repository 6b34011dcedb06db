"""Kernels written by hand for Hopper, each beside its plain version:
``paged_attention`` (K1), ``flash_attention`` (K3-K5) and
``moe_dispatch`` (K6, float and int8 expert weights).  Import the flash
and MoE names from their submodules, whose own ``LAUNCHES`` count their
kernels."""

from .paged_attention import (
    LAUNCHES,
    paged_decode_attention,
    paged_decode_attention_reference,
    resolve_attn_impl,
)

__all__ = ["LAUNCHES", "paged_decode_attention",
           "paged_decode_attention_reference", "resolve_attn_impl"]
