"""Kernels written by hand for Hopper, each beside its plain version."""

from .paged_attention import (
    LAUNCHES,
    paged_decode_attention,
    paged_decode_attention_reference,
    resolve_attn_impl,
)

__all__ = ["LAUNCHES", "paged_decode_attention",
           "paged_decode_attention_reference", "resolve_attn_impl"]
