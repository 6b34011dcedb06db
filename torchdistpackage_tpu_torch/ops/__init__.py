"""Kernels written by hand for Hopper, each beside its plain version:
``paged_attention`` (K1) and ``flash_attention`` (K3-K5; import its names
from the submodule, whose ``LAUNCHES`` counts its three kernels)."""

from .paged_attention import (
    LAUNCHES,
    paged_decode_attention,
    paged_decode_attention_reference,
    resolve_attn_impl,
)

__all__ = ["LAUNCHES", "paged_decode_attention",
           "paged_decode_attention_reference", "resolve_attn_impl"]
