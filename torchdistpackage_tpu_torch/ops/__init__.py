"""Kernels written by hand for Hopper, each beside its plain version:
``paged_attention`` (K1, and K2 for the context-parallel ring of
``ring_paged``), ``flash_attention`` (K3-K5) and ``moe_dispatch`` (K6
and K7, float and int8 expert weights).  Import the flash, MoE and ring
names from their submodules, whose own ``LAUNCHES`` count their
kernels.  Training's context parallelism (``ring_attention``: ring and
Ulysses attention over K3-K5) is exported here."""

from .paged_attention import (
    LAUNCHES,
    finalize_paged_carry,
    paged_carry_attention,
    paged_carry_attention_reference,
    paged_decode_attention,
    paged_decode_attention_reference,
    resolve_attn_impl,
)
from .ring_attention import (
    ring_attention,
    ulysses_attention,
    zigzag_permute,
    zigzag_positions,
    zigzag_unpermute,
)

__all__ = ["LAUNCHES", "finalize_paged_carry", "paged_carry_attention",
           "paged_carry_attention_reference", "paged_decode_attention",
           "paged_decode_attention_reference", "resolve_attn_impl",
           "ring_attention", "ulysses_attention", "zigzag_permute",
           "zigzag_positions", "zigzag_unpermute"]
