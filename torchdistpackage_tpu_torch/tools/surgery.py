"""Parameter-tree surgery and int8 weight-only quantisation — the
PyTorch counterpart of the int8 part of
``torchdistpackage_tpu/tools/surgery.py``: :func:`replace_params` (:39),
:class:`QuantizedLinear` (:57), :func:`quantize_int8` (:90),
:func:`dequantize_int8` (:98), :func:`int8_matmul` (:102),
:func:`quantize_stacked_int8` (:110), :data:`DECODE_WEIGHT_KEYS` (:128),
:func:`quantize_decode_params` (:131) and :func:`quantize_params_int8`
(:164), with the reference's ``key_str`` key paths
(``torchdistpackage_tpu/utils/tree.py:6``).

A parameter tree is nested dicts, lists and tuples of tensors.  Surgery
rewrites the leaves a ``(key path, leaf)`` predicate selects; the int8
sweep swaps a matmul weight for a :class:`QuantizedLinear` (an int8
weight and one f32 scale per output column), which the model's ``dense``
(``parallel/tensor_parallel/layers.py``) recognises by its ``q`` /
``scale`` attributes.  What int8 buys at decode is bytes: every weight is
read once a token, at half the bytes of bf16.

Two scale formulas live in the reference and stay apart here: this
module's ``absmax / 127 + 1e-12``, and the expert weights'
``max(absmax / 127, 1e-8)`` of ``ops.moe_dispatch.quantize_moe_experts``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

PyTree = Any


def is_int8_weight(x: Any) -> bool:
    """The reference's structural test for an int8 weight node: ``q`` and
    ``scale`` attributes (a :class:`QuantizedLinear` of this package or of
    the reference, with tensor or numpy children)."""
    return hasattr(x, "q") and hasattr(x, "scale")


def replace_params(params: PyTree, predicate: Callable[[str, Any], bool],
                   transform: Callable[[str, Any], Any]) -> PyTree:
    """Rewrite every leaf whose ``(key path, leaf)`` satisfies ``predicate``
    with ``transform(key path, leaf)``; returns a new tree (the leaves that
    stay are the same tensors).  Key paths are the reference's ``'a/b/0'``
    form: dict keys and list / tuple indices joined by ``/``; a
    :class:`QuantizedLinear` is a node whose children are ``0`` (q) and
    ``1`` (scale), as in the reference's flattening."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [walk(v, path + (str(i),)) for i, v in enumerate(node)]
            return out if isinstance(node, list) else tuple(out)
        if is_int8_weight(node):
            return QuantizedLinear(walk(node.q, path + ("0",)),
                                   walk(node.scale, path + ("1",)))
        key = "/".join(path)
        return transform(key, node) if predicate(key, node) else node

    return walk(params, ())


@dataclasses.dataclass
class QuantizedLinear:
    """An int8 weight ``q`` ``[*stack, in, out]`` and its f32 scale
    ``[*stack, 1, out]`` (or ``[out]``), standing in for a float weight.
    Indexing slices both together on the leading (stack) dims — where the
    reference's einsum specs carry a stacked weight, the port indexes it
    (``wqkv[i]``, ``layer_params``)."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.dim()

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())

    def __getitem__(self, i) -> "QuantizedLinear":
        if self.q.dim() <= 2 or self.scale.dim() != self.q.dim():
            raise IndexError(
                "a QuantizedLinear indexes its stack dims only (q "
                f"{tuple(self.q.shape)}, scale {tuple(self.scale.shape)})")
        return QuantizedLinear(self.q[i], self.scale[i])


@torch.no_grad()
def quantize_int8(w: torch.Tensor,
                  scale_dtype: torch.dtype = torch.float32) -> QuantizedLinear:
    """Symmetric per-output-channel (last dim) int8: ``scale = absmax over
    every other dim / 127 + 1e-12`` in ``w``'s dtype, then ``scale_dtype``;
    ``q = clip(round(w / scale), -127, 127)``."""
    absmax = w.abs().amax(dim=tuple(range(w.dim() - 1)))
    scale = (absmax / 127.0 + 1e-12).to(scale_dtype)
    q = torch.round(w / scale).clamp_(-127, 127).to(torch.int8)
    return QuantizedLinear(q=q, scale=scale)


def dequantize_int8(ql: QuantizedLinear,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return ql.q.to(dtype) * ql.scale.to(dtype)


def int8_matmul(x: torch.Tensor, ql: QuantizedLinear) -> torch.Tensor:
    """``x @ dequant(ql)`` the reference's way: the int8 weight upcast to
    ``x.dtype``, the product, then the per-column scale in f32 and a cast
    back to ``x.dtype``.  On the card the product of bf16 inputs comes out
    of cuBLAS rounded to bf16 (the reference keeps it f32 until the scale:
    one bf16 rounding more here); in f32 the arithmetic is the
    reference's."""
    y = x @ ql.q.to(x.dtype)
    return (y.float() * ql.scale.float()).to(x.dtype)


@torch.no_grad()
def quantize_stacked_int8(w: torch.Tensor,
                          scale_dtype: torch.dtype = torch.float32
                          ) -> QuantizedLinear:
    """Symmetric int8 with per-(stack, output-channel) scales: absmax over
    the contracted dim (-2) only, kept, so a layer-stacked ``[L, ..., d,
    out]`` weight keeps one scale row per layer and channel (``[L, ..., 1,
    out]``) and both leaves index together."""
    absmax = w.abs().amax(dim=-2, keepdim=True)
    scale = (absmax / 127.0 + 1e-12).to(scale_dtype)
    q = torch.round(w / scale).clamp_(-127, 127).to(torch.int8)
    return QuantizedLinear(q=q, scale=scale)


#: weight leaf names of the GPT / Llama / MoE families that carry matmul
#: weights (attention projections, MLP matrices, LM head)
DECODE_WEIGHT_KEYS = ("wqkv", "wq", "wkv", "wo", "w1", "w2", "head")


def quantize_decode_params(params: PyTree, min_size: int = 16384) -> PyTree:
    """int8 weight-only quantisation of a model tree for serving: every
    floating matmul weight named in :data:`DECODE_WEIGHT_KEYS` with at
    least 2 dims and ``min_size`` elements becomes a
    :func:`quantize_stacked_int8` :class:`QuantizedLinear` (stacked
    ``[L, ...]`` block leaves keep per-layer scales).  Embeddings, biases
    and norms stay float, and so do the MoE expert and router leaves
    (``experts`` / ``router`` in the key path): experts take
    ``quantize_moe_experts``' own pairs, which the fused kernel runs."""

    def pred(key: str, leaf: Any) -> bool:
        name = key.rsplit("/", 1)[-1]
        if "experts" in key or "router" in key:
            return False
        return (name in DECODE_WEIGHT_KEYS and isinstance(leaf, torch.Tensor)
                and leaf.dim() >= 2 and leaf.is_floating_point()
                and leaf.numel() >= min_size)

    return replace_params(params, pred,
                          lambda _k, w: quantize_stacked_int8(w))


def quantize_params_int8(params: PyTree,
                         predicate: Optional[Callable[[str, Any], bool]]
                         = None, min_size: int = 4096) -> PyTree:
    """Replace weight matrices with :func:`quantize_int8`
    :class:`QuantizedLinear` leaves.  Default predicate: floating 2-D
    leaves of at least ``min_size`` elements."""

    def default_pred(key: str, leaf: Any) -> bool:
        return (isinstance(leaf, torch.Tensor) and leaf.dim() == 2
                and leaf.is_floating_point() and leaf.numel() >= min_size)

    return replace_params(params, predicate or default_pred,
                          lambda _k, w: quantize_int8(w))
