"""Mixture-of-Experts serving on one device — the PyTorch counterpart of
the serving parts of ``torchdistpackage_tpu/parallel/moe.py``:
:class:`MoEConfig` (:48), ``_top_k_route`` (:134), ``check_expert_overflow``
(:297), ``moe_serve_forward`` (:501) and ``init_moe_params`` (:608).

``moe_serve_forward`` routes every token to its top-k experts with no
capacity (exact, no drops) and runs the expert FFN through one of two
arms: ``'gather'`` sorts the ``T k`` assignments by expert and runs one
product per expert over its row group (the reference's ragged path,
plain PyTorch), ``'cuda'`` hands the routing to the fused kernel K6
(``ops/moe_dispatch.py``) at the no-drop capacity ``C = T``, float or
int8 weight-only experts.  ``'auto'`` picks ``'cuda'`` on a CUDA device
and ``'gather'`` on the CPU.  The port's ``'cuda'`` stands where the
reference says ``'pallas'``.

The capacity (training) path ``moe_forward``, its load-balance loss, the
dense and sorted dispatch materialisations, expert-choice routing and
expert parallelism wait for MoE training (ROADMAP queue A).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.moe_dispatch import (
    _is_q,
    ffn_rows,
    fused_moe_ffn,
    resolve_moe_dispatch,
)
from .tensor_parallel.layers import _normal

Params = Dict[str, Any]

#: dispatch values of the reference that are training-side
#: materialisations of the capacity path, not ported yet
_QUEUED_DISPATCH = ("dense", "sorted")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The reference's ``MoEConfig``.  ``dtype`` is a ``torch.dtype``.
    ``dispatch``: ``'auto'`` | ``'gather'`` | ``'cuda'`` (the reference's
    ``'pallas'``); its ``'dense'`` / ``'sorted'`` capacity-path
    materialisations are refused until MoE training is ported.  ``act``:
    ``'gelu'`` | ``'swiglu'`` (stacked ``[E, 2, D, F]`` gate/up, the
    Mixtral expert)."""

    dim: int
    ffn_dim: int
    num_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 1e-2
    dtype: torch.dtype = torch.float32
    router: str = "topk"
    dispatch: str = "auto"
    act: str = "gelu"

    def __post_init__(self):
        if self.router not in ("topk", "expert_choice"):
            raise ValueError(f"unknown MoE router {self.router!r}")
        if self.dispatch in _QUEUED_DISPATCH:
            raise NotImplementedError(
                f"MoE dispatch {self.dispatch!r} belongs to the capacity "
                f"(training) path, not ported yet (ROADMAP queue A)")
        if self.dispatch not in ("auto", "gather", "cuda"):
            raise ValueError(f"unknown MoE dispatch {self.dispatch!r}")
        if self.dispatch == "cuda" and self.router != "topk":
            raise ValueError(
                "dispatch='cuda' consumes a _top_k_route decision; the "
                "expert_choice router has no (gate_idx, slot, keep) form")
        if self.act not in ("gelu", "swiglu"):
            raise ValueError(f"unknown MoE act {self.act!r}")
        if not 1 <= self.top_k <= self.num_experts:
            raise ValueError(
                f"top_k must be in [1, {self.num_experts}], got {self.top_k}")


def _top_k_gates(probs: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each token's top-k experts and their gates, renormalised over the
    k choices with ``max(sum, 1e-9)``."""
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)
    return (gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9),
            gate_idx)


def _top_k_route(probs: torch.Tensor, k: int, capacity: int,
                 priority: str = "choice"
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """The routing decision.  probs ``[T, E]`` -> ``gate_vals`` [T, k]
    (renormalised over the choices, ``max(sum, 1e-9)``), ``gate_idx``
    [T, k], ``slot`` int32 [T, k] (the choice's place in its expert's
    capacity) and ``keep`` [T, k, E] (one-hot of the choices that fit).
    ``priority='choice'`` ranks all first choices before any second one
    (Switch/GShard); ``'token'`` ranks token by token (causally safe under
    drops)."""
    T, E = probs.shape
    gate_vals, gate_idx = _top_k_gates(probs, k)
    onehot = F.one_hot(gate_idx, E)  # [T, k, E] int64
    if priority == "choice":
        flat = onehot.transpose(0, 1).reshape(k * T, E)
        pos = (flat.cumsum(0) - flat).reshape(k, T, E).transpose(0, 1)
    elif priority == "token":
        flat = onehot.reshape(T * k, E)
        pos = (flat.cumsum(0) - flat).reshape(T, k, E)
    else:
        raise ValueError(f"unknown routing priority {priority!r}")
    keep = (onehot * (pos < capacity)).to(probs.dtype)
    slot = (pos * onehot).sum(-1).to(torch.int32)
    return gate_vals, gate_idx, slot, keep


#: Dropped-token rate above which :func:`check_expert_overflow` records an
#: ``expert_overflow`` event (the reference's threshold).
EXPERT_OVERFLOW_THRESHOLD = 0.05


def check_expert_overflow(metrics: Dict[str, Any],
                          threshold: float = EXPERT_OVERFLOW_THRESHOLD,
                          where: str = "") -> bool:
    """Host-side overflow tripwire over concrete router metrics (any
    mapping with a ``dropped_token_rate``): past ``threshold`` it records
    an ``expert_overflow`` event and returns True."""
    rate = metrics.get("dropped_token_rate")
    rate = 0.0 if rate is None else float(rate)
    if rate > threshold:
        from ..obs.events import default_event_log

        default_event_log().emit("expert_overflow", dropped_token_rate=rate,
                                 threshold=threshold, where=where)
        return True
    return False


def _ragged_ffn(experts: Params, tokens: torch.Tensor,
                gate_vals: torch.Tensor, gate_idx: torch.Tensor
                ) -> torch.Tensor:
    """The ``'gather'`` arm's expert FFN: the ``T k`` (token, choice)
    assignments sorted by expert (stable, so ties keep token order), the
    rows gathered, one product per expert and weight over its row group in
    the model dtype, then the gate-weighted scatter-add per token.  The
    group sizes are read back to the host to cut the groups."""
    if _is_q(experts["w1"]) or _is_q(experts["w2"]):
        # the reference's ragged arm dies here with an AttributeError
        # (parallel/moe.py:588); it never dequantises silently, nor does this
        raise TypeError(
            "int8 (q8, scale) expert weights run only in the fused kernel: "
            "use moe_dispatch='cuda' (the 'gather' arm takes float experts)")
    T, D = tokens.shape
    k = gate_idx.shape[1]
    E = experts["w2"].shape[0]
    flat = gate_idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_tok = order // k
    rows = tokens[sorted_tok]  # [T k, D], grouped by expert
    sizes = torch.bincount(flat, minlength=E).tolist()
    out = torch.cat([
        ffn_rows(rows_e, *(experts[n][e] for n in ("w1", "b1", "w2", "b2")))
        for e, rows_e in enumerate(torch.split(rows, sizes)) if sizes[e]])
    g = gate_vals.reshape(-1)[order].to(out.dtype)
    y = torch.zeros(T, D, dtype=out.dtype, device=tokens.device)
    return y.index_add_(0, sorted_tok, g[:, None] * out)


def moe_serve_forward(params: Params, x: torch.Tensor, cfg: MoEConfig,
                      dispatch: Optional[str] = None,
                      return_metrics: bool = False):
    """Serving-time MoE FFN, ``[B, S, D] -> [B, S, D]``: exact top-k
    routing with no capacity (no drops, so causally safe), the router's
    product in the model dtype and its softmax in f32.  ``dispatch``
    overrides ``cfg.dispatch``: ``'gather'`` (the ragged plain path, the
    oracle arm; float experts only), ``'cuda'`` (K6 at ``C = T``; all-empty
    capacity tiles exit at once; float experts or the int8 ``(q8, scale)``
    pairs of ``quantize_moe_experts``) or ``'auto'`` (by the device).  ``return_metrics=True``
    also returns ``{'expert_tokens': [E] f32 (bincount of the choices of
    all T rows), 'dropped_token_rate': 0}``."""
    if cfg.router != "topk":
        raise NotImplementedError(
            f"moe_serve_forward supports router='topk' (got {cfg.router!r})")
    B, S, D = x.shape
    T, E, k = B * S, cfg.num_experts, cfg.top_k
    tokens = x.reshape(T, D)
    disp = resolve_moe_dispatch(cfg.dispatch if dispatch is None
                                else dispatch, x.device)
    probs = torch.softmax((tokens @ params["router"]["w"]).float(), dim=-1)
    gate_vals, gate_idx = _top_k_gates(probs, k)
    if disp == "cuda":
        # C = T is the static no-drop bound (a token holds at most one slot
        # of an expert), so keep is the full choice one-hot and this arm
        # routes exactly the (token, expert) set of the ragged arm
        gv, gi, slot, keep = _top_k_route(probs, k, T)
        y = fused_moe_ffn(params["experts"], tokens, gv, gi, slot, keep, T)
    else:
        y = _ragged_ffn(params["experts"], tokens, gate_vals, gate_idx)
    y = y.reshape(B, S, D).to(x.dtype)
    if not return_metrics:
        return y
    metrics = {
        "expert_tokens": torch.bincount(gate_idx.reshape(-1),
                                        minlength=E).float(),
        "dropped_token_rate": torch.zeros((), device=x.device),
    }
    return y, metrics


def _stack_normal(shape, std: float, dtype: torch.dtype,
                  gen: torch.Generator, device) -> torch.Tensor:
    """N(0, std²) drawn in f32 one expert at a time, so an expert stack of
    many GB never needs an f32 copy of itself."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i] = _normal(shape[1:], std, dtype, gen, device)
    return out


def init_moe_params(gen: torch.Generator, cfg: MoEConfig,
                    device=None) -> Params:
    """Router ``w`` [D, E] ~ N(0, 1/D); experts ``w1`` [E, D, F] (GELU) or
    [E, 2, D, F] (SwiGLU) ~ N(0, 1/D), ``w2`` [E, F, D] ~ N(0, 1/F), zero
    biases — the reference's layouts and scales, drawn from ``gen`` on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    D, Fd, E, dt = cfg.dim, cfg.ffn_dim, cfg.num_experts, cfg.dtype
    s1, s2 = 1.0 / math.sqrt(D), 1.0 / math.sqrt(Fd)
    if cfg.act == "swiglu":
        experts = {"w1": _stack_normal((E, 2, D, Fd), s1, dt, gen, dev),
                   "b1": torch.zeros(E, 2, Fd, dtype=dt, device=dev)}
    else:
        experts = {"w1": _stack_normal((E, D, Fd), s1, dt, gen, dev),
                   "b1": torch.zeros(E, Fd, dtype=dt, device=dev)}
    experts["w2"] = _stack_normal((E, Fd, D), s2, dt, gen, dev)
    experts["b2"] = torch.zeros(E, D, dtype=dt, device=dev)
    return {"router": {"w": _normal((D, E), s1, dt, gen, dev)},
            "experts": experts}
