"""Mixture-of-Experts serving — the PyTorch counterpart of the serving
parts of ``torchdistpackage_tpu/parallel/moe.py``: :class:`MoEConfig`
(:48), ``_top_k_route`` (:134), ``_load_balance_loss`` (:227),
``_expert_ffn`` (:242), ``_router_metrics`` (:254),
``check_expert_overflow`` (:297), the token-choice capacity path of
``moe_forward`` (:323) with its expert-parallel exchange,
``moe_serve_forward`` (:501), ``init_moe_params`` (:608) and
``moe_param_specs`` (:632, here :func:`shard_experts`).

``moe_serve_forward`` routes every token to its top-k experts with no
capacity (exact, no drops) and runs the expert FFN through one of two
arms: ``'gather'`` sorts the ``T k`` assignments by expert and runs one
product per expert over its row group (the reference's ragged path,
plain PyTorch), ``'cuda'`` hands the routing to the fused kernel K6
(``ops/moe_dispatch.py``) at the no-drop capacity ``C = T``, float or
int8 weight-only experts.  ``'auto'`` picks ``'cuda'`` on a CUDA device
and ``'gather'`` on the CPU.  The port's ``'cuda'`` stands where the
reference says ``'pallas'``.

``moe_forward`` is the capacity path: top-k routing at a capacity of
``ceil(T k cf / E)`` slots an expert (drops past it), the ``'sorted'``
index dispatch into an ``[E, C, D]`` slot layout, the expert FFN, and the
gate-weighted gather combine.  Under expert parallelism (``ep_group``, a
``torch.distributed`` process group) every rank holds ``E / ep`` experts
(:func:`shard_experts`) and the slots go to their experts' ranks and back
by two ``all_to_all_single`` exchanges; the FFN of the exchanged groups
runs in K7 (``fused_expert_ffn``) under ``'cuda'``, in plain PyTorch
under ``'sorted'``.  Without a group, ``'cuda'`` runs K6 on the routing
directly.  It is forward only (serving): an input that requires grad
raises, as do the ``'dense'`` materialisation and the ``expert_choice``
router, which wait for MoE training (ROADMAP queue A).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..device import resolve_device
from ..obs.numerics import tree_leaves
from ..ops.moe_dispatch import (
    _is_q,
    ffn_rows,
    fused_expert_ffn,
    fused_moe_ffn,
    resolve_moe_dispatch,
)
from .tensor_parallel.layers import _normal

Params = Dict[str, Any]

#: dispatch values of the reference that are training-side
#: materialisations of the capacity path, not ported yet
_QUEUED_DISPATCH = ("dense",)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The reference's ``MoEConfig``.  ``dtype`` is a ``torch.dtype``.
    ``dispatch``: ``'auto'`` | ``'gather'`` (the serving path's ragged
    arm) | ``'sorted'`` (the capacity path's index dispatch) | ``'cuda'``
    (the reference's ``'pallas'``: K6, or K7 under EP); the ``'dense'``
    materialisation is refused until MoE training is ported.  ``act``:
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
        if self.dispatch not in ("auto", "gather", "sorted", "cuda"):
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


def _load_balance_loss(probs: torch.Tensor,
                       dispatched: torch.Tensor) -> torch.Tensor:
    """Switch-style aux loss: ``E sum_e mean_t(dispatched_e) mean_t(p_e)``
    over ``dispatched [T, E]``, the kept choices of each token."""
    E = probs.shape[-1]
    return E * torch.sum(dispatched.mean(0) * probs.mean(0))


def _expert_ffn(experts: Params, x: torch.Tensor) -> torch.Tensor:
    """The per-expert FFN on stacked experts, ``x [E, G, D] -> [E, G,
    D]`` in the experts' dtype — the ``'sorted'`` arm's plain path.  Float
    experts only: the reference's ``_expert_ffn`` reads ``.ndim`` on an
    int8 pair and dies, so it serves int8 experts under EP only through
    its kernel, as this does."""
    if _is_q(experts["w1"]) or _is_q(experts["w2"]):
        raise TypeError(
            "int8 (q8, scale) expert weights run only in the fused kernel: "
            "use dispatch='cuda' (the 'sorted' arm takes float experts)")
    return ffn_rows(x, *(experts[n] for n in ("w1", "b1", "w2", "b2")))


def _router_metrics(probs: torch.Tensor, keep: torch.Tensor,
                    top_k: int) -> Dict[str, torch.Tensor]:
    """The capacity path's counters (f32): the mean per-token router
    entropy over ``log E``, the kept choices per expert and the share of
    the ``T k`` choices dropped past capacity.  Per rank under EP."""
    T, E = probs.shape
    plogp = torch.where(probs > 0, probs * torch.log(probs),
                        torch.zeros_like(probs))
    entropy = -plogp.sum(-1).mean() / math.log(max(E, 2))
    return {"router_entropy": entropy.float(),
            "expert_tokens": keep.sum((0, 1)).float(),
            "dropped_token_rate": (1.0 - keep.sum() / (T * top_k)).float()}


def _ep_exchange(send: torch.Tensor, group) -> torch.Tensor:
    """One all-to-all over ``group``: ``send [ep, ...]``, block i to rank
    i of the group; returns ``[ep, ...]`` with block i from rank i."""
    send = send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv


def moe_forward(params: Params, x: torch.Tensor, cfg: MoEConfig,
                ep_group=None, causal: bool = False,
                return_metrics: bool = False):
    """The token-choice capacity path, ``x [B, S, D]`` (the rank's own
    tokens under EP) -> ``(y [B, S, D], aux)`` (``aux`` the f32
    load-balance loss), plus :func:`_router_metrics` with
    ``return_metrics=True``.  Each expert takes ``C = ceil(T k cf / E)``
    slots, ``T`` the rank's tokens; choices past C are dropped (they add
    zero, so use the output as a residual).  ``causal=True`` ranks the
    capacity token by token, so token t's output depends on tokens <= t
    only.

    ``cfg.dispatch``: ``'sorted'`` (plain PyTorch), ``'cuda'`` (K6 on the
    routing without a group; K7 on the exchanged groups with one) or
    ``'auto'`` (``'cuda'`` on the card, ``'sorted'`` on the CPU).
    ``ep_group``: a ``torch.distributed`` group of ``ep`` ranks, each
    holding ``E / ep`` experts (:func:`shard_experts`); the ``[E, C, D]``
    slots go to their experts' ranks as ``[ep, E / ep, C, D]`` blocks by
    ``all_to_all_single``, each rank runs its experts on ``[E / ep, ep C,
    D]`` rows, and the inverse exchange brings the outputs back."""
    if cfg.router != "topk":
        raise NotImplementedError(
            f"moe_forward serves router='topk' (got {cfg.router!r}); "
            f"expert_choice waits for MoE training (ROADMAP queue A)")
    if x.requires_grad or any(t.requires_grad for t in tree_leaves(params)):
        raise NotImplementedError(
            "moe_forward is forward only: its backward (K7's autograd "
            "included) comes with MoE training (ROADMAP queue A)")
    disp = resolve_moe_dispatch(cfg.dispatch, x.device, plain="sorted")
    B, S, D = x.shape
    T, E, k = B * S, cfg.num_experts, cfg.top_k
    tokens = x.reshape(T, D)
    probs = torch.softmax((tokens @ params["router"]["w"]).float(), dim=-1)
    capacity = max(1, int(math.ceil(T * k * cfg.capacity_factor / E)))
    gate_vals, gate_idx, slot, keep = _top_k_route(
        probs, k, capacity, priority="token" if causal else "choice")
    aux = _load_balance_loss(probs, keep.sum(1)).float()
    metrics = _router_metrics(probs, keep, k) if return_metrics else None
    experts = params["experts"]

    def done(y):
        out = (y.reshape(B, S, D).to(x.dtype), aux)
        return out + (metrics,) if return_metrics else out

    if disp == "cuda" and ep_group is None:
        return done(fused_moe_ffn(experts, tokens, gate_vals, gate_idx,
                                  slot, keep, capacity))
    # the sorted dispatch: kept choice (t, j) writes token t into flat slot
    # e C + c; dropped choices land on a dumpster row E C, cut off
    kept = keep.sum(-1)  # [T, k]: 1 iff the choice fit
    dest = torch.where(kept > 0, gate_idx * capacity + slot.long(),
                       E * capacity)  # [T, k]
    src = tokens[:, None, :].expand(T, k, D).reshape(T * k, D)
    expert_in = torch.zeros(E * capacity + 1, D, dtype=x.dtype,
                            device=x.device).index_add_(
        0, dest.reshape(-1), src)[:E * capacity].reshape(E, capacity, D)
    gates = (gate_vals * kept).to(x.dtype)  # [T, k]
    ffn = fused_expert_ffn if disp == "cuda" else _expert_ffn
    if ep_group is None:
        expert_out = ffn(experts, expert_in)
    else:
        ep = ep_group.size()
        if E % ep != 0:
            raise ValueError(f"num_experts {E} not divisible by EP size {ep}")
        e_loc = E // ep
        held = experts["w2"][0] if _is_q(experts["w2"]) else experts["w2"]
        if held.shape[0] != e_loc:
            raise ValueError(
                f"this rank holds {held.shape[0]} experts, EP {ep} of {E} "
                f"needs {e_loc}: shard them with shard_experts")
        recv = _ep_exchange(expert_in.reshape(ep, e_loc, capacity, D),
                            ep_group)
        # the local experts see ep C slots, C from every EP peer
        grouped = recv.transpose(0, 1).reshape(e_loc, ep * capacity, D)
        out = ffn(experts, grouped)
        back = out.reshape(e_loc, ep, capacity, D).transpose(0, 1)
        expert_out = _ep_exchange(back, ep_group).reshape(E, capacity, D)
    out_flat = torch.cat([expert_out.reshape(E * capacity, D),
                          expert_out.new_zeros(1, D)])  # dumpster -> 0
    picked = out_flat[dest]  # [T, k, D]
    return done((gates[..., None] * picked).sum(1))


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


def shard_experts(params: Params, rank: int, size: int) -> Params:
    """This EP rank's share of an MoE layer's params — the reference's
    ``moe_param_specs`` (:632) placement, as slices: every expert leaf
    (both halves of an int8 ``(q8, scale)`` pair too) cut along E to its
    ``[E / size, ...]`` block ``rank`` (EP ranks hold contiguous
    experts); the router stays whole.  The slices are views (no copy);
    ``.clone()`` them to free the full stack.  Raises unless ``size``
    divides E."""
    if not 0 <= rank < size:
        raise ValueError(f"EP rank {rank} not in [0, {size})")
    experts = params["experts"]
    E = (experts["w2"][0] if _is_q(experts["w2"]) else experts["w2"]).shape[0]
    if E % size != 0:
        raise ValueError(f"num_experts {E} not divisible by EP size {size}")
    e_loc = E // size
    lo = rank * e_loc

    def cut(leaf):
        if isinstance(leaf, tuple):
            return tuple(cut(t) for t in leaf)
        return leaf[lo:lo + e_loc]

    return dict(params, experts={n: cut(v) for n, v in experts.items()})
