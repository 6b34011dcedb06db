"""Carry parameter trees into the port: from the JAX package
(:func:`params_from_jax`, :func:`vit_params_from_jax`) and from and to
HuggingFace checkpoints (the reference's ``models/convert.py``).

The port keeps the reference's layouts leaf for leaf (``[in, out]``
weights, block leaves stacked ``[L, ...]``, the Llama preset's zero
biases; the MoE family's per-block list with its stacked ``[E, ...]``
expert leaves; the int8 weight-only leaves), so the conversion is a
value-preserving copy of every array — after which the port and the JAX
package compute the same function on the same weights, which is what the
parity tests rely on.

The HF converters (JAX :74-484) are array surgery on a state dict: the
torch ``[out, in]`` linears transposed to ``[in, out]``, q/k/v (or k/v
under GQA) and gate/up stacked into the fused leaves.  Their rules are
the reference's: HF Llama's half-split rotary is ``apply_rope``'s;
``rms_norm_eps``, ``rope_theta``, the rope scalings JAX accepts
(``'linear'``, ``'llama3'``, ``'dynamic'``, ``'yarn'``; others refused) and
a uniform ``sliding_window`` carry over; real ``attention_bias`` /
``mlp_bias`` tensors load into the bias leaves (absent ones are zeros);
a checkpoint without ``lm_head.weight`` ties the head to the embedding;
non-silu Llama MLPs, decoupled head dims, mixed per-layer windows and
non-standard GPT-2 variants are refused rather than imported wrong.
They take a mapping of names to torch tensors or numpy arrays and an HF
config object or a plain dict of its fields, and never import
``transformers``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.moe import shard_experts
from ..parallel.tensor_parallel.layers import _ROPE_SCALING_TYPES
from ..tools.surgery import QuantizedLinear, is_int8_weight
from .gpt import GPTConfig, llama_config, shard_gpt_params


def _tensor(x, device, dtype=None) -> torch.Tensor:
    """One numpy array as a tensor on ``device``, of ``dtype`` or (None)
    of its own dtype.  bfloat16 (numpy's ``ml_dtypes`` extension type)
    passes through float32, which holds every bfloat16 value exactly."""
    arr = np.asarray(x)
    own = None
    if arr.dtype.name == "bfloat16":
        arr, own = arr.astype(np.float32), torch.bfloat16
    t = torch.from_numpy(np.array(arr, order="C"))  # a writable copy
    return t.to(device=device, dtype=dtype or own or t.dtype)


def params_from_jax(np_tree: Dict[str, Any], cfg: GPTConfig,
                    device=None, ep_rank: int = 0, ep_size: int = 1,
                    tp_rank: int = 0, tp_size: int = 1, pp_rank: int = 0,
                    pp_size: int = 1, num_chunks: int = 1) -> Dict[str, Any]:
    """``np_tree``: the JAX param pytree with every leaf already turned
    into a numpy array (``jax.tree.map(np.asarray, params)`` on the JAX
    side — this module never imports JAX).  Returns the port's dict with
    each float leaf a tensor of ``cfg.dtype`` on ``device`` (default: the
    card).  int8 weight-only leaves keep their dtypes (int8 weights, their
    scales' own float type): an ``ops.moe_dispatch.quantize_moe_experts``
    ``(q8, scale)`` expert pair stays a tuple of two tensors, and a
    ``tools.surgery.QuantizedLinear`` node of the reference (recognised by
    its ``q`` / ``scale`` attributes, whatever its class) becomes the
    port's :class:`~..tools.surgery.QuantizedLinear`.

    ``blocks`` is the dense family's stacked dict, or — for an MoE config
    (``cfg.moe_experts > 0``) — the per-block list of
    ``init_gpt_moe_params``, one dict per block, kept a list.
    ``ep_size > 1`` converts only expert-parallel rank ``ep_rank``'s
    share: each expert block's stacked expert leaves cut along E to the
    rank's ``[E / ep_size, ...]`` block before they are copied (as
    ``models.gpt_moe.shard_moe_params`` cuts a whole tree).
    ``tp_size > 1`` converts only tensor-parallel rank ``tp_rank``'s
    shard: ``models.gpt.shard_gpt_params`` cuts the numpy tree before the
    copy (an int8 leaf the table splits raises: the reference's specs
    shard none).  Both at once give rank ``(ep_rank, tp_rank)``'s share
    of an MoE tree, JAX ``gpt_moe_param_specs(tp_axis, ep_axis)``:
    attention, the embedding and the head cut over the tensor group, the
    experts cut along E over the expert group and replicated over the
    tensor group (so an int8 expert pair passes).

    ``pp_size > 1`` (or ``num_chunks > 1``) converts pipeline stage
    ``pp_rank``'s params: the dense family's slab of the stacked block
    leaves, or an MoE tree's slab of its block list
    (``models.gpt_moe.moe_stage_params``) — from the serial list, or from
    JAX's pipeline layout (``stack_moe_stage_params``: a list of ``L / (P
    V)`` positions whose leaves are stacked ``[P, ...]``, or ``[V, P,
    ...]`` interleaved), whose stage slices are taken first."""
    dev = resolve_device(device)
    if ep_size > 1 and not cfg.moe_experts:
        raise ValueError(f"EP size {ep_size} needs an MoE config")
    blocks = np_tree.get("blocks")
    nslabs, stages = pp_size * num_chunks, pp_size
    if (isinstance(blocks, (list, tuple)) and nslabs > 1
            and len(blocks) * nslabs == cfg.nlayers):
        np_tree = dict(np_tree, blocks=_jax_stage_slab(
            blocks, pp_rank, pp_size, num_chunks))
        pp_size = num_chunks = 1
    if tp_size > 1 or pp_size > 1 or num_chunks > 1:
        np_tree = shard_gpt_params(np_tree, cfg, tp_rank, tp_size,
                                   pp_rank=pp_rank, pp_size=pp_size,
                                   num_chunks=num_chunks)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, tuple):
            if len(x) != 2 or np.asarray(x[0]).dtype != np.int8:
                raise TypeError(
                    "a tuple leaf must be an int8 (q8, scale) expert pair")
            return tuple(_tensor(a, dev) for a in x)
        if is_int8_weight(x):
            return QuantizedLinear(_tensor(x.q, dev), _tensor(x.scale, dev))
        return _tensor(x, dev, cfg.dtype)

    tree = dict(np_tree)
    blocks = tree.pop("blocks", None)
    out = conv(tree)
    if isinstance(blocks, (list, tuple)):
        if not cfg.moe_experts or len(blocks) * stages != cfg.nlayers:
            raise TypeError(
                f"a per-block list of {len(blocks)} blocks needs an MoE "
                f"config of as many layers (moe_experts "
                f"{cfg.moe_experts}, nlayers {cfg.nlayers})")
        if ep_size > 1:
            blocks = [dict(b, moe=shard_experts(b["moe"], ep_rank, ep_size))
                      if "moe" in b else b for b in blocks]
        out["blocks"] = [conv(dict(b)) for b in blocks]
    elif blocks is not None:
        if cfg.moe_experts:
            raise TypeError("an MoE config needs the per-block list of "
                            "init_gpt_moe_params, got stacked blocks")
        out["blocks"] = conv(blocks)
    want = {"tok_emb", "blocks", "ln_f", "head"}
    if cfg.pos == "learned":
        want.add("pos_emb")
    if set(out) != want:
        raise ValueError(
            f"param tree keys {sorted(out)} do not match the config "
            f"(expected {sorted(want)})")
    return out



def _jax_stage_slab(blocks, pp_rank: int, pp_size: int, num_chunks: int):
    """Stage ``pp_rank``'s block list from JAX's MoE pipeline layout:
    position ``i``'s leaves ``[P, ...]`` (or ``[V, P, ...]``) sliced to the
    stage, chunk-major — the order of ``moe_stage_params``."""
    def take(node, v):
        if isinstance(node, dict):
            return {k: take(a, v) for k, a in node.items()}
        a = np.asarray(node)
        return a[pp_rank] if num_chunks == 1 else a[v, pp_rank]
    return [take(b, v) for v in range(num_chunks) for b in blocks]


def vit_params_from_jax(np_tree: Dict[str, Any], cfg, device=None,
                        ep_rank: int = 0, ep_size: int = 1,
                        tp_rank: int = 0, tp_size: int = 1,
                        pp_rank: int = 0, pp_size: int = 1
                        ) -> Dict[str, Any]:
    """:func:`params_from_jax` for the ViT families (``models.vit``,
    ``models.vit_moe``): ``np_tree`` is JAX's ``init_vit_params`` /
    ``init_vit_moe_params`` tree with numpy leaves — ``patch_proj`` {w,
    b}, ``pos_emb``, the stacked ``blocks`` (or, with
    ``cfg.moe_experts``, the per-block list), ``ln_f`` and ``head`` {w,
    b}.  Every float leaf becomes a tensor of ``cfg.dtype`` on ``device``
    (default: the card).  ``tp_size > 1``: tensor rank ``tp_rank``'s
    shard (``vit_param_specs`` / ``vit_moe_param_specs``: the blocks as
    the GPT's, the head on its classes); ``ep_size > 1``: each expert
    block's experts cut to rank ``ep_rank``'s ``[E / ep_size, ...]``;
    ``pp_size > 1``: stage ``pp_rank``'s slab of the blocks, every other
    leaf whole."""
    from ..parallel.tensor_parallel.layers import shard_params
    from .gpt import pipe_slab
    from .gpt_moe import moe_stage_params
    from .vit import vit_param_specs
    from .vit_moe import vit_moe_param_specs

    dev = resolve_device(device)
    moe = isinstance(np_tree.get("blocks"), (list, tuple))
    if moe != bool(cfg.moe_experts):
        raise TypeError(
            f"a {'per-block list' if moe else 'stacked block tree'} for a "
            f"config with moe_experts={cfg.moe_experts}")
    if ep_size > 1 and not moe:
        raise ValueError(f"EP size {ep_size} needs an MoE config")
    tree = dict(np_tree, blocks=list(np_tree["blocks"])) if moe else np_tree
    if tp_size > 1:
        specs = vit_moe_param_specs(tree) if moe else vit_param_specs(tree)
        tree = shard_params(tree, specs, tp_rank, tp_size)
    if pp_size > 1:
        tree = (moe_stage_params(tree, cfg, pp_rank, pp_size) if moe
                else pipe_slab(tree, pp_rank, pp_size))
    if ep_size > 1:
        tree = dict(tree, blocks=[
            dict(b, moe=shard_experts(b["moe"], ep_rank, ep_size))
            if "moe" in b else b for b in tree["blocks"]])

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        return _tensor(x, dev, cfg.dtype)

    out = conv(dict(tree))
    want = {"patch_proj", "pos_emb", "blocks", "ln_f", "head"}
    if set(out) != want:
        raise ValueError(f"param tree keys {sorted(out)} do not match a ViT "
                         f"(expected {sorted(want)})")
    return out


# ------------------------------------------------------------ HuggingFace


def _field(hf_cfg: Any) -> Any:
    """A getter of an HF config's fields: an object's attributes or a
    plain dict's keys."""
    if isinstance(hf_cfg, Mapping):
        return hf_cfg.get
    return lambda k, d=None: getattr(hf_cfg, k, d)


def _hf_tensor(x: Any, device: torch.device) -> torch.Tensor:
    """A state-dict value (torch tensor or numpy array) as a tensor on
    ``device`` in its own dtype."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device)
    return _tensor(x, device)


def llama_config_from_hf(hf_cfg: Any, dtype: torch.dtype = torch.bfloat16
                         ) -> GPTConfig:
    """An HF ``LlamaConfig`` (or ``MistralConfig`` / ``Qwen2Config``, or a
    dict of their fields) as the port's :func:`~.gpt.llama_config` preset
    (JAX :74): RMSNorm, SwiGLU, RoPE, GQA where the checkpoint has it, the
    uniform sliding window carried over.  Refuses rope scalings other than
    JAX's four, non-silu MLPs, a decoupled head dim and per-layer mixes of
    full and windowed attention."""
    get = _field(hf_cfg)
    nlayers = get("num_hidden_layers")
    max_pos = get("max_position_embeddings")
    scaling = get("rope_scaling")
    if scaling:
        kind = scaling.get("rope_type", scaling.get("type"))
        if kind == "default":
            scaling = None
        elif kind not in _ROPE_SCALING_TYPES:
            raise NotImplementedError(
                f"rope_scaling={scaling!r} is not supported; "
                f"{_ROPE_SCALING_TYPES} import "
                f"(tensor_parallel.layers._scaled_inv_freq)")
        elif kind == "dynamic" or (
                kind == "yarn"
                and "original_max_position_embeddings" not in scaling):
            # transformers keys dynamic NTK off max_position_embeddings
            # (not any original_max_position_embeddings in the dict), and
            # yarn falls back to it: bake it in
            scaling = dict(scaling, original_max_position_embeddings=max_pos)
    sw = get("sliding_window")
    if sw is not None and not get("use_sliding_window", True):
        sw = None  # Qwen2: the field set, the feature off
    if sw is not None:
        layer_types = get("layer_types")
        if layer_types:
            kinds = set(layer_types)
            if len(kinds) > 1:
                raise NotImplementedError(
                    f"heterogeneous layer_types {kinds}: only uniform "
                    f"sliding-window checkpoints import")
            if kinds == {"full_attention"}:
                sw = None
        else:
            # without layer_types, Qwen2 windows only the layers from
            # max_window_layers on
            mwl = get("max_window_layers")
            if mwl is not None:
                if mwl >= nlayers:
                    sw = None
                elif mwl > 0:
                    raise NotImplementedError(
                        f"max_window_layers={mwl} of {nlayers}: partially "
                        f"windowed checkpoints are not supported")
    act = get("hidden_act", "silu")
    if act not in ("silu", "swish"):
        raise NotImplementedError(
            f"hidden_act={act!r}: the Llama import supports silu-gated "
            f"MLPs only")
    dim, nheads = get("hidden_size"), get("num_attention_heads")
    hd = get("head_dim")
    if hd is not None and hd != dim // nheads:
        raise NotImplementedError(
            f"head_dim={hd} != hidden_size//num_attention_heads="
            f"{dim // nheads}: decoupled head_dim checkpoints are not "
            f"supported")
    kv = get("num_key_value_heads") or nheads
    return llama_config(
        vocab_size=get("vocab_size"), dim=dim, nheads=nheads,
        nlayers=nlayers, max_seq=max_pos,
        kv_heads=None if kv == nheads else kv,
        ffn_hidden=get("intermediate_size"),
        rope_theta=float(get("rope_theta", 10000.0)),
        rope_scaling=dict(scaling) if scaling else None,
        norm_eps=float(get("rms_norm_eps", 1e-5)),
        sliding_window=int(sw) if sw is not None else None, dtype=dtype)


def _stack_blocks(blocks, dtype: torch.dtype) -> Dict[str, Any]:
    """Per-layer block dicts stacked leaf by leaf into ``[L, ...]``."""
    first = blocks[0]
    if isinstance(first, dict):
        return {k: _stack_blocks([b[k] for b in blocks], dtype)
                for k in first}
    return torch.stack(blocks).to(dtype).contiguous()


def from_hf_llama(state_dict: Mapping[str, Any],
                  cfg: Optional[GPTConfig] = None, hf_config: Any = None,
                  dtype: Optional[torch.dtype] = None, device=None
                  ) -> Tuple[GPTConfig, Dict[str, Any]]:
    """HF ``LlamaForCausalLM`` weights as the port's ``(cfg, params)``
    (JAX :179), on ``device`` (default the card).  Pass ``cfg`` or
    ``hf_config`` (an HF config or a dict of its fields, converted by
    :func:`llama_config_from_hf`).  ``state_dict`` maps HF names to torch
    tensors or numpy arrays.  Without ``lm_head.weight`` the head is the
    embedding's transpose (tied embeddings)."""
    if cfg is None:
        if hf_config is None:
            raise ValueError("pass cfg or hf_config")
        cfg = llama_config_from_hf(hf_config, dtype=dtype or torch.bfloat16)
    dev = resolve_device(device)
    dt = dtype or cfg.dtype
    D, L = cfg.dim, cfg.nlayers
    Dkv = cfg.block.kv_head_count * cfg.block.head_dim
    F = cfg.block.ffn_dim

    def get(name):
        return _hf_tensor(state_dict[name], dev)

    def lin(name, out_dim, in_dim):
        w = get(name)
        if tuple(w.shape) != (out_dim, in_dim):
            raise ValueError(f"{name}: shape {tuple(w.shape)}, expected "
                             f"{(out_dim, in_dim)}")
        return w.t()  # torch [out, in] -> the port's [in, out]

    def bias(name, n):
        # attention_bias / mlp_bias checkpoints carry real biases
        return (get(name) if name in state_dict
                else torch.zeros(n, dtype=dt, device=dev))

    blocks = []
    for i in range(L):
        pre = f"model.layers.{i}."
        q = lin(pre + "self_attn.q_proj.weight", D, D)
        k = lin(pre + "self_attn.k_proj.weight", Dkv, D)
        v = lin(pre + "self_attn.v_proj.weight", Dkv, D)
        bq = bias(pre + "self_attn.q_proj.bias", D)
        bk = bias(pre + "self_attn.k_proj.bias", Dkv)
        bv = bias(pre + "self_attn.v_proj.bias", Dkv)
        if cfg.block.is_gqa:
            attn = {"wq": q, "bq": bq, "wkv": torch.stack([k, v]),
                    "bkv": torch.stack([bk, bv])}
        else:
            attn = {"wqkv": torch.stack([q, k, v]),
                    "bqkv": torch.stack([bq, bk, bv])}
        attn["wo"] = lin(pre + "self_attn.o_proj.weight", D, D)
        attn["bo"] = bias(pre + "self_attn.o_proj.bias", D)
        blocks.append({
            "ln1": {"scale": get(pre + "input_layernorm.weight")},
            "attn": attn,
            "ln2": {"scale": get(pre + "post_attention_layernorm.weight")},
            "mlp": {
                "w1": torch.stack([lin(pre + "mlp.gate_proj.weight", F, D),
                                   lin(pre + "mlp.up_proj.weight", F, D)]),
                "b1": torch.stack([bias(pre + "mlp.gate_proj.bias", F),
                                   bias(pre + "mlp.up_proj.bias", F)]),
                "w2": lin(pre + "mlp.down_proj.weight", D, F),
                "b2": bias(pre + "mlp.down_proj.bias", D),
            },
        })
    emb = get("model.embed_tokens.weight")
    head = (get("lm_head.weight").t() if "lm_head.weight" in state_dict
            else emb.t())  # tied embeddings
    params = {
        "tok_emb": emb.to(dt).contiguous(),
        "blocks": _stack_blocks(blocks, dt),
        "ln_f": {"scale": get("model.norm.weight").to(dt).contiguous()},
        "head": head.to(dt).contiguous(),
    }
    return cfg, params


def gpt2_config_from_hf(hf_cfg: Any, dtype: torch.dtype = torch.float32
                        ) -> GPTConfig:
    """An HF ``GPT2Config`` (or a dict of its fields) as the port's GPT
    family (JAX :278): learned positions, LayerNorm, gelu.  Refuses an
    activation other than ``gelu_new`` (the tanh GELU the blocks run) and
    the variants that change the attention's scaling."""
    get = _field(hf_cfg)
    act = get("activation_function", "gelu_new")
    if act != "gelu_new":
        raise NotImplementedError(
            f"activation_function={act!r}: the GPT-2 import matches "
            f"gelu_new only")
    for flag in ("scale_attn_by_inverse_layer_idx", "reorder_and_upcast_attn"):
        if get(flag, False):
            raise NotImplementedError(
                f"{flag}=True changes the attention math; the import "
                f"supports the standard 1/sqrt(hd) scaling only")
    if not get("scale_attn_weights", True):
        raise NotImplementedError(
            "scale_attn_weights=False skips the 1/sqrt(hd) scaling the "
            "blocks always apply")
    n_embd = get("n_embd")
    return GPTConfig(
        vocab_size=get("vocab_size"), dim=n_embd, nheads=get("n_head"),
        nlayers=get("n_layer"), max_seq=get("n_positions"),
        ffn_hidden=get("n_inner") or 4 * n_embd,
        norm_eps=float(get("layer_norm_epsilon", 1e-5)), dtype=dtype)


def from_hf_gpt2(state_dict: Mapping[str, Any],
                 cfg: Optional[GPTConfig] = None, hf_config: Any = None,
                 dtype: Optional[torch.dtype] = None, device=None
                 ) -> Tuple[GPTConfig, Dict[str, Any]]:
    """HF ``GPT2LMHeadModel`` weights as the port's ``(cfg, params)``
    (JAX :313), on ``device`` (default the card).  GPT-2's ``Conv1D``
    weights are already ``[in, out]``; the fused ``c_attn`` ``[D, 3D]``
    splits into the stacked ``[3, D, D]`` ``wqkv``; the head is tied to
    the embedding unless ``lm_head.weight`` is given.  Names with and
    without the ``transformer.`` prefix both load."""
    if cfg is None:
        if hf_config is None:
            raise ValueError("pass cfg or hf_config")
        cfg = gpt2_config_from_hf(hf_config, dtype=dtype or torch.float32)
    dev = resolve_device(device)
    dt = dtype or cfg.dtype
    D, L, F = cfg.dim, cfg.nlayers, cfg.block.ffn_dim

    def get(name, shape=None):
        key = name if name in state_dict else "transformer." + name
        a = _hf_tensor(state_dict[key], dev)
        if shape is not None and tuple(a.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(a.shape)}, expected "
                             f"{shape}")
        return a

    blocks = []
    for i in range(L):
        pre = f"h.{i}."
        ca = get(pre + "attn.c_attn.weight", (D, 3 * D))  # q|k|v columns
        blocks.append({
            "ln1": {"scale": get(pre + "ln_1.weight"),
                    "bias": get(pre + "ln_1.bias")},
            "attn": {
                "wqkv": torch.stack(ca.split(D, dim=1)),  # [3, D, D]
                "bqkv": get(pre + "attn.c_attn.bias").reshape(3, D),
                "wo": get(pre + "attn.c_proj.weight"),
                "bo": get(pre + "attn.c_proj.bias"),
            },
            "ln2": {"scale": get(pre + "ln_2.weight"),
                    "bias": get(pre + "ln_2.bias")},
            "mlp": {
                "w1": get(pre + "mlp.c_fc.weight", (D, F)),
                "b1": get(pre + "mlp.c_fc.bias", (F,)),
                "w2": get(pre + "mlp.c_proj.weight", (F, D)),
                "b2": get(pre + "mlp.c_proj.bias", (D,)),
            },
        })
    emb = get("wte.weight")
    head = (_hf_tensor(state_dict["lm_head.weight"], dev).t()
            if "lm_head.weight" in state_dict else emb.t())
    params = {
        "tok_emb": emb.to(dt).contiguous(),
        "pos_emb": get("wpe.weight").to(dt).contiguous(),
        "blocks": _stack_blocks(blocks, dt),
        "ln_f": {"scale": get("ln_f.weight").to(dt).contiguous(),
                 "bias": get("ln_f.bias").to(dt).contiguous()},
        "head": head.to(dt).contiguous(),
    }
    return cfg, params


def to_hf_llama(params: Dict[str, Any], cfg: GPTConfig
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """:func:`from_hf_llama`'s inverse (JAX :382): a Llama-family tree
    (rms, swiglu, rope) as ``(state_dict, hf_config_kwargs)`` — the
    ``LlamaForCausalLM`` names, each a contiguous tensor in the
    parameters' dtype on their device (the reference hands f32 numpy
    arrays), and the matching ``LlamaConfig`` arguments (rope_theta,
    rope_scaling, rms_norm_eps, the bias flags)::

        sd, kw = to_hf_llama(params, cfg)
        hf = LlamaForCausalLM(LlamaConfig(**kw))
        hf.load_state_dict(sd)

    Nonzero bias leaves export with ``attention_bias`` / ``mlp_bias`` set;
    all-zero ones are dropped.  A windowed config raises: ``LlamaConfig``
    has no sliding window (the same names load into ``MistralConfig``
    with one)."""
    if not (cfg.norm == "rms" and cfg.act == "swiglu" and cfg.pos == "rope"):
        raise ValueError(
            "to_hf_llama exports Llama-family configs only "
            f"(norm={cfg.norm!r}, act={cfg.act!r}, pos={cfg.pos!r})")
    if cfg.sliding_window is not None:
        raise ValueError(
            f"sliding_window={cfg.sliding_window}: LlamaConfig has no "
            f"sliding-window attention; export such trees to a Mistral "
            f"architecture instead (same state-dict names — use these "
            f"weights with transformers.MistralConfig)")

    def a(x):
        return x.detach().contiguous()

    def nonzero(x):
        return bool((x != 0).any())

    blocks = params["blocks"]
    attn_bias = any(nonzero(v) for k, v in blocks["attn"].items()
                    if k.startswith("b"))
    mlp_bias = nonzero(blocks["mlp"]["b1"]) or nonzero(blocks["mlp"]["b2"])
    sd: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": a(params["tok_emb"]),
        "model.norm.weight": a(params["ln_f"]["scale"]),
        "lm_head.weight": a(params["head"].t()),
    }
    at, mlp = blocks["attn"], blocks["mlp"]
    for i in range(cfg.nlayers):
        pre = f"model.layers.{i}."
        if cfg.block.is_gqa:
            q, k, v = at["wq"][i], at["wkv"][i, 0], at["wkv"][i, 1]
            bq, bk, bv = at["bq"][i], at["bkv"][i, 0], at["bkv"][i, 1]
        else:
            q, k, v = (at["wqkv"][i, j] for j in range(3))
            bq, bk, bv = (at["bqkv"][i, j] for j in range(3))
        sd[pre + "self_attn.q_proj.weight"] = a(q.t())
        sd[pre + "self_attn.k_proj.weight"] = a(k.t())
        sd[pre + "self_attn.v_proj.weight"] = a(v.t())
        sd[pre + "self_attn.o_proj.weight"] = a(at["wo"][i].t())
        if attn_bias:
            sd[pre + "self_attn.q_proj.bias"] = a(bq)
            sd[pre + "self_attn.k_proj.bias"] = a(bk)
            sd[pre + "self_attn.v_proj.bias"] = a(bv)
            sd[pre + "self_attn.o_proj.bias"] = a(at["bo"][i])
        sd[pre + "input_layernorm.weight"] = a(blocks["ln1"]["scale"][i])
        sd[pre + "post_attention_layernorm.weight"] = a(
            blocks["ln2"]["scale"][i])
        sd[pre + "mlp.gate_proj.weight"] = a(mlp["w1"][i, 0].t())
        sd[pre + "mlp.up_proj.weight"] = a(mlp["w1"][i, 1].t())
        sd[pre + "mlp.down_proj.weight"] = a(mlp["w2"][i].t())
        if mlp_bias:
            sd[pre + "mlp.gate_proj.bias"] = a(mlp["b1"][i, 0])
            sd[pre + "mlp.up_proj.bias"] = a(mlp["b1"][i, 1])
            sd[pre + "mlp.down_proj.bias"] = a(mlp["b2"][i])
    hf_kwargs: Dict[str, Any] = {
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.dim,
        "intermediate_size": cfg.block.ffn_dim,
        "num_hidden_layers": cfg.nlayers,
        "num_attention_heads": cfg.nheads,
        "num_key_value_heads": cfg.kv_heads or cfg.nheads,
        "max_position_embeddings": cfg.max_seq,
        "rms_norm_eps": cfg.norm_eps,
        "rope_theta": cfg.rope_theta,
        "rope_scaling": dict(cfg.rope_scaling) if cfg.rope_scaling else None,
        "attention_bias": attn_bias,
        "mlp_bias": mlp_bias,
        "tie_word_embeddings": False,
    }
    return sd, hf_kwargs
