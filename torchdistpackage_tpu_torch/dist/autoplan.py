"""The planner: from the cost models to a parallel layout — the port's
``torchdistpackage_tpu/dist/autoplan.py``.

Given a model config and a chip count it

1. **enumerates** candidate plans: factorizations ``dp x tp x pp`` of the
   chip count (``tp`` dividing heads, width, FFN, vocabulary and KV
   heads; ``pp`` dividing the layers), each crossed with the data axis'
   layout (``dp``: parameters replicated; ``fsdp``: sharded by ZeRO's
   first-free-divisible-dim rule, ``parallel.zero.zero_partition_spec``)
   and with the int8 arms (the grads' collective on the data axis, the
   SP boundaries on the tensor axis); an MoE GPT config also crosses an
   expert-parallel factor ``ep | gcd(dp, experts)``;
2. **prunes** the candidates whose modeled resident bytes a card cross
   the OOM-risk line: ``obs.mem_ledger.MemoryModel`` over the plan's
   spec tree (``memory='model'``) or its byte-for-byte mirror over the
   shape table (``'analytic'``, the CLI's); each pruned plan emits a
   ``plan_rejected_oom`` event before anything runs;
3. **scores** the rest by a modeled step time: the 6N + 12LSD compute
   term over a sustained FLOP/s a card (inflated by the pipeline
   schedule's bubble), plus every collective the plan implies priced by
   ``obs.comm_model.CommModel`` (``predict_compressed`` for an int8 arm);
4. **emits** the winner (its axes, layout, compression, spec table and
   score), the ranked alternatives and the pruned ones, a
   ``plan_selected`` event and the RUNREPORT ``autoplan`` section.

The executable side turns a plan into process groups
(:func:`build_groups`, JAX's ``build_mesh``), the port's spec tree
(:func:`plan_param_specs`), this rank's slice of the global batch
(:func:`batch_partition_spec`) and a train step built from the port's
``DataParallel``, ``FSDP``, TP + SP and 1F1B steps
(:func:`make_plan_step`).

Where the port differs from the reference:

- Memory: the port's AdamW keeps its moments in the parameters' dtype
  (``MemoryModel(opt_itemsize=None)``); the reference's are f32.  The
  analytic mirror follows the port (``opt_itemsize=None``), and
  ``opt_itemsize=4`` gives the reference's bytes.
- Compute: without a measured FLOP/s, a recognised card's sustained
  rate is its own measured fraction of peak (:data:`SUSTAINED_FRACTION`),
  not the reference's TPU band.
- The shape table and the spec builders are the port's, held leaf for
  leaf against the JAX package's by the CPU tests.

Host-side math only (no device, no ``transformers``): the CLI
``python -m torchdistpackage_tpu_torch.tools.autoplan`` runs anywhere.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs.comm_model import CommModel
from ..obs.events import emit_event
from ..obs.mem_ledger import headroom_verdict
from ..obs.report import AUTOPLAN_SCHEMA, PLAN_VERDICTS  # noqa: F401

#: Default sustained FLOP/s a card when nothing better is known (no
#: measured step, no recognised card): only the comm terms then order the
#: plans, and the section's basis says so.
ASSUMED_FLOPS = 1e12

#: A recognised card's sustained fraction of its peak bf16 FLOP/s
#: (``obs.telemetry.PEAK_BF16_FLOPS``), by its CUDA name: the port's own
#: measured MFU.  H100 80GB HBM3 at 700 W: GPT-125M training at
#: ``bench.py``'s default (batch 16, S 2048, remat 'flash') ran at MFU
#: 0.1701-0.1709 in ``chip_smoke.py``'s ``train_phase`` (PERF.md section
#: 5); the low end is kept.
SUSTAINED_FRACTION: Dict[str, float] = {"NVIDIA H100 80GB HBM3": 0.1701}

_ITEMSIZE = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
             "int8": 1, "uint8": 1, "int32": 4, "int64": 8}


def _itemsize(dtype: Any) -> int:
    """Bytes an element of ``dtype``: a ``torch.dtype``, a numpy dtype or
    a name (``'bfloat16'``, ``'torch.bfloat16'``)."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    name = str(dtype).split(".")[-1]
    if name in _ITEMSIZE:
        return _ITEMSIZE[name]
    return int(np.dtype(dtype).itemsize)


# --------------------------------------------------------- model description


@dataclasses.dataclass(frozen=True)
class ModelDims:
    """The config's dims the shape table and the FLOP formula need, from
    a ``GPTConfig``, a ``TransformerConfig`` or a dict (the CLI's JSON)
    by :func:`model_dims` (JAX :85)."""

    family: str  # 'gpt' (embedding + blocks + head) | 'transformer'
    dim: int
    nheads: int
    nlayers: int
    seq: int
    vocab: Optional[int] = None
    ffn: int = 0
    kv_heads: Optional[int] = None
    act: str = "gelu"
    norm: str = "layer"
    pos: str = "learned"
    dtype_size: int = 4
    # MoE (0 experts: dense): every moe_every-th block's FFN is an expert
    # layer; the expert FLOP term carries top_k * capacity_factor / experts
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_every: int = 2
    moe_capacity_factor: float = 1.25

    @property
    def n_moe_layers(self) -> int:
        """Expert blocks in the stack: ``L // moe_every``."""
        if not self.moe_experts:
            return 0
        return self.nlayers // max(self.moe_every, 1)


def model_dims(config: Any) -> ModelDims:
    """A GPTConfig / TransformerConfig / dict as :class:`ModelDims`
    (JAX :120); an MoE config needs the GPT family."""
    get = (config.get if isinstance(config, dict)
           else lambda k, d=None: getattr(config, k, d))
    moe_experts = int(get("moe_experts", 0) or 0)
    if moe_experts and not get("vocab_size"):
        raise ValueError(
            "MoE planning needs the gpt family (gpt_moe) — the "
            "transformer family has no expert blocks")
    dim = int(get("dim"))
    ffn = get("ffn_hidden") or dim * int(get("ffn_mult", 4))
    vocab = get("vocab_size")
    seq = get("max_seq") or get("seq") or 0
    kv = get("kv_heads")
    return ModelDims(
        family="gpt" if vocab else "transformer",
        dim=dim,
        nheads=int(get("nheads")),
        nlayers=int(get("nlayers")),
        seq=int(seq),
        vocab=int(vocab) if vocab else None,
        ffn=int(ffn),
        kv_heads=int(kv) if kv else None,
        act=str(get("act", "gelu")),
        norm=str(get("norm", "layer")),
        pos=str(get("pos", "learned")),
        dtype_size=_itemsize(get("dtype", "float32")),
        moe_experts=moe_experts,
        moe_top_k=int(get("moe_top_k", 2) or 2),
        moe_every=int(get("moe_every", 2) or 2),
        moe_capacity_factor=float(get("moe_capacity_factor", 1.25) or 1.25),
    )


@dataclasses.dataclass(frozen=True)
class LeafRow:
    """One leaf of the shape table (JAX :163): ``tp_dim`` / ``stack_dim``
    / ``ep_dim`` the dims the tensor / pipe / ep axes split (None:
    replicated there); ``count`` multiplies the leaf (per-layer leaves);
    ``matmul`` counts it in 6N; ``flop_weight`` scales its FLOPs (an
    expert leaf: ``top_k * capacity_factor / experts``)."""

    path: str
    shape: Tuple[int, ...]
    tp_dim: Optional[int] = None
    stack_dim: Optional[int] = None
    count: int = 1
    matmul: bool = True
    ep_dim: Optional[int] = None
    flop_weight: float = 1.0


def _norm_rows(d: ModelDims, prefix: str) -> List[LeafRow]:
    rows = [LeafRow(f"{prefix}.scale", (d.dim,))]
    if d.norm == "layer":
        rows.append(LeafRow(f"{prefix}.bias", (d.dim,)))
    return rows


def _block_rows(d: ModelDims) -> List[LeafRow]:
    """One block's leaves with their TP dims: the table
    ``parallel.tensor_parallel.layers.init_block_params`` and
    ``TP_SPLIT_DIMS`` give."""
    D, F = d.dim, d.ffn
    rows = _norm_rows(d, "ln1") + _norm_rows(d, "ln2")
    if d.kv_heads and d.kv_heads != d.nheads:
        dkv = d.kv_heads * (D // d.nheads)
        rows += [LeafRow("attn.wq", (D, D), tp_dim=1),
                 LeafRow("attn.bq", (D,), tp_dim=0),
                 LeafRow("attn.wkv", (2, D, dkv), tp_dim=2),
                 LeafRow("attn.bkv", (2, dkv), tp_dim=1)]
    else:
        rows += [LeafRow("attn.wqkv", (3, D, D), tp_dim=2),
                 LeafRow("attn.bqkv", (3, D), tp_dim=1)]
    rows += [LeafRow("attn.wo", (D, D), tp_dim=0), LeafRow("attn.bo", (D,))]
    if d.act == "swiglu":
        rows += [LeafRow("mlp.w1", (2, D, F), tp_dim=2),
                 LeafRow("mlp.b1", (2, F), tp_dim=1)]
    else:
        rows += [LeafRow("mlp.w1", (D, F), tp_dim=1),
                 LeafRow("mlp.b1", (F,), tp_dim=0)]
    rows += [LeafRow("mlp.w2", (F, D), tp_dim=0), LeafRow("mlp.b2", (D,))]
    return rows


def _moe_rows(d: ModelDims, count: int) -> List[LeafRow]:
    """An expert block's ``moe`` leaves (``parallel.moe``): the router
    replicated, the stacked experts split on E over ``ep``."""
    D, F, E = d.dim, d.ffn, d.moe_experts
    w = d.moe_top_k * d.moe_capacity_factor / E
    up = ((("moe.experts.w1", (E, 2, D, F)), ("moe.experts.b1", (E, 2, F)))
          if d.act == "swiglu" else
          (("moe.experts.w1", (E, D, F)), ("moe.experts.b1", (E, F))))
    rows = [LeafRow("moe.router.w", (D, E), count=count)]
    for path, shape in up + (("moe.experts.w2", (E, F, D)),
                             ("moe.experts.b2", (E, D))):
        rows.append(LeafRow(path, shape, ep_dim=0, count=count,
                            flop_weight=w))
    return rows


def param_table(d: ModelDims) -> List[LeafRow]:
    """The model's whole shape table (JAX :257): GPT's block leaves
    stacked on a leading ``[L]`` dim (``stack_dim`` 0, the dim ``pipe``
    splits); the transformer family's and an MoE GPT's blocks per layer
    (``count``)."""
    rows: List[LeafRow] = []
    if d.family == "gpt":
        rows.append(LeafRow("tok_emb", (d.vocab, d.dim), tp_dim=0,
                            matmul=False))
        if d.pos == "learned":
            rows.append(LeafRow("pos_emb", (d.seq, d.dim), matmul=False))
        if d.moe_experts:
            n_moe = d.n_moe_layers
            n_dense = d.nlayers - n_moe
            brows = _block_rows(d)
            if n_dense:
                rows += [dataclasses.replace(
                    r, path=f"blocks[dense].{r.path}", count=n_dense)
                    for r in brows]
            rows += [dataclasses.replace(
                r, path=f"blocks[moe].{r.path}", count=n_moe)
                for r in brows if not r.path.startswith("mlp.")]
            rows += [dataclasses.replace(r, path=f"blocks[moe].{r.path}")
                     for r in _moe_rows(d, count=n_moe)]
        else:
            rows += [LeafRow(
                f"blocks.{r.path}", (d.nlayers, *r.shape),
                tp_dim=None if r.tp_dim is None else r.tp_dim + 1,
                stack_dim=0) for r in _block_rows(d)]
        rows.append(LeafRow("head", (d.dim, d.vocab), tp_dim=1))
    else:
        rows += [dataclasses.replace(r, path=f"blocks.{r.path}",
                                     count=d.nlayers)
                 for r in _block_rows(d)]
    return rows + _norm_rows(d, "ln_f")


def flops_per_token(d: ModelDims) -> float:
    """``bench.py``'s 6N + 12LSD (JAX :302): 6 FLOPs a matmul parameter a
    token (the embedding tables are gathers) plus the attention's score
    and value products; expert leaves at their ``flop_weight``."""
    n_matmul = sum(
        r.count * r.flop_weight * int(np.prod(r.shape, dtype=np.int64))
        for r in param_table(d) if r.matmul)
    return 6.0 * n_matmul + 12.0 * d.nlayers * d.seq * d.dim


# --------------------------------------------------------------- candidates


def _divisors(n: int) -> List[int]:
    return [k for k in range(1, n + 1) if n % k == 0]


def _tp_ok(d: ModelDims, tp: int) -> bool:
    if tp == 1:
        return True
    if d.nheads % tp or d.dim % tp or d.ffn % tp:
        return False
    if d.vocab and d.vocab % tp:
        return False
    return not (d.kv_heads and d.kv_heads % tp)


def candidate_key(c: Dict[str, Any]) -> str:
    """``dp4`` / ``fsdp2·tp2`` / ``dp2·ep2`` / ``dp1·pp4`` (+``gc8`` /
    ``+ac8`` for the int8 arms), as the reference names them."""
    parts = [f"{'fsdp' if c['layout'] == 'fsdp' else 'dp'}{c['dp']}"]
    if c.get("ep", 1) > 1:
        parts.append(f"ep{c['ep']}")
    if c["tp"] > 1:
        parts.append(f"tp{c['tp']}")
    if c["pp"] > 1:
        parts.append(f"pp{c['pp']}")
    key = "·".join(parts)
    if c["compress"]["grads"]:
        key += "+gc8"
    if c["compress"]["acts"]:
        key += "+ac8"
    return key


def enumerate_candidates(
    d: ModelDims,
    n_chips: int,
    global_batch: int,
    allow_pp: bool = True,
    executable_only: bool = False,
    compression: bool = True,
    layouts: Sequence[str] = ("dp", "fsdp"),
) -> List[Dict[str, Any]]:
    """Every legal ``dp x tp x pp`` of ``n_chips`` crossed with the layout
    and the int8 arms, in a fixed order (JAX :351).  ``dp`` must divide
    the batch, so pure DP always remains.  ``executable_only``: the plans
    the reference's timed runners execute (int8 only on the pure-dp arm,
    ``pp > 1`` only with the ``dp`` layout), which :func:`make_plan_step`
    also builds.  MoE configs: an ``ep`` factor of ``dp`` dividing the
    expert count, ``pp`` 1, the ``dp`` layout, no int8 arms."""
    out: List[Dict[str, Any]] = []
    moe = d.moe_experts > 0
    for pp in _divisors(n_chips):
        if pp > 1 and (
                not allow_pp or d.family != "gpt" or d.nlayers % pp or moe):
            continue
        for tp in _divisors(n_chips // pp):
            if not _tp_ok(d, tp):
                continue
            dp = n_chips // pp // tp
            if global_batch % dp:
                continue
            arm_layouts = [
                l for l in layouts if l == "dp" or (l == "fsdp" and dp > 1)]
            if moe or (executable_only and pp > 1):
                arm_layouts = [l for l in arm_layouts if l == "dp"]
            ep_arms = ([e for e in _divisors(dp) if d.moe_experts % e == 0]
                       if moe else [1])
            for layout in arm_layouts:
                can_gq = compression and dp > 1 and not moe and not (
                    executable_only and (tp > 1 or pp > 1
                                         or layout == "fsdp"))
                grad_arms = (False, True) if can_gq else (False,)
                act_arms = (False, True) if (
                    compression and tp > 1 and not moe
                    and not executable_only) else (False,)
                for gq in grad_arms:
                    for aq in act_arms:
                        for ep in ep_arms:
                            c: Dict[str, Any] = {
                                "dp": dp, "tp": tp, "pp": pp,
                                "layout": layout,
                                "mesh_axes": {"pipe": pp, "data": dp,
                                              "tensor": tp},
                                "compress": {"grads": gq, "acts": aq},
                            }
                            if moe:
                                c["ep"] = ep
                                c["mesh_axes"] = {
                                    "pipe": pp, "data": dp // ep,
                                    "ep": ep, "tensor": tp}
                            out.append(c)
    for c in out:
        c["key"] = candidate_key(c)
    return out


# ----------------------------------------------------------------- sharding


def _first_free_dim(shape: Sequence[int], entries: Sequence[Optional[str]],
                    n: int) -> int:
    """ZeRO's rule (``parallel.zero.zero_partition_spec``) over a leaf
    whose dims ``entries`` already assigns: the first unassigned dim that
    ``n`` divides, -1 when none does."""
    for dim, (size, used) in enumerate(zip(shape, entries)):
        if used is None and size > 0 and size % n == 0:
            return dim
    return -1


def _axis_assignment(row: LeafRow, c: Dict[str, Any]
                     ) -> List[Optional[str]]:
    """Each dim's axis for one leaf under plan ``c`` (JAX :431): the
    pipe, ep and tensor dims from the table, then under ``fsdp`` the data
    axis on the first free dim ``dp`` divides."""
    entries: List[Optional[str]] = [None] * len(row.shape)
    if c["pp"] > 1 and row.stack_dim is not None:
        entries[row.stack_dim] = "pipe"
    if c.get("ep", 1) > 1 and row.ep_dim is not None:
        entries[row.ep_dim] = "ep"
    if c["tp"] > 1 and row.tp_dim is not None:
        entries[row.tp_dim] = "tensor"
    if c["layout"] == "fsdp" and c["dp"] > 1:
        dim = _first_free_dim(row.shape, entries, c["dp"])
        if dim >= 0:
            entries[dim] = "data"
    return entries


def _leaf_shards(row: LeafRow, c: Dict[str, Any]) -> int:
    return math.prod(c["mesh_axes"][a] for a in _axis_assignment(row, c)
                     if a is not None)


def _spec_str(entries: Sequence[Optional[str]]) -> str:
    trimmed = list(entries)
    while trimmed and trimmed[-1] is None:
        trimmed.pop()
    return "P(" + ", ".join(a or "None" for a in trimmed) + ")"


def spec_table(d: ModelDims, c: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Each leaf's rendered spec and shard count under plan ``c`` (JAX
    :468): the emitted plan's ``param_specs``."""
    return [{"path": r.path, "shape": list(r.shape),
             "spec": _spec_str(_axis_assignment(r, c)),
             "shard_count": _leaf_shards(r, c)} for r in param_table(d)]


# ------------------------------------------------------------------- memory


def estimate_memory_analytic(
    d: ModelDims,
    c: Dict[str, Any],
    global_batch: int,
    seq_len: Optional[int] = None,
    capacity_bytes: Optional[int] = None,
    optimizer_slots: int = 2,
    act_factor: float = 1.0,
    opt_itemsize: Optional[int] = None,
) -> Dict[str, Any]:
    """Resident bytes a card from the shape table (JAX :486), equal byte
    for byte to :func:`estimate_memory_model` (the CPU tests hold the
    two): each leaf's elements over its spec's shard product (rounded
    up), grads as the params, ``optimizer_slots`` moments of
    ``opt_itemsize`` bytes an element (None: the parameters' dtype, the
    port's AdamW; 4: the reference's f32 moments), and ``B_local S D L
    act_factor`` activations in the config dtype."""
    params_bytes = elems_resident = 0
    for r in param_table(d):
        resident = -(-int(np.prod(r.shape, dtype=np.int64))
                     // _leaf_shards(r, c))
        params_bytes += r.count * resident * d.dtype_size
        elems_resident += r.count * resident
    grads_bytes = params_bytes
    opt_bytes = optimizer_slots * elems_resident * (opt_itemsize
                                                    or d.dtype_size)
    S = seq_len if seq_len is not None else d.seq
    act_bytes = int((global_batch // c["dp"]) * S * d.dim * d.nlayers
                    * act_factor * d.dtype_size)
    total = params_bytes + grads_bytes + opt_bytes + act_bytes
    hv = headroom_verdict(total, capacity_bytes)
    return {"params_bytes": params_bytes, "grads_bytes": grads_bytes,
            "opt_bytes": opt_bytes, "act_bytes": act_bytes,
            "total_bytes": total, "capacity_bytes": capacity_bytes,
            "frac": hv["frac"], "headroom_frac": hv["headroom_frac"],
            "verdict": hv["verdict"], "basis": "analytic"}


def estimate_memory_model(
    config: Any,
    c: Dict[str, Any],
    global_batch: int,
    seq_len: Optional[int] = None,
    capacity_bytes: Optional[int] = None,
    optimizer_slots: int = 2,
    act_factor: float = 1.0,
    opt_itemsize: Optional[int] = None,
) -> Dict[str, Any]:
    """``MemoryModel.estimate`` over the plan's spec tree
    (:func:`plan_param_specs`) and its axis sizes (JAX :540): the model
    that judges a live run judges the plan, before anything runs."""
    from ..obs.mem_ledger import MemoryModel

    est = MemoryModel(
        capacity_bytes=capacity_bytes, optimizer_slots=optimizer_slots,
        opt_itemsize=opt_itemsize, act_factor=act_factor,
    ).estimate(config, c["mesh_axes"], plan_param_specs(c, config),
               batch_per_device=global_batch // c["dp"], seq_len=seq_len)
    est = {k: est[k] for k in (
        "params_bytes", "grads_bytes", "opt_bytes", "act_bytes",
        "total_bytes", "capacity_bytes", "frac", "headroom_frac",
        "verdict")}
    est["basis"] = "memory-model"
    return est


# ------------------------------------------------------------------ scoring


def _grad_payload_bytes(d: ModelDims, c: Dict[str, Any]) -> float:
    """Grad bytes a card entering the data axis' collective: each leaf's
    bytes after its tensor / pipe / ep shards (JAX :575); the fsdp shard
    is the collective's output."""
    total = 0
    for r in param_table(d):
        shards = math.prod(c["mesh_axes"][a]
                           for a in _axis_assignment(r, c)
                           if a in ("tensor", "pipe", "ep"))
        total += (r.count * -(-int(np.prod(r.shape, dtype=np.int64))
                              // shards) * d.dtype_size)
    return float(total)


def comm_terms(
    d: ModelDims,
    c: Dict[str, Any],
    global_batch: int,
    model: CommModel,
    seq_len: Optional[int] = None,
    microbatches: int = 8,
) -> List[Dict[str, Any]]:
    """The collectives a step of plan ``c`` runs, each priced by ``model``
    (JAX :591): op, axes, the full payload (``CommModel.predict``'s
    convention), the count a step, per-op and total seconds, and for an
    int8 arm the ``predict_compressed`` verdict."""
    S = seq_len if seq_len is not None else d.seq
    dp, tp, pp = c["dp"], c["tp"], c["pp"]
    terms: List[Dict[str, Any]] = []

    def price(name, op, axes, n, payload, count, compressed):
        if n <= 1 or payload <= 0 or count <= 0:
            return
        row: Dict[str, Any] = {
            "name": name, "op": op, "axes": list(axes), "n": int(n),
            "payload_bytes": int(payload), "count": int(count),
            "compressed": bool(compressed),
        }
        if compressed:
            rec = model.predict_compressed(
                op, payload, n, axes=axes, elem_bytes=d.dtype_size)
            row["per_op_s"] = rec["compressed_s"]
            row["model_approves"] = rec["compress"]
            row["basis"] = rec["basis"]
            row["exact_s"] = rec["exact_s"]
        else:
            row["per_op_s"] = model.predict(op, payload, n, axes=axes)
        row["total_s"] = row["per_op_s"] * count
        terms.append(row)

    gq = c["compress"]["grads"]
    grad_bytes = _grad_payload_bytes(d, c)
    if dp > 1:
        if c["layout"] == "fsdp":
            # ZeRO-3: the parameters' gather in the forward and again in
            # the backward, the grads' reduce-scatter
            price("fsdp-param-gather", "all_gather", ("data",), dp,
                  grad_bytes, 2, gq)
            price("fsdp-grad-scatter", "reduce_scatter", ("data",), dp,
                  grad_bytes, 1, gq)
        else:
            price("dp-grad-reduce", "all_reduce", ("data",), dp,
                  grad_bytes, 1, gq)
    if tp > 1:
        # SP boundaries: 2 gathers and 2 scatters a block's forward, the
        # transposed pair in the backward: 4 of each a layer a step
        act_bytes = (global_batch // dp) * S * d.dim * d.dtype_size
        aq = c["compress"]["acts"]
        price("sp-act-gather", "all_gather", ("tensor",), tp, act_bytes,
              4 * d.nlayers, aq)
        price("sp-act-scatter", "reduce_scatter", ("tensor",), tp,
              act_bytes, 4 * d.nlayers, aq)
    if pp > 1:
        # 1F1B's critical path: about 2 (M + P - 2) transfers of one
        # microbatch's boundary activation
        micro_act = ((global_batch // dp) / microbatches) * S * d.dim \
            * d.dtype_size
        price("pp-boundary", "ppermute", ("pipe",), pp, micro_act,
              2 * (microbatches + pp - 2), False)
    ep = c.get("ep", 1)
    if ep > 1:
        # the EP exchange: each MoE layer all-to-alls its capacity-padded
        # rows there and back, forward and backward: 4 a layer a step
        a2a = int((global_batch // dp) * S * d.moe_top_k
                  * d.moe_capacity_factor * d.dim * d.dtype_size)
        price("moe-all-to-all", "all_to_all", ("ep",), ep, a2a,
              4 * d.n_moe_layers, False)
    return terms


def score_candidate(
    d: ModelDims,
    c: Dict[str, Any],
    global_batch: int,
    model: CommModel,
    effective_flops: float,
    fpt: float,
    seq_len: Optional[int] = None,
    microbatches: int = 8,
) -> Dict[str, Any]:
    """Modeled step time (JAX :673): the compute term (FLOPs over the
    sustained FLOP/s a card, times the pipeline schedule's inflation for
    ``pp > 1``: the cheaper of 1F1B and zero-bubble, recorded with its
    bubble fraction) plus the comm terms, serialised."""
    from ..obs.aggregate import (
        pipeline_bubble_fraction,
        pipeline_time_inflation,
    )

    S = seq_len if seq_len is not None else d.seq
    n_chips = c["dp"] * c["tp"] * c["pp"]
    flops_step = fpt * global_batch * S
    if c["pp"] > 1:
        inflations = {s: pipeline_time_inflation(microbatches, c["pp"],
                                                 schedule=s)
                      for s in ("1f1b", "zb")}
        pp_schedule = min(inflations, key=inflations.get)
        inflation = inflations[pp_schedule]
        bubble = pipeline_bubble_fraction(microbatches, c["pp"],
                                          schedule=pp_schedule)
    else:
        pp_schedule, inflation, bubble = None, 1.0, 0.0
    compute_s = flops_step / n_chips / effective_flops * inflation
    terms = comm_terms(d, c, global_batch, model, seq_len=S,
                       microbatches=microbatches)
    comm_s = sum(t["total_s"] for t in terms)
    return {"compute_s": compute_s, "comm_s": comm_s,
            "step_s": compute_s + comm_s,
            "bubble_fraction": round(bubble, 4),
            "pp_schedule": pp_schedule, "terms": terms}


# --------------------------------------------------------------- the planner


def _resolve_effective_flops(effective_flops: Optional[float],
                             device_kind: Optional[str]
                             ) -> Tuple[float, str]:
    """``(sustained FLOP/s a card, basis)``: the caller's measured value;
    else a recognised card's peak times its own measured fraction
    (:data:`SUSTAINED_FRACTION`); else :data:`ASSUMED_FLOPS`."""
    if effective_flops:
        return float(effective_flops), "measured"
    if device_kind:
        from ..obs.telemetry import peak_flops_for

        peak = peak_flops_for(device_kind)
        frac = SUSTAINED_FRACTION.get(device_kind)
        if peak and frac:
            return frac * peak, f"peak-table@{frac}"
    return ASSUMED_FLOPS, "assumed"


def plan(
    config: Any,
    n_chips: int,
    global_batch: int,
    seq_len: Optional[int] = None,
    comm_model: Optional[CommModel] = None,
    capacity_bytes: Optional[int] = None,
    effective_flops: Optional[float] = None,
    fpt: Optional[float] = None,
    optimizer_slots: int = 2,
    act_factor: float = 1.0,
    microbatches: int = 8,
    allow_pp: bool = True,
    executable_only: bool = False,
    compression: bool = True,
    layouts: Sequence[str] = ("dp", "fsdp"),
    memory: str = "auto",
    device_kind: Optional[str] = None,
    top: int = 8,
    emit: bool = True,
    opt_itemsize: Optional[int] = None,
) -> Dict[str, Any]:
    """Plan ``config``'s parallelism on ``n_chips`` cards (JAX :734).

    Returns the RUNREPORT ``autoplan`` section: ``chosen`` (the winner:
    axes, layout, compression, rendered specs, score and memory),
    ``ranked`` (the ``top`` best, per-term breakdown on the first),
    ``pruned`` and ``n_pruned_oom``, the ``basis`` of each cost and the
    ``verdict`` (``ok`` | ``all_oom``).

    - ``comm_model``: default the table model of ``device_kind``
      (``CommModel.from_defaults``; an unknown device without one).
    - ``effective_flops``: sustained FLOP/s a card, e.g. what a measured
      step implies; default :func:`_resolve_effective_flops`.
    - ``fpt``: FLOPs a token; default :func:`flops_per_token`.
    - ``memory``: ``'model'`` (``MemoryModel`` over the plan's spec tree),
      ``'analytic'`` (the shape table), ``'auto'`` (model for a config
      object, analytic for a dict).
    - ``opt_itemsize``: bytes a moment element (None: the parameters'
      dtype, the port's AdamW; 4: the reference's f32 moments).
    - ``emit``: ``plan_rejected_oom`` for each pruned plan and one
      ``plan_selected`` on the default event log."""
    d = model_dims(config)
    if global_batch < 1:
        raise ValueError(f"global_batch must be >= 1, got {global_batch}")
    if memory not in ("auto", "model", "analytic"):
        raise ValueError(f"memory must be auto|model|analytic, got {memory!r}")
    use_model = memory == "model" or (memory == "auto"
                                      and not isinstance(config, dict))
    model = comm_model or CommModel.from_defaults(
        device_kind=device_kind or "unknown")
    fpt_val = float(fpt) if fpt else flops_per_token(d)
    eff, compute_basis = _resolve_effective_flops(effective_flops,
                                                  device_kind)
    mem_kw = dict(seq_len=seq_len, capacity_bytes=capacity_bytes,
                  optimizer_slots=optimizer_slots, act_factor=act_factor,
                  opt_itemsize=opt_itemsize)

    cands = enumerate_candidates(
        d, n_chips, global_batch, allow_pp=allow_pp,
        executable_only=executable_only, compression=compression,
        layouts=layouts)
    ranked: List[Dict[str, Any]] = []
    pruned: List[Dict[str, Any]] = []
    for c in cands:
        mem = (estimate_memory_model(config, c, global_batch, **mem_kw)
               if use_model else
               estimate_memory_analytic(d, c, global_batch, **mem_kw))
        if mem["verdict"] == "oom_risk":
            row = {"key": c["key"], "total_bytes": mem["total_bytes"],
                   "capacity_bytes": mem["capacity_bytes"],
                   "frac": mem["frac"]}
            pruned.append(row)
            if emit:
                emit_event("plan_rejected_oom", **row)
            continue
        score = score_candidate(d, c, global_batch, model, eff, fpt_val,
                                seq_len=seq_len, microbatches=microbatches)
        ranked.append({**c, **score, "memory": mem})
    ranked.sort(key=lambda r: (r["step_s"], r["key"]))

    chosen = None
    if ranked:
        chosen = dict(ranked[0])
        chosen["param_specs"] = spec_table(d, chosen)[:64]
        if emit:
            emit_event("plan_selected", key=chosen["key"],
                  modeled_step_s=chosen["step_s"], n_candidates=len(cands),
                  n_pruned_oom=len(pruned))
    return {
        "schema": AUTOPLAN_SCHEMA,
        "verdict": "ok" if chosen else "all_oom",
        "n_candidates": len(cands),
        "n_pruned_oom": len(pruned),
        "pruned": pruned[:16],
        "chosen": chosen,
        "ranked": [{k: v for k, v in r.items() if k != "terms"} if i else r
                   for i, r in enumerate(ranked[:top])],
        "params": {"n_chips": n_chips, "global_batch": global_batch,
                   "seq_len": seq_len if seq_len is not None else d.seq,
                   "family": d.family, "microbatches": microbatches},
        "basis": {"comm": model.source, "compute": compute_basis,
                  "memory": "memory-model" if use_model else "analytic",
                  "flops_per_token": fpt_val, "effective_flops": eff},
    }


PREFILL_PLAN_SCHEMA = "autoplan-prefill-v1"


def plan_prefill_tier(
    config: Any,
    *,
    context_len: int,
    chunk: int,
    block_size: int,
    num_blocks: Optional[int] = None,
    cp_widths: Sequence[int] = (1, 2, 4, 8),
    batch: int = 1,
    comm_model: Optional[CommModel] = None,
    device_kind: Optional[str] = None,
    capacity_bytes: Optional[int] = None,
    effective_flops: Optional[float] = None,
    emit: bool = True,
) -> Dict[str, Any]:
    """Size a CP prefill tier (JAX :869): for each ring width the modeled
    TTFT of one ``context_len``-token prompt (the chunks' forward compute
    split ``cp`` ways plus every ring hop through the ``ppermute`` row,
    at the payloads of ``ops.ring_paged.ring_hops_per_chunk`` /
    ``ring_chunk_bytes``) and the memory verdict a rank (its pool slice
    plus the ring's working set, ``headroom_verdict``).  Ranked by
    ``ttft_s`` among the arms that fit; a width that does not divide
    ``chunk`` is skipped.  Compute and hops add serially."""
    from ..ops.ring_paged import (
        modeled_cp_working_set_bytes,
        ring_chunk_bytes,
        ring_hops_per_chunk,
    )

    if context_len < 1 or chunk < 1 or block_size < 1:
        raise ValueError(
            f"context_len/chunk/block_size must be >= 1, got "
            f"{context_len}/{chunk}/{block_size}")
    d = model_dims(config)
    kv_heads = d.kv_heads or d.nheads
    head_dim = d.dim // d.nheads
    model = comm_model or CommModel.from_defaults(
        device_kind=device_kind or "unknown")
    eff, compute_basis = _resolve_effective_flops(effective_flops,
                                                  device_kind)
    # forward only: 6N + 12LSD counts the forward and a backward twice it
    fpt = flops_per_token(d) / 3.0
    n_chunks = -(-context_len // chunk)
    nb_base = (num_blocks if num_blocks is not None
               else 1 + batch * -(-context_len // block_size))

    ranked: List[Dict[str, Any]] = []
    pruned: List[Dict[str, Any]] = []
    skipped: List[int] = []
    for cp in sorted({int(w) for w in cp_widths}):
        if cp < 1 or chunk % cp:
            skipped.append(cp)
            continue
        nb = -(-nb_base // cp) * cp  # the engine's rounding
        nb_local = nb // cp
        pool = (2 * d.nlayers * nb * kv_heads * block_size * head_dim
                * d.dtype_size)
        mem_bytes = pool // cp + modeled_cp_working_set_bytes(
            kv_heads=kv_heads, head_dim=head_dim, block_size=block_size,
            nb_local=nb_local, chunk=chunk, cp=cp, batch=batch,
            itemsize=d.dtype_size)
        verdict = headroom_verdict(mem_bytes, capacity_bytes)
        compute_s = fpt * context_len / (cp * eff)
        terms: List[Dict[str, Any]] = [{
            "name": "prefill-compute", "op": "matmul", "axes": [],
            "n": cp, "count": n_chunks, "total_s": compute_s}]
        ring_s = 0.0
        if cp > 1:
            fresh = (batch * kv_heads * (chunk // cp) * head_dim
                     * d.dtype_size)
            pool_slice = (nb_local * kv_heads * block_size * head_dim
                          * d.dtype_size)
            for name, payload in (("cp-ring-fresh", fresh),
                                  ("cp-ring-pool", pool_slice)):
                per_op = model.predict("ppermute", payload, cp,
                                       axes=("context",))
                count = n_chunks * 2 * (cp - 1) * d.nlayers
                terms.append({
                    "name": name, "op": "ppermute", "axes": ["context"],
                    "n": cp, "payload_bytes": int(payload), "count": count,
                    "per_op_s": per_op, "total_s": per_op * count})
                ring_s += per_op * count
        row = {
            "key": f"cp{cp}", "cp": cp, "num_blocks": nb,
            "ttft_s": compute_s + ring_s, "compute_s": compute_s,
            "ring_s": ring_s,
            "ring_hops": n_chunks * ring_hops_per_chunk(d.nlayers, cp),
            "ring_bytes": n_chunks * ring_chunk_bytes(
                nlayers=d.nlayers, cp=cp, batch=batch, kv_heads=kv_heads,
                head_dim=head_dim, chunk=chunk, nb_local=nb_local,
                block_size=block_size, itemsize=d.dtype_size),
            "mem_bytes": mem_bytes, "memory": verdict, "terms": terms,
        }
        if verdict["verdict"] == "oom_risk":
            prow = {"key": row["key"], "total_bytes": mem_bytes,
                    "capacity_bytes": capacity_bytes,
                    "frac": verdict["frac"]}
            pruned.append(prow)
            if emit:
                emit_event("plan_rejected_oom", **prow)
            continue
        ranked.append(row)
    ranked.sort(key=lambda r: (r["ttft_s"], r["key"]))

    chosen = dict(ranked[0]) if ranked else None
    if chosen and emit:
        emit_event("plan_selected", key=chosen["key"],
              modeled_step_s=chosen["ttft_s"],
              n_candidates=len(ranked) + len(pruned),
              n_pruned_oom=len(pruned))
    return {
        "schema": PREFILL_PLAN_SCHEMA,
        "verdict": "ok" if chosen else "all_oom",
        "n_candidates": len(ranked) + len(pruned),
        "n_pruned_oom": len(pruned),
        "skipped_widths": skipped,
        "pruned": pruned,
        "chosen": chosen,
        "ranked": [{k: v for k, v in r.items() if k != "terms"} if i else r
                   for i, r in enumerate(ranked)],
        "params": {"context_len": context_len, "chunk": chunk,
                   "block_size": block_size, "batch": batch,
                   "family": d.family},
        "basis": {"comm": model.source, "compute": compute_basis,
                  "flops_per_token_fwd": fpt, "effective_flops": eff,
                  "overlap": "serial (compute + ring summed; ROADMAP 5c)"},
    }


def attach_measured(result: Dict[str, Any],
                    rows: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Record measured step times of some ranked plans as the section's
    ``modeled_vs_measured`` (JAX :1053): per plan the modeled and
    measured seconds and their relative error, both orders, and whether
    they agree.  ``rows``: dicts of ``key``, ``modeled_step_s``,
    ``measured_step_s`` (pp rows may carry ``pp_schedule``,
    ``modeled_bubble_fraction``, ``measured_bubble_fraction``,
    ``microbatches``, passed through)."""
    out_rows = []
    for r in rows:
        mo, me = float(r["modeled_step_s"]), float(r["measured_step_s"])
        out_rows.append({
            "key": r["key"], "modeled_step_s": mo, "measured_step_s": me,
            "rel_err": round((mo - me) / me, 4) if me > 0 else None})
        for extra in ("pp_schedule", "modeled_bubble_fraction",
                      "measured_bubble_fraction", "microbatches"):
            if extra in r:
                out_rows[-1][extra] = r[extra]
    modeled = [r["key"] for r in sorted(out_rows,
                                        key=lambda r: r["modeled_step_s"])]
    measured = [r["key"] for r in sorted(
        out_rows, key=lambda r: r["measured_step_s"])]
    result["modeled_vs_measured"] = {
        "rows": out_rows, "modeled_order": modeled,
        "measured_order": measured, "ordering_agrees": modeled == measured}
    return result


# ---------------------------------------------------------- executable side


def build_groups(c: Dict[str, Any], ctx: Any = None):
    """The plan's process groups (JAX's ``build_mesh`` :1093): ``ctx``
    (default ``tpc``) laid out over the plan's axes in its order (pipe,
    data[, ep], tensor; the last on consecutive ranks).  Every rank of the
    ``torch.distributed`` world calls it; raises when the world size is
    not the plan's chip count.  Returns the context."""
    import torch.distributed as dist

    from .topology import tpc

    ctx = tpc if ctx is None else ctx
    sizes = c["mesh_axes"]
    n = math.prod(sizes.values())
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != n:
        raise ValueError(f"plan wants {n} chips ({dict(sizes)}), the "
                         f"torch.distributed world has {have}")
    ctx.setup_process_groups(list(sizes.items()))
    return ctx


def _family_specs(c: Dict[str, Any], config: Any, shapes: Any) -> Any:
    """The family's own spec tree at the plan's tensor / pipe / ep axes
    (``models.gpt_param_specs``, ``models.gpt_moe_param_specs``,
    ``layers.transformer_param_specs``)."""
    tp_axis = "tensor" if c["tp"] > 1 else None
    if hasattr(config, "vocab_size") and getattr(config, "moe_experts", 0):
        from ..models.gpt_moe import gpt_moe_param_specs

        return gpt_moe_param_specs(
            shapes, ep_axis="ep" if c.get("ep", 1) > 1 else None)
    if hasattr(config, "vocab_size"):
        from ..models.gpt import gpt_param_specs

        return gpt_param_specs(
            shapes, pipe_axis="pipe" if c["pp"] > 1 else None,
            tp_axis=tp_axis)
    if tp_axis is None:
        return None
    from ..parallel.tensor_parallel.layers import transformer_param_specs

    return transformer_param_specs(config, axis=tp_axis)


def _entries(leaf: torch.Tensor, spec: Any, tp: int) -> List[Optional[str]]:
    """A leaf's spec as one axis name (or None) a dim: a tuple is that
    already; an int (the tensor group's split dim) the tensor axis there;
    an axis name (the MoE experts' ``ep``) on dim 0; anything else
    replicated."""
    if isinstance(spec, tuple):
        return list(spec)
    entries: List[Optional[str]] = [None] * leaf.dim()
    if isinstance(spec, int) and not isinstance(spec, bool) and tp > 1:
        entries[spec % leaf.dim()] = "tensor"
    elif spec == "ep":
        entries[0] = "ep"
    return entries


def plan_param_specs(c: Dict[str, Any], config: Any) -> Any:
    """Plan ``c``'s spec tree for ``config`` (JAX :1116), in the port's
    PartitionSpec-like form (each leaf a tuple of axis names, one a dim):
    the family's tensor / pipe / ep specs, and under ``fsdp`` the data
    axis on the first free dim ``dp`` divides — ZeRO's rule
    (``parallel.zero.zero_partition_spec``).  Trees like
    ``obs.mem_ledger._shapes_for_config(config)``; ``MemoryModel`` reads
    it, and :func:`spec_table` renders the same assignment."""
    from ..obs.mem_ledger import _shapes_for_config, _spec_leaves
    from ..obs.numerics import tree_paths
    from ..parallel.data_parallel import _unflatten_like

    shapes = _shapes_for_config(config)
    base = _family_specs(c, config, shapes)
    leaves = [leaf for _, leaf in tree_paths(shapes)]
    specs = (_spec_leaves(shapes, base) if base is not None
             else [None] * len(leaves))
    out = []
    for leaf, spec in zip(leaves, specs):
        entries = _entries(leaf, spec, c["tp"])
        if c["layout"] == "fsdp" and c["dp"] > 1:
            dim = _first_free_dim(tuple(leaf.shape), entries, c["dp"])
            if dim >= 0:
                entries[dim] = "data"
        out.append(tuple(entries))
    return _unflatten_like(shapes, iter(out))


def batch_partition_spec(c: Dict[str, Any], ctx: Any = None
                         ) -> Tuple[Tuple[str, ...], int, int]:
    """How the global batch's leading dim is split (JAX :1159): ``(axes,
    index, count)`` — over ``('data',)``, or ``('data', 'ep')`` for an MoE
    plan, in ``count = dp`` equal slices, of which this rank takes slice
    ``index`` (its coordinate on those axes in ``ctx``; 0 without one).
    ``()`` / 0 / 1 when ``dp`` is 1."""
    if c["dp"] <= 1:
        return (), 0, 1
    axes = ("data", "ep") if "ep" in c["mesh_axes"] else ("data",)
    index = 0
    if ctx is not None:
        for a in axes:
            index = index * ctx.get_group_size(a) + ctx.get_group_rank(a)
    return axes, index, c["dp"]


def shard_global_batch(batch: Dict[str, torch.Tensor], c: Dict[str, Any],
                       ctx: Any = None) -> Dict[str, torch.Tensor]:
    """This rank's rows of ``batch`` under :func:`batch_partition_spec`."""
    _, index, count = batch_partition_spec(c, ctx)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % count:
            raise ValueError(f"batch dim {v.shape[0]} not divisible by "
                             f"dp {count}")
        rows = v.shape[0] // count
        out[k] = v[index * rows:(index + 1) * rows]
    return out


def live_resident_bytes(params: Any, opt_state: Any) -> Dict[str, int]:
    """The bytes a step's state holds on this rank, from its live
    tensors: ``params_bytes`` (every leaf), ``grads_bytes`` (each leaf's
    ``.grad``), ``opt_bytes`` (the optimizer state's tensors but its step
    counters) — what a plan's ``memory`` models exactly (its activations
    are an estimate and are not here)."""
    from ..obs.numerics import tree_leaves

    leaves = list(tree_leaves(params))
    nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
    opt = 0
    for state in getattr(opt_state, "state", {}).values():
        opt += sum(nbytes(t) for k, t in state.items()
                   if k != "step" and isinstance(t, torch.Tensor))
    return {"params_bytes": sum(nbytes(p) for p in leaves),
            "grads_bytes": sum(nbytes(p.grad) for p in leaves
                               if p.grad is not None),
            "opt_bytes": opt}


@dataclasses.dataclass
class PlanStep:
    """A plan made executable (:func:`make_plan_step`): ``params`` and
    ``opt_state`` this rank's, ``step(params, opt_state, global_batch) ->
    (params, opt_state, loss, gnorm)`` (the loss the global batch's mean
    next-token cross-entropy, the same on every rank)."""

    step: Callable[..., Any]
    params: Any
    opt_state: Any
    plan: Dict[str, Any]


def make_plan_step(c: Dict[str, Any], config: Any, ctx: Any = None, *,
                   params: Any, optimizer: Any = None, remat: Any = False,
                   microbatches: Optional[int] = None) -> PlanStep:
    """Plan ``c``'s train step for a dense GPT ``config`` on this rank of
    ``ctx`` (after :func:`build_groups`), from ``params``, the whole tree
    (the same on every rank), built from the port's steps:

    - ``dp``: ``DataParallel.make_train_step`` over the data axis (the
      int8 grads arm: ``grad_compress='int8'``);
    - ``tp > 1``: the same with the tensor group's shard
      (``models.shard_gpt_params``) and ``param_specs``, SP on (the
      planner prices SP's boundaries; the int8 acts arm:
      ``ag_compress='int8'``);
    - ``fsdp``: ``FSDP.make_train_step`` (beside TP with its specs);
    - ``pp > 1``: ``models.gpt_pipeline_1f1b`` as ``DataParallel``'s
      ``value_and_grad_fn`` on the stage's slab, ``microbatches`` (default
      the largest divisor of the rank's batch rows up to 8) a step.

    ``optimizer`` defaults to ``adamw(3e-4)``; ``remat`` goes to the
    loss.  MoE plans raise (no MoE runner here yet)."""
    from ..models.gpt import (
        gpt_loss,
        gpt_param_specs,
        gpt_pipeline_1f1b,
        shard_gpt_params,
    )
    from ..parallel.data_parallel import DataParallel, adamw
    from ..parallel.fsdp import FSDP
    from ..utils.data import microbatch
    from .topology import tpc

    ctx = tpc if ctx is None else ctx
    if getattr(config, "moe_experts", 0) or not hasattr(config,
                                                        "vocab_size"):
        raise NotImplementedError(
            "make_plan_step builds dense GPT plans; an MoE or transformer "
            "plan is modeled only")
    if c["layout"] == "fsdp" and c["pp"] > 1:
        raise NotImplementedError("an fsdp layout beside a pipe axis has "
                                  "no runner (executable_only excludes it)")
    optimizer = optimizer or adamw(3e-4)
    tp, pp = c["tp"], c["pp"]
    if tp > 1 and c["compress"]["acts"]:
        config = dataclasses.replace(config, ag_compress="int8")
    tp_group = ctx.get_group("tensor") if tp > 1 else None
    pp_rank = ctx.get_group_rank("pipe") if pp > 1 else 0
    if tp > 1 or pp > 1:
        params = shard_gpt_params(
            params, config, ctx.get_group_rank("tensor") if tp > 1 else 0,
            tp, pp_rank=pp_rank, pp_size=pp)
    specs = gpt_param_specs(params) if tp > 1 else None
    grad_compress = "int8" if c["compress"]["grads"] else None

    def loss_fn(p, b):
        return gpt_loss(p, b, config, remat=remat, tp_group=tp_group,
                        sp=tp_group is not None)

    if c["layout"] == "fsdp" and c["dp"] > 1:
        if grad_compress is not None:
            raise NotImplementedError("the int8 grads arm of an fsdp plan "
                                      "has no runner (executable_only "
                                      "excludes it)")
        fsdp = FSDP(ctx=ctx, param_specs=specs)
        params = fsdp.shard_params(params)
        inner = fsdp.make_train_step(loss_fn, optimizer,
                                     sp=tp_group is not None)
    elif pp > 1:
        dp = DataParallel(ctx=ctx, grad_compress=grad_compress)
        pipe_specs = gpt_param_specs(params, pipe_axis="pipe",
                                     tp_axis="tensor" if tp > 1 else None)
        # the 1F1B step recomputes each stage's blocks unless told how
        remat_kw = {"remat": remat} if remat else {}
        vag = dp.make_train_step(
            value_and_grad_fn=lambda p, b: gpt_pipeline_1f1b(  # b: [M, ...]
                p, b, config, b["tokens"].shape[0], tp_group=tp_group,
                sp=tp_group is not None, pipe_group=ctx.get_group("pipe"),
                **remat_kw),
            optimizer=optimizer, pipe_specs=pipe_specs, param_specs=specs,
            sp=tp_group is not None)

        def inner(p, s, b):
            rows = b["tokens"].shape[0]
            m = microbatches or max(k for k in range(1, 9) if rows % k == 0)
            return vag(p, s, microbatch(b, m))
    else:
        dp = DataParallel(ctx=ctx, grad_compress=grad_compress)
        inner = dp.make_train_step(loss_fn, optimizer, param_specs=specs,
                                   sp=tp_group is not None)
    opt_state = optimizer.init(params)

    def step(p, s, global_batch_):
        return inner(p, s, shard_global_batch(global_batch_, c, ctx))

    return PlanStep(step=step, params=params, opt_state=opt_state, plan=c)
