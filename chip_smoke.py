#!/usr/bin/env python3
"""Drive the PyTorch port's training and serving paths on one NVIDIA card
and check them.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device  — a CUDA card is present; its name, count and power limit.
2. build   — the three kernel sources under ``torchdistpackage_tpu_torch/
   ops/csrc`` are compiled at once (one nvcc each), beside four
   planted-fault builds of ``paged_attention.cu`` and one each of
   ``moe_dispatch.cu`` and ``flash_attention.cu``; build seconds and
   ptxas' registers / shared memory / spills of every instantiation (K6's
   and K7's float and int8 ones named apart; a summary line of registers
   and spills for each K1/K2 instantiation, walk and tensor-core, and for
   each warpgroup instantiation — bf16 K3, K4 and K5, K6's and K7's
   chunk and decode passes —
   with its shared memory and its HGMMA count from ``cuobjdump -sass``,
   which must not be 0; a ptxas C75xx advisory, a serialised wgmma,
   fails the build), and each one's dynamic shared memory.
3. kernels — each kernel against its plain version on the card, row by
   row against the plain version run in f32 on the same values
   (``row_tolerance``, ``grad_held``, ``moe_held``), with planted faults
   that must fail the same checks; then its time, the plain version's
   time, a PyTorch yardstick the port never calls and the least time the
   card could take.  K1 (paged attention) at the serving shapes (decode,
   a 3-row step, a 512-row prefill chunk and a 200-row one; G 4, Hkv 8,
   hd 128, bs 16; windows None / 4096 / 64 / 48; bf16, int8 and f32
   pools; 4 slots of Mixtral-8x7B-v0.1's 32768 positions without a
   window; 64 and 320 slots of up to 2048 and 1024 positions; faults: a
   window edge one block late, one stage of blocks misread, and on the
   window-64 chunk the window edge 3 positions late,
   which only the tensor-core mode's per-element masks see; on the
   decode rows' split path, from planted-fault builds of the source:
   one split's partial dropped, a split boundary one block late, the
   merge taking the next split's m; yardstick SDPA).  Decode rows (the
   split-KV body and its merge) are also timed from a CUDA graph
   (``graph_ms``), since the wrapper's host time is as long as the
   kernels, checked bit-identical over two launches, and swept over
   NSPLIT and over the slot order (longest first or the grid's own).
   K3-K5 (flash attention forward, dq, dk/dv) at the training shape (B
   16, H 12, S 2048, hd 64, causal) and at Mistral-7B's attention (Hq 32,
   Hkv 8, hd 128, S 8192, window 4096), bf16 (the warpgroup bodies) and
   f32 (the CUDA-core bodies) (faults: the backward without the dlse
   term, K3's diagonal one key late, K5's lse column one query off, K4's
   delta one query row off, K4's dS.K on the key tile one tile late —
   emulated on the output — and the window one tile late; yardstick
   SDPA); then at sequence lengths no tile divides (S 1, 63, 65, 100,
   1000, and Sq 100 over Sk 65; hd 64 and 128; causal, window 48 and
   non-causal; bf16 and f32), K3's bf16 calls timed beside SDPA's forward
   (fault: the planted-fault build of bf16 K3 without its key bound, on a
   non-causal S 1000 case), and the generate prefill's own call (B 4,
   32 / 8 heads, S 1000, window 4096) timed beside its plain version,
   SDPA and its bound.  K6 (fused MoE dispatch) at Mixtral-8x7B's
   expert widths (E 8,
   top-2, D 4096, F 14336, SwiGLU, bf16) for decode (T 8) and a 512-row
   chunk of 8 slots (T 4096) at the serving capacity C = T, plus GELU,
   f32 and capacity-drop cases at smaller widths, each case naming the
   body it took (decode the swap-AB decode body, the chunk the two-pass
   warpgroup GEMM, f32 the walk; faults on the first case of each body:
   the gate weight not applied, the last F tile left out, the scatter on
   the neighbouring slot's token, and on the two warpgroup bodies the
   gather from the neighbouring slot's token and a hit expert or filled
   tile treated as empty, on the decode body one pass-2 run dropped from
   the merge (the planted-fault build), on the chunk body gate and up
   swapped; the decode body, and the chunk body at top-2, bit-identical
   over two launches; the three bodies swept over C = T 1-64; yardstick
   the ragged 'gather' arm, several cuBLAS calls).  K6's int8 variant
   (experts from ``quantize_moe_experts``) at the same Mixtral shapes,
   plus GELU, f32 tokens and capacity drops (faults: those, and w2's
   scale not applied, the up half scaled by the gate's scale row, each
   column scaled by its neighbour's scale; yardstick the ragged arm over
   bf16 weights dequantised beforehand).  K7 and K7-int8 (the expert-parallel expert FFN, every
   row computed) at Mixtral's expert widths at the per-rank shapes of EP
   1 and EP 4 — decode ([8, 8, 4096] / [2, 32, 4096]) and a 512-row
   chunk of 8 slots ([8, 4096, 4096] / [2, 16384, 4096]) — plus GELU, f32
   rows and ragged G and F, each case naming the body it took (decode
   rows the swap-AB decode body, checked bit-identical over two
   launches, chunk rows the two-pass warpgroup GEMM, f32 rows the walk;
   faults on the first case of each body: the last F tile left out, b2
   added by every F tile, each row in the next expert's block, for int8
   w2's scale not applied, on the warpgroup bodies gate and up swapped,
   on the decode body one pass-2 run dropped from the merge; yardstick
   the torch.bmm chain, several cuBLAS calls).  K2 (one hop of the context-parallel ring, the raw
   online-softmax carry) at the serving shapes (B 8, G 4, Hkv 8, hd 128,
   bs 16): decode and a 512-row chunk, windows 4096 / None / 64, bf16
   and f32, and a 200-row chunk at window 48 in bf16, each as one hop
   over the whole pool (cp 1) and as a four-hop carry chain over four
   quarter-pool slices through re-based tables (the per-rank work of cp
   4), held after ``finalize_paged_carry`` with the carry's m and l
   (``carry_held``; faults: the ownership mask off, the carry not seeded,
   the window one block late, the carry merged once a warp in split mode,
   the window edge 3 positions late on the window-64 chunk, and on the
   decode chains the four split-path faults, K2's carry seeded in every
   split among them; yardsticks SDPA over the gathered view and K1 at
   the same one-hop shape); and the 32k decode case as one hop and four.
4. train   — the training main path: ``bench.py``'s GPT-125M at full
   depth, batch 16, S 2048, bf16, remat 'flash', 10 AdamW steps on one
   fixed batch (losses, step time, tokens/s, MFU, peak memory, launches
   exactly once a layer a step for K3, K4, K5), one step profiled by
   kernel family; the kernel path against the plain ('naive') path on
   identical weights and batch at batch 2 (loss and every gradient
   leaf, bf16 and f32); 2 steps at Mistral-7B-v0.1 widths (2 layers, S
   8192) through GQA, the window, RoPE and SwiGLU; then data parallel
   (``dp_train_phase``): a one-rank NCCL group and ``tpc``'s ``data``
   axis, the GPT-125M run through ``make_train_step`` and through
   ``DataParallel.make_train_step`` (25 MB buckets, per-layer slice
   hooks), losses and parameters after 10 steps bit-identical, K3-K5
   once a layer a step, the step medians, the bucket count and the
   bytes whose all-reduce started inside the backward; remat
   'flash_offload' (losses equal to 'flash', step median; then, in one
   helper on one set of parameters and one batch, a forward and
   backward in each mode: the card bytes held at the end of the forward
   lower by the 12 kept ``o`` (12 B S D 2 bytes, within 1 %), the peak
   at least 0.5 GB lower); dropout 0.1 twice under one key (3 steps,
   bit-identical, apart from rate 0).
5. serve   — Mistral-7B-v0.1 widths, all 32 layers, bf16, random weights:
   ``paged_forward`` with K1 against the plain path on identical tokens
   (teacher-forced logits), then ``ServingEngine`` serves 16 requests
   (12 greedy, 4 sampled) through K1, launched once per layer per device
   call; a decode tick of 8 slots is timed and profiled.  Then the same
   model context-parallel (``cp_phase``): a one-rank NCCL group
   (``init_distributed``, ``build_cp_group(1)``), ``cp_paged_forward``
   with K2 against ``paged_forward`` with K1 (equal bit for bit: at cp 1
   K2 runs K1's body on K1's tiles) and against the CP gather arm on a
   4700-token context (teacher-forced logits), then
   ``ServingEngine(cp_group=...)`` serves 4 greedy requests of 30720,
   24576, 16384 and 8192 prompt tokens (Mistral's 32768 positions, a ~17
   GB pool) through K2, launched once per layer per device call, K1
   never; the share of its tokens equal to the K1 engine's on the same
   requests; a decode tick profiled.  Then the contiguous-cache decoding
   family (``generate_phase``, ``attn_impl='flash'``): greedy
   ``generate`` at B 4 on 1000-token prompts, 64 new tokens (K3 once a
   layer for the prefill, never in a decode step; every token held by
   teacher forcing through ``gpt_forward``: within 5 % of its row's
   scale of the row's maximum; prefill and decode-step ms), sampled
   ``generate`` twice from one seed (identical), ``beam_generate`` with 4
   beams (distinct; the best one's teacher-forced log-probability no
   lower than greedy's within tolerance) and with 1, and
   ``speculative_generate`` with 4 drafts from the target itself and
   from its int8 copy (equal to greedy ``generate`` bit for bit, or at
   the first difference a teacher-forced near-tie; acceptance printed);
   then ``ServingEngine(spec_k=3)`` and ``spec_k=4`` beside the plain
   engine on 8 requests (4 greedy, 4 sampled) whose prompts repeat a
   64-token segment (``spec_engine_phase``: K1 once a layer a device
   call, verify included; greedy rows teacher-forced; acceptance, tokens
   a slot a tick, TPOT and tokens/s; the K1 body a verify call runs, by
   torch.profiler: the split decode body at K 3, ``paged_tc_kernel`` at
   K 4).
6. MoE serve — Mixtral-8x7B-v0.1 widths at 16 of 32 layers (23.5 B
   parameters, 47 GB of bf16; all 32 layers do not fit one 80 GB card),
   random weights: ``paged_forward_moe`` with K6 against the ragged
   plain arm on identical tokens (the plain arm replaying the K6 run's
   routing; the free-running drift reported), then ``ServingEngine`` serves 12
   requests (9 greedy, 3 sampled) through K6 and K1, each launched once
   per layer per device call; the ``moe`` summary's expert load; a
   decode tick of 8 slots profiled by kernel family.  Then the same model
   expert-parallel (``ep_phase``): a one-rank NCCL process group
   (``init_distributed``, ``build_moe_groups(1)``), ``paged_forward_moe``
   through ``moe_forward``'s exchange with K7 against the ragged arm
   (routing pinned), the engine with ``ep_group`` serving the same 12
   requests through K7 and K1 (K6 never), a decode tick profiled, and
   greedy ``generate`` (``moe_generate_phase``: B 4, 500-token prompts,
   32 new tokens) through K6 and over the same group through K7, each
   launched exactly 16 x forward calls (the other 0).
7. int8 serve — Mixtral-8x7B-v0.1 whole, all 32 layers (46.7 B
   parameters), int8 weight-only with bf16 activations, random weights,
   built block by block (``quantize_moe_experts`` on each block's
   experts, then ``quantize_decode_params`` on the attention and the
   head): its bytes on the card by part (~47 GB); teacher-forced logits
   with K6-int8 against the ragged arm over each layer's experts
   dequantised to bf16 just before that layer's call (routing pinned, and
   free-running); ``ServingEngine`` serves the same 12 requests as the MoE
   phase through K6-int8 and K1, each launched once per layer per device
   call; a decode tick profiled; then expert-parallel as in phase 6,
   through K7-int8.
8. the ``{"kernels": [...]}`` line (nine entries), then the card line,
   then the result line ``{"ok": true, "device": {...}}`` last.

Every kernel's launch count is set to 0 just before each main path (the
training steps, each engine run) and read just after.
"""

import contextlib
import ctypes
import dataclasses
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,  # dense bf16 tensor cores
              torch.float32: 67e12}    # f32 outside the tensor cores
HKV, GROUPS, HD, BS = 8, 4, 128, 16    # Mistral-7B attention widths
TPU_SOURCE = "torchdistpackage_tpu/ops/paged_attention.py:214"


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters):
    """Mean milliseconds of ``fn()`` over ``iters`` calls, by CUDA events,
    after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters):
    """Mean milliseconds of ``fn()`` replayed from a CUDA graph: the
    device's time for the call's kernels without the host's cost of
    launching them (which, for a decode call, is as long as the kernels).
    Capturing it also shows the call reads nothing back from the card."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters)


# ------------------------------------------------------------ phase 3


def make_case(name, *, B, S_in, offsets, window, dtype, quantized, seed):
    """Random q and pool on the card; tables are a permutation of the
    pool's blocks, wide enough for the deepest slot's rows."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    mb = -(-(max(offsets) + S_in) // BS)
    nb = 1 + B * mb
    tables = (torch.randperm(nb - 1, generator=g, device=dev) + 1)
    tables = tables.reshape(B, mb).to(torch.int32).contiguous()
    offs = torch.tensor(offsets, dtype=torch.int32, device=dev)
    q = torch.randn(B, HKV * GROUPS, S_in, HD, generator=g,
                    device=dev).to(dtype)
    if quantized:
        pools = [(torch.randint(-127, 128, (nb, HKV, BS, HD), generator=g,
                                device=dev, dtype=torch.int8),
                  torch.rand(nb, HKV, BS, generator=g, device=dev) * 0.02
                  + 1e-3) for _ in range(2)]
    else:
        pools = [torch.randn(nb, HKV, BS, HD, generator=g,
                             device=dev).to(dtype) for _ in range(2)]
    return {"name": name, "q": q, "k": pools[0], "v": pools[1],
            "tables": tables, "offsets": offs, "window": window,
            "quantized": quantized}


def attended_keys(offsets, S_in, window, table_keys):
    """Per slot: the key positions its rows attend (the union over rows,
    for bytes) and the number of (row, key) pairs (for operations)."""
    keys, pairs = [], 0
    for off in offsets:
        qpos = off + np.arange(S_in)
        hi = np.minimum(qpos, table_keys - 1)
        lo = np.zeros_like(qpos) if window is None else np.maximum(
            qpos - window + 1, 0)
        pairs += int(np.maximum(hi - lo + 1, 0).sum())
        keys.append(max(0, int(hi.max()) - int(lo.min()) + 1))
    return keys, pairs


def bound(case):
    """Least time the card could take for this call: the larger of the
    bytes it must move (live KV of each slot once, q in, out, tables) over
    the memory rate and its operations over the peak for q's type."""
    q = case["q"]
    B, H, S_in, hd = q.shape
    table_keys = case["tables"].shape[1] * BS
    keys, pairs = attended_keys(case["offsets"].tolist(), S_in,
                                case["window"], table_keys)
    if case["quantized"]:
        per_key = HKV * (hd * 1 + 4)  # int8 payload + f32 scale
    else:
        per_key = HKV * hd * q.element_size()
    nbytes = (2 * sum(keys) * per_key + 2 * q.numel() * q.element_size()
              + case["tables"].numel() * 4 + B * 4)
    flops = 4 * pairs * GROUPS * HKV * hd  # QK^T and PV, 2 flops a MAC
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sdpa_ms(case, iters):
    """One PyTorch call computing the same attention — SDPA over the
    gathered, dequantized view with the same boolean mask (gather, repeat
    and mask construction excluded from the time)."""
    from torchdistpackage_tpu_torch.serving.paged_cache import gather_kv

    q, tables, window = case["q"], case["tables"], case["window"]
    k, v = gather_kv(case["k"], tables), gather_kv(case["v"], tables)
    if case["quantized"]:
        k = (k[0].float() * k[1][..., None]).to(q.dtype)
        v = (v[0].float() * v[1][..., None]).to(q.dtype)
    k = k.repeat_interleave(GROUPS, dim=1)
    v = v.repeat_interleave(GROUPS, dim=1)
    S_in, T = q.shape[2], k.shape[2]
    qpos = case["offsets"][:, None] + torch.arange(S_in, device=q.device)
    kpos = torch.arange(T, device=q.device)
    mask = kpos <= qpos[..., None]
    if window is not None:
        mask &= kpos > qpos[..., None] - window
    mask = mask[:, None]
    return cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), iters)


def row_tolerance(want, dtype):
    """The tolerance of each output row (one query row of one head),
    ``want.shape[:-1]``.  f32 out: 2e-5 — the kernel and the plain
    version differ only in summation order (online vs full-row softmax).
    bf16 out: 2 bf16 ulps of that row's own largest |value| — the kernel
    rounds its unnormalised probabilities to bf16 before P.V and its
    output once at the end, each below one ulp of the row.  A row's scale
    runs from |v| (a row that sees one key) down to about
    1/sqrt(context), so one tolerance for the whole output would be set
    by its largest row and blind at long contexts."""
    if dtype == torch.float32:
        return torch.full(want.shape[:-1], 2e-5, device=want.device)
    scale = want.float().abs().amax(-1).clamp_min(2.0 ** -100)
    return 2.0 * torch.exp2(torch.floor(torch.log2(scale)) - 7)


def held(got, want, dtype):
    """``(max abs error, max over rows of error / row tolerance)``: the
    kernel's output holds against ``want`` when the ratio is <= 1 and
    every value is finite."""
    err = (got.float() - want.float()).abs().amax(-1)
    ratio = float((err / row_tolerance(want, dtype)).max())
    if not torch.isfinite(got).all():
        ratio = float("inf")
    return float(err.max()), ratio


def exact_inputs(case):
    """The case's inputs as f32 — the same values, so the plain version
    run on them is the exact arithmetic the kernel approximates."""
    def up(pool):
        return pool if case["quantized"] else pool.float()
    return (case["q"].float(), up(case["k"]), up(case["v"]),
            case["tables"], case["offsets"])


def kernel_phase():
    from torchdistpackage_tpu_torch.ops.paged_attention import (
        DECODE_ROWS,
        LAUNCHES,
        paged_decode_attention,
        paged_decode_attention_reference,
    )

    decode_offs = [0, 17, 255, 1023, 2047, 3001, 4095, 4607]
    chunk_offs = [0, 512, 1024, 2048, 3072, 3584, 4096, 4608]
    bf, f32 = torch.bfloat16, torch.float32
    specs = [
        ("decode_bf16_w4096", dict(B=8, S_in=1, offsets=decode_offs,
                                   window=4096, dtype=bf, quantized=False)),
        ("decode_bf16_full", dict(B=8, S_in=1, offsets=decode_offs,
                                  window=None, dtype=bf, quantized=False)),
        ("decode_bf16_w64", dict(B=8, S_in=1, offsets=decode_offs,
                                 window=64, dtype=bf, quantized=False)),
        ("decode_bf16_full_32k", dict(B=4, S_in=1, offsets=LONG_OFFS,
                                      window=None, dtype=bf,
                                      quantized=False)),
        # many slots, on both sides of DECODE_ORDER_MAX_SLOTS
        ("decode_bf16_64slots_2k", dict(B=64, S_in=1,
                                        offsets=spread_offsets(64, 2048),
                                        window=4096, dtype=bf,
                                        quantized=False)),
        ("decode_bf16_320slots_1k", dict(B=320, S_in=1,
                                         offsets=spread_offsets(320, 1024),
                                         window=4096, dtype=bf,
                                         quantized=False)),
        ("rows3_bf16_w4096", dict(B=8, S_in=3, offsets=decode_offs,
                                  window=4096, dtype=bf, quantized=False)),
        ("chunk512_bf16_w4096", dict(B=8, S_in=512, offsets=chunk_offs,
                                     window=4096, dtype=bf,
                                     quantized=False)),
        ("chunk512_bf16_w64", dict(B=8, S_in=512, offsets=chunk_offs,
                                   window=64, dtype=bf, quantized=False)),
        ("chunk200_bf16_w48", dict(B=8, S_in=200, offsets=chunk_offs,
                                   window=48, dtype=bf, quantized=False)),
        ("decode_int8_w4096", dict(B=8, S_in=1, offsets=decode_offs,
                                   window=4096, dtype=bf, quantized=True)),
        ("chunk512_int8_full", dict(B=8, S_in=512, offsets=chunk_offs,
                                    window=None, dtype=bf, quantized=True)),
        ("decode_f32_full", dict(B=8, S_in=1, offsets=decode_offs,
                                 window=None, dtype=f32, quantized=False)),
        ("decode_f32_w4096", dict(B=8, S_in=1, offsets=decode_offs,
                                  window=4096, dtype=f32, quantized=False)),
        ("chunk512_f32_w4096", dict(B=8, S_in=512, offsets=chunk_offs,
                                    window=4096, dtype=f32,
                                    quantized=False)),
    ]
    rows = []
    for i, (name, spec) in enumerate(specs):
        case = make_case(name, seed=100 + i, **spec)
        args = (case["q"], case["k"], case["v"], case["tables"],
                case["offsets"])
        kw = {"window": case["window"]}
        before = LAUNCHES["paged_decode_attention"]
        got = paged_decode_attention(*args, **kw)
        torch.cuda.synchronize()
        if LAUNCHES["paged_decode_attention"] != before + 1:
            raise RuntimeError(f"{name}: the launch counter did not move")
        want = paged_decode_attention_reference(*args, **kw)
        exact = paged_decode_attention_reference(*exact_inputs(case), **kw)
        torch.cuda.synchronize()
        err, ratio = held(got, exact, spec["dtype"])
        plain_err, plain_ratio = held(got, want, spec["dtype"])
        log(f"[kernel] {name}: vs the plain version in f32: max abs err "
            f"{err:.3g}, {ratio:.3f} of the row tolerance; vs the plain "
            f"version in {str(spec['dtype'])[6:]}: {plain_err:.3g}, "
            f"{plain_ratio:.3f}")
        if not ratio <= 1.0:
            raise RuntimeError(
                f"{name}: kernel disagrees with its plain version: "
                f"{ratio:.3f} of the row tolerance")
        decode = GROUPS * spec["S_in"] <= DECODE_ROWS
        if decode:
            repeatable(name, got, lambda: paged_decode_attention(*args, **kw))
        if name in ("decode_bf16_w4096", "chunk512_bf16_w4096"):
            planted_faults(case, exact)
        if name == "chunk512_bf16_w64":
            mask_planted_fault(case, exact)
        if name in ("decode_bf16_w4096", "decode_bf16_full_32k"):
            for fault in (1, 2, 4):
                bad = with_paged_fault(fault, lambda: paged_decode_attention(
                    *args, **kw))
                split_fault_fails(name, fault, *held(bad, exact,
                                                     spec["dtype"]))
            nsplit_sweep(name, lambda: paged_decode_attention(*args, **kw),
                         splits_of(case))
        if name in ("decode_bf16_w4096", "decode_bf16_64slots_2k",
                    "decode_bf16_320slots_1k"):
            order_sweep(name, got, lambda: paged_decode_attention(*args,
                                                                  **kw))
        if "slots" in name:
            nsplit_sweep(name, lambda: paged_decode_attention(*args, **kw),
                         splits_of(case), counts=(1, 2, 3, 4, 8))
        heavy = spec["S_in"] > 8
        ms = cuda_ms(lambda: paged_decode_attention(*args, **kw),
                     5 if heavy else 50)
        # decode rows: also the device time alone, from a CUDA graph (the
        # wrapper's host time is about as long as the kernels)
        g_ms = graph_ms(lambda: paged_decode_attention(*args, **kw),
                        50) if decode else None
        plain_ms = cuda_ms(lambda: paged_decode_attention_reference(
            *args, **kw), 2 if heavy else 10)
        lib_ms = sdpa_ms(case, 5 if heavy else 50)
        bound_ms, bound_by = bound(case)
        row = {"case": name, "max_abs_err": err, "tol_ratio": ratio,
               "plain_dtype_err": plain_err, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "nsplit": splits_of(case) if decode else None,
               "graph_ms": g_ms}
        rows.append(row)
        log(f"[kernel] {name}: kernel {ms:.4f} ms"
            + (f" ({g_ms:.4f} ms from a CUDA graph; NSPLIT "
               f"{row['nsplit']})" if decode else "")
            + f"  plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        del case, args, got, want, exact
        torch.cuda.empty_cache()
    slot_order_sweep()
    return rows


LONG_OFFS = [32767, 24575, 16383, 8191]  # Mixtral-8x7B-v0.1's 32k context


def spread_offsets(B, context):
    """B slots' offsets spread evenly over [0, context): a server's slots
    at every stage of their contexts."""
    return [i * (context - 1) // (B - 1) for i in range(B)]


#: the kernel source's planted-fault variants (``-DTDP_PAGED_FAULT=n``),
#: built beside it by ``build_phase``
PAGED_FAULTS = {1: "one split's partial dropped",
                2: "a split boundary one block late",
                3: "K2's carry seeded in every split",
                4: "the merge taking the next split's m"}


def paged_fault_defines(fault):
    return (f"TDP_PAGED_FAULT={fault}",)


def with_paged_fault(fault, fn):
    """``fn()`` with K1 and K2 taken from planted-fault variant ``fault``
    of ``paged_attention.cu``."""
    from torchdistpackage_tpu_torch.ops import _build

    with _build.variant("paged_attention", paged_fault_defines(fault)):
        return fn()


def split_fault_fails(tag, fault, err, ratio):
    log(f"[kernel] {tag}, planted fault ({PAGED_FAULTS[fault]}): max abs "
        f"err {err:.3g}, {ratio:.1f} x the tolerance")
    if ratio <= 1.0:
        raise RuntimeError(f"{tag}: the check misses a planted fault "
                           f"({PAGED_FAULTS[fault]})")


def repeatable(tag, got, fn):
    """The decode rows' merge adds the partials in split order: a second
    launch on the same inputs gives the same bits."""
    again = fn()
    pairs = zip(got, again) if isinstance(got, tuple) else [(got, again)]
    if not all(torch.equal(a, b) for a, b in pairs):
        raise RuntimeError(f"{tag}: two launches differ")
    log(f"[kernel] {tag}: two launches bit-identical")


def splits_of(case):
    from torchdistpackage_tpu_torch.ops.paged_attention import decode_splits

    tables = case["tables"]
    return decode_splits(tables.shape[0] * HKV, tables.shape[1],
                         torch.cuda.get_device_properties(
                             0).multi_processor_count)


def nsplit_sweep(tag, fn, default,
                 counts=(1, 2, 4, 8, 12, 16, 24, 33, 48, 66)):
    """The decode rows' time at split counts pinned around the default
    (``decode_splits``): the measurement its choice rests on."""
    from torchdistpackage_tpu_torch.ops import paged_attention as pa

    chosen = pa.decode_splits
    times = []
    try:
        for n in counts:
            pa.decode_splits = lambda bh, mb, sms, n=n: n
            times.append(f"{n}: {graph_ms(fn, 30):.4f}")
    finally:
        pa.decode_splits = chosen
    log(f"[kernel] {tag}: NSPLIT sweep (ms from a CUDA graph; the default "
        f"is {default}) " + ", ".join(times))


def order_sweep(tag, got, fn):
    """The bf16 decode rows' time with the split grid's longest-first
    order on and off (``DECODE_ORDER_MAX_SLOTS`` pinned above and below
    B): the measurement that threshold rests on.  The order moves work
    between CTAs, never the arithmetic, so both give ``got``'s bits."""
    from torchdistpackage_tpu_torch.ops import paged_attention as pa

    chosen = pa.DECODE_ORDER_MAX_SLOTS
    times = []
    try:
        for what, limit in (("longest first", 1 << 30), ("grid order", 0)):
            pa.DECODE_ORDER_MAX_SLOTS = limit
            if not torch.equal(fn(), got):
                raise RuntimeError(f"{tag}: the {what} grid changes the "
                                   f"output")
            times.append(f"{what} {graph_ms(fn, 30):.4f}")
    finally:
        pa.DECODE_ORDER_MAX_SLOTS = chosen
    log(f"[kernel] {tag}: slot order (ms from a CUDA graph; the default "
        f"orders up to {chosen} slots) " + ", ".join(times))


def slot_order_sweep(slots=(96, 128, 160, 192, 256)):
    """:func:`order_sweep` at more slot counts (contexts spread over 2048
    positions, Mistral's window): where the longest-first order stops
    paying for each CTA's ranking of the slots."""
    from torchdistpackage_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
    )

    for i, B in enumerate(slots):
        case = make_case(f"decode_bf16_{B}slots_2k", B=B, S_in=1,
                         offsets=spread_offsets(B, 2048), window=4096,
                         dtype=torch.bfloat16, quantized=False, seed=200 + i)
        args = (case["q"], case["k"], case["v"], case["tables"],
                case["offsets"])

        def fn():
            return paged_decode_attention(*args, window=4096)

        order_sweep(case["name"], fn(), fn)
        del case, args
    torch.cuda.empty_cache()


def mask_planted_fault(case, exact):
    """The per-element masks of the tensor-core mode are checked: the
    kernel run with the window edge 3 positions late (inside a pool
    block, so only a key tile's element masks see it) must fail the row
    tolerance."""
    from torchdistpackage_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
    )

    got = paged_decode_attention(case["q"], case["k"], case["v"],
                                 case["tables"], case["offsets"],
                                 window=case["window"] + 3)
    err, ratio = held(got, exact, case["q"].dtype)
    log(f"[kernel] {case['name']}, planted fault (window edge 3 positions "
        f"late): max abs err {err:.3g}, {ratio:.1f} x the row tolerance")
    if ratio <= 1.0:
        raise RuntimeError(f"{case['name']}: the row tolerance misses a "
                           f"planted fault (window edge 3 positions late)")


def planted_faults(case, exact):
    """The check must catch the faults it is there for.  The kernel is
    run on deliberately wrong arguments and held against the plain
    version on the right ones: the window edge one pool block late, and
    one stage of 8 blocks of the deepest slot read from other blocks
    (a stage lost or misplaced).  Each must fail the row tolerance."""
    from torchdistpackage_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
    )

    q, tables, offs = case["q"], case["tables"], case["offsets"]
    deep = int(offs.argmax())
    first = int(offs[deep]) // BS - 8 * 4  # a stage well inside the window
    moved = tables.clone()
    moved[deep, first:first + 8] = moved[(deep + 1) % len(offs),
                                         first:first + 8]
    faults = {
        "window one block late": (tables, case["window"] + BS),
        "one stage read from other blocks": (moved, case["window"]),
    }
    whole = 2.0 * 2.0 ** (np.floor(np.log2(float(exact.abs().max()))) - 7)
    for what, (tab, window) in faults.items():
        got = paged_decode_attention(q, case["k"], case["v"], tab, offs,
                                     window=window)
        err, ratio = held(got, exact, q.dtype)
        log(f"[kernel] {case['name']}, planted fault ({what}): max abs err "
            f"{err:.3g}, {ratio:.1f} x the row tolerance (one tolerance "
            f"for the whole output, {whole:.3g}, would "
            f"{'catch' if err > whole else 'miss'} it)")
        if ratio <= 1.0:
            raise RuntimeError(
                f"{case['name']}: the row tolerance misses a planted fault "
                f"({what})")


# ------------------------------------------------------------ phase 4


def flash_case(name, *, B, H, Hkv, S, hd, window, dtype, seed):
    """Random q, k, v, dO and an lse cotangent on the card (causal)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    return {"name": name, "q": rnd(B, H, S, hd), "k": rnd(B, Hkv, S, hd),
            "v": rnd(B, Hkv, S, hd), "do": rnd(B, H, S, hd),
            "dlse": torch.randn(B, H, S, generator=g, device="cuda"),
            "window": window, "dtype": dtype, "scale": hd ** -0.5}


def flash_bounds(case):
    """Least time for each kernel's call: operations over the peak for
    the inputs' type (4 hd FLOP a visible (query, key) pair for the
    forward's two products, 6 hd for dq's three, 8 hd for dk/dv's four),
    or the bytes it must move (each input once, each output once) over
    the memory rate, whichever is larger."""
    q, k = case["q"], case["k"]
    B, H, S, hd = q.shape
    i = np.arange(S)
    seen = i + 1 if case["window"] is None else np.minimum(i + 1,
                                                           case["window"])
    pairs = B * H * int(seen.sum())
    e = q.element_size()
    qb, kb, rows = q.numel() * e, k.numel() * e, B * H * S * 4
    work = {"flash_fwd": (4 * hd * pairs, 2 * qb + 2 * kb + rows),
            "flash_bwd_dq": (6 * hd * pairs, 3 * qb + 2 * kb + 2 * rows),
            "flash_bwd_dkv": (8 * hd * pairs, 2 * qb + 4 * kb + 2 * rows)}
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / PEAK_FLOPS[q.dtype]
        t_bytes = nbytes / HBM_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes", flops)
    return out


def grad_held(got, want, scale, dtype):
    """Gradients, row by row.  f32: 2e-5 of the row's largest |value|, and
    at least 2e-5 — a dk/dv row sums G x window terms (16384 at Mistral's
    shape; the group sum inside the kernel, outside in the plain version),
    so the summation-order error grows with the sum's size.  bf16: 2 bf16
    ulps of the row's largest |value| (the final rounding) plus 4 x 2^-8
    of the row's largest rounding scale (``grad_rounding_scale`` — the
    kernel rounds P or dS to bf16 before each product, as the TPU kernel
    does, moving every term by up to 2^-8 of itself in random
    directions; 4 such scales are about 7 standard deviations)."""
    err = (got.float() - want.float()).abs().amax(-1)
    big = want.float().abs().amax(-1)
    if dtype == torch.float32:
        tol = 2e-5 * big.clamp_min(1.0)
    else:
        tol = row_tolerance(want, dtype) + 4.0 * 2.0 ** -8 * scale.amax(-1)
    ratio = float((err / tol).max())
    if not torch.isfinite(got).all():
        ratio = float("inf")
    return float(err.max()), ratio


def sdpa_flash_ms(case, iters):
    """One PyTorch call as the yardstick (never called by the port):
    SDPA forward, and forward + backward, causal (with the window as a
    boolean mask where there is one; GQA through ``enable_gqa``)."""
    q, k, v, do = (case[n].detach().clone() for n in ("q", "k", "v", "do"))
    S = q.shape[2]
    kw = {"enable_gqa": q.shape[1] != k.shape[1]}
    if case["window"] is None:
        kw["is_causal"] = True
    else:
        i = torch.arange(S, device="cuda")
        kw["attn_mask"] = ((i[None] <= i[:, None])
                           & (i[None] > i[:, None] - case["window"]))
    fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, **kw),
                  iters)
    for t in (q, k, v):
        t.requires_grad_(True)

    def fwd_bwd():
        F.scaled_dot_product_attention(q, k, v, **kw).backward(do)
    both = cuda_ms(fwd_bwd, iters)
    return fwd, both - fwd


def flash_kernel_phase():
    """K3, K4 and K5 against their plain versions on the card, at the
    training shape and at Mistral-7B's attention, in bf16 and f32, row by
    row against the plain version run in f32 on the same values; planted
    faults must fail the same checks; then times beside the bounds."""
    from torchdistpackage_tpu_torch.ops import flash_attention as fa

    bf, f32 = torch.bfloat16, torch.float32
    train = dict(B=16, H=12, Hkv=12, S=2048, hd=64, window=None)
    mistral = dict(B=1, H=32, Hkv=8, S=8192, hd=128, window=4096)
    specs = [("train_bf16", dict(train, dtype=bf)),
             ("mistral_bf16_w4096", dict(mistral, dtype=bf)),
             ("train_f32", dict(train, dtype=f32)),
             ("mistral_f32_w4096", dict(mistral, dtype=f32))]
    rows = {n: [] for n in fa.LAUNCHES}
    for i, (name, spec) in enumerate(specs):
        case = flash_case(name, seed=200 + i, **spec)
        dt = spec["dtype"]
        q, k, v, do = (case[n] for n in ("q", "k", "v", "do"))
        args = (case["scale"], True, case["window"])
        exact = [t.float() for t in (q, k, v, do)]
        o_x, lse_x = fa.flash_fwd_reference(*exact[:3], *args)
        delta = fa.flash_delta(o_x, exact[3], case["dlse"])
        before = dict(fa.LAUNCHES)
        o, lse = fa.flash_fwd(q, k, v, *args)
        dq = fa.flash_bwd_dq(q, k, v, do, lse_x, delta, *args)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_x, delta, *args)
        torch.cuda.synchronize()
        if any(fa.LAUNCHES[n] != before[n] + 1 for n in before):
            raise RuntimeError(f"{name}: a launch counter did not move")
        dq_x = fa.flash_bwd_dq_reference(*exact, lse_x, delta, *args)
        dk_x, dv_x = fa.flash_bwd_dkv_reference(*exact, lse_x, delta, *args)
        sq, sk, sv = fa.grad_rounding_scale(*exact, lse_x, delta, *args)
        lse_err = float((lse - lse_x).abs().max())
        checks = {"flash_fwd": [held(o, o_x, dt),
                                (lse_err, lse_err / 2e-5)],
                  "flash_bwd_dq": [grad_held(dq, dq_x, sq, dt)],
                  "flash_bwd_dkv": [grad_held(dk, dk_x, sk, dt),
                                    grad_held(dv, dv_x, sv, dt)]}
        body = ("wgmma, TMA-fed tiles" if dt == bf
                else "CUDA cores (f32)")
        for kname, res in checks.items():
            err, ratio = max(r[0] for r in res), max(r[1] for r in res)
            log(f"[flash] {name} {kname} ({body}): vs the plain version in "
                f"f32: max abs err {err:.3g}, {ratio:.3f} of the row "
                f"tolerance" + (f" (lse err {lse_err:.3g})"
                                if kname == "flash_fwd" else ""))
            if not ratio <= 1.0:
                raise RuntimeError(
                    f"{name}: {kname} disagrees with its plain version: "
                    f"{ratio:.3f} of the row tolerance")
            rows[kname].append({"case": name, "body": body,
                                "max_abs_err": err, "tol_ratio": ratio})
        ref = {"o": o_x, "dq": dq_x, "dk": dk_x, "dv": dv_x, "delta": delta,
               "lse": lse_x, "scales": (sq, sk, sv)}
        if dt == bf:
            flash_planted_faults(case, ref)
        del o, lse, dq, dk, dv, dq_x, dk_x, dv_x, sq, sk, sv, ref
        torch.cuda.empty_cache()

        heavy = spec["S"] > 4096 or dt == f32
        n_k, n_p = (3, 2) if heavy else (10, 3)
        plain = {"flash_fwd": lambda: fa.flash_fwd_reference(q, k, v, *args),
                 "flash_bwd_dq": lambda: fa.flash_bwd_dq_reference(
                     q, k, v, do, lse_x, delta, *args),
                 "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_reference(
                     q, k, v, do, lse_x, delta, *args)}
        kern = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, *args),
                "flash_bwd_dq": lambda: fa.flash_bwd_dq(
                    q, k, v, do, lse_x, delta, *args),
                "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(
                    q, k, v, do, lse_x, delta, *args)}
        lib_fwd, lib_bwd = sdpa_flash_ms(case, n_k)
        bounds = flash_bounds(case)
        for kname in rows:
            ms = cuda_ms(kern[kname], n_k)
            plain_ms = cuda_ms(plain[kname], n_p)
            lib = lib_fwd if kname == "flash_fwd" else lib_bwd
            bound_ms, bound_by, flops = bounds[kname]
            rows[kname][-1].update(
                ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=bound_ms,
                bound_by=bound_by, tflops=flops / ms / 1e9)
            log(f"[flash] {name} {kname}: kernel {ms:.4f} ms "
                f"({flops / ms / 1e9:.1f} TFLOP/s)  plain {plain_ms:.4f} ms"
                f"  sdpa {'fwd' if kname == 'flash_fwd' else 'bwd'} "
                f"{lib:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})")
        del case, q, k, v, do, exact, o_x, lse_x, delta, plain, kern
        torch.cuda.empty_cache()
    for kname, ragged in flash_ragged_phase().items():
        rows[kname].extend(ragged)
    return rows


def dq_keys_late(case, ref, tile=128):
    """dq as K4 would give it if its dS.K product read the key tile one
    tile late (key j + tile in place of key j, zeros past the end), from
    the plain pieces in f32 with dS rounded to bf16 as the kernel rounds
    it.  S and dS.K read the same K, so no argument plants this fault: it
    is emulated on the output, as K7's rows in the next expert's block
    are."""
    from torchdistpackage_tpu_torch.ops import flash_attention as fa

    q, k, v, do = (case[n].float() for n in ("q", "k", "v", "do"))
    k_late = torch.cat([k[:, :, tile:], torch.zeros_like(k[:, :, :tile])],
                       dim=2)
    scale, groups = case["scale"], q.shape[1] // k.shape[1]
    keep = fa._mask(q.shape[2], k.shape[2], True, case["window"], q.device)
    dq = torch.empty_like(q)
    for h, sl in fa._per_kv_head(q, k, groups):
        p = fa._probs(q[:, sl], k[:, h:h + 1], ref["lse"][:, sl], scale,
                      keep)
        dp = torch.matmul(do[:, sl], v[:, h:h + 1].transpose(-1, -2))
        ds = (p * (dp - ref["delta"][:, sl, :, None])).to(
            case["dtype"]).float()
        dq[:, sl] = torch.matmul(ds, k_late[:, h:h + 1]) * scale
    return dq


def flash_planted_faults(case, ref):
    """The checks must catch the faults they are there for: the kernels
    run on deliberately wrong arguments, held against the plain version
    on the right ones.  Training shape: the backward without the dlse
    term (K4 and K5 given delta = rowsum(dO·O) alone); K3's diagonal one
    key late (each query row handed to K3 one position later, so query
    i sees keys up to i + 1 — held on rows 1.., against the right output
    of rows ..S-2); K5 reading its lse column one query off (lse shifted
    by one along the sequence); K4 reading delta one query row off
    (delta shifted by one); K4's dS.K on the key tile one tile late
    (emulated on the output, ``dq_keys_late``).  Mistral shape: the
    window bound one 64-row tile late (K3 and K5 given window + 64).
    Each must fail its row tolerance."""
    from torchdistpackage_tpu_torch.ops import flash_attention as fa

    q, k, v, do = (case[n] for n in ("q", "k", "v", "do"))
    dt, scale, window = case["dtype"], case["scale"], case["window"]
    sq, sk, sv = ref["scales"]
    faults = {}
    if window is None:
        no_dlse = fa.flash_delta(ref["o"], do.float(), None)
        faults["K4 without the dlse term"] = grad_held(
            fa.flash_bwd_dq(q, k, v, do, ref["lse"], no_dlse, scale, True,
                            None), ref["dq"], sq, dt)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref["lse"], no_dlse, scale,
                                  True, None)
        faults["K5 without the dlse term"] = max(
            grad_held(dk, ref["dk"], sk, dt), grad_held(dv, ref["dv"], sv, dt),
            key=lambda r: r[1])
        late = torch.cat([q[:, :, -1:], q[:, :, :-1]], dim=2).contiguous()
        o, _ = fa.flash_fwd(late, k, v, scale, True, None)
        faults["K3 diagonal one key late"] = held(
            o[:, :, 1:], ref["o"][:, :, :-1], dt)
        lse_off = torch.roll(ref["lse"], -1, dims=-1).contiguous()
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_off, ref["delta"], scale,
                                  True, None)
        faults["K5 lse column one query off"] = max(
            grad_held(dk, ref["dk"], sk, dt), grad_held(dv, ref["dv"], sv, dt),
            key=lambda r: r[1])
        delta_off = torch.roll(ref["delta"], -1, dims=-1).contiguous()
        faults["K4 delta one query row off"] = grad_held(
            fa.flash_bwd_dq(q, k, v, do, ref["lse"], delta_off, scale, True,
                            None), ref["dq"], sq, dt)
        faults["K4 dS.K on the key tile one tile late (emulated)"] = (
            grad_held(dq_keys_late(case, ref), ref["dq"], sq, dt))
    else:
        late = window + fa.TILE
        o, _ = fa.flash_fwd(q, k, v, scale, True, late)
        faults["K3 window one tile late"] = held(o, ref["o"], dt)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref["lse"], ref["delta"],
                                  scale, True, late)
        faults["K5 window one tile late"] = max(
            grad_held(dk, ref["dk"], sk, dt), grad_held(dv, ref["dv"], sv, dt),
            key=lambda r: r[1])
    for what, (err, ratio) in faults.items():
        log(f"[flash] {case['name']}, planted fault ({what}): max abs err "
            f"{err:.3g}, {ratio:.1f} x the row tolerance")
        if ratio <= 1.0:
            raise RuntimeError(f"{case['name']}: the check misses a planted "
                               f"fault ({what})")


FLASH_FAULT = ("TDP_FLASH_FAULT=1",)  # bf16 K3 without the key bound
RAGGED_S = (1, 63, 65, 100, 1000)
RAGGED_MASKS = (("causal", True, None), ("window 48", True, 48),
                ("non-causal", False, None))


def ragged_case(S, hd, causal, window, dtype, seed, Sk=None):
    """q, k, v, dO at a sequence length that is no multiple of any tile:
    hd 128 with Mistral's GQA group of 4 (8 query heads, 2 KV heads), hd
    64 without GQA (4 heads); ``Sk`` differs from S only non-causally."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    H, Hkv = (8, 2) if hd == 128 else (4, 4)
    Sk = S if Sk is None else Sk

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    return {"q": rnd(2, H, S, hd), "k": rnd(2, Hkv, Sk, hd),
            "v": rnd(2, Hkv, Sk, hd), "do": rnd(2, H, S, hd),
            "dlse": torch.randn(2, H, S, generator=g, device="cuda"),
            "args": (hd ** -0.5, causal, window)}


def ragged_check(case, dt):
    """K3, K4 and K5 on a ragged case against their plain versions in f32
    on the same values: ``{kernel: (max abs err, ratio)}``."""
    from torchdistpackage_tpu_torch.ops import flash_attention as fa

    q, k, v, do = (case[n] for n in ("q", "k", "v", "do"))
    args = case["args"]
    exact = [t.float() for t in (q, k, v, do)]
    o_x, lse_x = fa.flash_fwd_reference(*exact[:3], *args)
    delta = fa.flash_delta(o_x, exact[3], case["dlse"])
    o, lse = fa.flash_fwd(q, k, v, *args)
    dq = fa.flash_bwd_dq(q, k, v, do, lse_x, delta, *args)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_x, delta, *args)
    sq, sk, sv = fa.grad_rounding_scale(*exact, lse_x, delta, *args)
    dk_x, dv_x = fa.flash_bwd_dkv_reference(*exact, lse_x, delta, *args)
    lse_err = float((lse - lse_x).abs().max())
    fwd = held(o, o_x, dt)
    return {"flash_fwd": max(fwd, (lse_err, lse_err / 2e-5),
                             key=lambda r: r[1]),
            "flash_bwd_dq": grad_held(
                dq, fa.flash_bwd_dq_reference(*exact, lse_x, delta, *args),
                sq, dt),
            "flash_bwd_dkv": max(grad_held(dk, dk_x, sk, dt),
                                 grad_held(dv, dv_x, sv, dt),
                                 key=lambda r: r[1])}


def flash_ragged_phase():
    """K3-K5 at sequence lengths no tile divides (S 1, 63, 65, 100, 1000;
    hd 64 and 128; causal, window 48 and non-causal, plus a non-causal Sq
    100 over Sk 65; bf16 and f32), each held row by row against its plain
    version at the phase's tolerances, K3's bf16 calls timed beside SDPA's
    forward on the same shapes; then the planted fault (the build of
    bf16 K3 without its key bound) must fail a non-causal ragged case.
    Returns rows for the kernels line."""
    from torchdistpackage_tpu_torch.ops import _build
    from torchdistpackage_tpu_torch.ops import flash_attention as fa

    rows = {n: [] for n in fa.LAUNCHES}
    specs = [(S, None, hd, m, dt) for S in RAGGED_S for hd in (64, 128)
             for m in RAGGED_MASKS for dt in (torch.bfloat16, torch.float32)]
    specs += [(100, 65, hd, RAGGED_MASKS[2], dt) for hd in (64, 128)
              for dt in (torch.bfloat16, torch.float32)]
    for i, (S, Sk, hd, (mname, causal, window), dt) in enumerate(specs):
        case = ragged_case(S, hd, causal, window, dt, 300 + i, Sk=Sk)
        name = (f"ragged S {S}{'' if Sk is None else f' Sk {Sk}'} hd {hd} "
                f"{mname} {'bf16' if dt == torch.bfloat16 else 'f32'}")
        res = ragged_check(case, dt)
        extra = {}
        if dt == torch.bfloat16 and Sk is None:
            q, k, v = case["q"], case["k"], case["v"]
            extra["ms"] = cuda_ms(lambda: fa.flash_fwd(q, k, v,
                                                       *case["args"]), 20)
            kw = {"enable_gqa": q.shape[1] != k.shape[1]}
            if window is not None:
                i_ = torch.arange(S, device="cuda")
                kw["attn_mask"] = ((i_[None] <= i_[:, None])
                                   & (i_[None] > i_[:, None] - window))
            else:
                kw["is_causal"] = causal
            extra["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, **kw), 20)
        for kname, (err, ratio) in res.items():
            if not ratio <= 1.0:
                raise RuntimeError(f"{name}: {kname} disagrees with its "
                                   f"plain version: {ratio:.3f} of the row "
                                   f"tolerance")
            rows[kname].append({"case": name, "max_abs_err": err,
                                "tol_ratio": ratio,
                                **(extra if kname == "flash_fwd" else {})})
        log(f"[flash-ragged] {name}: " + ", ".join(
            f"{k} err {e:.3g} ({r:.3f} of tol)" for k, (e, r) in res.items())
            + (f"; K3 {extra['ms']:.4f} ms, sdpa fwd "
               f"{extra['library_ms']:.4f} ms" if extra else ""))
    # the generate path's own call: Mistral's prefill of 4 prompts of 1000
    case = flash_case("ragged generate prefill: Mistral B 4, S 1000",
                      B=4, H=32, Hkv=8, S=1000, hd=128, window=4096,
                      dtype=torch.bfloat16, seed=398)
    q, k, v = case["q"], case["k"], case["v"]
    args = (case["scale"], True, 4096)
    o_x, _ = fa.flash_fwd_reference(q.float(), k.float(), v.float(), *args)
    err, ratio = held(fa.flash_fwd(q, k, v, *args)[0], o_x,
                      torch.bfloat16)
    if not ratio <= 1.0:
        raise RuntimeError(f"{case['name']}: K3 disagrees with its plain "
                           f"version: {ratio:.3f} of the row tolerance")
    i_ = torch.arange(1000, device="cuda")
    mask = (i_[None] <= i_[:, None]) & (i_[None] > i_[:, None] - 4096)
    bound_ms, bound_by, _ = flash_bounds(case)["flash_fwd"]
    row = {"case": case["name"], "max_abs_err": err, "tol_ratio": ratio,
           "ms": cuda_ms(lambda: fa.flash_fwd(q, k, v, *args), 20),
           "plain_ms": cuda_ms(lambda: fa.flash_fwd_reference(q, k, v,
                                                              *args), 3),
           "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
               q, k, v, attn_mask=mask, enable_gqa=True), 20),
           "bound_ms": bound_ms, "bound_by": bound_by}
    rows["flash_fwd"].append(row)
    log(f"[flash-ragged] {case['name']}, window 4096, bf16: err {err:.3g} "
        f"({ratio:.3f} of tol); K3 {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, sdpa fwd {row['library_ms']:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    del case, q, k, v, o_x, mask
    bad = ragged_case(1000, 128, False, None, torch.bfloat16, 399)
    with _build.variant("flash_attention", FLASH_FAULT):
        err, ratio = ragged_check(bad, torch.bfloat16)["flash_fwd"]
    log(f"[flash-ragged] planted fault (bf16 K3 without the key bound, "
        f"non-causal S 1000 hd 128): max abs err {err:.3g}, {ratio:.1f} x "
        f"the row tolerance")
    if ratio <= 1.0:
        raise RuntimeError("ragged K3: the check misses the planted fault "
                           "(the key bound off)")
    return rows


# ------------------------------------------------------------ K6


MOE_SOURCE = "torchdistpackage_tpu_torch/ops/csrc/moe_dispatch.cu"
MOE_REPLACES = "torchdistpackage_tpu/ops/moe_dispatch.py:289"
MOE_NAME = "moe_dispatch"
# the planted-fault build of moe_dispatch.cu: the decode bodies' merge
# drops the last of a unit's pass-2 runs where it has more than one
MOE_RUN_DROPPED = ("TDP_MOE_FAULT=1",)


def moe_experts(*, E, D, F, act, dtype, seed):
    """Random experts on the card, the layouts of ``init_moe_params``,
    with random biases (the serving model's are zero) so the bias paths
    are checked too; drawn one expert at a time."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(shape, std):
        out = torch.empty(shape, dtype=dtype, device="cuda")
        for e in range(shape[0]):
            out[e] = torch.randn(shape[1:], generator=g, device="cuda") * std
        return out

    swiglu = act == "swiglu"
    return {"w1": rnd((E, 2, D, F) if swiglu else (E, D, F), D ** -0.5),
            "b1": rnd((E, 2, F) if swiglu else (E, F), 0.1),
            "w2": rnd((E, F, D), F ** -0.5), "b2": rnd((E, D), 0.1)}


def weight(w):
    """An expert weight leaf's weight tensor (q8 of an int8 pair)."""
    return w[0] if isinstance(w, tuple) else w


def moe_case(name, experts, *, T, C, k, seed):
    """Tokens and a serving routing decision on the card: router
    probabilities from random logits, top-k, ``_top_k_route`` at capacity
    C (C = T is the engine's no-drop bound; a smaller C drops), the slot
    maps the kernel takes."""
    from torchdistpackage_tpu_torch.ops.moe_dispatch import slot_maps
    from torchdistpackage_tpu_torch.parallel.moe import _top_k_route

    g = torch.Generator(device="cuda").manual_seed(seed)
    E, D = weight(experts["w2"]).shape[0], weight(experts["w2"]).shape[2]
    dtype = experts["b2"].dtype
    tokens = torch.randn(T, D, generator=g, device="cuda").to(dtype)
    probs = torch.softmax(torch.randn(T, E, generator=g, device="cuda") * 2,
                          dim=-1)
    gv, gi, slot, keep = _top_k_route(probs, k, C)
    idx, comb = slot_maps(gv, gi, slot, keep, C)
    return {"name": name, "experts": experts, "tokens": tokens, "idx": idx,
            "comb": comb, "gate_vals": gv, "gate_idx": gi, "k": k,
            "dtype": dtype}


def moe_held(got, exact, scale, dtype):
    """Output row by output row (one token's [D] vector) against the plain
    version run in f32 on the same values.  f32: 2e-5 of the row's largest
    |value| — F-split partial sums meet in the output by atomics, in an
    order that changes from run to run.  bf16: 2 bf16 ulps of the row's
    largest |value| (the output's rounding) plus 4 x 2^-8 of the row's
    largest rounding scale (``moe_rounding_scale``: the kernel rounds the
    activation to bf16 before the second product, moving each term of
    that sum by up to 2^-8 of itself in random directions)."""
    err = (got.float() - exact).abs().amax(-1)
    big = exact.abs().amax(-1)
    if dtype == torch.float32:
        tol = 2e-5 * big
    else:
        tol = row_tolerance(exact, dtype) + 4.0 * 2.0 ** -8 * scale.amax(-1)
    ratio = torch.where(err == 0, torch.zeros_like(err),
                        err / tol.clamp_min(1e-30))
    r = float(ratio.max())
    if not torch.isfinite(got).all():
        r = float("inf")
    return float(err.max()), r


def moe_bound(case):
    """Least time for the call: the bytes it must move (tokens in, each
    expert hit read once — W1, b1, W2, b2, and for int8 weights their
    scales — the maps, f32 out) over the memory rate, or its operations
    (2 FLOP a MAC: three D x F products a filled slot for SwiGLU, two for
    GELU) over the peak for the tokens' type."""
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves

    ex, comb = case["experts"], case["comb"]
    per_expert = sum(t[0].numel() * t.element_size()
                     for t in tree_leaves(ex))
    hit = int((comb != 0).any(-1).sum())
    filled = int((comb != 0).sum())
    T, D = case["tokens"].shape
    F_ = weight(ex["w2"]).shape[1]
    nbytes = (hit * per_expert + case["tokens"].numel()
              * case["tokens"].element_size() + T * D * 4
              + 2 * case["idx"].numel() * 4)
    flops = 2 * filled * (3 if weight(ex["w1"]).dim() == 4 else 2) * D * F_
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[case["dtype"]]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", hit, filled)


def moe_cases(tag, specs, counter, faults, gather_experts=None,
              lib_label="gather arm (per-expert cuBLAS calls)"):
    """Each case against the plain version (``moe_ffn_oracle``'s
    arithmetic, in f32 on the same values; int8 weights ``_dequant``-ed),
    row by row, naming the body it took (``moe_ffn_body``): the launch
    must move ``counter`` alone; ``faults(case, body)`` gives the planted
    faults of the first case each body takes (decode for the decode body,
    the prefill chunk for the warpgroup body, the f32 case for the walk)
    as ``(experts, idx, comb, scatter_idx)`` inputs, or with a fifth item
    the ``-D`` defines of a planted-fault build of the source to run them
    on, each of which must fail the same check; two launches of the
    decode body, and at top-2 of the warpgroup body, must agree bit for
    bit.  At the two Mixtral shapes the kernel, the plain version and the
    ragged ``'gather'`` arm (over ``gather_experts(experts)``, made
    outside the timing) are timed beside the bound and each call's
    kernels profiled (:func:`call_passes`); at decode the body is also
    timed from a CUDA graph (``graph_ms``) and the walk on the same inputs
    (``walk_ms``), and the three bodies are swept over C = T
    (:func:`moe_ffn_body_sweep`)."""
    from torchdistpackage_tpu_torch.ops import _build
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md
    from torchdistpackage_tpu_torch.parallel.moe import _ragged_ffn

    rows = []
    for name, case in specs:
        ex, tok, idx, comb = (case[n] for n in ("experts", "tokens", "idx",
                                                "comb"))
        dt = case["dtype"]
        before = dict(md.LAUNCHES)
        got = md.fused_moe_ffn_slots(ex, tok, idx, comb).to(dt)
        torch.cuda.synchronize()
        if {n: md.LAUNCHES[n] - before[n] for n in before} != {
                n: int(n == counter) for n in before}:
            raise RuntimeError(f"{name}: {counter} did not launch once "
                               f"(alone): {md.LAUNCHES}")
        exact = md.moe_ffn_slots_reference(ex, tok, idx, comb)
        scale = md.moe_rounding_scale(ex, tok, idx, comb)
        err, ratio = moe_held(got, exact, scale, dt)
        dropped = 1.0 - float((comb != 0).sum()) / (tok.shape[0] * case["k"])
        body = md.moe_ffn_body(idx.shape[1], dt)
        log(f"[{tag}] {name} ({body} body): T {tok.shape[0]}, C "
            f"{idx.shape[1]}, D {tok.shape[1]}, F "
            f"{weight(ex['w2']).shape[1]}, drop rate {dropped:.3f}: vs the "
            f"plain version in f32: max abs err {err:.3g}, {ratio:.3f} of "
            f"the row tolerance")
        if not ratio <= 1.0:
            raise RuntimeError(f"{name}: {counter} disagrees with its plain "
                               f"version: {ratio:.3f} of the row tolerance")
        row = {"case": name, "body": body, "max_abs_err": err,
               "tol_ratio": ratio}
        if body not in {r["body"] for r in rows}:
            for what, (exf, ix, cb, dst, *defines) in faults(
                    case, body).items():
                with (_build.variant(MOE_NAME, defines[0]) if defines
                      else contextlib.nullcontext()):
                    bad = md.fused_moe_ffn_slots(exf, tok, ix, cb,
                                                 scatter_idx=dst).to(dt)
                f_err, f_ratio = moe_held(bad, exact, scale, dt)
                log(f"[{tag}] {name} ({body} body), planted fault ({what}): "
                    f"max abs err {f_err:.3g}, {f_ratio:.1f} x the row "
                    f"tolerance")
                if f_ratio <= 1.0:
                    raise RuntimeError(f"{name}: the row tolerance misses a "
                                       f"planted fault ({what})")
                del exf, bad
        if body == "decode" or (body == "wgmma" and case["k"] <= 2):
            row["repeatable"] = bool(torch.equal(
                got, md.fused_moe_ffn_slots(ex, tok, idx, comb).to(dt)))
            log(f"[{tag}] {name}: two launches bit-identical: "
                f"{row['repeatable']}")
            if not row["repeatable"]:
                raise RuntimeError(f"{name}: at top-{case['k']} two launches "
                                   f"of the {body} body differ")
        if name.endswith("_mixtral"):
            heavy = tok.shape[0] > 8
            ms = cuda_ms(lambda: md.fused_moe_ffn_slots(ex, tok, idx, comb),
                         3 if heavy else 20)
            plain_ms = cuda_ms(lambda: md.moe_ffn_slots_reference(
                ex, tok, idx, comb), 1 if heavy else 5)
            lib_ex = gather_experts(ex) if gather_experts else ex
            lib_ms = cuda_ms(lambda: _ragged_ffn(
                lib_ex, tok, case["gate_vals"], case["gate_idx"]),
                3 if heavy else 20)
            del lib_ex
            bound_ms, bound_by, hit, filled = moe_bound(case)
            row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       experts_hit=hit, filled_slots=filled)
            log(f"[{tag}] {name}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
                f"  {lib_label} {lib_ms:.4f} ms  bound {bound_ms:.4f} ms "
                f"({bound_by}; {hit} experts hit, {filled} filled slots)")
            row["passes"] = call_passes(
                tag, f"T = C = {tok.shape[0]}",
                lambda: md.fused_moe_ffn_slots(ex, tok, idx, comb))
            if not heavy:
                # the decode body from a CUDA graph (the capture also shows
                # the call reads nothing back), and the walk it replaced
                # on the same inputs
                row["graph_ms"] = graph_ms(
                    lambda: md.fused_moe_ffn_slots(ex, tok, idx, comb), 20)
                row["walk_ms"] = pinned_body_ms(
                    "walk", lambda: md.fused_moe_ffn_slots(ex, tok, idx,
                                                           comb))
                log(f"[{tag}] {name}: {body} body from a CUDA graph "
                    f"{row['graph_ms']:.4f} ms; the walk on the same inputs "
                    f"{row['walk_ms']:.4f} ms")
                row["body_sweep"] = moe_ffn_body_sweep(tag, ex)
        rows.append(row)
        del case, got, exact, scale
        torch.cuda.empty_cache()
    return rows


MOE_BODY_PINS = {"wgmma": (1, 1), "decode": (1 << 30, 1),
                 "walk": (1 << 30, 1 << 30)}


def pinned_body_ms(body, fn, iters=20):
    """``cuda_ms`` of ``fn`` with K6 pinned to ``body`` by its thresholds
    (``MOE_FFN_WGMMA_C_MIN``, ``MOE_FFN_DECODE_C_MIN``), restored after."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    mins = (md.MOE_FFN_WGMMA_C_MIN, md.MOE_FFN_DECODE_C_MIN)
    try:
        md.MOE_FFN_WGMMA_C_MIN, md.MOE_FFN_DECODE_C_MIN = MOE_BODY_PINS[body]
        return cuda_ms(fn, iters)
    finally:
        md.MOE_FFN_WGMMA_C_MIN, md.MOE_FFN_DECODE_C_MIN = mins


def moe_ffn_body_sweep(tag, ex, sizes=(1, 2, 4, 8, 12, 16, 32, 48, 64)):
    """K6's three bodies on ``ex`` at C = T (top-2, a serving routing) for
    each T of ``sizes``: the measurement ``MOE_FFN_WGMMA_C_MIN`` (the
    warpgroup body against the decode body) and ``MOE_FFN_DECODE_C_MIN``
    (the decode body against the walk) rest on.  Returns {T: {body:
    ms}}."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    mins, out = (md.MOE_FFN_WGMMA_C_MIN, md.MOE_FFN_DECODE_C_MIN), {}
    for T in sizes:
        c = moe_case("sweep", ex, T=T, C=T, k=2, seed=T)
        args = (ex, c["tokens"], c["idx"], c["comb"])
        out[T] = {body: pinned_body_ms(
            body, lambda: md.fused_moe_ffn_slots(*args), 10)
            for body in MOE_BODY_PINS}
        log(f"[{tag}] body sweep, C = T = {T} ({moe_bound(c)[2]} experts "
            f"hit): " + ", ".join(f"{b} {t:.4f} ms"
                                  for b, t in out[T].items())
            + f" (C_MIN {mins[0]}, DECODE_C_MIN {mins[1]})")
    return out


def flip_halves(leaf):
    """w1's (or b1's) gate and up halves (dim 1) exchanged, an int8
    pair's scales with them."""
    if isinstance(leaf, tuple):
        return tuple(t.flip(1).contiguous() for t in leaf)
    return leaf.flip(1).contiguous()


def moe_chunk_faults(case):
    """The warpgroup body's planted faults on a chunk case, as
    ``moe_cases`` takes them: the gate weight not applied, the last F tile
    left out, the scatter on the neighbouring slot's token, the gather
    from the neighbouring slot's token (idx rolled, scatter_idx kept), a
    filled tile treated as empty (its comb zeroed on the kernel side
    only) and gate and up swapped."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    ex, idx, comb = case["experts"], case["idx"], case["comb"]
    cut = weight(ex["w2"]).clone()
    cut[:, -md.TILE:, :] = 0
    empty = comb.clone()
    empty[0, :md.CHUNK_ROWS] = 0
    rolled = torch.roll(idx, -1, dims=1).contiguous()
    q = isinstance(ex["w2"], tuple)
    return {
        "gate weight not applied": (ex, idx, (comb != 0).float(), None),
        "last F tile left out": (
            dict(ex, w2=(cut, ex["w2"][1]) if q else cut), idx, comb, None),
        "scatter on the neighbouring slot's token": (ex, idx, comb, rolled),
        "gathered from the neighbouring slot's token": (ex, rolled, comb,
                                                        idx),
        "a filled tile treated as empty": (ex, idx, empty, None),
        "gate and up swapped": (dict(ex, w1=flip_halves(ex["w1"]),
                                     b1=flip_halves(ex["b1"])), idx, comb,
                                None),
    }


def moe_decode_faults(case):
    """The decode body's planted faults on a decode case, as ``moe_cases``
    takes them: the gate weight not applied, the last F tile left out,
    the scatter on the neighbouring slot's token, the gather from the
    neighbouring slot's token (idx rolled, scatter_idx kept), a hit
    expert treated as unhit (its comb zeroed on the kernel side only),
    and one pass-2 run dropped from the merge (the planted-fault build)."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    ex, idx, comb = case["experts"], case["idx"], case["comb"]
    cut = weight(ex["w2"]).clone()
    cut[:, -md.TILE:, :] = 0
    unhit = comb.clone()
    unhit[int(torch.nonzero(comb)[0, 0])] = 0
    rolled = torch.roll(idx, -1, dims=1).contiguous()
    q = isinstance(ex["w2"], tuple)
    return {
        "gate weight not applied": (ex, idx, (comb != 0).float(), None),
        "last F tile left out": (
            dict(ex, w2=(cut, ex["w2"][1]) if q else cut), idx, comb, None),
        "scatter on the neighbouring slot's token": (ex, idx, comb, rolled),
        "gathered from the neighbouring slot's token": (ex, rolled, comb,
                                                        idx),
        "a hit expert treated as unhit": (ex, idx, unhit, None),
        "one pass-2 run dropped from the merge": (ex, idx, comb, None,
                                                  MOE_RUN_DROPPED),
    }


def moe_specs(make, seed, variant=""):
    """The K6 cases, lazily (one case's experts on the card at a time,
    the Mixtral stack shared by its two shapes): Mixtral-8x7B widths (E 8,
    top-2, D 4096, F 14336, SwiGLU, bf16 tokens) at decode (T 8) and a
    512-row chunk of 8 slots (T 4096) at the serving capacity C = T; GELU
    and f32 at smaller widths; capacity drops with C 100 (not a multiple
    of the 64-slot tile).  ``make(**kw)`` makes the experts; ``variant``
    ('' or 'int8') goes into the case names."""
    bf, f32 = torch.bfloat16, torch.float32
    mixtral = make(E=8, D=4096, F=14336, act="swiglu", dtype=bf, seed=seed)
    big = variant or "bf16"
    cases = [(f"decode_{big}_mixtral", lambda: mixtral, dict(T=8, C=8, k=2)),
             (f"prefill4096_{big}_mixtral", lambda: mixtral,
              dict(T=4096, C=4096, k=2))]
    small = [("gelu", "bf16", dict(act="gelu", F=4096, dtype=bf),
              dict(T=256, C=256, k=2)),
             ("swiglu", "f32", dict(act="swiglu", F=1408, dtype=f32),
              dict(T=128, C=128, k=2)),
             ("drops_c100", "bf16", dict(act="swiglu", F=2048, dtype=bf),
              dict(T=512, C=100, k=2))]
    for i, (base, dt, kw, shape) in enumerate(small):
        name = "_".join(filter(None, (base, variant, dt)))
        cases.append((name, lambda kw=kw, i=i: make(
            E=8, D=1024, seed=seed + 1 + i, **kw), shape))
    for i, (name, experts, shape) in enumerate(cases):
        yield name, moe_case(name, experts(), seed=seed + 10 + i, **shape)


def moe_kernel_phase():
    """K6 (float experts) on the :func:`moe_specs` cases, bf16 where not
    named f32.  Planted faults at the decode shape (the decode body):
    :func:`moe_decode_faults`; at the chunk (the warpgroup body)
    :func:`moe_chunk_faults`; on the f32 case (the walk) the gate weight
    not applied (every filled slot's g taken as 1), the last F tile left
    out (its W2 rows zeroed) and the scatter landing on the neighbouring
    slot's token.  Yardstick: the ragged ``'gather'`` arm (one cuBLAS
    product per expert and weight — several calls, the nearest library
    yardstick; the kernel path never calls it)."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    def faults(case, body):
        if body == "wgmma":
            return moe_chunk_faults(case)
        if body == "decode":
            return moe_decode_faults(case)
        ex, idx, comb = case["experts"], case["idx"], case["comb"]
        w2 = ex["w2"].clone()
        w2[:, -md.TILE:, :] = 0
        return {
            "gate weight not applied": (ex, idx, (comb != 0).float(), None),
            "last F tile left out": (dict(ex, w2=w2), idx, comb, None),
            "scatter on the neighbouring slot's token": (
                ex, idx, comb, torch.roll(idx, -1, dims=1).contiguous()),
        }

    return moe_cases("moe", moe_specs(moe_experts, 300), "fused_moe_ffn",
                     faults)


# K6's bodies (``moe_ffn_body``) by the kernels each launches
MOE_BODY_KERNELS = {
    "decode": "moe_ffn_up_decode_kernel, moe_ffn_down_decode_kernel, "
              "moe_ffn_merge_kernel",
    "wgmma": "moe_ffn_up_wgmma_kernel, moe_ffn_down_wgmma_kernel",
    "walk": "moe_ffn_kernel / moe_ffn_int8_kernel",
}
MOE_INT8_REPLACES = ("torchdistpackage_tpu/ops/moe_dispatch.py:348 "
                     "(_kernel quantized branch :253-258)")


def dequant_bf16(experts):
    """int8 ``(q8, scale)`` expert leaves -> bf16 weights, one expert at a
    time (the f32 product of a whole Mixtral stack would be 5.6 GB)."""
    out = dict(experts)
    for n in ("w1", "w2"):
        q, s = experts[n]
        w = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
        for e in range(q.shape[0]):
            w[e] = (q[e].float() * s[e].unsqueeze(-2)).to(torch.bfloat16)
        out[n] = w
    return out


def moe_int8_kernel_phase():
    """K6's int8 variant on the :func:`moe_specs` cases, experts drawn as
    for K6 and put through ``quantize_moe_experts`` (f32 tokens in the
    f32 case), held under K6's rule with the row's ``moe_rounding_scale``
    taken on the dequantised weights.  Planted faults on the first case
    of each body: w2's scale not applied (all ones), the up half scaled
    by the gate's scale row, and each column scaled by its neighbour's
    scale (both scale rows rolled by one column); at decode (the decode
    body) those and :func:`moe_decode_faults`, at the chunk (the
    warpgroup body) those and :func:`moe_chunk_faults`.  Yardstick: the ragged ``'gather'`` arm
    over bf16 weights dequantised once, outside the timing — no single
    PyTorch call computes a bf16 x int8-weight product."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    def int8(**kw):
        return md.quantize_moe_experts(moe_experts(**kw))

    def faults(case, body):
        ex, idx, comb = case["experts"], case["idx"], case["comb"]
        (q1, s1), (q2, s2) = ex["w1"], ex["w2"]
        gate_twice = s1.clone()
        gate_twice[:, 1] = s1[:, 0]
        out = {
            "w2's scale not applied": (
                dict(ex, w2=(q2, torch.ones_like(s2))), idx, comb, None),
            "the up half scaled by the gate's scale row": (
                dict(ex, w1=(q1, gate_twice)), idx, comb, None),
            "each column scaled by its neighbour's scale": (dict(
                ex, w1=(q1, torch.roll(s1, 1, dims=-1).contiguous()),
                w2=(q2, torch.roll(s2, 1, dims=-1).contiguous())), idx,
                comb, None),
        }
        if body == "wgmma":
            out.update(moe_chunk_faults(case))
        if body == "decode":
            out.update(moe_decode_faults(case))
        return out

    return moe_cases("moe-int8", moe_specs(int8, 400, "int8"),
                     "fused_moe_ffn_int8", faults,
                     gather_experts=dequant_bf16,
                     lib_label="gather arm over bf16 weights dequantised "
                               "beforehand (per-expert cuBLAS calls)")


# ------------------------------------------------------------ K7


K7_REPLACES = {
    "fused_expert_ffn": "torchdistpackage_tpu/ops/moe_dispatch.py:506",
    "fused_expert_ffn_int8": ("torchdistpackage_tpu/ops/moe_dispatch.py:506 "
                              "(_ep_kernel quantized branch :434-439)"),
}


def expert_ffn_bound(experts, x):
    """Least time for a K7 call: every row is computed, so the bytes are
    all e_loc experts' weights (W1, b1, W2, b2, and int8 scales) once,
    x in and y out, over the memory rate; the operations 2 e_loc G (3 or
    2) D F over the peak for x's type."""
    from torchdistpackage_tpu_torch.obs.numerics import tree_bytes

    E, G, D = x.shape
    F_ = weight(experts["w2"]).shape[1]
    nbytes = tree_bytes(experts) + 2 * x.numel() * x.element_size()
    flops = 2 * E * G * (3 if weight(experts["w1"]).dim() == 4 else 2) * D * F_
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[x.dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bmm_chain(experts, x):
    """The library yardstick for K7: one cuBLAS batched product per
    weight over the experts (``torch.bmm``), bias and activation between
    — several calls, as no single PyTorch call computes the function."""
    w1, b1, w2, b2 = (experts[n] for n in ("w1", "b1", "w2", "b2"))
    if w1.dim() == 4:
        g = torch.baddbmm(b1[:, 0, None], x, w1[:, 0])
        u = torch.baddbmm(b1[:, 1, None], x, w1[:, 1])
        h = F.silu(g) * u
    else:
        h = F.gelu(torch.baddbmm(b1[:, None], x, w1), approximate="tanh")
    return torch.baddbmm(b2[:, None], h, w2)


def expert_ffn_specs(make, seed, variant=""):
    """K7's cases, lazily (the Mixtral stack shared by its four shapes):
    Mixtral-8x7B expert widths (D 4096, F 14336, SwiGLU, bf16) at the
    per-rank shapes of EP 1 and EP 4 (e_loc 8 or 2) — decode, 8 slots of
    one token (G = C = T = 8 at EP 1; 4 ranks' 8 at EP 4), and a 512-row
    chunk of 8 slots (G = C = T = 4096; 16384 at EP 4); then GELU, f32
    rows and ragged G (not a multiple of the 64- or 128-row tile; F 1472
    not one of the warpgroup body's 128-column F tile) at smaller
    widths.  Each case's rows are random with a band of zero pad rows."""
    bf, f32 = torch.bfloat16, torch.float32
    mixtral = make(E=8, D=4096, F=14336, act="swiglu", dtype=bf, seed=seed)
    big = variant or "bf16"
    cases = [(f"decode_ep1_{big}_mixtral", lambda: mixtral, 8, 8),
             (f"decode_ep4_{big}_mixtral", lambda: mixtral, 2, 32),
             (f"chunk_ep1_{big}_mixtral", lambda: mixtral, 8, 4096),
             (f"chunk_ep4_{big}_mixtral", lambda: mixtral, 2, 16384)]
    small = [("gelu", "bf16", dict(act="gelu", F=4096, dtype=bf), 256),
             ("swiglu", "f32", dict(act="swiglu", F=1408, dtype=f32), 128),
             ("ragged_g100", "bf16", dict(act="swiglu", F=2048, dtype=bf),
              100),
             ("ragged_g200_f1472", "bf16",
              dict(act="swiglu", F=1472, dtype=bf), 200)]
    for i, (base, dt, kw, G) in enumerate(small):
        name = "_".join(filter(None, (base, variant, dt)))
        cases.append((name, lambda kw=kw, i=i: make(
            E=4, D=1024, seed=seed + 1 + i, **kw), 4, G))
    for i, (name, experts, e_loc, G) in enumerate(cases):
        ex = experts()
        ex = {n: (tuple(t[:e_loc] for t in v) if isinstance(v, tuple)
                  else v[:e_loc]) for n, v in ex.items()}
        g = torch.Generator(device="cuda").manual_seed(seed + 20 + i)
        D = weight(ex["w2"]).shape[2]
        x = torch.randn(e_loc, G, D, generator=g, device="cuda")
        x[:, G // 2:G // 2 + G // 8 + 1] = 0  # pad rows
        yield name, ex, x.to(ex["b2"].dtype)


def expert_ffn_cases(tag, specs, counter, faults, lib_experts=None):
    """Each K7 case against ``expert_ffn_reference`` (f32 on the same
    values) row by row under ``moe_held``'s rule with
    ``expert_ffn_rounding_scale``, naming the body it took
    (``expert_ffn_body``); the launch must move ``counter`` alone;
    ``faults(ex, x, got, body)`` gives the planted faults of the first
    case each body takes, each of which must fail.  At the Mixtral shapes the kernel, the
    plain version and the ``torch.bmm`` chain (over ``lib_experts(ex)``,
    made outside the timing) are timed beside the bound."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    rows = []
    for name, ex, x in specs:
        dt = x.dtype
        before = dict(md.LAUNCHES)
        got = md.fused_expert_ffn(ex, x)
        torch.cuda.synchronize()
        if {n: md.LAUNCHES[n] - before[n] for n in before} != {
                n: int(n == counter) for n in before}:
            raise RuntimeError(f"{name}: {counter} did not launch once "
                               f"(alone): {md.LAUNCHES}")
        exact = md.expert_ffn_reference(ex, x)
        scale = md.expert_ffn_rounding_scale(ex, x)
        err, ratio = moe_held(got, exact, scale, dt)
        E, G, D = x.shape
        body = md.expert_ffn_body(G, dt)
        log(f"[{tag}] {name} ({body} body): e_loc {E}, G {G}, D {D}, F "
            f"{weight(ex['w2']).shape[1]}: vs the plain version in f32: max "
            f"abs err {err:.3g}, {ratio:.3f} of the row tolerance")
        if not ratio <= 1.0:
            raise RuntimeError(f"{name}: {counter} disagrees with its plain "
                               f"version: {ratio:.3f} of the row tolerance")
        row = {"case": name, "body": body, "max_abs_err": err,
               "tol_ratio": ratio}
        if body == "decode":
            row["repeatable"] = bool(torch.equal(
                got, md.fused_expert_ffn(ex, x)))
            log(f"[{tag}] {name}: two launches bit-identical: "
                f"{row['repeatable']}")
            if not row["repeatable"]:
                raise RuntimeError(f"{name}: two launches of the decode "
                                   f"body differ")
        if body not in {r["body"] for r in rows}:
            for what, bad in faults(ex, x, got, body).items():
                f_err, f_ratio = moe_held(bad, exact, scale, dt)
                log(f"[{tag}] {name} ({body} body), planted fault ({what}): "
                    f"max abs err {f_err:.3g}, {f_ratio:.1f} x the row "
                    f"tolerance")
                if f_ratio <= 1.0:
                    raise RuntimeError(f"{name}: the row tolerance misses a "
                                       f"planted fault ({what})")
        if name.endswith("_mixtral"):
            heavy = G > 64
            ms = cuda_ms(lambda: md.fused_expert_ffn(ex, x), 3 if heavy else 20)
            plain_ms = cuda_ms(lambda: md.expert_ffn_reference(ex, x),
                               1 if heavy else 5)
            lib_ex = lib_experts(ex) if lib_experts else ex
            lib_ms = cuda_ms(lambda: bmm_chain(lib_ex, x), 3 if heavy else 20)
            del lib_ex
            bound_ms, bound_by = expert_ffn_bound(ex, x)
            row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
            if body == "decode":
                row["graph_ms"] = graph_ms(lambda: md.fused_expert_ffn(ex, x),
                                           20)
                log(f"[{tag}] {name}: decode body from a CUDA graph "
                    f"{row['graph_ms']:.4f} ms")
            log(f"[{tag}] {name}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
                f"  torch.bmm chain {lib_ms:.4f} ms  bound {bound_ms:.4f} ms "
                f"({bound_by})")
        if name.startswith(("chunk_ep1", "decode_ep1")):
            row["passes"] = call_passes(
                tag, list(x.shape), lambda: md.fused_expert_ffn(ex, x))
        if name.startswith("chunk_ep1"):
            row["body_sweep"] = expert_ffn_body_sweep(tag, ex, x)
        rows.append(row)
        del ex, x, got, exact, scale
        torch.cuda.empty_cache()
    return rows


def call_passes(tag, what, fn):
    """Device time of each kernel one call of ``fn`` launches, by
    ``torch.profiler``: a warpgroup body's up and down passes, and the
    wrapper's small kernels (zeroing, the tile list, a cast).  Returns
    {kernel: ms}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = re.sub(r"^void (\(anonymous namespace\)::)?", "", e.key)[:40]
            out[k] = out.get(k, 0.0) + e.self_device_time_total / 1e3
    log(f"[{tag}] one call at {what}, device time by kernel: "
        + (", ".join(f"{k} {v:.3f} ms" for k, v in out.items())
           or "not measured (the profiler recorded no kernels)"))
    return out


def expert_ffn_body_sweep(tag, ex, x, groups=(1, 8, 16, 32, 64, 96, 128)):
    """K7's three bodies on the first G rows of each expert's group: the
    measurement ``EXPERT_FFN_WGMMA_G_MIN`` (chunk body against decode
    body) and ``EXPERT_FFN_DECODE_G_MIN`` (decode body against the walk)
    rest on.  Returns {G: {body: ms}}."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    pins = {"wgmma": (1, 1), "decode": (1 << 30, 1),
            "walk": (1 << 30, 1 << 30)}
    mins = (md.EXPERT_FFN_WGMMA_G_MIN, md.EXPERT_FFN_DECODE_G_MIN)
    out = {}
    try:
        for G in groups:
            xs = x[:, :G].contiguous()
            out[G] = {}
            for body, pin in pins.items():
                md.EXPERT_FFN_WGMMA_G_MIN, md.EXPERT_FFN_DECODE_G_MIN = pin
                out[G][body] = cuda_ms(lambda: md.fused_expert_ffn(ex, xs),
                                       20)
            log(f"[{tag}] body sweep, e_loc {x.shape[0]}, G {G}: "
                + ", ".join(f"{b} {t:.4f} ms" for b, t in out[G].items())
                + f" (G_MIN {mins[0]}, DECODE_G_MIN {mins[1]})")
    finally:
        md.EXPERT_FFN_WGMMA_G_MIN, md.EXPERT_FFN_DECODE_G_MIN = mins
    return out


def expert_ffn_kernel_phase():
    """K7 and K7-int8 on the :func:`expert_ffn_specs` cases.  Planted
    faults on the first case of each body (EP 1 decode for the decode
    body, EP 1's chunk for the chunk body, the f32 case for the walk):
    the last F tile left out (its W2 rows zeroed), b2 added by every F
    tile (b2 scaled by the F-tile count), each row written to the next
    expert's block (the output rolled by one expert), for int8 w2's scale
    not applied, and on the two warpgroup bodies, which keep the gate and
    up accumulators side by side, the two swapped (silu(up) * gate: w1's
    and b1's halves, and int8 s1's, exchanged), and on the decode body
    one pass-2 run dropped from the merge (the planted-fault build).  Two
    launches of the decode body must agree bit for bit.  Yardstick: the
    ``torch.bmm`` chain (for int8 over bf16 weights dequantised
    beforehand)."""
    from torchdistpackage_tpu_torch.ops import _build
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    def faults(ex, x, got, body):
        w2 = weight(ex["w2"])
        n_f = w2.shape[1] // md.TILE
        if isinstance(ex["w2"], tuple):
            cut = (ex["w2"][0].clone(), ex["w2"][1])
        else:
            cut = w2.clone()
        weight(cut)[:, -md.TILE:] = 0
        out = {
            "last F tile left out": md.fused_expert_ffn(dict(ex, w2=cut), x),
            "b2 added by every F tile": md.fused_expert_ffn(
                dict(ex, b2=ex["b2"] * n_f), x),
            "each row in the next expert's block": torch.roll(got, 1, 0),
        }
        if isinstance(ex["w2"], tuple):
            q2, s2 = ex["w2"]
            out["w2's scale not applied"] = md.fused_expert_ffn(
                dict(ex, w2=(q2, torch.ones_like(s2))), x)
        if body != "walk" and weight(ex["w1"]).dim() == 4:
            out["gate and up swapped"] = md.fused_expert_ffn(
                dict(ex, w1=flip_halves(ex["w1"]),
                     b1=flip_halves(ex["b1"])), x)
        if body == "decode":
            with _build.variant(MOE_NAME, MOE_RUN_DROPPED):
                out["one pass-2 run dropped from the merge"] = (
                    md.fused_expert_ffn(ex, x))
        return out

    def int8(**kw):
        return md.quantize_moe_experts(moe_experts(**kw))

    k7 = expert_ffn_cases("k7", expert_ffn_specs(moe_experts, 500),
                          "fused_expert_ffn", faults)
    k7_int8 = expert_ffn_cases("k7-int8",
                               expert_ffn_specs(int8, 600, "int8"),
                               "fused_expert_ffn_int8", faults,
                               lib_experts=dequant_bf16)
    return {"fused_expert_ffn": k7, "fused_expert_ffn_int8": k7_int8}


# ------------------------------------------------------------ K2


CARRY_SOURCE = "torchdistpackage_tpu_torch/ops/csrc/paged_attention.cu"
CARRY_REPLACES = "torchdistpackage_tpu/ops/paged_attention.py:509"
NWARPS = 4  # K2's warps a CTA (its split-mode merge)


def slice_hops(case, n):
    """The case's pool cut into ``n`` slices of equal blocks (zero blocks
    pad the last), each with the table re-based by its first block: the
    per-rank work of cp ``n`` (one hop a slice), chained on one card."""
    k, v, tables = case["k"], case["v"], case["tables"]
    per = -(-k.shape[0] // n)
    pad = per * n - k.shape[0]
    if pad:
        k = torch.cat([k, k.new_zeros((pad,) + k.shape[1:])])
        v = torch.cat([v, v.new_zeros((pad,) + v.shape[1:])])
    return [(k[i * per:(i + 1) * per], v[i * per:(i + 1) * per],
             (tables - i * per).contiguous()) for i in range(n)]


def chain(fn, q, hops, offsets, window, carry_fault=None):
    """The carry through every hop in order; ``carry_fault`` maps the
    carry handed to each hop after the first (a planted fault)."""
    carry = None
    for i, (k, v, tab) in enumerate(hops):
        if i and carry_fault is not None:
            carry = carry_fault(carry)
        carry = fn(q, k, v, tab, offsets, carry=carry, window=window)
    return carry


def carry_held(got, exact, scale, dtype):
    """``(max abs err, max ratio to the tolerance)`` of K2's final carry
    against the plain version's in f32 on the same values.  The finished
    output row by row (``finalize_paged_carry`` in the working type): f32
    within 2e-5 (summation order only, as K1); bf16 within 2 ulps of the
    row's largest |value| (the output's rounding) plus 4 x 2^-8 of the
    row's largest ``paged_carry_rounding_scale`` (K2 rounds P to bf16
    before P.V, each term off by up to 2^-8 of itself in random
    directions: 4 scales are ~7 standard deviations).  The carry's ``m``
    within 1e-4 (1 + |m|) (f32 scores, summation order) and ``l`` within
    1e-4 of itself (a sequential f32 sum over up to ~300 blocks of 16
    keys)."""
    from torchdistpackage_tpu_torch.ops.paged_attention import (
        finalize_paged_carry,
    )

    B, H, S_in, hd = scale.shape
    out = finalize_paged_carry(got, B, H, S_in, hd, dtype).float()
    want = finalize_paged_carry(exact, B, H, S_in, hd, torch.float32)
    err = (out - want).abs().amax(-1)
    if dtype == torch.float32:
        tol = torch.full_like(err, 2e-5)
    else:
        big = want.abs().amax(-1).clamp_min(2.0 ** -100)
        tol = (2.0 * torch.exp2(torch.floor(torch.log2(big)) - 7)
               + 4.0 * 2.0 ** -8 * scale.amax(-1))
    ratios = [float((err / tol).max()),
              float(((got[1] - exact[1]).abs()
                     / (1e-4 * (1 + exact[1].abs()))).max()),
              float(((got[2] - exact[2]).abs()
                     / (1e-4 * exact[2]).clamp_min(1e-30)).max())]
    # a NaN anywhere (a row finished with l = 0 gives 0/0) fails
    if not (bool(torch.isfinite(out).all()) and all(
            bool(torch.isfinite(t).all()) for t in got)
            and all(np.isfinite(ratios))):
        return float(err.max()), float("inf")
    return float(err.max()), max(ratios)


def carry_bound(case, hops):
    """Least time for the chain: the bytes it must move (each hop: the
    live keys of ITS owned blocks once, q in, the carry out, the carry in
    after the first hop, tables, offsets) over the memory rate, or its
    operations (4 hd FLOP a visible owned (row, key) pair a head) over the
    peak for q's type — K1's ``bound`` restricted to owned blocks."""
    q = case["q"]
    B, H, S_in, hd = q.shape
    R = GROUPS * S_in
    offs, window = case["offsets"].tolist(), case["window"]
    carry_bytes = B * HKV * R * (hd + 2) * 4
    nbytes, pairs = 0, 0
    for i, (k, _v, tab) in enumerate(hops):
        owned = ((tab >= 0) & (tab < k.shape[0])).cpu().numpy()
        keys = 0
        for b, off in enumerate(offs):
            pos = np.repeat(owned[b], BS)
            cum = np.concatenate([[0], np.cumsum(pos)])
            qpos = off + np.arange(S_in)
            hi = np.minimum(qpos, len(pos) - 1)
            lo = np.zeros_like(qpos) if window is None else np.maximum(
                qpos - window + 1, 0)
            pairs += int(np.maximum(cum[hi + 1] - cum[lo], 0).sum())
            keys += int(cum[hi.max() + 1] - cum[lo.min()])
        nbytes += (2 * keys * HKV * hd * k.element_size()
                   + q.numel() * q.element_size() + carry_bytes * (1 + (i > 0))
                   + tab.numel() * 4 + B * 4)
    flops = 4 * pairs * GROUPS * HKV * hd
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def carry_kernel_phase():
    """K2 at the serving shapes (B 8, G 4, Hkv 8, hd 128, bs 16): decode
    (S_in 1, the split-KV body) and a 512-row chunk (row mode), windows
    4096, None and 64, bf16 and f32, and 4 slots of 32768 positions
    without a window; each as one hop over the whole pool (cp 1) and as a
    four-hop carry chain over four quarter-pool slices through re-based
    tables (the per-rank work of cp 4).  Each is held against the plain
    version in f32 on the same values (``carry_held``); decode chains
    are bit-identical over two launches.  Planted faults on the bf16
    window-4096 chains: the ownership mask off (the kernel given the
    re-based tables clamped into the slice, as the TPU kernel's index map
    fetches a remote block, so every remote entry reads a block it does
    not own), the carry not seeded (each hop after the first starts
    empty), the window one block late and, at decode, the carry merged
    once a warp (each hop after the first given the carry with acc and l
    times the 4 warps); on the bf16 decode chains (window 4096 and 32k)
    the planted-fault builds of the split path (``PAGED_FAULTS``).  Times
    (CUDA events around eager calls; decode also from a CUDA graph,
    ``graph_ms``): the kernel, the plain version, SDPA over the gathered
    view and K1 at the same one-hop shape."""
    from torchdistpackage_tpu_torch.ops.paged_attention import (
        LAUNCHES,
        paged_carry_attention,
        paged_carry_attention_reference,
        paged_carry_rounding_scale,
        paged_decode_attention,
    )

    decode_offs = [0, 17, 255, 1023, 2047, 3001, 4095, 4607]
    chunk_offs = [0, 512, 1024, 2048, 3072, 3584, 4096, 4608]
    specs = []
    for dtype in (torch.bfloat16, torch.float32):
        for s_in, offs in ((1, decode_offs), (512, chunk_offs)):
            for window in (4096, None, 64):
                name = (f"{'decode' if s_in == 1 else 'chunk512'}_"
                        f"{str(dtype)[6:].replace('loat', '')}_"
                        f"{'full' if window is None else f'w{window}'}")
                specs.append((name, s_in, offs, window, dtype))
    specs.append(("chunk200_bf16_w48", 200, chunk_offs, 48, torch.bfloat16))
    specs.append(("decode_bf16_full_32k", 1, LONG_OFFS, None,
                  torch.bfloat16))
    rows = []
    for i, (name, s_in, offs, window, dtype) in enumerate(specs):
        case = make_case(name, B=len(offs), S_in=s_in, offsets=offs,
                         window=window, dtype=dtype, quantized=False,
                         seed=300 + i)
        q, o = case["q"], case["offsets"]
        heavy = s_in > 8
        for n_hops in (1, 4):
            hops = slice_hops(case, n_hops)
            before = LAUNCHES["paged_carry_attention"]
            got = chain(paged_carry_attention, q, hops, o, window)
            torch.cuda.synchronize()
            if LAUNCHES["paged_carry_attention"] != before + n_hops:
                raise RuntimeError(f"{name}: the launch counter did not move")
            exact_hops = [(k.float(), v.float(), t) for k, v, t in hops]
            exact = chain(paged_carry_attention_reference, q.float(),
                          exact_hops, o, window)
            scale = paged_carry_rounding_scale(q, hops, o, window=window)
            err, ratio = carry_held(got, exact, scale, dtype)
            tag = f"{name} x{n_hops}"
            log(f"[carry] {tag}: vs the plain version in f32: max abs err "
                f"{err:.3g}, {ratio:.3f} of the tolerance")
            if not ratio <= 1.0:
                raise RuntimeError(
                    f"{tag}: K2 disagrees with its plain version: "
                    f"{ratio:.3f} of the tolerance")
            if s_in == 1:
                repeatable(tag, got, lambda: chain(
                    paged_carry_attention, q, hops, o, window))
            if n_hops == 4 and dtype == torch.bfloat16 and window == 4096:
                carry_planted_faults(tag, q, hops, o, window, exact, scale,
                                     split=s_in == 1)
            if n_hops == 4 and s_in == 1 and dtype == torch.bfloat16 and (
                    window == 4096 or name.endswith("32k")):
                for fault in PAGED_FAULTS:
                    bad = with_paged_fault(fault, lambda: chain(
                        paged_carry_attention, q, hops, o, window))
                    split_fault_fails(tag, fault, *carry_held(
                        bad, exact, scale, dtype))
            if n_hops == 4 and name == "chunk512_bf16_w64":
                bad = chain(paged_carry_attention, q, hops, o, window + 3)
                bad_err, bad_ratio = carry_held(bad, exact, scale, dtype)
                log(f"[carry] {tag}, planted fault (window edge 3 positions "
                    f"late): max abs err {bad_err:.3g}, {bad_ratio:.1f} x "
                    f"the tolerance")
                if bad_ratio <= 1.0:
                    raise RuntimeError(f"{tag}: the check misses a planted "
                                       f"fault (window edge 3 positions "
                                       f"late)")
                del bad
            ms = cuda_ms(lambda: chain(paged_carry_attention, q, hops, o,
                                       window), 5 if heavy else 50)
            g_ms = graph_ms(lambda: chain(paged_carry_attention, q, hops, o,
                                          window), 50) if s_in == 1 else None
            plain_ms = cuda_ms(lambda: chain(
                paged_carry_attention_reference, q, hops, o, window),
                2 if heavy else 10)
            bound_ms, bound_by = carry_bound(case, hops)
            row = {"case": tag, "max_abs_err": err, "tol_ratio": ratio,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                   "k1_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
                   "graph_ms": g_ms, "k1_graph_ms": None}
            if n_hops == 1:
                args = (q, case["k"], case["v"], case["tables"], o)
                row["library_ms"] = sdpa_ms(case, 5 if heavy else 50)
                def k1():
                    return paged_decode_attention(*args, window=window)
                row["k1_ms"] = cuda_ms(k1, 5 if heavy else 50)
                if s_in == 1:
                    row["k1_graph_ms"] = graph_ms(k1, 50)
            rows.append(row)
            log(f"[carry] {tag}: kernel {ms:.4f} ms"
                + (f" ({g_ms:.4f} ms from a CUDA graph)" if s_in == 1
                   else "")
                + f"  plain {plain_ms:.4f} ms"
                + (f"  sdpa {row['library_ms']:.4f} ms  K1 "
                   f"{row['k1_ms']:.4f} ms" if n_hops == 1 else "")
                + (f" ({row['k1_graph_ms']:.4f} from a CUDA graph)"
                   if n_hops == 1 and s_in == 1 else "")
                + f"  bound {bound_ms:.4f} ms ({bound_by})")
            del got, exact, scale, hops, exact_hops
        del case, q
        torch.cuda.empty_cache()
    return rows


def carry_planted_faults(tag, q, hops, offsets, window, exact, scale, split):
    """Each planted fault must fail ``carry_held`` (see
    :func:`carry_kernel_phase`)."""
    from torchdistpackage_tpu_torch.ops.paged_attention import (
        paged_carry_attention,
    )

    clamped = [(k, v, t.clamp(0, k.shape[0] - 1).contiguous())
               for k, v, t in hops]
    faults = {
        "ownership mask off": chain(paged_carry_attention, q, clamped,
                                    offsets, window),
        "carry not seeded": chain(paged_carry_attention, q, hops, offsets,
                                  window, carry_fault=lambda c: None),
        "window one block late": chain(paged_carry_attention, q, hops,
                                       offsets, window + BS),
    }
    if split:
        faults["carry merged once a warp"] = chain(
            paged_carry_attention, q, hops, offsets, window,
            carry_fault=lambda c: (c[0] * NWARPS, c[1], c[2] * NWARPS))
    for what, got in faults.items():
        err, ratio = carry_held(got, exact, scale, q.dtype)
        log(f"[carry] {tag}, planted fault ({what}): max abs err {err:.3g}, "
            f"{ratio:.1f} x the tolerance")
        if ratio <= 1.0:
            raise RuntimeError(f"{tag}: the check misses a planted fault "
                               f"({what})")


# ------------------------------------------------------------ phase 5


def reset_counts():
    """Every kernel's launch count to 0 (before a main path's run)."""
    from torchdistpackage_tpu_torch.ops import flash_attention as fa
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md
    from torchdistpackage_tpu_torch.ops import paged_attention as pa

    for counts in (fa.LAUNCHES, pa.LAUNCHES, md.LAUNCHES):
        for name in counts:
            counts[name] = 0


TRAIN_BATCH = 16  # bench.py's first candidate (:85), with remat 'flash'


def gpt_125m():
    """``bench.py``'s default training configuration (bench.py:984-987):
    GPT-125M widths, bf16, flash attention, loss over the full logits."""
    from torchdistpackage_tpu_torch.models import GPTConfig

    return GPTConfig(vocab_size=32768, dim=768, nheads=12, nlayers=12,
                     max_seq=2048, ffn_mult=4, dtype=torch.bfloat16,
                     attn_impl="flash")


def random_batch(cfg, rows, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (rows, cfg.max_seq)
    return {"tokens": torch.randint(0, cfg.vocab_size, shape, generator=g,
                                    device="cuda"),
            "targets": torch.randint(0, cfg.vocab_size, shape, generator=g,
                                     device="cuda")}


def matmul_params(params):
    """Parameters that enter a matmul's FLOPs, as ``bench.py`` counts
    them (:380-395): every leaf but the token and position tables."""
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves

    return sum(p.numel() for k, sub in params.items()
               if k not in ("tok_emb", "pos_emb") for p in tree_leaves(sub))


def train_run(cfg, rows, steps):
    """Random weights and one fixed random batch; ``steps`` AdamW steps
    through the entry points a user calls.  The kernels' counts are set
    to 0 just before the steps and read just after.  Returns the per-step
    losses and host-clock times, the counts, the peak memory, and the
    state for a later profile."""
    from torchdistpackage_tpu_torch.models import gpt_loss, init_gpt_params
    from torchdistpackage_tpu_torch.ops import flash_attention as fa
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        adamw,
        make_train_step,
    )

    params = init_gpt_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    opt = adamw(3e-4)
    state = opt.init(params)
    step = make_train_step(lambda p, b: gpt_loss(p, b, cfg, remat="flash"),
                           opt)
    batch = random_batch(cfg, rows, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, norms, times = [], [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss, gnorm = step(params, state, batch)
        losses.append(float(loss))  # reads back: waits for the step
        times.append(time.perf_counter() - t0)
        norms.append(float(gnorm))
        want = cfg.nlayers * (i + 1)
        if any(n != want for n in fa.LAUNCHES.values()):
            raise RuntimeError(
                f"flash launches {dict(fa.LAUNCHES)} after step {i + 1}: "
                f"each kernel must launch once a layer a step ({want})")
    launches = dict(fa.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"losses not finite and falling: {losses}")
    return {"losses": losses, "norms": norms, "times": times,
            "launches": launches, "peak_gb": peak_gb, "params": params,
            "state": state, "step": step, "batch": batch}


def train_phase(card):
    """The main path: GPT-125M, full depth, batch 16, S 2048, remat
    'flash', 10 AdamW steps on one fixed batch; then a profile of one
    step by kernel family."""
    cfg, rows = gpt_125m(), TRAIN_BATCH
    steps, warmup = 10, 3
    run = train_run(cfg, rows, steps)
    step_s = float(np.median(run["times"][warmup:]))
    tokens = rows * cfg.max_seq
    fpt = 6 * matmul_params(run["params"]) + 12 * cfg.nlayers * cfg.max_seq * cfg.dim
    mfu = fpt * tokens / step_s / PEAK_FLOPS[torch.bfloat16]
    log("[train] GPT-125M (bench.py's default: vocab 32768, d 768, 12 "
        "heads, 12 layers, S 2048, bf16, flash, remat 'flash'), batch 16: "
        "losses " + ", ".join(f"{x:.4f}" for x in run["losses"]))
    log(f"[train] step median {step_s * 1e3:.2f} ms after {warmup} warm-up "
        f"steps (all: " + ", ".join(f"{t * 1e3:.1f}" for t in run["times"])
        + f" ms); {tokens / step_s:.0f} tokens/s; MFU {mfu:.4f} (6N + 12LSD "
        f"= {fpt / 1e6:.1f} MFLOP a token against 989 TFLOP/s); peak memory "
        f"{run['peak_gb']:.2f} GB; launches {run['launches']} "
        f"({cfg.nlayers} a step each) — on {card}")
    # the GEMMs' work a step: 6N a token, plus remat's recompute of the
    # blocks' forward (2 N_blocks a token)
    n_blocks = matmul_params({"blocks": run["params"]["blocks"]})
    gemm_flop = (6 * matmul_params(run["params"]) + 2 * n_blocks) * tokens
    prof = profile_train_step(run, card, gemm_flop)
    out = {"launches": run["launches"], "losses": run["losses"],
           "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
           "mfu": mfu, "peak_gb": run["peak_gb"], "profile": prof}
    del run
    torch.cuda.empty_cache()
    return out


def profile_train_step(run, card, gemm_flop):
    """One more step under torch.profiler: device time by kernel family
    and the device's idle share over the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run["step"](run["params"], run["state"], run["batch"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0.0:
        log(f"[train] profiled step {wall_ms:.2f} ms; device time not "
            f"measured (the profiler recorded no kernels) — on {card}")
        return None
    rules = [("flash_fwd", r"flash_fwd"), ("flash_bwd_dq", r"flash_bwd_dq"),
             ("flash_bwd_dkv", r"flash_bwd_dkv"),
             ("gemm", r"gemm|xmma|cutlass|nvjet|sm90"),
             ("optimizer", r"adam|multi_tensor"),
             ("loss", r"softmax|nll|cross_entropy"),
             ("copy", r"copy|cat_|concat"), ("reduce", r"reduce"),
             ("elementwise", r"elementwise"), ("other", r"")]
    families = {fam: 0.0 for fam, _ in rules}
    for e in kernels:
        name = e.key.lower()
        fam = next(f for f, rx in rules if re.search(rx, name))
        families[fam] += e.self_device_time_total / 1e3
    log(f"[train] profiled step: {wall_ms:.2f} ms wall, device busy "
        f"{busy_ms:.2f} ms (idle {1 - busy_ms / wall_ms:.1%}); by family: "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in families.items())
        + f"; {sum(e.count for e in kernels)} kernels — on {card}")
    log(f"[train] GEMMs: {gemm_flop:.4g} FLOP a step in "
        f"{families['gemm']:.2f} ms = "
        f"{gemm_flop / families['gemm'] / 1e9:.1f} TFLOP/s, "
        f"{gemm_flop / families['gemm'] * 1e3 / PEAK_FLOPS[torch.bfloat16]:.3f}"
        f" of the bf16 peak")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:14]:
        log(f"[train]   {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<5d} {e.key[:110]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "families": families}


def loss_and_grads(params, cfg, batch, remat):
    from torchdistpackage_tpu_torch.models import gpt_loss
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves

    for p in tree_leaves(params):
        p.grad = None
    loss = gpt_loss(params, batch, cfg, remat=remat)
    loss.backward()
    loss = float(loss.detach())
    grads = {}

    def walk(tree, path):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, f"{path}/{key}")
            else:
                grads[f"{path}/{key}"] = val.grad.float()
    walk(params, "")
    return loss, grads


# kernel path vs plain path: bf16 rounds at other places on the two paths
# (the plain path's autograd rounds dP to bf16, the kernels keep it f32),
# and 12 layers carry those differences on (measured: loss 9e-5, worst
# leaf 0.012); f32 differs in summation order only (measured: loss 0,
# worst leaf 1.7e-6)
PATH_TOL = {torch.bfloat16: {"loss": 2e-3, "grad": 5e-2},
            torch.float32: {"loss": 2e-5, "grad": 2e-5}}


def path_parity_phase():
    """The kernel path (attn_impl 'flash', remat 'flash') against the plain
    path (attn_impl 'naive') on identical weights and batch, at batch 2
    (the plain path's f32 scores at batch 16 would not fit): the loss
    within an absolute tolerance, each gradient leaf within a relative
    L2 distance (``PATH_TOL``), in bf16 and in f32."""
    from torchdistpackage_tpu_torch.models import init_gpt_params
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves

    out = {}
    for dt in (torch.bfloat16, torch.float32):
        cfg = dataclasses.replace(gpt_125m(), dtype=dt)
        params = init_gpt_params(
            cfg, torch.Generator(device="cuda").manual_seed(0))
        for p in tree_leaves(params):
            p.requires_grad_(True)
        batch = random_batch(cfg, 2, 1)
        loss_k, g_k = loss_and_grads(params, cfg, batch, "flash")
        loss_p, g_p = loss_and_grads(
            params, dataclasses.replace(cfg, attn_impl="naive"), batch,
            False)
        rel = {k: float((g_k[k] - g_p[k]).norm()
                        / g_p[k].norm().clamp_min(1e-30)) for k in g_p}
        worst = max(rel, key=rel.get)
        tol = PATH_TOL[dt]
        log(f"[parity] {str(dt)[6:]}: loss kernel path {loss_k:.6f} / plain "
            f"path {loss_p:.6f} (diff {abs(loss_k - loss_p):.3g}, tol "
            f"{tol['loss']}); grads: worst leaf {worst} at relative L2 "
            f"{rel[worst]:.3g} (tol {tol['grad']}), median "
            f"{float(np.median(list(rel.values()))):.3g} over {len(rel)} "
            f"leaves")
        if not (abs(loss_k - loss_p) <= tol["loss"]
                and rel[worst] <= tol["grad"]):
            raise RuntimeError(f"kernel and plain paths disagree in {dt}")
        out[str(dt)[6:]] = {"loss_diff": abs(loss_k - loss_p),
                            "worst_grad_rel": rel[worst]}
        del params, g_k, g_p
        torch.cuda.empty_cache()
    return out


def mistral_train_phase(card):
    """A short second run at Mistral-7B-v0.1 widths: 2 layers, S 8192,
    batch 1, 2 steps — GQA, the 4096 window, RoPE and SwiGLU through the
    training path at real widths."""
    from torchdistpackage_tpu_torch.models import mistral_7b_config

    cfg = dataclasses.replace(mistral_7b_config(), nlayers=2,
                              max_seq=8192, attn_impl="flash")
    # 2 steps on a fresh model: the loss falls on its fixed batch
    run = train_run(cfg, 1, 2)
    log(f"[train] Mistral-7B-v0.1 widths, 2 layers, S 8192, batch 1: "
        f"losses " + ", ".join(f"{x:.4f}" for x in run["losses"])
        + f"; step times " + ", ".join(f"{t * 1e3:.1f}" for t in run["times"])
        + f" ms; peak memory {run['peak_gb']:.2f} GB; launches "
        f"{run['launches']} — on {card}")
    out = {"losses": run["losses"], "launches": run["launches"]}
    del run
    torch.cuda.empty_cache()
    return out


def dp_train_run(cfg, rows, steps, remat="flash", dp=None, dropout_key=None):
    """``steps`` AdamW steps of GPT ``cfg`` on the fixed batch of
    ``train_run`` (the same init seed and batch), through
    ``make_train_step`` or, with ``dp``, ``DataParallel.make_train_step``
    (the batch through ``dp.shard_batch``).  The kernels' counts are set
    to 0 just before the steps and read just after; the peak memory is
    over the steps, less what was allocated before the run began (so
    runs made one after another compare), its gradients freed at the
    end."""
    from torchdistpackage_tpu_torch.models import gpt_loss, init_gpt_params
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves
    from torchdistpackage_tpu_torch.ops import flash_attention as fa
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        adamw,
        make_train_step,
    )

    gc.collect()  # an earlier run's tensors, freed before the baseline
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = init_gpt_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    opt = adamw(3e-4)
    state = opt.init(params)

    def loss_fn(p, b):
        return gpt_loss(p, b, cfg, remat=remat, dropout_key=dropout_key)

    if dp is None:
        step = make_train_step(loss_fn, opt)
        batch = random_batch(cfg, rows, 1)
    else:
        step = dp.make_train_step(loss_fn, opt)
        batch = dp.shard_batch(random_batch(cfg, rows, 1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss, _ = step(params, state, batch)
        losses.append(float(loss))  # reads back: waits for the step
        times.append(time.perf_counter() - t0)
    out = {"losses": losses, "times": times, "launches": dict(fa.LAUNCHES),
           "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
           "params": params,
           "stats": None if dp is None else dict(dp.last_stats)}
    del state
    for p in tree_leaves(params):
        p.grad = None
    return out


def remat_memory(cfg, rows, modes):
    """For each remat mode, on one set of GPT ``cfg`` parameters (init
    seed 0) and ``train_run``'s batch: the card bytes allocated at the
    end of the forward and the peak over the forward and backward, both
    less what was allocated before the forward.  Each mode runs once to
    warm up (kernels built, library workspaces made), then once measured;
    the grads are freed after each pass, so every pass starts from the
    same allocations."""
    from torchdistpackage_tpu_torch.models import gpt_loss, init_gpt_params
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves

    params = init_gpt_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    batch = random_batch(cfg, rows, 1)

    def settle():
        torch.cuda.synchronize()
        # frees held back by record_stream (the offload copies) are
        # returned at the allocator's next call
        torch.empty(1, device="cuda")
        gc.collect()
        return torch.cuda.memory_allocated()

    out = {}
    for mode in modes:
        for _ in range(2):  # warm-up pass, measured pass
            for p in tree_leaves(params):
                p.grad = None
            base = settle()
            torch.cuda.reset_peak_memory_stats()
            loss = gpt_loss(params, batch, cfg, remat=mode)
            held = settle() - base
            loss.backward()
            del loss
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
        out[mode] = {"held": held, "peak": peak}
    for p in tree_leaves(params):
        p.grad = None
    del params, batch
    settle()
    return out


def median_ms(times, warmup=3):
    return float(np.median(times[warmup:])) * 1e3


DP_DROPOUT = 0.1


def dp_train_phase(card):
    """The data-parallel training path at world 1 on the card: a one-rank
    NCCL group (``init_distributed``), ``tpc.setup_process_groups([('data',
    1)])``, then GPT-125M as ``train_phase`` trains it (batch 16, S 2048,
    bf16, remat 'flash', 10 AdamW steps, the same init seed and batch):

    - through ``make_train_step`` and through ``DataParallel.make_train_step``
      (25 MB buckets, per-layer slice hooks): losses and every parameter
      after step 10 bit-identical (a mean over one rank is exact); K3-K5
      launched once a layer a step on the data-parallel run; step medians,
      the bucket count and the bytes whose all-reduce started before the
      backward returned and before the block stack's backward was done;
    - remat 'flash_offload' (o in pinned host memory): the losses equal
      the 'flash' run's, the step median; then ``remat_memory`` for both
      modes: the bytes held at the end of the forward lower by the kept
      ``o`` of every layer (``nlayers`` B S D 2 bytes, within 1 %) and
      the peak at least 0.5 GB lower;
    - residual dropout 0.1 keyed by ``axis_unique_key(key, 'data')``: two
      3-step runs bit-identical, finite, and apart from the rate-0 run."""
    import torch.distributed as dist

    from torchdistpackage_tpu_torch.dist import init_distributed, tpc
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        DataParallel,
    )
    from torchdistpackage_tpu_torch.utils import axis_unique_key

    cfg, rows, steps = gpt_125m(), TRAIN_BATCH, 10
    init_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0, "cuda")
    try:
        tpc.setup_process_groups([("data", 1)])
        group = tpc.get_group("data")
        if dist.get_backend(group) != "nccl":
            raise RuntimeError("the data group on the card must use NCCL")
        single = dp_train_run(cfg, rows, steps)
        dp = DataParallel()
        par = dp_train_run(cfg, rows, steps, dp=dp)
        same_params = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(par["params"]), tree_leaves(single["params"])))
        want = cfg.nlayers * steps
        s = par["stats"]
        log(f"[dp-train] GPT-125M, batch 16, S 2048, bf16, remat 'flash', "
            f"{steps} steps, DataParallel over a one-rank NCCL group: losses "
            + ", ".join(f"{x:.6f}" for x in par["losses"])
            + f"; bit-identical to make_train_step: losses "
            f"{par['losses'] == single['losses']}, parameters {same_params};"
            f" step median {median_ms(par['times']):.2f} ms (make_train_step "
            f"{median_ms(single['times']):.2f} ms); launches "
            f"{par['launches']} ({want} each); peak memory over the run's "
            f"start {par['peak_gb']:.3f} GB (make_train_step "
            f"{single['peak_gb']:.3f}) — on {card}")
        log(f"[dp-train] buckets a step {s['buckets']} of at most 25 MB, "
            f"{s['bytes'] / 1e6:.1f} MB reduced; all-reduce started before "
            f"the backward returned: {s['bytes_before_backward_returned'] / 1e6:.1f}"
            f" MB; before the block stack's backward was done: "
            f"{s['bytes_before_blocks_done'] / 1e6:.1f} MB — on {card}")
        if par["losses"] != single["losses"] or not same_params:
            raise RuntimeError("the data-parallel step at world 1 is not "
                               "bit-identical to make_train_step")
        if any(n != want for n in par["launches"].values()):
            raise RuntimeError(f"flash launches {par['launches']}: each "
                               f"kernel must launch once a layer a step")
        dp_ms = median_ms(par["times"])
        del par, dp
        torch.cuda.empty_cache()

        off = dp_train_run(cfg, rows, steps, remat="flash_offload")
        same = off["losses"] == single["losses"]
        log(f"[dp-train] remat 'flash_offload': losses "
            + ", ".join(f"{x:.6f}" for x in off["losses"])
            + f" (equal to 'flash': {same}); step median "
            f"{median_ms(off['times']):.2f} ms ('flash' "
            f"{median_ms(single['times']):.2f}, x"
            f"{median_ms(off['times']) / median_ms(single['times']):.3f}); "
            f"launches {off['launches']} — on {card}")
        if not same:
            raise RuntimeError("remat 'flash_offload' changed the losses")
        off_ms = median_ms(off["times"])
        del off
        torch.cuda.empty_cache()
        mem = remat_memory(cfg, rows, ("flash", "flash_offload"))
        kept_o = cfg.nlayers * rows * cfg.max_seq * cfg.dim * 2  # bf16
        held = mem["flash"]["held"] - mem["flash_offload"]["held"]
        saved = (mem["flash"]["peak"] - mem["flash_offload"]["peak"]) / 1e9
        log(f"[dp-train] remat memory, one forward and backward each on "
            f"the same parameters and batch: held at the end of the "
            f"forward 'flash' {mem['flash']['held']} B, 'flash_offload' "
            f"{mem['flash_offload']['held']} B, {held} B lower (the kept "
            f"o: {cfg.nlayers} x B S D x 2 = {kept_o} B); peak 'flash' "
            f"{mem['flash']['peak'] / 1e9:.3f} GB, 'flash_offload' "
            f"{mem['flash_offload']['peak'] / 1e9:.3f} GB, {saved:.3f} GB "
            f"lower — on {card}")
        if abs(held - kept_o) > 0.01 * kept_o:
            raise RuntimeError(f"remat 'flash_offload' moved {held} B off "
                               f"the card at the end of the forward, not "
                               f"the kept o's {kept_o} B")
        if saved < 0.5:
            raise RuntimeError(f"remat 'flash_offload' saved {saved:.3f} GB "
                               f"of peak memory, not >= 0.5")

        dcfg = dataclasses.replace(cfg, dropout_rate=DP_DROPOUT)
        key = axis_unique_key(1234, "data")
        runs = [dp_train_run(dcfg, rows, 3, dp=DataParallel(),
                             dropout_key=key) for _ in range(2)]
        d0, d1 = (r["losses"] for r in runs)
        log(f"[dp-train] dropout {DP_DROPOUT}, the same key twice, 3 steps: "
            + ", ".join(f"{x:.6f}" for x in d0) + " / "
            + ", ".join(f"{x:.6f}" for x in d1)
            + f" (bit-identical: {d0 == d1}; rate 0: "
            + ", ".join(f"{x:.6f}" for x in single["losses"][:3])
            + f"); step times " + ", ".join(
                f"{t * 1e3:.1f}" for t in runs[0]["times"])
            + f" ms — on {card}")
        if not (d0 == d1 and all(np.isfinite(d0))
                and d0 != single["losses"][:3]):
            raise RuntimeError("dropout runs not repeatable, not finite, or "
                               "equal to the rate-0 run")
        out = {"dp_ms": dp_ms, "single_ms": median_ms(single["times"]),
               "offload_ms": off_ms, "offload_saved_gb": saved,
               "offload_held_bytes": held, "stats": s}
        del runs, single
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        tpc.reset()
    return out


# ------------------------------------------------------------ phase 6


def teacher_logits(params, cfg, forward, prompt_len=600, **kw):
    """Teacher-forced logits of 2 slots through ``forward``: a
    ``prompt_len``-token prompt in 512-row chunks, then 4 decode steps, on
    a fresh pool.
    Returns the logits of each call stacked ([6, 2, V], f32) and, per
    call, which of its B x S_in rows hold real tokens (the last chunk's
    padded tail writes into the shared NULL block, so its values are
    arbitrary and never read)."""
    from torchdistpackage_tpu_torch.serving.paged_cache import init_paged_kv

    dev = torch.device("cuda")
    B, P, C, steps = 2, prompt_len, 512, 4
    # as in the engine, the table is wider than the blocks a slot owns, so
    # the padded tail of the last chunk writes into the NULL block
    need, mb = -(-(P + steps) // BS), -(-(P + C) // BS)
    nb = 1 + B * need
    tables = torch.zeros(B, mb, dtype=torch.int32, device=dev)
    tables[:, :need] = torch.arange(1, nb, dtype=torch.int32,
                                    device=dev).reshape(B, need)
    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=g, device=dev)
    follow = torch.randint(0, cfg.vocab_size, (B, steps), generator=g,
                           device=dev)
    cache = init_paged_kv(cfg, nb, BS, device=dev)
    outs, real = [], []
    with torch.no_grad():
        for off in range(0, P, C):
            tok = torch.zeros(B, C, dtype=torch.long, device=dev)
            sl = prompt[:, off:off + C]
            tok[:, :sl.shape[1]] = sl
            real.append((torch.arange(C, device=dev) < sl.shape[1])
                        .repeat(B))
            last = torch.full((B,), min(P - 1 - off, C - 1), device=dev)
            offs = torch.full((B,), off, dtype=torch.int32, device=dev)
            cache, lg = forward(params, tok, cfg, cache, tables, offs,
                                last_idx=last, **kw)
            outs.append(lg.float())
        for t in range(steps):
            offs = torch.full((B,), P + t, dtype=torch.int32, device=dev)
            cache, lg = forward(params, follow[:, t:t + 1], cfg, cache,
                                tables, offs, **kw)
            outs.append(lg.float())
            real.append(torch.ones(B, dtype=torch.bool, device=dev))
    del cache
    return torch.stack(outs), real


def logits_agree(got, want, what, tag):
    """Max abs error relative to the logits' scale, argmax agreement."""
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{what}: kernel-path logits are not finite")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"[{tag}] teacher-forced logits, {what}: max abs err {err:.4g} at "
        f"logit scale {scale:.4g} (rel {err / scale:.3g}); argmax agreement "
        f"{agree:.3f} over {got.shape[0] * got.shape[1]} rows")
    return {"max_abs_err": err, "scale": scale, "rel": err / scale,
            "argmax_agree": agree}


def model_phase(params, cfg):
    """Teacher-forced: the kernel path ('cuda') and the plain path
    ('gather') see the same tokens, so every logit row is comparable.
    bf16 through 32 layers: the two attention paths round differently and
    the residual stream carries those differences on, so the bound is
    relative to the logits' scale (5 %)."""
    from torchdistpackage_tpu_torch.serving.paged_cache import paged_forward

    got, want = (teacher_logits(params, cfg, paged_forward,
                                attn_impl=impl)[0]
                 for impl in ("cuda", "gather"))
    res = logits_agree(got, want, "kernel vs plain (attn_impl)", "model")
    if res["rel"] > 0.05:
        raise RuntimeError(f"full-width logits disagree: {res['rel']:.3g} > "
                           f"5% of the scale")
    return res


def moe_model_phase(params, cfg, tag="moe-model", gather_experts=None,
                    ep_group=None):
    """Teacher-forced logits of the MoE path with K6 (moe_dispatch 'cuda',
    attention in K1) against the ragged plain arm ('gather') — or, with
    ``ep_group``, of the expert-parallel path (``moe_forward``'s exchange
    at the no-drop capacity, K7) against the same ragged arm.
    ``gather_experts`` maps a layer's experts to what the ragged arm takes
    (for int8 experts: bf16 weights dequantised just before that layer's
    call, so no dequantised copy of the whole model exists).  Routing is
    a discontinuous function of the hidden state: the two arms round
    differently (the ragged arm rounds each product to bf16, K6 keeps f32
    until the output), the rounding moves some tokens across a top-2
    boundary, and a token routed to another expert gets another output —
    so two free-running arms drift apart with depth for reasons that are
    not faults.  The held comparison therefore pins the routing: the plain
    arm replays, layer by layer, the (gate weights, experts) the K6 run
    chose on its own hidden states, and runs the ragged FFN on them —
    the FFN arithmetic of the two arms is then all that differs, held to
    5 % of the logits' scale.  The free-running plain arm is reported
    beside it, with the share of tokens whose expert pair differs at each
    layer."""
    from torchdistpackage_tpu_torch.parallel import moe as pm
    from torchdistpackage_tpu_torch.serving.paged_cache import (
        paged_forward_moe,
    )

    serve, capacity_path = pm.moe_serve_forward, pm.moe_forward
    routes = []   # (gate_vals, gate_idx) of every expert-layer call, in order
    replay = []
    prep = gather_experts or (lambda ex: ex)
    kname = "K6" if ep_group is None else "K7 (EP)"

    def route(params_l, x, mcfg):
        T = x.shape[0] * x.shape[1]
        probs = torch.softmax((x.reshape(T, -1) @ params_l["router"]["w"])
                              .float(), dim=-1)
        gv, gi = torch.topk(probs, mcfg.top_k, dim=-1)
        return gv / gv.sum(-1, keepdim=True).clamp_min(1e-9), gi

    def ragged(params_l, x, gv, gi):
        B, S, D = x.shape
        y = pm._ragged_ffn(prep(params_l["experts"]), x.reshape(B * S, D),
                           gv, gi)
        return y.reshape(B, S, D).to(x.dtype)

    # the serving arm's signature; under EP the capacity path's, whose
    # (y, aux) the forward takes apart (at the no-drop capacity the
    # routing is the plain top-k: every choice kept)
    def recording(params_l, x, mcfg, dispatch=None, return_metrics=False,
                  **ep):
        routes.append(route(params_l, x, mcfg))
        if ep_group is None:
            return serve(params_l, x, mcfg, dispatch=dispatch,
                         return_metrics=return_metrics)
        return capacity_path(params_l, x, mcfg, **ep)

    def replaying(params_l, x, mcfg, dispatch=None, return_metrics=False,
                  **ep):
        gv, gi = routes[len(replay)]
        replay.append(route(params_l, x, mcfg)[1])
        y = ragged(params_l, x, gv, gi)
        return y if ep_group is None else (y, torch.zeros(()))

    def freeing(params_l, x, mcfg, dispatch=None, return_metrics=False,
                **ep):
        gv, gi = route(params_l, x, mcfg)
        replay.append(gi)
        y = ragged(params_l, x, gv, gi)
        return y if ep_group is None else (y, torch.zeros(()))

    def run(wrapper, dispatch):
        name = "moe_serve_forward" if ep_group is None else "moe_forward"
        setattr(pm, name, wrapper)
        try:
            return teacher_logits(
                params, cfg, paged_forward_moe, attn_impl="cuda",
                moe_dispatch=dispatch,
                **({} if ep_group is None else {"ep_group": ep_group}))
        finally:
            pm.moe_serve_forward, pm.moe_forward = serve, capacity_path

    k6, real = run(recording, "cuda")
    pinned, _ = run(replaying, "gather")
    res = logits_agree(k6, pinned, f"{kname} vs the ragged arm, routing "
                       "pinned", tag)
    replay.clear()
    free, _ = run(freeing, "gather")
    drift = logits_agree(k6, free, f"{kname} vs the ragged arm, each "
                         "routing itself", tag)
    nl = cfg.nlayers
    differs = [(torch.sort(a[1], -1).values != torch.sort(b, -1).values)
               .any(-1) for a, b in zip(routes, replay)]
    per_layer = []  # over the real rows of every call
    for i in range(nl):
        calls = list(zip(differs[i::nl], real))
        per_layer.append(sum(int(d[m].sum()) for d, m in calls)
                         / sum(int(m.sum()) for _, m in calls))
    log(f"[{tag}] free-running arms: share of real tokens whose expert "
        f"pair differs, by layer: "
        + ", ".join(f"{f:.4f}" for f in per_layer))
    if res["rel"] > 0.05:
        raise RuntimeError(f"MoE logits disagree with the routing pinned: "
                           f"{res['rel']:.3g} > 5% of the scale")
    return {"pinned": res, "free": drift, "flips_by_layer": per_layer}


def engine_phase(params, cfg, card):
    from torchdistpackage_tpu_torch.ops.paged_attention import LAUNCHES
    from torchdistpackage_tpu_torch.serving import Request, ServingEngine

    rs = np.random.RandomState(0)
    lens = rs.choice([256, 1024, 2048, 4608], 16)
    if (lens == 4608).sum() < 2:  # the 4096 window must really mask
        lens[:2] = 4608
    news = rs.choice([32, 64, 128], 16)
    reqs = []
    for i, (n, m) in enumerate(zip(lens, news)):
        toks = rs.randint(0, cfg.vocab_size, int(n)).tolist()
        if i % 4 == 3:  # 4 sampled requests, 12 greedy
            reqs.append(Request(toks, int(m), temperature=0.8, top_k=50,
                                top_p=0.95, seed=i))
        else:
            reqs.append(Request(toks, int(m)))
    eng = ServingEngine(params, cfg, num_slots=8, block_size=BS, chunk=512,
                        max_ctx=8192)
    if eng.attn_impl != "cuda":
        raise RuntimeError(f"engine resolved attn_impl={eng.attn_impl!r}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rids = [eng.submit(r) for r in reqs]
    reset_counts()
    t0 = time.perf_counter()
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = LAUNCHES["paged_decode_attention"]
    s = eng.serving_summary()
    calls = s["prefill_chunks"] + s["decode_steps"]
    if launches != cfg.nlayers * calls:
        raise RuntimeError(
            f"kernel launches {launches} != {cfg.nlayers} x {calls} calls")
    if s["requests"]["completed"] != len(reqs):
        raise RuntimeError(f"completed {s['requests']} of {len(reqs)}")
    for r, req in zip(rids, reqs):
        f = eng.finished[r]
        gen = f["tokens"][len(req.tokens):]
        if (f["reason"] != "max_tokens" or len(gen) != req.max_new_tokens
                or gen.min() < 0 or gen.max() >= cfg.vocab_size):
            raise RuntimeError(f"request {r} finished wrong: {f['reason']}")
    if not eng.audit(heal=False)["ok"] or eng._alloc.in_use:
        raise RuntimeError("pool not conserved after the run")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ttft, tpot = s["ttft_s"], s["tpot_s"]
    log(f"[engine] {len(reqs)} requests, prompts {sorted(lens.tolist())}, "
        f"{s['generated_tokens']} tokens in {wall:.2f} s: "
        f"{s['tokens_per_sec']:.2f} tok/s, TTFT p50 {ttft['p50']:.3f} s "
        f"p99 {ttft['p99']:.3f} s, TPOT p50 {tpot['p50'] * 1e3:.2f} ms "
        f"p99 {tpot['p99'] * 1e3:.2f} ms, peak memory {peak_gb:.2f} GB, "
        f"{s['prefill_chunks']} prefill calls + {s['decode_steps']} decode "
        f"calls, {launches} kernel launches — on {card}")
    return {"launches": launches, "summary": s, "wall_s": wall,
            "peak_gb": peak_gb}


def kernel_families(prof, calls):
    """A profile's device kernels, their device time per call (ms) and
    that time by family: K1, K2 (one pair of kernel bodies; the last
    template argument, carry, tells them apart), K6, K7, NCCL, GEMMs, the
    rest."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / calls / 1e3
    families = {"paged_attention": 0.0, "paged_carry": 0.0, "moe_ffn": 0.0,
                "expert_ffn": 0.0, "nccl": 0.0, "gemm": 0.0, "other": 0.0}
    for e in kernels:
        name = e.key.lower()
        paged = re.search(
            r"paged_(?:walk|tc|split|merge)_kernel<\d+, \d+, (true|false)>",
            name)
        fam = ("paged_carry" if paged and paged.group(1) == "true" else
               "paged_attention" if paged else
               "moe_ffn" if "moe_ffn" in name else
               "expert_ffn" if "expert_ffn" in name else
               "nccl" if "nccl" in name else
               "gemm" if re.search(r"gemm|xmma|cutlass|nvjet|sm90", name)
               else "other")
        families[fam] += e.self_device_time_total / calls / 1e3
    return kernels, busy_ms, families


def profile_prefill(params, cfg, card, tag):
    """Where a prefill device call's time goes: 8 slots each start a
    2048-token prompt (chunk 512, so one call prefills 8 x 512 = 4096
    rows, the MoE layer's C = T chunk); after one warm call, one call
    under torch.profiler on the host clock to its end — device busy time
    by kernel family, the MoE kernel's share of it, the device's idle
    share of the call."""
    from torch.profiler import ProfilerActivity, profile

    from torchdistpackage_tpu_torch.serving import Request, ServingEngine

    eng = ServingEngine(params, cfg, num_slots=8, block_size=BS, chunk=512,
                        max_ctx=4096)
    rs = np.random.RandomState(3)
    for _ in range(8):
        eng.submit(Request(rs.randint(0, cfg.vocab_size, 2048).tolist(), 4))
    eng.step()
    torch.cuda.synchronize()
    before = dict(eng.stats)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) * 1e3
    if (eng.stats["prefill_chunks"] != before["prefill_chunks"] + 1
            or eng.stats["decode_steps"] != before["decode_steps"]):
        raise RuntimeError(f"[{tag}] the profiled step was not one prefill "
                           f"call: {before} -> {eng.stats}")
    kernels, busy_ms, families = kernel_families(prof, 1)
    del eng
    torch.cuda.empty_cache()
    if busy_ms == 0.0:
        log(f"[{tag}] prefill call {call_ms:.2f} ms; device time not "
            f"measured (the profiler recorded no kernels) — on {card}")
        return None
    moe = families["moe_ffn"] + families["expert_ffn"]
    log(f"[{tag}] one prefill call (8 slots x 512 rows): {call_ms:.2f} ms "
        f"on the host clock under the profiler; device busy {busy_ms:.2f} "
        f"ms (idle {1 - busy_ms / call_ms:.1%}); by family: " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in families.items())
        + f"; the MoE kernel {moe / busy_ms:.1%} of the busy time, "
        f"{moe / call_ms:.1%} of the call — on {card}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[{tag}]   {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")
    return {"call_ms": call_ms, "busy_ms": busy_ms, "families": families}


def profile_phase(params, cfg, card, max_ctx=8192, tag="profile",
                  ep_group=None, cp_group=None):
    """Where a decode tick's time goes: 8 slots decoding at 2048 context,
    16 ticks timed one by one on the host clock (each ends by reading the
    tokens back, so it waits for the device), then 8 more under
    torch.profiler — device time by kernel family (K1, K2, K6, K7, NCCL,
    GEMMs, the rest), the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    from torchdistpackage_tpu_torch.serving import Request, ServingEngine

    eng = ServingEngine(params, cfg, num_slots=8, block_size=BS, chunk=512,
                        max_ctx=max_ctx, ep_group=ep_group, cp_group=cp_group)
    rs = np.random.RandomState(1)
    for _ in range(8):
        eng.submit(Request(rs.randint(0, cfg.vocab_size, 2048).tolist(), 48))
    while eng.stats["prefill_chunks"] < 4 or eng.stats["decode_steps"] < 2:
        eng.step()
    torch.cuda.synchronize()
    ticks = []
    for _ in range(16):
        t0 = time.perf_counter()
        eng.step()
        ticks.append((time.perf_counter() - t0) * 1e3)
    tick_ms = float(np.median(ticks))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(8):
            eng.step()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) / 8 * 1e3
    kernels, busy_ms, families = kernel_families(prof, 8)
    if busy_ms == 0.0:
        log(f"[{tag}] decode tick {tick_ms:.2f} ms; device time not "
            f"measured (the profiler recorded no kernels) — on {card}")
        return None
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    log(f"[{tag}] decode tick (8 slots at 2048 context): median "
        f"{tick_ms:.2f} ms (min {min(ticks):.2f}, max {max(ticks):.2f}) on "
        f"the host clock, {prof_ms:.2f} ms under the profiler; device busy "
        f"{busy_ms:.2f} ms per tick (idle {1 - busy_ms / prof_ms:.1%} of "
        f"the profiled tick); by family: " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in families.items())
        + f"; {sum(e.count for e in kernels) / 8:.0f} kernels per tick"
        + (f"; K6 {families['moe_ffn'] / busy_ms:.1%} of the busy time"
           if families["moe_ffn"] else "")
        + (f"; K7 {families['expert_ffn'] / busy_ms:.1%} of the busy time"
           if families["expert_ffn"] else "")
        + (f"; K2 {families['paged_carry'] / busy_ms:.1%} of the busy time"
           if families["paged_carry"] else "") + f" — on {card}")
    for e in top:
        log(f"[{tag}]   {e.self_device_time_total / 8 / 1e3:8.3f} ms "
            f"x{e.count // 8:<4d} {e.key[:90]}")
    return {"tick_ms": tick_ms, "prof_ms": prof_ms, "busy_ms": busy_ms,
            "families": families}


def moe_engine_phase(params, cfg, card, k6="fused_moe_ffn",
                     tag="moe-engine", ep_group=None):
    """The MoE serving main path: ``ServingEngine`` (8 slots, blocks of 16,
    chunk 512, context 4096) serves 12 requests from ``RandomState(1)`` —
    prompts 128-2048 tokens, 32-96 new tokens, 9 greedy and 3 sampled —
    with the MoE kernel ``k6`` names in every expert layer (K6 or
    K6-int8; with ``ep_group``, the expert-parallel path: K7 or K7-int8)
    and K1 in every attention.  The counts are set to 0 just before the
    run and read just after: each kernel launches once a layer a device
    call, every other MoE kernel never; the ``moe`` summary counts top-k
    choices of every row each expert layer saw."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md
    from torchdistpackage_tpu_torch.ops import paged_attention as pa
    from torchdistpackage_tpu_torch.serving import Request, ServingEngine

    rs = np.random.RandomState(1)
    lens = rs.randint(128, 2049, 12)
    news = rs.randint(32, 97, 12)
    reqs = []
    for i, (n, m) in enumerate(zip(lens, news)):
        toks = rs.randint(0, cfg.vocab_size, int(n)).tolist()
        if i % 4 == 3:  # 3 sampled requests, 9 greedy
            reqs.append(Request(toks, int(m), temperature=0.8, top_p=0.95,
                                seed=i))
        else:
            reqs.append(Request(toks, int(m)))
    eng = ServingEngine(params, cfg, num_slots=8, block_size=BS, chunk=512,
                        max_ctx=4096, ep_group=ep_group,
                        moe_dispatch=None if ep_group is None else "cuda")
    if eng.attn_impl != "cuda" or eng.moe_dispatch != "cuda":
        raise RuntimeError(f"engine resolved attn_impl={eng.attn_impl!r}, "
                           f"moe_dispatch={eng.moe_dispatch!r}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rids = [eng.submit(r) for r in reqs]
    reset_counts()
    t0 = time.perf_counter()
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k6: md.LAUNCHES[k6], "paged_decode_attention": pa.LAUNCHES[
        "paged_decode_attention"]}
    s = eng.serving_summary()
    calls = s["prefill_chunks"] + s["decode_steps"]
    for kname, n in launches.items():
        if n != cfg.nlayers * calls:
            raise RuntimeError(f"{kname} launches {n} != {cfg.nlayers} x "
                               f"{calls} calls")
    other = sum(n for kname, n in md.LAUNCHES.items() if kname != k6)
    if other:
        raise RuntimeError(f"another MoE kernel launched: {md.LAUNCHES}")
    if s["requests"]["completed"] != len(reqs):
        raise RuntimeError(f"completed {s['requests']} of {len(reqs)}")
    for r, req in zip(rids, reqs):
        f = eng.finished[r]
        gen = f["tokens"][len(req.tokens):]
        if (f["reason"] != "max_tokens" or len(gen) != req.max_new_tokens
                or gen.min() < 0 or gen.max() >= cfg.vocab_size):
            raise RuntimeError(f"request {r} finished wrong: {f['reason']}")
    if not eng.audit(heal=False)["ok"] or eng._alloc.in_use:
        raise RuntimeError("pool not conserved after the run")
    moe = s["moe"]
    rows = (s["prefill_chunks"] * eng.num_slots * eng.chunk
            + s["decode_steps"] * eng.num_slots)
    want = cfg.moe_top_k * rows * cfg.nlayers  # every layer an expert layer
    if (len(moe["expert_tokens"]) != cfg.moe_experts
            or sum(moe["expert_tokens"]) != want
            or moe["dispatch"] != "cuda" or moe["dropped_token_rate"] != 0):
        raise RuntimeError(f"moe summary wrong: {moe} (want {want} choices)")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ttft, tpot = s["ttft_s"], s["tpot_s"]
    log(f"[{tag}] {len(reqs)} requests, prompts "
        f"{sorted(lens.tolist())}, {s['generated_tokens']} tokens in "
        f"{wall:.2f} s: {s['tokens_per_sec']:.2f} tok/s, TTFT p50 "
        f"{ttft['p50']:.3f} s p99 {ttft['p99']:.3f} s, TPOT p50 "
        f"{tpot['p50'] * 1e3:.2f} ms p99 {tpot['p99'] * 1e3:.2f} ms, peak "
        f"memory {peak_gb:.2f} GB, {s['prefill_chunks']} prefill calls + "
        f"{s['decode_steps']} decode calls, launches {launches} — on {card}")
    log(f"[{tag}] expert load: tokens {moe['expert_tokens']} "
        f"(sum {sum(moe['expert_tokens']):.0f} = 2 x {rows} rows x "
        f"{cfg.nlayers} layers), imbalance {moe['imbalance']:.4f}, load "
        f"entropy {moe['load_entropy']:.4f}")
    out = {"launches": launches, "summary": s, "wall_s": wall,
           "peak_gb": peak_gb}
    del eng
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ generate

#: the teacher-forced check: a row's top logit minus the emitted token's,
#: at most this share of the row's largest |logit| (model_phase's 5 %
#: bound on bf16 logits through the whole depth)
TF_TOL = 0.05
GEN_PROMPT, GEN_NEW = 1000, 64  # 1000 % 64 = 40, 1000 % 128 = 104


def gen_module():
    import importlib

    return importlib.import_module(
        "torchdistpackage_tpu_torch.models.generate")


@torch.no_grad()
def teacher_logits_of(params, cfg, seq):
    """f32 logits [B, S, V] of ``seq`` by one uncached forward: dense
    ``gpt_forward`` (flash, K3, over the whole sequence), or for an MoE
    model ``forward_cached_moe`` at offset 0 with ``all_logits``."""
    from torchdistpackage_tpu_torch.models import gpt_forward

    if not cfg.moe_experts:
        return gpt_forward(params, seq, cfg).float()
    gm = gen_module()
    cache = gm.init_kv_cache(cfg, seq.shape[0], seq.shape[1])
    return gm.forward_cached_moe(params, seq, cfg, cache, 0,
                                 all_logits=True)[1].float()


def tf_gaps(logits, seq, P):
    """Per emitted token (positions P..): (the row's top logit - the
    token's) / the row's largest |logit|, from teacher-forced logits."""
    rows = logits[:, P - 1:-1]
    got = rows.gather(-1, seq[:, P:, None].long())[..., 0]
    return (rows.amax(-1) - got) / rows.abs().amax(-1)


def tf_check(params, cfg, seq, P, what, tag, gate=True):
    """Every emitted token of ``seq`` within ``TF_TOL`` of its
    teacher-forced row maximum (printed with the exact-argmax share);
    ``gate=False`` only prints.  Returns the teacher-forced logits."""
    logits = teacher_logits_of(params, cfg, seq)
    gaps = tf_gaps(logits, seq, P)
    ok = float((gaps <= TF_TOL).float().mean())
    exact = float((gaps == 0).float().mean())
    log(f"[{tag}] {what}: teacher-forced, {gaps.numel()} emitted tokens: "
        f"{ok:.3f} within {TF_TOL} of the row's scale (max gap "
        f"{float(gaps.max()):.4f}), {exact:.3f} the exact argmax")
    if gate and ok < 1.0:
        raise RuntimeError(f"{what}: an emitted token is off its "
                           f"teacher-forced argmax by more than {TF_TOL}")
    if not ((0 <= seq).all() and (seq < cfg.vocab_size).all()):
        raise RuntimeError(f"{what}: a token out of the vocabulary")
    return logits


def seq_logprob(logits, seq, P):
    """Teacher-forced log-probability of ``seq``'s emitted tokens."""
    lp = torch.log_softmax(logits[:, P - 1:-1], dim=-1)
    return lp.gather(-1, seq[:, P:, None].long())[..., 0].sum(-1)


def launches_now():
    from torchdistpackage_tpu_torch.ops import flash_attention as fa
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md
    from torchdistpackage_tpu_torch.ops import paged_attention as pa

    return {**fa.LAUNCHES, **pa.LAUNCHES, **md.LAUNCHES}


def expect_launches(what, want):
    """Every kernel count is ``want``'s (0 where it names none)."""
    got = launches_now()
    bad = {k: v for k, v in got.items() if v != want.get(k, 0)}
    if bad:
        raise RuntimeError(f"{what}: launches {bad}, expected {want} "
                           f"(all others 0)")


@torch.no_grad()
def generate_phase(params, cfg, card):
    """The contiguous-cache decoding family at Mistral-7B-v0.1 widths (all
    32 layers, bf16, ``attn_impl='flash'``): greedy ``generate`` at B 4
    on 1000-token prompts (K3's last tile ragged) and 64 new tokens —
    K3 launched once a layer for the prefill call and never in a decode
    step, every token held by teacher forcing, the prefill's and a decode
    step's ms; sampled ``generate`` twice from one seed (identical);
    ``beam_generate`` with 4 beams and with 1, 32 new tokens (distinct
    beams, the best beam's teacher-forced log-probability no lower than
    the greedy sequence's within tolerance); ``speculative_generate``
    with 4 drafts, 64 new tokens, drafted by the target itself and by its
    int8 copy (``quantize_decode_params``), held to greedy ``generate``
    bit for bit or, at the first difference, to a teacher-forced top-2
    margin within ``TF_TOL``; acceptance printed."""
    from torchdistpackage_tpu_torch.models import (
        beam_generate,
        generate,
        speculative_generate,
    )
    from torchdistpackage_tpu_torch.tools.surgery import (
        quantize_decode_params,
    )

    gm = gen_module()
    cfg = dataclasses.replace(cfg, attn_impl="flash")
    L, B, P, N = cfg.nlayers, 4, GEN_PROMPT, GEN_NEW
    g = torch.Generator(device="cuda").manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                           device="cuda")
    out = {}
    generate(params, prompt, cfg, 2)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    greedy = generate(params, prompt, cfg, N)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    expect_launches("greedy generate", {"flash_fwd": L})
    out["launches"] = {"flash_fwd": L}
    tf_check(params, cfg, greedy, P, f"greedy generate B {B} P {P} +{N}",
             "generate")
    cache = gm.init_kv_cache(cfg, B, P + N)
    prefill_ms = cuda_ms(lambda: gm.forward_cached(params, prompt, cfg,
                                                   cache, 0), 3)
    tok = greedy[:, P:P + 1]
    step_ms = cuda_ms(lambda: gm.forward_cached(params, tok, cfg, cache, P),
                      10)
    H, hd = cfg.nheads, cfg.block.head_dim
    q = torch.randn(B, H, 1, hd, generator=g, device="cuda").to(cfg.dtype)
    attn_ms = cuda_ms(lambda: gm._cached_attention(
        q, cache["k"][0], cache["v"][0], P, window=cfg.sliding_window), 20)
    out.update(prefill_ms=prefill_ms, step_ms=step_ms, wall_s=wall,
               cached_attention_ms=attn_ms)
    log(f"[generate] greedy B {B}, prompt {P}, {N} new: {wall:.3f} s "
        f"wall; prefill call {prefill_ms:.2f} ms ({B * P} rows, K3), decode "
        f"step {step_ms:.2f} ms, of which _cached_attention (plain "
        f"PyTorch) {attn_ms:.4f} ms a layer, {attn_ms * L:.3f} ms a step; "
        f"K3 launches {L} (one prefill call) — on {card}")

    def sampled():
        gen = torch.Generator(device="cuda").manual_seed(7)
        return generate(params, prompt, cfg, N, generator=gen,
                        temperature=0.8, top_k=50, top_p=0.9)
    a, b = sampled(), sampled()
    if not torch.equal(a, b):
        raise RuntimeError("sampled generate: two runs from one seed differ")
    differ = float((a != greedy).float()[:, P:].mean())
    log(f"[generate] sampled (temperature 0.8, top-k 50, top-p 0.9) twice "
        f"from one seed: identical; {differ:.3f} of its tokens differ from "
        f"greedy")

    one = prompt[:1]
    reset_counts()
    beams = beam_generate(params, one, cfg, 32, num_beams=4,
                          return_all=True)
    torch.cuda.synchronize()
    expect_launches("beam_generate", {"flash_fwd": L})
    if len({tuple(r.tolist()) for r in beams}) != 4:
        raise RuntimeError("beam_generate: the 4 beams are not distinct")
    width1 = beam_generate(params, one, cfg, 32, num_beams=1)
    tf_check(params, cfg, width1, P, "beam width 1, +32", "beam")
    greedy1 = generate(params, one, cfg, 32)
    lg_best = teacher_logits_of(params, cfg, beams[:1])
    lg_greedy = tf_check(params, cfg, greedy1, P, "greedy B 1, +32", "beam")
    lp_best = float(seq_logprob(lg_best, beams[:1], P))
    lp_greedy = float(seq_logprob(lg_greedy, greedy1, P))
    tol = TF_TOL * float(lg_greedy[:, P - 1:-1].abs().amax(-1).sum())
    log(f"[beam] 4 beams, +32: teacher-forced log-probability of the best "
        f"beam {lp_best:.4f}, of the greedy sequence {lp_greedy:.4f} "
        f"(tolerance {tol:.3f}); width 1 equal to greedy: "
        f"{torch.equal(width1, greedy1)}")
    if lp_best < lp_greedy - tol:
        raise RuntimeError("beam_generate: the best beam scores below the "
                           "greedy sequence")

    t0 = time.perf_counter()
    want = generate(params, one, cfg, N)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    lg_want = teacher_logits_of(params, cfg, want)
    steps = []
    real = gm._spec_macro_step

    def counted(*args):
        res = real(*args)
        steps.append(res[2])
        return res
    drafts = {"self": params, "int8": quantize_decode_params(params)}
    out["spec"] = {}
    gm._spec_macro_step = counted
    try:
        for name, draft in drafts.items():
            steps.clear()
            reset_counts()
            t0 = time.perf_counter()
            got = speculative_generate(params, draft, one, cfg, N,
                                       num_draft=4)
            torch.cuda.synchronize()
            swall = time.perf_counter() - t0
            expect_launches(f"speculative ({name} draft)",
                            {"flash_fwd": 2 * L})
            equal = torch.equal(got, want)
            if not equal:
                j = int((got != want)[0].nonzero()[0])
                top2 = lg_want[0, j - 1].topk(2).values
                margin = float((top2[0] - top2[1])
                               / lg_want[0, j - 1].abs().max())
                log(f"[spec] {name} draft: first difference from greedy at "
                    f"position {j}: teacher-forced top-2 margin {margin:.4f}")
                if margin > TF_TOL:
                    raise RuntimeError(f"speculative ({name} draft) differs "
                                       f"from greedy past a near-tie")
            tf_check(params, cfg, got, P, f"speculative, {name} draft",
                     "spec")
            acc = sum(steps) / (4 * len(steps))
            out["spec"][name] = {"equal": equal, "accept_rate": acc,
                                 "macro_steps": len(steps), "wall_s": swall,
                                 "greedy_b1_wall_s": wall1}
            log(f"[spec] {name} draft, K 4, +{N}: equal to greedy generate "
                f"bit for bit: {equal}; {len(steps)} macro steps, "
                f"acceptance {acc:.3f}, {(N - 1) / len(steps):.2f} tokens a "
                f"verify; {swall:.3f} s (greedy generate at B 1: "
                f"{wall1:.3f} s) — on {card}")
    finally:
        gm._spec_macro_step = real
    del drafts
    torch.cuda.empty_cache()
    return out


SPEC_NEW = 64


def spec_requests(vocab):
    """8 requests whose prompts repeat a 64-token segment after a
    16-token head (the n-gram drafter finds it): 4 greedy, 4 sampled."""
    rs = np.random.RandomState(3)
    seg = rs.randint(0, vocab, 64).tolist()
    from torchdistpackage_tpu_torch.serving import Request

    reqs = []
    for i, m in enumerate((8, 12, 16, 24) * 2):
        toks = rs.randint(0, vocab, 16).tolist() + seg * m
        if i >= 4:
            reqs.append(Request(toks, SPEC_NEW, temperature=0.8, top_k=50,
                                top_p=0.95, seed=i))
        else:
            reqs.append(Request(toks, SPEC_NEW))
    return reqs


@torch.no_grad()
def spec_engine_phase(params, cfg, card):
    """``ServingEngine`` with ``spec_k`` 3 and 4 at Mistral-7B-v0.1 widths
    (8 slots, chunk 512), and without it, on the same 8 requests: K1
    launched exactly once a layer a device call, verify calls included;
    the greedy rows held by teacher forcing; acceptance, tokens a verify
    tick, TPOT and tokens/s beside the plain engine's; and which K1 body
    a verify call runs (R = 4 (K + 1) rows a KV head: 16, the split
    decode body; 20, ``paged_tc_kernel``), by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from torchdistpackage_tpu_torch.ops import paged_attention as pa
    from torchdistpackage_tpu_torch.serving import ServingEngine

    tf_cfg = dataclasses.replace(cfg, attn_impl="flash")
    out = {}
    tokens = {}
    for k in (0, 3, 4):
        reqs = spec_requests(cfg.vocab_size)
        eng = ServingEngine(params, cfg, num_slots=8, block_size=BS,
                            chunk=512, max_ctx=2048, spec_k=k)
        rids = [eng.submit(r) for r in reqs]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        eng.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = eng.serving_summary()
        calls = s["prefill_chunks"] + s["decode_steps"]
        expect_launches(f"spec_k {k} engine",
                        {"paged_decode_attention": cfg.nlayers * calls})
        if s["requests"]["completed"] != len(reqs):
            raise RuntimeError(f"spec_k {k}: completed {s['requests']}")
        tokens[k] = [eng.finished[r]["tokens"] for r in rids]
        for r, req in zip(rids, reqs):
            if req.temperature > 0.0:  # sampled rows: nothing to force
                continue
            f = eng.finished[r]
            seq = torch.from_numpy(f["tokens"][None]).cuda().long()
            tf_check(params, tf_cfg, seq, f["prompt_len"],
                     f"spec_k {k} greedy request {r}", "spec-engine")
        st = eng.stats
        per_tick = 1 + st["spec_accepted"] / max(st["decode_slot_steps"], 1)
        same = (np.mean([np.array_equal(a, b) for a, b in
                         zip(tokens[k][:4], tokens[0][:4])]) if k else 1.0)
        out[k] = {"launches": cfg.nlayers * calls, "wall_s": wall,
                  "tokens_per_sec": s["tokens_per_sec"],
                  "tpot_p50_ms": s["tpot_s"]["p50"] * 1e3,
                  "accept_rate": s["spec_accept_rate"],
                  "tokens_per_slot_tick": per_tick,
                  "decode_steps": s["decode_steps"],
                  "greedy_equal_plain": same}
        log(f"[spec-engine] spec_k {k}: {len(reqs)} requests (4 greedy, 4 "
            f"sampled), {s['generated_tokens']} tokens in {wall:.2f} s: "
            f"{s['tokens_per_sec']:.2f} tok/s, TPOT p50 "
            f"{s['tpot_s']['p50'] * 1e3:.2f} ms p99 "
            f"{s['tpot_s']['p99'] * 1e3:.2f} ms, TTFT p50 "
            f"{s['ttft_s']['p50']:.3f} s; {s['prefill_chunks']} prefill + "
            f"{s['decode_steps']} decode calls, K1 launches "
            f"{cfg.nlayers * calls}; acceptance {s['spec_accept_rate']:.3f}"
            f", {per_tick:.2f} tokens a slot a tick; greedy rows equal to "
            f"the plain engine's: {same:.2f} — on {card}")
    for k in (3, 4):
        case = make_case(f"verify K {k}", B=8, S_in=k + 1,
                         offsets=[1500] * 8, window=4096,
                         dtype=torch.bfloat16, quantized=False, seed=40 + k)
        fn = lambda: pa.paged_decode_attention(  # noqa: E731
            case["q"], case["k"], case["v"], case["tables"],
            case["offsets"], window=4096)
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = sorted({m.group(1) for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        for m in [re.search(r"(paged_\w+?_kernel)", e.key)]
                        if m})
        # the wrapper's own route: a split count > 0 is the split body
        nsplit = pa._workspace(8, HKV, GROUPS * (k + 1), HD,
                               case["tables"].shape[1], "cuda")[0]
        want = "paged_split_kernel" if nsplit else "paged_tc_kernel"
        log(f"[spec-engine] a verify call at K {k} (R = {GROUPS * (k + 1)} "
            f"rows a KV head): the wrapper routes it to {want} (NSPLIT "
            f"{nsplit}); torch.profiler saw {names or 'no kernel'}")
        if (want == "paged_split_kernel") != (k == 3) or (
                names and not any(want in n for n in names)):
            raise RuntimeError(f"verify K {k}: routed to {want}, the "
                               f"profiler saw {names}")
        out[k]["k1_body"] = want
    return out


@torch.no_grad()
def moe_generate_phase(params, shard, cfg, card, group):
    """Greedy ``generate`` on the 16-layer Mixtral-8x7B-v0.1 widths (bf16,
    ``attn_impl='flash'``), B 4, 500-token prompts, 32 new tokens: once
    serial through K6 (16 x 32 forward calls = 512 launches, K3 16 for the
    prefill), once over the one-rank NCCL ``group`` through K7 (the same
    count; K6 0).  Teacher forcing (``forward_cached_moe`` over the whole
    sequence) is printed, not gated: a decode row and the same row inside
    a 532-row call round differently, which can flip a near-tied routing
    choice (``moe_model_phase``'s free-running drift)."""
    from torchdistpackage_tpu_torch.models import generate

    cfg = dataclasses.replace(cfg, attn_impl="flash")
    L, B, P, N = cfg.nlayers, 4, 500, 32
    g = torch.Generator(device="cuda").manual_seed(6)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                           device="cuda")
    out = {}
    for name, kern, p, grp in (("K6", "fused_moe_ffn", params, None),
                               ("K7", "fused_expert_ffn", shard, group)):
        generate(p, prompt, cfg, 2, ep_group=grp)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        toks = generate(p, prompt, cfg, N, ep_group=grp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        expect_launches(f"MoE generate ({name})",
                        {"flash_fwd": L, kern: L * N})
        tf_check(params, cfg, toks, P, f"MoE generate through {name}",
                 "moe-generate", gate=False)
        out[name] = {"launches": L * N, "wall_s": wall, "tokens": toks}
        log(f"[moe-generate] {name}: B {B}, prompt {P}, {N} new in "
            f"{wall:.3f} s, {kern} launches {L * N} ({L} x {N} forward "
            f"calls), K3 {L} — on {card}")
    same = float((out["K6"]["tokens"] == out["K7"]["tokens"]).float()
                 [:, P:].mean())
    log(f"[moe-generate] K6 and K7 runs: {same:.3f} of the new tokens equal")
    return {k: {kk: vv for kk, vv in v.items() if kk != "tokens"}
            for k, v in out.items()}


def free_port():
    """A free TCP port on the loopback, for the process group's
    rendezvous."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def ep_phase(params, cfg, card, k7, tag, gather_experts=None, then=None):
    """The expert-parallel serving path on the model already built: a
    one-rank NCCL group (``init_distributed`` on the card,
    ``build_moe_groups(1)``; at EP 1 both exchanges are identities, the
    layout is the reference's at any EP size), the rank's expert share
    (``shard_moe_params``: at EP 1 views of every expert), then
    teacher-forced logits against the ragged arm with the routing pinned,
    the engine serving the same 12 requests with ``k7`` (K7 or K7-int8)
    in every expert layer, and a profiled decode tick; then ``then(shard,
    group)`` if given.  The group is destroyed before the model is
    freed."""
    import torch.distributed as dist

    from torchdistpackage_tpu_torch.dist import (
        build_moe_groups,
        init_distributed,
    )
    from torchdistpackage_tpu_torch.models import shard_moe_params

    init_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0, "cuda")
    try:
        group = build_moe_groups(1)
        log(f"[{tag}] process group: backend {dist.get_backend(group)}, EP "
            f"size {group.size()}")
        if dist.get_backend(group) != "nccl":
            raise RuntimeError("the EP group on the card must use NCCL")
        shard = shard_moe_params(params, cfg, 0, group.size())
        model = moe_model_phase(shard, cfg, tag=f"{tag}-model",
                                gather_experts=gather_experts,
                                ep_group=group)
        eng = moe_engine_phase(shard, cfg, card, k6=k7, tag=f"{tag}-engine",
                               ep_group=group)
        profile_phase(shard, cfg, card, max_ctx=4096, tag=f"{tag}-profile",
                      ep_group=group)
        extra = then(shard, group) if then is not None else None
    finally:
        dist.destroy_process_group()
    return {"model": model, **eng, "then": extra}


CP_PROMPT = 4700  # past Mistral's 4096 window: the window masks


def cp_model_phase(params, cfg, group):
    """Teacher-forced logits of ``cp_paged_forward`` with K2 (one hop a
    layer at cp 1) on a 4700-token context, against ``paged_forward`` with
    K1 (equal bit for bit) and against the CP path's gather arm (K2's
    plain version), within 5 % of the logits' scale as ``model_phase``;
    K2 launched once a layer a call, K1 never."""
    from torchdistpackage_tpu_torch.ops import paged_attention as pa
    from torchdistpackage_tpu_torch.serving.paged_cache import (
        cp_paged_forward,
        paged_forward,
    )

    reset_counts()
    got, real = teacher_logits(params, cfg, cp_paged_forward,
                               prompt_len=CP_PROMPT, cp_group=group,
                               attn_impl="cuda")
    torch.cuda.synchronize()
    calls = len(real)
    if (pa.LAUNCHES["paged_carry_attention"] != cfg.nlayers * calls
            or pa.LAUNCHES["paged_decode_attention"]):
        raise RuntimeError(f"CP forward launches {pa.LAUNCHES}, want K2 "
                           f"{cfg.nlayers} x {calls} and K1 0")
    k1 = teacher_logits(params, cfg, paged_forward, prompt_len=CP_PROMPT,
                        attn_impl="cuda")[0]
    plain = teacher_logits(params, cfg, cp_paged_forward,
                           prompt_len=CP_PROMPT, cp_group=group,
                           attn_impl="gather")[0]
    out = {}
    for what, want in (("K2 (CP) vs K1 (paged_forward)", k1),
                       ("K2 vs the CP gather arm", plain)):
        res = logits_agree(got, want, what, "cp-model")
        if res["rel"] > 0.05:
            raise RuntimeError(f"CP logits disagree ({what}): "
                               f"{res['rel']:.3g} > 5% of the scale")
        out[what] = res
    # at cp 1 K2 runs K1's body on K1's tiles in K1's order, and the ring
    # divides acc / l in f32 as K1 does: the logits are equal bit for bit
    if not torch.equal(got, k1):
        raise RuntimeError("CP logits differ from K1's: K2 at cp 1 must run "
                           "K1's arithmetic in K1's order")
    return out


def cp_engine_phase(params, cfg, card, group):
    """The CP serving main path at Mistral-7B-v0.1's published context:
    ``ServingEngine(cp_group=...)`` (4 slots, blocks of 16, chunk 512,
    max_ctx 32768) serves 4 greedy requests whose prompts are 30720,
    24576, 16384 and 8192 tokens from ``RandomState(2)``, 32 new tokens
    each.  Counts set to 0 just before the run and read just after: K2
    once a layer a device call, K1 never.  Every request completes and
    the pool is conserved.  Then the same requests through the K1 engine
    (no group): the share of generated tokens equal to it, reported and
    not held (random weights give near-ties)."""
    from torchdistpackage_tpu_torch.ops import paged_attention as pa
    from torchdistpackage_tpu_torch.serving import Request, ServingEngine

    rs = np.random.RandomState(2)
    lens = [30720, 24576, 16384, 8192]
    reqs = [Request(rs.randint(0, cfg.vocab_size, n).tolist(), 32)
            for n in lens]
    kw = dict(num_slots=4, block_size=BS, chunk=512, max_ctx=32768)
    eng = ServingEngine(params, cfg, cp_group=group, **kw)
    if eng.attn_impl != "cuda" or eng.cp != 1:
        raise RuntimeError(f"CP engine resolved attn_impl={eng.attn_impl!r}"
                           f", cp={eng.cp}")
    pool_gb = eng.serving_summary()["kv_pool"]["pool_bytes"] / 1e9
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rids = [eng.submit(r) for r in reqs]
    reset_counts()
    t0 = time.perf_counter()
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: pa.LAUNCHES[k] for k in ("paged_carry_attention",
                                            "paged_decode_attention")}
    s = eng.serving_summary()
    calls = s["prefill_chunks"] + s["decode_steps"]
    if launches != {"paged_carry_attention": cfg.nlayers * calls,
                    "paged_decode_attention": 0}:
        raise RuntimeError(f"CP engine launches {launches}, want K2 "
                           f"{cfg.nlayers} x {calls} and K1 0")
    if s["requests"]["completed"] != len(reqs):
        raise RuntimeError(f"completed {s['requests']} of {len(reqs)}")
    for r, req in zip(rids, reqs):
        f = eng.finished[r]
        gen = f["tokens"][len(req.tokens):]
        if (f["reason"] != "max_tokens" or len(gen) != req.max_new_tokens
                or gen.min() < 0 or gen.max() >= cfg.vocab_size):
            raise RuntimeError(f"request {r} finished wrong: {f['reason']}")
    if not eng.audit(heal=False)["ok"] or eng._alloc.in_use:
        raise RuntimeError("pool not conserved after the run")
    lc = s["long_context"]
    if lc["cp"] != 1 or lc["ring_hops"] or lc["ring_bytes"]:
        raise RuntimeError(f"long_context at cp 1 wrong: {lc}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    got = [eng.finished[r]["tokens"][len(q.tokens):] for r, q in
           zip(rids, reqs)]
    del eng
    torch.cuda.empty_cache()
    ref = ServingEngine(params, cfg, **kw)
    ref_rids = [ref.submit(r) for r in reqs]
    ref.run_until_idle()
    want = [ref.finished[r]["tokens"][len(q.tokens):] for r, q in
            zip(ref_rids, reqs)]
    del ref
    torch.cuda.empty_cache()
    same = float(np.mean(np.concatenate(got) == np.concatenate(want)))
    lead = [int(np.argmin(np.append(g == w, False))) for g, w in
            zip(got, want)]
    ttft, tpot = s["ttft_s"], s["tpot_s"]
    log(f"[cp-engine] {len(reqs)} greedy requests, prompts {lens} (32768 "
        f"positions), pool {pool_gb:.2f} GB: {s['generated_tokens']} tokens "
        f"in {wall:.2f} s: {s['tokens_per_sec']:.2f} tok/s, TTFT p50 "
        f"{ttft['p50']:.3f} s p99 {ttft['p99']:.3f} s, TPOT p50 "
        f"{tpot['p50'] * 1e3:.2f} ms p99 {tpot['p99'] * 1e3:.2f} ms, peak "
        f"memory {peak_gb:.2f} GB, {s['prefill_chunks']} prefill calls + "
        f"{s['decode_steps']} decode calls, launches {launches}, "
        f"long_context {lc} — on {card}")
    log(f"[cp-engine] greedy tokens equal to the K1 engine's: {same:.3f} "
        f"of {len(np.concatenate(got))} (first divergence at tokens "
        f"{lead} of 32; reported, not held)")
    return {"launches": launches, "summary": s, "wall_s": wall,
            "peak_gb": peak_gb, "pool_gb": pool_gb, "k1_agree": same}


def cp_phase(params, cfg, card):
    """The context-parallel serving path on the Mistral model already
    built: a one-rank NCCL group (``init_distributed`` on the card,
    ``build_cp_group(1)``; at cp 1 the ring is one hop a layer and no
    payload travels — the layout is the reference's at any cp), then the
    teacher-forced logits, the engine at 32768 positions and a profiled
    decode tick.  The group is destroyed before the model is freed."""
    import torch.distributed as dist

    from torchdistpackage_tpu_torch.dist import (
        build_cp_group,
        init_distributed,
    )

    init_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0, "cuda")
    try:
        group = build_cp_group(1)
        log(f"[cp] process group: backend {dist.get_backend(group)}, CP "
            f"size {group.size()}")
        if dist.get_backend(group) != "nccl":
            raise RuntimeError("the CP group on the card must use NCCL")
        model = cp_model_phase(params, cfg, group)
        eng = cp_engine_phase(params, cfg, card, group)
        profile_phase(params, cfg, card, tag="cp-profile", cp_group=group)
    finally:
        dist.destroy_process_group()
    return {"model": model, **eng}


def build_int8_mixtral(cfg, seed=0):
    """Mixtral-8x7B-v0.1 at full depth, int8 weight-only, on the card,
    built one block at a time from the public init functions so that no
    bf16 copy of the whole model (93.4 GB) ever exists: each block's
    attention and experts are drawn in bf16 from one seeded generator,
    the experts go through ``quantize_moe_experts`` (2.8 GB of bf16 ->
    1.4 GB of int8) and the bf16 experts are freed; after the last block
    ``quantize_decode_params`` turns the attention projections and the
    head into int8 ``QuantizedLinear`` leaves."""
    import math

    from torchdistpackage_tpu_torch.models.gpt_moe import moe_layer_config
    from torchdistpackage_tpu_torch.ops.moe_dispatch import (
        quantize_moe_experts,
    )
    from torchdistpackage_tpu_torch.parallel.moe import init_moe_params
    from torchdistpackage_tpu_torch.parallel.tensor_parallel.layers import (
        _normal,
        init_block_params,
        init_norm_params,
    )
    from torchdistpackage_tpu_torch.tools.surgery import (
        quantize_decode_params,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, V, dt = cfg.dim, cfg.vocab_size, cfg.dtype
    mcfg = moe_layer_config(cfg)
    params = {"tok_emb": _normal((V, D), 0.02, dt, gen, dev), "blocks": []}
    for _ in range(cfg.nlayers):
        bp = init_block_params(gen, cfg.block, device=dev, mlp=False)
        bp["moe"] = init_moe_params(gen, mcfg, device=dev)
        bp["moe"]["experts"] = quantize_moe_experts(bp["moe"]["experts"])
        params["blocks"].append(bp)
    params["ln_f"] = init_norm_params(D, dt, cfg.norm, dev)
    params["head"] = _normal((D, V), 1.0 / math.sqrt(D), dt, gen, dev)
    return quantize_decode_params(params)


def int8_model_bytes(params):
    """Bytes on the card by part: expert int8 weights, their scales, the
    int8 attention projections and head (with scales), ``tok_emb``, and
    the rest (norms, biases, routers)."""
    from torchdistpackage_tpu_torch.obs.numerics import tree_bytes

    experts = [b["moe"]["experts"] for b in params["blocks"]]
    parts = {
        "experts_int8": sum(ex[n][0].numel() for ex in experts
                            for n in ("w1", "w2")),
        "expert_scales": sum(ex[n][1].numel() * 4 for ex in experts
                             for n in ("w1", "w2")),
        "attention_and_head_int8": tree_bytes(
            [[b["attn"][n] for n in ("wq", "wkv", "wo")]
             for b in params["blocks"]] + [params["head"]]),
        "tok_emb": tree_bytes(params["tok_emb"]),
    }
    parts["rest"] = tree_bytes(params) - sum(parts.values())
    parts["total"] = tree_bytes(params)
    return parts


FLASH_SOURCE = "torchdistpackage_tpu_torch/ops/csrc/flash_attention.cu"
FLASH_REPLACES = {
    "flash_fwd": "torchdistpackage_tpu/ops/flash_attention.py:232",
    "flash_bwd_dq": "torchdistpackage_tpu/ops/flash_attention.py:369",
    "flash_bwd_dkv": "torchdistpackage_tpu/ops/flash_attention.py:395",
}


PAGED_TAGS = ("bf16", "f32", "bf16 q int8 pool", "f32 q int8 pool")


def paged_instantiation(line):
    """``(name, label)`` of a K1/K2 instantiation named in a ptxas line
    (``paged_{walk,tc,split,merge}_kernel<dtype tag, hd, carry>``), or
    None."""
    m = re.search(
        r"(paged_(?:walk|tc|split|merge)_kernel)ILi(\d)ELi(\d+)ELb([01])E",
        line)
    if m is None:
        return None
    name, tag, hd, carry = m.group(1), int(m.group(2)), m.group(3), m.group(4)
    return name, (f"{'K2' if carry == '1' else 'K1'} {name} "
                  f"{PAGED_TAGS[tag]} hd {hd}")


WGMMA_KERNELS = {"flash_fwd_wgmma_kernel": "K3",
                 "flash_bwd_dq_wgmma_kernel": "K4",
                 "flash_bwd_dkv_wgmma_kernel": "K5",
                 "moe_ffn_up_wgmma_kernel": "K6",
                 "moe_ffn_down_wgmma_kernel": "K6",
                 "expert_ffn_up_wgmma_kernel": "K7",
                 "expert_ffn_down_wgmma_kernel": "K7",
                 "expert_ffn_up_decode_kernel": "K7",
                 "expert_ffn_down_decode_kernel": "K7",
                 "moe_ffn_up_decode_kernel": "K6",
                 "moe_ffn_down_decode_kernel": "K6"}
# the warpgroup instantiations the build must hold, by kernel
WGMMA_COUNTS = {"K3": 2, "K4": 2, "K5": 2, "K6": 12, "K7": 24}


def wgmma_label(name, line):
    """``(label, (smem function, its args))`` of a warpgroup instantiation
    named in a ptxas line: K3-K5 by head dim (``tdp_flash_smem_bytes(
    kernel, 0, hd)``), K6's and K7's chunk passes by weight type and
    activation (``tdp_expert_ffn_wgmma_smem_bytes(up, quantized,
    swiglu)``: the two share the body), K6's and K7's decode passes by
    those and the row tile (K6's is 16;
    ``tdp_expert_ffn_decode_smem_bytes(up, quantized, swiglu, rows)``)."""
    if name.startswith("flash"):
        hd = 128 if "ILi128E" in line else 64
        kernel = {"K3": 0, "K4": 1, "K5": 2}[WGMMA_KERNELS[name]]
        return (f"{WGMMA_KERNELS[name]} {name} bf16 hd {hd}",
                ("tdp_flash_smem_bytes", (kernel, 0, hd)))
    flags = [int(b) for b in re.findall(r"Lb([01])E", line)]
    q, swiglu = flags[0], flags[1] if len(flags) > 1 else 0
    up = int("_up_" in name)
    act = ("swiglu" if swiglu else "gelu") if up else "any act"
    label = (f"{WGMMA_KERNELS[name]} {name} bf16 "
             f"{'tokens' if name.startswith('moe') else 'rows'}, "
             f"{'int8' if q else 'bf16'} weights, {act}")
    if "_decode_" in name:
        rows = (16 if name.startswith("moe")
                else int(re.search(r"Li(\d+)E", line).group(1)))
        return (f"{label}, row tile {rows}",
                ("tdp_expert_ffn_decode_smem_bytes", (up, q, swiglu, rows)))
    return label, ("tdp_expert_ffn_wgmma_smem_bytes", (up, q, swiglu))


def hgmma_counts(lib_path):
    """HGMMA (wgmma) instructions in each function of a built library, by
    ``cuobjdump -sass``: {mangled name: count}."""
    from torchdistpackage_tpu_torch.ops import _build

    cuobjdump = str(Path(_build._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return counts


def build_phase():
    """The three sources built at once (one nvcc each), with the
    planted-fault builds of paged_attention.cu (``PAGED_FAULTS``, run by
    ``with_paged_fault``) and of moe_dispatch.cu (``MOE_RUN_DROPPED``,
    run by the MoE phases' decode faults); ptxas' registers,
    shared memory and spills of every instantiation, its advisories
    (C75xx: a serialised wgmma fails the phase), and a summary line of
    each K1/K2 instantiation's registers and spills and of each
    warpgroup instantiation (bf16 K3-K5; K6's and K7's chunk and decode
    passes) with its registers, spills, shared memory and
    HGMMA count (``cuobjdump -sass``; none fails the phase: the warpgroup
    bodies must really run on wgmma).  Returns those summaries (label -> {"registers",
    "spill_stores", "spill_loads", ...})."""
    from torchdistpackage_tpu_torch.ops import _build

    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3 + len(PAGED_FAULTS)) as pool:
        faults = [pool.submit(_build.load, "paged_attention",
                              paged_fault_defines(f)) for f in PAGED_FAULTS]
        faults.append(pool.submit(_build.load, MOE_NAME, MOE_RUN_DROPPED))
        faults.append(pool.submit(_build.load, "flash_attention",
                                  FLASH_FAULT))
        libs = pool.submit(_build.load_all, ["paged_attention",
                                             "flash_attention",
                                             "moe_dispatch"]).result()
        for fut in faults:
            fut.result()
    log(f"[build] all sources, the {len(PAGED_FAULTS)} planted-fault "
        f"variants of paged_attention.cu and the one each of moe_dispatch.cu "
        f"and flash_attention.cu built in "
        f"{time.perf_counter() - t0:.1f} s ("
        + ", ".join(f"{n}.cu {i['seconds']:.1f} s"
                    for n, i in _build.BUILD_INFO.items()) + ")")
    summary = {}
    for src, info in _build.BUILD_INFO.items():
        if " -D" in src:  # a planted-fault variant
            continue
        kernel = "?"
        for line in str(info["log"]).splitlines():
            if "Compiling entry function" in line:  # name the instantiation
                inst = paged_instantiation(line)
                m = re.search(
                    r"\d+((?:flash_\w+"
                    r"|moe_tiles"
                    r"|moe_ffn(?:_int8|_up_wgmma|_down_wgmma|_up_decode"
                    r"|_down_decode|_merge)?"
                    r"|expert_ffn(?:_int8|_up_wgmma|_down_wgmma|_up_decode"
                    r"|_down_decode|_merge)?)_kernel)[IE]", line)
                name = m.group(1) if m else "?"
                dt = ("bf16" if "13__nv_bfloat16" in line
                      or name in WGMMA_KERNELS else "f32")
                if inst is not None:
                    kernel = inst[1]
                    summary[kernel] = {"registers": None, "spill_stores": None,
                                     "spill_loads": None}
                elif name in WGMMA_KERNELS:
                    kernel, smem_args = wgmma_label(name, line)
                    summary[kernel] = {"registers": None, "spill_stores": None,
                                     "spill_loads": None, "lib": src,
                                     "smem": smem_args,
                                     "function": re.search(
                                         r"function '(\S+)'", line).group(1)}
                elif name.endswith("_merge_kernel"):  # the decode merges
                    kernel = (f"{name} "
                              f"{'int8' if 'Lb1E' in line else 'bf16'} "
                              f"weights")
                elif name == "moe_tiles_kernel":
                    kernel = name
                elif name.startswith(("moe_ffn", "expert_ffn")):
                    kernel = (f"{name} {dt} "
                              f"{'swiglu' if 'Lb1E' in line else 'gelu'}")
                else:
                    kernel = (f"{name} {dt} "
                              f"hd {128 if 'Li128E' in line else 64}")
            elif re.search(r"C75\d\d", line):
                raise RuntimeError(f"build: {src}: ptxas advisory (a "
                                   f"serialised wgmma): {line.strip()}")
            elif re.search(r"registers|spill|smem", line):
                log(f"[build] {src}: {kernel}: {line.strip()}")
                if kernel in summary:
                    for key, pat in (
                            ("registers", r"Used (\d+) registers"),
                            ("spill_stores", r"(\d+) bytes spill stores"),
                            ("spill_loads", r"(\d+) bytes spill loads")):
                        m = re.search(pat, line)
                        if m:
                            summary[kernel][key] = int(m.group(1))
    fsmem = libs["flash_attention"].tdp_flash_smem_bytes
    fsmem.argtypes, fsmem.restype = [ctypes.c_int] * 3, ctypes.c_int
    hgmma = {}
    for src in ("flash_attention", "moe_dispatch"):
        hgmma.update(hgmma_counts(_build.BUILD_INFO[src]["path"]))
    for kernel, regs in summary.items():
        extra = ""
        if "function" in regs:
            fn_name, args = regs.pop("smem")
            smem = getattr(libs[regs.pop("lib")], fn_name)
            smem.argtypes = [ctypes.c_int] * len(args)
            smem.restype = ctypes.c_int
            regs["smem_bytes"] = smem(*args)
            regs["hgmma"] = hgmma.get(regs.pop("function"), 0)
            extra = (f", {regs['smem_bytes']} B dynamic shared memory, "
                     f"{regs['hgmma']} HGMMA instructions")
            if regs["hgmma"] == 0:
                raise RuntimeError(f"{kernel}: no HGMMA instruction in its "
                                   f"SASS: the body does not run on wgmma")
            # K4's, K5's and K6's / K7's chunk warpgroups trade registers
            # by setmaxnreg, whose budget (24 x 128 + 240 x 256) is the
            # launch's: 168 a thread at 384 threads.  With fewer,
            # setmaxnreg.inc would wait forever.  (K7's decode body does
            # not trade.)
            if (kernel[:2] in ("K4", "K5", "K6", "K7")
                    and "_decode_" not in kernel
                    and regs["registers"] != 168):
                raise RuntimeError(f"{kernel}: {regs['registers']} registers "
                                   f"at launch, not the 168 its setmaxnreg "
                                   f"budget assumes")
        log(f"[build] {kernel}: {regs['registers']} registers, "
            f"{regs['spill_stores']} bytes spill stores, "
            f"{regs['spill_loads']} bytes spill loads{extra}")
    found = {k: sum(1 for n in summary if n[:2] == k) for k in WGMMA_COUNTS}
    if found != WGMMA_COUNTS:
        raise RuntimeError(f"build: not every warpgroup instantiation "
                           f"({WGMMA_COUNTS}) was found in ptxas' log: "
                           f"{found}")
    smem = libs["paged_attention"].tdp_paged_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int] * 3, ctypes.c_int
    log("[build] paged_attention (K1 and K2) dynamic shared memory per CTA "
        "(hd 128): " + ", ".join(
            f"{name} {smem(tag, 128, rows)} B"
            for name, tag, rows in (
                ("decode bf16", 0, GROUPS), ("decode f32", 1, GROUPS),
                ("decode int8", 2, GROUPS),
                ("prefill bf16 (tensor cores)", 0, GROUPS * 512),
                ("prefill f32", 1, GROUPS * 512),
                ("prefill int8", 2, GROUPS * 512))))
    log("[build] flash_attention dynamic shared memory per CTA: " + ", ".join(
        f"{kern} {dt} hd {hd} {fsmem(i, tag, hd)} B"
        for i, kern in enumerate(("fwd", "dq", "dkv"))
        for tag, dt in ((0, "bf16"), (1, "f32")) for hd in (64, 128)))
    msmem = libs["moe_dispatch"].tdp_moe_ffn_smem_bytes
    msmem.argtypes, msmem.restype = [ctypes.c_int] * 2, ctypes.c_int
    log("[build] moe_dispatch dynamic shared memory per CTA (the walk "
        "body, K6's and K7's f32 rows): " + ", ".join(
            f"{dt} {act} {msmem(tag, sw)} B"
            for tag, dt in ((0, "bf16"), (1, "f32"), (2, "bf16 int8 weights"),
                            (3, "f32 int8 weights"))
            for sw, act in ((0, "gelu"), (1, "swiglu"))))
    return summary


def kernel_entry(name, route_src, replaces, launches, rows, head,
                 **extra):
    return {
        "name": name, "route": "cuda", "source": route_src,
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "max_tol_ratio": max(r["tol_ratio"] for r in rows),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "shape": head["case"],
        "graph_ms": head.get("graph_ms"),
        "cases_passed": len(rows), "cases": rows, **extra,
    }


def main():
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    from torchdistpackage_tpu_torch.models import (
        init_gpt_moe_params,
        init_gpt_params,
        mistral_7b_config,
        mixtral_8x7b_config,
    )
    # the plain versions are the f32 references: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = card_line()
    log(f"[device] {name} x{count}; nvidia-smi: {card}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    t_start = time.perf_counter()

    # 2. build
    ptxas_summary = build_phase()

    # 3. every kernel against its plain version
    rows = kernel_phase()
    flash_rows = flash_kernel_phase()
    moe_rows = moe_kernel_phase()
    int8_rows = moe_int8_kernel_phase()
    k7_rows = expert_ffn_kernel_phase()
    carry_rows = carry_kernel_phase()
    log(f"[time] kernel checks done at {time.perf_counter() - t_start:.0f} s")

    # 4. the training path: GPT-125M main path, the kernel path against the
    # plain path, a short Mistral-width run
    train = train_phase(card)
    path_parity_phase()
    mistral_train_phase(card)
    dp_train_phase(card)
    log(f"[time] training done at {time.perf_counter() - t_start:.0f} s")

    # 5. the serving path: full-width teacher-forced, then the engine
    cfg = mistral_7b_config()
    t0 = time.perf_counter()
    params = init_gpt_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"[model] Mistral-7B-v0.1 widths, {cfg.nlayers} layers, "
        f"{cfg.num_params() / 1e9:.3f} B params in bf16, initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    model_phase(params, cfg)
    eng = engine_phase(params, cfg, card)
    profile_phase(params, cfg, card)
    # the same model served context-parallel, K2 in every attention
    cp_eng = cp_phase(params, cfg, card)
    # the contiguous-cache decoding family (K3 at the prefill) and the
    # speculative engine (K1 on the K+1-row verify)
    gen = generate_phase(params, cfg, card)
    spec_eng = spec_engine_phase(params, cfg, card)
    log(f"[time] generate and speculative serving done at "
        f"{time.perf_counter() - t_start:.0f} s")
    del params
    torch.cuda.empty_cache()
    log(f"[time] serving done at {time.perf_counter() - t_start:.0f} s")

    # 6. the MoE serving path: Mixtral-8x7B-v0.1 widths at 16 of its 32
    # layers (all 32 are 93.4 GB of bf16 weights, more than the card holds)
    cfg = mixtral_8x7b_config(nlayers=16)
    cfg_moe_layers = cfg.nlayers
    t0 = time.perf_counter()
    params = init_gpt_moe_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"[moe-model] Mixtral-8x7B-v0.1 widths, {cfg.nlayers} of 32 layers, "
        f"{cfg.num_params() / 1e9:.3f} B params in bf16 "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB on the card), "
        f"initialised in {time.perf_counter() - t0:.1f} s")
    moe_model_phase(params, cfg)
    moe_eng = moe_engine_phase(params, cfg, card)
    profile_phase(params, cfg, card, max_ctx=4096, tag="moe-profile")
    profile_prefill(params, cfg, card, tag="moe-prefill-profile")
    # the same model served expert-parallel, K7 in every expert layer;
    # then greedy generate through K6 and, over the same group, K7
    ep_eng = ep_phase(params, cfg, card, "fused_expert_ffn", "ep",
                      then=lambda shard, group: moe_generate_phase(
                          params, shard, cfg, card, group))
    del params
    torch.cuda.empty_cache()
    log(f"[time] MoE serving done at {time.perf_counter() - t_start:.0f} s")

    # 7. int8 weight-only serving: Mixtral-8x7B-v0.1 whole (all 32
    # layers), expert layers in K6's int8 variant
    cfg = mixtral_8x7b_config()
    t0 = time.perf_counter()
    params = build_int8_mixtral(cfg)
    torch.cuda.synchronize()
    parts = int8_model_bytes(params)
    log(f"[int8-model] Mixtral-8x7B-v0.1, all {cfg.nlayers} layers, "
        f"{cfg.num_params() / 1e9:.3f} B params, int8 weight-only: "
        + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in parts.items())
        + f" ({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated on the "
        f"card), built in {time.perf_counter() - t0:.1f} s")
    moe_model_phase(params, cfg, tag="int8-model",
                    gather_experts=dequant_bf16)
    int8_eng = moe_engine_phase(params, cfg, card, k6="fused_moe_ffn_int8",
                                tag="int8-engine")
    profile_phase(params, cfg, card, max_ctx=4096, tag="int8-profile")
    profile_prefill(params, cfg, card, tag="int8-prefill-profile")
    ep_int8_eng = ep_phase(params, cfg, card, "fused_expert_ffn_int8",
                           "ep-int8", gather_experts=dequant_bf16)
    del params
    torch.cuda.empty_cache()
    log(f"[time] int8 serving done at {time.perf_counter() - t_start:.0f} s")

    # 8. the kernels line (headline numbers: the decode step's shape for
    # K1 and both K6 variants, the training shape for K3-K5)
    entries = [kernel_entry("paged_decode_attention",
                            "torchdistpackage_tpu_torch/ops/csrc/"
                            "paged_attention.cu", TPU_SOURCE,
                            eng["launches"], rows, rows[0],
                            ptxas={k: v for k, v in ptxas_summary.items()
                                   if k.startswith("K1")},
                            spec_engine_launches={
                                f"spec_k {k}": spec_eng[k]["launches"]
                                for k in (3, 4)})]
    for kname, krows in flash_rows.items():
        k = {"flash_fwd": "K3", "flash_bwd_dq": "K4",
             "flash_bwd_dkv": "K5"}[kname]
        extra = {}
        if kname == "flash_fwd":  # the generate path's prefill calls
            extra["generate_launches"] = {
                "generate": gen["launches"]["flash_fwd"],
                "moe_generate": cfg_moe_layers}
        entries.append(kernel_entry(kname, FLASH_SOURCE,
                                    FLASH_REPLACES[kname],
                                    train["launches"][kname], krows,
                                    krows[0], ptxas={
                                        n: v for n, v in ptxas_summary.items()
                                        if n.startswith(k)}, **extra))
    entries.append(kernel_entry(
        "fused_moe_ffn", MOE_SOURCE, MOE_REPLACES,
        moe_eng["launches"]["fused_moe_ffn"], moe_rows, moe_rows[0],
        body=moe_rows[0]["body"], body_kernels=MOE_BODY_KERNELS,
        generate_launches=ep_eng["then"]["K6"]["launches"],
        ptxas={n: v for n, v in ptxas_summary.items()
               if n.startswith("K6") and "bf16 weights" in n},
        library="the ragged 'gather' arm: one cuBLAS product per expert "
                "and weight (several calls)"))
    entries.append(kernel_entry(
        "fused_moe_ffn_int8", MOE_SOURCE, MOE_INT8_REPLACES,
        int8_eng["launches"]["fused_moe_ffn_int8"], int8_rows, int8_rows[0],
        body=int8_rows[0]["body"], body_kernels=MOE_BODY_KERNELS,
        ptxas={n: v for n, v in ptxas_summary.items()
               if n.startswith("K6") and "int8 weights" in n},
        library="the ragged 'gather' arm over bf16 weights dequantised "
                "beforehand: one cuBLAS product per expert and weight "
                "(several calls; no PyTorch call takes int8 weights)"))
    for kname, ep in (("fused_expert_ffn", ep_eng),
                      ("fused_expert_ffn_int8", ep_int8_eng)):
        krows = k7_rows[kname]
        weights = "int8 weights" if kname.endswith("int8") else "bf16 weights"
        extra = ({"generate_launches": ep["then"]["K7"]["launches"]}
                 if ep["then"] else {})
        entries.append(kernel_entry(
            kname, MOE_SOURCE, K7_REPLACES[kname], ep["launches"][kname],
            krows, krows[0], **extra,
            ptxas={n: v for n, v in ptxas_summary.items()
                   if n.startswith("K7") and weights in n},
            library="the torch.bmm chain: one cuBLAS batched product per "
                    "weight (several calls; for int8 over bf16 weights "
                    "dequantised beforehand)"))
    entries.append(kernel_entry(
        "paged_carry_attention", CARRY_SOURCE, CARRY_REPLACES,
        cp_eng["launches"]["paged_carry_attention"], carry_rows,
        carry_rows[0], k1_ms=carry_rows[0]["k1_ms"],
        k1_graph_ms=carry_rows[0]["k1_graph_ms"],
        ptxas={k: v for k, v in ptxas_summary.items() if k.startswith("K2")},
        library="SDPA over the gathered view at one hop; k1_ms: K1 on the "
                "same one-hop inputs (graph_ms, k1_graph_ms: replayed from "
                "a CUDA graph)"))
    log(json.dumps({"kernels": entries}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
