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
   bit-identical, apart from rate 0).  Then tensor parallel
   (``tp_train_phase``): a one-rank NCCL group as ``tpc``'s ``tensor``
   axis, the GPT-125M run through ``make_train_step``'s TP step at
   ``sp=False`` and at ``sp=True`` (``collective_matmul`` set, but at
   one rank the rings take the reference's shortcut, so the card runs
   the fused regions; ``ring_ag_matmul`` / ``ring_matmul_rs`` are proven
   by the gloo tests alone): every step's loss within 1e-3 relative of the serial step's, K3-K5 once a
   layer a step, each region's collectives exactly as many as a step
   runs (``tp_collectives``), the step medians beside the serial one.
   Then the sharded training state (``zero_fsdp_phase``): a one-rank
   NCCL group as ``tpc``'s ``data`` axis, the GPT-125M run through
   ``make_train_step`` (11 steps) and through ``ZeroOptimizer`` (bf16
   parameters, f32 master shards; step 1's loss bit-identical, every
   loss within ``ZERO_TOL`` relative, the largest gap printed;
   ``ShardedEMA(0.99)`` exact against a dense EMA formed on the card),
   the same with ``chain(clip_by_global_norm_parallel(1.0), adamw)``
   (step 1's norm before the clip within 1e-3 relative of
   ``make_train_step``'s, the clipped norm <= 1 + 1e-5),
   ``FSDP.make_train_step`` and ``make_overlap_train_step`` (losses and
   parameters after 10 steps bit-identical), ``offload_to_host`` /
   ``reload_to_device`` of the FSDP run's shards and AdamW state (the
   card's bytes lower by theirs, step 11 after the reload bit-identical
   to ``make_train_step``'s), and ``prefetched_layer_scan`` over the 12
   blocks with prefetch on and off (bit-identical); K3-K5 once a layer a
   step on every run; step medians, peaks and collectives a step.
   Then the pipeline (``pipeline_phase``): (a) over a one-rank NCCL data
   1 x pipe 1 layout, ``gpt_pipeline_1f1b`` at M 4 against
   ``local_value_and_grad(gpt_loss, grad_accum_iters=4)`` (loss within
   1e-3 relative, every grad leaf within 2 % of its largest |grad|), 10
   AdamW steps through ``DataParallel.make_train_step(value_and_grad_fn=
   gpt_pipeline_1f1b)`` (losses within 1e-3 relative of the accumulating
   step's) and through ``ZeroOptimizer`` (within ``ZERO_TOL``), K3-K5
   exactly 12 x 4 a step; (b) two spawned processes on the card, a pipe
   group of 2 over gloo (6 layers each), against the parent's serial
   reference at accumulation 8: 1F1B, interleaved V 2 and zero-bubble at
   M 8, one warm-up and three timed steps each (every loss within 1e-3
   relative, the embedding's and the head's grads within 2 % of their
   scale, K3-K5 exactly 6 x 8 a step, ZB 3 x / 2 x / 2 x that, in-flight
   maxima within the bound), and a 1F1B step with the replicated leaves'
   pipe sum planted out, which must fail its gate.  Then MoE training
   (``moe_train_phase``) at ``bench.py``'s ``--moe`` leaf (GPT-MoE
   8x125M, batch 8, S 2048, bf16, remat 'flash'): 10 steps through K6
   under autograd against the plain ``'sorted'`` arm (losses within
   ``MOE_LOSS_TOL``; step, tokens/s, MFU, peak; K3-K6 12 a step), one K6
   step replaying that arm's routing (every grad leaf within 5 %); K6's
   and K7's Functions at one expert block of the training shape against
   the f32 oracles, each with a planted fault; the moe view's
   ``DataParallel`` with ``ep_group`` (K7 12 a step) against the arm, its
   grads with the routing replayed; accumulation 4, the one-stage MoE
   1F1B and ZeRO x 1F1B (K3-K5 and K7 48 a step).  Then the ViT family
   and training context parallelism: ``vit_train_phase`` (ViT-B/16 at
   its published widths, batch 128, bf16, flash, remat 'flash': the
   first forward against the same weights' 'naive' one, loss within
   ``VIT_LOSS_TOL`` and logits within ``VIT_LOGIT_TOL``, a planted
   causal K3 that must miss; 8 AdamW steps, K3-K5 12 a step; step,
   images/s, MFU, peak), ``vit_moe_train_phase`` (the same widths with 8
   experts, top-2, every 2nd block: K6 under autograd 12 a step, its
   first loss against the ``'sorted'`` arm's; the expert-choice router
   on its plain arm; one expert layer's K6 forward at T 128 x 196 and at
   GPT-MoE's T 16384 beside the ``'sorted'`` arm), and
   ``cp_train_phase``: (a) GPT-125M over a one-rank NCCL context group,
   ``'ring'`` and ``'ulysses'`` bit-identical to ``'flash'``; (b) two
   spawned processes over gloo at S 8192 (4096 a rank): ring
   contiguous, ring zigzag and Ulysses against the serial step (loss
   within ``CP_LOSS_TOL``, the ``CP_LEAVES`` grads within
   ``CP_GRAD_TOL``), K3 a rank a layer by hop arithmetic
   (``CP_K3_A_LAYER``), three planted faults (the lse cotangent
   dropped, a past hop run causally, zigzag on contiguous chunks) that
   must miss, and ViT-B/16 under the ring at cp 2 (every leaf's grad
   whole on each rank).  K3-K5 are also held at the ViT's shape and at
   one ring hop (``cp_kernel_rows``, in phase 3).
5. serve   — Mistral-7B-v0.1 widths, all 32 layers, bf16, random weights:
   ``paged_forward`` with K1 against the plain path on identical tokens
   (teacher-forced logits), then ``ServingEngine`` serves 16 requests
   (12 greedy, 4 sampled) through K1, launched once per layer per device
   call.  Then observability (``obs_phase``): the same 16 requests through
   ``ServingEngine(telemetry=Telemetry(...), watchdog=Watchdog(60),
   metrics_sink=MultiSink([JsonlSink, PrometheusTextfileSink]))`` — every
   token, K1's launches and each K1 body's equal to the plain engine's,
   one decode signature, no ``recompile``; every tick's phases (audit /
   sched / prefill / draft / decode / fetch / host) make its ``tick_s``,
   summed 0.90-1.00 of the run's wall time, ``decode`` and ``fetch``
   above 0 on every decode tick (the share of a tick that is not
   ``fetch`` printed); every request's lifecycle rebuilt from the
   timeline; the RUNREPORT (card memory reported, the pool's accounting
   matched), the Perfetto trace and the sinks' records valid; planted: a
   rid dropped from one ``engine_tick``, the pool's bytes off by one
   block, and a 2.5 s ``slot_stall`` under ``Watchdog(timeout_s=1.0,
   abort=True)`` whose exit hook is replaced (``hang_suspected``, then
   ``hang_abort`` and the hook, the requests still finishing); tok/s,
   TTFT and TPOT printed beside the plain engine's.  Then a decode tick
   of 8 slots is timed and profiled, and the same model
   context-parallel (``cp_phase``): a one-rank NCCL group
   (``init_distributed``, ``build_cp_group(1)``), ``cp_paged_forward``
   with K2 against ``paged_forward`` with K1 (equal bit for bit: at cp 1
   K2 runs K1's body on K1's tiles) and against the CP gather arm on a
   4700-token context (teacher-forced logits), then
   ``ServingEngine(cp_group=...)`` serves 4 greedy requests of 30720,
   24576, 16384 and 8192 prompt tokens (Mistral's 32768 positions, a ~17
   GB pool) through K2, launched once per layer per device call, K1
   never; the share of its tokens equal to the K1 engine's on the same
   requests; a decode tick profiled; and TP beside CP
   (``tp_cp_phase``: a one-rank NCCL context x tensor layout,
   ``ServingEngine(cp_group=, tp_group=, replica_group=)`` on the same 4
   requests, every token equal to the CP engine's, K2 once a layer a
   device call, K1 never).  Then the contiguous-cache decoding
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
   the library's launch counts: the split decode body at K 3,
   ``paged_tc_kernel`` at K 4).  Then the fleet (``fleet_phase``, every
   replica on the one parameter dict with a pool of its own): (a) a
   ``Router`` over a prefill and a decode replica serving the engine's
   16 requests — the prefill replica launches only K1's
   ``paged_tc_kernel``, the decode replica only its split body and
   merge (the library's counts), greedy tokens the plain engine's or a
   teacher-forced near-tie within 5 %, the migrated bytes
   ``migration_wire_bytes``, each handoff's ``migrate_blocks`` timed by
   CUDA events, the audit green after every tick, and the Router's
   ``telemetry=``: its FLEETREPORT and fleet trace valid, each request
   one journey from the prefill replica to the decode replica; (b) two
   ``'both'``
   replicas with the prefix cache: 8 requests on a 2048-token system
   prompt, every one after the first routed to the warm replica by
   affinity; (c) the chunked wire under chaos (a dropped chunk healed by
   one retry, the decode replica dying mid-migration and evacuated, a
   ``table_corrupt`` on one of two decode replicas evacuated to the
   other); (d) the long-prompt tier: a CP prefill replica over a
   one-rank NCCL group (K2 only) handing prompts of 8192 and 12288
   tokens to a plain decode replica (K1 only), two ``kv_handoff_long``;
   (e) a planted transport shipping every live block but the last,
   which the token gate must fail.  Then tensor parallel over a one-rank
   NCCL ``tensor`` group: ``ServingEngine(tp_group=)`` on the engine's 16
   requests (``tp_engine_phase``: every token equal to the plain
   engine's, K1 once a layer a device call, tok/s, TTFT and TPOT beside
   the plain engine's), ``generate(tp_group=)`` at B 4, 1000-token
   prompts, 16 new tokens (equal to ``generate()``'s, K3 once a layer),
   and on a 2-layer model of Mixtral-8x7B-v0.1's widths (equal, K6 once a
   layer a forward call; ``tp_generate_phase``); TP beside EP on that
   model over a one-rank NCCL tensor x moe_ep layout (``tp_ep_phase``:
   the engine on the 16 requests and ``generate`` at B 4, 1000 + 16,
   every token equal to the EP engine's and ``generate(ep_group=)``'s,
   K7 once an expert layer a forward call, K6 never, K3 once a layer at
   the prefill).  Then, with this process's model freed, the engine's
   data-parallel slot groups (``dp_engine_phase``): two processes on the
   card (spawned, gloo between them), each with the whole model and the
   pool of 4 of the 8 slots, serve the 16 requests with ``dp_group=``:
   each rank's K1 once a layer a device call on its own 4 rows, its
   allocator's peak and ``dp_groups`` printed, both hosts' tokens equal,
   and every greedy token the plain engine's or a teacher-forced
   near-tie within 5 % of its row's scale (the exact share printed).
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


def make_case(name, *, B, S_in, offsets, window, dtype, quantized, seed,
              live=None):
    """Random q and pool on the card; tables are a permutation of the
    pool's blocks, wide enough for the deepest slot's rows.  ``live``:
    only these slots hold blocks, the others a NULL row (the idle slots
    of an engine's prefill call)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    mb = -(-(max(offsets) + S_in) // BS)
    nb = 1 + B * mb
    tables = (torch.randperm(nb - 1, generator=g, device=dev) + 1)
    tables = tables.reshape(B, mb).to(torch.int32)
    if live is not None:
        tables[[b for b in range(B) if b not in live]] = 0
    tables = tables.contiguous()
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
        # the prefix cache's shapes: a prefix hit's chunk starts at a block
        # boundary inside the prompt (2048 + 16 k: a multiple of 16, not of
        # the chunk), and a COW admission is one live row at P - 1 = 2047
        # with its chunk's pad rows past the prompt, the other slots idle
        # on NULL tables
        ("prefix_hit_bf16_w4096", dict(B=8, S_in=512, offsets=PREFIX_OFFS,
                                       window=4096, dtype=bf,
                                       quantized=False)),
        ("cow_bf16_w4096", dict(B=8, S_in=512, offsets=COW_OFFS,
                                window=4096, dtype=bf, quantized=False,
                                live={2})),
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
        if name in ("decode_bf16_w4096", "chunk512_bf16_w4096",
                    "prefix_hit_bf16_w4096"):
            planted_faults(case, exact)
        if name == "cow_bf16_w4096":
            planted_faults(case, exact, window_fault=False)
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
#: K1 at the prefix cache's prefill shapes (kernel_phase)
PREFIX_OFFS = [2048 + 16 * k for k in (1, 3, 7, 13, 40, 64, 96, 130)]
COW_OFFS = [0, 0, 2047, 0, 0, 0, 0, 0]


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


def planted_faults(case, exact, window_fault=True):
    """The check must catch the faults it is there for.  The kernel is
    run on deliberately wrong arguments and held against the plain
    version on the right ones: the window edge one pool block late, and
    one stage of 8 blocks of the deepest slot read from other blocks
    (a stage lost or misplaced).  Each must fail the row tolerance.
    ``window_fault=False`` plants the stage fault only (a case whose
    rows the window never reaches)."""
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
    if not window_fault:
        del faults["window one block late"]
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


def flash_case(name, *, B, H, Hkv, S, hd, window, dtype, seed,
               causal=True):
    """Random q, k, v, dO and an lse cotangent on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    return {"name": name, "q": rnd(B, H, S, hd), "k": rnd(B, Hkv, S, hd),
            "v": rnd(B, Hkv, S, hd), "do": rnd(B, H, S, hd),
            "dlse": torch.randn(B, H, S, generator=g, device="cuda"),
            "window": window, "dtype": dtype, "scale": hd ** -0.5,
            "causal": causal}


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
    if not case.get("causal", True):
        seen = np.full(S, S)
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
        kw["is_causal"] = case.get("causal", True)
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


def dp_train_run(cfg, rows, steps, remat="flash", dp=None, dropout_key=None,
                 tp_group=None, sp=False):
    """``steps`` AdamW steps of GPT ``cfg`` on the fixed batch of
    ``train_run`` (the same init seed and batch), through
    ``make_train_step`` or, with ``dp``, ``DataParallel.make_train_step``
    (the batch through ``dp.shard_batch``); with ``tp_group`` the rank's
    shard (``shard_gpt_params``) through ``make_train_step``'s tensor-
    parallel step (``sp``: sequence parallel).  The kernels' counts and
    the regions' collectives are set to 0 just before the steps and read
    just after; the peak memory is over the steps, less what was
    allocated before the run began (so runs made one after another
    compare), its gradients freed at the end."""
    from torchdistpackage_tpu_torch.models import gpt_loss, init_gpt_params
    from torchdistpackage_tpu_torch.models.gpt import (
        gpt_param_specs,
        shard_gpt_params,
    )
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves
    from torchdistpackage_tpu_torch.ops import flash_attention as fa
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        adamw,
        make_train_step,
    )
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        COLLECTIVES,
    )

    gc.collect()  # an earlier run's tensors, freed before the baseline
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = init_gpt_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    if tp_group is not None:
        params = shard_gpt_params(params, cfg, tp_group.rank(),
                                  tp_group.size())
    opt = adamw(3e-4)
    state = opt.init(params)

    def loss_fn(p, b):
        return gpt_loss(p, b, cfg, remat=remat, dropout_key=dropout_key,
                        tp_group=tp_group, sp=sp)

    if tp_group is not None:
        step = make_train_step(loss_fn, opt,
                               param_specs=gpt_param_specs(params), sp=sp,
                               tp_group=tp_group)
        batch = random_batch(cfg, rows, 1)
    elif dp is None:
        step = make_train_step(loss_fn, opt)
        batch = random_batch(cfg, rows, 1)
    else:
        step = dp.make_train_step(loss_fn, opt)
        batch = dp.shard_batch(random_batch(cfg, rows, 1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for name in COLLECTIVES:
        COLLECTIVES[name] = 0
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss, _ = step(params, state, batch)
        losses.append(float(loss))  # reads back: waits for the step
        times.append(time.perf_counter() - t0)
    out = {"losses": losses, "times": times, "launches": dict(fa.LAUNCHES),
           "collectives": dict(COLLECTIVES),
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


def engine_requests(cfg):
    """The serving phase's 16 requests (12 greedy, 4 sampled)."""
    from torchdistpackage_tpu_torch.serving import Request

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
    return reqs, lens


def paged_bodies():
    """K1 / K2's per-body launch counts so far (``csrc/launch_counts.cuh``
    through ``_build.body_launches``; cumulative: subtract two reads)."""
    from torchdistpackage_tpu_torch.ops import _build

    return {b: _build.body_launches("paged_attention", b)
            for b in FLEET_BODIES}


def engine_phase(params, cfg, card, tag="engine", **kw):
    """The Mistral engine (8 slots, chunk 512) on :func:`engine_requests`:
    K1 exactly once a layer a device call, every request finished as
    asked, the pool conserved; tok/s, TTFT, TPOT.  ``kw`` goes to the
    engine (``tp_group``).  Returns the counts (K1's and its bodies'),
    the summary and every request's tokens."""
    from torchdistpackage_tpu_torch.ops.paged_attention import LAUNCHES
    from torchdistpackage_tpu_torch.serving import ServingEngine

    reqs, lens = engine_requests(cfg)
    eng = ServingEngine(params, cfg, num_slots=8, block_size=BS, chunk=512,
                        max_ctx=8192, **kw)
    if eng.attn_impl != "cuda":
        raise RuntimeError(f"engine resolved attn_impl={eng.attn_impl!r}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bodies0 = paged_bodies()  # before the submits: it may build K1's library
    rids = [eng.submit(r) for r in reqs]
    reset_counts()
    t0 = time.perf_counter()
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = LAUNCHES["paged_decode_attention"]
    bodies = {b: n - bodies0[b] for b, n in paged_bodies().items()}
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
    log(f"[{tag}] {len(reqs)} requests, prompts {sorted(lens.tolist())}, "
        f"{s['generated_tokens']} tokens in {wall:.2f} s: "
        f"{s['tokens_per_sec']:.2f} tok/s, TTFT p50 {ttft['p50']:.3f} s "
        f"p99 {ttft['p99']:.3f} s, TPOT p50 {tpot['p50'] * 1e3:.2f} ms "
        f"p99 {tpot['p99'] * 1e3:.2f} ms, peak memory {peak_gb:.2f} GB, "
        f"{s['prefill_chunks']} prefill calls + {s['decode_steps']} decode "
        f"calls, {launches} kernel launches — on {card}")
    return {"launches": launches, "bodies": bodies, "summary": s,
            "wall_s": wall, "peak_gb": peak_gb,
            "tokens": [eng.finished[r]["tokens"] for r in rids]}


OBS_METRICS_EVERY = 1   # obs_phase: a serving_metrics record every tick
OBS_STALL_S = 2.5       # (iii): the slot_stall under the aborting watchdog


def obs_lifecycle_problems(events, eng, rids, reqs):
    """Each request rebuilt from the timeline alone
    (``assemble_request_timelines``): one valid record a request, the
    sequence queued -> admitted -> prefill -> decode -> retired, the
    request finished as asked, and as many prefill-chunk children as it
    had prefill chunks and decode-tick children as decode calls before
    the last: its first token comes from its last prefill chunk, and the
    tick whose decode retires it is emitted after its ``request_retired``
    (which closed the record).  Returns the problems found."""
    from torchdistpackage_tpu_torch.serving import (
        assemble_request_timelines,
        validate_request_record,
    )

    recs = {r["rid"]: r for r in assemble_request_timelines(events)}
    probs = []
    if sorted(recs) != sorted(rids):
        probs.append(f"records for rids {sorted(recs)}, want {sorted(rids)}")
    for rid, req in zip(rids, reqs):
        rec = recs.get(rid)
        if rec is None:
            continue
        probs += validate_request_record(rec)
        want = ["queued", "admitted", "prefill", "decode", "retired"]
        if rec["sequence"] != want:
            probs.append(f"rid {rid}: sequence {rec['sequence']}")
        if eng.finished[rid]["reason"] != "max_tokens":
            probs.append(f"rid {rid}: finished {eng.finished[rid]['reason']}")
        n = {k: sum(c["name"] == k for c in rec["ticks"])
             for k in ("prefill_chunk", "decode_tick")}
        chunks = -(-len(req.tokens) // eng.chunk)
        decodes = max(req.max_new_tokens - 2, 0)
        if n != {"prefill_chunk": chunks, "decode_tick": decodes}:
            probs.append(f"rid {rid}: children {n}, want {chunks} prefill "
                         f"chunks and {decodes} decode ticks")
    return probs


def prometheus_samples(path):
    """The textfile's samples ``{name: value}``; raises on a line that is
    not ``# TYPE name gauge`` or ``name{labels} value``."""
    out = {}
    for line in Path(path).read_text().splitlines():
        if line.startswith("# TYPE "):
            continue
        m = re.fullmatch(r'([a-zA-Z_][a-zA-Z0-9_]*)\{run="[^"]*",'
                         r'process="\d+"\} (\S+)', line)
        if m is None:
            raise RuntimeError(f"obs: textfile line {line!r} does not parse")
        out[m.group(1)] = float(m.group(2))
    return out


def obs_stall(params, cfg, card):
    """(iii) the four shortest greedy requests of :func:`engine_requests`
    (16 new tokens each) on a fresh engine whose tick 3 sleeps
    ``OBS_STALL_S`` (``ChaosMonkey`` ``slot_stall``) under
    ``Watchdog(timeout_s=1.0, abort=True)`` with its exit hook replaced:
    ``hang_suspected``, then ``hang_abort`` and the hook's call must be on
    the timeline, and the requests must still finish."""
    from torchdistpackage_tpu_torch.obs import (
        Telemetry,
        set_default_event_log,
    )
    from torchdistpackage_tpu_torch.resilience import (
        ChaosMonkey,
        Fault,
        Watchdog,
    )
    from torchdistpackage_tpu_torch.serving import ServingEngine

    reqs, _ = fleet_requests(cfg, n_new=16, greedy_only=True)
    reqs = sorted(reqs, key=lambda r: len(r.tokens))[:4]
    calls = []
    tel = Telemetry(run="obs-stall", report_path="", trace_path="")
    try:
        with Watchdog(timeout_s=1.0, abort=True,
                      _exit=lambda code: calls.append(
                          (time.perf_counter(), code))) as dog:
            eng = ServingEngine(
                params, cfg, num_slots=8, block_size=BS, chunk=512,
                max_ctx=8192, telemetry=tel, watchdog=dog,
                chaos=ChaosMonkey([Fault("slot_stall", step=3,
                                         duration_s=OBS_STALL_S)]))
            rids = [eng.submit(r) for r in reqs]
            eng.run_until_idle()
    finally:
        set_default_event_log(None)
    ev = tel.events.as_list()
    fired = next(e["t_mono"] for e in ev if e["kind"] == "fault_injected")
    # the stall's episode: the watchdog last heard of tick 2
    sus = [e for e in ev if e["kind"] == "hang_suspected"
           and e["last_step"] == 2 and e["t_mono"] > fired]
    ab = [e for e in ev if e["kind"] == "hang_abort"]
    done = [eng.finished.get(r, {}).get("reason") for r in rids]
    if not (len(sus) == 1 and len(ab) == 1 and len(calls) == 1
            and sus[0]["t_mono"] < ab[0]["t_mono"] <= calls[0][0]
            and ab[0]["last_step"] == 2 and calls[0][1] == 87
            and done == ["max_tokens"] * len(reqs)):
        raise RuntimeError(
            f"obs (iii): hang_suspected {sus}, hang_abort {ab}, exit hook "
            f"calls {calls}, finished {done}")
    other = sum(e["kind"] == "hang_suspected" for e in ev) - 1
    log(f"[obs] (iii) slot_stall {OBS_STALL_S} s at tick 3 under "
        f"Watchdog(timeout_s=1.0, abort=True): hang_suspected at age "
        f"{sus[0]['age_s']} s (last tick 2), hang_abort at "
        f"{ab[0]['age_s']} s, then the exit hook (code {calls[0][1]}, "
        f"{(calls[0][0] - ab[0]['t_mono']) * 1e3:.3f} ms after the event); "
        f"{other} other hang episodes; the {len(reqs)} requests finished "
        f"— on {card}")
    return {"hang_suspected_age_s": sus[0]["age_s"],
            "hang_abort_age_s": ab[0]["age_s"]}


def obs_phase(params, cfg, card, plain):
    """The observability layer on the Mistral-7B-v0.1 engine: the same
    :func:`engine_requests` as :func:`engine_phase` (8 slots, blocks of
    16, chunk 512) through ``ServingEngine(telemetry=Telemetry(...),
    watchdog=Watchdog(timeout_s=60), metrics_sink=MultiSink([JsonlSink,
    PrometheusTextfileSink]))``, writing its RUNREPORT (``.json`` +
    ``.md``), its Perfetto trace and the sinks' files into a temporary
    directory (printed).  Gates: every token and K1's launches (and each
    K1 body's) equal ``plain``'s, one decode signature and no
    ``recompile``; every tick's phases make its ``tick_s`` (1e-6 s), none
    negative, summed ``tick_s`` 0.90-1.00 of the run's wall time, and
    ``decode`` and ``fetch`` above 0 on every decode tick; every request
    rebuilt from the timeline (:func:`obs_lifecycle_problems`); the
    report and the trace valid, the card's memory reported and the
    pool's accounting matched; the sinks' records.  Planted faults that
    must fail those checks: (i) a rid dropped from one ``engine_tick``'s
    ``decode_rids``, (ii) ``kv_pool.pool_bytes`` off by one block, (iii)
    :func:`obs_stall`.  Prints tok/s, TTFT and TPOT beside the plain
    engine's (no gate: host-clock figures spread 20-40 %), and the
    phases' means and the share of a tick that is not ``fetch`` over all
    ticks, the ticks with a prefill call and the decode-only ticks."""
    import copy
    import tempfile

    from torchdistpackage_tpu_torch.obs import (
        EventLog,
        JsonlSink,
        MultiSink,
        PrometheusTextfileSink,
        Telemetry,
        set_default_event_log,
        validate_runreport,
        validate_trace,
    )
    from torchdistpackage_tpu_torch.ops.paged_attention import LAUNCHES
    from torchdistpackage_tpu_torch.resilience import Watchdog
    from torchdistpackage_tpu_torch.serving import (
        SERVING_METRICS_SCHEMA,
        TICK_PHASES,
        ServingEngine,
        phase_table,
    )

    t_phase = time.perf_counter()
    out = Path(tempfile.mkdtemp(prefix="obs-engine-"))
    paths = {k: str(out / n) for k, n in (
        ("report", "RUNREPORT.json"), ("trace", "trace.json"),
        ("jsonl", "serving_metrics.jsonl"), ("prom", "serving.prom"))}
    reqs, _ = engine_requests(cfg)
    tel = Telemetry(run="obs-engine", report_path=paths["report"],
                    trace_path=paths["trace"])
    sink = MultiSink([JsonlSink(paths["jsonl"]),
                      PrometheusTextfileSink(paths["prom"],
                                             run="obs-engine")])
    try:
        with Watchdog(timeout_s=60) as dog:
            eng = ServingEngine(params, cfg, num_slots=8, block_size=BS,
                                chunk=512, max_ctx=8192, telemetry=tel,
                                watchdog=dog, metrics_sink=sink,
                                metrics_every=OBS_METRICS_EVERY)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            bodies0 = paged_bodies()
            rids = [eng.submit(r) for r in reqs]
            reset_counts()
            t0 = time.perf_counter()
            eng.run_until_idle()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = LAUNCHES["paged_decode_attention"]
            bodies = {b: n - bodies0[b] for b, n in paged_bodies().items()}
        s = eng.serving_summary()
        tel.record_serving(s)
        report = tel.finalize(print_summary=False)
    finally:
        set_default_event_log(None)
    sink.close()

    # telemetry changes nothing
    tokens = [eng.finished[r]["tokens"] for r in rids]
    diff = [i for i, (a, b) in enumerate(zip(tokens, plain["tokens"]))
            if not np.array_equal(a, b)]
    if diff:
        raise RuntimeError(f"obs: requests {diff} emitted other tokens than "
                           f"the plain engine's")
    calls = s["prefill_chunks"] + s["decode_steps"]
    if not (launches == plain["launches"] == cfg.nlayers * calls
            and bodies == plain["bodies"]):
        raise RuntimeError(
            f"obs: K1 {launches} (bodies {bodies}) against the plain "
            f"engine's {plain['launches']} ({plain['bodies']}), "
            f"{cfg.nlayers} x {calls} calls")
    ev = tel.events.as_list()
    kinds = [e["kind"] for e in ev]
    if s["decode_signatures"] != 1 or kinds.count("compile") != 1 \
            or "recompile" in kinds:
        raise RuntimeError(f"obs: {s['decode_signatures']} decode "
                           f"signatures, {kinds.count('compile')} compile "
                           f"and {kinds.count('recompile')} recompile events")

    # every tick accounted for
    ticks = list(eng.tick_records)
    if len(ticks) != eng._tick:
        raise RuntimeError(f"obs: {len(ticks)} tick records of {eng._tick}")
    worst = max(abs(sum(r["phases"].values()) - r["tick_s"]) for r in ticks)
    low = min(min(r["phases"].values()) for r in ticks)
    summed = sum(r["tick_s"] for r in ticks)
    dec = [r for r in ticks if r["decode_slots"]]
    bad = [r["tick"] for r in dec
           if not (r["phases"]["decode"] > 0 and r["phases"]["fetch"] > 0)]
    if worst > 1e-6 or low < 0 or not 0.90 <= summed / wall <= 1.00 \
            or bad or not dec:
        raise RuntimeError(
            f"obs: tick accounting off: phases vs tick_s {worst:.3g} s, "
            f"smallest phase {low:.3g}, summed tick_s {summed:.4f} of "
            f"{wall:.4f} s, decode ticks without decode / fetch {bad}")
    # ticks with a prefill call (its read-back waits for the chunk's
    # device work) apart from decode-only ticks: the latter's non-fetch
    # share is the host's
    kinds_of = {"all": ticks,
                "prefill": [r for r in ticks if r["prefill_slots"]],
                "decode_only": [r for r in dec if not r["prefill_slots"]]}
    mean = {k: {p: float(np.mean([r["phases"][p] for r in rs]))
                for p in TICK_PHASES} for k, rs in kinds_of.items() if rs}
    non_fetch = {k: 1.0 - sum(r["phases"]["fetch"] for r in rs) / sum(
        r["tick_s"] for r in rs) for k, rs in kinds_of.items() if rs}

    # every request rebuilt from the timeline
    probs = obs_lifecycle_problems(ev, eng, rids, reqs)
    if probs:
        raise RuntimeError(f"obs: lifecycles: {probs[:4]}")

    # the artefacts
    on_disk = json.loads(Path(paths["report"]).read_text())
    errs = validate_runreport(on_disk)
    mem = on_disk["memory"]
    cap = torch.cuda.get_device_properties(0).total_memory
    if errs or not (mem["reported"] and mem["capacity_bytes"] == cap
                    and mem["measured_peak_bytes"] > 0
                    and mem["kv_pool"]["accounting_match"] is True):
        raise RuntimeError(f"obs: RUNREPORT {errs[:3]}, memory "
                           f"{ {k: mem.get(k) for k in ('reported', 'capacity_bytes', 'measured_peak_bytes', 'kv_pool')} }")
    trace = json.loads(Path(paths["trace"]).read_text())
    terrs = validate_trace(trace)
    if terrs:
        raise RuntimeError(f"obs: trace {terrs[:3]}")
    lines = [json.loads(ln) for ln in
             Path(paths["jsonl"]).read_text().splitlines()]
    want = len(ticks) // OBS_METRICS_EVERY
    if len(lines) != want or any(
            r["schema"] != SERVING_METRICS_SCHEMA
            or r["type"] != "serving_metrics" for r in lines) or \
            [r["tick"] for r in lines] != list(
                range(OBS_METRICS_EVERY, len(ticks) + 1, OBS_METRICS_EVERY)):
        raise RuntimeError(f"obs: {len(lines)} serving_metrics records, "
                           f"want {want}")
    prom = prometheus_samples(paths["prom"])
    if prom.get("tdp_tick") != lines[-1]["tick"] or \
            "tdp_phase_fetch_s" not in prom:
        raise RuntimeError(f"obs: textfile {sorted(prom)[:8]}")

    # planted faults
    planted = copy.deepcopy(ev)
    victim = next(e for e in planted if e["kind"] == "engine_tick"
                  and len(e["decode_rids"]) > 1)
    victim["decode_rids"] = victim["decode_rids"][1:]
    if not obs_lifecycle_problems(planted, eng, rids, reqs):
        raise RuntimeError("obs (i): a rid dropped from an engine_tick's "
                           "decode_rids passed the lifecycle check")
    block = s["kv_pool"]["pool_bytes"] // (s["kv_pool"]["num_blocks"])
    bad_s = copy.deepcopy(s)
    bad_s["kv_pool"]["pool_bytes"] -= block
    shadow = Telemetry(run="obs-planted", event_log=EventLog(),
                       report_path="", trace_path="")
    shadow.record_serving(bad_s)
    perrs = validate_runreport(shadow.finalize(write=False,
                                               print_summary=False))
    if not any("accounting mismatch" in e for e in perrs):
        raise RuntimeError(f"obs (ii): pool_bytes off by one block passed "
                           f"validate_runreport: {perrs}")
    stall = obs_stall(params, cfg, card)

    p, ttft, tpot = plain["summary"], s["ttft_s"], s["tpot_s"]
    log(f"[obs] telemetry + watchdog + metrics sink on the engine: "
        f"{len(reqs)} requests, every token and K1's {launches} launches "
        f"(bodies {bodies}) equal to the plain engine's, 1 decode "
        f"signature, 0 recompiles; {len(ticks)} ticks ({len(dec)} decoding), "
        f"phases within {worst:.2e} s of tick_s, summed tick_s {summed:.4f} "
        f"s = {summed / wall:.4f} of run_until_idle's {wall:.4f} s; "
        f"{len(lines)} serving_metrics records; {len(rids)} lifecycles "
        f"rebuilt; RUNREPORT and trace valid, peak "
        f"{mem['measured_peak_bytes'] / 1e9:.3f} GB of {cap / 1e9:.3f} GB, "
        f"kv_pool matched — on {card}")
    log(f"[obs] tok/s {s['tokens_per_sec']:.2f} (plain "
        f"{p['tokens_per_sec']:.2f}), TTFT p50 {ttft['p50']:.3f} / p99 "
        f"{ttft['p99']:.3f} s (plain {p['ttft_s']['p50']:.3f} / "
        f"{p['ttft_s']['p99']:.3f}), TPOT p50 {tpot['p50'] * 1e3:.2f} / p99 "
        f"{tpot['p99'] * 1e3:.2f} ms (plain {p['tpot_s']['p50'] * 1e3:.2f} / "
        f"{p['tpot_s']['p99'] * 1e3:.2f}); the run {wall:.3f} s (plain "
        f"{plain['wall_s']:.3f}) — on {card}")
    for k, rs in kinds_of.items():
        if rs:
            log(f"[obs] phase means, ms, over {len(rs)} {k} ticks (tick "
                f"{np.mean([r['tick_s'] for r in rs]) * 1e3:.3f}): "
                + ", ".join(f"{p} {mean[k][p] * 1e3:.4f}"
                            for p in TICK_PHASES)
                + f"; not fetch {non_fetch[k]:.4f} of the tick — on {card}")
    log(phase_table(ev))
    log(f"[obs] planted: (i) a rid dropped from tick {victim['tick']}'s "
        f"decode_rids fails the lifecycle check; (ii) pool_bytes off by one "
        f"block ({block} B) fails validate_runreport; (iii) the stall "
        f"escalated. Files: {out} (RUNREPORT.json / .md, trace.json, "
        f"serving_metrics.jsonl, serving.prom)")
    log(f"[obs] the phase {time.perf_counter() - t_phase:.1f} s — on {card}")
    return {"launches": launches, "bodies": bodies, "wall_s": wall,
            "ticks": len(ticks), "decode_ticks": len(dec),
            "phases_mean_s": mean, "non_fetch_share": non_fetch,
            "summary": s, "stall": stall,
            "seconds": time.perf_counter() - t_phase, "dir": str(out)}


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
    decode body; 20, ``paged_tc_kernel``), by the library's launch
    counts (``_build.body_launches``)."""
    from torchdistpackage_tpu_torch.ops import _build
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
        bodies = ("paged_split_kernel", "paged_tc_kernel")
        before = [_build.body_launches("paged_attention", b) for b in bodies]
        fn()
        torch.cuda.synchronize()
        got = {b: _build.body_launches("paged_attention", b) - n
               for b, n in zip(bodies, before)}
        # the wrapper's own route: a split count > 0 is the split body
        nsplit = pa._workspace(8, HKV, GROUPS * (k + 1), HD,
                               case["tables"].shape[1], "cuda")[0]
        want = "paged_split_kernel" if nsplit else "paged_tc_kernel"
        log(f"[spec-engine] a verify call at K {k} (R = {GROUPS * (k + 1)} "
            f"rows a KV head): the wrapper routes it to {want} (NSPLIT "
            f"{nsplit}); the library launched {got}")
        if (want == "paged_split_kernel") != (k == 3) or got != {
                b: int(b == want) for b in bodies}:
            raise RuntimeError(f"verify K {k}: routed to {want}, the "
                               f"library launched {got}")
        out[k]["k1_body"] = want
    return out


FEAT_NEW = 32          # tokens a request in engine_features_phase
SYS_LEN = 2048         # a shared system prompt


def feat_engine(params, cfg, **kw):
    """The phase's engine: Mistral-7B-v0.1 widths as given, 8 slots,
    chunk 512, block 16, max_ctx 8192, K1's CUDA path."""
    from torchdistpackage_tpu_torch.obs.events import EventLog
    from torchdistpackage_tpu_torch.serving import ServingEngine

    eng = ServingEngine(params, cfg, num_slots=8, block_size=BS, chunk=512,
                        max_ctx=8192, **kw)
    if eng.attn_impl != "cuda":
        raise RuntimeError(f"engine resolved attn_impl={eng.attn_impl!r}")
    eng._ev = EventLog()  # the phase reads its own engine's timeline
    return eng


def feat_run(eng, cfg, what, drive):
    """``drive(eng)`` from counts of 0; the K1 launches must be exactly
    nlayers x the device calls it made (a COW or a block migration adds
    a copy, not a forward), and every other kernel 0.  Returns the K1
    launches and the wall seconds."""
    torch.cuda.synchronize()
    reset_counts()
    s0 = dict(eng.stats)
    t0 = time.perf_counter()
    drive(eng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    calls = (eng.stats["prefill_chunks"] - s0["prefill_chunks"]
             + eng.stats["decode_steps"] - s0["decode_steps"])
    expect_launches(what, {"paged_decode_attention": cfg.nlayers * calls})
    return cfg.nlayers * calls, wall


def feat_leak_check(eng, what):
    rep = eng.audit(heal=False)
    if not rep["ok"] or eng._alloc.in_use:
        raise RuntimeError(f"{what}: blocks leaked ({eng._alloc.in_use} in "
                           f"use, audit {rep['violations'][:3]})")


def feat_tf(params, cfg, tokens, P, what, gate=True):
    """Teacher-forced check of one finished sequence (K3 over the whole
    sequence, ``TF_TOL`` of the row's scale); returns the exact share."""
    tf_cfg = dataclasses.replace(cfg, attn_impl="flash")
    seq = torch.from_numpy(np.asarray(tokens)[None]).cuda().long()
    logits = teacher_logits_of(params, tf_cfg, seq)
    gaps = tf_gaps(logits, seq, P)
    if gate and float((gaps <= TF_TOL).float().mean()) < 1.0:
        raise RuntimeError(f"{what}: an emitted token is off its "
                           f"teacher-forced argmax by more than {TF_TOL} "
                           f"(max gap {float(gaps.max()):.4f})")
    if not ((0 <= seq).all() and (seq < cfg.vocab_size).all()):
        raise RuntimeError(f"{what}: a token out of the vocabulary")
    return float((gaps == 0).float().mean())


def same_share(a, b):
    """The share of generated positions where two runs emitted the same
    token (over requests, each compared on its shorter output)."""
    eq = tot = 0
    for x, y in zip(a, b):
        n = min(len(x), len(y))
        eq += int((np.asarray(x[:n]) == np.asarray(y[:n])).sum())
        tot += n
    return eq / max(tot, 1)


def prefix_requests(vocab):
    """4 system prompts of 2048 tokens, each with 4 distinct tails of
    128-512 tokens (every fourth request sampled), and one whole-prompt
    request: exactly the first system prompt."""
    from torchdistpackage_tpu_torch.serving import Request

    rs = np.random.RandomState(15)
    sysp = [rs.randint(0, vocab, SYS_LEN).tolist() for _ in range(4)]
    reqs = []
    for j in range(4):
        for i in range(4):
            toks = sysp[i] + rs.randint(0, vocab,
                                        int(rs.randint(128, 513))).tolist()
            if j == 3:
                reqs.append(Request(toks, FEAT_NEW, temperature=0.8,
                                    top_k=50, top_p=0.95, seed=i))
            else:
                reqs.append(Request(toks, FEAT_NEW))
    reqs.append(Request(list(sysp[0]), FEAT_NEW))
    return reqs


def feat_prefix(params, cfg, card):
    """(a) The same 17 requests with the prefix cache off, then on: each
    system prompt's first request, then the rest once those prefilled."""
    out, toks = {}, {}
    for on in (False, True):
        eng = feat_engine(params, cfg, prefix_cache=on)
        reqs = prefix_requests(cfg.vocab_size)

        def drive(eng):
            first = [eng.submit(r) for r in reqs[:4]]
            while any(s.state == "prefill" for s in eng._slots) or eng.queue:
                eng.step()
            rest = [eng.submit(r) for r in reqs[4:]]
            eng.run_until_idle()
            drive.rids = first + rest

        launches, wall = feat_run(eng, cfg, f"prefix cache {on}", drive)
        rids = drive.rids
        s = eng.serving_summary()
        slot_chunks = sum(e["n_slots"] for e in eng._ev.as_list()
                          if e["kind"] == "prefill_chunk")
        if s["requests"]["completed"] != len(reqs):
            raise RuntimeError(f"prefix cache {on}: {s['requests']}")
        toks[on] = [eng.finished[r]["tokens"][len(q.tokens):]
                    for r, q in zip(rids, reqs)]
        exact = [feat_tf(params, cfg, eng.finished[r]["tokens"],
                         len(q.tokens), f"prefix cache {on}, request {r}")
                 for r, q in zip(rids, reqs) if q.temperature == 0.0]
        pc = s["prefix_cache"]
        out[on] = {"launches": launches, "wall_s": wall,
                   "prefill_calls": s["prefill_chunks"],
                   "slot_chunks": slot_chunks,
                   "ttft_p50": s["ttft_s"]["p50"],
                   "ttft_p99": s["ttft_s"]["p99"],
                   "tok_s": s["tokens_per_sec"], "prefix": pc,
                   "tf_exact": float(np.mean(exact))}
        log(f"[engine-features] prefix cache {'on' if on else 'off'}: "
            f"{len(reqs)} requests, {s['generated_tokens']} tokens in "
            f"{wall:.2f} s: {s['tokens_per_sec']:.2f} tok/s, TTFT p50 "
            f"{s['ttft_s']['p50']:.3f} s p99 {s['ttft_s']['p99']:.3f} s; "
            f"{s['prefill_chunks']} prefill calls ({slot_chunks} slot "
            f"chunks) + {s['decode_steps']} decode calls, K1 launches "
            f"{launches}; hits {pc['hits']}, cached tokens "
            f"{pc['cached_tokens']}, COW copies {pc['cow_copies']}; greedy "
            f"tokens the teacher-forced argmax: {out[on]['tf_exact']:.3f} "
            f"— on {card}")
        feat_leak_check(eng, f"prefix cache {on}")
        if on:
            # what the schedule implies: the 12 followers hit their 2048-
            # token system prompt (128 blocks), the whole-prompt request
            # hits all 128 and recomputes its last token through a COW
            want = {"hits": 13, "cached_tokens": 12 * SYS_LEN + SYS_LEN - 1,
                    "cow_copies": 1, "evictions": 0}
            got = {k: pc[k] for k in want}
            if got != want:
                raise RuntimeError(f"prefix cache: {got} != {want}")
            saved = sum(-(-len(q.tokens) // 512) for q in reqs[4:]) - sum(
                -(-(len(q.tokens) - SYS_LEN) // 512) for q in reqs[4:-1]) - 1
            if out[False]["slot_chunks"] - slot_chunks != saved:
                raise RuntimeError(
                    f"prefix cache: slot chunks {out[False]['slot_chunks']} "
                    f"-> {slot_chunks}, not {saved} fewer")
        del eng
        torch.cuda.empty_cache()
    share = same_share(toks[True], toks[False])
    log(f"[engine-features] prefix cache on vs off: TTFT p50 "
        f"{out[True]['ttft_p50']:.3f} / {out[False]['ttft_p50']:.3f} s, p99 "
        f"{out[True]['ttft_p99']:.3f} / {out[False]['ttft_p99']:.3f} s, "
        f"{out[True]['tok_s']:.2f} / {out[False]['tok_s']:.2f} tok/s, "
        f"prefill calls {out[True]['prefill_calls']} / "
        f"{out[False]['prefill_calls']}; tokens exactly equal between the "
        f"runs: {share:.3f} — on {card}")
    out["same_share"] = share
    return out


def feat_preempt(params, cfg, card):
    """(b) A priority-1 request arriving into 8 busy priority-0 slots on a
    pool sized for them preempts one; the replayed request is held by
    teacher forcing and against its uninterrupted tokens."""
    from torchdistpackage_tpu_torch.serving import Request

    rs = np.random.RandomState(16)
    lows = [Request(rs.randint(0, cfg.vocab_size, 1024).tolist(), FEAT_NEW)
            for _ in range(8)]
    high = Request(rs.randint(0, cfg.vocab_size, 1024).tolist(), FEAT_NEW,
                   priority=1)
    need = -(-(1024 + FEAT_NEW) // BS)
    base = feat_engine(params, cfg, num_blocks=1 + 8 * need)
    rids = [base.submit(r) for r in lows]
    feat_run(base, cfg, "preemption baseline", lambda e: e.run_until_idle())
    want = {i: base.finished[r]["tokens"] for i, r in enumerate(rids)}
    del base
    eng = feat_engine(params, cfg, num_blocks=1 + 8 * need)

    def drive(eng):
        drive.rids = [eng.submit(r) for r in lows]
        for _ in range(4):
            eng.step()
        drive.hi = eng.submit(high)
        eng.run_until_idle()

    launches, _ = feat_run(eng, cfg, "preemption", drive)
    st = eng.serving_summary()
    if st["requests"]["preempted"] < 1:
        raise RuntimeError(f"preemption: nothing preempted {st['requests']}")
    victims = {e["rid"] for e in eng._ev.as_list()
               if e["kind"] == "request_preempted"}
    exact = []
    for i, r in enumerate(drive.rids):
        f = eng.finished[r]
        if r in victims:
            feat_tf(params, cfg, f["tokens"], 1024,
                    f"preempted request {r}")
            exact.append(float(np.array_equal(f["tokens"], want[i])))
    feat_tf(params, cfg, eng.finished[drive.hi]["tokens"], 1024,
            "the priority-1 request")
    feat_leak_check(eng, "preemption")
    share = float(np.mean(exact)) if exact else float("nan")
    log(f"[engine-features] preemption: {st['requests']['preempted']} "
        f"preempted ({sorted(victims)}), replayed greedy requests exactly "
        f"equal to their uninterrupted tokens: {share:.3f}; K1 launches "
        f"{launches}; verdict {st['verdict']} — on {card}")
    del eng
    torch.cuda.empty_cache()
    return {"launches": launches, "preempted": st["requests"]["preempted"],
            "exact_share": share}


def feat_requests(vocab, n=8, sampled=(3, 7), seed=17):
    from torchdistpackage_tpu_torch.serving import Request

    rs = np.random.RandomState(seed)
    return [Request(rs.randint(0, vocab, int(rs.randint(300, 1500)))
                    .tolist(), FEAT_NEW,
                    **({"temperature": 0.8, "top_k": 50, "seed": i}
                       if i in sampled else {})) for i in range(n)]


def feat_drain(params, cfg, card):
    """(c) Drain mid-run to a file; a copy with one byte flipped is
    refused; a fresh engine on the same params resumes."""
    import shutil
    import tempfile

    from torchdistpackage_tpu_torch.resilience import CheckpointCorruptError

    reqs = feat_requests(cfg.vocab_size)
    base = feat_engine(params, cfg)
    rids = [base.submit(r) for r in reqs]
    feat_run(base, cfg, "drain baseline", lambda e: e.run_until_idle())
    want = [base.finished[r]["tokens"] for r in rids]
    del base
    torch.cuda.empty_cache()
    eng = feat_engine(params, cfg)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "drain.json")

        def drive(eng):
            for r in reqs:
                eng.submit(r)
            while not any(len(s.generated) >= 8 for s in eng._slots):
                if not (eng.queue or eng.n_busy):
                    raise RuntimeError("drain: the run ended before it")
                eng.step()
            drive.payload = eng.drain(persist_path=path)

        l1, _ = feat_run(eng, cfg, "drain", drive)
        states = sorted({len(d["emitted"]) > 0
                         for d in drive.payload["requests"]})
        bad = str(Path(tmp) / "bad.json")
        shutil.copy(path, bad)
        shutil.copy(path + ".manifest.json", bad + ".manifest.json")
        raw = bytearray(Path(bad).read_bytes())
        raw[len(raw) // 2] ^= 0x01
        Path(bad).write_bytes(bytes(raw))
        del eng
        torch.cuda.empty_cache()
        eng2 = feat_engine(params, cfg)
        try:
            eng2.resume(bad)
        except CheckpointCorruptError as e:
            refused = str(e)
        else:
            raise RuntimeError("a drain file with a flipped byte resumed")
        holder = {}

        def drive2(eng):
            holder["rids"] = eng.resume(path)
            eng.run_until_idle()

        l2, _ = feat_run(eng2, cfg, "resume", drive2)
    got = [eng2.finished[r]["tokens"] for r in holder["rids"]]
    for i, (g, req) in enumerate(zip(got, reqs)):
        if req.temperature == 0.0:
            feat_tf(params, cfg, g, len(req.tokens), f"resumed request {i}")
    greedy = [float(np.array_equal(g, w)) for g, w, q in zip(got, want, reqs)
              if q.temperature == 0.0]
    sampled = [float(np.array_equal(g, w)) for g, w, q in zip(got, want, reqs)
               if q.temperature > 0.0]
    feat_leak_check(eng2, "resume")
    log(f"[engine-features] drain/resume: {len(drive.payload['requests'])} "
        f"descriptors (with emitted tokens: {states}); the flipped byte "
        f"refused ({refused[:60]}); resumed requests exactly equal to the "
        f"uninterrupted run: greedy {np.mean(greedy):.3f}, sampled "
        f"{np.mean(sampled):.3f}; K1 launches {l1} + {l2} — on {card}")
    del eng2
    torch.cuda.empty_cache()
    return {"launches": l1 + l2, "greedy_exact": float(np.mean(greedy)),
            "sampled_exact": float(np.mean(sampled))}


def feat_migrate(params, cfg, card):
    """(d) A prefill engine (``hold_decode``) exports after prefill;
    ``migrate_blocks`` moves the blocks into a decode engine with the
    prefix cache on, which imports and decodes; a second request with
    the same 2048-token prefix imports warm (128 blocks shared, only the
    tail shipped)."""
    from torchdistpackage_tpu_torch.serving import (
        Request,
        migrate_blocks,
        migration_wire_bytes,
    )

    rs = np.random.RandomState(18)
    sysp = rs.randint(0, cfg.vocab_size, SYS_LEN).tolist()
    reqs = [Request(sysp + rs.randint(0, cfg.vocab_size, n).tolist(),
                    FEAT_NEW, **kw)
            for n, kw in ((300, {}), (200, {"temperature": 0.8, "top_k": 50,
                                            "seed": 5}))]
    base = feat_engine(params, cfg)
    rids = [base.submit(r) for r in reqs]
    feat_run(base, cfg, "migration baseline", lambda e: e.run_until_idle())
    want = [base.finished[r]["tokens"] for r in rids]
    del base
    torch.cuda.empty_cache()
    pre = feat_engine(params, cfg)
    pre.hold_decode = True
    dec = feat_engine(params, cfg, prefix_cache=True)
    moved = []

    def drive_pre(eng):
        for r in reqs:
            eng.submit(r)
        while len(eng.decode_slots()) < len(reqs):
            eng.step()

    l_pre, _ = feat_run(pre, cfg, "prefill tier", drive_pre)
    order = [rid for rid, _ in pre.decode_slots()]
    for rid in order:
        desc, snap = pre.export_slot(rid)
        got = dec.import_slot(desc)
        lo, hi = got["n_shared"], got["n_live"]
        nbytes = migration_wire_bytes(cfg, hi - lo, BS)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dec.cache = migrate_blocks(snap, dec.cache, desc["blocks"][lo:hi],
                                   got["blocks"][lo:hi])
        end.record()
        torch.cuda.synchronize()
        moved.append({"rid": got["rid"], "n_shared": lo, "n_live": hi,
                      "wire_bytes": nbytes,
                      "copy_ms": start.elapsed_time(end)})
        del snap
    if moved[1]["n_shared"] != SYS_LEN // BS:
        raise RuntimeError(f"warm import shared {moved[1]['n_shared']} "
                           f"blocks, not {SYS_LEN // BS}")
    l_dec, _ = feat_run(dec, cfg, "decode tier",
                        lambda e: e.run_until_idle())
    got = [dec.finished[m["rid"]]["tokens"] for m in moved]
    feat_tf(params, cfg, got[0], len(reqs[0].tokens), "migrated request")
    exact = [float(np.array_equal(g, w)) for g, w in zip(got, want)]
    feat_leak_check(pre, "prefill tier")
    feat_leak_check(dec, "decode tier")
    for m in moved:
        log(f"[engine-features] migration: request {m['rid']} shared "
            f"{m['n_shared']} of {m['n_live']} live blocks, shipped "
            f"{m['wire_bytes']} B (migration_wire_bytes) in "
            f"{m['copy_ms']:.3f} ms (one migrate_blocks, CUDA events) — on "
            f"{card}")
    log(f"[engine-features] migration: tokens exactly equal to the "
        f"single-engine run: greedy {exact[0]:.0f}, sampled {exact[1]:.0f}; "
        f"K1 launches {l_pre} (prefill tier, 0 decode calls) + {l_dec}")
    del pre, dec
    torch.cuda.empty_cache()
    return {"launches": l_pre + l_dec, "moved": moved, "exact": exact}


def feat_shed(params, cfg, card):
    """(e) A burst of 24 requests at ``max_queue`` 8 with mixed deadlines,
    after one request has measured the tick time."""
    from torchdistpackage_tpu_torch.serving import Request

    eng = feat_engine(params, cfg, max_queue=8)
    rs = np.random.RandomState(19)

    def drive(eng):
        eng.submit(Request(rs.randint(0, cfg.vocab_size, 256).tolist(), 8))
        eng.run_until_idle()
        drive.tick = eng._tick_ewma
        for i in range(24):
            dl = (None, 0.05, 2.0, 30.0)[i % 4]
            eng.submit(Request(rs.randint(0, cfg.vocab_size, 256).tolist(),
                               16, deadline_s=dl, priority=i % 2))
        eng.run_until_idle()

    launches, wall = feat_run(eng, cfg, "shedding", drive)
    s = eng.serving_summary()
    verdicts = {}
    for v in eng.rejected.values():
        verdicts[v["reason"]] = verdicts.get(v["reason"], 0) + 1
    if s["requests"]["shed"] == 0 or sum(verdicts.values()) != (
            s["requests"]["shed"] + s["requests"]["expired"]):
        raise RuntimeError(f"shedding: {s['requests']}, {verdicts}")
    cal = s["slo"]["calibration"]
    feat_leak_check(eng, "shedding")
    log(f"[engine-features] shedding: 24 requests at max_queue 8 (tick "
        f"EWMA {drive.tick * 1e3:.2f} ms when the burst came): shed "
        f"{s['requests']['shed']} ({verdicts}), expired "
        f"{s['requests']['expired']}, completed {s['requests']['completed']}"
        f"; estimate_ttft calibration: n {cal['n']}, bias {cal['bias']}, "
        f"relative error {cal['priorities']}; attainment "
        f"{s['slo']['attainment']}; K1 launches {launches} — on {card}")
    del eng
    torch.cuda.empty_cache()
    return {"launches": launches, "shed": s["requests"]["shed"],
            "verdicts": verdicts, "expired": s["requests"]["expired"],
            "calibration": cal}


def feat_rope(card):
    """(f) ``model_phase``'s teacher-forced check (K1 against the plain
    path) on a 2-layer Mistral-width model under 'yarn' and 'dynamic'
    rope scaling, with 600-token prompts past the original length
    (256)."""
    from torchdistpackage_tpu_torch.models import (
        init_gpt_params,
        mistral_7b_config,
    )

    out = {}
    for kind in ("yarn", "dynamic"):
        sc = {"rope_type": kind, "factor": 4.0,
              "original_max_position_embeddings": 256}
        cfg = dataclasses.replace(mistral_7b_config(), nlayers=2,
                                  rope_scaling=sc)
        params = init_gpt_params(
            cfg, torch.Generator(device="cuda").manual_seed(0))
        res = model_phase(params, cfg)
        out[kind] = res["rel"]
        log(f"[engine-features] rope '{kind}' (factor 4, original length "
            f"256, 600-token prompts): K1 vs the plain path {res['rel']:.3g}"
            f" of the logit scale — on {card}")
        del params
        torch.cuda.empty_cache()
    return out


@torch.no_grad()
def engine_features_phase(params, cfg, card):
    """The engine's scheduling and KV-state features at Mistral-7B-v0.1
    widths (32 layers, bf16, 8 slots, chunk 512, block 16, max_ctx 8192,
    K1's CUDA path): (a) the prefix cache off and on, (b) preemption, (c)
    drain / resume through a verified file, (d) slot migration between a
    prefill and a decode engine, (e) deadline shedding, (f) rope scaling
    'yarn' and 'dynamic'.  Every engine's K1 launches are exactly 32 x
    its device calls; no block leaks; a failed gate raises."""
    out = {"prefix": feat_prefix(params, cfg, card),
           "preempt": feat_preempt(params, cfg, card),
           "drain": feat_drain(params, cfg, card),
           "migrate": feat_migrate(params, cfg, card),
           "shed": feat_shed(params, cfg, card),
           "rope": feat_rope(card)}
    out["launches"] = (out["prefix"][False]["launches"]
                       + out["prefix"][True]["launches"]
                       + sum(out[k]["launches"] for k in
                             ("preempt", "drain", "migrate", "shed")))
    return out


FLEET_NEW = 16  # new tokens a request in fleet_phase (c) and (e)
FLEET_BODIES = ("paged_tc_kernel", "paged_split_kernel",
                "paged_merge_kernel", "paged_walk_kernel")


def fleet_counts(engines):
    """Per replica, the K1 / K2 launches and K1's bodies (the library's
    own counts, ``_build.body_launches``) of its ``step`` calls: each
    engine's ``step`` is wrapped to read the counts before and after.
    Returns the per-replica dicts, filled as the fleet runs."""
    from torchdistpackage_tpu_torch.ops import _build
    from torchdistpackage_tpu_torch.ops import paged_attention as pa

    def now():
        return {"K1": pa.LAUNCHES["paged_decode_attention"],
                "K2": pa.LAUNCHES["paged_carry_attention"],
                **{b: _build.body_launches("paged_attention", b)
                   for b in FLEET_BODIES}}

    per = [dict.fromkeys(now(), 0) for _ in engines]
    for eng, row in zip(engines, per):
        def step(_inner=eng.step, _row=row):
            before = now()
            out = _inner()
            for k, v in now().items():
                _row[k] += v - before[k]
            return out
        eng.step = step
    return per


def fleet_engine(params, cfg, **kw):
    """A fleet replica: Mistral-7B-v0.1 widths as given, blocks of 16,
    chunk 512, K1's CUDA path."""
    from torchdistpackage_tpu_torch.serving import ServingEngine

    kw = {"num_slots": 8, "block_size": BS, "chunk": 512, "max_ctx": 8192,
          **kw}
    eng = ServingEngine(params, cfg, device="cuda", **kw)
    if eng.attn_impl != "cuda":
        raise RuntimeError(f"fleet engine resolved attn_impl="
                           f"{eng.attn_impl!r}")
    return eng


def fleet_drive(router, what, max_ticks=20000):
    """Run the fleet to idle with ``Router.audit()`` green after every
    tick; returns the ticks."""
    ticks = 0
    while router.has_work():
        router.step()
        ticks += 1
        rep = router.audit()
        if not rep["ok"]:
            raise RuntimeError(f"{what}: audit after tick {ticks}: "
                               f"{rep['violations'][:3]}")
        if ticks > max_ticks:
            raise RuntimeError(f"{what}: the fleet did not drain")
    return ticks


def fleet_gap(params, cfg, tokens, P):
    """The largest teacher-forced gap of a finished sequence's emitted
    tokens (``tf_gaps``: of its row's scale), K3 over the sequence."""
    tf_cfg = dataclasses.replace(cfg, attn_impl="flash")
    seq = torch.from_numpy(np.asarray(tokens)[None]).to("cuda").long()
    return float(tf_gaps(teacher_logits_of(params, tf_cfg, seq), seq,
                         P).max())


def fleet_held(params, cfg, reqs, got, want, what, gate=True):
    """Greedy rows: each generated sequence equal to the plain engine's,
    or else every emitted token within ``TF_TOL`` of its teacher-forced
    row maximum.  Returns (the share of greedy tokens equal to the plain
    engine's, the sampled rows' share, the largest gap found)."""
    greedy = [i for i, r in enumerate(reqs) if r.temperature == 0.0]
    sampled = [i for i, r in enumerate(reqs) if r.temperature > 0.0]
    gen = [np.asarray(g)[len(r.tokens):] for g, r in zip(got, reqs)]
    ref = [np.asarray(w)[len(r.tokens):] for w, r in zip(want, reqs)]
    worst = 0.0
    for i in greedy:
        if len(gen[i]) != reqs[i].max_new_tokens:
            raise RuntimeError(f"{what}: request {i} emitted "
                               f"{len(gen[i])} tokens")
        if not np.array_equal(gen[i], ref[i][:len(gen[i])]):
            worst = max(worst, fleet_gap(params, cfg, got[i],
                                         len(reqs[i].tokens)))
    if gate and worst > TF_TOL:
        raise RuntimeError(f"{what}: a greedy token is off its teacher-"
                           f"forced argmax by {worst:.4f} > {TF_TOL}")
    return (same_share([gen[i] for i in greedy], [ref[i] for i in greedy]),
            same_share([gen[i] for i in sampled], [ref[i] for i in sampled])
            if sampled else None, worst)


def fleet_check_launches(what, per, k12, bodies=None):
    """Each replica's counts from :func:`fleet_counts`: ``k12[i]`` its
    (K1, K2) launches, and ``bodies[i]`` (when given) the K1 bodies it
    must launch, every other body none."""
    got = [(row["K1"], row["K2"]) for row in per]
    if got != [tuple(k) for k in k12]:
        raise RuntimeError(f"{what}: (K1, K2) launches by replica {got}, "
                           f"want {k12}")
    for i, row in enumerate(per):
        if bodies is not None and [b for b in FLEET_BODIES if (
                row[b] > 0) != (b in bodies[i])]:
            raise RuntimeError(f"{what}: replica {i} launched {row}, want "
                               f"only {bodies[i]}")


def fleet_requests(cfg, n_new=None, lens=None, greedy_only=False):
    """:func:`engine_requests` (optionally only greedy rows with prompts in
    ``lens``, each ``n_new`` new tokens) with their indices."""
    from torchdistpackage_tpu_torch.serving import Request

    reqs, _ = engine_requests(cfg)
    idx = [i for i, r in enumerate(reqs)
           if (not greedy_only or r.temperature == 0.0)
           and (lens is None or len(r.tokens) in lens)]
    if n_new is not None:
        reqs = [Request(r.tokens, n_new, temperature=r.temperature,
                        top_k=r.top_k, top_p=r.top_p, seed=r.seed)
                for r in reqs]
    return [reqs[i] for i in idx], idx


@torch.no_grad()
def fleet_disaggregated(params, cfg, card, plain):
    """(a) ``Router([pre, dec], roles=['prefill', 'decode'])`` serving
    :func:`engine_requests` (16, 12 greedy): tokens held to the plain
    engine's, K1's bodies per replica, each handoff's two device copies
    timed (the export's snapshot and the deliver's ``migrate_blocks``),
    bytes against ``migration_wire_bytes``, audit every tick; the Router
    takes a ``Telemetry`` on the fleet's timeline, whose FLEETREPORT and
    fleet trace must validate, with one journey spanning both replicas a
    request (:func:`fleet_obs_check`); then :func:`fleet_copy_split` on
    the two idle pools."""
    import tempfile

    from torchdistpackage_tpu_torch.obs import Telemetry
    from torchdistpackage_tpu_torch.obs.events import (
        EventLog,
        set_default_event_log,
    )
    from torchdistpackage_tpu_torch.obs.report import _validate_router
    from torchdistpackage_tpu_torch.serving import (
        LoopbackTransport,
        Router,
        migration_wire_bytes,
    )

    class Timed(LoopbackTransport):
        """The loopback wire with each handoff's deliver (its
        ``migrate_blocks`` onto the decode pool) timed by CUDA events."""

        def __init__(self):
            super().__init__()
            self.copies = []

        def deliver(self, handle, dst_cache, src_ids, dst_ids):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            out = super().deliver(handle, dst_cache, src_ids, dst_ids)
            b.record()
            self.copies.append((len(src_ids), a, b))
            return out

    def timed_export(eng, exports):
        """``eng.export_slot`` with each call (its ``PoolSnapshot``, the
        first of a handoff's two device copies) timed by CUDA events."""
        export = eng.export_slot

        def call(rid):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            desc, snap = export(rid)
            b.record()
            exports.append((len(snap.block_ids) - 1, a, b))
            return desc, snap
        eng.export_slot = call

    reqs, _ = fleet_requests(cfg)
    log_ = EventLog(history_max=1 << 16)
    set_default_event_log(log_)
    obs_dir = Path(tempfile.mkdtemp(prefix="obs-fleet-"))
    tel = Telemetry(run="obs-fleet", event_log=log_,
                    report_path=str(obs_dir / "FLEETREPORT.json"),
                    trace_path=str(obs_dir / "fleet_trace.json"))
    try:
        pre, dec = fleet_engine(params, cfg), fleet_engine(params, cfg)
        tr, exports = Timed(), []
        timed_export(pre, exports)
        router = Router([pre, dec], roles=["prefill", "decode"],
                        transport=tr, telemetry=tel)
        per = fleet_counts([pre, dec])
        rids = [router.submit(r) for r in reqs]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        ticks = fleet_drive(router, "fleet (a)")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        set_default_event_log(None)
    if pre.stats["decode_steps"] or dec.stats["prefill_chunks"]:
        raise RuntimeError("fleet (a): a tier ran the other's phase")
    fleet_check_launches(
        "fleet (a)", per, [(cfg.nlayers * pre.stats["prefill_chunks"], 0),
                           (cfg.nlayers * dec.stats["decode_steps"], 0)],
        (("paged_tc_kernel",), ("paged_split_kernel", "paged_merge_kernel")))
    got = [router.finished[r]["tokens"] for r in rids]
    exact, sampled, worst = fleet_held(params, cfg, reqs, got,
                                       plain["tokens"], "fleet (a)")
    s = router.summary()
    errs = _validate_router(s)
    if errs:
        raise RuntimeError(f"fleet (a): _validate_router: {errs[:3]}")
    tel.record_router(s)
    tel.finalize(print_summary=False)
    obs = fleet_obs_check(log_.as_list(), obs_dir, rids, card)
    mig = s["fleet"]["migrations"]
    per_block = migration_wire_bytes(cfg, 1, BS)
    events = [e for e in log_.as_list() if e["kind"] == "blocks_migrated"]
    summed = sum(migration_wire_bytes(cfg, e["n_blocks"], BS)
                 for e in events)
    if not (mig["blocks"] * per_block == summed == mig["bytes"] > 0
            and mig["handoffs"] == len(events) == len(reqs)):
        raise RuntimeError(f"fleet (a): migrations {mig}, events "
                           f"{len(events)} summing {summed} B")
    torch.cuda.synchronize()
    copies = [(n, a.elapsed_time(b)) for n, a, b in tr.copies]
    snaps = [(n, a.elapsed_time(b)) for n, a, b in exports]
    if pre._alloc.in_use or dec._alloc.in_use:
        raise RuntimeError("fleet (a): blocks leaked")
    if [n for n, _ in snaps] != [n for n, _ in copies]:
        raise RuntimeError(f"fleet (a): exported blocks {snaps} differ "
                           f"from those delivered {copies}")
    ms_block = [ms / n for n, ms in copies if n]
    log(f"[fleet] (a) disaggregated: {len(reqs)} requests (12 greedy) "
        f"through a prefill and a decode replica in {wall:.2f} s, {ticks} "
        f"router ticks, audit green after each; prefill replica "
        f"{pre.stats['prefill_chunks']} prefill calls, 0 decode calls, "
        f"bodies {per[0]}; decode replica {dec.stats['decode_steps']} "
        f"decode calls, 0 prefill calls, bodies {per[1]}; greedy tokens "
        f"equal to the plain engine's: {exact:.3f} (largest teacher-forced "
        f"gap where they differ {worst:.4f}, gate {TF_TOL}); sampled rows, "
        f"their stream state carried: {sampled:.3f} equal — on {card}")
    log(f"[fleet] (a) {mig['handoffs']} handoffs, {mig['blocks']} blocks, "
        f"{mig['bytes']} B = blocks x {per_block} B = migration_wire_bytes "
        f"summed; a handoff's deliver, its migrate_blocks onto the decode "
        f"pool (CUDA events around the call, host enqueue inside; blocks: "
        f"ms): " + ", ".join(f"{n}: {ms:.3f}" for n, ms in copies)
        + f"; {min(ms_block):.4f}-{max(ms_block):.4f} ms a block (ROADMAP "
        f"B2 item 12: 1.88-2.89 ms for 147 blocks, 0.0128-0.0197 a block); "
        f"its export_slot, whose PoolSnapshot copies the same blocks out "
        f"of the prefill pool (blocks: ms): "
        + ", ".join(f"{n}: {ms:.3f}" for n, ms in snaps)
        + f"; export + deliver {min(a + b for (_, a), (_, b) in zip(snaps, copies)):.3f}-"
        f"{max(a + b for (_, a), (_, b) in zip(snaps, copies)):.3f} ms a "
        f"handoff — on {card}")
    split = fleet_copy_split(pre, dec, cfg, card)
    out = {"launches": {"prefill": per[0], "decode": per[1]},
           "wall_s": wall, "exact": exact, "sampled": sampled,
           "worst_gap": worst, "copies": copies, "exports": snaps,
           "split": split, "migrations": mig, "obs": obs}
    del router, pre, dec
    torch.cuda.empty_cache()
    return out


def fleet_obs_check(events, obs_dir, rids, card):
    """Fleet (a)'s observability: the FLEETREPORT that ``finalize`` wrote
    into ``obs_dir`` passes ``validate_runreport`` (its router section
    through ``_validate_router``), ``fleet_trace_events`` over the
    timeline and the written trace pass ``validate_trace``, and each of
    the router's ``rids`` is one stitched journey from replica 0 to
    replica 1, retired."""
    from torchdistpackage_tpu_torch.obs import (
        validate_runreport,
        validate_trace,
    )
    from torchdistpackage_tpu_torch.serving import (
        assemble_fleet_request_timelines,
        fleet_trace_events,
    )

    report = json.loads((obs_dir / "FLEETREPORT.json").read_text())
    errs = validate_runreport(report)
    trace = fleet_trace_events(events)
    terrs = validate_trace(trace) + validate_trace(json.loads(
        (obs_dir / "fleet_trace.json").read_text()))
    journeys = {j["rid"]: j for j in
                assemble_fleet_request_timelines(events)["journeys"]}
    bad = [r for r in rids if r not in journeys
           or [h["replica"] for h in journeys[r]["hops"]] != [0, 1]
           or journeys[r]["outcome"] != "retired"
           or journeys[r]["sequence"][0] != "@replica0"
           or "@replica1" not in journeys[r]["sequence"]]
    if errs or terrs or bad or len(journeys) != len(rids) \
            or "router" not in report:
        raise RuntimeError(f"fleet (a) obs: FLEETREPORT {errs[:3]}, trace "
                           f"{terrs[:3]}, journeys off {bad}, "
                           f"{len(journeys)} journeys of {len(rids)}")
    migrate = sum(e.get("name") == "migrate" and e["ph"] == "s"
                  for e in trace)
    log(f"[fleet] (a) obs: Router(telemetry=) -> FLEETREPORT valid "
        f"(router section included), fleet trace of {len(trace)} events "
        f"valid, {migrate} migrate arrows; {len(rids)} journeys each "
        f"@replica0 -> @replica1, retired; files in {obs_dir} — on {card}")
    return {"journeys": len(journeys), "trace_events": len(trace),
            "migrate_arrows": migrate}


def fleet_copy_split(src, dst, cfg, card, sizes=(16, 64, 288), reps=10):
    """Where a handoff's copy time goes, on (a)'s two pools once they are
    idle (their blocks 1..n, free, are overwritten): the export's
    ``PoolSnapshot`` of the source pool; the lane vectors' host-to-device
    copies alone (``_lane``, as many as ``migrate_blocks`` makes: a
    source and a destination lane for each leaf pair); ``migrate_blocks``
    from the snapshot as the handoff calls it (host lanes); and the same
    copy with its lanes already on the card.  Each is the mean of
    ``reps`` calls, each call after a synchronise and timed alone by CUDA
    events, after one warm-up.  Then one handoff-style ``migrate_blocks``
    under ``torch.profiler``: the device time of its kernels and copies
    by name.  The floor is the migrated bytes read once and written once
    at ``HBM_BYTES_PER_S``."""
    from torch.profiler import ProfilerActivity, profile

    from torchdistpackage_tpu_torch.serving.paged_cache import (
        PoolSnapshot,
        _lane,
        migrate_blocks,
        migration_wire_bytes,
    )

    def timed(fn):
        ms = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        return sum(ms[1:]) / reps

    n_lanes = 2 * sum(len(x) if isinstance(x, tuple) else 1
                      for x in dst.cache.values())
    rows = {}
    for n in sizes:
        ids = np.arange(1, n + 1, dtype=np.int64)
        snap = PoolSnapshot(src.cache, ids)
        plain = dict(snap)
        dev_src = _lane(snap.rows(ids), "cuda")
        dev_dst = _lane(ids, "cuda")
        moved = migration_wire_bytes(cfg, n, BS)
        row = {
            "snapshot_ms": timed(lambda: PoolSnapshot(src.cache, ids)),
            "lanes_ms": timed(lambda: [_lane(ids, "cuda")
                                       for _ in range(n_lanes)]),
            "migrate_ms": timed(lambda: migrate_blocks(snap, dst.cache,
                                                       ids, ids)),
            "migrate_device_lanes_ms": timed(
                lambda: migrate_blocks(plain, dst.cache, dev_src,
                                       dev_dst)),
            "floor_ms": 2 * moved / HBM_BYTES_PER_S * 1e3,
            "bytes": moved,
        }
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            migrate_blocks(snap, dst.cache, ids, ids)
            torch.cuda.synchronize()
        dev = []
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            if us > 0:
                name = ("index_put (scatter)" if "index_put" in e.key else
                        "index (gather)" if "index_kernel" in e.key else
                        e.key[:48])
                dev.append((name, e.count, us / 1e3))
        row["profiled_ms"] = sum(ms for _, _, ms in dev) if dev else None
        row["profiled"] = dev
        rows[n] = row
        log(f"[fleet] (a) copy split at {n} blocks ({moved} B, floor "
            f"{row['floor_ms']:.4f} ms read once and written once): "
            f"PoolSnapshot {row['snapshot_ms']:.4f} ms; {n_lanes} lane "
            f"copies alone {row['lanes_ms']:.4f} ms; migrate_blocks as the "
            f"handoff calls it {row['migrate_ms']:.4f} ms, with its lanes "
            f"already on the card {row['migrate_device_lanes_ms']:.4f} ms "
            f"(means of {reps}, each call timed alone); one handoff-style "
            f"call's device time under torch.profiler: "
            + (f"{row['profiled_ms']:.4f} ms in " + "; ".join(
                f"{k} x{c} {ms:.4f}" for k, c, ms in dev)
               if dev else "not measured (no device time in the trace)")
            + f" — on {card}")
    return rows


@torch.no_grad()
def fleet_affinity(params, cfg, card):
    """(b) Two ``'both'`` replicas with the prefix cache on and 8 greedy
    requests sharing a 2048-token system prompt: after the first, every
    request routes to the warm replica by affinity.  Tokens against a
    plain engine (prefix cache off) on the same requests."""
    from torchdistpackage_tpu_torch.obs.events import (
        EventLog,
        set_default_event_log,
    )
    from torchdistpackage_tpu_torch.obs.report import _validate_router
    from torchdistpackage_tpu_torch.serving import Request, Router

    rs = np.random.RandomState(23)
    sysp = rs.randint(0, cfg.vocab_size, SYS_LEN).tolist()
    reqs = [Request(sysp + rs.randint(0, cfg.vocab_size,
                                      int(rs.randint(128, 513))).tolist(),
                    FEAT_NEW) for _ in range(8)]
    ref = fleet_engine(params, cfg)
    ref_rids = [ref.submit(r) for r in reqs]
    ref.run_until_idle()
    want = [ref.finished[r]["tokens"] for r in ref_rids]
    del ref
    torch.cuda.empty_cache()
    log_ = EventLog(history_max=1 << 16)
    set_default_event_log(log_)
    try:
        engines = [fleet_engine(params, cfg, prefix_cache=True)
                   for _ in range(2)]
        router = Router(engines)
        per = fleet_counts(engines)
        reset_counts()
        t0 = time.perf_counter()
        rids = [router.submit(reqs[0])]
        fleet_drive(router, "fleet (b) warm-up")
        warm = router.finished[rids[0]]["replica"]
        rids += [router.submit(r) for r in reqs[1:]]
        fleet_drive(router, "fleet (b)")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        set_default_event_log(None)
    decisions = [e for e in log_.as_list() if e["kind"] == "route_decision"]
    for d in decisions[1:]:
        first, second = d["candidates"]
        if not (d["chosen"] == warm == first["replica"]
                and first["affinity_tokens"] == SYS_LEN
                and second["affinity_tokens"] == 0):
            raise RuntimeError(f"fleet (b): rid {d['rid']} not routed by "
                               f"affinity: {d['candidates']}")
    hits = [e for e in log_.as_list() if e["kind"] == "prefix_hit"]
    saved = sum(-(-len(r.tokens) // 512) - -(-(len(r.tokens) - SYS_LEN)
                                            // 512) for r in reqs[1:])
    got = [router.finished[r]["tokens"] for r in rids]
    exact, _, worst = fleet_held(params, cfg, reqs, got, want, "fleet (b)")
    s = router.summary()
    errs = _validate_router(s)
    if errs or len(hits) != 7 or s["fleet"]["affinity"][
            "affinity_routed"] != 7:
        raise RuntimeError(f"fleet (b): hits {len(hits)}, affinity "
                           f"{s['fleet']['affinity']}, {errs[:3]}")
    log(f"[fleet] (b) affinity: 8 requests sharing a {SYS_LEN}-token "
        f"system prompt over two 'both' replicas with the prefix cache in "
        f"{wall:.2f} s: the 7 after the first routed to the warm replica "
        f"{warm} by affinity ({SYS_LEN} resident tokens against 0), "
        f"affinity hit rate {s['fleet']['affinity']['hit_rate']:.3f}; "
        f"{saved} prefill chunks of 512 saved ({len(hits)} prefix hits); "
        f"K1 bodies by replica {per}; tokens equal to the plain engine's "
        f"(prefix cache off): {exact:.3f} (largest gap where they differ "
        f"{worst:.4f}) — on {card}")
    del router, engines
    torch.cuda.empty_cache()
    return {"launches": per, "wall_s": wall, "saved_chunks": saved,
            "exact": exact, "worst_gap": worst}


@torch.no_grad()
def fleet_faults(params, cfg, card, plain):
    """(c) The chunked wire under chaos on a prefill / decode fleet (4
    greedy requests, prompts <= 2048, ``FLEET_NEW`` tokens): a dropped
    chunk healed by one ``migration_retry``; the decode replica dying
    mid-migration, evacuated with no leak; and a ``table_corrupt`` on
    one of two decode replicas with ``evacuate_on_fault`` moving its
    requests to the survivor.  Tokens held as in (a)."""
    from torchdistpackage_tpu_torch.obs.events import (
        EventLog,
        set_default_event_log,
    )
    from torchdistpackage_tpu_torch.obs.report import _validate_router
    from torchdistpackage_tpu_torch.resilience import ChaosMonkey, Fault
    from torchdistpackage_tpu_torch.serving import (
        ChunkedWireTransport,
        Router,
    )

    reqs, idx = fleet_requests(cfg, n_new=FLEET_NEW, lens=(256, 1024, 2048),
                               greedy_only=True)
    reqs, idx = reqs[:4], idx[:4]
    want = [plain["tokens"][i] for i in idx]
    arms = {
        "chunk_drop": dict(roles=["prefill", "decode"], transport=lambda:
                           ChunkedWireTransport(chaos=ChaosMonkey(
                               [Fault("chunk_drop", step=1)]))),
        "replica_death_midmigration": dict(
            roles=["prefill", "decode"], transport=lambda:
            ChunkedWireTransport(chaos=ChaosMonkey(
                [Fault("replica_death_midmigration", step=1)]))),
        "table_corrupt": dict(roles=["prefill", "decode", "decode"],
                              transport=lambda: None, chaos=1),
    }
    out = {}
    for name, arm in arms.items():
        log_ = EventLog(history_max=1 << 16)
        set_default_event_log(log_)
        try:
            engines = [fleet_engine(params, cfg, num_slots=4, max_ctx=4096)
                       for _ in arm["roles"]]
            if "chaos" in arm:
                engines[arm["chaos"]].chaos = ChaosMonkey(
                    [Fault("table_corrupt", step=3)])
            router = Router(engines, roles=arm["roles"],
                            transport=arm["transport"](),
                            evacuate_on_fault="chaos" in arm)
            per = fleet_counts(engines)
            rids = [router.submit(r) for r in reqs]
            t0 = time.perf_counter()
            fleet_drive(router, f"fleet (c) {name}")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            set_default_event_log(None)
        got = [router.finished[r]["tokens"] for r in rids]
        exact, _, worst = fleet_held(params, cfg, reqs, got, want,
                                     f"fleet (c) {name}")
        st, tr = router.stats, router.transport.stats
        kinds = [e["kind"] for e in log_.as_list()]
        if name == "chunk_drop":
            ok = (tr["retries"] == 1 == kinds.count("migration_retry")
                  and st["transport_fallbacks"] == 0
                  and tr["dead_transfers"] == 0)
        elif name == "replica_death_midmigration":
            ok = (router.alive == [True, False] and st["evacuations"] == 1
                  and st["transport_fallbacks"] == 1
                  and router.roles[0] == "both" and not router._inflight)
        else:
            ok = (engines[1].chaos.fired_count == 1
                  and router.alive == [True, False, True]
                  and st["evacuations"] == 1
                  and all(router.finished[r]["replica"] == 2
                          for r in rids))
        leaked = [e._alloc.in_use for e in engines]
        errs = _validate_router(router.summary())
        if not ok or any(leaked) or errs:
            raise RuntimeError(f"fleet (c) {name}: stats {st}, transport "
                               f"{tr}, alive {router.alive}, roles "
                               f"{router.roles}, blocks in use {leaked}, "
                               f"{errs[:3]}")
        out[name] = {"wall_s": wall, "exact": exact, "worst_gap": worst,
                     "retries": tr["retries"],
                     "fallbacks": st["transport_fallbacks"],
                     "evacuations": st["evacuations"], "launches": per}
        log(f"[fleet] (c) {name}: 4 greedy requests in {wall:.2f} s, "
            f"retries {tr['retries']}, fallbacks "
            f"{st['transport_fallbacks']}, evacuations {st['evacuations']}"
            f" ({st['evacuated_requests']} requests), alive "
            f"{router.alive}, roles {router.roles}, {router.transport.kind}"
            f" transport: {tr['chunks']} blocks, {tr['wire_bytes']} B "
            f"staged through the host; "
            f"audit green every tick, no block leaked; tokens equal to "
            f"the plain engine's {exact:.3f} (largest gap where they "
            f"differ {worst:.4f}) — on {card}")
        del router, engines
        torch.cuda.empty_cache()
    return out


@torch.no_grad()
def fleet_long(params, cfg, card):
    """(d) The long-prompt tier: a CP prefill replica over a one-rank
    NCCL ``cp_group`` (K2) hands two greedy requests of 8192 and 12288
    tokens to a plain decode replica (K1), ``long_ctx_threshold`` 8192:
    two ``kv_handoff_long`` with ``bytes > 0`` and ``cp == 1``; tokens
    against the plain engine."""
    import torch.distributed as dist

    from torchdistpackage_tpu_torch.dist import (
        build_cp_group,
        init_distributed,
    )
    from torchdistpackage_tpu_torch.obs.events import (
        EventLog,
        set_default_event_log,
    )
    from torchdistpackage_tpu_torch.obs.report import _validate_router
    from torchdistpackage_tpu_torch.serving import Request, Router

    rs = np.random.RandomState(24)
    reqs = [Request(rs.randint(0, cfg.vocab_size, n).tolist(), 32)
            for n in (8192, 12288)]
    kw = dict(num_slots=2, max_ctx=16384)
    ref = fleet_engine(params, cfg, **kw)
    ref_rids = [ref.submit(r) for r in reqs]
    ref.run_until_idle()
    want = [ref.finished[r]["tokens"] for r in ref_rids]
    del ref
    torch.cuda.empty_cache()
    init_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0, "cuda")
    log_ = EventLog(history_max=1 << 16)
    set_default_event_log(log_)
    try:
        group = build_cp_group(1)
        if dist.get_backend(group) != "nccl":
            raise RuntimeError("the CP group on the card must use NCCL")
        pre = fleet_engine(params, cfg, cp_group=group, **kw)
        dec = fleet_engine(params, cfg, **kw)
        router = Router([pre, dec], roles=["prefill", "decode"],
                        long_ctx_threshold=8192)
        per = fleet_counts([pre, dec])
        rids = [router.submit(r) for r in reqs]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        fleet_drive(router, "fleet (d)")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = router.summary()
        got = [router.finished[r]["tokens"] for r in rids]
        del router, pre, dec
        torch.cuda.empty_cache()
    finally:
        set_default_event_log(None)
        dist.destroy_process_group()
    longs = [e for e in log_.as_list() if e["kind"] == "kv_handoff_long"]
    pcalls = s["replicas"][0]["prefill_chunks"]
    dcalls = s["replicas"][1]["decode_steps"]
    fleet_check_launches("fleet (d)", per, [(0, cfg.nlayers * pcalls),
                                            (cfg.nlayers * dcalls, 0)])
    if len(longs) != 2 or any(e["cp"] != 1 or e["bytes"] <= 0
                              for e in longs):
        raise RuntimeError(f"fleet (d): kv_handoff_long {longs}")
    errs = _validate_router(s)
    if errs:
        raise RuntimeError(f"fleet (d): _validate_router: {errs[:3]}")
    exact, _, worst = fleet_held(params, cfg, reqs, got, want, "fleet (d)")
    log(f"[fleet] (d) long-prompt tier: a CP prefill replica (one-rank "
        f"NCCL group) -> a plain decode replica, prompts "
        f"{[len(r.tokens) for r in reqs]} in {wall:.2f} s: K2 "
        f"{per[0]['K2']} launches on the prefill replica ({pcalls} calls), "
        f"K1 {per[1]['K1']} on the decode replica ({dcalls} calls), K1 0 / "
        f"K2 0 across; kv_handoff_long "
        + ", ".join(f"{e['length']} tokens {e['n_blocks']} blocks "
                    f"{e['bytes']} B cp {e['cp']}" for e in longs)
        + f"; tokens equal to the plain engine's {exact:.3f} (largest gap "
        f"where they differ {worst:.4f}) — on {card}")
    return {"launches": per, "wall_s": wall, "exact": exact,
            "worst_gap": worst,
            "handoffs": [(e["length"], e["n_blocks"], e["bytes"])
                         for e in longs]}


@torch.no_grad()
def fleet_planted(params, cfg, card):
    """(e) A transport that ships every live block but the last, on 4
    greedy requests of 28-46 prompt tokens (the last block 12-15 of
    their positions): (a)'s token gate must fail it; by how much is
    printed.  Held against a plain engine on the same requests."""
    from torchdistpackage_tpu_torch.serving import (
        LoopbackTransport,
        Request,
        Router,
    )

    class ShortTail(LoopbackTransport):
        def deliver(self, handle, dst_cache, src_ids, dst_ids):
            return super().deliver(handle, dst_cache, src_ids[:-1],
                                   dst_ids[:-1])

    rs = np.random.RandomState(25)
    reqs = [Request(rs.randint(0, cfg.vocab_size, n).tolist(), FLEET_NEW)
            for n in (28, 30, 31, 46)]
    kw = dict(num_slots=4, max_ctx=512)
    ref = fleet_engine(params, cfg, **kw)
    ref_rids = [ref.submit(r) for r in reqs]
    ref.run_until_idle()
    want = [ref.finished[r]["tokens"] for r in ref_rids]
    engines = [fleet_engine(params, cfg, **kw) for _ in range(2)]
    router = Router(engines, roles=["prefill", "decode"],
                    transport=ShortTail())
    rids = [router.submit(r) for r in reqs]
    fleet_drive(router, "fleet (e)")
    got = [router.finished[r]["tokens"] for r in rids]
    exact, _, worst = fleet_held(params, cfg, reqs, got, want, "fleet (e)",
                                 gate=False)
    if worst <= TF_TOL:
        raise RuntimeError(f"fleet (e): the short-tail transport passed the "
                           f"token gate (largest gap {worst:.4f})")
    log(f"[fleet] (e) planted fault, the last live block of every handoff "
        f"not shipped (prompts {[len(r.tokens) for r in reqs]}): tokens "
        f"equal to the plain engine's {exact:.3f}, largest teacher-forced "
        f"gap {worst:.4f} > {TF_TOL}: the gate fails it — on {card}")
    del router, engines, ref
    torch.cuda.empty_cache()
    return {"exact": exact, "worst_gap": worst}


def fleet_phase(params, cfg, card, plain):
    """The fleet over the Mistral-7B-v0.1 weights on the card (32 layers,
    bf16; every replica shares the one parameter dict, each has its own
    pool): (a) prefill -> decode disaggregation, (b) prefix-affinity
    routing, (c) the chunked wire and the engines under chaos, (d) the
    long-prompt tier through a CP prefill replica, (e) a planted
    short-tail transport.  ``plain``: :func:`engine_phase`'s run of the
    same requests, whose tokens (a) and (c) are held to."""
    out, secs = {}, {}
    t_phase = time.perf_counter()
    for part, fn in (("a", lambda: fleet_disaggregated(params, cfg, card,
                                                       plain)),
                     ("b", lambda: fleet_affinity(params, cfg, card)),
                     ("c", lambda: fleet_faults(params, cfg, card, plain)),
                     ("d", lambda: fleet_long(params, cfg, card)),
                     ("e", lambda: fleet_planted(params, cfg, card))):
        t0 = time.perf_counter()
        out[part] = fn()
        secs[part] = time.perf_counter() - t0
    total = time.perf_counter() - t_phase
    log(f"[fleet] seconds by part: "
        + ", ".join(f"({k}) {v:.1f}" for k, v in secs.items())
        + f"; the phase {total:.1f} s (its budget 90 s) — on {card}")
    out["seconds"] = {**secs, "total": total}
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


@contextlib.contextmanager
def one_rank_layout(tag, config, moe_ep=False):
    """A one-rank NCCL process group (the card machine has one H100) laid
    out by ``tpc`` over ``config`` (and its MoE view, ``build_moe_mesh``,
    with ``moe_ep``); yields ``tpc``.  At one rank every axis's group is
    the same rank, every collective a copy: these phases prove the
    parallel paths run through the kernels at full width with every
    collective made; the multi-rank exchanges are proven on the CPU over
    gloo (tests/test_torch_tp.py, tests/test_torch_serving_compose.py)."""
    import torch.distributed as dist

    from torchdistpackage_tpu_torch.dist import init_distributed, tpc

    init_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0, "cuda")
    try:
        tpc.setup_process_groups(config)
        if moe_ep:
            tpc.build_moe_mesh(moe_ep_size=1)
        group = tpc.get_group(config[-1][0])
        if dist.get_backend(group) != "nccl":
            raise RuntimeError(f"the {tag} groups on the card must use NCCL")
        # NCCL makes a group's communicator at its first collective: once
        # here, so that no phase times it
        t0 = time.perf_counter()
        dist.all_reduce(torch.zeros(1, device="cuda"), group=group)
        torch.cuda.synchronize()
        log(f"[{tag}] process group: backend {dist.get_backend(group)}, "
            f"layout {config}{' + moe_ep 1' if moe_ep else ''}, first "
            f"collective {(time.perf_counter() - t0) * 1e3:.1f} ms")
        yield tpc
    finally:
        tpc.reset()
        dist.destroy_process_group()


@contextlib.contextmanager
def tensor_group(tag):
    """A one-rank NCCL ``tensor`` group (:func:`one_rank_layout` over data
    1 x tensor 1); yields the tensor group."""
    with one_rank_layout(tag, [("data", 1), ("tensor", 1)]) as ctx:
        yield ctx.get_group("tensor")


def tp_collectives(L, sp):
    """Each region's collectives in one training step under remat
    'flash'.  The backward recomputes each block's forward up to its last
    saved tensor (checkpoint's early stop): the attention's closing
    collective again, the MLP's not.  Non-SP: ``reduce_from_tp`` closes
    the embedding, two products a block (the attention's twice) and the
    loss; ``copy_to_tp``'s backward opens two products a block and the
    head.  SP: the gathers into two products a block and the head run
    forward, again in the recompute (the block's) and backward; the
    scatters out of two a block forward and backward, the attention's
    again; one split (its backward); the embedding and the loss still
    reduce."""
    if sp:
        return {"split_to_sp": 1, "gather_from_sp": 6 * L + 2,
                "scatter_to_sp": 5 * L, "reduce_from_tp": 2, "xent_max": 1}
    return {"reduce_from_tp": 3 * L + 2, "copy_to_tp": 2 * L + 1,
            "xent_max": 1}


def tp_train_phase(card):
    """GPT-125M as ``train_phase`` trains it (batch 16, S 2048, bf16, remat
    'flash', 10 AdamW steps, the same init seed and batch) through
    ``make_train_step`` and through its tensor-parallel step over a
    one-rank NCCL ``tensor`` group, at ``sp=False`` and at ``sp=True``
    (``collective_matmul`` set, but a one-rank group takes the rings'
    shortcut: ``ring_ag_matmul`` / ``ring_matmul_rs`` never run here and
    are proven by the gloo tests alone, tests/test_torch_tp.py): every
    step's loss within 1e-3 relative of
    the serial step's (the vocab-parallel loss forms its log-sum-exp by
    hand where the serial one calls ``F.cross_entropy``), the largest
    parameter difference after 10 steps printed, K3-K5 once a layer a
    step, every region's collectives exactly as many as a step runs
    (``tp_collectives``); step medians against the serial step's."""
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves

    cfg, rows, steps, warm = gpt_125m(), TRAIN_BATCH, 10, 3
    L = cfg.nlayers
    base = dp_train_run(cfg, rows, steps)
    base_ms = median_ms(base["times"], warm)
    out = {"serial_ms": base_ms, "losses": base["losses"]}
    with tensor_group("tp-train") as group:
        for sp in (False, True):
            tcfg = dataclasses.replace(cfg, collective_matmul=sp)
            run = dp_train_run(tcfg, rows, steps, tp_group=group, sp=sp)
            rel = max(abs(a - b) / abs(b)
                      for a, b in zip(run["losses"], base["losses"]))
            dp = max(float((a.float() - b.float()).abs().max())
                     for a, b in zip(tree_leaves(run["params"]),
                                     tree_leaves(base["params"])))
            want = {k: v * steps for k, v in tp_collectives(L, sp).items()}
            got = {k: v for k, v in run["collectives"].items() if v}
            ms = median_ms(run["times"], warm)
            tag = ("sp; collective_matmul set, the rings take the "
                   "one-rank shortcut" if sp else "no sp")
            log(f"[tp-train] GPT-125M, batch {rows}, S {cfg.max_seq}, bf16, "
                f"remat 'flash', {steps} steps through the TP step ({tag}) "
                f"over a one-rank NCCL group: losses "
                + ", ".join(f"{x:.6f}" for x in run["losses"])
                + f"; largest relative loss difference from make_train_step "
                f"{rel:.3e}, largest parameter difference after {steps} "
                f"steps {dp:.3e}; step median {ms:.2f} ms (serial "
                f"{base_ms:.2f}, x{ms / base_ms:.4f}); launches "
                f"{run['launches']}; collectives {got} — on {card}")
            if rel > 1e-3:
                raise RuntimeError(f"TP train ({tag}): a loss off the "
                                   f"serial step's by {rel:.3e} > 1e-3")
            if any(n != L * steps for n in run["launches"].values()):
                raise RuntimeError(f"TP train ({tag}): launches "
                                   f"{run['launches']}, expected "
                                   f"{L * steps} each")
            if got != want:
                raise RuntimeError(f"TP train ({tag}): collectives {got}, "
                                   f"expected {want}")
            out["sp" if sp else "tp"] = {
                "losses": run["losses"], "step_ms": ms, "rel_loss": rel,
                "param_diff": dp, "launches": run["launches"],
                "collectives": got}
            del run
    del base
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------ the sharded training state

ZERO_TOL = 0.05  # f32 masters against bf16 AdamW: largest relative loss gap


def sharded_run(cfg, rows, steps, kind, ema_decay=None, snapshot_at=None):
    """``steps`` AdamW(3e-4) steps of GPT ``cfg`` on ``train_run``'s fixed
    batch (the same init seed) through one of the steps a user calls:
    ``'plain'`` ``make_train_step``; ``'zero'`` ``ZeroOptimizer`` (bf16
    parameters, f32 master shards); ``'zero_clip'`` the same with
    ``chain(clip_by_global_norm_parallel(1.0), adamw)``; ``'fsdp'`` /
    ``'fsdp_overlap'`` ``FSDP.make_train_step`` /
    ``make_overlap_train_step`` on ``shard_params``' shards.  Over
    ``tpc``'s data group (one rank).  The kernels' counts and the
    collectives are set to 0 just before the steps and read just after
    (K3-K5 checked once a layer after every step); the peak memory is
    over the steps, less what was allocated before the run began.  With
    ``ema_decay`` a ``ShardedEMA`` is updated after each step (outside
    the timing) beside a dense f32 EMA of the same parameters formed on
    the card by the same formula.  ``snapshot_at``: a copy of the
    parameters after that step is kept (``'snapshot'``)."""
    from torchdistpackage_tpu_torch.models import gpt_loss, init_gpt_params
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves
    from torchdistpackage_tpu_torch.ops import flash_attention as fa
    from torchdistpackage_tpu_torch.parallel import (
        FSDP,
        ShardedEMA,
        ZeroOptimizer,
        adamw,
        chain,
        clip_by_global_norm_parallel,
    )
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        make_train_step,
    )
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        COLLECTIVES,
    )

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = init_gpt_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    lf = lambda p, b: gpt_loss(p, b, cfg, remat="flash")  # noqa: E731
    opt = adamw(3e-4)
    owner = None
    if kind == "plain":
        state = opt.init(params)
        step = make_train_step(lf, opt)
    elif kind in ("zero", "zero_clip"):
        if kind == "zero_clip":
            opt = chain(clip_by_global_norm_parallel(1.0), opt)
        owner = ZeroOptimizer(opt, param_dtype=cfg.dtype)
        params = owner.place_params(params)
        state = owner.init(params)
        step = owner.make_train_step(lf)
    else:
        owner = FSDP()
        params = owner.shard_params(params)
        state = opt.init(params)
        step = (owner.make_train_step(lf, opt) if kind == "fsdp" else
                owner.make_overlap_train_step(lf, opt))
    batch = random_batch(cfg, rows, 1)
    ema = dense = None
    if ema_decay is not None:
        ema = ShardedEMA(ema_decay)
        es = ema.init(params)
        d = torch.tensor(ema_decay, dtype=torch.float32)
        dense = [p.detach().float().clone() for p in tree_leaves(params)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for name in COLLECTIVES:
        COLLECTIVES[name] = 0
    losses, norms, times, snapshot = [], [], [], None
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
                f"{kind}: flash launches {dict(fa.LAUNCHES)} after step "
                f"{i + 1}: each kernel must launch once a layer a step")
        if snapshot_at == i + 1:
            snapshot = [p.detach().clone() for p in tree_leaves(params)]
        if ema is not None:
            ema.update(es, params)
            with torch.no_grad():
                dense = [e * d + p.float() * (1.0 - d)
                         for e, p in zip(dense, tree_leaves(params))]
    out = {"losses": losses, "norms": norms, "times": times,
           "launches": dict(fa.LAUNCHES),
           "collectives": {k: v // steps for k, v in COLLECTIVES.items()
                           if v},
           "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
           "params": params, "state": state, "step": step, "batch": batch,
           "owner": owner, "snapshot": snapshot}
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"{kind}: losses not finite and falling: "
                           f"{losses}")
    if ema is not None:
        out["ema_exact"] = ema.verify_with_gt(es, dense, atol=0.0)
        del es, dense
    return out


def prefetch_scan(cfg, rows, prefetch):
    """GPT ``cfg``'s block stack through ``prefetched_layer_scan`` over
    the one-rank data group (the stack's shards placed by
    ``stacked_fsdp_specs``), each layer ``block_forward`` under remat
    'flash', on ``train_run``'s embedded batch: the output, the grads of
    the shards and of the input, the K3-K5 launches."""
    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.models import gpt_embed, init_gpt_params
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves
    from torchdistpackage_tpu_torch.ops import flash_attention as fa
    from torchdistpackage_tpu_torch.parallel import (
        prefetched_layer_scan,
        stacked_fsdp_specs,
    )
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        block_forward,
        block_rope_cache,
        checkpoint_block,
    )
    from torchdistpackage_tpu_torch.parallel.zero import shard_of

    group = tpc.get_group("data")
    params = init_gpt_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    _, dims = stacked_fsdp_specs(params["blocks"], 1)
    stack = {k: v for k, v in params["blocks"].items()}

    def shards(tree, dtree):
        if isinstance(tree, dict):
            return {k: shards(v, dtree[k]) for k, v in tree.items()}
        return shard_of(tree.detach(), dtree, 0, 1).clone().requires_grad_()
    stack = shards(stack, dims)
    with torch.no_grad():
        x = gpt_embed(params, random_batch(cfg, rows, 1)["tokens"])
    x.requires_grad_(True)
    rope = block_rope_cache(cfg.block, cfg.max_seq, x.device)

    def apply_fn(lp, h, i):
        return checkpoint_block(
            lambda hh: block_forward(lp, hh, cfg.block, rope=rope),
            "flash")(h)

    reset_counts()
    y = prefetched_layer_scan(stack, x, apply_fn, group, dims,
                              prefetch=prefetch)
    leaves = list(tree_leaves(stack))
    grads = torch.autograd.grad(y.float().pow(2).mean(), leaves + [x])
    torch.cuda.synchronize()
    return {"y": y.detach(), "grads": grads, "launches": dict(fa.LAUNCHES)}


def offload_round_trip(run, base, steps, tag, card):
    """``offload_to_host`` of an FSDP run's shards and AdamW state, then
    ``reload_to_device``; ``memory_report`` at each point, and one more
    step against ``base``'s step ``steps + 1`` (loss and every
    parameter, bit for bit)."""
    from torchdistpackage_tpu_torch.obs.numerics import tree_bytes, tree_leaves
    from torchdistpackage_tpu_torch.parallel import (
        memory_report,
        offload_to_host,
        reload_to_device,
    )

    shards, state = run["params"], run["state"]
    moved = {"params": shards, "opt": state}
    nbytes = tree_bytes(shards) + sum(
        tree_bytes([v for v in st.values() if v.dim() > 0])
        for st in state.state.values())
    torch.cuda.synchronize()
    before = memory_report()["cuda:0"]["bytes_in_use"]
    offload_to_host(moved)
    torch.cuda.synchronize()
    off = memory_report()["cuda:0"]["bytes_in_use"]
    on_host = all(p.device.type == "cpu" and p.is_pinned()
                  for p in tree_leaves(shards))
    reload_to_device(moved)
    torch.cuda.synchronize()
    back = memory_report()["cuda:0"]["bytes_in_use"]
    shards, state, loss, _ = run["step"](shards, state, run["batch"])
    loss = float(loss)
    same = loss == base["losses"][steps] and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(shards),
                                          tree_leaves(base["params"])))
    log(f"{tag} offload after the FSDP run: parameters and AdamW state "
        f"{nbytes} B; memory_report bytes in use before {before}, "
        f"offloaded {off} ({before - off} B lower; pinned on the host: "
        f"{on_host}), reloaded {back}; step {steps + 1} after the reload: "
        f"loss {loss:.6f} (make_train_step {base['losses'][steps]:.6f}), "
        f"loss and every parameter bit-identical: {same} — on {card}")
    if before - off < nbytes or not on_host or not same:
        raise RuntimeError("offload round trip: the card's bytes did not "
                           "drop by the state's, or the step after the "
                           "reload differs")
    return {"state_bytes": nbytes, "before": before, "offloaded": off,
            "reloaded": back, "step_equal": same}

def zero_fsdp_phase(card):
    """The sharded training state at world 1 on the card: a one-rank NCCL
    group as ``tpc``'s ``data`` axis, GPT-125M as ``train_phase`` trains it
    (batch 16, S 2048, bf16, remat 'flash', 10 AdamW steps, the same init
    seed and batch) through ``make_train_step`` (11 steps, the last the
    offload's reference) and through:

    - ``ZeroOptimizer(adamw(3e-4))`` (bf16 parameters, f32 master
      shards): step 1's loss bit-identical to ``make_train_step``'s, the
      losses finite and falling, every later loss within ``ZERO_TOL``
      relative (f32 masters and bf16 AdamW part ways by design; the
      largest gap printed); ``ShardedEMA(0.99)`` updated after each step,
      exact (``verify_with_gt(atol=0)``) against a dense f32 EMA formed on
      the card by the same formula;
    - the same with ``chain(clip_by_global_norm_parallel(1.0), adamw)``:
      step 1's norm before the clip within 1e-3 relative of
      ``make_train_step``'s ``gnorm``, the clipped grads' norm <= 1 + 1e-5;
    - ``FSDP.make_train_step`` and ``make_overlap_train_step``: losses
      and every parameter after step 10 bit-identical to
      ``make_train_step``'s (at one rank a gather and a scatter are
      copies); then ``offload_to_host`` of the FSDP run's parameters and
      optimizer state and ``reload_to_device``: ``memory_report`` before,
      offloaded and reloaded, the card's bytes lower by at least the
      parameters' and state's bytes, and step 11 after the reload (loss
      and every parameter) bit-identical to ``make_train_step``'s step 11;
    - ``prefetched_layer_scan`` over the 12 blocks (``block_forward``
      under remat 'flash'), prefetch on against off: output and every
      grad bit-identical, K3-K5 once a layer each.

    K3-K5 launch once a layer a step on every run; step medians, peaks
    and each run's collectives a step printed beside the card."""
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves
    from torchdistpackage_tpu_torch.parallel import global_grad_norm

    cfg, rows, steps, warm = gpt_125m(), TRAIN_BATCH, 10, 3
    L = cfg.nlayers
    tag = "[zero-fsdp]"
    out = {}
    with one_rank_layout("zero-fsdp", [("data", 1)]) as ctx:
        group = ctx.get_group("data")
        base = sharded_run(cfg, rows, steps + 1, "plain", snapshot_at=steps)
        base_ms = median_ms(base["times"][:steps], warm)
        runs = {}

        def line(name, run, extra=""):
            log(f"{tag} {name}: GPT-125M, batch {rows}, S {cfg.max_seq}, "
                f"bf16, remat 'flash', {len(run['losses'])} steps over a "
                f"one-rank NCCL data group: losses "
                + ", ".join(f"{x:.6f}" for x in run["losses"])
                + f"; step median {median_ms(run['times'], warm):.2f} ms "
                f"(make_train_step {base_ms:.2f}); peak memory over the "
                f"run's start {run['peak_gb']:.3f} GB (make_train_step "
                f"{base['peak_gb']:.3f}); launches {run['launches']}; "
                f"collectives a step {run['collectives']}{extra} — on "
                f"{card}")

        # make_train_step's run, 11 steps: the reference of every check
        line("make_train_step", base)
        for name in ("zero", "zero_clip"):
            run = sharded_run(cfg, rows, steps, name,
                              ema_decay=0.99 if name == "zero" else None)
            gap = max(abs(a - b) / abs(b)
                      for a, b in zip(run["losses"], base["losses"]))
            extra = (f"; step 1 loss bit-identical: "
                     f"{run['losses'][0] == base['losses'][0]}; largest "
                     f"relative loss gap {gap:.3e} (tolerance {ZERO_TOL})")
            if name == "zero":
                extra += f"; ShardedEMA(0.99) exact: {run['ema_exact']}"
            else:
                master = run["state"]["master"]
                post = float(global_grad_norm(
                    [m.grad for m in tree_leaves(master)],
                    [(group,) if d >= 0 else () for d in tree_leaves(
                        run["owner"].shard_dims(run["params"]))]))
                pre_rel = abs(run["norms"][0] - base["norms"][0]) \
                    / base["norms"][0]
                bit = [i + 1 for i, n in enumerate(run["norms"]) if n > 1.0]
                extra += (f"; step 1 norm before the clip "
                          f"{run['norms'][0]:.6f} (make_train_step "
                          f"{base['norms'][0]:.6f}, relative "
                          f"{pre_rel:.3e}); norms before the clip "
                          + ", ".join(f"{n:.4f}" for n in run["norms"])
                          + f" (clipped at steps {bit}); the last step's "
                          f"clipped norm {post:.6f}")
                if pre_rel > 1e-3 or post > 1.0 + 1e-5:
                    raise RuntimeError(f"clip chain: pre-clip norm off by "
                                       f"{pre_rel:.3e} or clipped norm "
                                       f"{post} > 1")
            line(name, run, extra)
            if run["losses"][0] != base["losses"][0] or gap > ZERO_TOL:
                raise RuntimeError(f"{name}: step 1 loss not bit-identical "
                                   f"or a loss {gap:.3e} off")
            if name == "zero" and not run["ema_exact"]:
                raise RuntimeError("ShardedEMA is not exact against the "
                                   "dense EMA")
            runs[name] = {"losses": run["losses"], "norms": run["norms"],
                          "step_ms": median_ms(run["times"], warm),
                          "peak_gb": run["peak_gb"], "gap": gap,
                          "launches": run["launches"],
                          "collectives": run["collectives"]}
            del run
            torch.cuda.empty_cache()

        # FSDP against make_train_step's parameters after step 10, then
        # the offload round trip and step 11 against its step 11
        after10 = base["snapshot"]
        for name in ("fsdp", "fsdp_overlap"):
            run = sharded_run(cfg, rows, steps, name)
            same_losses = run["losses"] == base["losses"][:steps]
            same_params = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(run["params"]), after10))
            first = next((i + 1 for i, (a, b) in enumerate(zip(
                run["losses"], base["losses"])) if a != b), None)
            diff = max(float((a.detach().float() - b.float()).abs().max())
                       for a, b in zip(tree_leaves(run["params"]), after10))
            line(name, run, f"; bit-identical to make_train_step: losses "
                 f"{same_losses} (first difference at step {first}), "
                 f"parameters after step {steps} {same_params} (largest "
                 f"difference {diff:.3e})")
            if not (same_losses and same_params):
                raise RuntimeError(f"{name} at world 1 is not bit-identical "
                                   f"to make_train_step")
            runs[name] = {"losses": run["losses"],
                          "step_ms": median_ms(run["times"], warm),
                          "peak_gb": run["peak_gb"],
                          "launches": run["launches"],
                          "collectives": run["collectives"]}
            if name == "fsdp":
                runs["offload"] = offload_round_trip(run, base, steps, tag,
                                                     card)
            del run
            torch.cuda.empty_cache()
        del after10, base
        torch.cuda.empty_cache()

        scans = [prefetch_scan(cfg, rows, p) for p in (True, False)]
        same = torch.equal(scans[0]["y"], scans[1]["y"]) and all(
            torch.equal(a, b) for a, b in zip(scans[0]["grads"],
                                              scans[1]["grads"]))
        log(f"{tag} prefetched_layer_scan over the {L} blocks "
            f"(block_forward, remat 'flash'), prefetch on against off: "
            f"output and all {len(scans[0]['grads'])} grads bit-identical: "
            f"{same}; launches {scans[0]['launches']} / "
            f"{scans[1]['launches']} — on {card}")
        if not same or any(n != L for s in scans
                           for n in s["launches"].values()):
            raise RuntimeError("prefetched_layer_scan: prefetch on and off "
                               "differ, or K3-K5 not once a layer")
        runs["prefetch_equal"] = same
        del scans
        torch.cuda.empty_cache()
        out = runs
    return out


# --------------------------------------------------------------- the pipeline

PIPE_M = 4        # (a): microbatches of the one-stage schedule
PIPE_M2 = 8       # (b): microbatches of the two-stage schedules
PIPE_STAGES = 2   # (b): two processes on the one card, gloo between them
PIPE_LOSS_TOL = 1e-3   # relative loss against the serial reference
PIPE_GRAD_TOL = 0.02   # of each grad leaf's largest |value|
#: K3 / K4 / K5 launches a layer and microbatch of each schedule (remat
#: 'flash'): 1F1B and interleaved keep the forward's graph; ZB recomputes
#: the stage in the dgrad and in the wgrad (parallel/pipeline_parallel/
#: zero_bubble.py's note)
PIPE_LAUNCHES = {"1f1b": (1, 1, 1), "interleaved": (1, 1, 1),
                 "zb": (3, 2, 2)}


def microbatched(batch, m):
    return {k: v.reshape((m, v.shape[0] // m) + tuple(v.shape[1:]))
            for k, v in batch.items()}


def grad_gap(got, want):
    """The largest |got - want| of a leaf over the leaf's largest
    |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def pipeline_one_stage(cfg, rows, card, base_ms):
    """(a) of :func:`pipeline_phase`, inside its one-rank layout."""
    from torchdistpackage_tpu_torch.models import (
        gpt_loss,
        gpt_pipeline_1f1b,
        init_gpt_params,
    )
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves
    from torchdistpackage_tpu_torch.ops import flash_attention as fa
    from torchdistpackage_tpu_torch.parallel import (
        DataParallel,
        ZeroOptimizer,
        adamw,
    )
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        local_value_and_grad,
    )
    from torchdistpackage_tpu_torch.parallel.pipeline_parallel import (
        last_stats,
    )

    tag, L, m = "[pipeline]", cfg.nlayers, PIPE_M
    lf = lambda p, b: gpt_loss(p, b, cfg, remat="flash")  # noqa: E731
    vg = lambda p, b: gpt_pipeline_1f1b(  # noqa: E731
        p, b, cfg, m, remat="flash")
    batch = random_batch(cfg, rows, 1)
    pbatch = microbatched(batch, m)
    params = init_gpt_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    ref_loss, ref_grads = local_value_and_grad(lf, params, batch,
                                               grad_accum_iters=m)
    torch.cuda.synchronize()
    reset_counts()
    loss, grads = vg(params, pbatch)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    gaps = [grad_gap(g, r) for g, r in zip(tree_leaves(grads),
                                           tree_leaves(ref_grads))]
    exact = all(torch.equal(g, r) for g, r in zip(tree_leaves(grads),
                                                  tree_leaves(ref_grads)))
    log(f"{tag} (a) gpt_pipeline_1f1b, one stage (data 1 x pipe 1, NCCL), "
        f"GPT-125M, batch {rows} as M {m} x {rows // m}, S {cfg.max_seq}, "
        f"bf16, remat 'flash': loss {float(loss):.6f} against "
        f"local_value_and_grad(gpt_loss, grad_accum_iters={m}) "
        f"{float(ref_loss):.6f} (relative {rel:.3e}, tolerance "
        f"{PIPE_LOSS_TOL}); largest grad gap {max(gaps):.3e} of its leaf's "
        f"largest |grad| over {len(gaps)} leaves (tolerance "
        f"{PIPE_GRAD_TOL}), bit-identical: {exact}; launches {launches} "
        f"({L} x {m} each); in flight {last_stats['max_in_flight']} of "
        f"{last_stats['in_flight_bound']} — on {card}")
    if rel > PIPE_LOSS_TOL or max(gaps) > PIPE_GRAD_TOL:
        raise RuntimeError(f"one-stage 1F1B: loss {rel:.3e} or a grad "
                           f"{max(gaps):.3e} off")
    if any(n != L * m for n in launches.values()):
        raise RuntimeError(f"one-stage 1F1B launches {launches} != "
                           f"{L} x {m}")
    out = {"loss_rel": rel, "grad_gap": max(gaps), "exact": exact,
           "launches": launches}
    del params, grads, ref_grads
    gc.collect()
    torch.cuda.empty_cache()

    def run(kind, steps=10, warm=3):
        params = init_gpt_params(
            cfg, torch.Generator(device="cuda").manual_seed(0))
        opt = adamw(3e-4)
        b = batch
        if kind == "accum":
            state = opt.init(params)
            step = DataParallel().make_train_step(lf, opt,
                                                  grad_accum_iters=m)
        elif kind == "dp":
            state = opt.init(params)
            step = DataParallel().make_train_step(value_and_grad_fn=vg,
                                                  optimizer=opt)
            b = pbatch
        else:
            zero = ZeroOptimizer(opt, param_dtype=cfg.dtype)
            params = zero.place_params(params)
            state = zero.init(params)
            step = zero.make_train_step(value_and_grad_fn=vg)
            b = pbatch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, times = [], []
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, loss, _ = step(params, state, b)
            losses.append(float(loss))
            times.append(time.perf_counter() - t0)
            if any(n != L * m * (i + 1) for n in fa.LAUNCHES.values()):
                raise RuntimeError(f"{kind}: launches {dict(fa.LAUNCHES)} "
                                   f"after step {i + 1} != {L} x {m} a step")
        return {"losses": losses, "ms": median_ms(times, warm),
                "launches": {k: v // steps for k, v in fa.LAUNCHES.items()},
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}

    runs = {k: run(k) for k in ("accum", "dp", "zero")}
    ref = runs["accum"]["losses"]
    for kind, tol in (("dp", PIPE_LOSS_TOL), ("zero", ZERO_TOL)):
        r = runs[kind]
        gap = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], ref))
        r["gap"] = gap
        log(f"{tag} (a) 10 AdamW(3e-4) steps, {kind} "
            f"({'DataParallel' if kind == 'dp' else 'ZeroOptimizer'}"
            f"(value_and_grad_fn=gpt_pipeline_1f1b)): losses "
            + ", ".join(f"{x:.6f}" for x in r["losses"])
            + f"; largest relative gap to DataParallel(grad_accum_iters="
            f"{m})'s {gap:.3e} (tolerance {tol}); step median "
            f"{r['ms']:.2f} ms (accumulating step {runs['accum']['ms']:.2f}"
            f", train_phase's plain step {base_ms:.2f}); launches a step "
            f"{r['launches']}; peak {r['peak_gb']:.3f} GB (accumulating "
            f"{runs['accum']['peak_gb']:.3f}) — on {card}")
        if gap > tol or not all(np.isfinite(r["losses"])):
            raise RuntimeError(f"one-stage pipeline {kind}: losses "
                               f"{gap:.3e} off")
    out["runs"] = runs
    return out


def pipeline_rank(rank, world, port, tmp):
    """One stage of :func:`pipeline_phase` (b), in its own process: a pipe
    group of ``world`` over gloo on the loopback (NCCL puts no two ranks
    of one communicator on one card), the flash kernels loaded from the
    parent's build, GPT-125M from the parent's seed (this stage's 6
    layers and the whole leaves), ``train_run``'s batch as M 8 x 2.
    1F1B, interleaved (V 2) and ZB: one warm-up and three timed steps
    each, every step's loss and the first step's embedding and head grads
    against the parent's serial reference (``ref.npz``), K3-K5 launches a
    step, the in-flight maximum, the point-to-point traffic a step and
    the host copies gloo needed; then one 1F1B step with the replicated
    leaves' pipe sum left out.  Writes ``rank<r>.json`` under ``tmp``."""
    import datetime

    import torch.distributed as dist

    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.models import (
        gpt_pipeline_1f1b,
        gpt_pipeline_zb,
        init_gpt_params,
        pipe_slab,
    )
    from torchdistpackage_tpu_torch.ops import _build
    from torchdistpackage_tpu_torch.ops import flash_attention as fa
    from torchdistpackage_tpu_torch.parallel.pipeline_parallel import (
        _p2p,
        last_stats,
        pipeline_sched,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(2)  # two ranks and the parent share the host
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        _build.load_all(["flash_attention"])
        tpc.setup_process_groups([("pipe", world)])
        cfg, m = gpt_125m(), PIPE_M2
        full = init_gpt_params(
            cfg, torch.Generator(device="cuda").manual_seed(0))
        batch = microbatched(random_batch(cfg, TRAIN_BATCH, 1), m)
        ref = np.load(Path(tmp) / "ref.npz")
        ref_loss = float(ref["loss"])
        ref_g = {k: torch.from_numpy(ref[k]).cuda() for k in
                 ("tok_emb", "head")}

        def local(V):
            out = pipe_slab(full, rank, world, V)

            def own(t):
                if isinstance(t, dict):
                    return {k: own(v) for k, v in t.items()}
                return t.detach().clone().requires_grad_(True)
            return own(out)

        def gates(loss, grads):
            rel = abs(float(loss) - ref_loss) / abs(ref_loss)
            gaps = {k: grad_gap(grads[k], ref_g[k]) for k in ref_g}
            return rel, gaps

        res = {"rank": rank, "schedules": {}}
        scheds = (("1f1b", gpt_pipeline_1f1b, 1),
                  ("interleaved", gpt_pipeline_1f1b, 2),
                  ("zb", gpt_pipeline_zb, 1))
        base = torch.cuda.memory_allocated()
        for name, fn, V in scheds:
            params = local(V)
            kw = {"num_chunks": V} if V > 1 else {}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            rows = []
            for i in range(4):
                dist.barrier()
                reset_counts()
                _p2p.reset_stats()
                t0 = time.perf_counter()
                loss, grads = fn(params, batch, cfg, m, remat="flash", **kw)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                if i == 0:
                    rel, gaps = gates(loss, grads)
                else:
                    rel, gaps = abs(float(loss) - ref_loss) / abs(ref_loss), \
                        None
                rows.append({"ms": ms, "loss": float(loss), "rel": rel,
                             "gaps": gaps, "launches": dict(fa.LAUNCHES),
                             "p2p": dict(_p2p.P2P_STATS),
                             "in_flight": last_stats["max_in_flight"],
                             "bound": last_stats["in_flight_bound"]})
                del grads
            res["schedules"][name] = {
                "rows": rows,
                "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}
            del params
            torch.cuda.empty_cache()
        # the planted fault: the replicated leaves' pipe sum left out
        sync = pipeline_sched._Stage.sync
        pipeline_sched._Stage.sync = lambda self, g: None
        try:
            loss, grads = gpt_pipeline_1f1b(local(1), batch, cfg, m,
                                            remat="flash")
            rel, gaps = gates(loss, grads)
            res["planted"] = {"rel": rel, "gaps": gaps}
            del grads
        finally:
            pipeline_sched._Stage.sync = sync
        res["nlayers_here"] = cfg.nlayers // world
        (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(res))
        dist.barrier()
    finally:
        tpc.reset()
        dist.destroy_process_group()


def pipeline_two_stages(cfg, card, serial_ms, timeout=600):
    """(b) of :func:`pipeline_phase`: the parent's serial reference, then
    :func:`pipeline_rank` on two spawned processes."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    from torchdistpackage_tpu_torch.models import gpt_loss, init_gpt_params
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        local_value_and_grad,
    )

    tag, m = "[pipeline]", PIPE_M2
    tmp = Path(tempfile.mkdtemp(prefix="tdp-pipeline-"))
    try:
        params = init_gpt_params(
            cfg, torch.Generator(device="cuda").manual_seed(0))
        for p in tree_leaves(params):
            p.requires_grad_(True)
        batch = random_batch(cfg, TRAIN_BATCH, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = local_value_and_grad(
            lambda p, b: gpt_loss(p, b, cfg, remat="flash"), params, batch,
            grad_accum_iters=m)
        torch.cuda.synchronize()
        ref_ms = (time.perf_counter() - t0) * 1e3
        np.savez(tmp / "ref.npz", loss=np.float64(float(loss)),
                 tok_emb=grads["tok_emb"].float().cpu().numpy(),
                 head=grads["head"].float().cpu().numpy())
        del params, grads, loss
        gc.collect()
        torch.cuda.empty_cache()
        ctx = mp.get_context("spawn")
        port = free_port()
        procs = [ctx.Process(target=pipeline_rank,
                             args=(r, PIPE_STAGES, port, str(tmp)))
                 for r in range(PIPE_STAGES)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.perf_counter() + timeout
        for p in procs:
            p.join(max(1.0, deadline - time.perf_counter()))
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(30)
        codes = [p.exitcode for p in procs]
        if codes != [0] * PIPE_STAGES:
            raise RuntimeError(f"pipeline ranks exited {codes}")
        res = [json.loads((tmp / f"rank{r}.json").read_text())
               for r in range(PIPE_STAGES)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    total = time.perf_counter() - t0
    out = {"ref_loss_step_ms": ref_ms, "phase_s": total, "ranks": res}
    bad = []
    for r in res:
        L = r["nlayers_here"]
        for name, sch in r["schedules"].items():
            rows = sch["rows"]
            k = PIPE_LAUNCHES[name]
            want = {"flash_fwd": k[0] * L * m, "flash_bwd_dq": k[1] * L * m,
                    "flash_bwd_dkv": k[2] * L * m}
            first, timed = rows[0], rows[1:]
            p2p = first["p2p"]
            log(f"{tag} (b) rank {r['rank']} of {PIPE_STAGES} (stage "
                f"{r['rank']}, {L} layers and the whole leaves), {name}, "
                f"M {m} x 2: losses " + ", ".join(
                    f"{x['loss']:.6f}" for x in rows)
                + f" (largest relative gap {max(x['rel'] for x in rows):.3e} "
                f"to the serial reference; tolerance {PIPE_LOSS_TOL}); step "
                f"1 grad gaps {first['gaps']} of their leaves' largest "
                f"|grad| (tolerance {PIPE_GRAD_TOL}); launches a step "
                f"{first['launches']} (want {want}); in flight "
                f"{first['in_flight']} of {first['bound']}; a step's p2p: "
                f"{p2p['sends']} sends / {p2p['recvs']} receives, "
                f"{p2p['bytes_sent']} / {p2p['bytes_recv']} B, "
                f"{p2p['host_copies']} host copies of "
                f"{p2p['host_copy_bytes']} B (gloo moves a CUDA payload "
                f"through the host), {p2p['all_reduces']} pipe all-reduces, "
                f"{p2p['preambles']} shape preamble; step median "
                f"{float(np.median([x['ms'] for x in timed])):.2f} ms of 3 "
                f"(two processes share one card: not pipeline scaling; the "
                f"serial step at accumulation {m} {ref_ms:.2f} ms, (a)'s "
                f"one-stage step {serial_ms:.2f} ms); peak over the "
                f"schedule's start {sch['peak_gb']:.3f} GB — on {card}")
            if (max(x["rel"] for x in rows) > PIPE_LOSS_TOL
                    or max(first["gaps"].values()) > PIPE_GRAD_TOL):
                bad.append(f"rank {r['rank']} {name}: loss or grads off")
            if any(x["launches"] != want for x in rows):
                bad.append(f"rank {r['rank']} {name}: launches "
                           f"{[x['launches'] for x in rows]} != {want}")
            if any(not 0 < x["in_flight"] <= x["bound"] for x in rows):
                bad.append(f"rank {r['rank']} {name}: in flight over the "
                           f"bound")
        pl = r["planted"]
        caught = pl["rel"] > PIPE_LOSS_TOL or max(
            pl["gaps"].values()) > PIPE_GRAD_TOL
        log(f"{tag} (b) rank {r['rank']}: planted fault (the replicated "
            f"leaves' pipe sum left out): grad gaps {pl['gaps']} — "
            f"{'caught' if caught else 'NOT caught'} by the gate")
        if not caught:
            bad.append(f"rank {r['rank']}: the planted fault passed")
    log(f"{tag} (b) two processes on one card, phase {total:.1f} s with "
        f"both processes' start — on {card}")
    if bad:
        raise RuntimeError("pipeline (b): " + "; ".join(bad))
    return out


def pipeline_phase(card, base_ms):
    """The pipeline schedules on the card, GPT-125M (batch 16, S 2048,
    bf16, remat 'flash'): (a) one stage in this process over a one-rank
    NCCL data 1 x pipe 1 layout; (b) two stages as two processes on the
    card over gloo (the multi-stage exchanges at P 2 and 4 and beside
    data, ZeRO and tensor groups are held on the CPU,
    tests/test_torch_pipeline.py and tests/test_torch_pipeline_compose.py).
    ``base_ms``: ``train_phase``'s step median."""
    cfg, rows = gpt_125m(), TRAIN_BATCH
    with one_rank_layout("pipeline", [("data", 1), ("pipe", 1)]):
        a = pipeline_one_stage(cfg, rows, card, base_ms)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[pipeline] this process holds "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB before the two "
        f"stages start")
    b = pipeline_two_stages(cfg, card, a["runs"]["dp"]["ms"])
    return {"one_stage": a, "two_stages": b}


MOE_TRAIN_BATCH = 8     # bench.py's --moe leaf's first candidate (:128)
MOE_TRAIN_M = 4         # (d): microbatches of the accumulating / 1F1B steps
MOE_LOSS_TOL = 5e-4     # (a): K6 against the plain 'sorted' arm, relative
#: (c) against the 'sorted' arm's step 1: the loss (relative) of the run
#: that routes itself, each grad leaf (of its largest |value|) of the run
#: that replays the 'sorted' arm's routing (:class:`RouteTap`)
MOE_VIEW_TOL = {"loss": 2e-4, "grad": 0.05}
MOE_ZERO_TOL = 1e-3     # (d): ZeRO x 1F1B against the accumulating step
MOE_FN_TOL = 0.02       # (b): of each grad's largest |value|


def gpt_moe_8x125m(dispatch="auto"):
    """``bench.py``'s ``--moe`` leaf (bench.py:955-965): GPT-125M's trunk
    (vocab 32768, d 768, 12 heads, 12 layers, S 2048, GELU, learned
    positions) with 8 experts, top-2, every 2nd block (6 expert blocks),
    capacity factor 1.25, bf16, flash attention."""
    from torchdistpackage_tpu_torch.models import GPTConfig

    return GPTConfig(vocab_size=32768, dim=768, nheads=12, nlayers=12,
                     max_seq=2048, ffn_mult=4, dtype=torch.bfloat16,
                     attn_impl="flash", moe_experts=8, moe_top_k=2,
                     moe_every=2, moe_capacity_factor=1.25,
                     moe_dispatch=dispatch)


def moe_matmul_params(params, cfg):
    """``bench.py``'s MoE accounting (:374-393): the parameters that enter
    a matmul a token, the experts at ``top_k / E`` (a token runs only its
    routed experts), the router whole, no embedding tables."""
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves

    n = 0
    for k, sub in params.items():
        if k in ("tok_emb", "pos_emb"):
            continue
        if k != "blocks":
            n += sum(t.numel() for t in tree_leaves(sub))
            continue
        for bp in sub:
            for name, leaf in bp.items():
                if name == "moe":
                    n += leaf["router"]["w"].numel()
                    n += sum(t.numel() for t in tree_leaves(
                        leaf["experts"])) * cfg.moe_top_k // cfg.moe_experts
                else:
                    n += sum(t.numel() for t in tree_leaves(leaf))
    return n


def moe_launches():
    from torchdistpackage_tpu_torch.ops import flash_attention as fa
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    out = dict(fa.LAUNCHES)
    out.update(K6=md.LAUNCHES["fused_moe_ffn"],
               K7=md.LAUNCHES["fused_expert_ffn"])
    return out


def moe_expected(cfg, per_block, k6=0, k7=0):
    """The launches a step: K3-K5 once a layer and microbatch (remat
    'flash' keeps K3's (o, lse)); the expert kernel twice an expert block
    and microbatch (the forward and the checkpoint's recompute; its
    backward is plain PyTorch, the reference's oracle VJP)."""
    n_moe = sum(1 for i in range(cfg.nlayers)
                if i % cfg.moe_every == cfg.moe_every - 1)
    return {"flash_fwd": cfg.nlayers * per_block,
            "flash_bwd_dq": cfg.nlayers * per_block,
            "flash_bwd_dkv": cfg.nlayers * per_block,
            "K6": 2 * n_moe * per_block * k6,
            "K7": 2 * n_moe * per_block * k7}


def gated_steps(step, params, state, batch, steps, want, tag,
                keep_grads=True):
    """``steps`` calls of ``step``, the counts set to 0 just before and
    checked after each against ``want`` a step; returns the losses, the
    host times, the counts a step, the peak and (``keep_grads``) step 1's
    grads, the leaves' ``.grad``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, times, g1 = [], [], None
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss, _ = step(params, state, batch)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
        if i == 0 and keep_grads:
            g1 = [p.grad.detach().clone() for p in leaves_of(params)]
        got = moe_launches()
        if any(got[k] != v * (i + 1) for k, v in want.items()):
            raise RuntimeError(f"{tag}: launches {got} after step {i + 1}, "
                               f"want {want} a step")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"{tag}: losses not finite: {losses}")
    return {"losses": losses, "times": times, "launches": want,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "grads1": g1, "params": params}


def leaves_of(params):
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves

    return list(tree_leaves(params))


def grad_gaps(got, want, params):
    """Each leaf's largest |got - want| over its largest |want|; the QKV
    bias's key rows are left out (their grad is 0 in exact arithmetic:
    both sides hold rounding noise)."""
    from torchdistpackage_tpu_torch.utils.partition import named_leaves

    out = {}
    for (name, _), g, w in zip(named_leaves(params), got, want):
        if name.endswith("attn/bqkv"):
            g, w = g[[0, 2]], w[[0, 2]]
        out[name] = grad_gap(g, w)
    return out


def top_gaps(gaps, skip=(), n=4):
    """The ``n`` largest of ``gaps`` outside ``skip``, printed."""
    top = sorted(((v, k) for k, v in gaps.items() if k not in skip),
                 reverse=True)[:n]
    return ", ".join(f"{k} {v:.3e}" for v, k in top)


class RouteTap:
    """``parallel.moe._top_k_route`` wrapped while the tap is open.  It
    records the routing decisions (``gate_idx``, ``slot``, ``keep``) of
    the first ``limit`` calls in call order; given ``replay``, another
    run's record, call ``j`` takes decision ``j`` instead: that run's
    experts, slots and kept choices, with the gates this run's own
    probabilities give those experts (renormalised over the k choices as
    ``_top_k_gates`` does), so the gradient still reaches the router.
    Routing is a discontinuous function of the hidden state: two arms
    that round differently send a few near-tie tokens to other experts,
    and a token routed apart moves its block's output and the grads that
    depend on it for reasons that are not faults.  A run that replays
    another's routing differs from it by the arithmetic alone.  Two runs
    of one model and remat mode call the router in the same order: each
    expert block's forward, then under remat its recompute."""

    def __init__(self, limit=None, replay=None):
        self.limit, self.replay, self.calls, self.n = limit, replay, [], 0

    def __enter__(self):
        from torchdistpackage_tpu_torch.parallel import moe as pm

        self._pm, self._true = pm, pm._top_k_route
        pm._top_k_route = self._route
        return self

    def __exit__(self, *exc):
        self._pm._top_k_route = self._true

    def _route(self, probs, k, capacity, priority="choice"):
        j, self.n = self.n, self.n + 1
        if self.replay is None:
            out = self._true(probs, k, capacity, priority)
        elif j < len(self.replay):
            gi, slot, keep = self.replay[j]
            gv = probs.gather(-1, gi)
            out = (gv / gv.sum(-1, keepdim=True).clamp_min(1e-9), gi, slot,
                   keep)
        else:
            raise RuntimeError(f"router call {j + 1}, but the replayed run "
                               f"recorded {len(self.replay)}")
        if self.limit is None or j < self.limit:
            self.calls.append(tuple(t.detach().clone() for t in out[1:]))
        return out


def routes_apart(a, b, n):
    """Per expert block, over the first ``n`` calls of two
    :class:`RouteTap` records (a step's forward): the tokens whose expert
    pair differs, and the tokens whose kept experts differ (those, plus
    the tokens dropped past capacity in one run and not the other)."""
    pairs, kept = [], []
    for (gi_a, _, keep_a), (gi_b, _, keep_b) in zip(a[:n], b[:n]):
        pairs.append(int((gi_a.sort(-1).values != gi_b.sort(-1).values)
                         .any(-1).sum()))
        kept.append(int((keep_a.sum(1) != keep_b.sum(1)).any(-1).sum()))
    return pairs, kept


def frozen_gap(losses):
    """The largest relative gap to ``losses`` of a run whose state never
    moves (every loss the first): a loss gate tells a fault only below
    it."""
    return max(abs(losses[0] - x) / abs(x) for x in losses)


def moe_serial(cfg, batch, steps, card, keep_grads=True, tap=None):
    """(a): ``make_train_step(gpt_moe_loss)``, AdamW 3e-4, remat 'flash',
    ``steps`` steps from the seed-0 weights on one batch, under ``tap``
    (a :class:`RouteTap`) if given."""
    from torchdistpackage_tpu_torch.models import (
        gpt_moe_loss,
        init_gpt_moe_params,
    )
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        adamw,
        make_train_step,
    )

    params = init_gpt_moe_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    opt = adamw(3e-4)
    state = opt.init(params)
    step = make_train_step(lambda p, b: gpt_moe_loss(p, b, cfg,
                                                     remat="flash"), opt)
    k6 = int(cfg.moe_dispatch != "sorted")
    with tap or contextlib.nullcontext():
        run = gated_steps(step, params, state, batch, steps,
                          moe_expected(cfg, 1, k6=k6),
                          f"moe-train (a) {cfg.moe_dispatch}", keep_grads)
    run["matmul_params"] = moe_matmul_params(params, cfg)
    run["num_params"] = sum(p.numel() for p in leaves_of(params))
    return run


def train_block_inputs(cfg):
    """One expert block's inputs at the training shape: bf16 GELU experts
    of the model's widths, T = batch x S tokens, a routing from random
    router logits at the model's capacity; and the generator, for the
    cotangent."""
    from torchdistpackage_tpu_torch.parallel.moe import _top_k_route

    T, D, Fd, E, k = (MOE_TRAIN_BATCH * cfg.max_seq, cfg.dim,
                      cfg.block.ffn_dim, cfg.moe_experts, cfg.moe_top_k)
    C = int(np.ceil(T * k * cfg.moe_capacity_factor / E))
    ex = moe_experts(E=E, D=D, F=Fd, act="gelu", dtype=torch.bfloat16,
                     seed=31)
    g = torch.Generator(device="cuda").manual_seed(32)
    x = torch.randn(T, D, generator=g, device="cuda").bfloat16()
    probs = torch.softmax(torch.randn(T, E, generator=g, device="cuda") * 2,
                          -1)
    return ex, x, _top_k_route(probs, k, C), C, g


def backward_ms(fwd, cot, n=4):
    """Median milliseconds of ``fwd().backward(cot)``'s backward alone,
    by CUDA events, the first of ``n`` calls left out."""
    times = []
    for _ in range(n):
        y = fwd()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        y.backward(cot)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times[1:]))


def moe_fn_check(cfg, card, fails):
    """(b) for K6: its Function at one expert block of the training shape
    — the grads of the experts, the tokens and ``gate_vals`` from a fixed
    routing against the f32 oracle's autograd on f32 copies, K6's forward
    against its plain version (``moe_held``), the planted fault (the gate
    cotangent dropped), and the forward, backward and plain times."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    ex, x, (gv, gi, slot, keep), C, g = train_block_inputs(cfg)
    (T, D), Fd, E, k = x.shape, cfg.block.ffn_dim, cfg.moe_experts, gi.shape[1]
    cot = (torch.randn(T, D, generator=g, device="cuda") * 1e-3).bfloat16()

    def grads(fault=False):
        exr = {n: w.detach().clone().requires_grad_(True)
               for n, w in ex.items()}
        xr, gvr = (t.detach().clone().requires_grad_(True) for t in (x, gv))
        true_backward = md._FusedMoE.backward
        if fault:
            def dropped(ctx, gg):
                out = list(true_backward(ctx, gg))
                out[4] = torch.zeros_like(out[4])  # the gate cotangent
                return tuple(out)
            md._FusedMoE.backward = staticmethod(dropped)
        try:
            y = md.fused_moe_ffn(exr, xr, gvr, gi, slot, keep, C)
            y.backward(cot)
        finally:
            md._FusedMoE.backward = true_backward
        out = {n: w.grad for n, w in exr.items()}
        out.update(tokens=xr.grad, gate_vals=gvr.grad)
        return y.detach(), out

    reset_counts()
    y, got = grads()
    launches = md.LAUNCHES["fused_moe_ffn"]
    exf = {n: w.float().requires_grad_(True) for n, w in ex.items()}
    xf, gvf = x.float().requires_grad_(True), gv.detach().requires_grad_(True)
    md.moe_ffn_oracle_diff(exf, xf, gvf, gi, slot, keep, C).backward(
        cot.float())
    want = {n: w.grad for n, w in exf.items()}
    want.update(tokens=xf.grad, gate_vals=gvf.grad)
    gaps = {n: grad_gap(got[n], want[n]) for n in want}
    _, faulty = grads(fault=True)
    fault_gap = grad_gap(faulty["gate_vals"], want["gate_vals"])
    del exf, xf, gvf, want, faulty
    idx, comb = md.slot_maps(gv, gi, slot, keep, C)
    with torch.no_grad():
        exact = md.moe_ffn_slots_reference(ex, x, idx, comb)
        scale = md.moe_rounding_scale(ex, x, idx, comb)
    err, ratio = moe_held(y.float(), exact, scale, torch.bfloat16)
    del exact, scale
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: md.fused_moe_ffn(ex, x, gv, gi, slot, keep,
                                                  C), 10)
        plain_ms = cuda_ms(lambda: md.moe_ffn_slots_reference(
            ex, x, idx, comb), 3)
    exr = {n: w.detach().clone().requires_grad_(True) for n, w in ex.items()}
    xr, gvr = (t.detach().clone().requires_grad_(True) for t in (x, gv))
    bwd_ms = backward_ms(
        lambda: md.fused_moe_ffn(exr, xr, gvr, gi, slot, keep, C), cot)
    filled = int((comb != 0).sum())
    flops = 2 * filled * 2 * D * Fd
    bound = max(flops / PEAK_FLOPS[torch.bfloat16],
                (sum(t.numel() * t.element_size() for t in ex.values())
                 + x.numel() * 2 + T * D * 4) / HBM_BYTES_PER_S) * 1e3
    log(f"[moe-train] (b) K6's Function at one expert block of the training "
        f"shape (tokens [{T}, {D}] bf16, E {E}, top-{k}, C {C}, F {Fd}, "
        f"GELU; {filled} slots filled): {launches} K6 launch for the forward "
        f"and backward; grad gaps to the f32 oracle's autograd "
        + ", ".join(f"{n} {v:.3e}" for n, v in gaps.items())
        + f" (tolerance {MOE_FN_TOL} of each leaf's largest |grad|); the "
        f"planted fault (gate cotangent dropped): gate_vals gap "
        f"{fault_gap:.3e}; forward against the plain version: max abs err "
        f"{err:.3e}, tolerance ratio {ratio:.3f}; K6 forward {fwd_ms:.4f} ms "
        f"({flops / fwd_ms / 1e9:.1f} TFLOP/s; bound {bound:.4f} ms), the "
        f"oracle backward {bwd_ms:.3f} ms, the plain f32 forward "
        f"{plain_ms:.3f} ms — on {card}")
    if max(gaps.values()) > MOE_FN_TOL or ratio > 1.0 or launches != 1:
        fails.append(f"(b) K6: grads {gaps}, forward ratio {ratio}, "
                     f"launches {launches}")
    if not fault_gap > MOE_FN_TOL:
        fails.append(f"(b) K6: the planted gate fault passed "
                     f"({fault_gap:.3e})")
    return {"gaps": gaps, "fault_gap": fault_gap, "max_abs_err": err,
            "tol_ratio": ratio, "ms": fwd_ms, "backward_ms": bwd_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "filled": filled,
            "C": C}


def expert_fn_check(cfg, card, fails):
    """(b) for K7: its Function on the exchange's layout at the training
    shape — ``[E / ep, ep C, D]`` = ``[8, 5120, 768]`` bf16 at ep 1, the
    slots that the sorted dispatch fills from K6's check's tokens and
    routing, empty slots 0, a cotangent on the filled slots — the grads
    of the experts and the rows against ``expert_ffn_reference_diff``'s
    f32 autograd on f32 copies (``MOE_FN_TOL`` of each leaf's largest
    |grad|), its forward against ``expert_ffn_reference`` (``moe_held``),
    the planted fault (the rows' cotangent dropped), and the forward,
    backward, plain and ``torch.bmm`` times beside the bound."""
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md

    ex, x, route, C, _ = train_block_inputs(cfg)
    idx, comb = md.slot_maps(*route, C)
    filled = (comb != 0)[..., None]
    rows = torch.where(filled, x[idx.long()], 0).contiguous()  # [E, C, D]
    del x, route
    g = torch.Generator(device="cuda").manual_seed(33)
    cot = (torch.randn(rows.shape, generator=g, device="cuda")
           * 1e-3).bfloat16() * filled

    def grads(fault=False):
        exr = {n: w.detach().clone().requires_grad_(True)
               for n, w in ex.items()}
        xr = rows.detach().clone().requires_grad_(True)
        true_backward = md._ExpertFFN.backward
        if fault:
            def dropped(ctx, gg):
                out = list(true_backward(ctx, gg))
                out[0] = torch.zeros_like(out[0])  # the rows' cotangent
                return tuple(out)
            md._ExpertFFN.backward = staticmethod(dropped)
        try:
            y = md.fused_expert_ffn(exr, xr)
            y.backward(cot)
        finally:
            md._ExpertFFN.backward = true_backward
        out = {n: w.grad for n, w in exr.items()}
        out["rows"] = xr.grad
        return y.detach(), out

    reset_counts()
    y, got = grads()
    launches = md.LAUNCHES["fused_expert_ffn"]
    exf = {n: w.float().requires_grad_(True) for n, w in ex.items()}
    xf = rows.float().requires_grad_(True)
    md.expert_ffn_reference_diff(exf, xf).backward(cot.float())
    want = {n: w.grad for n, w in exf.items()}
    want["rows"] = xf.grad
    gaps = {n: grad_gap(got[n], want[n]) for n in want}
    _, faulty = grads(fault=True)
    fault_gap = grad_gap(faulty["rows"], want["rows"])
    del exf, xf, want, faulty
    with torch.no_grad():
        exact = md.expert_ffn_reference(ex, rows)
        scale = md.expert_ffn_rounding_scale(ex, rows)
    err, ratio = moe_held(y, exact, scale, torch.bfloat16)
    del exact, scale
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: md.fused_expert_ffn(ex, rows), 10)
        plain_ms = cuda_ms(lambda: md.expert_ffn_reference(ex, rows), 3)
        lib_ms = cuda_ms(lambda: bmm_chain(ex, rows), 10)
    exr = {n: w.detach().clone().requires_grad_(True) for n, w in ex.items()}
    xr = rows.detach().clone().requires_grad_(True)
    bwd_ms = backward_ms(lambda: md.fused_expert_ffn(exr, xr), cot)
    bound, bound_by = expert_ffn_bound(ex, rows)
    E, G, D = rows.shape
    log(f"[moe-train] (b) K7's Function on the exchange's layout at the "
        f"training shape (rows [{E}, {G}, {D}] bf16 at ep 1, "
        f"{int(filled.sum())} slots filled, F {cfg.block.ffn_dim}, GELU, "
        f"{md.expert_ffn_body(G, rows.dtype)} body): {launches} K7 launch "
        f"for the forward and backward; grad gaps to the f32 reference's "
        f"autograd " + ", ".join(f"{n} {v:.3e}" for n, v in gaps.items())
        + f" (tolerance {MOE_FN_TOL} of each leaf's largest |grad|); the "
        f"planted fault (the rows' cotangent dropped): rows gap "
        f"{fault_gap:.3e}; forward against the plain version: max abs err "
        f"{err:.3e}, tolerance ratio {ratio:.3f}; K7 forward {fwd_ms:.4f} ms "
        f"(bound {bound:.4f} ms, by {bound_by}; torch.bmm chain "
        f"{lib_ms:.4f} ms), the reference backward {bwd_ms:.3f} ms, the "
        f"plain f32 forward {plain_ms:.3f} ms — on {card}")
    if max(gaps.values()) > MOE_FN_TOL or ratio > 1.0 or launches != 1:
        fails.append(f"(b) K7: grads {gaps}, forward ratio {ratio}, "
                     f"launches {launches}")
    if not fault_gap > MOE_FN_TOL:
        fails.append(f"(b) K7: the planted rows fault passed "
                     f"({fault_gap:.3e})")
    return {"gaps": gaps, "fault_gap": fault_gap, "max_abs_err": err,
            "tol_ratio": ratio, "ms": fwd_ms, "backward_ms": bwd_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound,
            "bound_by": bound_by, "rows": [E, G, D]}


def moe_view_runs(cfg, batch, ref, card, fails):
    """(c) and (d), inside a one-rank NCCL data 1 x pipe 1 layout and its
    moe view (moe_dp 1 x moe_ep 1): ``DataParallel(axis=('moe_dp',
    'moe_ep'), grad_reduce_overrides=moe_grad_reduce_overrides())`` with
    ``ep_group`` — the sorted layout, the two exchanges and K7 under
    autograd.  One step that routes itself: its loss against the plain
    'sorted' arm's step 1, and the tokens it routes apart from that arm.
    One step that replays the 'sorted' arm's routing (:class:`RouteTap`):
    every grad leaf against that arm's step 1, which shares the layout
    and the combine, so what differs is K7, the exchanges and the
    overrides.  Then 3 steps each of the accumulating step (M 4), the MoE
    1F1B at one stage under ``DataParallel`` and under ZeRO over
    ``moe_dp``, against the accumulating step."""
    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.models import (
        gpt_moe_loss,
        gpt_moe_pipeline_1f1b,
        gpt_moe_pipeline_param_specs,
        init_gpt_moe_params,
    )
    from torchdistpackage_tpu_torch.parallel import (
        DataParallel,
        ZeroOptimizer,
        adamw,
    )
    from torchdistpackage_tpu_torch.parallel.moe import (
        moe_grad_reduce_overrides,
    )

    ep = tpc.get_group("moe_ep")
    ovr = moe_grad_reduce_overrides()
    m = MOE_TRAIN_M
    n_moe = len(ref["routes"]) // 2

    def fresh():
        return init_gpt_moe_params(
            cfg, torch.Generator(device="cuda").manual_seed(0))

    def lf(p, b):
        return gpt_moe_loss(p, b, cfg, remat="flash", ep_group=ep)

    def vg(p, b):
        return gpt_moe_pipeline_1f1b(p, b, cfg, m, ep_group=ep,
                                     remat="flash")

    dp = DataParallel(axis=("moe_dp", "moe_ep"), grad_reduce_overrides=ovr)

    def view_step(tap, tag):
        params = fresh()
        total = sum(p.numel() * p.element_size() for p in leaves_of(params))
        opt = adamw(3e-4)
        with tap:
            r = gated_steps(dp.make_train_step(lf, opt), params,
                            opt.init(params), batch, 1,
                            moe_expected(cfg, 1, k7=1), f"moe-train {tag}")
        r["bucketed"] = (dp.last_stats["bytes"], total,
                         dp.last_stats["buckets"])
        if dp.last_stats["bytes"] != total:
            fails.append(f"{tag}: {dp.last_stats['bytes']} of {total} B "
                         f"bucketed")
        r["loss_rel"] = (abs(r["losses"][0] - ref["losses"][0])
                         / abs(ref["losses"][0]))
        if r["loss_rel"] > MOE_VIEW_TOL["loss"]:
            fails.append(f"{tag}: loss {r['loss_rel']:.3e} off the 'sorted' "
                         f"arm's")
        r["gaps"] = grad_gaps(r.pop("grads1"), ref["grads1"], params)
        return r

    free_tap = RouteTap(limit=n_moe)
    c = view_step(free_tap, "(c)")
    pairs, kept = routes_apart(free_tap.calls, ref["routes"], n_moe)
    del free_tap
    pin_tap = RouteTap(replay=ref["routes"])
    cp = view_step(pin_tap, "(c) routing replayed")
    if pin_tap.n != len(ref["routes"]):
        fails.append(f"(c) routing replayed: {pin_tap.n} router calls, the "
                     f"'sorted' arm made {len(ref['routes'])}")
    gaps = cp["gaps"]
    worst = max(gaps, key=gaps.get)
    routers = [n for n in gaps if n.endswith("router/w")]
    T = MOE_TRAIN_BATCH * cfg.max_seq
    log(f"[moe-train] (c) DataParallel on the moe view (moe_dp 1 x moe_ep 1, "
        f"NCCL), ep_group: the sorted layout, two exchanges and K7 a block; "
        f"against the plain 'sorted' arm's step 1 ({ref['losses'][0]:.6f}; "
        f"K6's {ref['k6_loss']:.6f}). Routing itself: loss "
        f"{c['losses'][0]:.6f} (relative {c['loss_rel']:.3e}, tolerance "
        f"{MOE_VIEW_TOL['loss']}; to K6's "
        f"{abs(c['losses'][0] - ref['k6_loss']) / abs(ref['k6_loss']):.3e});"
        f" tokens routed apart from the 'sorted' arm by expert block, of "
        f"{T}: expert pair " + ", ".join(map(str, pairs)) + "; kept experts "
        + ", ".join(map(str, kept)) + f"; largest grad gaps "
        f"{top_gaps(c['gaps'], routers)}, the routers' "
        + ", ".join(f"{c['gaps'][n]:.3e}" for n in routers) + ". Routing "
        f"replayed: loss {cp['losses'][0]:.6f} (relative "
        f"{cp['loss_rel']:.3e}); largest grad gaps {top_gaps(gaps, routers)}"
        f", the routers' " + ", ".join(f"{gaps[n]:.3e}" for n in routers)
        + f" over {len(gaps)} leaves (tolerance {MOE_VIEW_TOL['grad']} of "
        f"each leaf's largest |grad|; the largest {worst} "
        f"{gaps[worst]:.3e}); bucketed {cp['bucketed'][0]} of "
        f"{cp['bucketed'][1]} B in {cp['bucketed'][2]} buckets; launches a "
        f"step {cp['launches']}; peak {cp['peak_gb']:.3f} GB — on {card}")
    if gaps[worst] > MOE_VIEW_TOL["grad"]:
        fails.append(f"(c) routing replayed: grad {gaps[worst]:.3e} "
                     f"({worst}) off the 'sorted' arm's")
    out = {"c": {"loss_rel": c["loss_rel"], "routes_apart": pairs,
                 "kept_apart": kept, "free_gaps": c["gaps"],
                 "launches": c["launches"], "peak_gb": c["peak_gb"]},
           "c_pinned": {"loss_rel": cp["loss_rel"], "grad_gap": gaps[worst],
                        "worst": worst, "gaps": gaps,
                        "launches": cp["launches"]}}
    del c, cp
    gc.collect()
    torch.cuda.empty_cache()

    pbatch = microbatched(batch, m)
    runs = {}
    for kind in ("accum", "1f1b", "zero_1f1b"):
        params = fresh()
        opt = adamw(3e-4)
        b = pbatch
        if kind == "accum":
            state = opt.init(params)
            step = dp.make_train_step(lf, opt, grad_accum_iters=m)
            b = batch
        elif kind == "1f1b":
            state = opt.init(params)
            step = dp.make_train_step(
                value_and_grad_fn=vg, optimizer=opt,
                pipe_specs=gpt_moe_pipeline_param_specs(params))
        else:
            zero = ZeroOptimizer(opt, shard_axis="moe_dp",
                                 grad_reduce_axes=("moe_dp", "moe_ep"),
                                 grad_reduce_overrides=ovr,
                                 param_dtype=cfg.dtype,
                                 pipe_specs=gpt_moe_pipeline_param_specs(
                                     params))
            params = zero.place_params(params)
            state = zero.init(params)
            step = zero.make_train_step(value_and_grad_fn=vg)
        r = gated_steps(step, params, state, b, 3,
                        moe_expected(cfg, m, k7=1), f"moe-train (d) {kind}",
                        keep_grads=False)
        runs[kind] = {"losses": r["losses"], "ms": median_ms(r["times"], 1),
                      "peak_gb": r["peak_gb"], "launches": r["launches"]}
        del r, params, state, step
        gc.collect()
        torch.cuda.empty_cache()
    ref_l = runs["accum"]["losses"]
    frozen = frozen_gap(ref_l)
    for kind, tol in (("1f1b", PIPE_LOSS_TOL), ("zero_1f1b", MOE_ZERO_TOL)):
        r = runs[kind]
        r["gap"] = max(abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                           ref_l))
        log(f"[moe-train] (d) {kind} (M {m} x {MOE_TRAIN_BATCH // m} rows, "
            f"one stage, "
            f"{'ZeroOptimizer over moe_dp' if kind == 'zero_1f1b' else 'DataParallel'}"
            f"): losses " + ", ".join(f"{x:.6f}" for x in r["losses"])
            + f"; largest relative gap to the accumulating step's "
            + ", ".join(f"{x:.6f}" for x in ref_l) + f" {r['gap']:.3e} "
            f"(tolerance {tol}; a state that never moved would read "
            f"{frozen:.3e}); step median {r['ms']:.2f} ms (accumulating "
            f"{runs['accum']['ms']:.2f}); launches a step {r['launches']}; "
            f"peak {r['peak_gb']:.3f} GB (accumulating "
            f"{runs['accum']['peak_gb']:.3f}) — on {card}")
        if r["gap"] > tol:
            fails.append(f"(d) {kind}: losses {r['gap']:.3e} off")
        if not tol < frozen:
            fails.append(f"(d) {kind}: tolerance {tol} cannot tell a state "
                         f"that never moved ({frozen:.3e})")
    runs["frozen_gap"] = frozen
    out["d"] = runs
    return out


def moe_train_launches(run, kernel):
    """``kernel``'s launches a step in each of :func:`moe_train_phase`'s
    runs."""
    return {"serial_k6": run["a"]["launches"][kernel],
            "serial_k6_routing_replayed":
                run["a_pinned"]["launches"][kernel],
            "serial_sorted": run["plain"]["launches"][kernel],
            "moe_view": run["c"]["launches"][kernel],
            "moe_view_routing_replayed": run["c_pinned"]["launches"][kernel],
            **{k: v["launches"][kernel] for k, v in run["d"].items()
               if k != "frozen_gap"}}


def moe_train_phase(card):
    """MoE training on the card at ``bench.py``'s ``--moe`` leaf (GPT-MoE
    8x125M, batch 8, S 2048, bf16, remat 'flash'): (a) the serial step
    through K6 under autograd, 10 AdamW steps, against 3 steps of the
    plain ``'sorted'`` arm, and one K6 step that replays that arm's
    routing (:class:`RouteTap`), every grad leaf against the arm's; (b)
    K6's and K7's Functions at one expert block of the training shape
    against the f32 oracles, each with a planted fault; (c) the moe
    view's ``DataParallel`` with ``ep_group`` (K7 under autograd) against
    the 'sorted' arm's step 1; (d) the accumulating step, the one-stage
    MoE 1F1B and ZeRO over ``moe_dp`` x 1F1B (the multi-rank exchanges
    are held on the CPU: tests/test_torch_moe_train_dist.py).  Every gate
    is read before the phase raises, naming each that failed."""
    t_phase = time.perf_counter()
    fails = []
    cfg = gpt_moe_8x125m()
    n_moe = sum(1 for i in range(cfg.nlayers)
                if i % cfg.moe_every == cfg.moe_every - 1)
    batch = random_batch(cfg, MOE_TRAIN_BATCH, 1)
    a_tap = RouteTap(limit=n_moe)
    a = moe_serial(cfg, batch, 10, card, tap=a_tap)
    tokens = MOE_TRAIN_BATCH * cfg.max_seq
    step_s = float(np.median(a["times"][3:]))
    fpt = 6 * a["matmul_params"] + 12 * cfg.nlayers * cfg.max_seq * cfg.dim
    mfu = fpt * tokens / step_s / PEAK_FLOPS[torch.bfloat16]
    log(f"[moe-train] (a) GPT-MoE 8x125M (bench.py's --moe leaf: "
        f"{a['num_params'] / 1e9:.4f} B parameters, "
        f"{a['matmul_params'] / 1e6:.1f} M a token by bench.py's accounting),"
        f" batch {MOE_TRAIN_BATCH}, S {cfg.max_seq}, bf16, remat 'flash', "
        f"moe_dispatch 'auto' (K6 under autograd): losses "
        + ", ".join(f"{x:.4f}" for x in a["losses"]))
    log(f"[moe-train] (a) step median {step_s * 1e3:.2f} ms after 3 warm-up "
        f"steps (all: " + ", ".join(f"{t * 1e3:.1f}" for t in a["times"])
        + f" ms); {tokens / step_s:.0f} tokens/s; MFU {mfu:.4f} (6N + 12LSD "
        f"= {fpt / 1e6:.1f} MFLOP a token against 989 TFLOP/s); peak memory "
        f"{a['peak_gb']:.3f} GB; launches a step {a['launches']} — on {card}")
    s_tap = RouteTap(limit=2 * n_moe)  # the forward and the recompute
    plain = moe_serial(gpt_moe_8x125m("sorted"), batch, 3, card, tap=s_tap)
    pairs, kept = routes_apart(a_tap.calls, s_tap.calls, n_moe)
    del a_tap
    plain_gaps = grad_gaps(a["grads1"], plain["grads1"], a["params"])
    routers = [n for n in plain_gaps if n.endswith("router/w")]
    gap = max(abs(x - y) / abs(y) for x, y in zip(a["losses"][:3],
                                                  plain["losses"]))
    frozen = frozen_gap(plain["losses"])
    log(f"[moe-train] (a) the plain 'sorted' arm from the same start: losses "
        + ", ".join(f"{x:.6f}" for x in plain["losses"]) + " against K6's "
        + ", ".join(f"{x:.6f}" for x in a["losses"][:3])
        + f": largest relative gap {gap:.3e} (tolerance {MOE_LOSS_TOL}; a "
        f"state that never moved would read {frozen:.3e}); step median "
        f"{median_ms(plain['times'], 1):.2f} ms; launches a step "
        f"{plain['launches']}; peak {plain['peak_gb']:.3f} GB; step 1: "
        f"tokens routed apart from K6's by expert block, of {tokens}: "
        f"expert pair " + ", ".join(map(str, pairs)) + "; kept experts "
        + ", ".join(map(str, kept)) + "; K6's grad gaps to the arm's: "
        f"routers " + ", ".join(f"{plain_gaps[n]:.3e}" for n in routers)
        + "; the largest of the other leaves "
        + top_gaps(plain_gaps, routers) + f" — on {card}")
    if gap > MOE_LOSS_TOL or not a["losses"][-1] < a["losses"][0]:
        fails.append(f"(a): losses {gap:.3e} off the plain arm, or not "
                     f"falling: {a['losses']}")
    if not MOE_LOSS_TOL < frozen:
        fails.append(f"(a): tolerance {MOE_LOSS_TOL} cannot tell a state "
                     f"that never moved ({frozen:.3e})")
    out = {"a": {k: a[k] for k in ("losses", "launches", "peak_gb",
                                    "num_params", "matmul_params")},
           "plain": {k: plain[k] for k in ("losses", "launches", "peak_gb")}}
    out["a"].update(step_ms=step_s * 1e3, tokens_per_s=tokens / step_s,
                    mfu=mfu, plain_gap=gap, frozen_gap=frozen,
                    plain_step_ms=median_ms(plain["times"], 1),
                    plain_grad_gaps=plain_gaps, routes_apart=pairs,
                    kept_apart=kept)
    del a
    gc.collect()
    torch.cuda.empty_cache()
    pin_tap = RouteTap(replay=s_tap.calls)
    ap = moe_serial(cfg, batch, 1, card, tap=pin_tap)
    pin_gaps = grad_gaps(ap["grads1"], plain["grads1"], ap["params"])
    pin_rel = abs(ap["losses"][0] - plain["losses"][0]) / abs(
        plain["losses"][0])
    worst = max(pin_gaps, key=pin_gaps.get)
    log(f"[moe-train] (a) K6 replaying the 'sorted' arm's routing, one step: "
        f"loss {ap['losses'][0]:.6f} against the arm's "
        f"{plain['losses'][0]:.6f} (relative {pin_rel:.3e}); grad gaps: "
        f"routers " + ", ".join(f"{pin_gaps[n]:.3e}" for n in routers)
        + "; the largest of the other leaves " + top_gaps(pin_gaps, routers)
        + f" (tolerance {MOE_VIEW_TOL['grad']} of each leaf's largest "
        f"|grad|); {pin_tap.n} router calls replayed; launches a step "
        f"{ap['launches']} — on {card}")
    if (pin_gaps[worst] > MOE_VIEW_TOL["grad"]
            or pin_rel > MOE_VIEW_TOL["loss"]
            or pin_tap.n != len(s_tap.calls)):
        fails.append(f"(a) routing replayed: grad {pin_gaps[worst]:.3e} "
                     f"({worst}), loss {pin_rel:.3e}, {pin_tap.n} router "
                     f"calls of {len(s_tap.calls)}")
    out["a_pinned"] = {"loss_rel": pin_rel, "gaps": pin_gaps,
                       "grad_gap": pin_gaps[worst], "worst": worst,
                       "launches": ap["launches"]}
    ref = {"losses": plain["losses"], "grads1": plain["grads1"],
           "routes": s_tap.calls, "k6_loss": out["a"]["losses"][0]}
    del ap, plain, pin_tap, s_tap
    gc.collect()
    torch.cuda.empty_cache()
    out["b"] = {"K6": moe_fn_check(cfg, card, fails)}
    gc.collect()
    torch.cuda.empty_cache()
    out["b"]["K7"] = expert_fn_check(cfg, card, fails)
    gc.collect()
    torch.cuda.empty_cache()
    with one_rank_layout("moe-train", [("data", 1), ("pipe", 1)],
                         moe_ep=True):
        out.update(moe_view_runs(cfg, batch, ref, card, fails))
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[moe-train] phase done in {out['seconds']:.1f} s")
    if fails:
        raise RuntimeError("moe-train: " + "; ".join(fails))
    return out


# ------------------------------------------- ViT and context parallelism

VIT_BATCH = 128        # vit_train_phase: images a step
VIT_LOSS_TOL = 2e-3    # relative loss: the flash step against the 'naive' one
VIT_LOGIT_TOL = 0.05   # of the largest |logit|: the same forward's logits
CP_SEQ = 8192          # cp_train_phase (b): the sequence, 4096 a rank
CP_BATCH = 2           # (b): rows
CP_RANKS = 2           # (b): two processes on the one card, gloo between
CP_ONE_RANK_BATCH = 4  # (a): rows of S 2048
CP_LOSS_TOL = 1e-3     # (b): relative loss against the serial step
CP_GRAD_TOL = 0.02     # (b): of each compared grad leaf's largest |value|
#: (b): the attention op alone — its output and q / k / v grads against
#: one serial flash call on the whole sequence, each within this share of
#: the serial value's largest |value|; q scaled by CP_OP_Q_SCALE so the
#: softmax is peaked and the hops' logsumexps differ (at a random model's
#: near-uniform attention the lse cotangent hardly moves the grads)
CP_OP_TOL = 0.02
CP_OP_Q_SCALE = 3.0
#: (b): the grads held (the position table sees the shard positions, the
#: attention weights every hop, the head the loss)
CP_LEAVES = ("pos_emb", "head", "blocks/attn/wqkv")
#: (b): the K3 launches a rank a layer by hop arithmetic at cp 2 — the
#: contiguous ring's rank 0 computes its diagonal hop, rank 1 that and
#: one past hop; zigzag 2 cp + 1 half-sized calls on each rank; Ulysses
#: one call at H / 2 heads
CP_K3_A_LAYER = {"ring": (1, 2), "zigzag": (5, 5), "ulysses": (1, 1)}
VIT_CP_BATCH = 16      # (b): ViT-B/16 images under ring CP


def vit_b16(**kw):
    """ViT-B/16 at its published widths (Dosovitskiy et al., ICLR 2021,
    Table 1): image 224, patch 16 (196 patches), d 768, 12 heads, 12
    layers, MLP 3072, 1000 classes; bf16, flash attention."""
    from torchdistpackage_tpu_torch.models import ViTConfig

    return ViTConfig(**dict(dict(
        image_size=224, patch_size=16, channels=3, num_classes=1000,
        dim=768, nheads=12, nlayers=12, ffn_mult=4, dtype=torch.bfloat16,
        attn_impl="flash"), **kw))


def vit_batch(cfg, rows, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return {"images": torch.randn(rows, cfg.image_size, cfg.image_size,
                                  cfg.channels, generator=g,
                                  device="cuda").to(cfg.dtype),
            "labels": torch.randint(0, cfg.num_classes, (rows,),
                                    generator=g, device="cuda")}


def cp_kernel_rows():
    """K3-K5 at the shapes the new paths give them, against their plain
    versions row by row in f32: ViT-B/16's attention (B 128, H 12, S 196,
    hd 64, non-causal; the cotangent on o only, as its blocks give it) and
    one ring hop of ``cp_train_phase``'s GPT (B 2, H 12, S 4096 a rank,
    hd 64; the diagonal hop causal, a past hop non-causal; a live lse
    cotangent, as the hops' combine gives it), bf16; each timed beside
    its plain version, SDPA and its bound (operations)."""
    from torchdistpackage_tpu_torch.ops import flash_attention as fa

    bf = torch.bfloat16
    specs = [("vit_b16_bf16", dict(B=VIT_BATCH, H=12, Hkv=12, S=196, hd=64,
                                   causal=False), False),
             ("ring_hop_diagonal_bf16", dict(B=CP_BATCH, H=12, Hkv=12,
                                             S=CP_SEQ // CP_RANKS, hd=64,
                                             causal=True), True),
             ("ring_hop_past_bf16", dict(B=CP_BATCH, H=12, Hkv=12,
                                         S=CP_SEQ // CP_RANKS, hd=64,
                                         causal=False), True)]
    rows = {n: [] for n in fa.LAUNCHES}
    for i, (name, spec, with_dlse) in enumerate(specs):
        case = flash_case(name, window=None, dtype=bf, seed=500 + i, **spec)
        q, k, v, do = (case[n] for n in ("q", "k", "v", "do"))
        args = (case["scale"], spec["causal"], None)
        dlse = case["dlse"] if with_dlse else None
        exact = [t.float() for t in (q, k, v, do)]
        o_x, lse_x = fa.flash_fwd_reference(*exact[:3], *args)
        delta = fa.flash_delta(o_x, exact[3], dlse)
        o, lse = fa.flash_fwd(q, k, v, *args)
        dq = fa.flash_bwd_dq(q, k, v, do, lse_x, delta, *args)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_x, delta, *args)
        torch.cuda.synchronize()
        dq_x = fa.flash_bwd_dq_reference(*exact, lse_x, delta, *args)
        dk_x, dv_x = fa.flash_bwd_dkv_reference(*exact, lse_x, delta, *args)
        sq, sk, sv = fa.grad_rounding_scale(*exact, lse_x, delta, *args)
        lse_err = float((lse - lse_x).abs().max())
        checks = {"flash_fwd": [held(o, o_x, bf), (lse_err, lse_err / 2e-5)],
                  "flash_bwd_dq": [grad_held(dq, dq_x, sq, bf)],
                  "flash_bwd_dkv": [grad_held(dk, dk_x, sk, bf),
                                    grad_held(dv, dv_x, sv, bf)]}
        del o, lse, dq, dk, dv, dq_x, dk_x, dv_x, sq, sk, sv
        torch.cuda.empty_cache()
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
        lib_fwd, lib_bwd = sdpa_flash_ms(case, 10)
        bounds = flash_bounds(case)
        for kname, res in checks.items():
            err, ratio = max(r[0] for r in res), max(r[1] for r in res)
            ms, plain_ms = cuda_ms(kern[kname], 10), cuda_ms(plain[kname], 3)
            lib = lib_fwd if kname == "flash_fwd" else lib_bwd
            bound_ms, bound_by, flops = bounds[kname]
            log(f"[cp-kernels] {name} {kname} (B {spec['B']}, H 12, S "
                f"{spec['S']}, hd 64, {'causal' if spec['causal'] else 'non-causal'}"
                f"{', lse cotangent' if with_dlse else ''}): vs the plain "
                f"version in f32: max abs err {err:.3g}, {ratio:.3f} of the "
                f"row tolerance; kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                f"TFLOP/s)  plain {plain_ms:.4f} ms  sdpa "
                f"{'fwd' if kname == 'flash_fwd' else 'bwd'} {lib:.4f} ms  "
                f"bound {bound_ms:.4f} ms ({bound_by})")
            if not ratio <= 1.0:
                raise RuntimeError(
                    f"{name}: {kname} disagrees with its plain version: "
                    f"{ratio:.3f} of the row tolerance")
            rows[kname].append({
                "case": name, "body": "wgmma, TMA-fed tiles",
                "max_abs_err": err, "tol_ratio": ratio, "ms": ms,
                "plain_ms": plain_ms, "library_ms": lib, "bound_ms": bound_ms,
                "bound_by": bound_by, "tflops": flops / ms / 1e9})
        del case, q, k, v, do, exact, o_x, lse_x, delta, plain, kern
        torch.cuda.empty_cache()
    return rows


def vit_forward_logits(params, batch, cfg):
    from torchdistpackage_tpu_torch.models import vit_forward

    with torch.no_grad():
        return vit_forward(params, batch["images"], cfg).float()


def vit_train_phase(card):
    """ViT-B/16 training on the card (batch 128, bf16, flash attention,
    remat 'flash'): the first step's forward held against the same
    weights' 'naive' forward (loss and logits), with a planted fault (K3
    run causally) that must fail the gate; then 8 AdamW steps, the counts
    set to 0 before and read after each (K3 / K4 / K5 12 a step); the step
    median after 3 warm-ups, images/s, MFU and peak memory."""
    import dataclasses as dc

    from torchdistpackage_tpu_torch.models import init_vit_params, vit_loss
    from torchdistpackage_tpu_torch.ops import flash_attention as fa
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        adamw,
        make_train_step,
    )

    t_phase = time.perf_counter()
    cfg = vit_b16()
    params = init_vit_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0))
    batch = vit_batch(cfg, VIT_BATCH, 1)

    def held_to_naive(logits, want):
        loss = F.cross_entropy(logits, batch["labels"])
        ref = F.cross_entropy(want, batch["labels"])
        return (float(abs(loss - ref) / abs(ref)),
                float((logits - want).abs().max() / want.abs().max()))

    naive = vit_forward_logits(params, batch, dc.replace(cfg,
                                                         attn_impl="naive"))
    got = held_to_naive(vit_forward_logits(params, batch, cfg), naive)
    real = fa.flash_attention
    fa.flash_attention = lambda q, k, v, causal=True, **kw: real(
        q, k, v, causal=True, **kw)
    try:
        fault = held_to_naive(vit_forward_logits(params, batch, cfg), naive)
    finally:
        fa.flash_attention = real
    sound = got[0] <= VIT_LOSS_TOL and got[1] <= VIT_LOGIT_TOL
    caught = fault[0] > VIT_LOSS_TOL or fault[1] > VIT_LOGIT_TOL
    log(f"[vit-train] ViT-B/16 ({cfg.num_params() / 1e6:.2f} M parameters), "
        f"batch {VIT_BATCH}: the flash forward against the same weights' "
        f"'naive' one: loss {got[0]:.3e} relative (tolerance "
        f"{VIT_LOSS_TOL}), logits {got[1]:.3e} of the largest (tolerance "
        f"{VIT_LOGIT_TOL}); the planted fault (K3 run causally): loss "
        f"{fault[0]:.3e}, logits {fault[1]:.3e} — "
        f"{'caught' if caught else 'NOT caught'} by the gate")
    if not sound or not caught:
        raise RuntimeError(f"vit-train: flash vs naive {got}, planted fault "
                           f"{fault}: the gate must pass the one and fail "
                           f"the other")
    del naive
    opt = adamw(3e-4)
    state = opt.init(params)
    step = make_train_step(lambda p, b: vit_loss(p, b, cfg, remat="flash"),
                           opt)
    steps, warmup = 8, 3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, times = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss, _ = step(params, state, batch)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
        want = cfg.nlayers * (i + 1)
        if any(n != want for n in fa.LAUNCHES.values()):
            raise RuntimeError(f"vit-train: flash launches {dict(fa.LAUNCHES)}"
                               f" after step {i + 1}, want {want} each")
    launches = {n: c // steps for n, c in fa.LAUNCHES.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"vit-train: losses not finite and falling: "
                           f"{losses}")
    step_s = float(np.median(times[warmup:]))
    S = cfg.num_patches
    fpt = 6 * matmul_params(params) + 12 * cfg.nlayers * S * cfg.dim
    mfu = fpt * VIT_BATCH * S / step_s / PEAK_FLOPS[torch.bfloat16]
    log(f"[vit-train] ViT-B/16, batch {VIT_BATCH} ({S} patches an image), "
        f"bf16, flash, remat 'flash', AdamW: losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f"; step median {step_s * 1e3:.2f} ms after {warmup} warm-up steps "
        f"(all: " + ", ".join(f"{t * 1e3:.1f}" for t in times)
        + f" ms); {VIT_BATCH / step_s:.1f} images/s; MFU {mfu:.4f} (6N + "
        f"12LSD = {fpt / 1e6:.1f} MFLOP a patch against 989 TFLOP/s); peak "
        f"memory {peak_gb:.3f} GB; launches a step {launches} — on {card}")
    del params, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"step_ms": step_s * 1e3, "images_per_s": VIT_BATCH / step_s,
            "mfu": mfu, "peak_gb": peak_gb, "launches": launches,
            "losses": losses, "naive_gap": got, "fault_gap": fault,
            "seconds": time.perf_counter() - t_phase}


def moe_layer_times(cfg, T, card, tag):
    """One expert layer of ``cfg`` on T random bf16 tokens: K6's forward
    alone (``fused_moe_ffn`` on a fixed routing) beside its bound, and the
    layer's forward through ``moe_forward`` on the K6 arm and on the plain
    ``'sorted'`` arm (router, dispatch, experts, combine) — the arm's the
    yardstick: one PyTorch index_add, a bmm chain and a gather."""
    from torchdistpackage_tpu_torch.models import moe_layer_config
    from torchdistpackage_tpu_torch.ops import moe_dispatch as md
    from torchdistpackage_tpu_torch.parallel.moe import (
        _top_k_route,
        init_moe_params,
        moe_forward,
    )

    g = torch.Generator(device="cuda").manual_seed(41)
    mcfg = moe_layer_config(cfg)
    layer = init_moe_params(g, mcfg, device="cuda")
    ex = layer["experts"]
    D, Fd, E, k = cfg.dim, cfg.block.ffn_dim, cfg.moe_experts, cfg.moe_top_k
    C = int(np.ceil(T * k * cfg.moe_capacity_factor / E))
    x = torch.randn(T, D, generator=g, device="cuda").to(cfg.dtype)
    probs = torch.softmax(torch.randn(T, E, generator=g, device="cuda") * 2,
                          -1)
    gv, gi, slot, keep = _top_k_route(probs, k, C)
    with torch.no_grad():
        k6_ms = cuda_ms(lambda: md.fused_moe_ffn(ex, x, gv, gi, slot, keep,
                                                 C), 10)
        arms = {}
        for disp in ("cuda", "sorted"):
            c = dataclasses.replace(mcfg, dispatch=disp)
            arms[disp] = cuda_ms(lambda: moe_forward(layer, x[None], c), 10)
    filled = int(keep.sum())
    flops = 2 * filled * 2 * D * Fd
    t_ops = flops / PEAK_FLOPS[torch.bfloat16]
    t_bytes = (sum(t.numel() * t.element_size() for t in ex.values())
               + 2 * x.numel() * x.element_size()) / HBM_BYTES_PER_S
    bound, bound_by = max(t_ops, t_bytes) * 1e3, (
        "operations" if t_ops >= t_bytes else "bytes")
    log(f"[{tag}] one expert layer, T {T} tokens, E {E}, top-{k}, C "
        f"{C}, D {D}, F {Fd} ({filled} slots filled): K6 forward "
        f"{k6_ms:.4f} ms ({flops / k6_ms / 1e9:.1f} TFLOP/s; bound "
        f"{bound:.4f} ms, {bound_by}); the layer through moe_forward: K6 "
        f"arm {arms['cuda']:.4f} ms, plain 'sorted' arm {arms['sorted']:.4f}"
        f" ms — on {card}")
    return {"T": T, "C": C, "filled": filled, "ms": k6_ms, "bound_ms": bound,
            "bound_by": bound_by, "k6_layer_ms": arms["cuda"], "sorted_layer_ms": arms["sorted"]}


def vit_moe_train_phase(card):
    """ViT-MoE at ViT-B/16's widths with 8 experts, top-2, every 2nd
    block (6 expert blocks), capacity 1.25, aux 1e-2 (the JAX
    ``ViTConfig``'s MoE defaults with 8 experts), batch 128: the top-k
    router through K6 under autograd (``'auto'``), its first forward
    held against the plain ``'sorted'`` arm's on the same weights, then 5
    AdamW steps (K3-K5 12, K6 12 a step: the forward and the recompute of
    each expert block); the expert-choice router on its plain arm (one
    step, K6 0); and one expert layer's K6 forward at T 128 x 196 and at
    the GPT-MoE training shape (T 16384) beside the 'sorted' arm."""
    import dataclasses as dc

    from torchdistpackage_tpu_torch.models import (
        init_vit_moe_params,
        vit_moe_loss,
    )
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        adamw,
        make_train_step,
    )

    t_phase = time.perf_counter()
    cfg = vit_b16(moe_experts=8, moe_top_k=2, moe_every=2,
                  moe_capacity_factor=1.25, moe_aux_weight=1e-2)
    n_moe = sum(1 for i in range(cfg.nlayers)
                if i % cfg.moe_every == cfg.moe_every - 1)
    params = init_vit_moe_params(cfg, torch.Generator(device="cuda")
                                 .manual_seed(0))
    batch = vit_batch(cfg, VIT_BATCH, 1)
    with torch.no_grad():
        first = float(vit_moe_loss(params, batch, cfg))
        sorted_first = float(vit_moe_loss(
            params, batch, dc.replace(cfg, moe_dispatch="sorted")))
    gap = abs(first - sorted_first) / abs(sorted_first)
    opt = adamw(3e-4)
    state = opt.init(params)
    step = make_train_step(
        lambda p, b: vit_moe_loss(p, b, cfg, remat="flash"), opt)
    want = moe_expected(cfg, 1, k6=1)
    run = gated_steps(step, params, state, batch, 5, want, "vit-moe-train",
                      keep_grads=False)
    step_s = float(np.median(run["times"][2:]))
    S = cfg.num_patches
    fpt = 6 * moe_matmul_params(params, cfg) + 12 * cfg.nlayers * S * cfg.dim
    mfu = fpt * VIT_BATCH * S / step_s / PEAK_FLOPS[torch.bfloat16]
    log(f"[vit-moe-train] ViT-MoE-B/16 (8 experts, top-2, every 2nd block: "
        f"{n_moe} expert blocks, capacity 1.25, aux 1e-2), batch "
        f"{VIT_BATCH}, bf16, remat 'flash', top-k through K6: first loss "
        f"{first:.6f} against the 'sorted' arm's {sorted_first:.6f} "
        f"(relative {gap:.3e}, tolerance {MOE_LOSS_TOL}); losses "
        + ", ".join(f"{x:.4f}" for x in run["losses"])
        + f"; step median {step_s * 1e3:.2f} ms after 2 warm-up steps (all: "
        + ", ".join(f"{t * 1e3:.1f}" for t in run["times"])
        + f" ms); {VIT_BATCH / step_s:.1f} images/s; MFU {mfu:.4f}; peak "
        f"{run['peak_gb']:.3f} GB; launches a step {want} — on {card}")
    fails = []
    if gap > MOE_LOSS_TOL or not run["losses"][-1] < run["losses"][0]:
        fails.append(f"top-k: first loss {gap:.3e} off the 'sorted' arm or "
                     f"losses not falling {run['losses']}")
    del state, step, run
    gc.collect()
    torch.cuda.empty_cache()
    ec = dc.replace(cfg, moe_router="expert_choice")
    opt = adamw(3e-4)
    state = opt.init(params)
    ec_run = gated_steps(make_train_step(
        lambda p, b: vit_moe_loss(p, b, ec, remat="flash"), opt), params,
        state, batch, 1, moe_expected(ec, 1), "vit-moe-train EC",
        keep_grads=False)
    log(f"[vit-moe-train] the expert-choice router (the plain arm, as the "
        f"reference): loss {ec_run['losses'][0]:.4f}; launches a step "
        f"{ec_run['launches']} — on {card}")
    del params, state, ec_run
    gc.collect()
    torch.cuda.empty_cache()
    shape = moe_layer_times(cfg, VIT_BATCH * S, card, "vit-moe-train")
    gpt_moe = gpt_moe_8x125m()
    gpt_shape = moe_layer_times(gpt_moe, MOE_TRAIN_BATCH * gpt_moe.max_seq,
                                card, "vit-moe-train: GPT-MoE 8x125M's")
    if fails:
        raise RuntimeError("vit-moe-train: " + "; ".join(fails))
    return {"step_ms": step_s * 1e3, "images_per_s": VIT_BATCH / step_s,
            "mfu": mfu, "first_gap": gap, "launches": want,
            "ec_launches": moe_expected(ec, 1), "shape": shape,
            "gpt_moe_shape": gpt_shape,
            "seconds": time.perf_counter() - t_phase}


def npz_key(path):
    return path.replace("/", ".")


def grads_of(loss, params, names=None):
    """``{path: grad}`` of ``loss`` for the leaves of ``params`` (all, or
    those whose '/'-joined path is in ``names``)."""
    from torchdistpackage_tpu_torch.utils.partition import named_leaves

    pairs = [(n, p) for n, p in named_leaves(params)
             if names is None or n in names]
    grads = torch.autograd.grad(loss, [p for _, p in pairs])
    return {n: g for (n, _), g in zip(pairs, grads)}


def cp_one_rank(card):
    """(a) of :func:`cp_train_phase`: GPT-125M (batch 4, S 2048, bf16,
    remat 'flash') over a one-rank NCCL context group with ``'ring'`` and
    ``'ulysses'`` against the ``'flash'`` step: one hop is the same K3
    call, the all-to-alls move nothing, so the loss and every grad must
    be the flash step's bit for bit, and K3 / K4 / K5 launch 12 times
    each."""
    import dataclasses as dc

    from torchdistpackage_tpu_torch.models import gpt_loss, init_gpt_params
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves
    from torchdistpackage_tpu_torch.ops import flash_attention as fa

    cfg = gpt_125m()
    params = init_gpt_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    batch = random_batch(cfg, CP_ONE_RANK_BATCH, 1)
    out, bad = {}, []
    with one_rank_layout("cp-train", [("data", 1), ("context", 1)]) as ctx:
        cp = ctx.get_group("context")
        ref = None
        for impl in ("flash", "ring", "ulysses"):
            c = dc.replace(cfg, attn_impl=impl)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = gpt_loss(params, batch, c, remat="flash",
                            cp_group=None if impl == "flash" else cp)
            grads = grads_of(loss, params)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = dict(fa.LAUNCHES)
            if ref is None:
                ref = (loss.detach(), grads)
                same = True
            else:
                same = torch.equal(loss, ref[0]) and all(
                    torch.equal(grads[n], ref[1][n]) for n in grads)
            out[impl] = {"loss": float(loss.detach()), "bit_identical": same,
                         "launches": launches, "ms": ms}
            log(f"[cp-train] (a) GPT-125M, batch {CP_ONE_RANK_BATCH}, S "
                f"{cfg.max_seq}, attn_impl {impl!r} over a one-rank NCCL "
                f"context group: loss {float(loss.detach()):.6f}, forward and "
                f"backward {ms:.1f} ms; launches {launches}; loss and all "
                f"{len(grads)} grads bit-identical to the 'flash' step: "
                f"{same} — on {card}")
            if not same or any(v != cfg.nlayers for v in launches.values()):
                bad.append(f"(a) {impl}: bit-identical {same}, launches "
                           f"{launches}")
            del loss, grads
    del params, ref
    gc.collect()
    torch.cuda.empty_cache()
    return out, bad


def cp_rank(rank, world, port, tmp):
    """One rank of :func:`cp_train_phase` (b) in its own process: a
    context group of ``world`` over gloo on the loopback (NCCL puts no
    two ranks of a communicator on one card; the ring's sends and
    Ulysses' all-to-alls go through the host), the flash kernels from
    the parent's build.  GPT-125M at S 8192 (this rank's 4096) from the
    parent's seed, remat 'flash': the ring contiguous and zigzag and
    Ulysses, each a forward and backward with K3-K5 counted, the loss and
    the ``CP_LEAVES`` grads averaged over the group against the parent's
    serial step (``ref.npz``), a second call timed; the three planted
    faults; then ViT-B/16 under the ring (98 patches a rank), whose grads
    come out whole on every rank.  Writes ``rank<r>.json``."""
    import datetime
    import importlib

    import torch.distributed as dist

    from torchdistpackage_tpu_torch.dist import tpc
    from torchdistpackage_tpu_torch.models import (
        gpt_loss,
        init_gpt_params,
        init_vit_params,
        vit_loss,
    )
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves
    from torchdistpackage_tpu_torch.ops import _build
    from torchdistpackage_tpu_torch.ops import flash_attention as fa
    from torchdistpackage_tpu_torch.parallel.tensor_parallel.tp_utils import (
        HOST_STAGING,
    )

    ra = importlib.import_module(
        "torchdistpackage_tpu_torch.ops.ring_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        _build.load_all(["flash_attention"])
        tpc.setup_process_groups([("context", world)])
        cp = tpc.get_group("context")
        ref = np.load(Path(tmp) / "ref.npz")
        cfg = dataclasses.replace(gpt_125m(), max_seq=CP_SEQ)
        params = init_gpt_params(cfg, torch.Generator(device="cuda")
                                 .manual_seed(0))
        for p in tree_leaves(params):
            p.requires_grad_(True)
        full = random_batch(cfg, CP_BATCH, 1)
        s = CP_SEQ // world

        def shard(batch, zig):
            if zig:
                batch = {k: ra.zigzag_permute(v, world, 1)
                         for k, v in batch.items()}
            return {k: v[:, rank * s:(rank + 1) * s] for k, v in
                    batch.items()}

        def run(impl, layout, zig, timed=True):
            c = dataclasses.replace(cfg, attn_impl=impl, cp_layout=layout)
            b = shard(full, zig)
            reset_counts()
            for k in HOST_STAGING:
                HOST_STAGING[k] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = gpt_loss(params, b, c, remat="flash", cp_group=cp)
            grads = grads_of(loss, params, CP_LEAVES)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = {n: v / cfg.nlayers for n, v in fa.LAUNCHES.items()}
            staged = dict(HOST_STAGING)
            if timed:  # a second call, the first having warmed the path
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                again = gpt_loss(params, b, c, remat="flash", cp_group=cp)
                grads_of(again, params, CP_LEAVES)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            vals = torch.cat([loss.detach().float().reshape(1)]
                             + [grads[n].float().reshape(-1)
                                for n in CP_LEAVES]).cpu()
            dist.all_reduce(vals, group=cp)
            vals /= world
            loss_rel = abs(float(vals[0]) - float(ref["loss"])) / abs(
                float(ref["loss"]))
            gaps, off = {}, 1
            for n in CP_LEAVES:
                want = torch.from_numpy(ref[npz_key(n)]).reshape(-1)
                got = vals[off:off + want.numel()]
                off += want.numel()
                gaps[n] = float((got - want).abs().max() / want.abs().max())
            return {"loss_rel": loss_rel, "gaps": gaps, "ms": ms,
                    "launches": launches, "staged": staged}

        g = torch.Generator(device="cuda").manual_seed(7)
        qkvo = [torch.randn(1, 12, CP_SEQ, 64, generator=g, device="cuda")
                for _ in range(4)]
        qkvo[0] = qkvo[0] * CP_OP_Q_SCALE
        qkvo = [t.to(cfg.dtype) for t in qkvo]
        leaves = [t.clone().requires_grad_(True) for t in qkvo[:3]]
        whole = fa.flash_attention(*leaves, causal=True)
        whole = (whole.detach(),) + torch.autograd.grad(whole, leaves,
                                                        qkvo[3])

        def op(impl, layout, zig):
            """The attention op alone on this rank's shard against the
            serial call's shard: each of out, dq, dk, dv's largest error
            over the serial value's largest |value|."""
            def cut(t):
                t = ra.zigzag_permute(t, world, 2) if zig else t
                return t[:, :, rank * s:(rank + 1) * s].contiguous()
            loc = [cut(t).requires_grad_(True) for t in qkvo[:3]]
            if impl == "ulysses":
                out = ra.ulysses_attention(*loc, group=cp, causal=True)
            else:
                out = ra.ring_attention(*loc, group=cp, causal=True,
                                        layout=layout)
            got = (out.detach(),) + torch.autograd.grad(out, loc,
                                                        cut(qkvo[3]))
            return {n: grad_gap(a, cut(b)) for n, a, b in
                    zip(("out", "dq", "dk", "dv"), got, whole)}

        res = {"rank": rank, "gpt": {}, "faults": {}}
        for name, impl, layout, zig in (
                ("ring", "ring", "contiguous", False),
                ("zigzag", "ring", "zigzag", True),
                ("ulysses", "ulysses", "contiguous", False)):
            res["gpt"][name] = run(impl, layout, zig)
            res["gpt"][name]["op"] = op(impl, layout, zig)
        real = ra.flash_attention_with_lse
        faults = {
            "no_lse_cotangent": lambda *a, **kw: (
                lambda o, lse: (o, lse.detach()))(*real(*a, **kw)),
            "past_hop_causal": lambda q, k, v, causal=True, **kw: real(
                q, k, v, causal=True, **kw)}
        for name, fn in faults.items():
            ra.flash_attention_with_lse = fn
            try:
                res["faults"][name] = run("ring", "contiguous", False,
                                          timed=False)
                res["faults"][name]["op"] = op("ring", "contiguous", False)
            finally:
                ra.flash_attention_with_lse = real
        res["faults"]["zigzag_contiguous_positions"] = run(
            "ring", "zigzag", False, timed=False)
        res["faults"]["zigzag_contiguous_positions"]["op"] = op(
            "ring", "zigzag", False)
        del whole, leaves, qkvo
        del params
        gc.collect()
        torch.cuda.empty_cache()
        vcfg = vit_b16(attn_impl="ring")
        vparams = init_vit_params(vcfg, torch.Generator(device="cuda")
                                  .manual_seed(0))
        for p in tree_leaves(vparams):
            p.requires_grad_(True)
        vbatch = vit_batch(vcfg, VIT_CP_BATCH, 2)
        reset_counts()
        loss = vit_loss(vparams, vbatch, vcfg, remat="flash", cp_group=cp)
        vnames = ("head/w", "patch_proj/w", "blocks/attn/wqkv")
        grads = grads_of(loss, vparams, vnames)
        torch.cuda.synchronize()
        res["vit"] = {
            "loss_rel": abs(float(loss.detach()) - float(ref["vit_loss"]))
            / abs(float(ref["vit_loss"])),
            "gaps": {n: grad_gap(grads[n].float().cpu(), torch.from_numpy(
                ref[npz_key("vit/" + n)])) for n in vnames},
            "launches": {n: v / vcfg.nlayers for n, v in fa.LAUNCHES.items()}}
        (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(res))
        dist.barrier()
    finally:
        tpc.reset()
        dist.destroy_process_group()


def cp_two_ranks(card, timeout=900):
    """(b) of :func:`cp_train_phase`: the parent's serial references
    (GPT-125M at S 8192 and ViT-B/16 on 16 images, remat 'flash'), then
    :func:`cp_rank` on two spawned processes; every gate read."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    from torchdistpackage_tpu_torch.models import (
        gpt_loss,
        init_gpt_params,
        init_vit_params,
        vit_loss,
    )
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves

    tmp = Path(tempfile.mkdtemp(prefix="tdp-cp-"))
    try:
        cfg = dataclasses.replace(gpt_125m(), max_seq=CP_SEQ)
        params = init_gpt_params(cfg, torch.Generator(device="cuda")
                                 .manual_seed(0))
        for p in tree_leaves(params):
            p.requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = gpt_loss(params, random_batch(cfg, CP_BATCH, 1), cfg,
                        remat="flash")
        grads = grads_of(loss, params, CP_LEAVES)
        torch.cuda.synchronize()
        serial_ms = (time.perf_counter() - t0) * 1e3
        ref = {"loss": np.float64(float(loss.detach())),
               **{npz_key(n): grads[n].float().cpu().numpy()
                  for n in CP_LEAVES}}
        del params, grads, loss
        vcfg = vit_b16()
        vparams = init_vit_params(vcfg, torch.Generator(device="cuda")
                                  .manual_seed(0))
        for p in tree_leaves(vparams):
            p.requires_grad_(True)
        vloss = vit_loss(vparams, vit_batch(vcfg, VIT_CP_BATCH, 2), vcfg,
                         remat="flash")
        vnames = ("head/w", "patch_proj/w", "blocks/attn/wqkv")
        vgrads = grads_of(vloss, vparams, vnames)
        ref["vit_loss"] = np.float64(float(vloss.detach()))
        ref.update({npz_key("vit/" + n): vgrads[n].float().cpu().numpy()
                    for n in vnames})
        np.savez(tmp / "ref.npz", **ref)
        del vparams, vgrads, vloss, ref
        gc.collect()
        torch.cuda.empty_cache()
        ctx = mp.get_context("spawn")
        port = free_port()
        procs = [ctx.Process(target=cp_rank, args=(r, CP_RANKS, port,
                                                   str(tmp)))
                 for r in range(CP_RANKS)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.perf_counter() + timeout
        for p in procs:
            p.join(max(1.0, deadline - time.perf_counter()))
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(30)
        codes = [p.exitcode for p in procs]
        if codes != [0] * CP_RANKS:
            raise RuntimeError(f"cp-train (b): ranks exited {codes}")
        res = [json.loads((tmp / f"rank{r}.json").read_text())
               for r in range(CP_RANKS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t0
    bad = []

    def off(x):
        return (x["loss_rel"] > CP_LOSS_TOL
                or max(x["gaps"].values()) > CP_GRAD_TOL
                or max(x.get("op", {"": 0.0}).values()) > CP_OP_TOL)

    def op_text(rows):
        return "; the op alone against one serial flash call, by rank: " \
            + "; ".join(", ".join(f"{n} {v:.3e}" for n, v in x["op"].items())
                        for x in rows) + f" (tolerance {CP_OP_TOL})"

    for name in ("ring", "zigzag", "ulysses"):
        rows = [r["gpt"][name] for r in res]
        k3 = tuple(x["launches"]["flash_fwd"] for x in rows)
        even = all(x["launches"][n] == x["launches"]["flash_fwd"]
                   for x in rows for n in x["launches"])
        log(f"[cp-train] (b) GPT-125M at S {CP_SEQ} ({CP_SEQ // CP_RANKS} a "
            f"rank), batch {CP_BATCH}, bf16, remat 'flash', {name} over "
            f"{CP_RANKS} processes (gloo, host-staged exchanges): the ranks' "
            f"mean loss {rows[0]['loss_rel']:.3e} relative to the serial "
            f"'flash' step (tolerance {CP_LOSS_TOL}); grad gaps "
            + ", ".join(f"{n} {v:.3e}" for n, v in rows[0]["gaps"].items())
            + f" of each leaf's largest |value| (tolerance {CP_GRAD_TOL})"
            + op_text(rows) + "; "
            f"K3 a rank a layer {k3} (want {CP_K3_A_LAYER[name]}), K4 / K5 "
            f"the same: {even}; host copies of the exchanges (rank 0, one "
            f"forward and backward) {rows[0]['staged']['host_copies']}, "
            f"{rows[0]['staged']['host_copy_bytes']} B; forward and backward "
            + ", ".join(f"rank {r['rank']} {x['ms']:.1f} ms"
                        for r, x in zip(res, rows))
            + f" (the serial step {serial_ms:.1f} ms; two processes share "
            f"one card and a host-staged exchange: not CP scaling) — on "
            f"{card}")
        if any(off(x) for x in rows) or k3 != CP_K3_A_LAYER[name] \
                or not even:
            bad.append(f"(b) {name}: loss / grads / launches off")
    for name in res[0]["faults"]:
        x = res[0]["faults"][name]
        caught = any(off(r["faults"][name]) for r in res)
        log(f"[cp-train] (b) planted fault {name}: loss {x['loss_rel']:.3e}"
            f", grad gaps " + ", ".join(f"{n} {v:.3e}" for n, v in
                                        x["gaps"].items())
            + op_text([r["faults"][name] for r in res])
            + f" — {'caught' if caught else 'NOT caught'} by the gate")
        if not caught:
            bad.append(f"(b) the planted fault {name} passed")
    for r in res:
        v = r["vit"]
        log(f"[cp-train] (b) ViT-B/16 under the ring at cp {CP_RANKS} "
            f"({vit_b16().num_patches // CP_RANKS} patches a rank), {VIT_CP_BATCH} images, rank "
            f"{r['rank']}: loss {v['loss_rel']:.3e} relative to the serial "
            f"step, its own grads' gaps "
            + ", ".join(f"{n} {g:.3e}" for n, g in v["gaps"].items())
            + f" (the head's included: every leaf whole on every rank); K3 "
            f"a layer {v['launches']['flash_fwd']} (two non-causal hops) — "
            f"on {card}")
        if off(v) or any(x != CP_RANKS for x in v["launches"].values()):
            bad.append(f"(b) ViT rank {r['rank']}: off")
    log(f"[cp-train] (b) two processes on one card: {seconds:.1f} s with "
        f"both processes' start")
    return {"ranks": res, "serial_ms": serial_ms, "seconds": seconds}, bad


def cp_train_phase(card):
    """Training context parallelism on the card: (a) one rank, the ring
    and Ulysses bit-identical to 'flash'; (b) two processes over gloo at
    S 8192, held against the serial step, with planted faults; ViT-B/16
    under the ring.  The multi-rank exchanges at cp 2 and 4 are held
    against JAX on the CPU (tests/test_torch_ring_attention.py,
    tests/test_torch_gpt_cp.py, tests/test_torch_vit.py)."""
    t_phase = time.perf_counter()
    a, bad = cp_one_rank(card)
    log(f"[cp-train] this process holds "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB before the two ranks "
        f"start")
    b, bad_b = cp_two_ranks(card)
    bad += bad_b
    seconds = time.perf_counter() - t_phase
    log(f"[cp-train] phase done in {seconds:.1f} s")
    if bad:
        raise RuntimeError("cp-train: " + "; ".join(bad))
    return {"one_rank": a, "two_ranks": b, "seconds": seconds}


# ------------------------------------------------------------ the collectives

COMPRESS_STEPS = 3        # AdamW steps an arm
COMPRESS_RANKS = 2        # (b): two processes on the one card, gloo between
COMPRESS_ROWS = 8         # (b): sequences a rank
#: (b): each loss against its exact arm's, relative — the reference's own
#: bound (tests/test_compression.py:220, :260, :296, :330, :380)
COMPRESS_LOSS_TOL = 0.05
#: (b): step 1's reduced grads against the exact arm's, of each leaf's
#: largest |value|: the reference's bound for grads through a quantized
#: forward (:391, TP's activations), which FSDP's quantized gathered
#: weights also are; a third of it where only the reductions are
#: quantized (DP, ZeRO)
COMPRESS_GRAD_TOL = {"forward": 0.15, "reduce": 0.05}
#: (b): the arms the planted ring fault runs on, and the gate each reads
FAULT_ARMS = {"zero": "reduce", "fsdp": "forward"}
STAGING_TOL = 0.10        # (b): measured host-staged ratio / predicted
COMPRESS_BENCH_BYTES = (16 << 20, 256 << 20)
COMPRESS_BENCH_OPS = ("all_reduce", "all_gather", "reduce_scatter",
                      "all_to_all", "ppermute", "int8_all_reduce",
                      "int8_reduce_scatter", "int8_all_gather")
#: (b)'s arms: name -> (kind, options); ``tp`` arms run on a tensor 2
#: layout (the same 8 sequences on both ranks), the others on data 2
COMPRESS_ARMS = {
    "dp": ("dp", {}),
    "dp_int8": ("dp", {"grad_compress": "int8"}),
    "zero": ("zero", {}),
    "zero_int8": ("zero", {"grad_compress": "int8",
                           "gather_compress": None}),
    "zero_int8_ef": ("zero", {"grad_compress": "int8_ef",
                              "gather_compress": None}),
    "zero_int8_gather": ("zero", {"grad_compress": "int8",
                                  "gather_compress": "int8"}),
    "fsdp": ("fsdp", {}),
    "fsdp_int8": ("fsdp", {"grad_compress": "int8"}),
    "tp": ("tp", {}),
    "tp_int8": ("tp", {"ag_compress": "int8"}),
}
#: (a)'s arms over the one-rank group: name -> (kind, options); each
#: compressed arm is held to the arm its name starts with
COMPRESS_ONE_RANK_ARMS = {
    "dp": ("dp", {}),
    "dp_int8": ("dp", {"grad_compress": "int8"}),
    "dp_auto": ("dp", {"grad_compress": "auto"}),
    "zero": ("zero", {}),
    "zero_int8": ("zero", {"grad_compress": "int8",
                           "gather_compress": "follow"}),
    "zero_int8_ef": ("zero", {"grad_compress": "int8_ef"}),
    "fsdp": ("fsdp", {}),
    "fsdp_int8": ("fsdp", {"grad_compress": "int8"}),
}
#: each compressed arm of (b) and the exact arm it is held to
COMPRESS_EXACT = {"dp_int8": "dp", "zero_int8": "zero",
                  "zero_int8_ef": "zero", "zero_int8_gather": "zero",
                  "fsdp_int8": "fsdp", "tp_int8": "tp"}


def compress_arm(cfg, kind, opts, tp_group=None):
    """``(params, state, step, grads)`` of one arm: GPT ``cfg`` from seed
    0 through the step a user calls — ``'dp'`` ``DataParallel``,
    ``'zero'`` ``ZeroOptimizer`` (bf16 parameters, f32 master shards),
    ``'fsdp'`` ``FSDP.make_overlap_train_step``, ``'tp'``
    ``make_train_step``'s TP + SP step over ``tp_group`` — each with
    ``opts`` (``'tp'``: fields of the config); AdamW(3e-4), remat
    'flash'.  ``grads(params, state)`` lists the step's reduced grads
    (ZeRO: the master shards') as ``(leaf name, grad)``."""
    from torchdistpackage_tpu_torch.models import gpt_loss, init_gpt_params
    from torchdistpackage_tpu_torch.models.gpt import (
        gpt_param_specs,
        shard_gpt_params,
    )
    from torchdistpackage_tpu_torch.parallel import (
        FSDP,
        DataParallel,
        ZeroOptimizer,
        adamw,
    )
    from torchdistpackage_tpu_torch.parallel.data_parallel import (
        make_train_step,
    )
    from torchdistpackage_tpu_torch.utils.partition import named_leaves

    params = init_gpt_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    opt = adamw(3e-4)
    if kind == "tp":
        cfg = dataclasses.replace(cfg, **opts)
        params = shard_gpt_params(params, cfg, tp_group.rank(),
                                  tp_group.size())
    lf = lambda p, b: gpt_loss(p, b, cfg, remat="flash",  # noqa: E731
                               tp_group=tp_group, sp=tp_group is not None)
    if kind == "dp":
        state = opt.init(params)
        step = DataParallel(**opts).make_train_step(lf, opt)
    elif kind == "zero":
        owner = ZeroOptimizer(opt, param_dtype=cfg.dtype, **opts)
        params = owner.place_params(params)
        state = owner.init(params)
        step = owner.make_train_step(lf)
    elif kind == "fsdp":
        owner = FSDP()
        params = owner.shard_params(params)
        state = opt.init(params)
        step = owner.make_overlap_train_step(lf, opt, **opts)
    else:
        state = opt.init(params)
        step = make_train_step(lf, opt, param_specs=gpt_param_specs(params),
                               sp=True, tp_group=tp_group)

    def grads(params, state):
        tree = state["master"] if kind == "zero" else params
        return [(name, p.grad) for name, p in named_leaves(tree)]
    return params, state, step, grads


def compress_run(cfg, kind, opts, batch, steps, tp_group=None,
                 keep_grads=False):
    """``steps`` steps of :func:`compress_arm` on ``batch``; the kernels'
    counts, the collectives and ``HOST_STAGING`` set to 0 just before the
    steps and read just after.  Returns the losses, host-clock times,
    K3-K5 launches and host-staged bytes a step, step 1's reduced grads
    (f32 copies, ``keep_grads``) and the state."""
    from torchdistpackage_tpu_torch.ops import flash_attention as fa
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        COLLECTIVES,
    )
    from torchdistpackage_tpu_torch.parallel.tensor_parallel.tp_utils import (
        HOST_STAGING,
    )

    params, state, step, grads = compress_arm(cfg, kind, opts, tp_group)
    torch.cuda.synchronize()
    reset_counts()
    for d in (COLLECTIVES, HOST_STAGING):
        for k in d:
            d[k] = 0
    losses, times, first = [], [], None
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss, _ = step(params, state, batch)
        losses.append(float(loss))  # reads back: waits for the step
        times.append(time.perf_counter() - t0)
        if i == 0 and keep_grads:
            first = [(name, g.detach().float().clone())
                     for name, g in grads(params, state)]
    return {"losses": losses, "times": times,
            "launches": {k: v / steps for k, v in fa.LAUNCHES.items()},
            "staged": HOST_STAGING["host_copy_bytes"] / steps,
            "collectives": {k: v // steps for k, v in COLLECTIVES.items()
                            if v},
            "grads": first, "params": params, "state": state}


def int8_payload(c):
    """The bytes an int8 ring moves for ``c`` elements: the codes and one
    f32 scale a group (``dist.compressed``'s packing)."""
    from torchdistpackage_tpu_torch.dist.compressed import _group_size

    return c + 4 * (c // _group_size(c))


def staged_prediction(cfg, rows, n):
    """(b)'s host-staged bytes a step and rank, by arm, from the leaves'
    shapes and the staging rules of ``tp_utils``: each copy to the host
    and back counted, so an all-reduce of P bytes stages 2P, an
    all-gather of this rank's b bytes (n + 1) b, a reduce-scatter of P
    (1 + 1/n) P, a ring hop of b 2b; an int8 payload of c elements is
    :func:`int8_payload` (``obs.comm_model.compressed_payload_bytes``'s
    1 byte an element and 4 / 256 for the scales).  The int8 collectives:
    the mean (``int8_ring_pmean``) n - 1 hops and the gather of the
    finished chunks, the reduce-scatter n - 1 hops, the all-gather and the
    re-gather one all-gather of the codes.  TP + SP: per layer and step 11
    boundary collectives, 6 gathers and 5 reduce-scatters (2 of each
    forward, their 4 backwards, and the attention's two and the MLP's
    gather again in the 'flash' recompute), each ``3 B S D`` bytes exact; the embedding's
    all-reduce, the split's and the head gather's and their backwards,
    the loss's reductions and the SP sums exact in both arms.  Also
    returns, beside each compressed arm, the reference model's ratio
    (``compressed_wire_bytes`` over ``wire_bytes``)."""
    from torchdistpackage_tpu_torch.models import init_gpt_params
    from torchdistpackage_tpu_torch.models.gpt import (
        gpt_param_specs,
        shard_gpt_params,
    )
    from torchdistpackage_tpu_torch.obs.comm_model import (
        compressed_wire_bytes,
        wire_bytes,
    )
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        PARTIAL_UNDER_SP,
    )
    from torchdistpackage_tpu_torch.parallel.zero import (
        leaf_specs,
        zero_partition_spec,
    )
    from torchdistpackage_tpu_torch.utils.partition import named_leaves

    params = init_gpt_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0))
    leaves = [(name, tuple(p.shape), p.numel()) for name, p in
              named_leaves(params)]
    tp_shard = shard_gpt_params(params, cfg, 0, n)
    partial = sum(p.numel() for p, s in zip(
        (p for _, p in named_leaves(tp_shard)),
        leaf_specs(tp_shard, gpt_param_specs(tp_shard)))
        if s == PARTIAL_UNDER_SP)
    del params, tp_shard
    q = int8_payload
    ar = lambda b: 2 * b  # noqa: E731
    ag = lambda b: (n + 1) * b  # noqa: E731
    rs = lambda b: b + b // n  # noqa: E731
    loss, norm = ar(4), ar(16)  # the f32 loss's and the norm's all-reduces
    big = [(E, zero_partition_spec(s, None, n)) for _, s, E in leaves]
    thr = 65536

    def pmean8(E):
        return (3 * n - 1) * q(E // n) if E % n == 0 else ar(2 * E)

    out = {"dp": sum(ar(2 * E) for E, _ in big) + loss}
    out["dp_int8"] = sum(pmean8(E) if E >= thr else ar(2 * E)
                         for E, _ in big) + loss
    zero = sum(rs(4 * E) + ag(2 * E // n) if d >= 0 else ar(4 * E)
               for E, d in big) + loss + norm
    out["zero"] = zero
    comp = [(E, d) for E, d in big if d >= 0 and E >= thr]
    out["zero_int8"] = zero - sum(rs(4 * E) - 2 * (n - 1) * q(E // n)
                                  for E, _ in comp)
    out["zero_int8_ef"] = out["zero_int8"]
    out["zero_int8_gather"] = out["zero_int8"] - sum(
        ag(2 * E // n) - (n + 1) * q(E // n) for E, _ in comp)
    fsdp = sum(ag(2 * E // n) + rs(2 * E) if d >= 0 else ar(2 * E)
               for E, d in big) + loss + norm
    out["fsdp"] = fsdp
    out["fsdp_int8"] = fsdp - sum(
        ag(2 * E // n) + rs(2 * E) - ag(q(E // n)) - 2 * (n - 1) * q(E // n)
        for E, _ in comp)
    B, S, D, L = rows, cfg.max_seq, cfg.dim, cfg.nlayers
    F, X = B * S * D, B * S * D // n
    edge = ar(2 * F) + ag(2 * X) + ag(2 * X) + rs(2 * F) \
        + ar(4 * B * S) + ar(8 * B * S) + ar(2 * partial) + norm
    out["tp"] = edge + 11 * L * ag(2 * X)
    out["tp_int8"] = edge + L * (6 * ag(q(X)) + 5 * 2 * (n - 1) * q(X))
    model = {
        "dp_int8": sum((compressed_wire_bytes("all_reduce", 2 * E, n, 2)
                        if E >= thr else wire_bytes("all_reduce", 2 * E, n))
                       for E, _ in big)
        / sum(wire_bytes("all_reduce", 2 * E, n) for E, _ in big),
        "zero_int8": sum(compressed_wire_bytes("reduce_scatter", 4 * E, n)
                         for E, _ in comp)
        / sum(wire_bytes("reduce_scatter", 4 * E, n) for E, _ in comp),
    }
    return out, model


def ef_bound_check(run):
    """``'int8_ef'``'s residual after the run: each compressed leaf's
    residual against one quantization step of each group of what was
    compressed (at one rank the master's grad is ``Q(x)`` and ``x =
    Q(x) + e``): ``(largest |e| / (group amax / 127), leaves checked,
    largest |e|)``."""
    from torchdistpackage_tpu_torch.dist.compressed import _group_size
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves

    worst, checked, emax = 0.0, 0, 0.0
    for m, e in zip(tree_leaves(run["state"]["master"]),
                    tree_leaves(run["state"]["ef"])):
        if m.numel() < 65536:
            continue
        x = (m.grad.float() + e).reshape(-1)
        g = _group_size(x.numel())
        step = x.reshape(-1, g).abs().amax(dim=1) / 127.0
        ratio = (e.reshape(-1, g).abs().amax(dim=1)
                 / step.clamp_min(1e-30)).max()
        worst = max(worst, float(ratio))
        emax = max(emax, float(e.abs().max()))
        checked += 1
    return worst, checked, emax


def compress_one_rank(card):
    """(a): GPT-125M at full width and depth, batch 16, 3 AdamW steps an
    arm, over a one-rank NCCL data group: DataParallel exact / 'int8' /
    'auto', ZeroOptimizer exact / 'int8' (gather 'follow') / 'int8_ef',
    FSDP's overlap step exact / 'int8'."""
    from torchdistpackage_tpu_torch.dist import compressed as C
    from torchdistpackage_tpu_torch.obs.numerics import tree_leaves

    cfg, rows, steps = gpt_125m(), TRAIN_BATCH, COMPRESS_STEPS
    L, tag, bad, out = cfg.nlayers, "[compress] (a)", [], {}
    # the quantizer on the card against the CPU on the same values
    rs = np.random.RandomState(0)
    x = rs.randn(1 << 22).astype(np.float32)
    x[::97] *= 500.0
    qc, sc = C._quant(torch.from_numpy(x).cuda())
    qh, sh = C._quant(torch.from_numpy(x))
    code_diff = int((qc.cpu() != qh).sum())
    scale_diff = int((sc.cpu() != sh).sum())
    deq_same = torch.equal(C._dequant(qc, sc).cpu(), C._dequant(qh, sh))
    log(f"{tag} _quant on the card against the CPU, {x.size} numpy-seeded "
        f"f32 values (outliers x500 every 97th): codes that differ "
        f"{code_diff}, scales that differ {scale_diff}, _dequant "
        f"bit-identical {deq_same} — on {card}")
    if code_diff or scale_diff or not deq_same:
        bad.append("(a) the card's quantizer differs from the CPU's")
    out["quant_code_diff"] = code_diff
    batch = random_batch(cfg, rows, 1)
    with one_rank_layout("compress", [("data", 1)]):
        runs = {}
        for name, (kind, opts) in COMPRESS_ONE_RANK_ARMS.items():
            run = compress_run(cfg, kind, opts, batch, steps)
            run["params"] = [p.detach().clone() for p in
                             tree_leaves(run["params"])]
            if name == "zero_int8_ef":
                run["ef"] = ef_bound_check(run)
            run.pop("state")
            runs[name] = run
            ok = (all(np.isfinite(run["losses"]))
                  and all(v == L for v in run["launches"].values()))
            exact = name.split("_")[0]
            same = None
            if exact != name:
                ref = runs[exact]
                same = (run["losses"] == ref["losses"] and all(
                    torch.equal(a, b) for a, b in zip(run["params"],
                                                      ref["params"])))
            extra = ""
            if name == "zero_int8_ef":
                worst, checked, emax = run["ef"]
                gap = max(abs(a - b) / abs(b) for a, b in
                          zip(run["losses"], runs["zero"]["losses"]))
                alive = emax > 0.0
                extra = (f"; differs from the exact arm by the quantizer "
                         f"alone: step 1's loss bit-identical "
                         f"{run['losses'][0] == runs['zero']['losses'][0]}, "
                         f"largest relative loss gap {gap:.3e} (tolerance "
                         f"{COMPRESS_LOSS_TOL}); the residual of {checked} "
                         f"compressed leaves: largest |e| {emax:.3e} "
                         f"(alive: {alive}), largest |e| / (group amax / "
                         f"127) {worst:.4f} (bound 1)")
                ok = ok and alive and worst <= 1.0 and gap <= \
                    COMPRESS_LOSS_TOL and run["losses"][0] == \
                    runs["zero"]["losses"][0]
                same = None
            elif same is not None:
                extra = (f"; losses and every parameter after step {steps} "
                         f"bit-identical to the exact arm: {same}")
                ok = ok and same
            log(f"{tag} {name}: GPT-125M, batch {rows}, S {cfg.max_seq}, "
                f"bf16, remat 'flash', {steps} steps over a one-rank NCCL "
                f"data group: losses "
                + ", ".join(f"{v:.6f}" for v in run["losses"])
                + f"; step median {np.median(run['times']) * 1e3:.2f} ms; "
                f"K3-K5 a step {run['launches']}; collectives a step "
                f"{run['collectives']}{extra} — on {card}")
            if not ok:
                bad.append(f"(a) {name}: not finite, launches off, or not "
                           f"as its exact arm")
            out[name] = {"losses": run["losses"], "launches": run["launches"],
                         "step_ms": float(np.median(run["times"]) * 1e3),
                         "same_as_exact": same}
        out["zero_int8_ef"]["ef"] = list(runs["zero_int8_ef"]["ef"])
        # the planted fault: an error feedback that drops the residual
        real = C.ef_compress
        C.ef_compress = lambda x: (real(x)[0], torch.zeros(
            x.shape, dtype=torch.float32, device=x.device))
        try:
            run = compress_run(cfg, "zero", {"grad_compress": "int8_ef"},
                               batch, 1)
            worst, checked, emax = ef_bound_check(run)
        finally:
            C.ef_compress = real
        caught = not emax > 0.0
        log(f"{tag} planted fault: ef_compress drops the residual: largest "
            f"|e| after a step {emax:.3e} — "
            f"{'caught' if caught else 'NOT caught'} by the gate")
        if not caught:
            bad.append("(a) the dropped residual passed")
        del runs, run
        gc.collect()
        torch.cuda.empty_cache()
    return out, bad


def worst_leaf(got, want, top=3):
    """Step 1's grads of an arm (``[(leaf name, grad)]``) against its
    exact arm's, leaf by leaf (:func:`grad_gap`): the worst leaf's name
    and gap, the runner-up's, how many of the worst leaf's elements are
    off by more than half its gap (of its largest |want|), and its
    ``top`` worst elements as ``[flat index, got, want]``."""
    gaps = sorted(((grad_gap(a, b), name) for (name, a), (_, b) in
                   zip(got, want)), reverse=True)
    gap, name = gaps[0]
    a, b = dict(got)[name].reshape(-1), dict(want)[name].reshape(-1)
    d = (a - b).abs()
    amax = float(b.abs().max().clamp_min(1e-30))
    idx = torch.topk(d, min(top, d.numel())).indices.tolist()
    return {"leaf": name, "gap": gap, "elems": d.numel(), "want_amax": amax,
            "over_half": int((d > 0.5 * gap * amax).sum()),
            "top": [[i, float(a[i]), float(b[i])] for i in idx],
            "runner_up": list(gaps[1][::-1]) if len(gaps) > 1 else None}


def faulty_ring(module):
    """The int8 reduce-scatter ring with the planted fault: each hop adds
    the wrong travelling chunk (``idx - t - 1`` for ``idx - t - 2``),
    built from the module's own source."""
    import inspect
    import textwrap

    src = textwrap.dedent(inspect.getsource(module._ring_reduce_scatter))
    if "idx - t - 2" not in src:
        raise RuntimeError("the ring's source changed: no 'idx - t - 2'")
    ns = dict(vars(module))
    exec(src.replace("idx - t - 2", "idx - t - 1"), ns)
    return ns["_ring_reduce_scatter"]


def compress_rank(rank, world, port, tmp):
    """One rank of :func:`compress_phase` (b) in its own process: a gloo
    group on the loopback (NCCL puts no two ranks of a communicator on
    one card; every collective of a CUDA tensor goes through the host,
    counted in ``tp_utils.HOST_STAGING``), the flash kernels from the
    parent's build.  GPT-125M at full width and depth from the parent's
    seed: every arm of :data:`COMPRESS_ARMS`, 3 AdamW steps; the planted
    ring fault on ZeroOptimizer 'int8' and on FSDP 'int8' (one step
    each); then
    ``comm_bench.test_collection`` over the pair.  Writes
    ``rank<r>.json``."""
    import datetime

    import torch.distributed as dist

    from torchdistpackage_tpu_torch.dist import comm_bench, tpc
    from torchdistpackage_tpu_torch.dist import compressed as C
    from torchdistpackage_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        _build.load_all(["flash_attention"])
        cfg = gpt_125m()
        full = random_batch(cfg, COMPRESS_ROWS * world, 1)
        own = {k: v[rank * COMPRESS_ROWS:(rank + 1) * COMPRESS_ROWS]
               .contiguous() for k, v in full.items()}
        same = {k: v[:COMPRESS_ROWS].contiguous() for k, v in full.items()}
        res = {"rank": rank, "arms": {}}
        exact_grads = {}
        for layout in ("data", "tensor"):
            tpc.setup_process_groups([(layout, world)])
            group = tpc.get_group("tensor") if layout == "tensor" else None
            for name, (kind, opts) in COMPRESS_ARMS.items():
                if (kind == "tp") != (layout == "tensor"):
                    continue
                run = compress_run(cfg, kind, opts,
                                   same if kind == "tp" else own,
                                   COMPRESS_STEPS, tp_group=group,
                                   keep_grads=True)
                row = {k: run[k] for k in ("losses", "times", "launches",
                                           "staged", "collectives")}
                if name in COMPRESS_EXACT:
                    row["worst"] = worst_leaf(
                        run["grads"], exact_grads[COMPRESS_EXACT[name]])
                    row["grad_gap"] = row["worst"]["gap"]
                else:
                    exact_grads[name] = run["grads"]
                res["arms"][name] = row
                del run
                gc.collect()
                torch.cuda.empty_cache()
            if layout == "data":
                # the planted fault: the ring adds the wrong chunk, under
                # ZeRO's reduce-to-owner and FSDP's int8 gather's backward
                real = C._ring_reduce_scatter
                C._ring_reduce_scatter = faulty_ring(C)
                res["fault"] = {}
                try:
                    for kind in FAULT_ARMS:
                        run = compress_run(cfg, kind,
                                           COMPRESS_ARMS[f"{kind}_int8"][1],
                                           own, 1, keep_grads=True)
                        res["fault"][kind] = worst_leaf(run["grads"],
                                                        exact_grads[kind])
                        del run
                finally:
                    C._ring_reduce_scatter = real
                exact_grads.clear()
                gc.collect()
                torch.cuda.empty_cache()
                rows = comm_bench.test_collection(
                    "data", sizes=COMPRESS_BENCH_BYTES,
                    ops=COMPRESS_BENCH_OPS, verbose=False, warmup=1,
                    iters=3)
                res["bench"] = rows
            tpc.reset()
        (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(res))
        dist.barrier()
    finally:
        tpc.reset()
        dist.destroy_process_group()


def compress_two_ranks(card, timeout=900):
    """(b) of :func:`compress_phase`: the host-staged bytes predicted,
    then :func:`compress_rank` on two spawned processes; every gate
    read."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    from torchdistpackage_tpu_torch.obs.comm_model import CommModel

    cfg, n, tag = gpt_125m(), COMPRESS_RANKS, "[compress] (b)"
    pred, model = staged_prediction(cfg, COMPRESS_ROWS, n)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{tag} predicted host-staged bytes a step and rank, before the "
        f"run (staged_prediction): "
        + ", ".join(f"{k} {v}" for k, v in pred.items())
        + "; compressed / exact: "
        + ", ".join(f"{k} {pred[k] / pred[e]:.4f}"
                    for k, e in COMPRESS_EXACT.items())
        + "; the reference model's wire ratio (compressed_wire_bytes, its "
        "psum gather leg): "
        + ", ".join(f"{k} {v:.4f}" for k, v in model.items()))
    tmp = Path(tempfile.mkdtemp(prefix="tdp-compress-"))
    try:
        ctx = mp.get_context("spawn")
        port = free_port()
        procs = [ctx.Process(target=compress_rank, args=(r, n, port,
                                                         str(tmp)))
                 for r in range(n)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.perf_counter() + timeout
        for p in procs:
            p.join(max(1.0, deadline - time.perf_counter()))
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(30)
        codes = [p.exitcode for p in procs]
        if codes != [0] * n:
            raise RuntimeError(f"compress (b): ranks exited {codes}")
        res = [json.loads((tmp / f"rank{r}.json").read_text())
               for r in range(n)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t0
    bad, out = [], {"predicted": pred, "model_ratio": model, "arms": {}}
    L = cfg.nlayers
    for name, (kind, _) in COMPRESS_ARMS.items():
        rows = [r["arms"][name] for r in res]
        ok = all(all(np.isfinite(x["losses"])) for x in rows) and all(
            v == L for x in rows for v in x["launches"].values())
        line = (f"{tag} {name}: GPT-125M, S {cfg.max_seq}, bf16, remat "
                f"'flash', {COMPRESS_ROWS} sequences a rank"
                f"{' (the same on both: TP 2 + SP)' if kind == 'tp' else ''}"
                f", {COMPRESS_STEPS} steps over {n} processes (gloo, "
                f"host-staged): losses by rank "
                + "; ".join(", ".join(f"{v:.6f}" for v in x["losses"])
                            for x in rows)
                + f"; K3-K5 a step {rows[0]['launches']}; host-staged bytes "
                f"a step {rows[0]['staged']:.0f} (predicted {pred[name]})")
        row_out = {"losses": [x["losses"] for x in rows],
                   "staged": rows[0]["staged"], "predicted": pred[name],
                   "step_ms": [float(np.median(x["times"]) * 1e3)
                               for x in rows],
                   "launches": rows[0]["launches"]}
        if name in COMPRESS_EXACT:
            ex = [r["arms"][COMPRESS_EXACT[name]] for r in res]
            gap = max(abs(a - b) / abs(b) for x, e in zip(rows, ex)
                      for a, b in zip(x["losses"], e["losses"]))
            moved = all(x["losses"][-1] != x["losses"][0] for x in rows)
            ggap = max(x["grad_gap"] for x in rows)
            gtol = COMPRESS_GRAD_TOL["forward" if kind in ("tp", "fsdp")
                                     else "reduce"]
            ratio = rows[0]["staged"] / ex[0]["staged"]
            worst = max((x["worst"] for x in rows), key=lambda w: w["gap"])
            want = pred[name] / pred[COMPRESS_EXACT[name]]
            line += (f"; largest relative loss gap to {COMPRESS_EXACT[name]} "
                     f"{gap:.3e} (tolerance {COMPRESS_LOSS_TOL}), losses "
                     f"move step 1 -> {COMPRESS_STEPS}: {moved}; step 1's "
                     f"reduced grads {ggap:.3e} of each leaf's largest "
                     f"|value| (tolerance {gtol}), worst leaf "
                     f"{worst['leaf']}: {worst['over_half']} of "
                     f"{worst['elems']} elements off by more than half "
                     f"the gap, largest |exact| {worst['want_amax']:.3e}, "
                     f"worst elements [index, got, exact] {worst['top']}, "
                     f"runner-up {worst['runner_up']}; host-staged ratio to "
                     f"{COMPRESS_EXACT[name]} {ratio:.4f} (predicted "
                     f"{want:.4f}, {ratio / want - 1:+.3%}, tolerance "
                     f"{STAGING_TOL:.0%})")
            ok = ok and gap <= COMPRESS_LOSS_TOL and moved and \
                ggap <= gtol and abs(ratio / want - 1) <= STAGING_TOL
            row_out.update(loss_gap=gap, grad_gap=ggap, staged_ratio=ratio,
                           predicted_ratio=want, worst_leaf=worst)
        line += (f"; step median by rank "
                 + ", ".join(f"{v:.1f}" for v in row_out["step_ms"])
                 + f" ms (two processes share one card and a host-staged "
                 f"gloo exchange: not NVLink) — on {card}")
        log(line)
        if not ok:
            bad.append(f"(b) {name}: off")
        out["arms"][name] = row_out
    out["fault_grad_gap"] = {}
    for kind, tol in FAULT_ARMS.items():
        fault = max(r["fault"][kind]["gap"] for r in res)
        caught = fault > COMPRESS_GRAD_TOL[tol]
        log(f"{tag} planted fault: the int8 reduce-scatter ring adds the "
            f"wrong travelling chunk (idx - t - 1), {kind} 'int8' one step: "
            f"step 1's reduced grads {fault:.3e} of each leaf's largest "
            f"|value| (worst leaf by rank "
            + ", ".join(r["fault"][kind]["leaf"] for r in res)
            + f"; gate {COMPRESS_GRAD_TOL[tol]}) — "
            f"{'caught' if caught else 'NOT caught'} by the gate")
        if not caught:
            bad.append(f"(b) the ring fault passed under {kind}")
        out["fault_grad_gap"][kind] = fault
    rows = res[0]["bench"]
    log(f"{tag} comm_bench.test_collection over the pair's data group: "
        f"gloo over the loopback with every payload staged through the "
        f"host — not NVLink — on {card}; one comm record a line:")
    for row in rows:
        log(json.dumps(row))
    model = CommModel.calibrate(records=rows)
    fit = {a: c.as_dict() for a, c in model.axis_costs.items()}
    qfit = {a: c.as_dict() for a, c in model.compressed_axis_costs.items()}
    log(f"{tag} CommModel.calibrate from those records (gloo over the "
        f"loopback, host-staged — on {card}): exact {fit}, int8 {qfit}; "
        f"predict_compressed('all_reduce', 256 MiB bf16, 2) "
        + json.dumps({k: v for k, v in model.predict_compressed(
            "all_reduce", 256 << 20, 2, axes=("data",),
            elem_bytes=2).items() if k in ("exact_s", "compressed_s",
                                           "compress", "basis")}))
    out.update(bench=rows, fit=fit, int8_fit=qfit, seconds=seconds)
    log(f"{tag} two processes on one card: {seconds:.1f} s with both "
        f"processes' start")
    return out, bad


def compress_phase(card):
    """The compressed collectives on the card: (a) one rank, the int8
    modes bit-identical to their exact arms (the reference's ``n == 1``
    contract) but 'int8_ef', which differs by the quantizer alone, and
    the card's quantizer against the CPU's; (b) two processes over gloo,
    each compressed arm within 5 % of its exact arm, its host-staged
    bytes at the prediction, a planted ring fault, and
    ``comm_bench`` with ``CommModel.calibrate``.  The multi-rank rings at
    n 2 and 4 are held against JAX on the CPU
    (tests/test_torch_compressed.py)."""
    t_phase = time.perf_counter()
    a, bad = compress_one_rank(card)
    log(f"[compress] this process holds "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB before the two ranks "
        f"start")
    b, bad_b = compress_two_ranks(card)
    bad += bad_b
    seconds = time.perf_counter() - t_phase
    log(f"[compress] phase done in {seconds:.1f} s")
    if bad:
        raise RuntimeError("compress: " + "; ".join(bad))
    return {"one_rank": a, "two_ranks": b, "seconds": seconds}


def tp_engine_phase(params, cfg, card, plain):
    """The Mistral engine (all 32 layers) over a one-rank NCCL ``tensor``
    group: the rank's shard (``shard_gpt_params``: at one rank views of
    every leaf), ``ServingEngine(tp_group=)`` on :func:`engine_requests`.
    At one rank the collectives are copies and each row-parallel bias is
    added after them, so the arithmetic is the plain engine's: every
    token equal to ``plain``'s (12 greedy and 4 sampled requests), K1
    once a layer a device call, the pool's bytes as
    ``expected_pool_bytes(axis_size=1)``; tok/s, TTFT and TPOT beside the
    plain engine's; and what one region costs at a decode tick's shape
    (``region_ms``), the overhead a tick pays ``2 L + 3`` times."""
    from torchdistpackage_tpu_torch.models.gpt import shard_gpt_params

    with tensor_group("tp-engine") as group:
        shard = shard_gpt_params(params, cfg, 0, group.size())
        run = engine_phase(shard, cfg, card, tag="tp-engine",
                           tp_group=group)
        cost = region_ms(group, (8, 1, cfg.dim), cfg.dtype)
    same = [np.array_equal(a, b) for a, b in zip(run["tokens"],
                                                 plain["tokens"])]
    s, p = run["summary"], plain["summary"]
    pool = s["kv_pool"]
    log(f"[tp-engine] tokens equal to the plain engine's: {sum(same)} of "
        f"{len(same)} requests; tok/s {s['tokens_per_sec']:.2f} (plain "
        f"{p['tokens_per_sec']:.2f}), TTFT p50 {s['ttft_s']['p50']:.3f} s "
        f"(plain {p['ttft_s']['p50']:.3f}), TPOT p50 "
        f"{s['tpot_s']['p50'] * 1e3:.2f} ms (plain "
        f"{p['tpot_s']['p50'] * 1e3:.2f}); pool {pool['pool_bytes']} B, "
        f"expected {pool['pool_bytes_expected']} — on {card}")
    per_tick = 2 * cfg.nlayers + 3  # the blocks, embedding, logits, tokens
    log(f"[tp-engine] one reduce_from_tp on [8, 1, {cfg.dim}] "
        f"{str(cfg.dtype)[6:]} over the one-rank NCCL group, back to back: "
        f"{cost['region']:.4f} ms a call (a clone alone {cost['clone']:.4f} "
        f"ms); a decode tick makes {per_tick} collective calls: "
        f"{per_tick * cost['region']:.2f} ms a tick — on {card}")
    if not all(same):
        raise RuntimeError("TP engine: tokens differ from the plain "
                           f"engine's in {len(same) - sum(same)} requests")
    if pool["pool_bytes"] != pool["pool_bytes_expected"]:
        raise RuntimeError("TP engine: pool bytes off the expected")
    return {**{k: v for k, v in run.items() if k != "tokens"},
            "region_ms": cost}


def region_ms(group, shape, dtype, iters=200):
    """Host-clock ms a call of ``reduce_from_tp`` over ``group`` (and of
    the clone inside it, alone) takes back to back on a ``shape``
    tensor, the device synchronised at the ends: at one rank NCCL's sum
    is a copy, so this is the call's overhead."""
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import (
        reduce_from_tp,
    )

    x = torch.randn(shape, device="cuda").to(dtype)
    out = {}
    for name, fn in (("region", lambda: reduce_from_tp(x, group)),
                     ("clone", x.clone)):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / iters * 1e3
    return out


@torch.no_grad()
def tp_generate_phase(params, cfg, card, moe_layers=2):
    """``generate(tp_group=)`` over a one-rank NCCL group at Mistral-7B-v0.1
    widths (32 layers, bf16, flash), B 4, 1000-token prompts, 16 new
    tokens: every token equal to ``generate()``'s, K3 once a layer (the
    prefill call), K1 never; then a ``moe_layers``-layer model of
    Mixtral-8x7B-v0.1's widths (the experts whole on the rank, K6 in every
    expert layer): tokens equal to ``generate()``'s, K6 once a layer a
    forward call."""
    from torchdistpackage_tpu_torch.models import (
        generate,
        init_gpt_moe_params,
        mixtral_8x7b_config,
    )
    from torchdistpackage_tpu_torch.models.gpt import shard_gpt_params

    B, P, N = 4, GEN_PROMPT, 16
    out = {}
    with tensor_group("tp-generate") as group:
        for what in ("dense", "moe"):
            if what == "dense":
                gcfg, p = dataclasses.replace(cfg, attn_impl="flash"), params
            else:
                gcfg = dataclasses.replace(
                    mixtral_8x7b_config(nlayers=moe_layers),
                    attn_impl="flash")
                p = init_gpt_moe_params(
                    gcfg, torch.Generator(device="cuda").manual_seed(3))
            L = gcfg.nlayers
            g = torch.Generator(device="cuda").manual_seed(7)
            prompt = torch.randint(0, gcfg.vocab_size, (B, P), generator=g,
                                   device="cuda")
            generate(p, prompt, gcfg, 2)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = generate(p, prompt, gcfg, N)
            torch.cuda.synchronize()
            plain = time.perf_counter() - t0
            shard = shard_gpt_params(p, gcfg, 0, group.size())
            generate(shard, prompt, gcfg, 2, tp_group=group)  # warm-up
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            got = generate(shard, prompt, gcfg, N, tp_group=group)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"flash_fwd": L}
            if what == "moe":
                launches["fused_moe_ffn"] = L * N
            expect_launches(f"TP generate ({what})", launches)
            same = float((got == want).float()[:, P:].mean())
            log(f"[tp-generate] {what} ({L} layers): B {B}, prompt {P}, {N} "
                f"new in {wall:.3f} s through generate(tp_group=) "
                f"(generate() {plain:.3f} s); "
                f"{same:.3f} of the new tokens equal to generate()'s; "
                f"launches {launches} — on {card}")
            if same != 1.0:
                raise RuntimeError(f"TP generate ({what}): tokens differ "
                                   f"from generate()'s")
            out[what] = {"launches": launches, "wall_s": wall,
                         "plain_s": plain}
            del shard
        del p
    torch.cuda.empty_cache()
    return out


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
    from torchdistpackage_tpu_torch.serving import ServingEngine

    reqs = cp_requests(cfg)
    lens = [len(r.tokens) for r in reqs]
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
            "peak_gb": peak_gb, "pool_gb": pool_gb, "k1_agree": same,
            "tokens": got}


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


def cp_requests(cfg):
    """:func:`cp_engine_phase`'s 4 greedy requests (prompts 30720, 24576,
    16384 and 8192 tokens from ``RandomState(2)``, 32 new tokens each)."""
    from torchdistpackage_tpu_torch.serving import Request

    rs = np.random.RandomState(2)
    return [Request(rs.randint(0, cfg.vocab_size, n).tolist(), 32)
            for n in (30720, 24576, 16384, 8192)]


def tp_cp_phase(params, cfg, card, cp_run):
    """TP beside CP: the Mistral model (all 32 layers) over a one-rank
    NCCL context x tensor layout (``tpc`` over ``[('context', 1),
    ('tensor', 1)]``; the replica group over both), ``ServingEngine(
    cp_group=, tp_group=, replica_group=)`` on :func:`cp_engine_phase`'s
    requests with its engine shape.  Counts set to 0 just before the run
    and read just after: K2 once a layer a device call, K1 never.  At one
    rank every collective is a copy and each row-parallel bias is added
    after it, so the arithmetic is the CP engine's: every token equal to
    ``cp_run``'s."""
    from torchdistpackage_tpu_torch.models.gpt import shard_gpt_params
    from torchdistpackage_tpu_torch.ops import paged_attention as pa
    from torchdistpackage_tpu_torch.serving import ServingEngine

    reqs = cp_requests(cfg)
    with one_rank_layout("tp-cp", [("context", 1), ("tensor", 1)]) as ctx:
        shard = shard_gpt_params(params, cfg, 0, 1)
        eng = ServingEngine(shard, cfg, num_slots=4, block_size=BS,
                            chunk=512, max_ctx=32768,
                            cp_group=ctx.get_group("context"),
                            tp_group=ctx.get_group("tensor"),
                            replica_group=ctx.replica_group())
        rids = [eng.submit(r) for r in reqs]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        eng.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = eng.serving_summary()
        calls = s["prefill_chunks"] + s["decode_steps"]
        launches = {"paged_carry_attention": cfg.nlayers * calls}
        expect_launches("TP x CP engine", launches)
        got = [eng.finished[r]["tokens"][len(q.tokens):] for r, q in
               zip(rids, reqs)]
        done = s["requests"]["completed"]
        conserved = eng.audit(heal=False)["ok"] and not eng._alloc.in_use
        del eng
        cost = region_ms(ctx.get_group("tensor"), (4, 1, cfg.dim),
                         cfg.dtype)
    torch.cuda.empty_cache()
    same = float(np.mean(np.concatenate(got)
                         == np.concatenate(cp_run["tokens"])))
    ttft, tpot = s["ttft_s"], s["tpot_s"]
    log(f"[tp-cp] {len(reqs)} greedy requests through ServingEngine("
        f"cp_group=, tp_group=, replica_group=), {s['generated_tokens']} "
        f"tokens in {wall:.2f} s: {s['tokens_per_sec']:.2f} tok/s (CP "
        f"engine {cp_run['summary']['tokens_per_sec']:.2f}), TTFT p50 "
        f"{ttft['p50']:.3f} s, TPOT p50 {tpot['p50'] * 1e3:.2f} ms, "
        f"{s['prefill_chunks']} prefill calls + {s['decode_steps']} decode "
        f"calls, launches {launches} (K1 0); {same:.3f} of the tokens "
        f"equal to the CP engine's; one reduce_from_tp on [4, 1, "
        f"{cfg.dim}] {cost['region']:.4f} ms a call (a clone alone "
        f"{cost['clone']:.4f}), {2 * cfg.nlayers + 3} such calls a decode "
        f"tick — on {card}")
    if done != len(reqs) or not conserved:
        raise RuntimeError(f"TP x CP engine: completed {done} of "
                           f"{len(reqs)}, pool conserved {conserved}")
    if same != 1.0:
        raise RuntimeError("TP x CP engine: tokens differ from the CP "
                           "engine's")
    return {"launches": launches, "summary": s, "wall_s": wall,
            "same": same, "region_ms": cost}


@torch.no_grad()
def tp_ep_phase(card, layers=2):
    """TP beside EP: ``layers`` layers of Mixtral-8x7B-v0.1's widths (bf16,
    flash, random weights from seed 3, as ``tp_generate_phase``) over a
    one-rank NCCL tensor x moe_ep layout (``build_moe_mesh`` on data 1 x
    tensor 1; the replica group over moe_ep x tensor), the rank's share
    from ``shard_moe_params(..., tp_rank=, tp_size=)``.  The engine (8
    slots, chunk 512) on :func:`engine_requests`' 16 requests through
    ``ServingEngine(ep_group=)`` and through ``ServingEngine(ep_group=,
    tp_group=, replica_group=)``: K7 and K1 once a layer a device call, K6
    never, every token equal (at one rank the collectives are copies, the
    arithmetic the EP engine's); then ``generate(ep_group=)`` and
    ``generate(tp_group=, ep_group=)``, B 4, 1000-token prompts, 16 new
    tokens: K3 once a layer (the prefill call), K7 once a layer a forward
    call, tokens equal."""
    from torchdistpackage_tpu_torch.models import (
        generate,
        init_gpt_moe_params,
        mixtral_8x7b_config,
        shard_moe_params,
    )
    from torchdistpackage_tpu_torch.serving import ServingEngine

    cfg = dataclasses.replace(mixtral_8x7b_config(nlayers=layers),
                              attn_impl="flash")
    L = cfg.nlayers
    p = init_gpt_moe_params(cfg, torch.Generator(device="cuda").manual_seed(3))
    out = {}
    with one_rank_layout("tp-ep", [("data", 1), ("tensor", 1)],
                         moe_ep=True) as ctx:
        tp, ep = ctx.get_group("tensor"), ctx.get_group("moe_ep")
        shard = shard_moe_params(p, cfg, 0, 1, tp_rank=0, tp_size=1)
        runs = {}
        for name, kw in (("ep", dict(ep_group=ep)),
                         ("tp_ep", dict(ep_group=ep, tp_group=tp,
                                        replica_group=ctx.replica_group(
                                            "moe")))):
            reqs, _ = engine_requests(cfg)
            eng = ServingEngine(shard, cfg, num_slots=8, block_size=BS,
                                chunk=512, max_ctx=8192, moe_dispatch="cuda",
                                **kw)
            rids = [eng.submit(r) for r in reqs]
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            eng.run_until_idle()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            s = eng.serving_summary()
            calls = s["prefill_chunks"] + s["decode_steps"]
            launches = {"fused_expert_ffn": L * calls,
                        "paged_decode_attention": L * calls}
            expect_launches(f"{name} engine", launches)
            if s["requests"]["completed"] != len(reqs):
                raise RuntimeError(f"{name} engine: completed "
                                   f"{s['requests']} of {len(reqs)}")
            runs[name] = {"tokens": [eng.finished[r]["tokens"] for r in rids],
                          "launches": launches, "wall_s": wall,
                          "tok_s": s["tokens_per_sec"],
                          "tpot_ms": s["tpot_s"]["p50"] * 1e3}
            del eng
        same = [np.array_equal(a, b) for a, b in
                zip(runs["tp_ep"]["tokens"], runs["ep"]["tokens"])]
        log(f"[tp-ep] engine, {L} Mixtral layers, 16 requests through "
            f"ServingEngine(ep_group=, tp_group=, replica_group=): "
            f"{runs['tp_ep']['tok_s']:.2f} tok/s, TPOT p50 "
            f"{runs['tp_ep']['tpot_ms']:.2f} ms (EP engine "
            f"{runs['ep']['tok_s']:.2f} tok/s, "
            f"{runs['ep']['tpot_ms']:.2f} ms); launches "
            f"{runs['tp_ep']['launches']} (K6 0); tokens equal to the EP "
            f"engine's in {sum(same)} of {len(same)} requests — on {card}")
        if not all(same):
            raise RuntimeError("TP x EP engine: tokens differ from the EP "
                               "engine's")
        out["engine"] = {k: {kk: vv for kk, vv in v.items()
                             if kk != "tokens"} for k, v in runs.items()}
        B, P, N = 4, GEN_PROMPT, 16
        g = torch.Generator(device="cuda").manual_seed(7)
        prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                               device="cuda")
        toks = {}
        for name, kw in (("ep", dict(ep_group=ep)),
                         ("tp_ep", dict(ep_group=ep, tp_group=tp))):
            generate(shard, prompt, cfg, 2, **kw)  # warm-up
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            toks[name] = generate(shard, prompt, cfg, N, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"flash_fwd": L, "fused_expert_ffn": L * N}
            expect_launches(f"{name} generate", launches)
            out[f"generate_{name}"] = {"launches": launches, "wall_s": wall}
        same = float((toks["tp_ep"] == toks["ep"]).float()[:, P:].mean())
        log(f"[tp-ep] generate(tp_group=, ep_group=), {L} layers: B {B}, "
            f"prompt {P}, {N} new in {out['generate_tp_ep']['wall_s']:.3f} s "
            f"(generate(ep_group=) {out['generate_ep']['wall_s']:.3f} s); "
            f"{same:.3f} of the new tokens equal; launches "
            f"{out['generate_tp_ep']['launches']} — on {card}")
        if same != 1.0:
            raise RuntimeError("TP x EP generate: tokens differ from "
                               "generate(ep_group=)'s")
        del shard
    del p
    torch.cuda.empty_cache()
    return out


DP_GROUPS = 2  # two processes on the one card, gloo between them


def dp_engine_rank(rank, world, port, tmp):
    """One rank of :func:`dp_engine_phase`, in its own process: gloo over
    the loopback (NCCL puts no two ranks of one communicator on one card),
    the kernels loaded from the parent's build, Mistral-7B-v0.1 from the
    parent's seed, ``ServingEngine(dp_group=)`` on
    :func:`engine_requests`; rank 0 teacher-forces every greedy request
    whose tokens differ from the plain engine's.  Writes
    ``rank<r>.json`` under ``tmp``."""
    import datetime

    import torch.distributed as dist

    from torchdistpackage_tpu_torch.models import (
        init_gpt_params,
        mistral_7b_config,
    )
    from torchdistpackage_tpu_torch.ops import _build
    from torchdistpackage_tpu_torch.ops.paged_attention import LAUNCHES
    from torchdistpackage_tpu_torch.serving import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=600))
    try:
        _build.load_all(["paged_attention", "flash_attention"])
        cfg = mistral_7b_config()
        params = init_gpt_params(
            cfg, torch.Generator(device="cuda").manual_seed(0))
        reqs, lens = engine_requests(cfg)
        eng = ServingEngine(params, cfg, num_slots=8, block_size=BS,
                            chunk=512, max_ctx=8192,
                            dp_group=dist.group.WORLD)
        rids = [eng.submit(r) for r in reqs]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        reset_counts()
        t0 = time.perf_counter()
        eng.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = eng.serving_summary()
        tokens = [eng.finished[r]["tokens"] for r in rids]
        res = {"rank": rank, "nlayers": cfg.nlayers,
               "launches": LAUNCHES["paged_decode_attention"],
               "calls": s["prefill_chunks"] + s["decode_steps"],
               "prefill_calls": s["prefill_chunks"],
               "decode_calls": s["decode_steps"],
               "dp_groups": s["kv_pool"]["dp_groups"],
               "num_blocks": s["kv_pool"]["num_blocks"],
               "pool_bytes": s["kv_pool"]["pool_bytes"],
               "peaks": [a.peak_in_use for a in eng._allocs],
               "in_use": [a.in_use for a in eng._allocs],
               "audit_ok": eng.audit(heal=False)["ok"],
               "completed": s["requests"]["completed"],
               "wall_s": wall, "tok_s": s["tokens_per_sec"],
               "ttft_p50": s["ttft_s"]["p50"], "tpot_p50": s["tpot_s"]["p50"],
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "tokens": [t.tolist() for t in tokens],
               "generated": [eng.finished[r]["tokens"][len(q.tokens):]
                             .tolist() for r, q in zip(rids, reqs)],
               "sampled": [i for i, q in enumerate(reqs)
                           if q.temperature > 0]}
        del eng
        torch.cuda.empty_cache()
        gaps = {}
        if rank == 0:
            plain = np.load(Path(tmp) / "plain.npz")
            tcfg = dataclasses.replace(cfg, attn_impl="flash")
            for i, (req, tok) in enumerate(zip(reqs, tokens)):
                if req.temperature > 0 or np.array_equal(
                        tok, plain[f"arr_{i}"]):
                    continue
                seq = torch.from_numpy(tok[None].astype(np.int64)).cuda()
                logits = teacher_logits_of(params, tcfg, seq)
                g = tf_gaps(logits, seq, len(req.tokens))
                gaps[i] = [float(g.max()), float((g == 0).float().mean())]
                del logits
        res["tf_max_gap"] = gaps
        (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(res))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dp_engine_phase(card, plain, timeout=900):
    """The engine's data-parallel slot groups on the one card: two
    processes (``torch.multiprocessing``, spawn — this process has CUDA
    up), a data 2 x tensor 1 layout whose data group is gloo (NCCL puts
    no two ranks of one communicator on one card; over gloo the step's
    gather moves the host copy of the tokens it reads back anyway).  Each
    holds Mistral-7B-v0.1 whole (32 layers, ~14.5 GB bf16, the serving
    phase's seed) and its group's pool for 4 of the 8 slots; both serve
    :func:`engine_requests`' 16 requests, the slots split 4 + 4.  Each
    rank's K1 launches are once a layer a device call (each call on its
    own 4 rows), its own allocator's peak and ``dp_groups`` are printed,
    and both hosts hold the same tokens.  Gated against ``plain`` (the
    plain engine's tokens): the exact share is printed; a greedy request
    that differs passes only if every emitted token is within ``TF_TOL``
    of its teacher-forced row maximum (a bf16 near-tie: a group's step
    runs 4 rows where the plain engine's runs 8, so K1's split count and
    the GEMMs' tiling differ); a sampled request is printed, not held.
    Two processes share one card, so the phase's tok/s is not
    data-parallel scaling.  The caller frees its model and engines
    first: two ranks' weights and pools fit in 80 GB only so."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    tmp = Path(tempfile.mkdtemp(prefix="tdp-dp-engine-"))
    try:
        np.savez(tmp / "plain.npz", *plain["tokens"])
        ctx = mp.get_context("spawn")
        port = free_port()
        procs = [ctx.Process(target=dp_engine_rank,
                             args=(r, DP_GROUPS, port, str(tmp)))
                 for r in range(DP_GROUPS)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(30)
        codes = [p.exitcode for p in procs]
        if codes != [0] * DP_GROUPS:
            raise RuntimeError(f"DP engine ranks exited {codes}")
        res = [json.loads((tmp / f"rank{r}.json").read_text())
               for r in range(DP_GROUPS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    total = time.perf_counter() - t0
    L = res[0]["nlayers"]
    for r in res:
        log(f"[dp-engine] rank {r['rank']} of {DP_GROUPS} (data group "
            f"{r['rank']}, slots {4 * r['rank']}-{4 * r['rank'] + 3}): K1 "
            f"launches {r['launches']} ({L} x {r['calls']} device calls: "
            f"{r['prefill_calls']} prefill + {r['decode_calls']} decode, "
            f"each on its own 4 rows); its allocator's peak "
            f"{r['peaks'][r['rank']]} of {r['num_blocks'] - 1} blocks (the "
            f"other group's {r['peaks'][1 - r['rank']]}); dp_groups "
            f"{r['dp_groups']}; pool {r['pool_bytes']} B; peak memory "
            f"{r['peak_gb']:.2f} GB; {r['completed']} requests in "
            f"{r['wall_s']:.2f} s: {r['tok_s']:.2f} tok/s (two processes on "
            f"one card: not data-parallel scaling), TTFT p50 "
            f"{r['ttft_p50']:.3f} s, TPOT p50 {r['tpot_p50'] * 1e3:.2f} ms "
            f"— on {card}")
        if r["launches"] != L * r["calls"]:
            raise RuntimeError(f"DP rank {r['rank']}: K1 launches "
                               f"{r['launches']} != {L} x {r['calls']}")
        if (r["dp_groups"] != DP_GROUPS or r["completed"] != 16
                or not r["audit_ok"] or any(r["in_use"])):
            raise RuntimeError(f"DP rank {r['rank']}: dp_groups "
                               f"{r['dp_groups']}, completed "
                               f"{r['completed']}, audit {r['audit_ok']}, "
                               f"in use {r['in_use']}")
    if res[0]["tokens"] != res[1]["tokens"]:
        raise RuntimeError("DP ranks' hosts hold different tokens")
    got = [np.asarray(t) for t in res[0]["tokens"]]
    same = [np.array_equal(a, b) for a, b in zip(got, plain["tokens"])]
    n_prompt = [len(t) - len(g) for t, g in zip(
        got, res[0]["generated"])]
    new = [(a[p:], b[p:]) for a, b, p in zip(got, plain["tokens"], n_prompt)]
    token_share = float(np.mean(np.concatenate([a == b for a, b in new])))
    lead = [int(np.argmin(np.append(a == b, False))) for a, b in new]
    gaps = {int(k): v for k, v in res[0]["tf_max_gap"].items()}
    sampled = set(res[0]["sampled"])
    greedy = [ok for i, ok in enumerate(same) if i not in sampled]
    greedy_bad = [i for i, ok in enumerate(same)
                  if not ok and i not in sampled
                  and not (i in gaps and gaps[i][0] <= TF_TOL)]
    log(f"[dp-engine] tokens equal to the plain engine's in {sum(same)} of "
        f"{len(same)} requests (greedy {sum(greedy)} of {len(greedy)}, "
        f"sampled {sum(same) - sum(greedy)} of {len(sampled)}, printed "
        f"only), {token_share:.3f} of the generated tokens; first "
        f"divergence at generated token {lead} (of "
        f"{[len(a) for a, _ in new]}); each greedy request that differs, "
        f"by teacher forcing its largest gap and its exact-argmax share: "
        + ", ".join(f"{i}: {g:.4f} / {e:.3f}" for i, (g, e) in gaps.items())
        + f" (gate {TF_TOL}: a group's step runs 4 rows where the plain "
        f"engine's runs 8, so the GEMMs' tiling and K1's split count "
        f"differ and bf16 near-ties flip); phase {total:.1f} s with both "
        f"processes' start — on {card}")
    if greedy_bad:
        raise RuntimeError(f"DP engine: greedy requests {greedy_bad} differ "
                           f"from the plain engine's beyond a near-tie")
    return {"launches": [r["launches"] for r in res],
            "calls": [r["calls"] for r in res],
            "peaks": [r["peaks"][r["rank"]] for r in res],
            "same": sum(same), "tf_max_gap": gaps,
            "tok_s": [r["tok_s"] for r in res]}


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
    # K3-K5 at the shapes of the ViT and of a context-parallel ring hop
    for kname, krows in cp_kernel_rows().items():
        flash_rows[kname].extend(krows)
    log(f"[time] kernel checks done at {time.perf_counter() - t_start:.0f} s")

    # 4. the training path: GPT-125M main path, the kernel path against the
    # plain path, a short Mistral-width run
    train = train_phase(card)
    path_parity_phase()
    mistral_train_phase(card)
    dp_train_phase(card)
    tp_train = tp_train_phase(card)
    zero_fsdp = zero_fsdp_phase(card)
    # the int8 collectives in DP, ZeRO, FSDP and TP + SP: one rank, then
    # two processes over gloo, comm_bench and the model's fit
    compress = compress_phase(card)
    pipe = pipeline_phase(card, train["step_ms"])
    # MoE training: K6 and K7 under autograd at bench.py's --moe leaf
    moe_train = moe_train_phase(card)
    # the ViT family (K3-K5 at 196 patches, K6 under autograd) and
    # training context parallelism (K3-K5 a ring hop)
    vit_train = vit_train_phase(card)
    vit_moe_train = vit_moe_train_phase(card)
    cp_train = cp_train_phase(card)
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
    # the same requests with telemetry, the watchdog and a metrics sink:
    # the same tokens and launches, every tick and request accounted for
    obs = obs_phase(params, cfg, card, eng)
    profile_phase(params, cfg, card)
    # the same model served context-parallel, K2 in every attention
    cp_eng = cp_phase(params, cfg, card)
    # and beside tensor parallelism (TP x CP), K2 in every attention
    tp_cp = tp_cp_phase(params, cfg, card, cp_eng)
    # the contiguous-cache decoding family (K3 at the prefill) and the
    # speculative engine (K1 on the K+1-row verify)
    gen = generate_phase(params, cfg, card)
    spec_eng = spec_engine_phase(params, cfg, card)
    log(f"[time] generate and speculative serving done at "
        f"{time.perf_counter() - t_start:.0f} s")
    # the engine's prefix cache, preemption, drain / resume, slot
    # migration, shedding and rope scaling
    feat = engine_features_phase(params, cfg, card)
    log(f"[time] engine features done at "
        f"{time.perf_counter() - t_start:.0f} s")
    # the fleet: the Router's disaggregation, affinity, faults and the
    # long-prompt tier (K1 on both tiers, K2 on the CP prefill replica)
    fleet = fleet_phase(params, cfg, card, eng)
    log(f"[time] fleet done at {time.perf_counter() - t_start:.0f} s")
    # tensor parallelism over a one-rank NCCL group: the engine on the
    # same requests, generate() dense and MoE
    tp_eng = tp_engine_phase(params, cfg, card, eng)
    tp_gen = tp_generate_phase(params, cfg, card)
    # TP beside EP on 2 Mixtral layers: the engine and generate(), K7
    tp_ep = tp_ep_phase(card)
    log(f"[time] tensor-parallel serving done at "
        f"{time.perf_counter() - t_start:.0f} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # the engine's data-parallel slot groups: two processes on the card,
    # each with the whole model; this process holds nothing large now
    log(f"[dp-engine] this process holds "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB before the two "
        f"ranks start")
    dp_eng = dp_engine_phase(card, eng)
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
                                for k in (3, 4)},
                            engine_features_launches={
                                "prefix_cache_off":
                                    feat["prefix"][False]["launches"],
                                "prefix_cache_on":
                                    feat["prefix"][True]["launches"],
                                **{k: feat[k]["launches"] for k in
                                   ("preempt", "drain", "migrate", "shed")},
                                "all": feat["launches"]},
                            tp_engine_launches=tp_eng["launches"],
                            obs_engine_launches=obs["launches"],
                            fleet_launches={
                                "disaggregated": fleet["a"]["launches"],
                                "affinity": fleet["b"]["launches"],
                                "long_tier_decode":
                                    fleet["d"]["launches"][1]["K1"]},
                            dp_engine_launches_by_rank=dp_eng["launches"],
                            tp_ep_engine_launches=tp_ep["engine"]["tp_ep"][
                                "launches"]["paged_decode_attention"])]
    for kname, krows in flash_rows.items():
        k = {"flash_fwd": "K3", "flash_bwd_dq": "K4",
             "flash_bwd_dkv": "K5"}[kname]
        extra = {"tp_train_launches": {
            m: tp_train[m]["launches"][kname] for m in ("tp", "sp")},
            "zero_fsdp_launches": {
                m: zero_fsdp[m]["launches"][kname] for m in (
                    "zero", "zero_clip", "fsdp", "fsdp_overlap")},
            "compress_launches_a_step": {
                "one_rank": {m: compress["one_rank"][m]["launches"][kname]
                             for m in COMPRESS_ONE_RANK_ARMS},
                "two_ranks": {m: compress["two_ranks"]["arms"][m][
                    "launches"][kname] for m in COMPRESS_ARMS}},
            "pipeline_launches_a_step": {
                "one_stage_1f1b": pipe["one_stage"]["launches"][kname],
                **{f"{m}_one_stage": pipe["one_stage"]["runs"][m][
                    "launches"][kname] for m in ("dp", "zero")},
                **{f"{name}_two_stages": [
                    r["schedules"][name]["rows"][0]["launches"][kname]
                    for r in pipe["two_stages"]["ranks"]]
                   for name in PIPE_LAUNCHES}},
            "moe_train_launches_a_step": moe_train_launches(moe_train,
                                                            kname),
            "vit_train_launches_a_step": vit_train["launches"][kname],
            "vit_moe_train_launches_a_step": vit_moe_train["launches"][kname],
            "cp_train_launches": {
                "one_rank": {m: cp_train["one_rank"][m]["launches"][kname]
                             for m in ("ring", "ulysses")},
                "two_ranks_a_layer": {
                    m: [r["gpt"][m]["launches"][kname]
                        for r in cp_train["two_ranks"]["ranks"]]
                    for m in CP_K3_A_LAYER}}}
        if kname == "flash_fwd":  # the generate path's prefill calls
            extra["generate_launches"] = {
                "generate": gen["launches"]["flash_fwd"],
                "moe_generate": cfg_moe_layers,
                "tp_generate": tp_gen["dense"]["launches"]["flash_fwd"],
                "tp_moe_generate": tp_gen["moe"]["launches"]["flash_fwd"],
                "tp_ep_generate":
                    tp_ep["generate_tp_ep"]["launches"]["flash_fwd"]}
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
        tp_generate_launches=tp_gen["moe"]["launches"]["fused_moe_ffn"],
        moe_train_launches_a_step=moe_train_launches(moe_train, "K6"),
        vit_moe_train_launches_a_step=vit_moe_train["launches"]["K6"],
        train_shape={**{k: moe_train["b"]["K6"][k] for k in (
            "ms", "backward_ms", "plain_ms", "bound_ms", "max_abs_err",
            "tol_ratio", "C", "filled")},
            "layer": vit_moe_train["gpt_moe_shape"]},
        vit_moe_shape=vit_moe_train["shape"],
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
        extra = ({"generate_launches": ep["then"]["K7"]["launches"],
                  "tp_ep_engine_launches": tp_ep["engine"]["tp_ep"][
                      "launches"]["fused_expert_ffn"],
                  "tp_ep_generate_launches": tp_ep["generate_tp_ep"][
                      "launches"]["fused_expert_ffn"],
                  "moe_train_launches_a_step": moe_train_launches(
                      moe_train, "K7"),
                  "train_shape": moe_train["b"]["K7"]}
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
        tp_cp_engine_launches=tp_cp["launches"]["paged_carry_attention"],
        fleet_cp_prefill_launches=fleet["d"]["launches"][0]["K2"],
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
