#!/usr/bin/env python3
"""Drive the PyTorch port's training and serving paths on one NVIDIA card
and check them.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device  — a CUDA card is present; its name, count and power limit.
2. build   — both kernel sources under ``torchdistpackage_tpu_torch/ops/
   csrc`` are compiled at once (one nvcc each); build seconds and ptxas'
   registers / shared memory / spills of every instantiation.
3. kernels — each kernel against its plain version on the card, row by
   row against the plain version run in f32 on the same values
   (``row_tolerance``, ``grad_held``), with planted faults that must fail
   the same checks; then its time, the plain version's time, one PyTorch
   call's time (SDPA — a yardstick the port never calls) and the least
   time the card could take.  K1 (paged attention) at the serving
   shapes (decode, a 3-row step and a 512-row prefill chunk; G 4, Hkv 8,
   hd 128, bs 16; windows None / 4096 / 64; bf16, int8 and f32 pools;
   faults: a window edge one block late, one stage of blocks misread).
   K3-K5 (flash attention forward, dq, dk/dv) at the training shape (B
   16, H 12, S 2048, hd 64, causal) and at Mistral-7B's attention (Hq 32,
   Hkv 8, hd 128, S 8192, window 4096), bf16 and f32 (faults: the
   backward without the dlse term, the window one tile late).
4. train   — the training main path: ``bench.py``'s GPT-125M at full
   depth, batch 16, S 2048, bf16, remat 'flash', 10 AdamW steps on one
   fixed batch (losses, step time, tokens/s, MFU, peak memory, launches
   exactly once a layer a step for K3, K4, K5), one step profiled by
   kernel family; the kernel path against the plain ('naive') path on
   identical weights and batch at batch 2 (loss and every gradient
   leaf, bf16 and f32); 2 steps at Mistral-7B-v0.1 widths (2 layers, S
   8192) through GQA, the window, RoPE and SwiGLU.
5. serve   — Mistral-7B-v0.1 widths, all 32 layers, bf16, random weights:
   ``paged_forward`` with K1 against the plain path on identical tokens
   (teacher-forced logits), then ``ServingEngine`` serves 16 requests
   (12 greedy, 4 sampled) through K1, launched once per layer per device
   call; a decode tick of 8 slots is timed and profiled.
6. the ``{"kernels": [...]}`` line, then the card line, then the result
   line ``{"ok": true, "device": {...}}`` last.

Every kernel's launch count is set to 0 just before each main path (the
training steps, the engine run) and read just after.
"""

import ctypes
import dataclasses
import json
import re
import subprocess
import sys
import time

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
        ("rows3_bf16_w4096", dict(B=8, S_in=3, offsets=decode_offs,
                                  window=4096, dtype=bf, quantized=False)),
        ("chunk512_bf16_w4096", dict(B=8, S_in=512, offsets=chunk_offs,
                                     window=4096, dtype=bf,
                                     quantized=False)),
        ("chunk512_bf16_w64", dict(B=8, S_in=512, offsets=chunk_offs,
                                   window=64, dtype=bf, quantized=False)),
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
        if name in ("decode_bf16_w4096", "chunk512_bf16_w4096"):
            planted_faults(case, exact)
        heavy = spec["S_in"] > 8
        ms = cuda_ms(lambda: paged_decode_attention(*args, **kw),
                     5 if heavy else 50)
        plain_ms = cuda_ms(lambda: paged_decode_attention_reference(
            *args, **kw), 2 if heavy else 10)
        lib_ms = sdpa_ms(case, 5 if heavy else 50)
        bound_ms, bound_by = bound(case)
        row = {"case": name, "max_abs_err": err, "tol_ratio": ratio,
               "plain_dtype_err": plain_err, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}
        rows.append(row)
        log(f"[kernel] {name}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"sdpa {lib_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})")
        del case, args, got, want, exact
        torch.cuda.empty_cache()
    return rows


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
        for kname, res in checks.items():
            err, ratio = max(r[0] for r in res), max(r[1] for r in res)
            log(f"[flash] {name} {kname}: vs the plain version in f32: "
                f"max abs err {err:.3g}, {ratio:.3f} of the row tolerance"
                + (f" (lse err {lse_err:.3g})" if kname == "flash_fwd"
                   else ""))
            if not ratio <= 1.0:
                raise RuntimeError(
                    f"{name}: {kname} disagrees with its plain version: "
                    f"{ratio:.3f} of the row tolerance")
            rows[kname].append({"case": name, "max_abs_err": err,
                                "tol_ratio": ratio})
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
    return rows


def flash_planted_faults(case, ref):
    """The checks must catch the faults they are there for: the kernels
    run on deliberately wrong arguments, held against the plain version
    on the right ones.  Training shape: the backward without the dlse
    term (K4 and K5 given delta = rowsum(dO·O) alone).  Mistral shape:
    the window bound one 64-row tile late (K3 and K5 given window + 64).
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


# ------------------------------------------------------------ phase 5


def reset_counts():
    """Every kernel's launch count to 0 (before a main path's run)."""
    from torchdistpackage_tpu_torch.ops import flash_attention as fa
    from torchdistpackage_tpu_torch.ops import paged_attention as pa

    for counts in (fa.LAUNCHES, pa.LAUNCHES):
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


# ------------------------------------------------------------ phase 6


def model_phase(params, cfg):
    """Teacher-forced: both arms see the same tokens, so every logit row
    is comparable.  bf16 through 32 layers: the two attention paths round
    differently and the residual stream carries those differences on, so
    the bound is relative to the logits' scale."""
    from torchdistpackage_tpu_torch.serving.paged_cache import (
        init_paged_kv,
        paged_forward,
    )

    dev = torch.device("cuda")
    B, P, C, steps = 2, 600, 512, 4
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
    logits = {}
    for impl in ("cuda", "gather"):
        cache = init_paged_kv(cfg, nb, BS, device=dev)
        outs = []
        with torch.no_grad():
            for off in range(0, P, C):
                tok = torch.zeros(B, C, dtype=torch.long, device=dev)
                sl = prompt[:, off:off + C]
                tok[:, :sl.shape[1]] = sl
                last = torch.full((B,), min(P - 1 - off, C - 1), device=dev)
                offs = torch.full((B,), off, dtype=torch.int32, device=dev)
                cache, lg = paged_forward(params, tok, cfg, cache, tables,
                                          offs, last_idx=last, attn_impl=impl)
                outs.append(lg.float())
            for t in range(steps):
                offs = torch.full((B,), P + t, dtype=torch.int32, device=dev)
                cache, lg = paged_forward(params, follow[:, t:t + 1], cfg,
                                          cache, tables, offs,
                                          attn_impl=impl)
                outs.append(lg.float())
        logits[impl] = torch.stack(outs)
        del cache
    got, want = logits["cuda"], logits["gather"]
    if not torch.isfinite(got).all():
        raise RuntimeError("kernel-path logits are not finite")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"[model] teacher-forced logits, kernel vs plain: max abs err "
        f"{err:.4g} at logit scale {scale:.4g} (rel {err / scale:.3g}); "
        f"argmax agreement {agree:.3f} over {got.shape[0] * B} rows")
    if err > 0.05 * scale:
        raise RuntimeError(
            f"full-width logits disagree: {err:.4g} > 5% of {scale:.4g}")
    return {"max_abs_err": err, "scale": scale, "argmax_agree": agree}


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


def profile_phase(params, cfg, card):
    """Where a decode tick's time goes: 8 slots decoding at 2048 context,
    16 ticks timed one by one on the host clock (each ends by reading the
    tokens back, so it waits for the device), then 8 more under
    torch.profiler — device time by kernel family, the device's idle
    share."""
    from torch.profiler import ProfilerActivity, profile

    from torchdistpackage_tpu_torch.serving import Request, ServingEngine

    eng = ServingEngine(params, cfg, num_slots=8, block_size=BS, chunk=512,
                        max_ctx=8192)
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
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 8 / 1e3
    if busy_ms == 0.0:
        log(f"[profile] decode tick {tick_ms:.2f} ms; device time not "
            f"measured (the profiler recorded no kernels) — on {card}")
        return
    families = {"paged_attention": 0.0, "gemm": 0.0, "other": 0.0}
    for e in kernels:
        name = e.key.lower()
        fam = ("paged_attention" if "paged_attention" in name else
               "gemm" if re.search(r"gemm|xmma|cutlass|nvjet|sm90", name)
               else "other")
        families[fam] += e.self_device_time_total / 8 / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    log(f"[profile] decode tick (8 slots at 2048 context): median "
        f"{tick_ms:.2f} ms (min {min(ticks):.2f}, max {max(ticks):.2f}) on "
        f"the host clock, {prof_ms:.2f} ms under the profiler; device busy "
        f"{busy_ms:.2f} ms per tick (idle {1 - busy_ms / prof_ms:.1%} of "
        f"the profiled tick); by family: " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in families.items())
        + f"; {sum(e.count for e in kernels) / 8:.0f} kernels per tick "
        f"— on {card}")
    for e in top:
        log(f"[profile]   {e.self_device_time_total / 8 / 1e3:8.3f} ms "
            f"x{e.count // 8:<4d} {e.key[:90]}")


FLASH_SOURCE = "torchdistpackage_tpu_torch/ops/csrc/flash_attention.cu"
FLASH_REPLACES = {
    "flash_fwd": "torchdistpackage_tpu/ops/flash_attention.py:232",
    "flash_bwd_dq": "torchdistpackage_tpu/ops/flash_attention.py:369",
    "flash_bwd_dkv": "torchdistpackage_tpu/ops/flash_attention.py:395",
}


def build_phase():
    """Both sources built at once (one nvcc each); ptxas' registers,
    shared memory and spills of every instantiation."""
    from torchdistpackage_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.load_all(["paged_attention", "flash_attention"])
    log(f"[build] both sources built in {time.perf_counter() - t0:.1f} s ("
        + ", ".join(f"{n}.cu {i['seconds']:.1f} s"
                    for n, i in _build.BUILD_INFO.items()) + ")")
    for src, info in _build.BUILD_INFO.items():
        kernel = "?"
        for line in str(info["log"]).splitlines():
            if "Compiling entry function" in line:  # name the instantiation
                m = re.search(r"\d+((?:flash_\w+|paged_attention)_kernel)I",
                              line)
                kernel = (f"{m.group(1) if m else '?'} "
                          f"{'bf16' if '13__nv_bfloat16' in line else 'f32'}"
                          f"{' int8 pool' if 'Lb1E' in line else ''} "
                          f"hd {128 if 'Li128E' in line else 64}")
            elif re.search(r"registers|spill|smem", line):
                log(f"[build] {src}: {kernel}: {line.strip()}")
    smem = libs["paged_attention"].tdp_paged_attention_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    log("[build] paged_attention dynamic shared memory per CTA (hd 128): "
        + ", ".join(f"{name} {smem(tag, 128)} B" for name, tag in
                    (("bf16", 0), ("f32", 1), ("int8", 2))))
    fsmem = libs["flash_attention"].tdp_flash_smem_bytes
    fsmem.argtypes, fsmem.restype = [ctypes.c_int] * 3, ctypes.c_int
    log("[build] flash_attention dynamic shared memory per CTA: " + ", ".join(
        f"{kern} {dt} hd {hd} {fsmem(i, tag, hd)} B"
        for i, kern in enumerate(("fwd", "dq", "dkv"))
        for tag, dt in ((0, "bf16"), (1, "f32")) for hd in (64, 128)))


def kernel_entry(name, route_src, replaces, launches, rows, head):
    return {
        "name": name, "route": "cuda", "source": route_src,
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "max_tol_ratio": max(r["tol_ratio"] for r in rows),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "shape": head["case"],
        "cases_passed": len(rows), "cases": rows,
    }


def main():
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    from torchdistpackage_tpu_torch.models import (
        init_gpt_params,
        mistral_7b_config,
    )

    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = card_line()
    log(f"[device] {name} x{count}; nvidia-smi: {card}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    t_start = time.perf_counter()

    # 2. build
    build_phase()

    # 3. every kernel against its plain version
    rows = kernel_phase()
    flash_rows = flash_kernel_phase()
    log(f"[time] kernel checks done at {time.perf_counter() - t_start:.0f} s")

    # 4. the training path: GPT-125M main path, the kernel path against the
    # plain path, a short Mistral-width run
    train = train_phase(card)
    path_parity_phase()
    mistral_train_phase(card)
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
    log(f"[time] serving done at {time.perf_counter() - t_start:.0f} s")

    # 6. the kernels line (headline numbers: the decode step's shape for
    # K1, the training shape for K3-K5)
    entries = [kernel_entry("paged_decode_attention",
                            "torchdistpackage_tpu_torch/ops/csrc/"
                            "paged_attention.cu", TPU_SOURCE,
                            eng["launches"], rows, rows[0])]
    for kname, krows in flash_rows.items():
        entries.append(kernel_entry(kname, FLASH_SOURCE,
                                    FLASH_REPLACES[kname],
                                    train["launches"][kname], krows,
                                    krows[0]))
    log(json.dumps({"kernels": entries}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
