#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA card and check it.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device  — a CUDA card is present; its name, count and power limit.
2. build   — the paged-attention kernel is compiled from
   ``torchdistpackage_tpu_torch/ops/csrc``; build seconds and ptxas'
   registers / shared memory / spills.
3. kernel  — the kernel against its plain version on the card at the
   shapes the serving path gives it (decode, a 3-row step and a 512-row
   prefill chunk; G 4, Hkv 8, hd 128, bs 16; windows None / 4096 / 64;
   bf16, int8 and f32 pools), held row by row (``row_tolerance``); two
   planted faults (a window edge one block late, one stage of blocks
   misread) must fail the same check.  Then its time, the plain
   version's time, one PyTorch attention call's time (SDPA over the
   already-gathered view, gather excluded — a yardstick the port never
   calls) and the least time the card could take.
4. model   — Mistral-7B-v0.1 widths, all 32 layers, bf16, random weights
   from a seeded generator: ``paged_forward`` with the kernel against the
   plain path on identical tokens (a 600-token prompt in 512-token chunks,
   then 4 decode steps), logits compared.
5. engine  — ``ServingEngine`` serves 16 requests (12 greedy, 4 sampled)
   through the kernel; every request completes and the kernel launched
   once per layer per device call.  Then a decode tick of 8 slots is
   timed and profiled: device time by kernel family and the idle share.
6. the ``{"kernels": [...]}`` line, then the card line, then the result
   line ``{"ok": true, "device": {...}}`` last.
"""

import ctypes
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


# ------------------------------------------------------------ phase 5


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
    LAUNCHES["paged_decode_attention"] = 0
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


def main():
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    from torchdistpackage_tpu_torch.models import (
        init_gpt_params,
        mistral_7b_config,
    )
    from torchdistpackage_tpu_torch.ops import _build

    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = card_line()
    log(f"[device] {name} x{count}; nvidia-smi: {card}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    _build.load("paged_attention")
    info = _build.BUILD_INFO["paged_attention"]
    log(f"[build] paged_attention.cu built in {info['seconds']:.1f} s")
    kernel = "?"
    for line in str(info["log"]).splitlines():
        if "Compiling entry function" in line:  # name the instantiation
            q = "bf16" if "kernelI13__nv_bfloat16" in line else "f32"
            pool = "int8" if "Lb1E" in line else q
            kernel = f"q {q}, pool {pool}, hd {128 if 'Li128E' in line else 64}"
        elif re.search(r"registers|spill|smem", line):
            log(f"[build] {kernel}: {line.strip()}")
    smem = _build.load("paged_attention").tdp_paged_attention_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    log("[build] dynamic shared memory per CTA (hd 128): " + ", ".join(
        f"{name} {smem(tag, 128)} B" for name, tag in
        (("bf16", 0), ("f32", 1), ("int8", 2))))

    # 3. kernel against its plain version
    rows = kernel_phase()

    # 4. full-width path, teacher-forced
    cfg = mistral_7b_config()
    t0 = time.perf_counter()
    params = init_gpt_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"[model] Mistral-7B-v0.1 widths, {cfg.nlayers} layers, "
        f"{cfg.num_params() / 1e9:.3f} B params in bf16, initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    model_phase(params, cfg)

    # 5. the engine: the main path, through the entry points users call
    eng = engine_phase(params, cfg, card)
    profile_phase(params, cfg, card)

    # 6. the kernels line (headline numbers: the decode step's shape)
    head = rows[0]
    log(json.dumps({"kernels": [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "torchdistpackage_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": TPU_SOURCE,
        "launches": eng["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "max_tol_ratio": max(r["tol_ratio"] for r in rows),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": head["case"],
        "cases_passed": len(rows),
        "cases": rows,
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
