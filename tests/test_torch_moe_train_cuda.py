"""K6 and K7 under autograd on the card: the Functions' grads against the
f32 oracles' autograd, their launch counts, and a planted fault.

``fused_moe_ffn`` (K6) and ``fused_expert_ffn`` (K7) on bf16 tokens and
experts at two shapes each (GELU and SwiGLU): the forward bit for bit
against a ``no_grad`` call of the same kernel (the bf16 bodies are
repeatable) and within 2 % of the output's largest |value| of the f32
oracle's forward on f32 copies of the same inputs; the grads of the
experts, the tokens and ``gate_vals`` (K6) or the rows (K7) within 2 %
of each leaf's largest |grad| of that oracle's autograd
(``moe_ffn_oracle_diff``, ``expert_ffn_reference_diff``).  A call with
grads launches its kernel once (the backward launches none: the
reference has no backward kernel) and a ``no_grad`` call once.  The
planted faults, a K6 backward that drops the ``gate_vals`` cotangent and
a K7 backward that drops the rows' cotangent, must fail the gate.
``chip_smoke.py``'s ``moe_train_phase`` holds both Functions at the
training shape too (its part (b): K6 on T 16384 tokens, K7 on ``[8,
5120, 768]`` rows), each forward also against its plain version row by
row.

Every test is ``gpu``-marked and skips without a CUDA device.  The file
imports neither JAX nor the JAX package::

    python -m pytest --noconftest -m gpu tests/test_torch_moe_train_cuda.py
"""

import math

import pytest
import torch

from torchdistpackage_tpu_torch.ops import moe_dispatch as md
from torchdistpackage_tpu_torch.parallel import moe as tmoe

pytestmark = pytest.mark.gpu

GRAD_TOL = 0.02  # of each leaf's largest |grad|
#: (act, T, D, F, E, k, capacity factor): C 80 / 64, the wgmma body
SHAPES = {"gelu": ("gelu", 256, 256, 512, 8, 2, 1.25),
          "swiglu": ("swiglu", 128, 128, 256, 4, 2, 1.0)}


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(name, seed=0):
    act, T, D, Fd, E, k, cf = SHAPES[name]
    g = torch.Generator(device="cuda").manual_seed(seed)
    cfg = tmoe.MoEConfig(dim=D, ffn_dim=Fd, num_experts=E, top_k=k,
                         capacity_factor=cf, act=act, dtype=torch.bfloat16)
    experts = tmoe.init_moe_params(g, cfg, device="cuda")["experts"]
    for b in ("b1", "b2"):
        experts[b] = 0.1 * torch.randn(experts[b].shape, generator=g,
                                       device="cuda").bfloat16()
    x = torch.randn(T, D, generator=g, device="cuda").bfloat16()
    logits = torch.randn(T, E, generator=g, device="cuda") * 2
    C = max(1, math.ceil(T * k * cf / E))
    route = tmoe._top_k_route(torch.softmax(logits, -1), k, C)
    return experts, x, route, C


def _gap(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _k6_grads(experts, x, route, C):
    gv, gi, slot, keep = route
    ex = {n: w.detach().clone().requires_grad_(True)
          for n, w in experts.items()}
    xr = x.detach().clone().requires_grad_(True)
    gvr = gv.detach().clone().requires_grad_(True)
    before = md.LAUNCHES["fused_moe_ffn"]
    y = md.fused_moe_ffn(ex, xr, gvr, gi, slot, keep, C)
    launched = md.LAUNCHES["fused_moe_ffn"] - before
    cot = torch.linspace(-1, 1, y.numel(), device="cuda").reshape(
        y.shape).to(y.dtype)
    y.backward(cot)
    backward = md.LAUNCHES["fused_moe_ffn"] - before - launched
    grads = {n: w.grad for n, w in ex.items()}
    grads.update(tokens=xr.grad, gate_vals=gvr.grad)
    return y, grads, cot, (launched, backward)


def _k6_reference(experts, x, route, C, cot):
    gv, gi, slot, keep = route
    ex = {n: w.detach().float().requires_grad_(True)
          for n, w in experts.items()}
    xr = x.detach().float().requires_grad_(True)
    gvr = gv.detach().float().requires_grad_(True)
    y = md.moe_ffn_oracle_diff(ex, xr, gvr, gi, slot, keep, C)
    y.backward(cot.float())
    grads = {n: w.grad for n, w in ex.items()}
    grads.update(tokens=xr.grad, gate_vals=gvr.grad, forward=y.detach())
    return grads


@pytest.mark.parametrize("name", list(SHAPES))
def test_k6_function_grads_and_launches(name):
    experts, x, route, C = _inputs(name)
    assert md.moe_ffn_body(C, x.dtype) == "wgmma"
    y, grads, cot, (fwd, bwd) = _k6_grads(experts, x, route, C)
    assert (fwd, bwd) == (1, 0)
    before = md.LAUNCHES["fused_moe_ffn"]
    with torch.no_grad():
        plain = md.fused_moe_ffn(experts, x, *route, C)
    assert md.LAUNCHES["fused_moe_ffn"] - before == 1
    assert torch.equal(plain, y.detach())
    want = _k6_reference(experts, x, route, C, cot)
    assert _gap(y, want.pop("forward")) < GRAD_TOL
    gaps = {n: _gap(grads[n], want[n]) for n in want}
    assert max(gaps.values()) < GRAD_TOL, gaps


def test_k6_planted_gate_fault_fails():
    """A backward that drops the ``gate_vals`` cotangent must fail the
    gate the true backward passes."""
    experts, x, route, C = _inputs("gelu", seed=1)
    true_backward = md._FusedMoE.backward

    def dropped(ctx, g):
        grads = list(true_backward(ctx, g))
        grads[4] = torch.zeros_like(grads[4])
        return tuple(grads)
    md._FusedMoE.backward = staticmethod(dropped)
    try:
        _, grads, cot, _ = _k6_grads(experts, x, route, C)
    finally:
        md._FusedMoE.backward = true_backward
    want = _k6_reference(experts, x, route, C, cot)
    assert _gap(grads["gate_vals"], want["gate_vals"]) > GRAD_TOL


def _k7_inputs(name):
    experts = _inputs(name, seed=2)[0]
    E, D = experts["w2"].shape[0], experts["w2"].shape[-1]
    g = torch.Generator(device="cuda").manual_seed(3)
    rows = torch.randn(E, 64, D, generator=g, device="cuda").bfloat16()
    return experts, rows


def _k7_grads(experts, rows):
    ex = {n: w.detach().clone().requires_grad_(True)
          for n, w in experts.items()}
    xr = rows.detach().clone().requires_grad_(True)
    y = md.fused_expert_ffn(ex, xr)
    cot = torch.linspace(-1, 1, y.numel(), device="cuda").reshape(
        y.shape).to(y.dtype)
    y.backward(cot)
    grads = {n: w.grad for n, w in ex.items()}
    grads["rows"] = xr.grad
    return y, grads, cot


def _k7_reference(experts, rows, cot):
    ef = {n: w.detach().float().requires_grad_(True)
          for n, w in experts.items()}
    xf = rows.detach().float().requires_grad_(True)
    y = md.expert_ffn_reference_diff(ef, xf)
    y.backward(cot.float())
    grads = {n: w.grad for n, w in ef.items()}
    grads.update(rows=xf.grad, forward=y.detach())
    return grads


@pytest.mark.parametrize("name", list(SHAPES))
def test_k7_function_grads_and_launches(name):
    experts, rows = _k7_inputs(name)
    assert md.expert_ffn_body(64, rows.dtype) == "wgmma"
    before = md.LAUNCHES["fused_expert_ffn"]
    y, grads, cot = _k7_grads(experts, rows)
    assert md.LAUNCHES["fused_expert_ffn"] - before == 1
    with torch.no_grad():
        assert torch.equal(md.fused_expert_ffn(experts, rows), y.detach())
    assert md.LAUNCHES["fused_expert_ffn"] - before == 2
    want = _k7_reference(experts, rows, cot)
    assert _gap(y, want.pop("forward")) < GRAD_TOL
    gaps = {n: _gap(grads[n], want[n]) for n in want}
    assert max(gaps.values()) < GRAD_TOL, gaps


def test_k7_planted_rows_fault_fails():
    """A K7 backward that drops the rows' cotangent must fail the gate
    the true backward passes."""
    experts, rows = _k7_inputs("gelu")
    true_backward = md._ExpertFFN.backward

    def dropped(ctx, g):
        grads = list(true_backward(ctx, g))
        grads[0] = torch.zeros_like(grads[0])
        return tuple(grads)
    md._ExpertFFN.backward = staticmethod(dropped)
    try:
        _, grads, cot = _k7_grads(experts, rows)
    finally:
        md._ExpertFFN.backward = true_backward
    want = _k7_reference(experts, rows, cot)
    assert _gap(grads["rows"], want["rows"]) > GRAD_TOL
