"""K6's decode rows on the swap-AB decode body (and K7's, which share its
passes and merge), in plain form on the CPU.

- The plan (``moe_decode_plan``, ``expert_decode_plan``): every (hit
  expert's slot tile, weight-column tile, K stage) falls in exactly one
  CTA's run of each pass, for random routings, C from 1 to 15 and SM
  counts 1, 7 and 132; a run meets no more units than the scratch has
  slots for; and the merge's closed form (``merge_runs``) names exactly
  the runs that met a unit, in run order, at the slots the runs wrote.
- The merge order: ``moe_decode_split_reference`` — each pass-2 run's
  partial sum in f32, merged token by token in the kernel's order —
  against the JAX package's ``moe_ffn_oracle`` within 1e-5, with holes
  and unhit experts, GELU and SwiGLU, float and int8 experts.  (The JAX
  Pallas K6 cannot be the oracle here: it does not build on this JAX.)

Inputs are made with numpy or JAX's init and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistpackage_tpu.ops import moe_dispatch as jmd
from torchdistpackage_tpu.parallel import moe as jmoe
from torchdistpackage_tpu_torch.ops import moe_dispatch as md
from torchdistpackage_tpu_torch.parallel.moe import _top_k_route

E, K = 8, 2
RTOL, ATOL = 1e-5, 1e-5  # f32, summation order only


def _comb(T, C, seed, e=E, unhit=()):
    """Slot maps of a serving routing decision (top-2 at capacity C);
    the experts in ``unhit`` are never chosen."""
    logits = np.random.RandomState(seed).randn(T, e).astype(np.float32)
    logits[:, list(unhit)] = -30.0
    probs = torch.softmax(torch.from_numpy(logits) * 2, -1)
    return md.slot_maps(*_top_k_route(probs, K, C), C)


def _check_runs(plan, units, nk, grid, segs, pass_name):
    """Each CTA's pieces: contiguous in run order, slot j its unit
    ``beg // nk + j``; and in pass 2, whose pieces each write a slot of
    the partials' scratch, no more than ``segs`` of them, and the merge's
    closed form gives back, for every unit, the (cta, slot) pairs that
    met it in run order."""
    met = {}
    for b, run in enumerate(plan[pass_name]):
        assert pass_name == "up" or len(run) <= segs
        for j, s in enumerate(run):
            assert s.u == run[0].u + j
            assert 0 <= s.kb < s.ke <= nk
            met.setdefault(s.u, []).append((b, j))
    assert sorted(met) == list(range(units))
    total = units * nk
    if pass_name == "down":
        for u, want in met.items():
            assert md.merge_runs(u, nk, total, grid) == want


def _covered(plan, pass_name):
    seen = []
    for run in plan[pass_name]:
        for s in run:
            seen += [(s.e, s.rows, s.cols, k) for k in range(s.kb, s.ke)]
    return seen


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("C", list(range(1, 16)))
def test_moe_decode_plan_covers_every_stage_once(C, sms):
    """At C = T (the serving capacity), random routing, D 256 and F 384
    (several column tiles and stages in each pass, a last ragged 128-row
    F stage): every (hit expert, column tile, stage) in exactly one
    CTA's run of pass 1 and of pass 2, and nothing of an unhit expert."""
    D, F = 256, 384
    idx, comb = _comb(C, C, seed=100 * C + sms)
    plan = md.moe_decode_plan(comb, D, F, True, sms)
    hit = sorted({int(e) for e in torch.nonzero(comb)[:, 0]})
    assert plan["offs"][E] == len(hit)  # C <= 16: one tile an expert
    (nk1, nk2), (mt1, mt2) = plan["nk"], plan["mt"]
    grid1, grid2 = plan["grid"]
    assert (nk1, nk2, mt1, mt2) == (4, 3, 3, 2)
    for pass_name, mt, nk, grid in (("up", mt1, nk1, grid1),
                                    ("down", mt2, nk2, grid2)):
        assert len(plan[pass_name]) == grid <= sms
        seen = _covered(plan, pass_name)
        assert len(seen) == len(set(seen))
        assert sorted(seen) == sorted(
            (e, 0, m, k) for e in hit for m in range(mt) for k in range(nk))
        _check_runs(plan, len(hit) * mt, nk, grid, plan["segs"], pass_name)
    # pass 1 hands out whole units: a run holds each unit's every stage
    assert all(s.kb == 0 and s.ke == nk1 for run in plan["up"] for s in run)


@pytest.mark.parametrize("case", ["mixtral_decode", "drops_c100",
                                  "holes_c40", "empty"])
def test_moe_decode_plan_at_other_shapes(case):
    """The plan past one tile an expert (C 40 and 100: several 16-slot
    tiles, holes emptying whole tiles), at Mixtral's widths (D 4096, F
    14336: 112 stages of F, 32 column tiles of D) on 132 SMs, and with
    no filled slot at all (no run meets anything)."""
    D, F, sms = 256, 384, 7
    if case == "mixtral_decode":
        idx, comb = _comb(8, 8, seed=1)
        D, F, sms = 4096, 14336, 132
    elif case == "drops_c100":
        idx, comb = _comb(300, 100, seed=2)
    elif case == "holes_c40":
        idx, comb = _comb(40, 40, seed=3)
        comb[:, 16:32] = 0  # the middle tile of every expert empty
        comb[2, 5] = 0
    else:
        comb = torch.zeros(E, 8)
    plan = md.moe_decode_plan(comb, D, F, True, sms)
    tiles, offs = md.chunk_tiles(comb, md.DECODE_ROWS)
    assert plan["tiles"] == tiles.tolist() and plan["offs"] == offs.tolist()
    listed = [divmod(t, -(-comb.shape[1] // 16)) for t in plan["tiles"][
        :plan["offs"][E]]]
    (nk1, nk2), (mt1, mt2) = plan["nk"], plan["mt"]
    for pass_name, mt, nk in (("up", mt1, nk1), ("down", mt2, nk2)):
        seen = _covered(plan, pass_name)
        assert len(seen) == len(set(seen))
        assert sorted(seen) == sorted((e, t, m, k) for e, t in listed
                                      for m in range(mt) for k in range(nk))
        if listed:
            _check_runs(plan, len(listed) * mt, nk,
                        plan["grid"][pass_name == "down"], plan["segs"],
                        pass_name)
    if case == "mixtral_decode":
        assert (nk1, nk2, mt1, mt2) == (64, 112, 112, 32)
        assert plan["grid"] == (132, 132)
    if case == "empty":
        assert not any(plan["up"]) and not any(plan["down"])


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("e_loc,G", [(1, 1), (8, 8), (2, 32), (3, 20),
                                     (2, 100)])
def test_expert_decode_plan_covers_every_stage_once(e_loc, G, sms):
    """K7's decode body on the same passes: every (expert, row tile,
    column tile, stage) in exactly one CTA's run of each pass; the merge's
    closed form names the runs that met each pass-2 unit."""
    D, F = 256, 384
    plan = md.expert_decode_plan(e_loc, G, D, F, False, sms)
    nr = plan["rows"]
    assert nr == (16 if G <= 16 else 32 if G <= 32 else 64)
    gt = -(-G // nr)
    (nk1, nk2), (mt1, mt2) = plan["nk"], plan["mt"]
    assert (nk1, nk2) == (2, 3)  # GELU's pass 1 streams one weight
    for pass_name, mt, nk in (("up", mt1, nk1), ("down", mt2, nk2)):
        seen = _covered(plan, pass_name)
        assert len(seen) == len(set(seen))
        assert sorted(seen) == sorted(
            (e, t, m, k) for e in range(e_loc) for t in range(gt)
            for m in range(mt) for k in range(nk))
        _check_runs(plan, e_loc * gt * mt, nk,
                    plan["grid"][pass_name == "down"], plan["segs"],
                    pass_name)


# --------------------------------------------- the merge order against JAX


def _jexperts(act, seed, quantized, D, FF):
    cfg = jmoe.MoEConfig(dim=D, ffn_dim=FF, num_experts=E, top_k=K, act=act)
    ex = jax.tree.map(np.asarray, jmoe.init_moe_params(
        jax.random.PRNGKey(seed), cfg))["experts"]
    rs = np.random.RandomState(seed)
    for b in ("b1", "b2"):
        ex[b] = rs.randn(*ex[b].shape).astype(np.float32) * 0.1
    if quantized:
        ex = jax.tree.map(np.asarray, jmd.quantize_moe_experts(ex))
    return ex


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_t(v) for v in tree)
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("act", ["gelu", "swiglu"])
@pytest.mark.parametrize("T,C,sms,shape", [
    (8, 8, 132, "decode"),         # the driven decode: C = T = 8
    (15, 15, 1, "holes_unhit"),    # one CTA runs everything
    (12, 5, 7, "drops"),           # capacity drops, runs split units
    (40, 40, 7, "tiles"),          # three 16-slot tiles an expert
])
def test_decode_merge_order_matches_jax_oracle(T, C, sms, shape, act,
                                               quantized):
    """``moe_decode_split_reference`` — pass 1's H per listed tile, each
    pass-2 run's partial over its F stages, the merge in the kernel's
    order — against JAX's ``moe_ffn_oracle`` at D 128, F 384 within 1e-5:
    unhit experts (two never chosen), holes (every fifth (token, choice)
    with gate value 0), drops, several tiles an expert."""
    D, FF = 128, 384
    ex = _jexperts(act, seed=T + C, quantized=quantized, D=D, FF=FF)
    x = np.random.RandomState(T).randn(T, D).astype(np.float32)
    logits = np.random.RandomState(T + 1).randn(T, E).astype(np.float32)
    if shape == "holes_unhit":
        logits[:, [2, 5]] = -30.0
    route = jmoe._top_k_route(jax.nn.softmax(jnp.asarray(logits) * 2, -1),
                              K, C)
    if shape == "holes_unhit":
        gv = np.array(route[0])
        gv.reshape(-1)[::5] = 0.0
        route = (jnp.asarray(gv),) + tuple(route[1:])
    want = np.asarray(jmd.moe_ffn_oracle(jax.tree.map(jnp.asarray, ex),
                                         jnp.asarray(x), *route, C))
    troute = [torch.from_numpy(np.array(a)) for a in route]
    idx, comb = md.slot_maps(*troute, C)
    unhit = int((~(comb != 0).any(-1)).sum())
    assert unhit >= (2 if shape == "holes_unhit" else 0)
    got = md.moe_decode_split_reference(_t(ex), torch.from_numpy(x), idx,
                                        comb, sms=sms)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_decode_merge_order_follows_scatter_idx():
    """``scatter_idx`` other than ``idx``: each slot's result lands on the
    token it names, as in the plain version."""
    D, FF, T = 64, 256, 10
    ex = _t(_jexperts("swiglu", seed=3, quantized=False, D=D, FF=FF))
    x = torch.from_numpy(np.random.RandomState(4).randn(T, D).astype(
        np.float32))
    idx, comb = _comb(T, T, seed=5)
    perm = torch.from_numpy(np.random.RandomState(6).permutation(T))
    dst = perm[idx.long()].to(torch.int32)
    want = md.moe_ffn_slots_reference(ex, x, idx, comb, dst)
    got = md.moe_decode_split_reference(ex, x, idx, comb, dst, sms=7)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_decode_grid_bounds_every_run():
    """``decode_grid``'s scratch slots hold every run whatever the list's
    real length (at most the host's bound): for each count of listed
    tiles up to E, no pass-2 run meets more units than ``segs``."""
    for D, F, sms in ((4096, 14336, 132), (256, 384, 7), (128, 128, 1)):
        mt2, nk2 = -(-D // 128), -(-F // 128)
        mt1 = -(-F // 128)
        grid1, grid2, segs = md.decode_grid(E * mt1, E * mt2, nk2, sms)
        assert grid1 == min(E * mt1, sms) and grid2 == min(E * mt2 * nk2,
                                                           sms)
        for n in range(E + 1):
            runs = md.decode_runs(n * mt2, nk2, grid2, whole=False)
            assert max(len(r) for r in runs) <= segs
