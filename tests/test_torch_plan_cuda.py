"""The planning slice's knobs on the card: every built K3 tile against
the plain forward, every K1 / K2 split width against the plain split
schedule, and the planner's exact resident bytes against a step's live
tensors.

Every test here is ``gpu``-marked and skips without a CUDA device (a
kernel has no CPU mode).  The file imports neither JAX nor the JAX
package::

    python -m pytest --noconftest -m gpu tests/test_torch_plan_cuda.py
"""

import pytest
import torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _rows_ratio(got, want):
    """Largest error over the row tolerance: 2 bf16 ulps of the row's own
    largest |value| (the kernel rounds P to bf16 before P.V and its
    output once, each below one ulp of the row)."""
    err = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1).clamp_min(2.0 ** -100)
    tol = 2.0 * torch.exp2(torch.floor(torch.log2(scale)) - 7)
    assert torch.isfinite(got).all()
    return float((err / tol).max())


# ----------------------------------------------------- K3's built tiles


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("s,causal,window", [
    (640, True, None), (1000, True, 96), (100, False, None), (65, True, None)])
def test_every_k3_tile_matches_plain_on_card(cuda, hd, s, causal, window):
    """Each (block_k, stages) of ``FWD_TILES`` launches its own
    instantiation (the library's per-tile launch count) and gives ``o``
    within 2 bf16 ulps of its row and ``lse`` within 2e-5 of the plain
    forward on the same values in f32; S 1000, 100 and 65 leave a ragged
    last tile at both key widths."""
    from torchdistpackage_tpu_torch.ops import _build
    from torchdistpackage_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(hd + s)
    b, h, hkv = 2, 4, 2

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(
            torch.bfloat16)

    q, k, v = rnd(b, h, s, hd), rnd(b, hkv, s, hd), rnd(b, hkv, s, hd)
    args = (hd ** -0.5, causal, window)
    o_x, lse_x = fa.flash_fwd_reference(q.float(), k.float(), v.float(),
                                        *args)
    for bq, bk, ns in fa.FWD_TILES:
        name = f"flash_fwd_wgmma_kernel {bk} {ns}"
        before = _build.body_launches("flash_attention", name)
        o, lse = fa.flash_fwd(q, k, v, *args, block_q=bq, block_k=bk,
                              stages=ns)
        torch.cuda.synchronize()
        assert _build.body_launches("flash_attention", name) == before + 1
        assert _rows_ratio(o, o_x) <= 1.0, (bk, ns)
        assert float((lse - lse_x).abs().max()) <= 2e-5, (bk, ns)


@pytest.mark.gpu
def test_k3_default_tile_and_refusals_on_card(cuda):
    """The card's default is the main path's tile (128, 128, 2); a tile
    not built and an explicit tile on f32 raise before any launch."""
    from torchdistpackage_tpu_torch.ops import flash_attention as fa

    if "h100" in torch.cuda.get_device_name(cuda).lower():
        assert fa.default_tiles(cuda) == (128, 128, 2)
    q = torch.zeros(1, 2, 64, 64, device=cuda, dtype=torch.bfloat16)
    before = fa.LAUNCHES["flash_fwd"]
    with pytest.raises(ValueError, match="not built"):
        fa.flash_fwd(q, q, q, 0.125, True, None, block_k=256)
    with pytest.raises(ValueError, match="one tile"):
        fa.flash_fwd(q.float(), q.float(), q.float(), 0.125, True, None,
                     stages=3)
    assert fa.LAUNCHES["flash_fwd"] == before


# ------------------------------------------------ K1 / K2 split widths


def _decode_inputs(cuda, dtype, hd=128, groups=4, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    hkv, bs, mb, b = 2, 16, 12, 4
    nb = 1 + b * mb
    tables = torch.randperm(nb - 1, generator=g, device=cuda)[:b * mb]
    tables = (tables + 1).reshape(b, mb).to(torch.int32)
    offs = torch.tensor([0, 37, 130, mb * bs - 1], dtype=torch.int32,
                        device=cuda)
    q = torch.randn(b, hkv * groups, 1, hd, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(nb, hkv, bs, hd, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    return q, k, v, tables, offs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("window", [None, 48])
def test_every_nsplit_matches_plain_split_schedule_on_card(cuda, dtype,
                                                           window):
    """K1 at every ``nsplit`` from 1 to the table width against the plain
    split schedule at that width, in f32 on the same values (2 bf16 ulps
    of the row; f32 2e-5), and K2 at cp 1 finished equal to K1 bit for
    bit at each width."""
    from torchdistpackage_tpu_torch.ops import paged_attention as pa

    dt = getattr(torch, dtype)
    q, k, v, tables, offs = _decode_inputs(cuda, dt, seed=len(dtype))
    B, H, S, hd = q.shape
    for n in range(1, tables.shape[1] + 1):
        before = pa.LAUNCHES["paged_decode_attention"]
        got = pa.paged_decode_attention(q, k, v, tables, offs,
                                        window=window, nsplit=n)
        assert pa.LAUNCHES["paged_decode_attention"] == before + 1
        want = pa.finalize_paged_carry(pa.paged_decode_split_reference(
            q.float(), k.float(), v.float(), tables, offs, nsplit=n,
            window=window), B, H, S, hd, torch.float32)
        if dt == torch.float32:
            assert float((got - want).abs().max()) <= 2e-5, n
        else:
            assert _rows_ratio(got, want) <= 1.0, n
        carry = pa.paged_carry_attention(q, k, v, tables, offs,
                                         window=window, nsplit=n)
        assert torch.equal(got, pa.finalize_paged_carry(carry, B, H, S, hd,
                                                        dt)), n
    with pytest.raises(ValueError, match="nsplit"):
        pa.paged_decode_attention(q, k, v, tables, offs,
                                  nsplit=tables.shape[1] + 1)


# -------------------------------------------- the plan's resident bytes


@pytest.mark.gpu
def test_plan_resident_bytes_equal_the_live_tensors_on_card(cuda, tmp_path):
    """A bf16 GPT planned for one card (the MemoryModel over the plan's
    spec tree, moments in the parameters' dtype), built over a one-rank
    NCCL group and stepped once: its modeled parameter, gradient and
    moment bytes equal the bytes of the step's live tensors exactly."""
    import torch.distributed as dist

    from torchdistpackage_tpu_torch.dist import ParallelContext
    from torchdistpackage_tpu_torch.dist import autoplan as ap
    from torchdistpackage_tpu_torch.models import GPTConfig, init_gpt_params
    from torchdistpackage_tpu_torch.obs.mem_ledger import device_capacity

    cfg = GPTConfig(vocab_size=1024, dim=256, nheads=4, nlayers=2,
                    max_seq=256, dtype=torch.bfloat16, attn_impl="flash")
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 's'}",
                            world_size=1, rank=0)
    try:
        res = ap.plan(cfg, 1, 4, capacity_bytes=device_capacity(cuda),
                      emit=False)
        c = res["chosen"]
        assert c["key"] == "dp1" and res["basis"]["memory"] == "memory-model"
        ctx = ap.build_groups(c, ParallelContext())
        params = init_gpt_params(cfg, torch.Generator(
            device=cuda).manual_seed(0))
        run = ap.make_plan_step(c, cfg, ctx, params=params)
        g = torch.Generator(device=cuda).manual_seed(1)
        batch = {k: torch.randint(0, cfg.vocab_size, (4, cfg.max_seq),
                                  generator=g, device=cuda)
                 for k in ("tokens", "targets")}
        _, state, loss, _ = run.step(run.params, run.opt_state, batch)
        torch.cuda.synchronize()
        assert torch.isfinite(loss)
        live = ap.live_resident_bytes(run.params, state)
        for k, v in live.items():
            assert c["memory"][k] == v, (k, c["memory"][k], v)
    finally:
        dist.destroy_process_group()
