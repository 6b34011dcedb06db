"""The paged-attention kernel's plain version against the JAX package, on
the CPU; the kernel itself against its plain version on the card.

- The plain version (``paged_decode_attention_reference``, which the
  wrapper takes for CPU tensors) matches the JAX Pallas kernel run in
  interpret mode at the shapes of tests/test_paged_attention.py, and the
  JAX gather oracle, within f32 ``atol`` 2e-6 — decode, a 3-row verify
  shape and a prefill chunk, vector and scalar offsets, G in {1, 2},
  window None or 6, and the int8 pool; and at the card's tensor-core
  tile shapes (blocks of 16, S_in 80 and 200, G 1 and 4, window 48).
- The CUDA kernel itself is held against the plain version on the card
  by tests/test_torch_cuda_kernels.py (``gpu``-marked).
- An AST check: nothing in the port, nor ``chip_smoke.py``, nor the
  expert-parallel test worker ``tests/_torch_ep_worker.py``, imports
  ``jax`` or ``torchdistpackage_tpu``.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistpackage_tpu.ops.paged_attention import (
    paged_decode_attention as jax_kernel,
)
from torchdistpackage_tpu.serving import paged_attention as jax_gather
from torchdistpackage_tpu_torch.ops import _build
from torchdistpackage_tpu_torch.ops.paged_attention import (
    LAUNCHES,
    modeled_attend_temp_bytes,
    paged_decode_attention,
    paged_decode_attention_reference,
    resolve_attn_impl,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
ATOL = 2e-6  # tests/test_paged_attention.py's kernel-vs-oracle tolerance
B, HKV, BS, HD, MB = 2, 2, 4, 8, 5
NB = 1 + B * MB


def _pool(seed, quantized=False):
    rs = np.random.RandomState(seed)
    if quantized:
        return (rs.randint(-127, 128, (NB, HKV, BS, HD)).astype(np.int8),
                rs.uniform(1e-3, 2e-2, (NB, HKV, BS)).astype(np.float32))
    return rs.randn(NB, HKV, BS, HD).astype(np.float32)


def _tables():
    return (np.random.RandomState(0).permutation(np.arange(1, NB))
            .reshape(B, MB).astype(np.int32))


def _j(x):
    return tuple(jnp.asarray(a) for a in x) if isinstance(x, tuple) \
        else jnp.asarray(x)


def _t(x):
    return tuple(torch.from_numpy(a) for a in x) if isinstance(x, tuple) \
        else torch.from_numpy(x)


# (groups, S_in, window, offsets): decode, verify-shaped and chunk rows;
# every axis covered without the full cross product (each interpret-mode
# JAX call is slow)
CASES = [
    (1, 1, None, [9, 14]), (2, 1, 6, [9, 14]), (2, 3, 6, [9, 14]),
    (2, 8, None, [3, 10]), (1, 8, 6, [0, 12]), (1, 3, None, 7),
]


@pytest.mark.parametrize("groups,s_in,window,offsets", CASES)
def test_plain_matches_jax_kernel_and_gather(groups, s_in, window, offsets):
    kp, vp, tables = _pool(1), _pool(2), _tables()
    q = np.random.RandomState(groups * 10 + s_in).randn(
        B, HKV * groups, s_in, HD).astype(np.float32)
    offs = np.asarray(offsets, np.int32)
    got = paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                 _t(offs) if offs.ndim else int(offs),
                                 window=window)
    want_kernel = jax_kernel(_j(q), _j(kp), _j(vp), _j(tables), _j(offs),
                             window=window)
    want_gather = jax_gather(_j(q), _j(kp), _j(vp), _j(offs),
                             tables=_j(tables), window=window)
    for want in (want_kernel, want_gather):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


# The card's tensor-core tiling (64 query rows a CTA, key tiles of 4 pool
# blocks of 16): S_in 80 (a ragged last row tile, tiles across two query
# heads), 200, a window of 48 (its edge inside a block and inside a key
# tile); blocks of 16 positions, 20 a slot.
TILE_BS, TILE_MB = 16, 20
TILE_NB = 1 + B * TILE_MB


@pytest.mark.parametrize("groups,s_in,window", [
    (4, 80, None), (4, 80, 48), (1, 200, 48), (4, 200, 48)])
def test_plain_matches_jax_at_tile_shapes(groups, s_in, window):
    rs = np.random.RandomState(s_in + groups)
    kp, vp = (rs.randn(TILE_NB, HKV, TILE_BS, HD).astype(np.float32)
              for _ in range(2))
    tables = (rs.permutation(np.arange(1, TILE_NB))
              .reshape(B, TILE_MB).astype(np.int32))
    offs = np.asarray([0, 70], np.int32)
    q = rs.randn(B, HKV * groups, s_in, HD).astype(np.float32)
    got = paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                 _t(offs), window=window)
    want_kernel = jax_kernel(_j(q), _j(kp), _j(vp), _j(tables), _j(offs),
                             window=window)
    want_gather = jax_gather(_j(q), _j(kp), _j(vp), _j(offs),
                             tables=_j(tables), window=window)
    for want in (want_kernel, want_gather):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("s_in", [3])
def test_plain_int8_matches_jax_kernel(s_in):
    kq, vq, tables = _pool(7, True), _pool(8, True), _tables()
    offs = np.asarray([11, 6], np.int32)
    q = np.random.RandomState(s_in).randn(B, 4, s_in, HD).astype(np.float32)
    got = paged_decode_attention(_t(q), _t(kq), _t(vq), _t(tables),
                                 _t(offs))
    want = jax_kernel(_j(q), _j(kq), _j(vq), _j(tables), _j(offs))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_cpu_tensors_take_the_plain_version():
    kp, vp, tables = _t(_pool(1)), _t(_pool(2)), _t(_tables())
    q = torch.randn(B, 4, 1, HD, generator=torch.Generator().manual_seed(0))
    offs = torch.tensor([9, 14], dtype=torch.int32)
    before = LAUNCHES["paged_decode_attention"]
    got = paged_decode_attention(q, kp, vp, tables, offs, window=6)
    want = paged_decode_attention_reference(q, kp, vp, tables, offs,
                                            window=6)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert LAUNCHES["paged_decode_attention"] == before


def test_other_devices_raise():
    """A tensor neither on the CPU nor on a card is refused — the
    wrapper has no silent fall back."""
    q = torch.empty(B, 4, 1, HD, device="meta")
    with pytest.raises(ValueError, match="device"):
        paged_decode_attention(q, q, q, q, 0)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("paged_attention")


def test_resolve_attn_impl():
    assert resolve_attn_impl("auto", "cpu") == "gather"
    assert resolve_attn_impl(None, "cuda") == "cuda"
    assert resolve_attn_impl("gather", "cuda") == "gather"
    with pytest.raises(ValueError):
        resolve_attn_impl("pallas", "cpu")


def test_modeled_attend_temp_bytes():
    kw = dict(batch=8, kv_heads=8, max_blocks=512, block_size=16,
              head_dim=128, itemsize=2)
    assert modeled_attend_temp_bytes("gather", **kw) == 2 * 8 * 8 * 512 * 16 * 128 * 2
    assert modeled_attend_temp_bytes("cuda", groups=4, **kw) == 8 * 8 * 2 * 4 * 128 * 2
    with pytest.raises(ValueError):
        modeled_attend_temp_bytes("pallas", **kw)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    files = sorted((REPO / "torchdistpackage_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py"]
    files += sorted((REPO / "tests").glob("_torch_*_worker.py"))
    files += sorted((REPO / "tests").glob("test_torch_*_cuda.py"))
    files += [REPO / "tests" / "test_torch_cuda_kernels.py"]
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "torchdistpackage_tpu"), (
                f"{path.relative_to(REPO)} imports {mod}")
