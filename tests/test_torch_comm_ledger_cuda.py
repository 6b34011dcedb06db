"""The comm ledger's recorder on the card: over a one-rank NCCL group
laid out as the tensor axis alone, each of ``tp_utils``' five
collective helpers once on a CUDA tensor (bf16 and f32), inside
a ``CommRecorder``: the recorder's op counts equal the
``tp_utils.COLLECTIVES`` deltas (the all-to-all counts under no region)
and its bytes the operand sizes (an all-gather's times the group's one
rank); an async all-reduce waited for after a shift has that shift in
its window; with no recorder active, nothing is recorded.

Every test is ``gpu``-marked and skips without a CUDA device.  The file
imports neither JAX nor the JAX package::

    python -m pytest --noconftest -m gpu tests/test_torch_comm_ledger_cuda.py
"""

import socket
from collections import Counter

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def tensor_group():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from torchdistpackage_tpu_torch.dist import init_distributed, tpc

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_distributed(f"tcp://127.0.0.1:{port}", 1, 0, "cuda")
    try:
        tpc.setup_process_groups([("tensor", 1)])
        group = tpc.get_group("tensor")
        assert dist.get_backend(group) == "nccl"
        yield group
    finally:
        tpc.reset()
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_five_helpers_on_the_card(tensor_group, dtype):
    from torchdistpackage_tpu_torch.obs.comm_ledger import CommRecorder
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import tp_utils

    g = tensor_group
    x = torch.randn(4, 64, 96, device="cuda").to(dtype)
    nb = x.numel() * x.element_size()
    before = dict(tp_utils.COLLECTIVES)
    with CommRecorder() as rec:
        y = tp_utils._all_reduce(x, g, "reduce_from_tp")
        z = tp_utils._start_all_gather(x, g, 1, "gather_from_sp")()
        w = tp_utils._reduce_scatter(x, g, 1, "scatter_to_sp")
        v = tp_utils._shift(x, g, 1, "ring_shift")
        u = tp_utils._all_to_all(x.reshape(1, -1), g)
        tp_utils._count("zero_all_reduce")  # as its callers count it
        wait = tp_utils.start_all_reduce(x.clone(), g, name="zero_all_reduce")
        tp_utils._shift(x, g, 1, "ring_shift")
        wait()
    torch.cuda.synchronize()
    for out in (y, z, w, v, u.reshape(x.shape)):  # one rank: identities
        assert torch.equal(out, x)
    deltas = {k: n - before[k] for k, n in tp_utils.COLLECTIVES.items()
              if n != before[k]}
    led = rec.ledger()
    assert dict(Counter(c["op_name"] for c in led["collectives"]
                        if c["op_name"] is not None)) == deltas
    assert [(c["op"], c["bytes"], c["axes"], c["dim"], c["group_size"])
            for c in led["collectives"]] == [
        ("all-reduce", nb, ["tensor"], "tp", 1),
        ("all-gather", nb, ["tensor"], "tp", 1),
        ("reduce-scatter", nb, ["tensor"], "tp", 1),
        ("collective-permute", nb, ["tensor"], "tp", 1),
        ("all-to-all", nb, ["tensor"], "tp", 1),
        ("all-reduce", nb, ["tensor"], "tp", 1),
        ("collective-permute", nb, ["tensor"], "tp", 1)]
    assert led["collectives"][5]["async"] is True
    assert led["collectives"][5]["overlapped_idx"] == [6]
    assert led["per_dim"] == {"tp": {"bytes": 7 * nb, "ops": 7}}


def test_nothing_recorded_without_a_recorder(tensor_group):
    from torchdistpackage_tpu_torch.obs import comm_ledger as cl
    from torchdistpackage_tpu_torch.parallel.tensor_parallel import tp_utils

    x = torch.ones(8, device="cuda")
    with cl.CommRecorder() as rec:
        pass
    tp_utils._all_reduce(x, tensor_group, "reduce_from_tp")
    assert rec.records == [] and cl._ACTIVE is None
