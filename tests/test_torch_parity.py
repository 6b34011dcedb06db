"""The port's run parity and artifact tools against the JAX package's, on
the CPU.

- ``obs.parity``: ``stream_of``, ``compare_streams``,
  ``param_divergence`` (over the port's tensor dicts against JAX's over
  the same values as arrays) and ``parity_section`` on the streams of
  ``tests/test_numerics_obs.py``'s parity tests, output for output.
- ``tools.parity_diff`` on the port's own RUNREPORTs: one launch of 2
  JAX-free ``tests/_torch_comm_ledger_worker.py`` processes over gloo
  trains the tiny GPT exact and with ``grad_compress='int8'`` under
  ``Telemetry``; the port's tool and JAX's on the two reports print the
  same lines and exit 0 with ``bounded``, the data-axis bytes at the
  count derived from the leaves' shapes; a diverged pair exits 1, a
  missing file 2.
- ``tools.bench_trend`` on rounds written under ``tmp_path``: the same
  lines and exit code as JAX's.
"""

import contextlib
import copy
import io
import json
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistpackage_tpu.models import GPTConfig as JGPTConfig
from torchdistpackage_tpu.models import init_gpt_params as jinit
from torchdistpackage_tpu.obs import parity as jpar
from torchdistpackage_tpu.tools import bench_trend as jtrend
from torchdistpackage_tpu.tools import parity_diff as jdiff
from torchdistpackage_tpu_torch.obs import parity as tpar
from torchdistpackage_tpu_torch.obs import validate_runreport
from torchdistpackage_tpu_torch.tools import bench_trend as ttrend
from torchdistpackage_tpu_torch.tools import parity_diff as tdiff

sys.path.insert(0, str(Path(__file__).parent))
import _torch_comm_ledger_worker as W  # noqa: E402
from _torch_ep_worker import flatten  # noqa: E402

# ------------------------------------------------------------ obs.parity

A = {i: 1.0 + 0.1 * i for i in range(10)}
#: tests/test_numerics_obs.py:269-316's stream pairs
STREAMS = {
    "exact": (A, dict(A), {}),
    "bounded": (A, {i: v * 1.001 for i, v in A.items()}, {"rtol": 0.05}),
    "diverged": (A, {**A, 7: 100.0}, {"rtol": 0.05}),
    "one_sided_nan": (A, {**A, 3: float("nan")}, {"rtol": 1e9}),
    "both_nan": ({**A, 3: float("nan")}, {**A, 3: float("nan")}, {}),
    "disjoint": (A, {100: 1.0}, {}),
    "long": ({i: math.sin(i) for i in range(300)},
             {i: math.sin(i) * (1 + 1e-4 * i) for i in range(300)},
             {"rtol": 0.5, "atol": 1e-3}),
}


def _same(got, want):
    """Equal, NaN equal to NaN (the drift curves carry no NaN; ``inf``
    compares as itself)."""
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_compare_streams_equal_jax(name):
    a, b, kw = STREAMS[name]
    _same(tpar.compare_streams(a, b, key="loss", **kw),
          jpar.compare_streams(a, b, key="loss", **kw))


def test_stream_of_equal_jax():
    recs = [
        {"type": "step", "step": 0, "loss": 1.0},
        {"type": "event", "kind": "compile"},
        {"type": "step", "step": 1, "loss": 2.0, "grad_norm": 0.5},
        {"step": 2, "loss": "oops"},
        {"step": 3, "loss": True},
        "not a record",
    ]
    report = {"numerics": {"timeline": [
        {"step": 0, "loss": 3.0}, {"step": 1, "loss": 4.0}, {"loss": 9.0}]}}
    for src, key in ((recs, "loss"), (recs, "grad_norm"), (report, "loss"),
                     ({}, "loss"), ([], "loss")):
        assert tpar.stream_of(src, key=key) == jpar.stream_of(src, key=key)


def _trees(seed):
    rs = np.random.RandomState(seed)
    a = {"w": rs.randn(4, 4).astype(np.float32),
         "blocks": {"b": np.ones(4, np.float32),
                    "c": [rs.randn(3).astype(np.float32),
                          np.zeros(2, np.float32)]}}
    b = copy.deepcopy(a)
    b["blocks"]["b"] = b["blocks"]["b"] * 1.5
    b["w"] = b["w"] + 1e-3
    b["blocks"]["c"][1] = b["blocks"]["c"][1] + 1.0
    return a, b


def _torch_tree(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _torch_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v, dtype) for v in tree]
    return torch.from_numpy(tree).to(dtype)


def test_param_divergence_equal_jax():
    """The port's tensor dicts (f32 and bf16) against JAX's over the same
    values: paths in JAX's spelling and flatten order, worst leaf first;
    a structure mismatch raises in both."""
    a, b = _trees(0)
    want = jpar.param_divergence(
        {"w": jnp.asarray(a["w"]), "blocks": {
            "b": jnp.asarray(a["blocks"]["b"]),
            "c": [jnp.asarray(x) for x in a["blocks"]["c"]]}},
        {"w": jnp.asarray(b["w"]), "blocks": {
            "b": jnp.asarray(b["blocks"]["b"]),
            "c": [jnp.asarray(x) for x in b["blocks"]["c"]]}})
    _same(tpar.param_divergence(_torch_tree(a), _torch_tree(b)), want)
    _same(tpar.param_divergence(a, b), want)  # numpy leaves too
    ha, hb = _torch_tree(a, torch.bfloat16), _torch_tree(b, torch.bfloat16)
    jwant = jpar.param_divergence(
        jax_tree(ha), jax_tree(hb))
    _same(tpar.param_divergence(ha, hb), jwant)
    with pytest.raises(ValueError):
        tpar.param_divergence({"w": torch.ones(2)}, {})
    with pytest.raises(ValueError):
        jpar.param_divergence({"w": jnp.ones(2)}, {})


def jax_tree(tree):
    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [jax_tree(v) for v in tree]
    return jnp.asarray(tree.float().numpy()).astype(jnp.bfloat16)


def test_parity_section_equal_jax():
    streams = [jpar.compare_streams(*STREAMS[k][:2], **STREAMS[k][2])
               for k in ("exact", "bounded")]
    a, b = _trees(1)
    div = jpar.param_divergence(a, b)
    for kw in ({}, {"params": div, "labels": ("fp", "int8")},
               {"extra": {"note": "x"}}):
        _same(tpar.parity_section(streams, **kw),
              jpar.parity_section(streams, **kw))
    _same(tpar.parity_section(), jpar.parity_section())
    assert tpar.PARITY_SCHEMA == jpar.PARITY_SCHEMA
    assert tpar.PARITY_VERDICTS == jpar.PARITY_VERDICTS


# ------------------------------------------------------- tools.parity_diff


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    rs = np.random.RandomState(1)
    kw = W.PARITY_GPT
    import jax

    p = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0),
                                       JGPTConfig(**kw, dtype=jnp.float32)))
    inp = {f"pgpt/params/{k}": v for k, v in flatten(p).items()}
    for i in range(W.STEPS):
        for k in ("tokens", "targets"):
            inp[f"pgpt/batch{i}/{k}"] = rs.randint(
                0, kw["vocab_size"], (W.ROWS, kw["max_seq"])).astype(np.int32)
    tmp = tmp_path_factory.mktemp("parity2")
    out = W.results(W.start("parity", 2, inp, tmp), tmp)
    for arm in ("exact", "int8"):
        (tmp / f"{arm}.json").write_text(json.dumps(out[0][f"{arm}/report"]))
    return out, tmp


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _int8_payload(c):
    g = 1
    while g * 2 <= 256 and c % (g * 2) == 0:
        g *= 2
    return c + 4 * (c // g)


def _derived(leaves, n=2):
    """Data-axis ledger bytes of one step of each arm, from the leaves'
    shapes: the exact arm all-reduces every f32 grad; the int8 arm sends
    a leaf of ``COMPRESS_MIN`` elements or more through the int8 mean —
    ``n - 1`` ring hops of its quantized ``1/n`` chunk, then the
    all-gather of the ``n`` finished chunks — and the rest exact; both
    all-reduce the f32 loss."""
    exact = int8 = 4
    for _, shape, size in leaves:
        E = int(np.prod(shape))
        exact += size * E
        if E >= W.COMPRESS_MIN and E % n == 0:
            int8 += (n - 1) * _int8_payload(E // n) + n * _int8_payload(E // n)
        else:
            int8 += size * E
    return exact, int8


def test_parity_diff_bounded_on_the_ports_int8_arm(world2):
    """Exit 0, ``bounded``, the data-axis bytes at the derived counts and
    their ratio; JAX's tool on the same files prints the same."""
    out, tmp = world2
    exact, int8 = _derived(out[0]["leaves"])
    for arm in ("exact", "int8"):
        rep = out[0][f"{arm}/report"]
        assert validate_runreport(rep) == []
        assert rep["numerics"]["dtype_ledgers"] == []
    argv = [str(tmp / "exact.json"), str(tmp / "int8.json"),
            "--label-a", "exact", "--label-b", "int8"]
    rc, text, _ = _run(tdiff.main, argv)
    jrc, jtext, _ = _run(jdiff.main, argv)
    assert (rc, text) == (jrc, jtext)
    line = json.loads(text.strip().splitlines()[-1])
    assert rc == 0 and line["verdict"] == "bounded"
    assert line["comm_axis_bytes"] == {"data": {
        "a": exact, "b": int8, "ratio": round(exact / int8, 3)}}
    assert "dtype_bytes_delta" not in line
    assert tdiff.dtype_shift(out[0]["exact/report"],
                             out[0]["int8/report"]) is None
    # the ranks' ledgers are the same
    assert out[1]["int8/report"]["comm"]["ledger"]["per_dim"] == \
        out[0]["int8/report"]["comm"]["ledger"]["per_dim"]


def test_parity_diff_diverged_and_missing(world2, tmp_path):
    out, tmp = world2
    bad = copy.deepcopy(out[0]["int8/report"])
    bad["numerics"]["timeline"][-1]["loss"] *= 2.0
    (tmp_path / "bad.json").write_text(json.dumps(bad))
    argv = [str(tmp / "exact.json"), str(tmp_path / "bad.json")]
    rc, text, err = _run(tdiff.main, argv)
    assert (rc, text, err) == _run(jdiff.main, argv)
    assert rc == 1 and json.loads(text.strip().splitlines()[-1])[
        "verdict"] == "diverged" and "DIVERGED" in err
    argv = [str(tmp / "exact.json"), str(tmp_path / "missing.json")]
    rc, text, err = _run(tdiff.main, argv)
    assert rc == 2 and (rc, text, err) == _run(jdiff.main, argv)


def test_parity_diff_on_jsonl_records(world2, tmp_path):
    """Records files (one step record a line) load as streams, with no
    report beside them: no comm shift."""
    out, _ = world2
    paths = []
    for arm in ("exact", "int8"):
        p = tmp_path / f"{arm}.jsonl"
        p.write_text("\n".join(json.dumps({"type": "step", **r}) for r in
                               out[0][f"{arm}/report"]["numerics"]["timeline"]
                               ) + "\nnot json\n")
        paths.append(str(p))
    rc, text, err = _run(tdiff.main, paths)
    assert (rc, text, err) == _run(jdiff.main, paths)
    line = json.loads(text.strip().splitlines()[-1])
    assert rc == 0 and line["verdict"] == "bounded"
    assert "comm_axis_bytes" not in line


# ------------------------------------------------------- tools.bench_trend


def _round(n, lines, parsed=None):
    return {"n": n, "tail": "\n".join(json.dumps(x) for x in lines)
            + "\nnot json\n", "parsed": parsed}


@pytest.mark.parametrize("case", ["clean", "regression", "stale", "empty"])
def test_bench_trend_equal_jax(tmp_path, case):
    rounds = {
        1: [{"metric": "train", "value": 100.0, "mfu": 0.4,
             "comm_bytes_per_dim": {"dp": 10, "tp": 5}, "config": "c"},
            {"metric": "serve", "value": 50.0, "slo_attainment": 0.9}],
        2: [{"metric": "train", "value": 103.0, "mfu": 0.41},
            {"metric": "serve", "value": 51.0}],
        3: [{"metric": "train", "value": 104.0,
             "grad_norm_final": 1.2}],
    }
    if case == "regression":
        rounds[3] = [{"metric": "train", "value": 90.0}]
    if case == "stale":
        rounds[3] = [{"metric": "train", "value": 10.0, "stale": True}]
    for n, lines in rounds.items():
        (tmp_path / f"BENCH_r{n:02d}.json").write_text(json.dumps(
            _round(n, lines, parsed=lines[0] if n == 2 else None)))
    (tmp_path / "BENCH_r09.json").write_text("{broken")
    argv = ["--dir", str(tmp_path)]
    if case == "empty":
        argv += ["--glob", "NOTHING_*.json"]
    got, want = _run(ttrend.main, argv), _run(jtrend.main, argv)
    assert got == want
    assert got[0] == {"clean": 0, "regression": 1, "stale": 0,
                      "empty": 2}[case]
    assert ttrend.AUX_KEYS == jtrend.AUX_KEYS
