"""Hardened checkpoint I/O — the port's
``torchdistpackage_tpu/resilience/ckpt_guard.py``: bounded retries,
integrity manifests, quarantine.

The atomic commit of :class:`~..utils.checkpoint.CheckpointManager`
protects against an interrupted save (a half-written step is never
listed); nothing protects a committed step whose bytes rot afterwards.
This module closes that gap:

- :func:`with_retries` — bounded retry with exponential backoff and
  jitter around transient I/O errors, each retry a ``ckpt_retry`` event
  (the serving drain file and the migration wire use it too);
- integrity manifests — at commit, :func:`write_manifest` records the
  step's files (size and SHA-256 each) and the state's per-leaf tree
  (path, shape, dtype) in ``<dir>/manifests/<step>.json``;
  :func:`verify_checkpoint` re-hashes before a restore parses a byte;
- quarantine — :func:`quarantine_checkpoint` renames a bad step to
  ``<dir>.quarantine/<step>`` (``ckpt_quarantine``), and
  ``utils.checkpoint.auto_resume`` walks back to the newest good step.

:class:`GuardedCheckpointManager` composes them over the port's manager.
A step's manifest is written when the step commits, so no window is left
in which a committed step has none."""

from __future__ import annotations

import hashlib
import json
import os
import random
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.checkpoint import CheckpointManager, PyTree

MANIFEST_DIRNAME = "manifests"
MANIFEST_SCHEMA = "tdp-ckpt-manifest/v1"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification."""


def with_retries(
    fn: Callable[[], Any],
    retries: int = 3,
    base_delay_s: float = 0.05,
    max_delay_s: float = 2.0,
    jitter: float = 0.5,
    retry_on: Tuple[type, ...] = (OSError,),
    label: str = "ckpt",
    rng: Optional[random.Random] = None,
    on_retry: Optional[Callable[[int, float, BaseException], None]] = None,
) -> Any:
    """Call ``fn()``; on a ``retry_on`` exception retry up to ``retries``
    times with exponential backoff (``base * 2**attempt``, capped, plus
    uniform jitter).  Every retry emits a ``ckpt_retry`` event, or calls
    ``on_retry(attempt, delay_s, error)`` instead when given (the
    migration wire emits ``migration_retry`` through it); the last
    failure re-raises."""
    rng = rng or random.Random()
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            if attempt >= retries:
                raise
            delay = min(max_delay_s, base_delay_s * (2 ** attempt))
            delay += delay * jitter * rng.random()
            if on_retry is not None:
                on_retry(attempt + 1, delay, e)
            else:
                from ..obs.events import emit_event

                emit_event(
                    "ckpt_retry", label=label, attempt=attempt + 1,
                    retries=retries, delay_s=round(delay, 4), error=repr(e))
            time.sleep(delay)
            attempt += 1


def _sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _dtype_str(dtype) -> str:
    return str(dtype).replace("torch.", "")


def tree_spec(state: PyTree) -> List[Dict[str, Any]]:
    """Per-leaf structure record (JAX :116): ``{path, shape, dtype}`` for
    every tensor and scalar of a payload tree, the path in JAX's key-path
    form (``['params']['w']``, ``[0]``).  An optimizer records the
    parameters it optimizes (``['opt']['params'][i]``), not its state,
    which a fresh optimizer creates only at its first step — the record
    that tells a drifted model from the checkpoint's."""
    out: List[Dict[str, Any]] = []

    def walk(node, path):
        if isinstance(node, torch.optim.Optimizer):
            params = [p for g in node.param_groups for p in g["params"]]
            for i, p in enumerate(params):
                walk(p, f"{path}['params'][{i}]")
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}[{k!r}]")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
        elif isinstance(node, torch.Tensor):
            out.append({"path": path, "shape": list(node.shape),
                        "dtype": _dtype_str(node.dtype)})
        elif node is not None:
            out.append({"path": path, "shape": list(np.shape(node)),
                        "dtype": str(np.asarray(node).dtype)})

    walk(state, "")
    return out


def manifest_path(directory: str, step: int) -> str:
    return os.path.join(directory, MANIFEST_DIRNAME, f"{int(step)}.json")


def write_manifest(directory: str, step: int, state: Optional[PyTree] = None,
                   extra: Optional[Dict[str, Any]] = None,
                   known: Optional[Dict[str, Tuple[int, str]]] = None
                   ) -> Dict[str, Any]:
    """Hash every file of committed step ``step`` into
    ``<directory>/manifests/<step>.json`` (written to a temporary file and
    renamed) — JAX :142.  Call only once the step has committed.
    ``known``: ``{file: (size, sha256)}`` formed from the bytes as they
    were written, taken for a file of that size instead of reading it
    back."""
    step_dir = os.path.join(directory, str(int(step)))
    if not os.path.isdir(step_dir):
        raise FileNotFoundError(f"checkpoint step dir missing: {step_dir}")
    files = []
    max_mtime = 0.0
    for root, _dirs, names in os.walk(step_dir):
        for name in sorted(names):
            p = os.path.join(root, name)
            rel, size = os.path.relpath(p, step_dir), os.path.getsize(p)
            size_sha = (known or {}).get(rel)
            files.append({"path": rel, "size": size,
                          "sha256": size_sha[1] if size_sha
                          and size_sha[0] == size else _sha256(p)})
            max_mtime = max(max_mtime, os.path.getmtime(p))
    files.sort(key=lambda f: f["path"])
    manifest: Dict[str, Any] = {
        "schema": MANIFEST_SCHEMA,
        "step": int(step),
        # pins the manifest to THIS incarnation of the step: a recycled
        # step number rewrites every file, all then newer than this stamp
        "files_max_mtime": max_mtime,
        "n_files": len(files),
        "files": files,
    }
    if state is not None:
        manifest["tree"] = tree_spec(state)
    if extra:
        manifest.update(extra)
    mpath = manifest_path(directory, step)
    os.makedirs(os.path.dirname(mpath), exist_ok=True)
    tmp = mpath + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, mpath)
    return manifest


def verify_checkpoint(directory: str, step: int) -> List[str]:
    """Problems with committed step ``step``; ``[]`` = verified (JAX :192).

    A step without a manifest returns ``[]`` (it cannot be proven good,
    nor condemned; a failing restore still makes ``auto_resume`` walk
    back), and so does a stale manifest: a recorded step number that
    differs, or every recorded file newer than the manifest's recorded
    mtime (a recycled step number).  Otherwise every recorded file must
    exist with its size and SHA-256, and no unrecorded file may be
    there."""
    mpath = manifest_path(directory, step)
    if not os.path.exists(mpath):
        return []
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return [f"manifest unreadable: {e!r}"]
    step_dir = os.path.join(directory, str(int(step)))
    if not os.path.isdir(step_dir):
        return [f"step dir missing: {step_dir}"]
    if int(manifest.get("step", step)) != int(step):
        return []  # misplaced manifest: not evidence about THIS step
    rec_max = manifest.get("files_max_mtime")
    if rec_max is not None:
        surviving = [
            os.path.getmtime(os.path.join(step_dir, r["path"]))
            for r in manifest.get("files", [])
            if os.path.exists(os.path.join(step_dir, r["path"]))]
        if surviving and min(surviving) > float(rec_max) + 1e-3:
            return []  # every file postdates the manifest: stale
    problems: List[str] = []
    on_disk = set()
    for root, _dirs, names in os.walk(step_dir):
        for name in names:
            on_disk.add(os.path.relpath(os.path.join(root, name), step_dir))
    for rec in manifest.get("files", []):
        rel = rec["path"]
        p = os.path.join(step_dir, rel)
        if rel not in on_disk:
            problems.append(f"missing file: {rel}")
            continue
        size = os.path.getsize(p)
        if size != rec["size"]:
            problems.append(f"size mismatch: {rel} ({size} != {rec['size']})")
            continue
        if _sha256(p) != rec["sha256"]:
            problems.append(f"checksum mismatch: {rel}")
    for rel in sorted(on_disk - {r["path"] for r in manifest.get("files", [])}):
        problems.append(f"unrecorded file: {rel}")
    return problems


def verify_template(directory: str, step: int, template: PyTree) -> List[str]:
    """The manifest's recorded tree (when there is one) against
    ``template``'s paths, shapes and dtypes (JAX :268): a model that
    drifted since the save fails loudly."""
    mpath = manifest_path(directory, step)
    if not os.path.exists(mpath):
        return []
    with open(mpath) as f:
        manifest = json.load(f)
    recorded = manifest.get("tree")
    if not recorded:
        return []
    want = {r["path"]: (r["shape"], r["dtype"]) for r in recorded}
    have = {r["path"]: (r["shape"], r["dtype"]) for r in tree_spec(template)}
    problems = []
    for p in sorted(set(want) - set(have)):
        problems.append(f"template lacks leaf {p}")
    for p in sorted(set(have) - set(want)):
        problems.append(f"checkpoint lacks leaf {p}")
    for p in sorted(set(want) & set(have)):
        if want[p] != have[p]:
            problems.append(f"leaf {p}: ckpt {want[p]} vs template {have[p]}")
    return problems


def quarantine_dir(directory: str) -> str:
    return directory.rstrip(os.sep) + ".quarantine"


def quarantine_checkpoint(directory: str, step: int, reason: str = ""
                          ) -> Optional[str]:
    """Rename bad step ``step`` to ``<directory>.quarantine/<step>`` (its
    manifest beside it) and emit ``ckpt_quarantine`` (JAX :307).  Only
    process 0 renames — the directory is shared — and every process
    emits the event.  Returns the new path (None elsewhere, or when the
    step is already gone)."""
    from ..obs.events import _process_index, emit_event

    step_dir = os.path.join(directory, str(int(step)))
    dest = None
    if _process_index() == 0 and os.path.isdir(step_dir):
        qdir = quarantine_dir(directory)
        os.makedirs(qdir, exist_ok=True)
        dest = os.path.join(qdir, str(int(step)))
        if os.path.exists(dest):  # a recycled step number
            dest = f"{dest}.{int(time.perf_counter() * 1e6)}"
        try:
            os.replace(step_dir, dest)
            mpath = manifest_path(directory, step)
            if os.path.exists(mpath):
                os.replace(mpath, os.path.join(qdir, os.path.basename(mpath)))
        except FileNotFoundError:
            dest = None
    emit_event("ckpt_quarantine", step=int(step), directory=str(directory),
               quarantined_to=dest, reason=reason[:500])
    return dest


class GuardedCheckpointManager(CheckpointManager):
    """The port's :class:`~..utils.checkpoint.CheckpointManager` with the
    hardened I/O path (JAX :355): retried saves and restores, a manifest
    written when a step commits, manifests of vanished steps pruned,
    verification before every restore::

        with GuardedCheckpointManager(dir, max_to_keep=3) as mgr:
            mgr.save(step, state)
            start, state = auto_resume(mgr, template)
    """

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1, retries: int = 3,
                 base_delay_s: float = 0.05,
                 verify_on_restore: bool = True) -> None:
        super().__init__(directory, max_to_keep=max_to_keep,
                         save_interval_steps=save_interval_steps)
        self.retries = retries
        self.base_delay_s = base_delay_s
        self.verify_on_restore = verify_on_restore
        #: the tree specs of saves not yet committed, by step
        self._pending_manifests: Dict[int, List[Dict[str, Any]]] = {}
        # a fresh run over a cleaned directory restarts at step 0: drop
        # the manifests of steps that are gone
        self._prune_manifests()

    def _prune_manifests(self) -> None:
        """Delete ``manifests/<step>.json`` of every step the manager no
        longer lists (process 0 only)."""
        from ..obs.events import _process_index

        mdir = os.path.join(self.directory, MANIFEST_DIRNAME)
        if _process_index() != 0 or not os.path.isdir(mdir):
            return
        live = set(self.all_steps())
        for name in os.listdir(mdir):
            stem, ext = os.path.splitext(name)
            if ext == ".json" and stem.isdigit() and int(stem) not in live:
                try:
                    os.remove(os.path.join(mdir, name))
                except OSError:
                    pass  # gone already: not fatal

    digest_files = True

    def _committed(self, step: int, digests: Dict[str, Tuple[int, str]]
                   ) -> None:
        """The step's manifest, written as soon as it commits (process 0;
        the digests its own save formed while writing are taken, the
        other files hashed), then the manifests of vanished steps
        pruned."""
        spec = self._pending_manifests.pop(int(step), None)
        if spec is not None:
            with_retries(
                lambda: write_manifest(self.directory, step,
                                       extra={"tree": spec}, known=digests),
                retries=self.retries, base_delay_s=self.base_delay_s,
                label="manifest")
        self._prune_manifests()

    def save(self, step: int, state: PyTree, wait: bool = False,
             force: bool = False) -> bool:
        # shapes and dtypes now, for the manifest the commit writes
        self._pending_manifests[int(step)] = tree_spec(state)
        try:
            saved = with_retries(
                lambda: CheckpointManager.save(self, step, state, wait=False,
                                               force=force),
                retries=self.retries, base_delay_s=self.base_delay_s,
                label="save")
        except BaseException:
            self._pending_manifests.pop(int(step), None)
            raise
        from ..obs.events import _process_index

        if not saved or _process_index() != 0:  # process 0 writes it
            self._pending_manifests.pop(int(step), None)
        if wait:
            self.wait_until_finished()
        return saved

    def restore(self, step: Optional[int] = None,
                template: Optional[PyTree] = None, mesh: Any = None,
                specs: Any = None) -> PyTree:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints under {self.directory}")
        if self.verify_on_restore:
            problems = verify_checkpoint(self.directory, step)
            if not problems and template is not None:
                problems = verify_template(self.directory, step, template)
            if problems:
                raise CheckpointCorruptError(
                    f"checkpoint step {step} failed verification: "
                    + "; ".join(problems[:5])
                    + (f" (+{len(problems) - 5} more)"
                       if len(problems) > 5 else ""))
        return with_retries(
            lambda: CheckpointManager.restore(self, step, template=template,
                                              mesh=mesh, specs=specs),
            retries=self.retries, base_delay_s=self.base_delay_s,
            label="restore", retry_on=(OSError,))
