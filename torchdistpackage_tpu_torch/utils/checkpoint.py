"""Step-numbered checkpoints, resume and model-parallel naming — the
port's counterpart of ``torchdistpackage_tpu/utils/checkpoint.py``.

The reference writes through Orbax.  The port's format is its own:

- one numbered directory a step, ``<directory>/<step>/``, holding one
  ``torch.save`` file a process (``rank<r>.pt``, every rank its own
  shard of the state) and process 0's ``meta.json``;
- a save writes into ``<directory>/.tmp-<step>/`` and process 0 commits
  it by one atomic rename once every rank's file is written, so
  :meth:`CheckpointManager.all_steps` lists only committed steps;
- a restore reads with ``torch.load(weights_only=True)``.

The payload is a tree (dicts, lists, tuples) of tensors, Python scalars
and ``torch.optim.Optimizer`` objects (saved as their ``state_dict``).
Training in the port is in place — the step updates the parameter
tensors and the optimizer it was given — so a save copies the state to
the host before it returns (an asynchronous save then writes that copy
on a thread), and a restore with a template writes INTO the template's
tensors (``copy_``) and optimizers (``load_state_dict``) instead of
handing back new ones: the optimizer's references to the parameters
stay live.  The reference's resharding restore (``mesh=`` / ``specs=``)
is not ported yet; it raises ``NotImplementedError``.

- :func:`get_mp_ckpt_suffix` — the reference's per-partition suffix.
- :func:`save_checkpoint` / :func:`load_checkpoint` — one-shot.
- :class:`CheckpointManager` — retention, the save interval, resume.
- :func:`auto_resume` — restore the newest GOOD checkpoint, walking
  back past (and quarantining) corrupt ones.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..obs.comm_ledger import note

PyTree = Any

#: the key an optimizer's ``state_dict`` is saved under
OPTIMIZER_KEY = "__optimizer_state_dict__"
CKPT_FORMAT = "tdp-torch-ckpt/v1"
_RESHARD = ("the resharding restore (mesh= / specs=) is not ported yet: "
            "ROADMAP queue A, 'Obs, resilience, tools, utils and HF "
            "conversion'")


def get_mp_ckpt_suffix() -> str:
    """Per-partition filename suffix, e.g. ``_tp_0_pp_1`` (JAX :31); empty
    without model parallelism."""
    from ..dist.topology import PIPE_AXIS, TENSOR_AXIS, tpc

    suffix = ""
    if tpc.is_mode_inited(TENSOR_AXIS):
        suffix += f"_tp_{tpc.get_group_rank(TENSOR_AXIS)}"
    if tpc.is_mode_inited(PIPE_AXIS):
        suffix += f"_pp_{tpc.get_group_rank(PIPE_AXIS)}"
    return suffix


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def _rank() -> int:
    return dist.get_rank() if _grouped() else 0


def _process_count() -> int:
    """The default process group's size (1 without one)."""
    return dist.get_world_size() if _grouped() else 1


def _barrier() -> None:
    if _process_count() > 1:
        dist.barrier()


def _pod_any(flag: bool, n_proc: int) -> bool:
    """A per-process flag OR-ed over the default process group (JAX :137):
    a collective when ``n_proc > 1``, the flag itself otherwise."""
    if n_proc <= 1:
        return bool(flag)
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=dev)
    note("all-reduce", t)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def to_host(tree: PyTree, staging: Optional[Dict[str, torch.Tensor]] = None,
            path: str = "") -> PyTree:
    """A host copy of a payload tree: every tensor copied to the CPU (a
    CPU tensor cloned), every optimizer replaced by a host copy of its
    ``state_dict`` under :data:`OPTIMIZER_KEY`; scalars kept.  The copy
    is complete when it returns, so the caller may go on training in
    place.  ``staging``: pinned host tensors by tree path, reused from
    one call to the next (allocated where missing) — a card-to-host copy
    into pinned memory runs at the link's rate, into pageable memory at
    a fraction of it."""
    out = _to_host(tree, staging, path)
    if staging and torch.cuda.is_available():
        torch.cuda.current_stream().synchronize()  # the pinned copies
    return out


def _to_host(tree, staging, path):
    if isinstance(tree, torch.optim.Optimizer):
        return {OPTIMIZER_KEY: _to_host(tree.state_dict(), staging, path)}
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if staging is None or not t.is_cuda:
            return t.to("cpu", copy=True)
        buf = staging.get(path)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = staging[path] = torch.empty(t.shape, dtype=t.dtype,
                                              pin_memory=True)
        return buf.copy_(t, non_blocking=True)
    if isinstance(tree, dict):
        return {k: _to_host(v, staging, f"{path}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v, staging, f"{path}/{i}")
                          for i, v in enumerate(tree))
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}: the "
                    f"payload holds tensors, optimizers and Python scalars")


def restore_into(template: PyTree, loaded: PyTree, path: str = "") -> PyTree:
    """``loaded`` (as :func:`to_host` wrote it) written into ``template``:
    each tensor by ``copy_`` (shape and dtype must match), each optimizer
    by ``load_state_dict``; returns the template's structure with the
    loaded scalars.  A structural difference raises ``ValueError``
    ("key mismatch")."""
    where = path or "<root>"
    if isinstance(template, torch.optim.Optimizer):
        if not isinstance(loaded, dict) or OPTIMIZER_KEY not in loaded:
            raise ValueError(f"key mismatch at {where}: the template holds "
                             f"an optimizer, the checkpoint does not")
        template.load_state_dict(loaded[OPTIMIZER_KEY])
        return template
    if isinstance(template, dict):
        if not isinstance(loaded, dict) or set(template) != set(loaded):
            got = sorted(loaded) if isinstance(loaded, dict) else \
                type(loaded).__name__
            raise ValueError(f"key mismatch at {where}: template keys "
                             f"{sorted(template)}, checkpoint {got}")
        return {k: restore_into(template[k], loaded[k], f"{path}/{k}")
                for k in template}
    if isinstance(template, (list, tuple)):
        if not isinstance(loaded, (list, tuple)) or \
                len(loaded) != len(template):
            raise ValueError(f"key mismatch at {where}: a sequence of "
                             f"{len(template)} in the template")
        return type(template)(restore_into(t, v, f"{path}/{i}")
                              for i, (t, v) in enumerate(zip(template,
                                                             loaded)))
    if isinstance(template, torch.Tensor):
        if not isinstance(loaded, torch.Tensor) or \
                loaded.shape != template.shape or \
                loaded.dtype != template.dtype:
            got = (f"{tuple(loaded.shape)} {loaded.dtype}"
                   if isinstance(loaded, torch.Tensor)
                   else type(loaded).__name__)
            raise ValueError(
                f"key mismatch at {where}: template "
                f"{tuple(template.shape)} {template.dtype}, checkpoint {got}")
        with torch.no_grad():
            template.copy_(loaded)
        return template
    if isinstance(loaded, (dict, list, tuple, torch.Tensor)):
        raise ValueError(f"key mismatch at {where}: a scalar in the template")
    return loaded


def _write(obj: PyTree, path: str, digest: bool = False
           ) -> Optional[Tuple[int, str]]:
    """``torch.save`` of ``obj`` into ``path``, flushed to the disk.
    ``digest``: the file is serialised in memory first and its SHA-256
    formed on a second thread while the bytes are written; returns
    ``(size, sha256)``."""
    if not digest:
        with open(path, "wb") as f:
            torch.save(obj, f)
            f.flush()
            os.fsync(f.fileno())
        return None
    buf = io.BytesIO()
    torch.save(obj, buf)
    data = buf.getbuffer()
    sha: Dict[str, str] = {}
    hasher = threading.Thread(  # hashlib lets go of the GIL
        target=lambda: sha.update(hex=hashlib.sha256(data).hexdigest()))
    hasher.start()
    try:
        with open(path, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
    finally:
        hasher.join()
    return len(data), sha["hex"]


def _write_meta(step_dir: str, step: int) -> None:
    """The step's ``meta.json`` (format, step, process count), written by
    process 0 before the payload files: a file that no later write to a
    payload touches, so a manifest tells a damaged step (some files newer
    than the manifest) from a recycled step number (all of them)."""
    with open(os.path.join(step_dir, "meta.json"), "w") as f:
        json.dump({"format": CKPT_FORMAT, "step": int(step),
                   "processes": _process_count()}, f)


def _read(step_dir: str) -> PyTree:
    return torch.load(os.path.join(step_dir, f"rank{_rank()}.pt"),
                      map_location="cpu", weights_only=True)


def save_checkpoint(path: str, state: PyTree, force: bool = True) -> None:
    """Write ``state`` to the directory ``path`` (each process its own
    ``rank<r>.pt``), committed by an atomic rename; ``force`` replaces an
    existing checkpoint there."""
    path = os.path.abspath(path)
    tmp = path.rstrip(os.sep) + ".tmp"
    host = to_host(state)
    if _rank() == 0:
        if os.path.exists(path) and not force:
            raise FileExistsError(f"checkpoint exists: {path}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        _write_meta(tmp, -1)
    _barrier()
    _write(host, os.path.join(tmp, f"rank{_rank()}.pt"))
    _barrier()
    if _rank() == 0:
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
    _barrier()


def load_checkpoint(path: str, template: Optional[PyTree] = None,
                    mesh: Any = None, specs: Any = None) -> PyTree:
    """Read this process's file of the checkpoint at ``path``: the host
    tree when ``template`` is None, else written into ``template`` (see
    :func:`restore_into`)."""
    if mesh is not None or specs is not None:
        raise NotImplementedError(_RESHARD)
    loaded = _read(os.path.abspath(path))
    return loaded if template is None else restore_into(template, loaded)


def _probe_readable(mgr: "CheckpointManager", step: int) -> bool:
    """Can step ``step`` be read at all, template-free (JAX :151)?  Tells a
    corrupt checkpoint from a restore template that does not fit."""
    try:
        mgr.restore(step)
        return True
    except Exception:
        return False


def auto_resume(mgr: "CheckpointManager", template: PyTree,
                mesh: Any = None, specs: Any = None, verify: bool = True):
    """``(start_step, state)`` (JAX :161): the newest GOOD checkpoint
    written into ``template`` (resuming at ``step + 1``), else
    ``(0, template)`` untouched.

    A step proven corrupt — its integrity manifest
    (``resilience.ckpt_guard``) fails, or a manifest-less step cannot be
    read even template-free — is quarantined (renamed to
    ``<directory>.quarantine/<step>``, a ``ckpt_quarantine`` event) and
    the walk goes on to the next older step.  Everything else fails
    loudly: a persistent ``OSError`` (retried first), a restore of a
    verified step that fails (a template that drifted), and, with several
    processes, any restore failure after an agreed verification.  With
    several processes each step's verdict is OR-ed over the default
    process group, so a step corrupt on one rank is condemned on all,
    and only process 0 renames it.  ``verify=False``: raise on any
    failure."""
    from ..resilience.ckpt_guard import (
        CheckpointCorruptError,
        GuardedCheckpointManager,
        manifest_path,
        quarantine_checkpoint,
        verify_checkpoint,
        verify_template,
        with_retries,
    )

    if mesh is not None or specs is not None:
        raise NotImplementedError(_RESHARD)
    n_proc = _process_count()
    # a GuardedCheckpointManager retries transient I/O itself
    restore_retries = 0 if isinstance(mgr, GuardedCheckpointManager) else 3

    def _quarantine(step: int, reason: str) -> None:
        quarantine_checkpoint(mgr.directory, step, reason=reason)
        mgr.reload()

    for step in sorted(mgr.all_steps(), reverse=True):
        has_manifest = False
        if verify:
            problems = verify_checkpoint(mgr.directory, step)
            if _pod_any(bool(problems), n_proc):
                _quarantine(step, reason="integrity verification failed: "
                            + "; ".join(problems[:3]
                                        or ["(on another process)"]))
                continue
            has_manifest = os.path.exists(manifest_path(mgr.directory, step))
            if has_manifest:
                drift = verify_template(mgr.directory, step, template)
                if drift:
                    raise ValueError(
                        f"auto_resume: checkpoint step {step} verified OK "
                        "but the restore template does not match its "
                        "recorded tree (drifted model/config?): "
                        + "; ".join(drift[:5]))
        try:
            state = with_retries(
                lambda s=step: mgr.restore(s, template=template),
                retries=restore_retries, label="restore",
                retry_on=(OSError,))
            return step + 1, state
        except OSError:
            raise  # storage trouble, not proven corruption
        except Exception as e:
            if not verify or n_proc > 1:
                raise
            if not isinstance(e, CheckpointCorruptError) and (
                    has_manifest or _probe_readable(mgr, step)):
                raise  # the bytes are fine: the template is at fault
            _quarantine(step, reason=repr(e))
    return 0, template


class CheckpointManager:
    """Step-numbered checkpoints with retention and resume (JAX :265)::

        with CheckpointManager(dir, max_to_keep=3) as mgr:
            mgr.save(step, {"params": params, "opt": opt_state})
            ...
            state = mgr.restore(mgr.latest_step(),
                                template={"params": params, "opt": opt_state})

    - ``save`` declines a step at or below the newest one, and one off
      ``save_interval_steps`` unless no checkpoint exists yet or
      ``force=True`` (Orbax's decision); it returns whether it saved.
    - ``save(wait=False)`` copies the state to the host, then writes it on
      a thread, which commits the step when done (with several processes
      process 0 commits it in :meth:`wait_until_finished`, once every
      rank's file is written); :meth:`wait_until_finished` is also run by
      the next save, :meth:`close` and the context manager's exit, even
      while an exception unwinds.
    - ``max_to_keep``: the newest steps kept once a step commits.
    - Events: ``checkpoint_save`` when a save is accepted,
      ``checkpoint_restore`` when a template is restored.
    """

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1) -> None:
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        os.makedirs(self.directory, exist_ok=True)
        self._pending: Optional[dict] = None
        #: pinned host tensors a save copies the card's state into,
        #: reused by the next save once this one is written
        self._staging: Dict[str, torch.Tensor] = {}

    # -------------------------------------------------------------- steps

    def all_steps(self) -> List[int]:
        """The committed steps, oldest first."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit()
                      and os.path.isdir(os.path.join(self.directory, d)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def reload(self) -> None:
        """Re-scan the directory after a step was renamed aside; the port's
        manager reads the directory at every query, so nothing is
        cached."""

    def should_save(self, step: int) -> bool:
        """Orbax's default decision: never at or below the newest step
        (committed or pending); else on the interval, or when there is no
        checkpoint at all."""
        known = self.all_steps()
        if self._pending is not None:
            known.append(self._pending["step"])
        if known and max(known) >= step:
            return False
        return step % self.save_interval_steps == 0 or not known

    # ---------------------------------------------------------------- save

    def save(self, step: int, state: PyTree, wait: bool = False,
             force: bool = False) -> bool:
        """Returns True iff the step was saved (see the class note)."""
        if not force and not self.should_save(step):
            return False
        self.wait_until_finished()
        step = int(step)
        if step in self.all_steps():
            raise ValueError(f"checkpoint for step {step} already exists "
                             f"under {self.directory}")
        host = to_host(state, self._staging)
        tmp = os.path.join(self.directory, f".tmp-{step}")
        if _rank() == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            _write_meta(tmp, step)
        _barrier()
        pending = {"step": step, "tmp": tmp, "error": None, "digests": {}}
        alone = _process_count() == 1

        def write():
            try:
                name = f"rank{_rank()}.pt"
                got = _write(host, os.path.join(tmp, name),
                             digest=self.digest_files)
                if got is not None:
                    pending["digests"][name] = got
                if alone:  # commits as soon as it is written, as Orbax
                    self._commit(pending)
            except BaseException as e:  # re-raised by wait_until_finished
                pending["error"] = e

        pending["thread"] = threading.Thread(target=write, daemon=True)
        pending["thread"].start()
        self._pending = pending
        from ..obs.events import emit_event

        emit_event("checkpoint_save", step=step, wait=bool(wait),
                   directory=str(self.directory))
        if wait:
            self.wait_until_finished()
        return True

    def _commit(self, pending: dict) -> None:
        """Process 0: rename the step's temporary directory into place,
        drop the steps past ``max_to_keep``, run :meth:`_committed`."""
        os.replace(pending["tmp"],
                   os.path.join(self.directory, str(pending["step"])))
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)),
                              ignore_errors=True)
        self._committed(pending["step"], pending["digests"])

    #: whether a save forms its own file's SHA-256 while writing it (for
    #: a manifest written at commit)
    digest_files = False

    def _committed(self, step: int, digests: Dict[str, Tuple[int, str]]
                   ) -> None:
        """Hook run on process 0 right after ``step`` commits;
        ``digests``: ``{file: (size, sha256)}`` of the files this process
        wrote (with :attr:`digest_files`)."""

    def wait_until_finished(self) -> None:
        """Join the pending write.  One process: the writer has committed
        the step itself.  Several (a collective: every rank calls it):
        process 0 commits it once every rank's file is written."""
        pending, self._pending = self._pending, None
        if pending is None:
            return
        pending["thread"].join()
        if _pod_any(pending["error"] is not None, _process_count()):
            if _rank() == 0:
                shutil.rmtree(pending["tmp"], ignore_errors=True)
            raise RuntimeError(
                f"checkpoint step {pending['step']} was not written"
            ) from pending["error"]
        if _process_count() > 1:
            _barrier()
            if _rank() == 0:
                self._commit(pending)
            _barrier()

    # ------------------------------------------------------------- restore

    def restore(self, step: Optional[int] = None,
                template: Optional[PyTree] = None, mesh: Any = None,
                specs: Any = None) -> PyTree:
        """Step ``step`` (None: the newest): the host tree, or written into
        ``template`` (:func:`restore_into`)."""
        if mesh is not None or specs is not None:
            raise NotImplementedError(_RESHARD)
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints under {self.directory}")
        loaded = _read(os.path.join(self.directory, str(int(step))))
        if template is None:
            return loaded
        out = restore_into(template, loaded)
        from ..obs.events import emit_event

        emit_event("checkpoint_restore", step=int(step),
                   directory=str(self.directory), resharded=False)
        return out

    # ----------------------------------------------------------- lifecycle

    def close(self) -> None:
        self.wait_until_finished()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        # an exception between save() and teardown must not strand the
        # pending step: wait for its commit while unwinding
        self.close()
