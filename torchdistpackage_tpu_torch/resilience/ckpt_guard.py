"""Checkpoint integrity and bounded retries — the port's copy of the
pieces of ``torchdistpackage_tpu/resilience/ckpt_guard.py`` that the
serving engine's drain file and the fleet's migration wire need:
:class:`CheckpointCorruptError` (JAX :51), :func:`with_retries` (JAX
:58, the bounded-backoff loop the chunked wire re-requests a chunk
under) and the file digest ``_sha256`` (JAX :105).  Verify before
restore: a reader compares a payload's size and SHA-256 against its
manifest before it parses a byte."""

from __future__ import annotations

import hashlib
import random
import time
from typing import Any, Callable, Optional, Tuple


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
