"""Checkpoint integrity — the port's copy of the two pieces of
``torchdistpackage_tpu/resilience/ckpt_guard.py`` that the serving
engine's drain file needs: :class:`CheckpointCorruptError` (JAX :51) and
the file digest ``_sha256`` (JAX :105).  Verify before restore: a
reader compares a payload's size and SHA-256 against its manifest
before it parses a byte."""

from __future__ import annotations

import hashlib


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification."""


def _sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()
