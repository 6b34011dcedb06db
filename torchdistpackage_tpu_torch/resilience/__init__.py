"""Resilience — so far the integrity pieces the serving engine's drain
file uses (``ckpt_guard``); the rest of the reference's
``resilience/`` waits for ROADMAP queue A's "Obs, resilience, tools,
utils and HF conversion"."""

from .ckpt_guard import CheckpointCorruptError

__all__ = ["CheckpointCorruptError"]
