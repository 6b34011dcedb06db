"""Parallel layers — the serial block math so far."""
