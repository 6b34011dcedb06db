"""Parallel layers and the train step — the serial block math and the
single-device step so far."""
