"""Parallel layers and the train step — the serial block math, the
single-device step and data parallelism (``data_parallel.DataParallel``)."""
