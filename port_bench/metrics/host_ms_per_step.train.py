"""Host milliseconds a train step takes to issue (the benchmark's span
around each ``Trainer.train_step``, no synchronize), outside the profiler
slice."""
from harness.readers import host_ms_per_unit


def read(record: dict):
    return host_ms_per_unit(record, "train_step")
