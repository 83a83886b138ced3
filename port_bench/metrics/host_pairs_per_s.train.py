"""Pairs trained a second on the host's clock: the steps outside the
profiler slice, their pairs over the time of their spans (the benchmark's
span around each ``Trainer.train_step``, no synchronize). The host sets
the pace of a SBNet step, and its speed moves between runs: this is the
training rate kept per layer, beside the end-to-end device time a step."""
from harness.readers import host_rate


def read(record: dict):
    return host_rate(record, "train_step")
