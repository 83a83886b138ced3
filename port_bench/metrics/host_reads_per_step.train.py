"""Calls a train step makes that wait for the card (the program's
``host_wait`` spans, one a call: reads of the card's memory and copies
from pageable host memory), in the steps outside the profiler slice."""
from harness.program_trace import spans_per


def read(record: dict):
    return spans_per(record, "train_step", "host_wait", "trainer.train_step")
