"""Calls a user batch makes that wait for the card (the program's
``host_wait`` spans over a pass's batches, one a call: reads of the card's
memory and copies from pageable host memory), in the passes outside the
profiler slice."""
from harness.program_trace import batches, spans_per


def read(record: dict):
    return spans_per(record, "validate", "host_wait", "evaluator.rank",
                     batches(record))
