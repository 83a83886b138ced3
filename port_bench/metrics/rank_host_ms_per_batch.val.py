"""Host milliseconds a user batch spends issuing its ranking (the
program's span ``evaluator.rank``: the user encode, K2 and the peel, any
redo) less every wait for the card inside it (its ``host_wait`` spans:
the peel's flag read and the copies that wait on the card's queue), in the
passes outside the profiler slice."""
from harness.program_trace import batches, span_ms


def read(record: dict):
    return span_ms(record, "validate", "evaluator.rank", batches(record),
                   less="host_wait")
