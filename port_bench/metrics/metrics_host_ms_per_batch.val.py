"""Host milliseconds a user batch spends on its hit tests, metrics and
their accumulation (the program's span ``evaluator.metrics``), in the
passes outside the profiler slice."""
from harness.program_trace import batches, span_ms


def read(record: dict):
    return span_ms(record, "validate", "evaluator.metrics", batches(record))
