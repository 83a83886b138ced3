"""Host milliseconds a validation pass spends on its results (the
program's span ``evaluator.get_results``: the one transfer and the host's
reduction), in the passes outside the profiler slice."""
from harness.program_trace import span_ms


def read(record: dict):
    return span_ms(record, "validate", "evaluator.get_results")
