"""Host milliseconds a user batch waits for the peel's exactness flags
(the program's span ``host_wait.peel.flag``: the host waiting for the
card), in the passes outside the profiler slice."""
from harness.program_trace import batches, span_ms


def read(record: dict):
    return span_ms(record, "validate", "host_wait.peel.flag",
                   batches(record))
