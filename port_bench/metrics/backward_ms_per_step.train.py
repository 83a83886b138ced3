"""Host milliseconds a train step spends in autograd's backward (the
program's span ``trainer.backward``), in the steps outside the profiler
slice."""
from harness.program_trace import span_ms


def read(record: dict):
    return span_ms(record, "train_step", "trainer.backward")
