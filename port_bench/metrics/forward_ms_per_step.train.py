"""Host milliseconds a train step spends issuing the model's forward and
the rec loss (the program's span ``trainer.forward``), in the steps outside
the profiler slice."""
from harness.program_trace import span_ms


def read(record: dict):
    return span_ms(record, "train_step", "trainer.forward")
