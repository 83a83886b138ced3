"""Host milliseconds a train step spends in the optimizer (the program's
span ``trainer.optimizer_step``: the dense optimizer's per-parameter loop
and the row-sparse updates), in the steps outside the profiler slice."""
from harness.program_trace import span_ms


def read(record: dict):
    return span_ms(record, "train_step", "trainer.optimizer_step")
