"""Host milliseconds a train step spends drawing its batch (the program's
span ``trainer.draw_batch``: the pairs' users and items, the negatives), in
the steps outside the profiler slice."""
from harness.program_trace import span_ms


def read(record: dict):
    return span_ms(record, "train_step", "trainer.draw_batch")
