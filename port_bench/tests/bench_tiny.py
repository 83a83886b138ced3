"""Small-size runs of the harness on the CPU, shared by the tests: the real
cells, configurations and mixes at the widths they state, over a data set
cut to a few hundred users (the program's kernels take their plain
versions on CPU tensors)."""
import time

from harness import run_cell

TINY = {"n_users": 300, "n_items": 1024, "n_interactions": 6000}
SEED = 4_000_000_123  # more than 32 bits, as the driver's seeds


def run(cell: str, seconds: float = 0.5, **kwargs):
    return run_cell.run(cell, SEED, seconds, False, "cpu",
                        time.perf_counter(), data_overrides=TINY, **kwargs)
