"""Device milliseconds per user batch of the selection chain in the
slice: K1 (exclusion rows, hit tests), K3, K4, K11 and K13."""
from harness.readers import select_ms_per_batch


def read(record: dict):
    return select_ms_per_batch(record)
