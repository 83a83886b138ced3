"""Share of the f32 peak: the operations the slice's steps need (every
dense layer's forward, weight gradient and input gradient where the input
needs one; each interaction layer's sum over its live entries, forward and
kernel gradient), from the shapes the layers received, over the slice's
time."""
from harness.readers import mfu_pct


def read(record: dict):
    return mfu_pct(record)
