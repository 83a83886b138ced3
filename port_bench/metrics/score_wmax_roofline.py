"""K2's share of its roofline: per launch in the slice, ``2 B C D``
operations over the f32 peak or its bytes over the HBM rate, the larger,
over the launches' profiler time. A pass scores its users in batches of
the eval batch, the last one holding the rest: each launch is counted at
its batch's own rows, the catalog and the depth recorded at the score step.
"""
from harness import peaks
from harness.trace import kernel_seconds


def read(record: dict):
    sl, shape = record["slice"], record.get("score_shape")
    if sl is None or shape is None:
        return None
    seconds, count = kernel_seconds(sl, "score_wmax_kernel")
    batch, c, d = shape
    users = record["users_per_pass"]
    rows = [batch] * (users // batch) + ([users % batch] if users % batch
                                         else [])
    if count == 0 or seconds <= 0 or count != sl["units"] * len(rows):
        return None
    bound = sum(peaks.bound_s(*peaks.score_wmax(b, c, d)) for b in rows)
    return 100.0 * sl["units"] * bound / seconds
