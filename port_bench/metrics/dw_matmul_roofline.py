"""K5's share of its roofline: per launch in the slice, the larger of its
operations over the f32 peak and its bytes over the HBM rate (its shape
recorded at the launch), summed, over the launches' profiler time."""
from harness import peaks
from harness.trace import kernel_seconds


def read(record: dict):
    sl = record["slice"]
    if sl is None:
        return None
    calls = sl["dw_calls"]
    seconds, count = kernel_seconds(sl, "dw_matmul_kernel")
    if count == 0 or count != len(calls) or seconds <= 0:
        return None
    bound = sum(peaks.bound_s(*peaks.dw_matmul(*c)) for c in calls)
    return 100.0 * bound / seconds
