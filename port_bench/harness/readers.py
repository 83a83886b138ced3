"""Readings shared by the per-layer metrics (``metrics/<name>.py``). Each
returns None where the traced run holds nothing to read."""
from __future__ import annotations

from harness import peaks
from harness.trace import kernel_seconds

GIB = 2.0 ** 30
# the evaluator's selection chain: K1 exclusion rows and hit tests, K3 window
# gathers, K4 peels, K11 winner recovery, K13 exact top-k
SELECT_KERNELS = ("segment_gather_kernel", "gather_windows_kernel",
                  "peel_values_kernel", "recover_winners_kernel",
                  "exact_topk_kernel")


def idle_pct(record: dict):
    sl = record["slice"]
    if sl is None or sl["window_s"] <= 0 or sl["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["window_s"])


def peak_gib(record: dict):
    peak = record["memory_window_peak_bytes"]
    return peak / GIB if peak else None


def host_ms_per_unit(record: dict, unit: str):
    """Mean host milliseconds of the units outside the profiler slice (no
    synchronize inside a unit's span)."""
    spans = [t1 - t0 for name, t0, t1, inside in record["spans"]
             if name == unit and not inside]
    return 1e3 * sum(spans) / len(spans) if spans else None


def host_rate(record: dict, unit: str):
    """Work a second of the units outside the profiler slice: their work
    over the host time of their spans (no synchronize inside a span)."""
    spans = [t1 - t0 for name, t0, t1, inside in record["spans"]
             if name == unit and not inside]
    if not spans or not record.get("work_per_unit"):
        return None
    return len(spans) * record["work_per_unit"] / sum(spans)


def mfu_pct(record: dict, extra_flops: float = 0.0):
    """The slice's operations (the layers' recorded shapes, plus
    ``extra_flops``) over its time and the f32 peak."""
    sl = record["slice"]
    if sl is None or sl["window_s"] <= 0:
        return None
    flops = sl["flops"] + extra_flops
    if flops <= 0:
        return None
    return 100.0 * flops / sl["window_s"] / peaks.F32_FLOPS


def select_ms_per_batch(record: dict):
    sl = record["slice"]
    if sl is None or not sl["units"]:
        return None
    seconds = sum(kernel_seconds(sl, k)[0] for k in SELECT_KERNELS)
    batches = sl["units"] * record["batches_per_pass"]
    return 1e3 * seconds / batches if seconds > 0 else None
