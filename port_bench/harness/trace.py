"""The traced run's instruments: host spans around each unit, one
``torch.profiler`` slice of the window, operation counts from the shapes
the model's layers receive, and the reading of the slice (device busy time,
idle share, time by kernel, the longest idle gaps).

Everything here is the benchmark's own: the spans wrap the calls into the
program, the layer shapes come from forward hooks put on the program's
modules for the slice only, and K5's shapes from a wrapper around its
launching function for the slice only (its launch count is kept).

The slice records CUDA activity alone (kernels, copies and the CUDA
runtime's calls), not the host's operators: recording every operator
doubled the host time of a host-paced step. Two marker kernels
(``torch.cuda._sleep``), launched just before the slice's first unit and
just after its last, bound the slice on the device's clock.

``WindowTrace`` records a whole window the same way (no hooks), for a cell
whose end-to-end metric is the device's busy time a unit.
"""
from __future__ import annotations

import bisect
import re
import time
from contextlib import contextmanager

import torch

from harness import peaks

MARKER = "spin_kernel"  # the kernel of ``torch.cuda._sleep``
MARKER_CYCLES = 1000


class Tracer:
    """Collects the traced run's record. ``enabled`` False makes every call
    a no-op except the host spans, which cost a clock read."""

    def __init__(self, enabled: bool, model=None, slice_start: int = 0,
                 slice_units: int = 0, idles: tuple = (2.0, 6.0)):
        self.enabled = enabled
        self.model = model
        self.slice_start, self.slice_units = slice_start, slice_units
        self.idles = list(idles)
        self.spans: list = []  # (name, t0, t1, in_slice)
        self.slices: list = []  # attempts, the last one kept
        self._prof = None
        self._slice_left = 0
        self._hooks: list = []
        self._calls: list = []
        self._dw: list = []
        self._restore = None

    # ------------------------------------------------------------- spans
    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter(),
                               self._prof is not None))

    # ------------------------------------------------------------- slice
    def before_unit(self, index: int) -> None:
        """Open the profiler slice before unit ``slice_start`` (and again,
        with a longer idle, if the first attempt lost kernels)."""
        if (not self.enabled or self._prof is not None or not self.idles
                or index < self.slice_start or self._kept()):
            return
        self._calls, self._dw = [], []
        self._prof = open_profile(self.idles.pop(0))
        self._hook()
        torch.cuda._sleep(MARKER_CYCLES)
        self._slice_left = self.slice_units

    def after_unit(self) -> None:
        if self._prof is None:
            return
        self._slice_left -= 1
        if self._slice_left <= 0:
            self.close()

    def close(self) -> None:
        """End an open slice: synchronize, stop the profiler, read it."""
        if self._prof is None:
            return
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        self._unhook()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        units = self.slice_units - self._slice_left
        t = time.perf_counter()
        self.slices.append(read_profile(prof, units, self._calls, self._dw))
        self.slices[-1]["read_s"] = time.perf_counter() - t

    def pending(self, index: int) -> bool:
        """Whether the window has to go on for the slice: it is open, or
        has not opened yet and an attempt is left."""
        return self.enabled and (self._prof is not None or (
            not self._kept() and bool(self.idles)))

    def _kept(self) -> bool:
        return bool(self.slices) and self.slices[-1]["complete"]

    def record(self) -> dict | None:
        """The kept slice (None if no attempt recorded every kernel)."""
        return self.slices[-1] if self._kept() else None

    # ------------------------------------------------------------- shapes
    def _hook(self) -> None:
        if self.model is None:
            return
        for module in self.model.modules():
            if isinstance(module, torch.nn.Linear):
                self._hooks.append(module.register_forward_hook(
                    self._linear_hook))
            elif hasattr(module, "csr") and hasattr(module, "kernel"):
                self._hooks.append(module.register_forward_hook(
                    self._tower_hook))
        from sibrar_tpu_torch.ops import dw

        original = dw.dw_matmul
        calls = self._dw

        def recorded(vec, g):
            calls.append((vec.shape[0], vec.shape[1], g.shape[1]))
            return original(vec, g)

        recorded.launches = original.launches
        dw.dw_matmul = recorded

        def restore():
            original.launches = recorded.launches
            dw.dw_matmul = original

        self._restore = restore

    def _unhook(self) -> None:
        for h in self._hooks:
            h.remove()
        self._hooks = []
        if self._restore is not None:
            self._restore()
            self._restore = None

    def _linear_hook(self, module, inputs, output) -> None:
        x = inputs[0]
        train = module.training and torch.is_grad_enabled()
        rows = x.numel() // max(module.in_features, 1)
        self._calls.append(("linear", peaks.linear_flops(
            rows, module.in_features, module.out_features, train,
            x.requires_grad)))

    def _tower_hook(self, module, inputs, output) -> None:
        idxs = inputs[0]
        train = module.training and torch.is_grad_enabled()
        self._calls.append(("tower", (idxs, module.csr.indptr,
                                      module.kernel.shape[1], train)))


def open_profile(idle: float):
    """A running profiler of CUDA activity alone, opened after a
    synchronize and ``idle`` seconds of sleep (it starts recording the
    device late)."""
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CUDA])
    prof.__enter__()
    time.sleep(idle)
    return prof


class WindowTrace:
    """The device's activity over a whole window: ``open`` before its first
    unit (a start marker after the idle), ``close(units)`` after the
    window's closing synchronize (an end marker, then the reading of
    ``read_profile``, with ``stop_s`` and ``read_s``)."""

    def __init__(self, idle: float = 2.0):
        self.idle = idle
        self._prof = None

    def open(self) -> None:
        self._prof = open_profile(self.idle)
        torch.cuda._sleep(MARKER_CYCLES)

    def close(self, units: int) -> dict:
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        t = time.perf_counter()
        prof.__exit__(None, None, None)
        stop_s = time.perf_counter() - t
        t = time.perf_counter()
        out = read_profile(prof, units, [], [], detail=False)
        out.update(stop_s=stop_s, read_s=time.perf_counter() - t)
        return out


def raw_events(prof, keep_host: bool = True) -> tuple[list, list, int]:
    """``(device, host, launched)`` from the profiler's raw records (not
    its parsed events, which take ~0.1 ms each): device and host events as
    ``(start_us, end_us, name)`` with kernel names demangled (host events
    only with ``keep_host``), and the count of the runtime's kernel
    launches."""
    cuda = torch.autograd.DeviceType.CUDA
    names: dict = {}
    device, host = [], []
    launched = 0
    for e in prof.profiler.kineto_results.events():
        raw = e.name()
        name = names.get(raw)
        if name is None:
            name = names[raw] = torch._C._demangle(raw)
        t0 = e.start_ns() / 1e3
        item = (t0, t0 + e.duration_ns() / 1e3, name)
        if e.device_type() == cuda:
            device.append(item)
        else:
            if keep_host:
                host.append(item)
            if "LaunchKernel" in name:
                launched += 1
    return device, host, launched


def slice_flops(calls: list) -> float:
    """Operations of the recorded layer calls; an interaction layer's live
    entries are counted from its rows after the slice, off the profile."""
    total = 0.0
    for kind, item in calls:
        if kind == "linear":
            total += item
        else:
            idxs, indptr, h, train = item
            rows = idxs.reshape(-1).long()
            nnz = int((indptr[rows + 1] - indptr[rows]).sum())
            total += peaks.sparse_first_layer_flops(nnz, h, train)
    return total


def read_profile(prof, units: int, calls: list, dw_calls: list,
                 detail: bool = True) -> dict:
    """The slice's reading: its span on the device's clock (from the start
    of the first marker kernel to the end of the last), device busy seconds
    (the union of device operations inside the span, markers left out),
    kernels by name, the launch check (both markers recorded, and no fewer
    kernels than the runtime's recorded launches), and the longest idle
    gaps, each labelled by the CUDA runtime call running when it began, or
    else by the last one before it. Without ``detail``, no kernels by name
    and no gaps (a whole window's trace needs only its busy time)."""
    events, host, launched = raw_events(prof, keep_host=detail)
    device, markers = [], []
    for e in events:
        (markers if MARKER in e[2] else device).append(e)
    kernels = [d for d in device
               if not d[2].startswith(("Memcpy", "Memset"))]
    lo = hi = 0.0  # a slice without both markers is not kept
    if len(markers) >= 2:
        lo, hi = min(m[0] for m in markers), max(m[1] for m in markers)
    inside = sorted((max(a, lo), min(b, hi), n) for a, b, n in device
                    if b > lo and a < hi)
    busy_us, gaps, end = 0.0, [], lo
    for a, b, _ in inside:
        if a > end:
            gaps.append((a - end, end))
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    if hi > end:
        gaps.append((hi - end, end))
    if detail:
        gaps.sort(reverse=True)
        host.sort()
    starts = [a for a, _, _ in host]
    labelled = []
    for length, at in gaps[:10] if detail else []:
        cover = before = None  # the last-started call over it, or before it
        for i in range(bisect.bisect_right(starts, at) - 1, -1, -1):
            _, b, name = host[i]
            if b >= at:
                cover = name
                break
            before = before or name
        label = cover or (f"host code after {before}" if before
                          else "nothing recorded")
        labelled.append([label[:120], length / 1e6])
    by_name: dict = {}
    count: dict = {}
    for a, b, name in inside if detail else []:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        count[name] = count.get(name, 0) + 1
    # ``launched`` counts the markers' launches too
    complete = len(markers) >= 2 and len(kernels) + len(markers) >= launched
    return {"complete": complete, "launched": launched,
            "kernels": len(kernels), "markers": len(markers),
            "window_s": (hi - lo) / 1e6, "busy_s": busy_us / 1e6,
            "units": units, "by_name": by_name, "count": count,
            "gaps": labelled, "flops": slice_flops(calls),
            "dw_calls": list(dw_calls)}


def kernel_seconds(record: dict, pattern: str) -> tuple[float, int]:
    """Device seconds and launches in the slice of the kernels whose name
    holds ``pattern`` as a whole identifier."""
    rx = re.compile(r"(?<![A-Za-z0-9_])" + pattern + r"(?![A-Za-z0-9_])")
    names = [k for k in record["by_name"] if rx.search(k)]
    return (sum(record["by_name"][k] for k in names),
            sum(record["count"][k] for k in names))
