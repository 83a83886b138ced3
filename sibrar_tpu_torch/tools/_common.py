"""Pieces the GEMM probes share: their inputs, steps and timers."""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from sibrar_tpu_torch import full_f32
from sibrar_tpu_torch.ops import gemm_probe

B, D, C = 1024, 256, 501_760  # users, depth, catalog of every GEMM probe
PROFILED_ITERS = 8


def parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cpu runs the plain versions and times nothing")
    return p


def inputs(c: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The probes' draws: ``default_rng(1)``, then ``u [B, D]`` and
    ``items [c, D]`` standard normal as f32, in that order; TF32 off."""
    full_f32()
    rng = np.random.default_rng(1)
    u = rng.normal(size=(B, D)).astype(np.float32)
    items = rng.normal(size=(c, D)).astype(np.float32)
    return (torch.from_numpy(u).to(device),
            torch.from_numpy(items).to(device))


def gemm_step(mode: str):
    """One call of ``mode``: a K14 variant, or ``xla``, the library GEMM
    (f32, TF32 off) that the JAX probe left to XLA."""
    if mode == "xla":
        return lambda u, items: (torch.matmul(u, items.T),)
    return gemm_probe.VARIANTS[mode]


def cuda_ms(fn, iters: int, device: torch.device) -> float | None:
    """Device ms per call of ``fn()``: CUDA events around ``iters`` calls
    after one warm-up. Off the card the calls run and the result is None."""
    fn()
    if device.type != "cuda":
        for _ in range(iters):
            fn()
        return None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled(fn, trace_path: str | None = None,
             idles: tuple = (0.0, 2.0, 6.0, 15.0)
             ) -> tuple[dict, float, float]:
    """Run ``fn()`` under ``torch.profiler``: device microseconds by kernel
    name, host wall microseconds around ``fn()`` and the sync after it, and
    the seconds the kept session idled before ``fn()``. ``trace_path``
    receives the kept session's Chrome trace.

    Late in a long process the profiler can begin recording device activity
    seconds after a session opens and then drops the kernels launched
    before (seen on an H100 under torch 2.11, where 2-6 s of idling
    sufficed). So each session is held to its own record, as many kernels
    on the device as kernel launches on the host, and opened again, idle
    for the next of ``idles`` seconds before ``fn()``, until it holds: a
    caller whose ``fn`` must run once passes one idle. Raises if it never
    holds. Without a card the session records the host only."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    on_card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    for idle_s in idles:
        sync()
        with profile(activities=activities) as prof:
            time.sleep(idle_s)
            t0 = time.perf_counter()
            fn()
            sync()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.events()
        launched = sum(e.device_type != cuda and "LaunchKernel" in e.name
                       for e in events)
        kernels = [e for e in events if e.device_type == cuda
                   and not e.name.startswith(("Memcpy", "Memset"))]
        if len(kernels) >= launched:
            break
    else:
        raise RuntimeError(f"torch.profiler recorded {len(kernels)} of "
                           f"{launched} kernels launched")
    if trace_path:
        prof.export_chrome_trace(trace_path)
    by_name: dict = {}
    for evt in events:
        if evt.device_type == cuda:
            by_name[evt.name] = (by_name.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us())
    return by_name, wall_us, idle_s


def device_ops_ms(fn, device: torch.device, n_iters: int = PROFILED_ITERS,
                  match: str = "") -> dict | None:
    """Device ms per call of ``fn()`` by kernel name over ``n_iters`` calls
    under the profiler (`profiled`): the 6 largest, or every kernel whose
    name holds ``match``. None off the card."""
    if device.type != "cuda":
        return None
    by_name, _, _ = profiled(lambda: [fn() for _ in range(n_iters)])
    ranked = sorted(((k, v) for k, v in by_name.items() if match in k),
                    key=lambda kv: -kv[1])
    return {name: us / 1e3 / n_iters
            for name, us in (ranked if match else ranked[:6])}


def rel_vs_f32_slice(scores: torch.Tensor, u: torch.Tensor,
                     items: torch.Tensor) -> float:
    """max |scores - ref| / max |ref| over the first 8 users and 1,024
    items, ``ref`` the f32 library product of that slice."""
    ref = u[:8] @ items[:1024].T
    return float((scores[:8, :1024] - ref).abs().max() / ref.abs().max())


def bf16_within(name: str, s: torch.Tensor, wmax_t: torch.Tensor,
                u: torch.Tensor, items: torch.Tensor,
                rows: int = 128) -> tuple[float, float]:
    """Hold K15's outputs ``s [B, C]`` and ``wmax_t [C/128, B]`` for
    ``u [B, D]``, ``items [C, D]`` to ``D 2^-24 (|u~| @ |i~|^T)`` of the
    exact product of the bf16-rounded operands u~, i~ (float64 sums, exact
    to 2^-53 relative at these depths), the maxima to the window maxima of
    the bound, over chunks of ``rows`` users; raises AssertionError past it.
    The plain version, an f32 product, carries its own rounding of up to
    that bound, so the check does not compare against it. Returns the
    largest |s - exact| and the largest |s - exact| / bound."""
    b, c = s.shape
    d = u.shape[1]
    ib = items.bfloat16().double()
    ib_abs = ib.abs()
    err = ratio = 0.0
    for r in range(0, b, rows):
        ub = u[r:r + rows].bfloat16().double()
        n = ub.shape[0]
        exact = ub @ ib.T
        tol = d * 2.0 ** -24 * (ub.abs() @ ib_abs.T)
        diff = (s[r:r + rows].double() - exact).abs()
        wdiff = (wmax_t[:, r:r + rows].T.double()
                 - exact.view(n, c // 128, 128).amax(-1)).abs()
        if not (bool((diff <= tol).all()) and bool(
                (wdiff <= tol.view(n, c // 128, 128).amax(-1)).all())):
            raise AssertionError(
                f"{name}: past D 2^-24 (|u~| @ |i~|^T) of the rounded "
                f"operands' exact product by up to "
                f"{float((diff - tol).max())} (users {r}-{r + n - 1})")
        err = max(err, float(diff.max()))
        ratio = max(ratio, float((diff / tol.clamp_min(1e-300)).max()))
    return err, ratio
