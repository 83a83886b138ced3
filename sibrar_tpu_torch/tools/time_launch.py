"""Time K16's wrappers and the kernel launch path, or one peel selection,
of one or more checkouts of the port, in turns on one card.

    python3 sibrar_tpu_torch/tools/time_launch.py [--case roll|peel] \
        ROOT [ROOT ...]

Each ROOT is the root of a checkout of the repository: this one, or an
older commit unpacked with ``git archive``. For each, in the order ROOT1,
..., ROOTn, ROOTn, ..., ROOT1, a fresh process imports ``sibrar_tpu_torch``
from that root alone (its kernels built there, from its own sources) and
runs the case.

``roll`` (the default) checks the three K16 wrappers (``roll_lanes``,
``lane_slice``, ``segment_roll``) bit-equal to their plain versions at the
roll probes' shapes, then measures, three times each:

- ``ms``: each wrapper's and ``torch.roll(x, -37, dims=1)``'s events loop,
  CUDA events around 100 calls after one warm-up, as ``chip_smoke.py``'s
  K16 rows take it;
- ``host_us``: host microseconds per enqueue over 1,000 calls with no
  synchronize, of ``_cuda.launch("sibrar_roll_lanes", ...)`` alone (the
  output allocated once), of the ``roll_lanes`` wrapper and of
  ``torch.roll``.

``peel`` runs ``peel.peel_topk_from_scores`` (no redo) on K2's scores and
window maxima at B = 1,024, C = 100,352, D = 256, k = 100 (normal draws
from a seed, items scaled by D^-1/2) with the validation dot path's
exclusion rows: E = 64 slots, each row's live count uniform in [0, 64],
so the margin path selects m = 168 windows as the validation split's
longest row does. It records a digest of ``(v, idx, ok)`` (every run of
every root must give the same bytes) and, three times each:

- ``ms``: the events loop, CUDA events around 50 selections after one;
- ``host_us``: host microseconds per selection, enqueued 20 at a time with
  no synchronize (the median of five such bursts);
- ``device_ms``: device busy ms per selection under ``torch.profiler``
  over 20 selections (every kernel, Memcpy and Memset included).

Prints one JSON line: the card's name and power limit (``nvidia-smi``),
the case, the roots, and per root the numbers of each of its runs.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

LOOP_ITERS, HOST_CALLS, REPEATS = 100, 1000, 3
PEEL_LOOP, PEEL_BURST, PEEL_BURSTS = 50, 20, 5
PEEL_B, PEEL_C, PEEL_D, PEEL_K, PEEL_E = 1024, 100_352, 256, 100, 64


def one() -> dict:
    """The measurements of the package on ``sys.path[0]``."""
    import torch

    from sibrar_tpu_torch.ops import _cuda, roll
    from sibrar_tpu_torch.tools import probe_roll

    dev = torch.device("cuda")
    i32 = dict(dtype=torch.int32, device=dev)
    x = torch.arange(256, dtype=torch.float32, device=dev)[None]
    x512 = torch.arange(512, dtype=torch.float32, device=dev)[None]
    shift = torch.tensor([37], **i32)
    flat = torch.arange(probe_roll.SEGMENT_N, **i32)
    starts = torch.tensor(probe_roll.SEGMENT_STARTS, **i32)
    n = probe_roll.SEGMENT_LEN
    out = torch.empty_like(x)
    fns = {"roll_lanes": lambda: roll.roll_lanes(x, shift),
           "lane_slice": lambda: roll.lane_slice(x512, shift),
           "segment_roll": lambda: roll.segment_roll(flat, starts, n),
           "torch.roll": lambda: torch.roll(x, -37, dims=1)}
    for name, plain in (
            ("roll_lanes", lambda: roll.roll_lanes_plain(x, shift)),
            ("lane_slice", lambda: roll.lane_slice_plain(x512, shift)),
            ("segment_roll", lambda: roll.segment_roll_plain(flat, starts,
                                                             n))):
        if not torch.equal(fns[name]().view(torch.int32),
                           plain().view(torch.int32)):
            raise AssertionError(f"{name} differs from its plain version")
    host = {"launch": lambda: _cuda.launch(
                "sibrar_roll_lanes", x.data_ptr(), shift.data_ptr(), 1, 256,
                out.data_ptr()),
            "roll_lanes": fns["roll_lanes"], "torch.roll": fns["torch.roll"]}
    got = {"ms": {k: [] for k in fns}, "host_us": {k: [] for k in host}}
    for _ in range(REPEATS):
        for name, fn in fns.items():
            fn()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(LOOP_ITERS):
                fn()
            end.record()
            torch.cuda.synchronize()
            got["ms"][name].append(start.elapsed_time(end) / LOOP_ITERS)
        for name, fn in host.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            got["host_us"][name].append(
                (time.perf_counter() - t0) / HOST_CALLS * 1e6)
            torch.cuda.synchronize()
    return got


def one_peel() -> dict:
    """The peel case's measurements of the package on ``sys.path[0]``."""
    import torch

    from sibrar_tpu_torch import full_f32
    from sibrar_tpu_torch.ops import peel, window
    from sibrar_tpu_torch.tools import _common

    full_f32()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, c, d, e = PEEL_B, PEEL_C, PEEL_D, PEEL_E
    u = torch.randn(b, d, device=dev, generator=gen)
    items = torch.randn(c, d, device=dev, generator=gen) / d ** 0.5
    scores, wmax = window.score_wmax(u, items)
    cols = torch.randint(0, c, (b, e), device=dev, generator=gen,
                         dtype=torch.int32).sort(dim=1).values
    n_live = torch.randint(0, e + 1, (b, 1), device=dev, generator=gen)
    mask = torch.arange(e, device=dev) < n_live
    cols = torch.where(mask, cols, 0)

    def select():
        return peel.peel_topk_from_scores(scores, wmax, cols, mask, PEEL_K,
                                          c)

    digest = hashlib.sha256()
    for x in select():
        digest.update(x.cpu().numpy().tobytes())
    got = {"digest": digest.hexdigest(), "ms": [], "host_us": [],
           "device_ms": []}
    for _ in range(REPEATS):
        got["ms"].append(_common.cuda_ms(select, PEEL_LOOP, dev))
        bursts = []
        for _ in range(PEEL_BURSTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PEEL_BURST):
                select()
            bursts.append((time.perf_counter() - t0) / PEEL_BURST * 1e6)
        torch.cuda.synchronize()
        got["host_us"].append(statistics.median(bursts))
        by_name, _, _ = _common.profiled(
            lambda: [select() for _ in range(PEEL_BURST)])
        got["device_ms"].append(sum(by_name.values()) / 1e3 / PEEL_BURST)
    return got


CASES = {"roll": one, "peel": one_peel}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--case", default="roll", choices=tuple(CASES))
    p.add_argument("roots", nargs="+")
    args = p.parse_args(argv)
    roots = [os.path.abspath(r) for r in args.roots]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    order = list(range(len(roots))) + list(reversed(range(len(roots))))
    runs = [[] for _ in roots]
    for i in order:
        env = {**os.environ, "PYTHONPATH": roots[i]}
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", roots[i], args.case], cwd=roots[i],
                             env=env, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{roots[i]}: exit {res.returncode}\n"
                               f"{res.stderr[-4000:]}")
        runs[i].append(json.loads(res.stdout.strip().splitlines()[-1]))
    digests = {run["digest"] for root in runs for run in root
               if "digest" in run}
    if len(digests) > 1:
        raise AssertionError(f"the roots' selections differ: {digests}")
    print(json.dumps({"card": card, "case": args.case, "roots": roots,
                      "order": order, "runs": runs}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        sys.path[0] = sys.argv[2]  # the checkout's package, not this one's
        print(json.dumps(CASES[sys.argv[3]]()))
    else:
        main()
