"""Time K16's wrappers and the kernel launch path of one or more checkouts
of the port, in turns on one card.

    python3 sibrar_tpu_torch/tools/time_launch.py ROOT [ROOT ...]

Each ROOT is the root of a checkout of the repository: this one, or an
older commit unpacked with ``git archive``. For each, in the order ROOT1,
..., ROOTn, ROOTn, ..., ROOT1, a fresh process imports ``sibrar_tpu_torch``
from that root alone (its kernels built there, from its own sources),
checks the three K16 wrappers (``roll_lanes``, ``lane_slice``,
``segment_roll``) bit-equal to their plain versions at the roll probes'
shapes, then measures, three times each:

- ``ms``: each wrapper's and ``torch.roll(x, -37, dims=1)``'s events loop,
  CUDA events around 100 calls after one warm-up, as ``chip_smoke.py``'s
  K16 rows take it;
- ``host_us``: host microseconds per enqueue over 1,000 calls with no
  synchronize, of ``_cuda.launch("sibrar_roll_lanes", ...)`` alone (the
  output allocated once), of the ``roll_lanes`` wrapper and of
  ``torch.roll``.

Prints one JSON line: the card's name and power limit (``nvidia-smi``),
the roots, and per root the numbers of each of its runs.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

LOOP_ITERS, HOST_CALLS, REPEATS = 100, 1000, 3


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


def main(argv=None) -> None:
    roots = [os.path.abspath(r) for r in (argv or sys.argv[1:])]
    if not roots:
        raise SystemExit(__doc__)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    order = list(range(len(roots))) + list(reversed(range(len(roots))))
    runs = [[] for _ in roots]
    for i in order:
        env = {**os.environ, "PYTHONPATH": roots[i]}
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", roots[i]], cwd=roots[i], env=env,
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{roots[i]}: exit {res.returncode}\n"
                               f"{res.stderr[-4000:]}")
        runs[i].append(json.loads(res.stdout.strip().splitlines()[-1]))
    print(json.dumps({"card": card, "roots": roots, "order": order,
                      "runs": runs}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        sys.path[0] = sys.argv[2]  # the checkout's package, not this one's
        print(json.dumps(one()))
    else:
        main()
