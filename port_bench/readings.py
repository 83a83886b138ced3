#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card:

    python3 port_bench/readings.py --workload <cell> --seeds 1 2 3 \
        [--control-seeds 1 2 3] [--seconds 2]

For each of ``--seeds``, one run of the cell (as ``run.py`` makes it, with a
short window) and its compared numbers: the lower readings. For each of
``--control-seeds``, the control: the plain reference put in the program's
place and computed in the precision below the configuration's f32 with
TF32 off (its matrix products in TF32; validation's metrics in bfloat16),
judged as the program is; and, for training, the reference with half of
each batch left out of the loss. One JSON line
per reading, then a summary line: the largest program reading and the
smallest control and fault readings of each number.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def control_numbers(cell_name: str, seed: int, device) -> dict:
    """``{"control": numbers, "half_batch": numbers}`` of one seed."""
    import torch

    from harness import catalog, run_cell, traffic

    cell = catalog.cell(cell_name)
    conf = catalog.config(cell["config"])
    mix = catalog.mix(cell["traffic"])
    entry = catalog.entry(mix["entry"])
    family = catalog.reference(conf["algorithm"])
    seeds = run_cell.seeds_of(seed)
    data = traffic.make(traffic.parameters(conf.get("data"),
                                           mix.get("data")),
                        seeds["data"], device)
    ref = entry.reference_readings(family, conf, mix, data, seeds, device)
    out = {}
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        ctrl = entry.reference_readings(family, conf, mix, data, seeds,
                                        device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ctrl = entry.control(ctrl, ref)
    out["control"] = entry.numbers(ctrl, ref)
    out["control_details"] = entry.details(ctrl, ref)
    if mix["entry"] == "train":
        half = entry.reference_readings(family, conf, mix, data, seeds,
                                        device, fault="half_batch")
        out["half_batch"] = entry.numbers(half, ref)
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args()

    import torch

    from harness import run_cell

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    lower: dict = {}
    upper: dict = {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        result, out, _ = run_cell.run(args.workload, seed, args.seconds,
                                      False, "cuda", t0)
        nums = {k: v["value"] for k, v in result["checks"].items()}
        details = [json.loads(line.split(" ", 2)[2]) for line in out
                   if line.startswith("check details ")]
        print(json.dumps({"seed": seed, "program": nums,
                          "correct": result["correct"],
                          "details": details}), flush=True)
        for k, v in nums.items():
            lower[k] = max(lower.get(k, 0.0), float(v))
    for seed in args.control_seeds:
        got = control_numbers(args.workload, seed, "cuda")
        print(json.dumps({"seed": seed, **got}), flush=True)
        for kind, nums in got.items():
            if kind.endswith("details"):
                continue
            for k, v in nums.items():
                key = f"{kind}.{k}"
                upper[key] = min(upper.get(key, float("inf")), float(v))
    print(json.dumps({"workload": args.workload, "program_max": lower,
                      "min": upper,
                      "card": run_cell.power_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
