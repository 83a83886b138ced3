#!/usr/bin/env python3
"""Trained-quality parity of the PyTorch port against the JAX package.

Both packages train the same family on the same synthetic artifact
directory with the same hyperparameters and seeds; the comparison is on
the best validation ndcg@10 (the two frameworks draw different random
numbers, so converged quality is compared, not trajectories). The JAX side
is ``tools/trained_parity.py``'s ``train_ours_*``; the port side is
``sibrar_tpu_torch/tools/trained_parity.py``, which imports no JAX and runs
on the card or the CPU.

    # the JAX side, on the CPU (writes the per-seed values)
    python torch_trained_parity.py jax --family sbnet mf --seeds 0 1 2 3 4 \
        --out sibrar_tpu_torch/tools/trained_parity_jax.json
    # the port side (no JAX), on the card or with --device cpu
    python -m sibrar_tpu_torch.tools.trained_parity --family sbnet mf \
        --seeds 0 1 2 3 4 --out port.json
    # the join: trained_parity_stats' keys per family, JAX as "ref"
    python torch_trained_parity.py join \
        --jax sibrar_tpu_torch/tools/trained_parity_jax.json --port port.json

The gate per family (``tests/test_trained_parity.py``): |delta_mean| <=
max(0.01, delta_sem), and both means above 0.03.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FLOOR = 0.03
TOLERANCE = 0.01


def run_jax(families, seeds) -> dict:
    """Best validation ndcg@10 of JAX's ``train_ours_<family>`` per seed,
    at mid scale: artifacts written by JAX's ``make_midscale_artifacts``,
    hyperparameters updated by its ``MIDSCALE_HPARAMS``."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import jax

    import trained_parity as tp

    out = {"scale": "mid", "platform": jax.default_backend(),
           "jax": jax.__version__, "families": {}}
    with tempfile.TemporaryDirectory() as d:
        tp.make_midscale_artifacts(d)
        for family in families:
            _, ours_fn, base = tp._families()[family]
            h = dict(base)
            h.update(tp.MIDSCALE_HPARAMS.get(family, {}))
            runs, secs = {}, {}
            for s in seeds:
                t0 = time.perf_counter()
                runs[str(s)] = float(ours_fn(d, seed=s, hparams=h))
                secs[str(s)] = round(time.perf_counter() - t0, 1)
                print(f"jax {family} seed {s}: {runs[str(s)]:.6f} "
                      f"({secs[str(s)]} s)", flush=True)
            out["families"][family] = {"hparams": h, "runs": runs,
                                       "seconds": secs}
    return out


def join(jax_runs: dict, port_runs: dict) -> dict:
    """Per family, on the seeds both sides ran: the keys of
    ``trained_parity_stats`` with JAX as ``ref`` and the port as
    ``ours``, plus the gate's verdict. Raises ValueError when the two
    runs differ in scale or in a family's hyperparameters."""
    if port_runs["scale"] != jax_runs["scale"]:
        raise ValueError(f"port run at scale {port_runs['scale']!r}, JAX "
                         f"runs at {jax_runs['scale']!r}")
    out = {}
    for family, port in port_runs["families"].items():
        if port["hparams"] != jax_runs["families"][family]["hparams"]:
            raise ValueError(f"{family}: port hparams {port['hparams']} "
                             f"differ from JAX's "
                             f"{jax_runs['families'][family]['hparams']}")
        ref_all = jax_runs["families"][family]["runs"]
        seeds = [s for s in port["runs"] if s in ref_all]
        ref = [ref_all[s] for s in seeds]
        ours = [port["runs"][s] for s in seeds]
        deltas = np.asarray(ours) - np.asarray(ref)
        n = len(seeds)
        sem = (float(np.std(deltas, ddof=1) / np.sqrt(n)) if n > 1
               else 0.0)
        r = {"family": family, "seeds": seeds, "n_seeds": n,
             "ref_runs": ref, "ours_runs": ours,
             "ref_mean": float(np.mean(ref)), "ref_std": float(np.std(ref)),
             "ours_mean": float(np.mean(ours)),
             "ours_std": float(np.std(ours)),
             "delta_mean": float(np.mean(deltas)),
             "delta_std": float(np.std(deltas, ddof=1)) if n > 1 else 0.0,
             "delta_sem": sem,
             "port_device": port_runs.get("device")}
        r["passes"] = bool(abs(r["delta_mean"]) <= max(TOLERANCE, sem)
                           and r["ref_mean"] > FLOOR
                           and r["ours_mean"] > FLOOR)
        out[family] = r
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    j = sub.add_parser("jax", help="train the JAX side on this CPU")
    j.add_argument("--family", nargs="+", default=["sbnet", "mf"])
    j.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2, 3, 4])
    j.add_argument("--out", required=True)
    k = sub.add_parser("join", help="join a port run with the JAX runs")
    k.add_argument("--jax", required=True)
    k.add_argument("--port", required=True)
    k.add_argument("--out")
    args = p.parse_args(argv)
    if args.cmd == "jax":
        res = run_jax(args.family, args.seeds)
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
            fh.write("\n")
        return 0
    with open(args.jax) as fh:
        jax_runs = json.load(fh)
    with open(args.port) as fh:
        port_runs = json.load(fh)
    res = join(jax_runs, port_runs)
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0 if all(r["passes"] for r in res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
