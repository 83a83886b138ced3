"""Sweep CLI of the port: one hyperparameter-search worker, with the
arguments of the repository root's ``sweep_agent.py``.

    python -m sibrar_tpu_torch.sweep_agent \\
        -c conf/sweeps/sbnet/sbnet_onion18_random_huge_no-user.yml \\
        -o results/sweeps/sbnet

runs the sweep's trials in this process (`sweep.run_sweep`), on the card
unless a trial's ``run_settings.device`` is ``cpu``, and prints the best
trial as one JSON line (``best_trial``, ``params``, ``metric``,
``value``). ``--trial-offset`` / ``--max-trials`` take one shard of the
trials (``python -m sibrar_tpu_torch.run_agent`` starts one worker per
shard); ``--wandb-agent`` runs one trial as a ``wandb agent`` worker
instead (`sweep.wandb_train_val_agent`). The port compiles nothing at run
time, so there is no compilation cache to enable. Under torchrun each
trial runs on the mesh its ``parallel`` block asks for; rank 0 keeps the
sweep's files and prints the line.
"""
from __future__ import annotations

import argparse
import json

from sibrar_tpu_torch import sweep as sweeps
from sibrar_tpu_torch.parallel.distributed import (
    initialize_distributed,
    is_main,
)


def main(argv=None):
    initialize_distributed()
    parser = argparse.ArgumentParser(description="sibrar_tpu_torch sweep "
                                                 "agent")
    parser.add_argument("--sweep_conf", "-c", default=None)
    parser.add_argument("--results_base", "-o", default=None)
    parser.add_argument("--trial-offset", type=int, default=0)
    parser.add_argument("--max-trials", type=int, default=None)
    parser.add_argument("--wandb-agent", action="store_true",
                        help="server-driven mode: run as a `wandb agent` "
                             "worker taking its hyperparameters from "
                             "wandb.config")
    parser.add_argument("--keep-top-runs", type=int, default=10)
    args = parser.parse_args(argv)

    if args.wandb_agent:
        sweeps.wandb_train_val_agent(keep_top_runs=args.keep_top_runs)
        return
    if not (args.sweep_conf and args.results_base):
        parser.error("--sweep_conf/-c and --results_base/-o are required "
                     "in local sweep mode")
    sweep = sweeps.load_sweep_config(args.sweep_conf)
    records = sweeps.run_sweep(sweep, args.results_base,
                               trial_offset=args.trial_offset,
                               max_trials=args.max_trials)
    best = records[0]
    if is_main():
        print(json.dumps({"best_trial": best["trial"],
                          "params": best["params"], "metric": sweep.metric,
                          "value": best["metrics"].get(sweep.metric)}))


if __name__ == "__main__":
    main()
