"""Multi-worker sweep launcher of the port, with the arguments of the
repository root's ``run_agent.py``: it starts ``-p`` sweep workers
(``python -m sibrar_tpu_torch.sweep_agent``), each on its own shard of
``--trials-per-worker`` trials of one sweep, waits for them, and on
Ctrl-C or ``SystemExit`` tears down every worker's process group.

    python -m sibrar_tpu_torch.run_agent -c conf/sweeps/sbnet_random.yml \\
        -o results/sweeps/sbnet -p 4 --trials-per-worker 8 --devices 0,1,2,3

Workers start in their own sessions and get ``SIGTERM`` when the launcher
dies (`utils.process.on_parent_exit`). With more than one worker their
output goes to ``/dev/null``; their run directories, state files and (with
``shared_history``) the shared observation log are the record. Two things
differ from the JAX launcher on purpose:

- a worker is ``[sys.executable, "-m", "sibrar_tpu_torch.sweep_agent",
  ...]`` with this package's root put first on ``PYTHONPATH``, so the
  launcher works from any directory (JAX's starts ``sweep_agent.py`` by a
  path relative to the working directory);
- ``--devices`` (one entry per worker, taken in turn) is exported as
  ``CUDA_VISIBLE_DEVICES`` (JAX's: ``TPU_VISIBLE_DEVICES``); ``0,0`` puts
  two workers on one card.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

from sibrar_tpu_torch.utils.process import (
    on_parent_exit,
    terminate_process_group,
)

# the directory that holds the sibrar_tpu_torch package
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    parser = argparse.ArgumentParser(description="sibrar_tpu_torch sweep "
                                                 "worker launcher")
    parser.add_argument("--sweep_conf", "-c", default=None)
    parser.add_argument("--results_base", "-o", default=None)
    parser.add_argument("--n_parallel", "-p", type=int, default=1)
    parser.add_argument("--trials-per-worker", type=int, default=None)
    parser.add_argument("--devices", default=None,
                        help="comma-separated devices, one per worker, "
                             "taken in turn (exported as "
                             "CUDA_VISIBLE_DEVICES)")
    parser.add_argument("--wandb-agent", action="store_true",
                        help="start server-driven W&B sweep workers instead "
                             "of local trial shards")
    args = parser.parse_args(argv)

    if not args.wandb_agent:
        if not (args.sweep_conf and args.results_base
                and args.trials_per_worker):
            parser.error("local mode requires -c, -o and --trials-per-worker")

    devices = (args.devices.split(",") if args.devices
               else [None] * args.n_parallel)
    verbose = args.n_parallel == 1
    python_path = os.pathsep.join(
        p for p in (PACKAGE_ROOT, os.environ.get("PYTHONPATH")) if p)

    processes = []
    for i in range(args.n_parallel):
        cmd = [sys.executable, "-m", "sibrar_tpu_torch.sweep_agent"]
        if args.wandb_agent:
            cmd.append("--wandb-agent")
            desc = "wandb-agent worker"
        else:
            cmd += ["-c", args.sweep_conf, "-o", args.results_base,
                    "--trial-offset", str(i * args.trials_per_worker),
                    "--max-trials", str(args.trials_per_worker)]
            desc = (f"trials {i * args.trials_per_worker}..."
                    f"{(i + 1) * args.trials_per_worker - 1}")
        env = {**os.environ, "PYTHONPATH": python_path}
        if devices[i % len(devices)]:
            env["CUDA_VISIBLE_DEVICES"] = devices[i % len(devices)]
        kwargs = {} if verbose else {"stdout": subprocess.DEVNULL,
                                     "stderr": subprocess.DEVNULL}
        p = subprocess.Popen(cmd, env=env, start_new_session=True,
                             preexec_fn=on_parent_exit(), **kwargs)
        print(f"launched worker {i} (pid {p.pid}, {desc})", flush=True)
        processes.append((p, i))

    try:
        while processes:
            done = [(p, i) for p, i in processes if p.poll() is not None]
            for p, i in done:
                print(f"worker {i} finished with code {p.returncode}",
                      flush=True)
                processes.remove((p, i))
            time.sleep(1)
        print("all workers finished", flush=True)
    except (KeyboardInterrupt, SystemExit):
        print("terminating all workers...", flush=True)
        while alive := [p for p, _ in processes if p.poll() is None]:
            for p in alive:
                terminate_process_group(p, signal.SIGTERM)
            time.sleep(1)
        sys.exit(1)


if __name__ == "__main__":
    main()
