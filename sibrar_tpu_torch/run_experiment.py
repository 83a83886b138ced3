"""Experiment CLI of the port: ``run_experiment.py``'s arguments, running on
the card (port of the repository root's ``run_experiment.py``).

    python -m sibrar_tpu_torch.run_experiment -a sbnet \\
        -c conf/single/sbnet_onion18_huge_no-user.yml \\
        -d data/onion18/random_split -t train_val_test

``-o key.path=value`` overrides a config key (the value is parsed as
YAML); the dataset name defaults to the artifact directory's name.
``-t train_val``, ``test``, ``train_val_test`` and ``gather`` (the
``--split_set`` split, top ``--gather_k``) run; ``-a uiprotomfs_combine
--u_run_dir U --i_run_dir I`` evaluates the score sum of two fitted runs
and takes no ``-d`` / ``-c``.

Under torchrun every rank runs it on its own card, as a (data, item) mesh
where ``parallel`` turns one on (`parallel.distributed`):

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m sibrar_tpu_torch.run_experiment -a sbnet -c ... -d ... \
        -o parallel.enabled=true -o parallel.item_parallelism=2
"""
from __future__ import annotations

import argparse
import logging
import os

import yaml

from sibrar_tpu_torch.config.loader import get_config
from sibrar_tpu_torch.experiment import (
    run_combine_experiment,
    run_gather,
    run_test,
    run_train_val,
    run_train_val_test,
)
from sibrar_tpu_torch.models.registry import ALGORITHMS
from sibrar_tpu_torch.parallel.distributed import initialize_distributed

RUNS = {"train_val": run_train_val, "test": run_test,
        "train_val_test": run_train_val_test}
RUN_TYPES = (*RUNS, "gather")
SPLIT_TYPES = ("random", "temporal", "cold_start_user", "cold_start_item",
               "cold_start_both")
COMBINE_ALG = "uiprotomfs_combine"


def main(argv=None):
    """Parse ``argv`` and run; returns the run's metrics (a pair for
    ``train_val_test``)."""
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    initialize_distributed()
    parser = argparse.ArgumentParser(
        description="sibrar_tpu_torch experiment runner")
    parser.add_argument("--algorithm", "-a", required=True,
                        choices=sorted(ALGORITHMS) + [COMBINE_ALG])
    parser.add_argument("--dataset_path", "-d", default=None,
                        help="preprocessed artifact directory")
    parser.add_argument("--dataset_name", "-n", default=None,
                        help="dataset name for the results tree (default: "
                             "dir name)")
    parser.add_argument("--split_type", "-s", default=None,
                        choices=SPLIT_TYPES)
    parser.add_argument("--run_type", "-t", default="train_val",
                        choices=RUN_TYPES)
    parser.add_argument("--conf_path", "-c", default=None,
                        help="yaml/json experiment config (base_configs "
                             "supported)")
    parser.add_argument("--override", "-o", action="append", default=[],
                        metavar="key.path=value",
                        help="config override, e.g. -o learn.lr=0.01")
    parser.add_argument("--split_set", default="test",
                        choices=("train", "val", "test"),
                        help="split evaluated by gather / uiprotomfs_combine")
    parser.add_argument("--gather_k", type=int, default=None,
                        help="top-k export size for gather")
    parser.add_argument("--u_run_dir", default=None,
                        help="uiprotomfs_combine: fitted UProtoMFs run dir")
    parser.add_argument("--i_run_dir", default=None,
                        help="uiprotomfs_combine: fitted IProtoMFs run dir")
    args = parser.parse_args(argv)

    if args.algorithm == COMBINE_ALG:
        if not (args.u_run_dir and args.i_run_dir):
            parser.error(f"{COMBINE_ALG} requires --u_run_dir and "
                         f"--i_run_dir")
        return run_combine_experiment(args.u_run_dir, args.i_run_dir,
                                      split_set=args.split_set)
    if not (args.dataset_path and args.conf_path):
        parser.error("--dataset_path/-d and --conf_path/-c are required")

    overrides = {"dataset.dataset_path": args.dataset_path}
    for item in args.override:
        key, _, value = item.partition("=")
        overrides[key] = yaml.safe_load(value)
    conf = get_config(
        args.conf_path, algorithm=args.algorithm,
        dataset_name=args.dataset_name or os.path.basename(
            os.path.normpath(args.dataset_path)),
        split_type=args.split_type, overrides=overrides)
    if args.run_type == "gather":
        return run_gather(conf, split_set=args.split_set, k=args.gather_k)
    return RUNS[args.run_type](conf)


if __name__ == "__main__":
    main()
