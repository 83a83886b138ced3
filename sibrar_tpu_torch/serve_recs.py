"""Batch recommendation CLI over a fitted run directory of the port (port
of the repository root's ``serve_recs.py``, with its arguments, defaults
and output formats, plus ``--device``).

It reloads a fitted run (`serve.Recommender.from_run_dir`), serves the
requested users in fixed-size batches, and writes one ranked list per
user: CSV (``user,item_0,...[,score_0,...]``) or, for a ``.jsonl`` path,
JSON lines (``{"user", "items"[, "scores"]}``, scores rounded to 6
places).

    # top-10 test-split lists for every user, as CSV
    python -m sibrar_tpu_torch.serve_recs -r results/mf_run -k 10 -o recs.csv

    # specific users (one id per line), JSONL with scores, bf16 GEMM
    python -m sibrar_tpu_torch.serve_recs -r results/sbnet_run \\
        -u users.txt -k 100 --dtype bfloat16 --scores -o recs.jsonl

``--selection approx`` ranks exactly on the port (K13 after the exact
exclusion fill): recall 1.0, at or above any ``--recall_target``. Under
torchrun the run's ``parallel`` block serves on a mesh
(`serve.Recommender`), and rank 0 writes the lists.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys

import numpy as np

from sibrar_tpu_torch.parallel.distributed import (
    initialize_distributed,
    is_main,
)
from sibrar_tpu_torch.serve import Recommender


def _parse_users(arg: str | None, dataset) -> np.ndarray:
    if arg is None:
        return np.asarray(dataset.users_in_split)
    try:  # inline comma-separated ids
        return np.asarray([int(x) for x in arg.split(",")], dtype=np.int64)
    except ValueError:
        pass
    with open(arg) as f:  # one id per line
        return np.asarray([int(line) for line in f if line.strip()],
                          dtype=np.int64)


def _write(out, users, ids, scores, k: int, jsonl: bool,
           with_scores: bool) -> None:
    if jsonl:
        for u, row_i, row_s in zip(users, ids, scores):
            obj = {"user": int(u), "items": [int(i) for i in row_i]}
            if with_scores:
                obj["scores"] = [round(float(s), 6) for s in row_s]
            out.write(json.dumps(obj) + "\n")
        return
    hdr = ["user"] + [f"item_{j}" for j in range(k)]
    if with_scores:
        hdr += [f"score_{j}" for j in range(k)]
    out.write(",".join(hdr) + "\n")
    for u, row_i, row_s in zip(users, ids, scores):
        cells = [str(int(u))] + [str(int(i)) for i in row_i]
        if with_scores:
            cells += [f"{float(s):.6g}" for s in row_s]
        out.write(",".join(cells) + "\n")


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    initialize_distributed()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-r", "--run_dir", required=True,
                   help="fitted run directory (conf.yml + model.pt or "
                        "model.npz)")
    p.add_argument("-u", "--users", default=None,
                   help="comma-separated ids or a file with one id per line "
                        "(default: every user in the split)")
    p.add_argument("-k", type=int, default=10, help="list length")
    p.add_argument("-s", "--split_set", default="test",
                   choices=("val", "test"),
                   help="exclusion context: test = train+val seen items")
    p.add_argument("-o", "--out", default="-",
                   help="output path; .jsonl for JSON lines, else CSV "
                        "(default: stdout CSV)")
    p.add_argument("--scores", action="store_true",
                   help="include the score next to each item id")
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16", "int8"),
                   help="GEMM inputs for dot models: bfloat16 = one "
                        "tensor-core pass (K15); int8 = per-row "
                        "post-training quantization, 4x smaller item table "
                        "(see serve.Recommender)")
    p.add_argument("--selection", default="exact",
                   choices=("exact", "approx"),
                   help="approx: exclusion fill + K13 top-k, exact on the "
                        "port (recall 1.0)")
    p.add_argument("--recall_target", type=float, default=0.95)
    p.add_argument("--include_seen", action="store_true",
                   help="do NOT exclude already-interacted items")
    p.add_argument("--device", default=None,
                   help="cuda or cpu (default: the run's "
                        "run_settings.device)")
    args = p.parse_args(argv)

    rec = Recommender.from_run_dir(
        args.run_dir, split=args.split_set, device=args.device, k=args.k,
        batch_size=args.batch_size,
        dtype=None if args.dtype == "float32" else args.dtype,
        selection=args.selection, recall_target=args.recall_target,
        exclude_seen=not args.include_seen)
    users = _parse_users(args.users, rec.dataset)
    ids, scores = rec.recommend(users, k=args.k, return_scores=True)
    if not is_main():
        return 0

    out = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        _write(out, users, ids, scores, args.k, args.out.endswith(".jsonl"),
               args.scores)
    finally:
        if out is not sys.stdout:
            out.close()
            logging.info("wrote %d lists to %s", len(users), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
