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
    # a toy-scale file (make_artifacts' 100 x 120, no MIDSCALE_HPARAMS)
    python torch_trained_parity.py jax --family ecf --scale toy \
        --out sibrar_tpu_torch/tools/trained_parity_jax_toy.json
    # JAX's ECF draws, init and epochs, one .npz per seed, for a replay
    python torch_trained_parity.py replay-jax --scale toy --out-dir _replay
    # the port side (no JAX), on the card or with --device cpu
    python -m sibrar_tpu_torch.tools.trained_parity --family sbnet mf \
        --seeds 0 1 2 3 4 --out port.json
    # the join: trained_parity_stats' keys per family, JAX as "ref"
    python torch_trained_parity.py join \
        --jax sibrar_tpu_torch/tools/trained_parity_jax.json --port port.json

The gate per family (``tests/test_trained_parity.py``): |delta_mean| <=
max(0.01, delta_sem), and both means above 0.03. The matrix algorithms
that fit without random draws (``uknn``, ``iknn``, ``ifknn``, ``ease``,
``slim``, ``p3alpha``, ``svd``, ``rbmf``, ``pop``) are held instead to
JAX's val ndcg@10 and recall@10 within 1e-3 on every seed run; ``als``
and ``rand`` take the paired-seed gate (``als`` at seed 0 alone: each side
starts from one fixed draw whatever the seed, so its seeds cannot differ).

    python torch_trained_parity.py jax --family uknn iknn ifknn ease slim \
        p3alpha svd rbmf pop --seeds 0 --out /tmp/jax_matrix.json
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import tempfile
import time

import numpy as np

from sibrar_tpu_torch.tools.trained_parity import (
    EXACT_MATRIX,
    MATRIX_HPARAMS,
    MATRIX_TOLERANCE,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
FLOOR = 0.03
TOLERANCE = 0.01


def jax_matrix(family: str, artifact_dir: str, seed: int = 0,
               hparams: dict | None = None) -> dict:
    """JAX's side of the port's ``train_port_matrix``: ``{"ndcg",
    "recall"}`` at 10 on the val split of matrix algorithm ``family``
    fitted on the train split by JAX's registry build (``rand`` as
    ``RandomItems(seed)``), users in batches of 256."""
    from sibrar_tpu.config.schema import EvalConfig, FeatureDefinition, \
        FeatureType
    from sibrar_tpu.data.dataset import RecDataset
    from sibrar_tpu.eval.evaluator import FullEvaluator, evaluate_model
    from sibrar_tpu.experiment import _fit_matrix_algorithm
    from sibrar_tpu.models.matrix_algs import RandomItems
    from sibrar_tpu.models.registry import get_algorithm

    h = dict(MATRIX_HPARAMS[family], **(hparams or {}))
    item = [FeatureDefinition(h["feature_name"], FeatureType.VECTOR)] \
        if family == "ifknn" else None
    tr = RecDataset.load(artifact_dir, "train", item_feature_definitions=item)
    va = RecDataset.load(artifact_dir, "val")
    alg = (RandomItems(seed) if family == "rand"
           else get_algorithm(family).build(h, tr))
    _fit_matrix_algorithm(alg, tr)
    ev = FullEvaluator(EvalConfig(top_k=[10], metrics=["ndcg", "recall"]),
                       va, evaluator_name="val")
    m = evaluate_model(alg.score_fn(va.items_in_split), ev, 256)
    return {"ndcg": float(m["val/ndcg@10"]),
            "recall": float(m["val/recall@10"])}


def run_jax(families, seeds, scale: str = "mid") -> dict:
    """Best validation ndcg@10 of JAX's ``train_ours_<family>`` per seed.
    At ``mid`` scale the artifacts are JAX's ``make_midscale_artifacts``
    and the hyperparameters are updated by its ``MIDSCALE_HPARAMS``; at
    ``toy`` scale they are ``make_artifacts``' defaults (100 users x 120
    items) and the family's own hyperparameters (``tests/
    test_trained_parity.py``'s setting)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import jax

    import trained_parity as tp

    out = {"scale": scale, "platform": jax.default_backend(),
           "jax": jax.__version__, "families": {}}
    with tempfile.TemporaryDirectory() as d:
        (tp.make_midscale_artifacts if scale == "mid"
         else tp.make_artifacts)(d)
        for family in families:
            if family in MATRIX_HPARAMS:
                h = dict(MATRIX_HPARAMS[family])
                ours_fn = functools.partial(jax_matrix, family)
            else:
                _, ours_fn, base = tp._families()[family]
                h = dict(base)
                if scale == "mid":
                    h.update(tp.MIDSCALE_HPARAMS.get(family, {}))
            runs, secs, recall = {}, {}, {}
            for s in seeds:
                t0 = time.perf_counter()
                r = ours_fn(d, seed=s, hparams=h)
                if isinstance(r, dict):  # a matrix algorithm
                    r, recall[str(s)] = r["ndcg"], r["recall"]
                runs[str(s)] = float(r)
                secs[str(s)] = round(time.perf_counter() - t0, 1)
                print(f"jax {family} seed {s}: {runs[str(s)]:.6f} "
                      f"({secs[str(s)]} s)", flush=True)
            out["families"][family] = {"hparams": h, "runs": runs,
                                       "seconds": secs}
            if recall:
                out["families"][family]["recall"] = recall
    return out


def record_jax_ecf(artifact_dir: str, seed: int, h: dict) -> dict:
    """JAX's ECF training, set up as ``train_ours_ecf`` and run epoch by
    epoch, with what a replay needs (flat arrays): the initial parameters
    (``init/<path>``), every step's users (``users``) and items (``items``,
    global ids, the positive first) in order with the steps' sizes
    (``sizes``), the validation ndcg@10 before training and after each
    epoch (``val``), the parameters after each epoch (``epoch<e>/<path>``)
    and after each step of the first epoch (``step<j>/<path>``). The draws
    are derived from the trainer's keys as its epoch function derives them
    (``sibrar_tpu/train/trainer.py``: the epoch's permutation under
    ``fold_in(rng, 1000003 + step)``, each step's negatives under the first
    of ``split(fold_in(rng, step), 3)``)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    import trained_parity as tp
    from sibrar_tpu.config.schema import (
        DatasetConfig,
        EvalConfig,
        FeatureDefinition,
        FeatureType,
        LearningConfig,
    )
    from sibrar_tpu.data.dataset import RecDataset
    from sibrar_tpu.data.sampling import sample_negatives
    from sibrar_tpu.eval.evaluator import FullEvaluator
    from sibrar_tpu.models.ecf import ECF
    from sibrar_tpu.train.trainer import Trainer

    h = dict(tp.ECF_HPARAMS, **h)
    feat = [FeatureDefinition("genres", FeatureType.TAG)]
    tr = RecDataset.load(artifact_dir, "train",
                         item_feature_definitions=feat)
    va = RecDataset.load(artifact_dir, "val")
    learn = LearningConfig(
        n_epochs=h["epochs"], lr=h["lr"], wd=h["wd"], rec_loss=h["loss"],
        max_patience=h["epochs"] + 1, optimizing_metric="ndcg@10")
    ev = FullEvaluator(EvalConfig(top_k=[10], metrics=["ndcg"]), va,
                       evaluator_name="val")
    dconf = DatasetConfig(n_negative_samples=h["n_neg"])

    def make_trainer():
        """A fresh trainer on fresh device data: an epoch donates its
        state, whose ``tables`` hold the data's interaction arrays."""
        dd = tr.to_device()
        model = ECF.build_from_conf(
            {k: h[k] for k in ("embedding_dim", "n_clusters", "top_n",
                               "top_m", "top_p")} | {"tag_feature": "genres"},
            tr, dd)
        return Trainer(model, tr, ev, learn, dconf,
                       batch_size=h["batch_size"], seed=seed, device_data=dd)

    trainer = make_trainer()
    dd = trainer.data

    def flat(prefix, params):
        return {f"{prefix}/" + "/".join(k): np.asarray(v)
                for k, v in flatten_dict(params).items()}

    out = flat("init", trainer.state.params)
    n_inter = int(dd.train_users.shape[0])
    n_batches, tail = trainer.epoch_batch_plan(n_inter, h["batch_size"], None)
    sizes = [h["batch_size"]] * n_batches + ([tail] if tail else [])
    users, items, val, step = [], [], [trainer.validate()["val/ndcg@10"]], 0
    for e in range(h["epochs"]):
        rng = trainer.state.rng  # the epoch donates the state: read anew
        perm = jax.random.permutation(
            jax.random.fold_in(rng, 1000003 + step), n_inter)
        off = 0
        for size in sizes:
            idxs = perm[off:off + size]
            off += size
            k_neg = jax.random.split(jax.random.fold_in(rng, step), 3)[0]
            u = dd.train_users[idxs]
            negs = sample_negatives(
                k_neg, u, dd.pos_csr, dd.popularity,
                strategy=dconf.negative_sampling_strategy,
                n_catalog=tr.n_items_in_split, n_neg=h["n_neg"],
                squashing_factor=dconf.popularity_squashing_factor)
            i_cat = jnp.concatenate([dd.train_items_cat[idxs][:, None], negs],
                                    axis=1)
            users.append(np.asarray(u))
            items.append(np.asarray(dd.catalog[i_cat]))
            step += 1
        trainer.train_epoch()
        if int(trainer.state.step) != step:
            raise RuntimeError(f"epoch {e}: the trainer took "
                               f"{int(trainer.state.step)} steps, not {step}")
        val.append(trainer.validate()["val/ndcg@10"])
        out.update(flat(f"epoch{e}", trainer.state.params))
    # the first epoch again from the same init, one step per call, each
    # step's parameters kept (``step<j>/<path>``): where the port parts
    trainer = make_trainer()
    perm = jax.random.permutation(
        jax.random.fold_in(trainer.state.rng, 1000003), n_inter)
    off = 0
    for j, size in enumerate(sizes):
        fn = trainer._make_epoch_fn(*((1, 0) if size == h["batch_size"]
                                      else (0, size)))
        trainer.state, _ = fn(trainer.state, perm[off:off + size])
        off += size
        out.update(flat(f"step{j}", trainer.state.params))
    out.update(users=np.concatenate(users), items=np.concatenate(items),
               sizes=np.asarray(sizes * h["epochs"], np.int64),
               val=np.asarray(val, np.float64))
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
        if family in EXACT_MATRIX:
            # no random draws: each seed's ndcg@10 and recall@10 within
            # MATRIX_TOLERANCE of JAX's
            ref_rec = jax_runs["families"][family]["recall"]
            r["max_abs_diff_ndcg"] = float(np.abs(deltas).max())
            r["max_abs_diff_recall"] = float(max(
                abs(port["recall"][s] - ref_rec[s]) for s in seeds))
            r["passes"] = bool(max(r["max_abs_diff_ndcg"],
                                   r["max_abs_diff_recall"])
                               <= MATRIX_TOLERANCE)
        else:
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
    j.add_argument("--scale", default="mid", choices=("mid", "toy"))
    j.add_argument("--out", required=True)
    r = sub.add_parser("replay-jax", help="record JAX's ECF draws, init "
                       "and epochs for the port's --replay")
    r.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2, 3, 4])
    r.add_argument("--scale", default="toy", choices=("mid", "toy"))
    r.add_argument("--out-dir", required=True)
    k = sub.add_parser("join", help="join a port run with the JAX runs")
    k.add_argument("--jax", required=True)
    k.add_argument("--port", required=True)
    k.add_argument("--out")
    args = p.parse_args(argv)
    if args.cmd == "jax":
        res = run_jax(args.family, args.seeds, args.scale)
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
            fh.write("\n")
        return 0
    if args.cmd == "replay-jax":
        sys.path.insert(0, os.path.join(ROOT, "tools"))
        import trained_parity as tp

        os.makedirs(args.out_dir, exist_ok=True)
        h = {} if args.scale == "toy" else tp.MIDSCALE_HPARAMS["ecf"]
        with tempfile.TemporaryDirectory() as d:
            (tp.make_midscale_artifacts if args.scale == "mid"
             else tp.make_artifacts)(d)
            for s in args.seeds:
                rec = record_jax_ecf(d, s, h)
                np.savez_compressed(os.path.join(
                    args.out_dir, f"ecf_{args.scale}_seed{s}.npz"), **rec)
                print(f"jax ecf seed {s}: best {rec['val'].max():.6f}",
                      flush=True)
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
