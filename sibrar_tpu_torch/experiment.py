"""Experiment orchestration: config -> data -> model -> fit -> evaluation ->
run files (port of ``sibrar_tpu/experiment.py``: ``run_train_val``,
``run_test``, ``run_train_val_test``, ``run_gather`` and
``run_combine_experiment``, for the ``sgd`` and ``matrix`` families).

A run reads its splits from ``conf.dataset.dataset_path`` (the split type
from the directory's ``used_config.yaml``) and writes into
``results/{dataset}/{split_dir}/{algorithm}/{run_id}`` unless
``results_path`` is set: ``conf.yml`` before training, ``model.pt``
whenever the best validation improves, ``metrics_val.yml`` (fit's best
validation) and ``metrics_test.yml``. ``profile_training`` writes a
``torch.profiler`` trace of the first epoch under ``profile/``. A ProtoMF
run adds `eval.explanations.protomf_post_val`'s prototype diagnostics to
every validation's metrics. ``run_gather`` writes ``gather_{split}.pkl``
(per-user metrics and exclusion-masked top-k lists, JAX's payload), which
``eval/stat_tests.py`` compares.

`load_for_serving` rebuilds a fitted run directory for serving
(``serve.Recommender.from_run_dir``, ``python -m
sibrar_tpu_torch.serve_recs``).

A matrix algorithm (``models/matrix_algs.py``) fits once over the train
CSR (`_fit_matrix_algorithm`), writes JAX's ``model.npz`` and is
validated, tested, gathered and served through its ``score_fn`` on the
scores path, as in JAX.

``run_settings.device``: ``cuda`` and ``tpu`` run on the card and raise
when there is none, ``cpu`` runs on the CPU. ``run_settings.debug_nans``
makes the trainer raise ``FloatingPointError`` at the first train step
with a NaN in its loss, gradients or updated parameters (JAX's
``jax_debug_nans`` traps the operation that made it; see
``train/trainer.py``).

``parallel``: under torchrun (`parallel.distributed.initialize_distributed`)
`_make_run_mesh` turns the block into a (data, item) mesh
(`parallel.mesh.make_mesh_from_config`; None for one device, as in JAX),
rounding ``loader.batch_size`` up to the mesh's rank count where
``adjust_batch_sizes`` allows, and the trainer, evaluators and scorers
run on it (``shard_towers`` / ``tower_min_rows`` slice the tower
kernels). Every rank returns the same metrics; only rank 0 writes
``conf.yml``, ``model.pt``, the metrics files, the gather payload and
W&B, into the run directory rank 0 names.
"""
from __future__ import annotations

import logging
import os
import pickle
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from sibrar_tpu_torch import config_from_dict
from sibrar_tpu_torch.config.loader import (
    load_split_type,
    parse_conf_file,
    yaml_save,
)
from sibrar_tpu_torch.config.schema import (
    DatasetSplitType,
    ExperimentConfig,
    as_dict,
)
from sibrar_tpu_torch.data.dataset import RecDataset
from sibrar_tpu_torch.eval.evaluator import FullEvaluator, evaluate_model
from sibrar_tpu_torch.models.protomf import UIProtoMFsCombine
from sibrar_tpu_torch.models.registry import AlgorithmSpec, get_algorithm
from sibrar_tpu_torch.ops.sparse import csr_row_gather
from sibrar_tpu_torch.ops.topk import NEG, masked_topk
from sibrar_tpu_torch.parallel import distributed as pdist
from sibrar_tpu_torch.parallel.mesh import (
    batch_multiple,
    gather_rows,
    make_mesh_from_config,
    pad_to_multiple,
    shard_catalog,
    shard_rows,
    sharded_masked_topk,
)
from sibrar_tpu_torch.train.trainer import Trainer
from sibrar_tpu_torch.utils.misc import (
    generate_id,
    log_info_results,
    reproducible,
)

logger = logging.getLogger(__name__)


def resolve_device(conf: ExperimentConfig) -> torch.device:
    """The device ``run_settings.device`` names: ``cuda`` or ``tpu`` the
    card (raises without one), ``cpu`` the CPU."""
    name = conf.run_settings.device
    if name == "cpu":
        return torch.device("cpu")
    if name not in ("cuda", "tpu"):
        raise ValueError(f"unsupported device {name!r} (use 'cuda', 'tpu' "
                         f"for the card, or 'cpu')")
    if name == "tpu":
        logger.info("run_settings.device 'tpu' runs on the CUDA card")
    if not torch.cuda.is_available():
        raise RuntimeError(f"run_settings.device={name!r} asks for the "
                           f"card, and torch.cuda.is_available() is false; "
                           f"pass -o run_settings.device=cpu for the CPU")
    return torch.device("cuda")


def _tower_kwargs(conf: ExperimentConfig) -> dict:
    """Trainer kwargs for tensor-parallel interaction towers."""
    p = conf.parallel
    if p is None:
        return {}
    return {"shard_towers": p.shard_towers,
            "tower_min_rows": p.tower_min_rows}


def _make_run_mesh(conf: ExperimentConfig):
    """``conf.parallel`` as a mesh (None for one device), with
    ``loader.batch_size`` rounded up to the mesh's rank count where
    ``parallel.adjust_batch_sizes`` allows (else a batch that does not
    divide raises)."""
    mesh = make_mesh_from_config(conf.parallel)
    if mesh is None:
        return None
    mult = batch_multiple(mesh)
    if conf.loader.batch_size % mult:
        if not conf.parallel.adjust_batch_sizes:
            raise ValueError(
                f"loader.batch_size={conf.loader.batch_size} does not divide "
                f"over the mesh ({mult} devices); set "
                f"parallel.adjust_batch_sizes or fix the batch size")
        new = pad_to_multiple(conf.loader.batch_size, mult)
        logger.info("rounding loader.batch_size %d -> %d to divide over the "
                    "%d-device mesh", conf.loader.batch_size, new, mult)
        conf.loader.batch_size = new
    return mesh


def _fit_matrix_algorithm(alg, train_ds: RecDataset) -> None:
    """Fit a matrix algorithm on the train CSR; ifknn also gets its item
    feature's `FeatureTable.dense_table` as ``feature_matrix`` (JAX
    ``_fit_matrix_algorithm``)."""
    kwargs = {}
    feature_name = getattr(alg, "feature_name", None)
    if feature_name:
        kwargs["feature_matrix"] = train_ds.item_features[
            feature_name].dense_table()
    alg.fit(matrix=train_ds.user_sampling_matrix, **kwargs)


def _saved_scorer(conf: ExperimentConfig, spec: AlgorithmSpec,
                  train_ds: RecDataset, evaluator: FullEvaluator,
                  run_dir: str, device: torch.device):
    """The scorer of a fitted run over ``evaluator``'s split: an ``sgd``
    model with ``model.pt`` loaded and its catalog encoded once (on
    ``evaluator.mesh``, its tower kernels sliced), or a matrix algorithm
    from ``model.npz``."""
    if spec.kind == "matrix":
        alg = spec.build(conf.model, train_ds, device)
        alg.load(run_dir)
        return alg.score_fn(evaluator.dataset.items_in_split)
    train_data = train_ds.to_device(device)
    model = spec.build(conf.model, train_ds, train_data,
                       conf.run_settings.seed)
    mesh = evaluator.mesh
    trainer = Trainer(model, train_ds, conf.learn, conf.dataset,
                      batch_size=pad_to_multiple(conf.loader.batch_size,
                                                 batch_multiple(mesh)),
                      seed=conf.run_settings.seed, device_data=train_data,
                      val_evaluator=evaluator, mesh=mesh,
                      **_tower_kwargs(conf))
    trainer.load(run_dir)
    return trainer.make_score_fn()


def _load_split(conf: ExperimentConfig, split_set: str,
                split_type: DatasetSplitType) -> RecDataset:
    return RecDataset.load(
        conf.dataset.dataset_path, split_set,
        user_feature_definitions=conf.dataset.user_features or None,
        item_feature_definitions=conf.dataset.item_features or None,
        split_type=split_type)


def _results_path(conf: ExperimentConfig) -> str:
    """The run directory: ``results_path``, or one named after the run id
    (rank 0's, on every rank); only rank 0 makes it."""
    if not conf.results_path:
        run_id = pdist.broadcast_object(conf.run_id or generate_id())
        conf.results_path = os.path.join(
            "results", conf.dataset_name, conf.split_type.dir_name,
            conf.algorithm, run_id)
    if pdist.is_main():
        os.makedirs(conf.results_path, exist_ok=True)
    return conf.results_path


def _maybe_wandb(conf: ExperimentConfig):
    """A live wandb run, or None when it is not asked for, on a rank other
    than 0, or when wandb is not installed (with a warning)."""
    if not (conf.wandb.use_wandb or conf.run_settings.use_wandb):
        return None
    if not pdist.is_main():  # one W&B run per experiment: rank 0's
        return None
    try:
        import wandb
    except ImportError:
        logging.warning("wandb requested but not installed; logging "
                        "disabled")
        return None
    if getattr(wandb, "run", None) is not None:
        return wandb.run  # a sweep agent's run: it owns the lifecycle
    run = wandb.init(
        project=conf.wandb.project, entity=conf.wandb.entity,
        name=conf.run_id or None, tags=list(conf.wandb.tags) or None,
        config=as_dict(conf), reinit=True)
    if run is not None:
        run._sibrar_owned = True  # only runs opened here are finished here
    return run


def _make_log_fn(conf: ExperimentConfig, wandb_run):
    """Per-epoch metric sink: one console line per epoch, plus W&B and Ray
    Tune (``in_tune``) where they are on."""
    sinks = [wandb_run.log] if wandb_run else []
    if conf.run_settings.in_tune:
        try:
            from ray.air import session

            sinks.append(lambda d: session.report(
                {k: v for k, v in d.items() if isinstance(v, (int, float))}))
        except ImportError:
            logging.warning("in_tune requested but ray is not installed")
    console = logging.getLogger("sibrar_tpu_torch.train")
    opt = conf.learn.optimizing_metric

    def log(d: dict) -> None:
        keys = ("epoch", "train/loss", "train/epoch_wall_s", "val/wall_s",
                f"val/{opt}", f"train/{opt}")
        console.info("%s", " ".join(
            f"{k}={d[k]:.5g}" if isinstance(d[k], float) else f"{k}={d[k]}"
            for k in keys if k in d))
        for sink in sinks:
            sink(d)

    return log


def _finish(wandb_run) -> None:
    if wandb_run and getattr(wandb_run, "_sibrar_owned", False):
        wandb_run.finish()


def _post_val_fn(conf: ExperimentConfig, results_path: str):
    """The ProtoMF runs' post-validation hook (names ending in ``protomf``
    or ``protomfs``): `protomf_post_val` of the user side (``u*``), the
    item side (``i*``) or both (``ui*``); None for other algorithms."""
    name = conf.algorithm
    if not name.endswith(("protomf", "protomfs")):
        return None
    from sibrar_tpu_torch.eval.explanations import protomf_post_val

    entities = (("user", "item") if name.startswith("ui")
                else ("item",) if name[0] == "i" else ("user",))

    def post_val(model, epoch: int) -> dict:
        out = {}
        for entity in entities:
            out.update(protomf_post_val(
                model, entity, epoch,
                results_dir=results_path if pdist.is_main() else None))
        return out

    return post_val


def run_train_val(conf: ExperimentConfig, log_fn=None) -> dict:
    """Train on the train split, validating on val; returns (and writes)
    the best validation metrics."""
    reproducible(conf.run_settings.seed)
    device = resolve_device(conf)
    spec = get_algorithm(conf.algorithm)
    mesh = _make_run_mesh(conf)  # may round the batch size: conf.yml after
    results_path = _results_path(conf)
    if pdist.is_main():
        yaml_save(os.path.join(results_path, "conf.yml"), as_dict(conf))
    split_type = load_split_type(conf.dataset.dataset_path)
    train_ds = _load_split(conf, "train", split_type)
    val_ds = _load_split(conf, "val", split_type)
    evaluator = FullEvaluator(conf.eval, val_ds, device=device,
                              evaluator_name="val", mesh=mesh)
    wandb_run = _maybe_wandb(conf)
    if spec.kind == "matrix":
        alg = spec.build(conf.model, train_ds, device)
        _fit_matrix_algorithm(alg, train_ds)
        if pdist.is_main():
            alg.save(results_path)
        metrics = evaluate_model(alg.score_fn(val_ds.items_in_split),
                                 evaluator, conf.loader.eval_batch_size)
        (log_fn or _make_log_fn(conf, wandb_run))(metrics)
        return _write_val(conf, results_path, metrics, wandb_run)
    train_data = train_ds.to_device(device)
    model = spec.build(conf.model, train_ds, train_data,
                       conf.run_settings.seed)
    trainer = Trainer(
        model, train_ds, conf.learn, conf.dataset,
        batch_size=conf.loader.batch_size, seed=conf.run_settings.seed,
        device_data=train_data, val_evaluator=evaluator,
        eval_batch_size=conf.loader.eval_batch_size,
        results_path=results_path,
        log_fn=log_fn or _make_log_fn(conf, wandb_run),
        train_evaluator=(FullEvaluator(conf.eval, train_ds, train_data,
                                       evaluator_name="train", mesh=mesh)
                         if conf.train_eval else None),
        post_val_fn=_post_val_fn(conf, results_path),
        profile_dir=(os.path.join(results_path, "profile")
                     if conf.profile_training and pdist.is_main() else None),
        debug_nans=conf.run_settings.debug_nans, mesh=mesh,
        **_tower_kwargs(conf))
    return _write_val(conf, results_path, trainer.fit(), wandb_run)


def _write_val(conf: ExperimentConfig, results_path: str, metrics: dict,
               wandb_run) -> dict:
    if pdist.is_main():
        yaml_save(os.path.join(results_path, "metrics_val.yml"), metrics)
    log_info_results(metrics)
    _finish(wandb_run)
    pdist.barrier()  # the run's files exist before any rank reads them
    return metrics


def run_test(conf: ExperimentConfig, log_fn=None) -> dict:
    """Evaluate the run's saved best model (``model.pt``) on the test
    split, with no training step; returns (and writes) the metrics."""
    reproducible(conf.run_settings.seed)
    device = resolve_device(conf)
    spec = get_algorithm(conf.algorithm)
    mesh = _make_run_mesh(conf)
    results_path = _results_path(conf)
    split_type = load_split_type(conf.dataset.dataset_path)
    train_ds = _load_split(conf, "train", split_type)
    test_ds = _load_split(conf, "test", split_type)
    evaluator = FullEvaluator(conf.eval, test_ds, device=device,
                              evaluator_name="test", mesh=mesh)
    wandb_run = _maybe_wandb(conf)
    if wandb_run is not None and hasattr(wandb_run, "define_metric"):
        # a running W&B run rejects test/* at step 0 without its own axis
        wandb_run.define_metric("test/step")
        wandb_run.define_metric("test/*", step_metric="test/step")
    metrics = evaluate_model(
        _saved_scorer(conf, spec, train_ds, evaluator, results_path, device),
        evaluator, conf.loader.eval_batch_size)
    (log_fn or _make_log_fn(conf, wandb_run))(metrics)
    if pdist.is_main():
        yaml_save(os.path.join(results_path, "metrics_test.yml"), metrics)
    log_info_results(metrics)
    _finish(wandb_run)
    return metrics


def _run_conf(run_dir: str) -> ExperimentConfig:
    """A run directory's ``conf.yml``, its results path the directory."""
    conf = config_from_dict(ExperimentConfig, parse_conf_file(
        os.path.join(run_dir, "conf.yml")))
    conf.results_path = run_dir
    return conf


def run_train_val_test(conf: ExperimentConfig) -> tuple[dict, dict]:
    return run_train_val(conf), run_test(conf)


def run_combine_experiment(u_run_dir: str, i_run_dir: str,
                           split_set: str = "test") -> dict:
    """``uiprotomfs_combine``: the score sum of two fitted runs (a
    UProtoMFs and an IProtoMFs run), evaluated on ``split_set`` with the U
    run's ``eval`` config and eval batch size, with no training. Each
    scorer is `load_for_serving`'s over the test split's catalog (JAX's
    ``reload_run``), on the U run's device."""
    u_conf = _run_conf(u_run_dir)
    device = resolve_device(u_conf)
    u_score = load_for_serving(u_run_dir, "test", device)[0]
    i_score = load_for_serving(i_run_dir, "test", device)[0]
    eval_ds = _load_split(u_conf, split_set,
                          load_split_type(u_conf.dataset.dataset_path))
    evaluator = FullEvaluator(u_conf.eval, eval_ds, device=device,
                              evaluator_name=split_set,
                              mesh=_make_run_mesh(u_conf))
    metrics = evaluate_model(UIProtoMFsCombine(u_score, i_score), evaluator,
                             u_conf.loader.eval_batch_size)
    log_info_results(metrics)
    return metrics


def run_gather(conf: ExperimentConfig, split_set: str = "test",
               k: Optional[int] = None,
               out_name: Optional[str] = None) -> dict:
    """Evaluate the run's saved model (``model.pt``) on ``split_set`` and
    write JAX's gather payload to ``gather_{split_set}.pkl`` (or
    ``out_name``) in the run directory: ``metrics``, ``raw_metrics`` (the
    per-user values), ``user_indices`` (the split's users, in order),
    ``topk_item_indices`` (catalog positions, int32) and ``topk_logits``
    of each user's top-``k`` with its seen items excluded
    (`ops.topk.masked_topk`), ``targets`` (``(user row, catalog
    position)`` pairs of the split's positives, int64), ``n_users``,
    ``n_items``, ``k`` (default the largest cutoff, at most the catalog)
    and ``items_in_split``. Users go in batches of the eval batch size,
    the last one padded by repeating its last user; when ``k`` covers
    every cutoff the metrics come from the exported lists
    (``eval_batch_from_topk``)."""
    reproducible(conf.run_settings.seed)
    device = resolve_device(conf)
    spec = get_algorithm(conf.algorithm)
    mesh = _make_run_mesh(conf)
    results_path = _results_path(conf)
    split_type = load_split_type(conf.dataset.dataset_path)
    train_ds = _load_split(conf, "train", split_type)
    eval_ds = _load_split(conf, split_set, split_type)
    evaluator = FullEvaluator(conf.eval, eval_ds, device=device,
                              evaluator_name=split_set, mesh=mesh)
    score_fn = _saved_scorer(conf, spec, train_ds, evaluator, results_path,
                             device)

    if k is None:
        k = max(conf.eval.top_k)
    k = min(k, eval_ds.n_items_in_split)
    users_dev = evaluator.data.users_in_split
    users = users_dev.cpu().numpy()
    bs = conf.loader.eval_batch_size
    top_idx, top_logits = [], []
    with torch.no_grad():
        for start in range(0, len(users), bs):
            u = users_dev[start:start + bs]
            valid = np.ones(len(u), bool)
            pad = bs - len(u)
            if pad > 0:
                u = torch.cat([u, u[-1:].expand(pad)])
                valid = np.concatenate([valid, np.zeros(pad, bool)])
            if mesh is None:
                scores = score_fn(u)
                v, i = masked_topk(scores, evaluator.data.exclude_csr, u, k)
                vg, ig = v, i
            else:  # this rank's rows and catalog columns, lists gathered
                scores, u, v, i, vg, ig, valid_l = _gather_batch_mesh(
                    score_fn, evaluator, u, valid, k)
            top_idx.append(ig.to(torch.int32).cpu().numpy()[valid])
            top_logits.append(vg.cpu().numpy()[valid])
            if mesh is not None:
                valid = valid_l
            if k >= evaluator.k_max:
                evaluator.eval_batch_from_topk(u, i, valid=valid)
            else:
                evaluator.eval_batch(u, scores, valid=valid)
    metrics, raw = evaluator.get_results(return_raw_results=True)

    inter = eval_ds.interactions
    item_to_catalog = np.full(eval_ds.n_items, -1, dtype=np.int64)
    item_to_catalog[eval_ds.items_in_split] = np.arange(
        eval_ds.n_items_in_split)
    pos = sp.csr_matrix(
        (np.ones(len(inter), np.int8),
         (inter[:, 0], item_to_catalog[inter[:, 1]])),
        shape=(eval_ds.n_users, eval_ds.n_items_in_split))
    coo = pos[users].tocoo()
    payload = {
        "metrics": metrics,
        "raw_metrics": raw,
        "user_indices": users,
        "topk_item_indices": np.concatenate(top_idx),
        "topk_logits": np.concatenate(top_logits),
        "targets": np.stack([coo.row, coo.col], axis=1).astype(np.int64),
        "n_users": len(eval_ds.users_in_split),
        "n_items": eval_ds.n_items_in_split,
        "k": k,
        "items_in_split": np.asarray(eval_ds.items_in_split),
    }
    out = os.path.join(results_path, out_name or f"gather_{split_set}.pkl")
    if pdist.is_main():
        with open(out, "wb") as fh:
            pickle.dump(payload, fh)
    log_info_results(metrics)
    return payload


def _gather_batch_mesh(score_fn, evaluator: FullEvaluator, u: torch.Tensor,
                       valid: np.ndarray, k: int):
    """One `run_gather` batch on a mesh: this rank's rows ``u`` and its
    tile of scores, the per-shard scatter top-k of its rows (ids clamped
    into the catalog), and the batch's lists gathered over the data axis.
    Returns ``(tile, rows, v, i, v_all, i_all, valid rows)``."""
    mesh = evaluator.mesh
    b = u.shape[0]
    u = shard_rows(u, mesh)
    valid_l = shard_rows(torch.from_numpy(valid), mesh, fill=False).numpy()
    scores = score_fn(u)
    if getattr(score_fn, "mesh", None) is None:
        scores = shard_catalog(scores, mesh, dim=1, fill=NEG)
    scores = evaluator._pad_columns(scores)
    cols, mask = csr_row_gather(evaluator.data.exclude_csr, u)
    v, i = sharded_masked_topk(scores, cols, mask, k, mesh)
    i = i.clamp(max=evaluator.dataset.n_items_in_split - 1)
    return (scores, u, v, i, gather_rows(v, mesh, b), gather_rows(i, mesh, b),
            valid_l)


def load_for_serving(run_dir: str, split: str = "test", device=None,
                     mesh=None):
    """A fitted run directory rebuilt for serving (JAX
    ``Recommender.from_run_dir``): ``conf.yml``, the train split and the
    serving ``split`` (``"val"`` or ``"test"``, which sets the catalog and
    the exclusions), then an ``sgd`` model with ``model.pt`` loaded and
    the catalog encoded once, or a matrix algorithm from ``model.npz``.
    ``device`` defaults to the run's ``run_settings.device``
    (`resolve_device`). Returns ``(score_fn, dataset, device_data, k)``,
    ``k`` the largest ``eval.top_k``. With ``mesh`` the scorer is this
    rank's (`train.scoring.make_score_fn` on the mesh)."""
    conf = _run_conf(run_dir)
    spec = get_algorithm(conf.algorithm)
    device = resolve_device(conf) if device is None else torch.device(device)
    split_type = load_split_type(conf.dataset.dataset_path)
    train_ds = _load_split(conf, "train", split_type)
    serve_ds = _load_split(conf, split, split_type)
    evaluator = FullEvaluator(conf.eval, serve_ds, device=device,
                              evaluator_name=split, mesh=mesh)
    return (_saved_scorer(conf, spec, train_ds, evaluator, run_dir, device),
            serve_ds, evaluator.data, max(conf.eval.top_k))
