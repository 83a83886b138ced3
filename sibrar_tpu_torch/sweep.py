"""Hyperparameter sweeps (port of ``sibrar_tpu/sweep.py``).

A sweep YAML names a ``method`` (``random``, ``grid`` or ``bayes``, the
local TPE of ``tpe.py``), the ``metric`` and ``goal`` that rank trials,
``n_trials``, ``keep_top_runs``, a ``seed``, the ``parameters`` (dotted
config keys to specs: ``{values: [...]}`` or ``{min, max[,
distribution]}``; a ``_paired*`` key carries a dict of dotted overrides
set together) and a ``base_config`` with its own ``base_configs`` chain.
`run_sweep` runs the trials one after another in this process, each a
`experiment.run_train_val_test` into ``results_base/<run_id>``, and keeps
the model files (``model.*``: the port's ``model.pt`` and ``model.npz``)
of the best ``keep_top_runs`` runs only.

Workers that share one ``results_base`` split the trials with
``trial_offset`` / ``max_trials`` (``python -m
sibrar_tpu_torch.run_agent``): each writes its own state file
(``sweep_state.yml``, ``sweep_state_t{offset}.yml``), and bayes workers
draw from offset-decorrelated seeds. With ``shared_history: true`` bayes
workers share one file-locked observation log (``observations.jsonl``):
every suggestion conditions on every worker's finished trials, and
retention ranks all of them together. A trial that raises stops the
sweep.

``wandb_train_val_agent`` is the server-driven mode: one trial under
``wandb agent``, its parameters from ``wandb.config``.
"""
from __future__ import annotations

import copy
import gc
import glob
import os
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from sibrar_tpu_torch import config_from_dict
from sibrar_tpu_torch.config.loader import (
    extend_by_base_configs,
    load_config_dict,
    nested_dict_get,
    update_nested_dict,
    yaml_save,
)
from sibrar_tpu_torch.config.schema import ExperimentConfig
from sibrar_tpu_torch.parallel import distributed as pdist
from sibrar_tpu_torch.tpe import TPESampler, _sample_value
from sibrar_tpu_torch.utils.misc import generate_id


@dataclass
class SweepConfig:
    method: str = "random"  # 'random' | 'grid' | 'bayes' (local TPE)
    metric: str = "val/ndcg@10"
    goal: str = "maximize"
    n_trials: int = 20
    keep_top_runs: int = 10
    seed: int = 0
    # bayes workers on one results_base share a file-locked observation
    # log: each suggestion sees every worker's finished trials, and
    # retention ranks them all together
    shared_history: bool = False
    parameters: dict[str, Any] = field(default_factory=dict)
    base_config: dict[str, Any] = field(default_factory=dict)


class SharedObservationLog:
    """The bayes workers' shared log, ``results_base/observations.jsonl``:
    one JSON line per finished trial (``trial``, ``params``, ``value``,
    ``metric``, ``results_path``). Appends and reads hold an exclusive
    ``fcntl.flock`` on a sidecar lock file, so concurrent workers never
    interleave writes. POSIX only."""

    def __init__(self, results_base: str):
        os.makedirs(results_base, exist_ok=True)
        self.path = os.path.join(results_base, "observations.jsonl")
        self._lock_path = self.path + ".lock"

    def _locked(self):
        import fcntl
        from contextlib import contextmanager

        @contextmanager
        def cm():
            with open(self._lock_path, "w") as lk:
                fcntl.flock(lk, fcntl.LOCK_EX)
                try:
                    yield
                finally:
                    fcntl.flock(lk, fcntl.LOCK_UN)

        return cm()

    def append(self, record: dict) -> None:
        import json

        with self._locked():
            with open(self.path, "a") as fh:
                fh.write(json.dumps(record) + "\n")

    def read(self) -> list[dict]:
        import json

        with self._locked():
            if not os.path.exists(self.path):
                return []
            with open(self.path) as fh:
                return [json.loads(ln) for ln in fh if ln.strip()]


def _apply_param(conf_dict: dict[str, Any], key: str, value: Any) -> None:
    """Set one sampled parameter; a ``_paired*`` key's dict of dotted
    overrides is set together (e.g. ``split_type`` with the artifact
    directory of that split)."""
    if key.startswith("_paired") and isinstance(value, dict):
        for k2, v2 in value.items():
            update_nested_dict(conf_dict, k2, v2)
    else:
        update_nested_dict(conf_dict, key, value)


def _grid_points(parameters: dict[str, Any]) -> list[dict[str, Any]]:
    import itertools

    keys, value_lists = [], []
    for k, spec in parameters.items():
        if not isinstance(spec, dict) or "values" not in spec:
            raise ValueError(f"grid sweeps need explicit 'values' for {k!r}")
        keys.append(k)
        value_lists.append(spec["values"])
    return [dict(zip(keys, combo)) for combo in itertools.product(*value_lists)]


def sample_trials(sweep: SweepConfig) -> list[dict[str, Any]]:
    """Every trial of a ``grid`` (the product of the values, in order) or
    ``random`` sweep (``n_trials`` draws from ``seed``); ``bayes`` is
    sequential and has no list up front."""
    if sweep.method == "grid":
        return _grid_points(sweep.parameters)
    if sweep.method != "random":
        raise ValueError(f"cannot pre-sample trials for method "
                         f"{sweep.method!r}")
    rng = np.random.default_rng(sweep.seed)
    return [
        {k: _sample_value(rng, spec) for k, spec in sweep.parameters.items()}
        for _ in range(sweep.n_trials)
    ]


def _remove_model_files(results_path: str) -> None:
    if not pdist.is_main():  # rank 0 owns a run's files under torchrun
        return
    for f in glob.glob(os.path.join(results_path, "model.*")):
        os.remove(f)


def run_sweep(sweep: SweepConfig, results_base: str,
              trial_offset: int = 0, max_trials: Optional[int] = None,
              run_fn=None) -> list[dict]:
    """Run trials ``trial_offset`` onwards (at most ``max_trials``) with
    ``run_fn(conf) -> (val_metrics, test_metrics)``, by default
    `experiment.run_train_val_test`; returns ``[{trial, params, metrics,
    results_path}, ...]``, best first (a trial without the metric last,
    under either goal). See the module's docstring for the state files,
    the shared log and retention."""
    if run_fn is None:
        from sibrar_tpu_torch.experiment import run_train_val_test as run_fn
    sign = 1.0 if sweep.goal == "maximize" else -1.0
    sampler = None
    if sweep.method == "bayes":
        # sharded workers run independent TPEs from decorrelated seeds
        # unless shared_history rebuilds each one from the shared log
        sampler = TPESampler(sweep.parameters,
                             seed=sweep.seed + 7919 * trial_offset)
        n = sweep.n_trials - trial_offset
        if max_trials is not None:
            n = min(n, max_trials)
        trials = range(max(n, 0))
    else:
        if sweep.method not in ("random", "grid"):
            raise ValueError(f"unknown sweep method {sweep.method!r} "
                             "(expected 'random' | 'grid' | 'bayes')")
        trials = sample_trials(sweep)[trial_offset:]
        if max_trials is not None:
            trials = trials[:max_trials]

    shared_log = (SharedObservationLog(results_base)
                  if sampler is not None and sweep.shared_history else None)
    records = []
    for t, params in enumerate(trials):
        if sampler is not None:
            if shared_log is not None:
                # a fresh TPE on every worker's observations so far, seeded
                # per (worker, trial) so simultaneous workers differ
                sampler = TPESampler(
                    sweep.parameters,
                    seed=sweep.seed + 7919 * trial_offset + 104729 * t)
                for rec in shared_log.read():
                    sampler.observe(rec["params"], rec["value"])
            params = sampler.suggest()
        conf_dict = copy.deepcopy(sweep.base_config)
        conf_dict = extend_by_base_configs(conf_dict)
        for key, value in params.items():
            _apply_param(conf_dict, key, value)
        run_id = pdist.broadcast_object(
            generate_id(postfix=f"t{trial_offset + t}"))
        conf_dict["run_id"] = run_id
        conf_dict["results_path"] = os.path.join(results_base, run_id)
        conf = config_from_dict(ExperimentConfig, conf_dict)
        val_metrics, test_metrics = run_fn(conf)
        # a module imported for the first time inside a trial can leave a
        # cycle that holds a frame (matplotlib's pyparsing, under the
        # ProtoMF diagnostics), and a frame holds its callers' locals: the
        # trial's model, optimizer state and device data. Free them before
        # the next trial allocates its own
        gc.collect()
        records.append({
            "trial": trial_offset + t,
            "params": params,
            "metrics": {**val_metrics, **test_metrics},
            "results_path": conf.results_path,
        })
        if sampler is not None:
            m = records[-1]["metrics"].get(sweep.metric)
            val = None if m is None else sign * float(m)
            sampler.observe(params, val)
            if shared_log is not None and pdist.is_main():
                shared_log.append({
                    "trial": trial_offset + t, "params": params,
                    "value": val,
                    "metric": None if m is None else float(m),
                    "results_path": conf.results_path})
            pdist.barrier()  # every rank reads the same log next trial
        # one state file per worker: workers share results_base
        state_name = (f"sweep_state_t{trial_offset}.yml" if trial_offset
                      else "sweep_state.yml")
        if pdist.is_main():
            yaml_save(os.path.join(results_base, state_name),
                      {"records": [dict(r) for r in records]})

    # the sentinel ranks a trial without the metric last under either goal
    records.sort(key=lambda r: sign * r["metrics"].get(sweep.metric,
                                                       sign * -np.inf),
                 reverse=True)
    if shared_log is not None:
        # global retention: a run enters the log only once its run_fn has
        # returned, so pruning any logged run is safe while others train;
        # the last worker to finish leaves exactly the global top N
        all_recs = shared_log.read()
        all_recs.sort(
            key=lambda r: r["value"] if r.get("value") is not None
            else -np.inf, reverse=True)
        for r in all_recs[sweep.keep_top_runs:]:
            _remove_model_files(r["results_path"])
        return records
    for r in records[sweep.keep_top_runs:]:
        _remove_model_files(r["results_path"])
    return records


def wandb_train_val_agent(keep_top_runs: int = 10):
    """One trial as a ``wandb agent`` worker: the trial's parameters from
    ``wandb.config`` (dotted keys expand into the nested config;
    ``algorithm_type`` / ``algorithm``, ``dataset_path`` and
    ``split_type`` are popped and set), the base configs merged, then
    `experiment.run_train_val_test`, and the run's model files removed
    when the W&B API does not rank it in the sweep's top
    ``keep_top_runs``. Without wandb installed this raises; a failing API
    (offline) skips retention with a log line."""
    try:
        import wandb
    except ImportError as e:
        raise RuntimeError(
            "wandb is not installed; use the local sweep mode (python -m "
            "sibrar_tpu_torch.sweep_agent -c <sweep.yml> -o <results>)") from e

    run = wandb.init(job_type="train/val/test", allow_val_change=True)
    flat = {k: v for k, v in dict(wandb.config).items()
            if not k.startswith("_")}
    algorithm = flat.pop("algorithm_type", None) or flat.pop("algorithm", None)
    dataset_path = flat.pop("dataset_path", None)
    split_type = flat.pop("split_type", None)
    conf_dict: dict[str, Any] = {}
    for k, v in flat.items():
        update_nested_dict(conf_dict, k, v)
    conf_dict = extend_by_base_configs(conf_dict)
    if algorithm:
        conf_dict["algorithm"] = algorithm
    if split_type:
        conf_dict["split_type"] = split_type
    if dataset_path:
        update_nested_dict(conf_dict, "dataset.dataset_path", dataset_path)
    update_nested_dict(conf_dict, "wandb.sweep_id",
                       getattr(run, "sweep_id", None))
    update_nested_dict(conf_dict, "wandb.use_wandb", True)
    conf_dict.setdefault("run_id", getattr(run, "id", None) or generate_id())
    from sibrar_tpu_torch.config.schema import as_dict

    conf = config_from_dict(ExperimentConfig, conf_dict)
    try:  # the server's copy of the fully resolved config
        wandb.config.update(as_dict(conf), allow_val_change=True)
    except Exception:
        pass

    from sibrar_tpu_torch.experiment import run_train_val_test

    val_metrics, test_metrics = run_train_val_test(conf)

    try:
        api = wandb.Api()
        sweep = api.sweep(f"{run.entity}/{run.project}/{run.sweep_id}")
        top = api.runs(path=f"{run.entity}/{run.project}",
                       per_page=keep_top_runs, order=sweep.order,
                       filters={"$and": [{"sweep": f"{run.sweep_id}"}]}
                       )[:keep_top_runs]
        if run.id not in {r.id for r in top}:
            _remove_model_files(conf.results_path)
    except Exception as e:
        import logging

        logging.getLogger(__name__).info("W&B top-N retention skipped: %s", e)
    wandb.finish()
    return val_metrics, test_metrics


def load_sweep_config(path: str) -> SweepConfig:
    """A sweep YAML with its ``base_configs`` chains folded in, the
    ``base_config``'s resolved against the file's directory."""
    raw = load_config_dict(path)
    if isinstance(raw.get("base_config"), dict):
        raw["base_config"] = extend_by_base_configs(raw["base_config"], path)
    return config_from_dict(SweepConfig, raw)


__all__ = ["SweepConfig", "SharedObservationLog", "sample_trials",
           "run_sweep", "load_sweep_config",
           "wandb_train_val_agent", "nested_dict_get"]
