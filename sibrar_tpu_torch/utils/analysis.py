"""Analysis of a results tree (port of ``sibrar_tpu/utils/analysis.py``).

Every run directory holds ``conf.yml`` and ``metrics_val.yml`` /
``metrics_test.yml`` (``experiment.py``; a sweep's trials too), so the
tree is the record: `collect_runs` flattens it into a pandas frame,
`best_run` picks a run by a metric, `filter_by` selects rows, and
`reload_run` rebuilds a run's scorer. ``pandas`` and ``yaml`` are imported
inside the functions.
"""
from __future__ import annotations

import glob
import os
from typing import Any


def _read_yaml(path: str) -> dict:
    import yaml

    with open(path) as fh:
        return yaml.safe_load(fh) or {}


def collect_runs(results_base: str):
    """One row per run directory (a ``conf.yml``) under ``results_base``:
    ``results_path``, ``run_id``, ``algorithm``, ``dataset_name``,
    ``split_type``, ``learn.*``, the scalar ``model.*`` keys and every
    val / test metric."""
    import pandas as pd

    rows = []
    for conf_path in glob.glob(os.path.join(results_base, "**", "conf.yml"),
                               recursive=True):
        run_dir = os.path.dirname(conf_path)
        row: dict[str, Any] = {"results_path": run_dir}
        conf = _read_yaml(conf_path)
        for k in ("run_id", "algorithm", "dataset_name", "split_type"):
            row[k] = conf.get(k)
        for key, sub in (conf.get("learn") or {}).items():
            row[f"learn.{key}"] = sub
        for key, sub in (conf.get("model") or {}).items():
            if not isinstance(sub, (dict, list)):
                row[f"model.{key}"] = sub
        for split in ("val", "test"):
            mp = os.path.join(run_dir, f"metrics_{split}.yml")
            if os.path.exists(mp):
                row.update(_read_yaml(mp))
        rows.append(row)
    return pd.DataFrame(rows)


def best_run(results_base: str, metric: str, maximize: bool = True):
    """The row of `collect_runs` with the best ``metric``, or None when no
    run has it."""
    df = collect_runs(results_base)
    if df.empty or metric not in df.columns:
        return None
    df = df.dropna(subset=[metric])
    if df.empty:
        return None
    idx = df[metric].idxmax() if maximize else df[metric].idxmin()
    return df.loc[idx]


def reload_run(run_dir: str):
    """``(conf, score_fn)`` of a fitted run: its ``conf.yml`` (results path
    the directory) and `experiment.load_for_serving`'s scorer over the test
    split's catalog, on the run's ``run_settings.device``."""
    from sibrar_tpu_torch.experiment import _run_conf, load_for_serving

    return _run_conf(run_dir), load_for_serving(run_dir, "test")[0]


def filter_by(df, conditions: dict[str, Any]):
    """Rows of ``df`` meeting every condition: a scalar (equality), a
    list, set or tuple (membership) or a callable on the value."""
    import pandas as pd

    mask = pd.Series(True, index=df.index)
    for column, cond in conditions.items():
        if callable(cond):
            mask &= df[column].map(cond)
        elif isinstance(cond, (list, set, tuple)):
            mask &= df[column].isin(list(cond))
        else:
            mask &= df[column] == cond
    return df[mask]
