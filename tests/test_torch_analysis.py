"""The port's ``config/paths.py`` and ``utils/analysis.py`` against the JAX
package's on the CPU: one paths file resolved to the same roots and
dataset paths; `collect_runs`, `best_run` and `filter_by` giving JAX's
frames on a results tree the port's sweep agent wrote and on one JAX's
wrote from the same artifacts (the same columns and config values; the
trained metrics differ by package); `reload_run`'s scorer on a port run."""
import os
import socket

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

import sibrar_tpu.config.paths as jax_paths
from sibrar_tpu.utils import analysis as jax_analysis
from sibrar_tpu_torch import experiment, sweep_agent
from sibrar_tpu_torch.config import paths
from sibrar_tpu_torch.data.synthetic import (
    make_synthetic_splits,
    write_reference_artifacts,
)
from sibrar_tpu_torch.utils import analysis

METRIC = "val/ndcg@10"


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------- config/paths.py
def write_paths(tmp_path, machines: dict) -> str:
    pf = tmp_path / "paths.yml"
    pf.write_text(yaml.safe_dump({"machines": machines}))
    return str(pf)


@pytest.mark.parametrize("host_entry", [True, False],
                         ids=["this_host", "default"])
def test_paths_resolve_as_jax(tmp_path, monkeypatch, host_entry):
    """This host's entry (or ``default``) of one paths file, then the
    environment over it, in both packages (tests/test_config.py's
    cases)."""
    machines = {"default": {"data": "/d", "results": "/r"}}
    if host_entry:
        machines[socket.gethostname()] = {"data": "/mnt/data",
                                          "results": "/mnt/res"}
    pf = write_paths(tmp_path, machines)
    data, res = ("/mnt/data", "/mnt/res") if host_entry else ("/d", "/r")
    for module in (paths, jax_paths):
        monkeypatch.setattr(module, "_PATHS_FILE", pf)
    monkeypatch.delenv("SIBRAR_DATA_ROOT", raising=False)
    monkeypatch.delenv("SIBRAR_RESULTS_ROOT", raising=False)
    for module in (paths, jax_paths):
        assert module.get_data_root() == data
        assert module.get_results_root() == res
        for split, sub in (("cold_start_item", "cold_start_item"),
                           ("random", "random_split"),
                           ("temporal", "temporal_split")):
            assert module.get_dataset_path("ml1m", split) == os.path.join(
                data, "ml1m", sub)
        assert module.get_dataset_path("x", "cold_start_both", "/o") == \
            "/o/x/cold_start_both"
    monkeypatch.setenv("SIBRAR_DATA_ROOT", "/env")
    monkeypatch.setenv("SIBRAR_RESULTS_ROOT", "/envr")
    for module in (paths, jax_paths):
        assert module.get_dataset_path("ml1m", "random").startswith("/env/")
        assert module.get_results_root() == "/envr"


def test_paths_without_a_file_take_the_defaults(tmp_path, monkeypatch):
    for module in (paths, jax_paths):
        monkeypatch.setattr(module, "_PATHS_FILE", str(tmp_path / "none"))
    monkeypatch.delenv("SIBRAR_DATA_ROOT", raising=False)
    monkeypatch.delenv("SIBRAR_RESULTS_ROOT", raising=False)
    for module in (paths, jax_paths):
        assert (module.get_data_root(), module.get_results_root(),
                module.get_data_root("/x")) == ("./data", "./results", "/x")
    with pytest.raises(ValueError):
        paths.get_dataset_path("ml1m", "sideways")


def test_paths_file_is_jaxs():
    assert paths._PATHS_FILE == jax_paths._PATHS_FILE


# -------------------------------------------------------- utils/analysis.py
SWEEP = {
    "method": "grid", "metric": METRIC, "keep_top_runs": 1,
    "parameters": {"model.embedding_dim": {"values": [4, 8]},
                   "learn.lr": {"values": [0.01, 0.002]}},
    "base_config": {
        "algorithm": "mf",
        "dataset": {"n_negative_samples": 2},
        "learn": {"n_epochs": 1, "rec_loss": "bpr",
                  "optimizing_metric": "ndcg@10"},
        "eval": {"top_k": [5, 10], "metrics": ["ndcg", "recall"],
                 "group_metrics": []},
        "loader": {"batch_size": 32, "eval_batch_size": 64},
        "run_settings": {"device": "cpu"}},
}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One set of artifacts; the port's sweep agent and JAX's each run the
    same four-trial grid over it into a results tree."""
    tmp = tmp_path_factory.mktemp("analysis")
    art = str(tmp / "data")
    write_reference_artifacts(art, make_synthetic_splits(
        n_users=40, n_items=50, n_interactions=800, seed=2))
    conf = {**SWEEP, "base_config": {**SWEEP["base_config"], "dataset": {
        **SWEEP["base_config"]["dataset"], "dataset_path": art}}}
    path = tmp / "sweep.yml"
    path.write_text(yaml.safe_dump(conf))
    import sweep_agent as jax_sweep_agent

    out = {}
    for name, main in (("port", sweep_agent.main),
                       ("jax", jax_sweep_agent.main)):
        out[name] = str(tmp / name)
        main(["-c", str(path), "-o", out[name]])
    return out


CONF_COLUMNS = ["algorithm", "dataset_name", "split_type",
                "model.embedding_dim", "learn.lr", "learn.n_epochs",
                "learn.rec_loss"]


@pytest.mark.parametrize("tree", ["port", "jax"])
def test_collect_runs_best_run_filter_by_match_jax(trees, tree):
    base = trees[tree]
    got, want = analysis.collect_runs(base), jax_analysis.collect_runs(base)
    pd.testing.assert_frame_equal(got, want)
    assert len(got) == 4 and set(CONF_COLUMNS) <= set(got.columns)
    assert np.isfinite(got[METRIC]).all()
    for maximize in (True, False):
        pd.testing.assert_series_equal(
            analysis.best_run(base, METRIC, maximize),
            jax_analysis.best_run(base, METRIC, maximize))
    best = analysis.best_run(base, METRIC)
    assert best[METRIC] == got[METRIC].max()
    assert os.path.exists(os.path.join(best["results_path"], "model.pt"
                                       if tree == "port" else
                                       "model.msgpack"))
    for conditions in ({"model.embedding_dim": 8},
                       {"learn.lr": [0.002], "algorithm": "mf"},
                       {METRIC: lambda v: v > got[METRIC].median()}):
        pd.testing.assert_frame_equal(
            analysis.filter_by(got, conditions),
            jax_analysis.filter_by(want, conditions))
    for module in (analysis, jax_analysis):
        assert module.best_run(base, "val/nope") is None


def test_the_two_trees_have_jaxs_columns_and_config_values(trees):
    """The port's runs write JAX's ``conf.yml`` and metric keys: the same
    columns and, trial by trial, the same config values."""
    port = analysis.collect_runs(trees["port"])
    jax = analysis.collect_runs(trees["jax"])
    assert sorted(port.columns) == sorted(jax.columns)
    key = ["model.embedding_dim", "learn.lr"]
    port, jax = (df.sort_values(key).reset_index(drop=True)
                 for df in (port, jax))
    same = [c for c in port.columns
            if c not in ("results_path", "run_id")
            and not c.startswith(("val/", "test/"))]
    pd.testing.assert_frame_equal(port[same], jax[same])


def test_collect_runs_of_an_empty_tree(tmp_path):
    assert analysis.collect_runs(str(tmp_path)).empty
    assert jax_analysis.collect_runs(str(tmp_path)).empty
    assert analysis.best_run(str(tmp_path), METRIC) is None


def test_filter_by_dsl():
    df = pd.DataFrame({"a": [1, 2, 3], "b": ["x", "y", "x"]})
    assert len(analysis.filter_by(df, {"b": "x"})) == 2
    assert len(analysis.filter_by(df, {"a": [1, 3]})) == 2
    assert len(analysis.filter_by(df, {"a": {2}})) == 1
    assert len(analysis.filter_by(df, {"a": lambda v: v > 1, "b": "x"})) == 1


def test_reload_run_scores_as_load_for_serving(trees):
    """`reload_run` of the port's best run: its ``conf.yml`` (results path
    the directory) and a scorer equal to `load_for_serving`'s."""
    run = analysis.best_run(trees["port"], METRIC)["results_path"]
    conf, score_fn = analysis.reload_run(run)
    assert conf.results_path == run and conf.algorithm == "mf"
    with open(os.path.join(run, "conf.yml")) as fh:
        written = yaml.safe_load(fh)
    assert conf.model == written["model"] and conf.run_id == written[
        "run_id"]
    want, dataset, _, k = experiment.load_for_serving(run, "test")
    users = torch.arange(0, dataset.n_users, 3)
    got = score_fn(users)
    assert got.shape == (len(users), dataset.n_items_in_split) and k == 10
    assert torch.equal(got, want(users))
