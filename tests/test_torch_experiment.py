"""The port's experiment layer against the JAX package's, on the CPU.

`get_config` gives JAX's config for every YAML under ``conf/`` (the same
``as_dict``, overrides and conflict errors); the registry has JAX's names
and families; the results directory follows JAX's layout; the device
mapping; `run_test` on the same transplanted SBNet weights (batch-norm
scales spread so lists do not tie) writes JAX's ``metrics_test.yml`` keys
with every value within 1e-5, neither package taking a train step; the
first epoch's profile; and the CLI end to end in a subprocess with jax,
flax, optax, pandas and ``sibrar_tpu`` blocked, on the artifacts and
overrides of ``tests/test_cli_e2e.py``'s onion-scale run."""
import glob
import os
import subprocess
import sys

import flax.serialization
import jax
import numpy as np
import pytest
import torch
import yaml

from sibrar_tpu import experiment as jax_experiment
from sibrar_tpu.config.loader import get_config as jax_get_config
from sibrar_tpu.config.loader import update_nested_dict as jax_update
from sibrar_tpu.config.schema import as_dict as jax_as_dict
from sibrar_tpu.data.synthetic import make_onion_scale_splits as jax_onion
from sibrar_tpu.data.synthetic import \
    write_reference_artifacts as jax_write
from sibrar_tpu.models.base import init_model_abstract
from sibrar_tpu.models.registry import ALGORITHMS as JAX_ALGORITHMS
from sibrar_tpu.models.sbnet import SingleBranchNet as JaxSBNet
from sibrar_tpu.train.trainer import Trainer as JaxTrainer
from sibrar_tpu_torch import experiment
from sibrar_tpu_torch.config.loader import get_config, update_nested_dict
from sibrar_tpu_torch.config.schema import as_dict
from sibrar_tpu_torch.models.registry import ALGORITHMS, get_algorithm
from sibrar_tpu_torch.models.transplant import transplant
from sibrar_tpu_torch.run_experiment import main
from sibrar_tpu_torch.train.trainer import Trainer
from test_torch_evaluator import _draw
from test_torch_sbnet_serve import CONF, FEATURES, ROOT, _chip_smoke, \
    _narrow_conf

CONF_FILES = sorted(glob.glob(os.path.join(ROOT, "conf", "*.yml"))
                    + glob.glob(os.path.join(ROOT, "conf", "single",
                                             "*.yml")))
ITEM_FEATURES = [{"name": "ivec256", "type": "vector"},
                 {"name": "bert", "type": "vector"},
                 {"name": "musicnn", "type": "vector"},
                 {"name": "genres", "type": "tag"}]
# tests/test_cli_e2e.py:test_cli_onion_scale_conf_e2e's item features
ITEM_FEATS_FLAG = ("[{name: ivec256, type: vector}, {name: bert, type: "
                   "vector}, {name: musicnn, type: vector}, {name: genres, "
                   "type: tag}]")


@pytest.mark.parametrize("path", CONF_FILES,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_get_config_matches_jax_on_every_yaml(path):
    """The resolved config of every shipped YAML, as both packages load it;
    ``conf/fast.yml``'s ``eval.score_dtype: bfloat16`` loads and validates
    in the port too."""
    want = jax_as_dict(jax_get_config(path, overrides={"run_id": "r"}))
    got = get_config(path, overrides={"run_id": "r"})
    got.eval.validate()
    assert as_dict(got) == want


def test_get_config_overrides_and_conflicts_match_jax(tmp_path):
    args = dict(algorithm="sbnet", dataset_name="onion18",
                split_type="cold_start_item",
                overrides={"learn.lr": 0.01, "eval.top_k": [5, 10],
                           "dataset.item_features": ITEM_FEATURES,
                           "model.user.embedding_dim": 8, "run_id": "r",
                           "run_settings.device": "cpu"})
    path = os.path.join(ROOT, CONF)
    got = as_dict(get_config(path, **args))
    assert got == jax_as_dict(jax_get_config(path, **args))
    assert got["split_type"] == "cold_start_item"
    assert got["dataset"]["item_features"][3] == {"name": "genres",
                                                  "type": "tag"}
    assert get_config(path, algorithm="sbnet").run_id.startswith("sbnet_")
    leaf = tmp_path / "leaf.json"  # json leaf with a yaml base
    leaf.write_text('{"base_configs": "%s", "algorithm": "mf"}' % path)
    for load in (get_config, jax_get_config):
        assert load(str(leaf)).algorithm == "mf"
        with pytest.raises(ValueError, match="authoritative"):
            load(str(leaf), algorithm="sbnet")
    for update in (update_nested_dict, jax_update):
        d = {"learn": None, "eval": 3}
        update(d, "learn.lr", 0.5)
        assert d == {"learn": {"lr": 0.5}, "eval": 3}
        with pytest.raises(ValueError, match="scalar"):
            update(d, "eval.top_k", [1])


def test_registry_names_and_kinds_match_jax():
    assert sorted(ALGORITHMS) == sorted(JAX_ALGORITHMS)
    for name, spec in JAX_ALGORITHMS.items():
        assert (ALGORITHMS[name].name, ALGORITHMS[name].kind) == (
            spec.name, spec.kind)
    ease = get_algorithm("ease").build({"lam": 2.0}, None, "cpu")
    assert (type(ease).__name__, ease.lam, ease.device) == ("EASE", 2.0,
                                                            "cpu")
    with pytest.raises(ValueError, match="unknown algorithm"):
        get_algorithm("nope")


def test_results_path_layout_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = dict(algorithm="sbnet", dataset_name="onion18",
                split_type="cold_start_both", overrides={"run_id": "r1"})
    path = os.path.join(ROOT, CONF)
    got = experiment._results_path(get_config(path, **args))
    want = jax_experiment._results_path(jax_get_config(path, **args))
    assert got == want == os.path.join("results", "onion18",
                                       "cold_start_both", "sbnet", "r1")
    assert os.path.isdir(got)


def test_device_mapping_and_no_cpu_fallback(monkeypatch):
    """``cpu`` is the CPU; ``tpu`` and ``cuda`` are the card and raise
    without one (never a CPU run); anything else is refused at load."""
    conf = get_config(os.path.join(ROOT, CONF),
                      overrides={"run_settings.device": "cpu"})
    assert experiment.resolve_device(conf) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("tpu", "cuda"):
        conf.run_settings.device = name
        with pytest.raises(RuntimeError, match="is_available"):
            experiment.resolve_device(conf)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert experiment.resolve_device(conf) == torch.device("cuda")
    conf.run_settings.device = "gpu"
    with pytest.raises(ValueError, match="unsupported device"):
        experiment.resolve_device(conf)
    with pytest.raises(ValueError, match="unsupported device"):
        get_config(os.path.join(ROOT, CONF),
                   overrides={"run_settings.device": "gpu"})


@pytest.fixture(scope="module")
def onion_dir(tmp_path_factory):
    """Small onion-scale artifacts (C > 4,096: the dot path's peel)."""
    path = str(tmp_path_factory.mktemp("onion_small"))
    jax_write(path, jax_onion(n_users=200, n_items=5000, n_interactions=4000,
                              n_clusters=8, seed=7, feature_dims=FEATURES))
    return path


def _overrides(data_dir, results, **extra):
    return {"dataset.dataset_path": data_dir, "results_path": str(results),
            "dataset.user_features": [],
            "dataset.item_features": ITEM_FEATURES,
            "eval.group_metrics": [], "run_settings.device": "cpu",
            "model": _narrow_conf(), "loader.eval_batch_size": 64,
            "run_id": "r", **extra}


def test_run_test_matches_jax_on_transplanted_weights(onion_dir, tmp_path,
                                                      monkeypatch):
    """JAX's ``run_test`` from a ``model.msgpack`` (``Trainer.save``'s
    payload) and the port's from a ``model.pt`` of the same weights: the
    same metric keys, every value within 1e-5, and no train step taken."""
    path = os.path.join(ROOT, CONF)
    args = dict(algorithm="sbnet", dataset_name="onion18")
    jconf = jax_get_config(path, overrides=_overrides(
        onion_dir, tmp_path / "jax"), **args)
    tconf = get_config(path, overrides=_overrides(
        onion_dir, tmp_path / "port"), **args)
    jtrain = jax_experiment._load_split(jconf, "train")
    jm = JaxSBNet.build_from_conf(jconf.model, jtrain, jtrain.to_device())
    shaped = init_model_abstract(jm, jax.random.PRNGKey(0),
                                 jtrain.to_device())
    draw = _draw(np.random.default_rng(1))
    variables = {
        "params": jax.tree_util.tree_map_with_path(draw, shaped["params"]),
        "batch_stats": jax.tree_util.tree_map_with_path(
            draw, shaped["batch_stats"])}
    os.makedirs(jconf.results_path)
    with open(os.path.join(jconf.results_path, "model.msgpack"), "wb") as fh:
        fh.write(flax.serialization.to_bytes(variables))
    ttrain = experiment._load_split(tconf, "train", "random")
    tm = get_algorithm("sbnet").build(tconf.model, ttrain,
                                      ttrain.to_device("cpu"), 0)
    transplant(tm, variables)
    os.makedirs(tconf.results_path)
    torch.save(tm.state_dict(), os.path.join(tconf.results_path, "model.pt"))

    def no_training(*args, **kwargs):
        raise AssertionError("run_test took a train step")

    monkeypatch.setattr(JaxTrainer, "train_epoch", no_training)
    monkeypatch.setattr(Trainer, "train_step", no_training)
    jax_experiment.run_test(jconf)
    got = experiment.run_test(tconf)
    with open(os.path.join(jconf.results_path, "metrics_test.yml")) as fh:
        want = yaml.safe_load(fh)
    with open(os.path.join(tconf.results_path, "metrics_test.yml")) as fh:
        assert yaml.safe_load(fh) == got
    assert sorted(got) == sorted(want)
    assert set(got) == _chip_smoke().expected_keys(tconf.eval, "test")
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-5,
                                   err_msg=key)
    assert 0 < got["test/ndcg@100"] < 1


def test_run_train_val_profiles_the_first_epoch(onion_dir, tmp_path):
    """``profile_training``: the first epoch's Chrome trace under
    ``profile/``; ``metrics_val.yml`` holds fit's best validation, and
    ``conf.yml`` the resolved config."""
    conf = get_config(os.path.join(ROOT, CONF), algorithm="sbnet",
                      overrides=_overrides(
                          onion_dir, tmp_path / "run", profile_training=True,
                          **{"learn.n_epochs": 1,
                             "learn.max_batches_per_epoch": 2,
                             "eval.top_k": [10]}))
    metrics = experiment.run_train_val(conf)
    run = conf.results_path
    assert os.path.getsize(os.path.join(run, "profile",
                                        "train_epoch0.json")) > 0
    with open(os.path.join(run, "metrics_val.yml")) as fh:
        assert yaml.safe_load(fh) == metrics
    with open(os.path.join(run, "conf.yml")) as fh:
        assert yaml.safe_load(fh) == as_dict(conf)
    assert os.path.exists(os.path.join(run, "model.pt"))


def test_cli_runs_mf_with_sparse_tables_and_debug_nans(onion_dir, tmp_path,
                                                       monkeypatch):
    """``-a mf -c conf/single/mf_onion18.yml`` trains and tests on the CPU
    with row-sparse tables and ``debug_nans`` on; the trainer gets both."""
    made = []
    init = Trainer.__init__

    def recording(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    monkeypatch.setattr(Trainer, "__init__", recording)
    val, test = main([
        "-a", "mf", "-c", os.path.join(ROOT, "conf/single/mf_onion18.yml"),
        "-d", onion_dir, "-n", "onion18", "-t", "train_val_test",
        "-o", f"results_path={tmp_path}/r", "-o", "run_settings.device=cpu",
        "-o", "run_settings.debug_nans=true", "-o", "learn.optimizer=adam",
        "-o", "learn.sparse_tables=true",
        "-o", "learn.sparse_table_min_rows=100", "-o", "learn.n_epochs=1",
        "-o", "learn.max_batches_per_epoch=2", "-o", "dataset.user_features=[]",
        "-o", "dataset.item_features=[]", "-o", "eval.group_metrics=[]",
        "-o", "loader.eval_batch_size=64", "-o", "eval.top_k=[10]"])
    assert made[0].debug_nans and made[0].step == 2
    assert made[0].sparse == {"user_embeddings": "user",
                              "item_embeddings": "item"}
    assert np.isfinite(val["val/ndcg@10"]) and np.isfinite(
        test["test/ndcg@10"])
    assert sorted(os.listdir(f"{tmp_path}/r")) == [
        "conf.yml", "metrics_test.yml", "metrics_val.yml", "model.pt"]


def test_cli_refuses_what_is_not_ported(onion_dir, tmp_path):
    """A matrix name now runs (EASE writes its run files); a ``parallel``
    block asking for two devices runs on one in a single process, as in
    JAX (no mesh), with the same metrics; a missing card is still refused
    before anything is written."""
    val, test = main([
        "-a", "ease", "-c", CONF, "-d", onion_dir, "-t", "train_val_test",
        "-o", f"results_path={tmp_path}/ease", "-o", "model.lam=500.0",
        "-o", "run_settings.device=cpu", "-o", "dataset.user_features=[]",
        "-o", "dataset.item_features=[]", "-o", "eval.group_metrics=[]",
        "-o", "eval.top_k=[10]"])
    assert np.isfinite(val["val/ndcg@10"]) and np.isfinite(
        test["test/ndcg@10"])
    assert sorted(os.listdir(f"{tmp_path}/ease")) == [
        "conf.yml", "metrics_test.yml", "metrics_val.yml", "model.npz"]
    par = main([
        "-a", "ease", "-c", CONF, "-d", onion_dir, "-t", "train_val",
        "-o", f"results_path={tmp_path}/par", "-o", "model.lam=500.0",
        "-o", "run_settings.device=cpu", "-o", "dataset.user_features=[]",
        "-o", "dataset.item_features=[]", "-o", "eval.group_metrics=[]",
        "-o", "eval.top_k=[10]", "-o", "parallel.enabled=true",
        "-o", "parallel.n_devices=2"])
    assert par == val
    base = ["-c", CONF, "-d", onion_dir, "-o", f"results_path={tmp_path}/r"]
    if not torch.cuda.is_available():  # base.yml's device: tpu
        with pytest.raises(RuntimeError, match="is_available"):
            main(["-a", "sbnet", *base])
    assert not os.path.exists(f"{tmp_path}/r")  # refused before writing


BLOCKED_CLI = r"""
import runpy, sys
for name in ("jax", "flax", "optax", "pandas", "sibrar_tpu"):
    sys.modules[name] = None  # any import of these now fails
sys.argv = ["run_experiment"] + ARGS
runpy.run_module("sibrar_tpu_torch.run_experiment", run_name="__main__")
loaded = [m for m in ("jax", "flax", "optax", "pandas", "sibrar_tpu")
          if sys.modules.get(m) is not None]
assert not loaded, loaded
print("cli ok")
"""


def test_cli_train_val_test_runs_without_jax_flax_optax_pandas(tmp_path):
    """``python -m sibrar_tpu_torch.run_experiment`` on the shipped YAML
    (full widths) and the onion-scale artifacts of
    ``test_cli_onion_scale_conf_e2e``, with its overrides and the CPU: the
    four run files, JAX's metric keys, finite values."""
    data = str(tmp_path / "onion_ci")
    jax_write(data, jax_onion(n_users=300, n_items=400, n_interactions=8000,
                              n_clusters=8, seed=7, feature_dims=FEATURES))
    results = tmp_path / "run"
    args = ["-a", "sbnet", "-c", CONF, "-d", data, "-n", "onion18",
            "-t", "train_val_test", "-o", f"results_path={results}",
            "-o", "learn.n_epochs=1", "-o", "learn.max_patience=2",
            "-o", "dataset.user_features=[]",
            "-o", f"dataset.item_features={ITEM_FEATS_FLAG}",
            "-o", "eval.group_metrics=[]", "-o", "eval.top_k=[10]",
            "-o", "loader.batch_size=64", "-o", "loader.eval_batch_size=64",
            "-o", "run_settings.device=cpu"]
    # one intra-op thread: beside the suite's other workers, torch's
    # spinning OpenMP threads otherwise slow each step by tens of times
    proc = subprocess.run(
        [sys.executable, "-c", f"ARGS = {args!r}\n" + BLOCKED_CLI],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "cli ok" in proc.stdout
    assert sorted(os.listdir(results)) == [
        "conf.yml", "metrics_test.yml", "metrics_val.yml", "model.pt"]
    conf = get_config(str(results / "conf.yml"))
    assert conf.eval.top_k == [10] and conf.run_settings.device == "cpu"
    for name in ("val", "test"):
        with open(results / f"metrics_{name}.yml") as fh:
            metrics = yaml.safe_load(fh)
        assert set(metrics) == _chip_smoke().expected_keys(conf.eval, name)
        assert all(np.isfinite(v) for v in metrics.values())
