"""``run_gather``, ``run_combine_experiment`` and the paired t-tests of the
port against the JAX package, on the CPU: a UProtoMFs and an IProtoMFs run
directory per package, with the same (numpy-drawn) weights (JAX's
``model.msgpack``, the port's ``model.pt``, as ``test_torch_experiment.py``
sets up ``run_test``), on one artifact directory. The gather payload
(keys, dtypes, values; top-k ids equal up to ties), the combined run's
metrics within 1e-5 and ``paired_t_tests`` / ``compare_gathers`` against
JAX's; then both through the CLI (``-t gather``, ``-a
uiprotomfs_combine``)."""
import os
import pickle

import flax.serialization
import jax
import numpy as np
import pytest
import torch
import yaml

from sibrar_tpu import experiment as jax_experiment
from sibrar_tpu.config.loader import get_config as jax_get_config
from sibrar_tpu.config.loader import yaml_save as jax_yaml_save
from sibrar_tpu.config.schema import as_dict as jax_as_dict
from sibrar_tpu.eval import stat_tests as jstat
from sibrar_tpu.models.base import init_model_abstract
from sibrar_tpu.models.registry import get_algorithm as jax_get_algorithm
from sibrar_tpu_torch import experiment
from sibrar_tpu_torch.config.loader import get_config, yaml_save
from sibrar_tpu_torch.config.schema import as_dict
from sibrar_tpu_torch.data.synthetic import (
    make_synthetic_splits,
    write_reference_artifacts,
)
from sibrar_tpu_torch.eval import stat_tests as tstat
from sibrar_tpu_torch.models.registry import get_algorithm
from sibrar_tpu_torch.models.transplant import transplant
from sibrar_tpu_torch.run_experiment import main
from test_torch_dmf import _draw, one_torch_thread  # noqa: F401

CONF = {
    "learn": {"n_epochs": 1, "rec_loss": "bpr",
              "optimizing_metric": "ndcg@10"},
    "eval": {"top_k": [1, 5, 10], "metrics": ["ndcg", "recall", "coverage"]},
    "loader": {"batch_size": 32, "eval_batch_size": 16},
    "dataset": {"n_negative_samples": 2, "user_features": [],
                "item_features": []},
    "run_settings": {"device": "cpu"},
}
MODELS = {"uprotomfs": {"embedding_dim": 8, "n_prototypes": 5},
          "iprotomfs": {"embedding_dim": 8, "n_prototypes": 6}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{package: {algorithm: conf}}``: two fitted-looking run
    directories per package (``conf.yml`` and the weights) over one
    artifact directory of 60 users x 80 items."""
    root = tmp_path_factory.mktemp("gather")
    data = str(root / "data")
    write_reference_artifacts(data, make_synthetic_splits(
        n_users=60, n_items=80, n_interactions=1500, seed=11))
    conf_path = str(root / "conf.yml")
    with open(conf_path, "w") as fh:
        yaml.safe_dump(CONF, fh)
    out = {"jax": {}, "port": {}}
    for i, (name, model) in enumerate(MODELS.items()):
        overrides = {"dataset.dataset_path": data, "model": model}
        jconf = jax_get_config(conf_path, algorithm=name, overrides={
            **overrides, "results_path": str(root / "jax" / name)})
        tconf = get_config(conf_path, algorithm=name, overrides={
            **overrides, "results_path": str(root / "port" / name)})
        jtrain = jax_experiment._load_split(jconf, "train")
        jm = jax_get_algorithm(name).build(jconf.model, jtrain,
                                           jtrain.to_device())
        shaped = init_model_abstract(jm, jax.random.PRNGKey(0),
                                     jtrain.to_device())
        params = jax.tree_util.tree_map_with_path(
            _draw(np.random.default_rng(i)), shaped["params"])
        # the relu'd weight side drawn positive, as its init is (around
        # 0.5): all-zero weight rows would tie every score they make at
        # 0, and the metrics would then depend on the order of ties
        side = "item_embed" if name == "uprotomfs" else "user_embed"
        params[side] = {"embedding": np.abs(
            params[side]["embedding"]) + 0.05}
        os.makedirs(jconf.results_path)
        jax_yaml_save(os.path.join(jconf.results_path, "conf.yml"),
                      jax_as_dict(jconf))
        with open(os.path.join(jconf.results_path, "model.msgpack"),
                  "wb") as fh:
            fh.write(flax.serialization.to_bytes(
                {"params": params,
                 "batch_stats": shaped.get("batch_stats", {})}))
        ttrain = experiment._load_split(tconf, "train", "random")
        tm = get_algorithm(name).build(tconf.model, ttrain,
                                       ttrain.to_device("cpu"), 0)
        transplant(tm, {"params": params})
        os.makedirs(tconf.results_path)
        yaml_save(os.path.join(tconf.results_path, "conf.yml"),
                  as_dict(tconf))
        torch.save(tm.state_dict(),
                   os.path.join(tconf.results_path, "model.pt"))
        out["jax"][name], out["port"][name] = jconf, tconf
    return out


def check_payload(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key in ("user_indices", "targets", "items_in_split"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("n_users", "n_items", "k"):
        assert got[key] == want[key] and type(got[key]) is type(want[key])
    for key in ("topk_item_indices", "topk_logits"):
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
    np.testing.assert_allclose(got["topk_logits"], want["topk_logits"],
                               rtol=1e-5, atol=1e-6)
    # ids equal, up to exact ties of the JAX scores
    differ = got["topk_item_indices"] != want["topk_item_indices"]
    logits = want["topk_logits"]
    for r, c in zip(*np.nonzero(differ)):
        assert (logits[r] == logits[r, c]).sum() > 1
    assert sorted(got["raw_metrics"]) == sorted(want["raw_metrics"])
    for key, value in want["raw_metrics"].items():
        assert got["raw_metrics"][key].dtype == value.dtype, key
        np.testing.assert_allclose(got["raw_metrics"][key], value,
                                   rtol=0, atol=1e-5, err_msg=key)
    assert sorted(got["metrics"]) == sorted(want["metrics"])
    for key, value in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][key], value, rtol=0,
                                   atol=1e-5, err_msg=key)


@pytest.mark.parametrize("split,k", [("test", None), ("val", 3),
                                     ("test", 30)])
def test_run_gather_payload_matches_jax(runs, split, k):
    """The default k (the largest cutoff), a shallow k below it (the
    metrics' own pass) and a deep one; a padded last batch each time
    (users in the split not a multiple of 16)."""
    name = "uprotomfs"
    want = jax_experiment.run_gather(runs["jax"][name], split, k)
    got = experiment.run_gather(runs["port"][name], split, k)
    check_payload(got, want)
    assert len(got["user_indices"]) % CONF["loader"]["eval_batch_size"]
    assert got["k"] == (k or 10)
    path = os.path.join(runs["port"][name].results_path,
                        f"gather_{split}.pkl")
    with open(path, "rb") as fh:
        check_payload(pickle.load(fh), want)
    # nothing seen is exported
    ds = experiment._load_split(runs["port"][name], split, "random")
    excl = ds.exclude_matrix().tocsr()[got["user_indices"]]
    items = got["items_in_split"][got["topk_item_indices"]]
    rows = np.repeat(np.arange(len(items)), items.shape[1])
    assert not np.asarray(excl[rows, items.reshape(-1)]).any()


def test_run_gather_metrics_equal_run_test(runs):
    conf = runs["port"]["iprotomfs"]
    payload = experiment.run_gather(conf)
    tested = experiment.run_test(conf)
    assert payload["metrics"] == tested


def test_run_combine_experiment_matches_jax(runs):
    want = jax_experiment.run_combine_experiment(
        runs["jax"]["uprotomfs"].results_path,
        runs["jax"]["iprotomfs"].results_path, "test")
    got = experiment.run_combine_experiment(
        runs["port"]["uprotomfs"].results_path,
        runs["port"]["iprotomfs"].results_path, "test")
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-5,
                                   err_msg=key)
    alone = experiment.run_test(runs["port"]["uprotomfs"])
    assert got != alone


def test_paired_t_tests_match_jax(runs, tmp_path):
    rng = np.random.default_rng(4)
    base = rng.random(50)
    arrays = {"a": base, "b": base + 0.05 * rng.random(50),
              "c": base - 0.2 + 0.01 * rng.random(50)}
    arrays["b"][3] = np.nan
    for threshold in (0.05, 0.01):
        assert (tstat.paired_t_tests(arrays, threshold)
                == [tstat.PairedComparison(**vars(c)) for c in
                    jstat.paired_t_tests(arrays, threshold)])
    with pytest.raises(ValueError, match="two models"):
        tstat.paired_t_tests({"a": base})
    paths = {}
    for name in MODELS:
        conf = runs["port"][name]
        experiment.run_gather(conf, out_name="g.pkl")
        paths[name] = os.path.join(conf.results_path, "g.pkl")
    got = tstat.compare_gathers(paths, "test/ndcg@10")
    want = jstat.compare_gathers(paths, "test/ndcg@10")
    assert [vars(c) for c in got] == [vars(c) for c in want]
    assert len(got) == 1 and 0 <= got[0].p_value <= 1
    csv_path = str(tmp_path / "per_user.csv")
    with open(csv_path, "w") as fh:
        fh.write("a,b,c\n" + "\n".join(
            ",".join(str(arrays[m][i]) for m in "abc") for i in range(50)))
    assert ([vars(c) for c in tstat.compare_csv(csv_path)]
            == [vars(c) for c in jstat.compare_csv(csv_path)])


def test_cli_gather_and_combine(runs):
    """``-t gather --gather_k 7 --split_set val`` writes the payload of
    `run_gather`; ``-a uiprotomfs_combine`` returns the combined metrics
    and refuses to run without both run directories."""
    conf = runs["port"]["uprotomfs"]
    with open(os.path.join(conf.results_path, "conf.yml")) as fh:
        saved = yaml.safe_load(fh)
    conf_path = os.path.join(conf.results_path, "cli.yml")
    with open(conf_path, "w") as fh:
        yaml.safe_dump({k: saved[k] for k in ("learn", "eval", "loader",
                                              "dataset", "run_settings",
                                              "model")}, fh)
    payload = main(["-a", "uprotomfs", "-c", conf_path,
                    "-d", conf.dataset.dataset_path, "-t", "gather",
                    "--gather_k", "7", "--split_set", "val",
                    "-o", f"results_path={conf.results_path}"])
    assert payload["k"] == 7 and payload["topk_item_indices"].shape[1] == 7
    assert os.path.exists(os.path.join(conf.results_path, "gather_val.pkl"))
    check_payload(payload, experiment.run_gather(conf, "val", 7))
    combined = main(["-a", "uiprotomfs_combine", "--u_run_dir",
                     conf.results_path, "--u_run_dir", conf.results_path,
                     "--i_run_dir", runs["port"]["iprotomfs"].results_path])
    assert combined == experiment.run_combine_experiment(
        conf.results_path, runs["port"]["iprotomfs"].results_path)
    with pytest.raises(SystemExit):
        main(["-a", "uiprotomfs_combine", "--u_run_dir", conf.results_path])
