"""The matrix algorithms through the port's entry points, on the CPU, in
process: ``python -m sibrar_tpu_torch.run_experiment`` (``main``) for
``ease``, ``pop`` and ``iknn`` (tests/test_experiment.py's matrix runs) on
the artifacts JAX's run reads too, with JAX's metrics (pop and iknn equal
within 1e-6: the same fits and lists; ease within 1e-4, an f32 inverse
in another order); every eleventh name's ``train_val_test`` run files;
``-t gather`` against the run's own scores and its ``-t test`` metrics;
`Recommender.from_run_dir` and ``serve_recs`` on a matrix run
(tests/test_serve.py's EASE case), ``dtype`` bf16 / int8 warning and
staying f32 as in JAX; a JAX run directory (its ``model.npz``) served by
the port; the quality join's gate for the matrix algorithms that fit
without random draws; and the card run's matrix settings against
``conf/single/knn.yml``."""
import json
import logging
import os
import pickle

import numpy as np
import pytest
import torch
import yaml

import run_experiment as jax_run_experiment
from sibrar_tpu.serve import Recommender as JaxRecommender
from sibrar_tpu_torch.data.synthetic import (
    make_synthetic_splits,
    write_reference_artifacts,
)
from sibrar_tpu_torch.experiment import load_for_serving
from sibrar_tpu_torch.run_experiment import main
from sibrar_tpu_torch.serve import Recommender
from sibrar_tpu_torch.serve_recs import main as serve_recs
from sibrar_tpu_torch.tools import trained_parity
from test_torch_matrix_algs import MODEL_CONFS
from test_torch_sbnet_serve import _chip_smoke
from test_torch_synthetic_sampling import _joiner


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def artifact_dir(tmp_path_factory):
    """tests/test_experiment.py's artifacts, written by the port (JAX's
    files byte for byte)."""
    out = str(tmp_path_factory.mktemp("synth_random"))
    write_reference_artifacts(out, make_synthetic_splits(
        n_users=50, n_items=60, n_interactions=1200, seed=11))
    return out


def _write_conf(path, model, results, device=True):
    """tests/test_experiment.py's ``_write_conf`` for a matrix name."""
    conf = {
        "eval": {"top_k": [10], "metrics": ["ndcg", "recall", "coverage"]},
        "loader": {"batch_size": 32, "eval_batch_size": 64},
        "dataset": {"item_features": [{"name": "audio", "type": "vector"}]},
        "model": model, "results_path": str(results)}
    if device:
        conf["run_settings"] = {"device": "cpu"}
    with open(path, "w") as fh:
        yaml.safe_dump(conf, fh)
    return str(path)


def _read(run, name):
    with open(os.path.join(run, name)) as fh:
        return yaml.safe_load(fh)


@pytest.mark.parametrize("algorithm", ["ease", "pop", "iknn"])
def test_cli_train_val_test_matrix_matches_jax(tmp_path, artifact_dir,
                                               algorithm):
    conf = _write_conf(tmp_path / "conf.yml", MODEL_CONFS[algorithm],
                       tmp_path / "run")
    main(["-a", algorithm, "-d", artifact_dir, "-t", "train_val_test",
          "-c", conf])
    run = str(tmp_path / "run")
    assert sorted(os.listdir(run)) == ["conf.yml", "metrics_test.yml",
                                       "metrics_val.yml", "model.npz"]
    jconf = _write_conf(tmp_path / "jconf.yml", MODEL_CONFS[algorithm],
                        tmp_path / "jrun", device=False)
    jax_run_experiment.main(["-a", algorithm, "-d", artifact_dir, "-t",
                             "train_val_test", "-c", jconf])
    atol = 1e-4 if algorithm == "ease" else 1e-6
    for name in ("metrics_val.yml", "metrics_test.yml"):
        got, want = _read(run, name), _read(str(tmp_path / "jrun"), name)
        assert list(got) == list(want)
        for key, v in want.items():
            np.testing.assert_allclose(got[key], v, rtol=0, atol=atol,
                                       err_msg=key)


@pytest.mark.parametrize("algorithm", sorted(MODEL_CONFS))
def test_every_matrix_name_runs_train_val_test(tmp_path, artifact_dir,
                                               algorithm):
    conf = _write_conf(tmp_path / "conf.yml", MODEL_CONFS[algorithm],
                       tmp_path / "run")
    val, test = main(["-a", algorithm, "-d", artifact_dir, "-t",
                      "train_val_test", "-c", conf])
    assert np.isfinite(val["val/ndcg@10"]) and np.isfinite(
        test["test/ndcg@10"])
    assert os.path.exists(tmp_path / "run" / "model.npz")


def test_gather_on_a_matrix_run(tmp_path, artifact_dir):
    conf = _write_conf(tmp_path / "conf.yml", MODEL_CONFS["iknn"],
                       tmp_path / "run")
    main(["-a", "iknn", "-d", artifact_dir, "-t", "train_val", "-c", conf])
    main(["-a", "iknn", "-d", artifact_dir, "-t", "gather", "-c", conf])
    with open(tmp_path / "run" / "gather_test.pkl", "rb") as fh:
        payload = pickle.load(fh)
    score_fn, ds, data, _ = load_for_serving(str(tmp_path / "run"), "test",
                                             "cpu")
    users = payload["user_indices"]
    scores = score_fn(torch.as_tensor(users)).numpy().astype(np.float64)
    excl = ds.exclude_matrix().tocsr()[:, ds.items_in_split].toarray()
    scores[excl[users] > 0] = -1e30
    order = np.argsort(-scores, axis=1, kind="stable")[:, :payload["k"]]
    np.testing.assert_array_equal(payload["topk_item_indices"], order)
    assert payload["topk_item_indices"].dtype == np.int32
    main(["-a", "iknn", "-d", artifact_dir, "-t", "test", "-c", conf])
    test = _read(str(tmp_path / "run"), "metrics_test.yml")
    assert list(payload["metrics"]) == list(test)
    for key, v in test.items():
        np.testing.assert_allclose(payload["metrics"][key], v, rtol=0,
                                   atol=1e-6, err_msg=key)


def test_from_run_dir_matrix_algorithm(tmp_path, caplog):
    """tests/test_serve.py's EASE run, served by the port: the lists are
    the reloaded scores' masked top-k, ``serve_recs`` writes the same, and
    bf16 / int8 warn (no dot parts) and serve the f32 lists."""
    art = str(tmp_path / "data")
    write_reference_artifacts(art, make_synthetic_splits(
        n_users=30, n_items=40, n_interactions=600, seed=6))
    res = str(tmp_path / "run")
    conf = str(tmp_path / "conf.yml")
    with open(conf, "w") as fh:
        yaml.safe_dump({"eval": {"top_k": [5], "metrics": ["ndcg"]},
                        "loader": {"batch_size": 32, "eval_batch_size": 32},
                        "model": {"lam": 5.0}, "results_path": res,
                        "run_settings": {"device": "cpu"}}, fh)
    main(["-a", "ease", "-d", art, "-t", "train_val", "-c", conf])
    rec = Recommender.from_run_dir(res, split="val", batch_size=16)
    users = np.arange(10)
    ids = rec.recommend(users, k=5)
    assert ids.shape == (10, 5)
    scores = rec.score_fn(torch.as_tensor(users)).numpy().copy()
    excl = rec.dataset.exclude_matrix().tocsr()
    for r, u in enumerate(users):
        scores[r, excl[u].indices] = -np.inf
    want = np.asarray(rec.dataset.items_in_split)[
        np.argsort(-scores, axis=1, kind="stable")[:, :5]]
    np.testing.assert_array_equal(ids, want)
    out = str(tmp_path / "recs.csv")
    serve_recs(["-r", res, "-s", "val", "-k", "5", "-u",
                ",".join(map(str, users)), "-o", out, "--device", "cpu"])
    with open(out) as fh:
        rows = [line.strip().split(",") for line in fh][1:]
    np.testing.assert_array_equal(np.asarray(rows, np.int64)[:, 1:], want)
    for dtype in ("bfloat16", "int8"):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            low = Recommender.from_run_dir(res, split="val", dtype=dtype)
        assert "exposes no dot_parts" in caplog.text
        assert low.dtype is None
        np.testing.assert_array_equal(low.recommend(users, k=5), want)


@pytest.mark.parametrize("algorithm", ["pop", "iknn", "svd"])
def test_jax_run_dir_served_by_the_port(tmp_path, artifact_dir, algorithm):
    """A run directory JAX's CLI wrote (``model.npz``, its ``conf.yml``)
    serves on the port with JAX's scores and lists."""
    conf = _write_conf(tmp_path / "jconf.yml", MODEL_CONFS[algorithm],
                       tmp_path / "jrun", device=False)
    jax_run_experiment.main(["-a", algorithm, "-d", artifact_dir, "-t",
                             "train_val", "-c", conf])
    run = str(tmp_path / "jrun")
    rec = Recommender.from_run_dir(run, split="test", device="cpu", k=10)
    jrec = JaxRecommender.from_run_dir(run, split="test", k=10)
    users = np.arange(50)
    got, gs = rec.recommend(users, return_scores=True)
    want, ws = jrec.recommend(users, return_scores=True)
    np.testing.assert_allclose(gs, np.asarray(ws), rtol=1e-6, atol=1e-7)
    if algorithm != "svd":  # f32 products in another order may swap ties
        np.testing.assert_array_equal(got, np.asarray(want))


def _matrix_runs(ndcg, recall, family="iknn"):
    return {"scale": "mid", "device": "cpu", "families": {family: {
        "hparams": trained_parity.hparams_for(family, "mid"),
        "runs": {"0": ndcg}, "recall": {"0": recall}}}}


@pytest.mark.parametrize("case", ["equal", "ndcg off", "recall off",
                                  "the committed values"])
def test_quality_join_matrix_gate(case):
    """The exact-fit matrix names' gate in ``torch_trained_parity.join``:
    both metrics within 1e-3 of JAX's pass, 2e-3 off in either fails; the
    committed JAX file holds every matrix family with its hyperparameters
    and the recall of every seed it ran."""
    join = _joiner().join
    ref = _matrix_runs(0.18, 0.30)
    if case == "the committed values":
        with open(trained_parity.JAX_RUNS) as fh:
            fams = json.load(fh)["families"]
        for name, h in trained_parity.MATRIX_HPARAMS.items():
            assert fams[name]["hparams"] == h
            assert set(fams[name]["recall"]) == set(fams[name]["runs"])
        return
    ndcg, recall = {"equal": (0.1805, 0.2995), "ndcg off": (0.182, 0.30),
                    "recall off": (0.18, 0.298)}[case]
    res = join(ref, _matrix_runs(ndcg, recall))["iknn"]
    assert res["passes"] is (case == "equal")
    assert res["max_abs_diff_recall"] == pytest.approx(abs(recall - 0.30))


def test_chip_smoke_matrix_confs_match_yaml():
    """The card run's iknn width is conf/single/knn.yml's, which is the
    quality run's KNN; its ML-1M runs use the quality run's settings."""
    smoke = _chip_smoke()
    assert smoke.get_knn_conf() == {
        "k": 100, "shrinkage": 10.0,
        "sim_func_params": {"sim_func_name": "cosine"}}
    assert set(smoke.ML1M_NAMES) | {"iknn", "pop", "rand"} == set(
        trained_parity.MATRIX_HPARAMS)
    assert set(smoke.MATRIX_NAMES) == set(trained_parity.MATRIX_HPARAMS)
