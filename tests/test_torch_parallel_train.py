"""Training, checkpoints, evaluation, serving and the CLI on a device mesh
(the port's counterparts of JAX's test_parallel.py), each held to the
same run on one device.

One spawned 8-rank gloo world (data 4 x item 2, ``torch_parallel_world``)
runs every case next to its single-device run, from the same seeds and
weights; a 2-rank world runs the CLI. Tolerances: JAX's, 1e-5 for
evaluation (the mesh's metrics equal the single device's here) and 2e-4
after a data- or tensor-parallel epoch (measured: at most 3.7e-7 in the
parameters). One SBNet step, data parallel with both interaction towers
row-sliced: the losses within 1e-6, every gradient within 5e-5 absolute
(measured 2.5e-5, on gradients up to 10.6), and the parameters after the
AdamW step within 1e-6 (measured 2.4e-7), except the biases of layers a
batch norm follows: their gradient is zero up to rounding (1.7e-6 here),
so Adam's first step moves them by about +-lr on either side, and they
are held within 2 lr."""
import copy
import os

import numpy as np
import pytest
import yaml

from sibrar_tpu.config.schema import DatasetConfig as JaxDatasetConfig
from sibrar_tpu.config.schema import EvalConfig as JaxEvalConfig
from sibrar_tpu.config.schema import LearningConfig as JaxLearningConfig
from sibrar_tpu.data.synthetic import make_synthetic_splits as jax_splits
from sibrar_tpu.eval.evaluator import FullEvaluator as JaxEvaluator
from sibrar_tpu.models.mf import SGDMatrixFactorization as JaxMF
from sibrar_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sibrar_tpu.train.trainer import Trainer as JaxTrainer
from test_torch_sbnet_serve import FEATURES, _narrow_conf
from torch_parallel_world import run_world

TRAINED = dict(rtol=2e-4, atol=2e-4)
LR = 1e-3  # the SBNet step's learning rate (torch_parallel_world)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("world8"))
    return run_world(8, "train_eval", {
        "tmp": tmp, "features": FEATURES,
        "sbnet_conf": copy.deepcopy(_narrow_conf())}, tmp)


def _close(got: dict, want: dict, **tol):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _epoch_close(pair):
    mesh, single = pair["mesh"], pair["single"]
    np.testing.assert_allclose(mesh["losses"], single["losses"], **TRAINED)
    _close(mesh["state"], single["state"], **TRAINED)
    _close(mesh["val"], single["val"], **TRAINED)


def test_batch_size_must_divide_mesh(port):
    """JAX's error, word for word."""
    splits = jax_splits(n_users=30, n_items=40, n_interactions=400, seed=2)
    model = JaxMF(n_users=30, n_items=40, embedding_dim=4)
    ev = JaxEvaluator(JaxEvalConfig(top_k=[5]), splits["val"])
    with pytest.raises(ValueError) as e:
        JaxTrainer(model, splits["train"], ev, JaxLearningConfig(),
                   JaxDatasetConfig(), batch_size=17, seed=0,
                   mesh=jax_make_mesh(8))
    assert port["divide"] == str(e.value)
    assert "must divide over the mesh" in port["divide"]


def test_dp_training_step_matches_single_device(port):
    """MF, pure data parallelism over all 8 ranks, 2 capped steps of 64
    (JAX's test_dp_training_step_runs_sharded): the parameters moved, and
    losses, parameters and validation match one device."""
    pair = port["mf_dp"]
    _epoch_close(pair)
    assert pair["mesh"]["losses"].shape == (2, 3)
    assert np.isfinite(pair["mesh"]["val"]["val/ndcg@5"])


def test_dp_epoch_with_tail_matches_single_device(port):
    """A whole MF epoch, its tail batch a whole number of rows a rank."""
    pair = port["mf_epoch"]
    _epoch_close(pair)
    assert pair["mesh"]["losses"].shape[0] > 2


def test_mesh_evaluator_matches_single_device(port):
    """The same weights evaluated on the mesh (per-shard selection, the
    candidates merged over the item axis, the rows gathered over the data
    axis) and on one device."""
    ev = port["mesh_eval"]
    _close(ev["mesh"], ev["single"], rtol=0, atol=1e-5)


def test_chunked_item_repr_sharded_matches_default(port):
    """The catalog encoded in chunks of 16, each sharded over the ranks."""
    ev = port["mesh_eval"]
    _close(ev["chunked"], ev["mesh"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("path", ["dense", "bag"])
def test_tower_tensor_parallel_matches_single_device(port, path):
    """DMF with both towers' first-layer kernels row-sliced over the item
    axis (JAX's tower TP tests, dense and bag first layers): each rank
    holds n/2 kernel rows and their moments, the hidden layers whole, and
    the epoch matches one device."""
    pair = port[f"dmf_{path}"]
    _epoch_close(pair)
    _close(pair["val_again"], pair["single"]["val"], rtol=0, atol=1e-5)
    shapes = pair["shapes"]
    assert shapes["user_kernel"] == (32, 16)  # 64 items / 2
    assert shapes["item_kernel"] == (24, 16)  # 48 users / 2
    assert (32, 16) in shapes["moments"] and (24, 16) in shapes["moments"]
    assert shapes["tp"] == {"user_nn.kernel": (0, 32, 64),
                            "item_nn.kernel": (0, 24, 48)}
    assert not shapes["flat"]  # the batch shards over the data axis only
    for k, v in pair["single"]["state"].items():
        assert pair["mesh"]["state"][k].shape == v.shape, k


def test_tower_tp_checkpoint_roundtrip(port):
    """The checkpoint a tensor-parallel run writes (rank 0, kernels and
    moments whole) loads bit for bit into a single-device trainer; its
    model.pt too; a mesh trainer reloads it sliced and trains on."""
    c = port["checkpoint"]
    assert all(c["model"].values()) and c["model"]
    assert all(c["moments"].values()) and c["moments"]
    assert c["model_pt"] and c["resumed_slices"]
    assert c["step"][0] == c["step"][1] > 0
    assert c["item_kernel"] == (24, 16)
    assert np.isfinite(c["loss"])


def test_explicit_non_peel_method_forces_scatter_per_shard(port):
    """``topk_method: full`` on an item-sharded mesh pins the per-shard
    scatter: no flags, no redo."""
    assert port["explicit"] == (False, False)


def test_sharded_dot_eval_batch_matches_scores_path(port):
    """The per-shard K2 + peel eval batch (C = 6,001, odd over 2 shards)
    against the scores path on the same users: metrics and coverage."""
    dot = port["dot_batch"]
    assert dot["engaged"] and dot["max_diff"] <= 1e-6


def test_evaluate_model_sharded_dot_path_end_to_end(port):
    d = port["dot_eval"]
    _close(d["mesh"], d["single"], rtol=1e-5, atol=1e-6)


def test_sharded_peel_redo_restores_exactness(port):
    """Every top-100 winner in one 128-wide window of shard 0: its peel
    flags the rows, the item group redoes them with the scatter, and the
    metrics are the exact single-device ones."""
    r = port["redo"]
    assert r["flagged"] > 0
    _close(r["mesh"], r["single"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8", "scores",
                                  "approx"])
def test_serving_mesh_matches_unsharded(port, mode):
    """Recommender on the mesh against one device, for every user of the
    split: the same ids, the same scores, on every rank. The dot models
    take the per-shard dot chain (f32, bf16, and approx, served exact on a
    mesh as in JAX); int8 and a scorer without dot parts the per-shard
    scatter."""
    s = port["serve"][mode]
    np.testing.assert_array_equal(s["mesh"][0], s["single"][0])
    np.testing.assert_allclose(s["mesh"][1], s["single"][1], rtol=1e-6)
    assert s["same_on_ranks"]
    assert s["use_dot"] == (mode in ("f32", "bf16", "approx"))


def test_sbnet_dp_tp_step_matches_single_device(port):
    """One SBNet step (narrow widths, routing, dropout, batch norm,
    InfoNCE), data parallel over the data axis with both interaction
    towers row-sliced, against the same step on one device."""
    s = port["sbnet"]
    assert set(s["tp"]) == {"user_module.net.kernel",
                            "item_module.modalities.0.kernel"}
    mesh, single = s["mesh"], s["single"]
    np.testing.assert_allclose(mesh["loss"], single["loss"], rtol=1e-6)
    _close(mesh["grads"], single["grads"], rtol=0, atol=5e-5)
    state = single["state"]
    before_bn = {k.replace("batch_norm", "linears").rsplit(".", 1)[0]
                 + ".bias" for k in state if ".batch_norm." in k}
    for k, v in state.items():
        tol = 2 * LR if k in before_bn else 1e-6
        np.testing.assert_allclose(mesh["state"][k], v, rtol=0, atol=tol,
                                   err_msg=k)


CLI_CONF = {
    "learn": {"n_epochs": 1, "lr": 0.005, "rec_loss": "bpr",
              "optimizing_metric": "ndcg@5"},
    "eval": {"top_k": [1, 5], "metrics": ["ndcg", "recall"]},
    "loader": {"batch_size": 31, "eval_batch_size": 16},
    "dataset": {"n_negative_samples": 2, "user_features": [],
                "item_features": []},
    "run_settings": {"device": "cpu"},
    "model": {"u_mid_layers": [8], "i_mid_layers": [8],
              "final_dimension": 4},
    "parallel": {"enabled": True, "item_parallelism": 2,
                 "tower_min_rows": 8},
}


def test_cli_train_val_test_two_ranks(tmp_path):
    """``run_experiment -t train_val_test`` (DMF, its towers row-sliced
    over an item axis of 2) on 2 ranks, each in its own working
    directory: the run's files are written once, into the run directory,
    nothing lands in either working directory, and the metrics have the
    keys of the same run in one process (which asks for one device)."""
    from sibrar_tpu_torch.data.synthetic import (
        make_synthetic_splits,
        write_reference_artifacts,
    )
    from sibrar_tpu_torch.run_experiment import main

    data = str(tmp_path / "data")
    write_reference_artifacts(data, make_synthetic_splits(
        n_users=30, n_items=40, n_interactions=600, seed=5,
        with_features=False))
    conf = str(tmp_path / "conf.yml")
    with open(conf, "w") as fh:
        yaml.safe_dump(CLI_CONF, fh)
    argv = ["-a", "dmf", "-c", conf, "-d", data, "-t", "train_val_test",
            "-o", f"results_path={tmp_path / 'run'}"]
    got = run_world(2, "cli", {"tmp": str(tmp_path), "argv": argv},
                    str(tmp_path / "world"))
    assert sorted(os.listdir(tmp_path / "run")) == [
        "conf.yml", "metrics_test.yml", "metrics_val.yml", "model.pt"]
    with open(tmp_path / "run" / "conf.yml") as fh:
        # rounded up to divide over the 2 ranks (adjust_batch_sizes)
        assert yaml.safe_load(fh)["loader"]["batch_size"] == 32
    assert os.listdir(tmp_path / "cwd0") == []
    assert os.listdir(tmp_path / "cwd1") == []
    with open(tmp_path / "run" / "metrics_test.yml") as fh:
        assert yaml.safe_load(fh) == got["test"]
    one_val, one_test = main([*argv[:-1], f"results_path={tmp_path / 'one'}"])
    assert set(one_val) == set(got["val"]) and set(one_test) == set(
        got["test"])
    for v in (*got["val"].values(), *got["test"].values()):
        assert np.isfinite(v)

