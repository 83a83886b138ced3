"""Full-state checkpoints and ``debug_nans`` in the port, on the CPU.

Resume mirrors ``tests/test_checkpoint_resume.py``: train an epoch, save,
train another; a fresh trainer loads and trains the same epoch and must
match, rtol 1e-5 as JAX's test (here the CPU gives the same bits). Then
the checkpoint's format (``torch.load(weights_only=True)``), a missing
checkpoint, bf16 moments kept in bf16, and ``debug_nans`` raising
``FloatingPointError`` in both packages on an input that makes a NaN."""
import os

import jax
import numpy as np
import pytest
import torch

from sibrar_tpu.config.schema import DatasetConfig as JaxDatasetConfig
from sibrar_tpu.config.schema import EvalConfig as JaxEvalConfig
from sibrar_tpu.config.schema import LearningConfig as JaxLearningConfig
from sibrar_tpu.data.synthetic import make_synthetic_splits as jax_splits
from sibrar_tpu.eval.evaluator import FullEvaluator as JaxEvaluator
from sibrar_tpu.models.mf import SGDMatrixFactorization as JaxMF
from sibrar_tpu.train.trainer import Trainer as JaxTrainer
from sibrar_tpu_torch.config.schema import (
    DatasetConfig,
    EvalConfig,
    LearningConfig,
)
from sibrar_tpu_torch.data.synthetic import make_synthetic_splits
from sibrar_tpu_torch.eval.evaluator import FullEvaluator
from sibrar_tpu_torch.models.registry import get_algorithm
from sibrar_tpu_torch.train.trainer import CHECKPOINT, Trainer


def _trainer(splits, seed=0, **learn):
    train = splits["train"]
    data = train.to_device("cpu")
    model = get_algorithm("mf").build({"embedding_dim": 8}, train, data,
                                      seed)
    ev = FullEvaluator(EvalConfig(top_k=[5]), splits["val"], device="cpu",
                       evaluator_name="val")
    return Trainer(model, train,
                   LearningConfig(**{"n_epochs": 1, "lr": 1e-2,
                                     "rec_loss": "bpr",
                                     "optimizing_metric": "ndcg@5", **learn}),
                   DatasetConfig(), batch_size=32, seed=seed,
                   device_data=data, val_evaluator=ev)


def _splits(seed):
    return make_synthetic_splits(n_users=40, n_items=50, n_interactions=700,
                                 seed=seed, with_features=False)


@pytest.mark.parametrize("learn", [{}, {"moment_dtype": "bfloat16"},
                                   {"sparse_tables": True,
                                    "sparse_table_min_rows": 1}],
                         ids=["f32", "bf16_moments", "sparse_tables"])
def test_full_state_resume_is_deterministic(tmp_path, learn):
    splits = _splits(4)
    a = _trainer(splits, **learn)
    a.train_epoch()
    a.save_checkpoint(str(tmp_path / "ckpt"))
    a.train_epoch()  # one more epoch after saving

    b = _trainer(splits, seed=1, **learn)  # another init and generator
    b.load_checkpoint(str(tmp_path / "ckpt"))
    assert b.step < a.step  # the checkpoint predates the second epoch
    b.train_epoch()
    assert b.step == a.step
    for x, y in zip(a.model.parameters(), b.model.parameters()):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert torch.equal(x, y)
    for p, q in zip(a.optimizer.params, b.optimizer.params):
        for key, t in a.optimizer.state[p].items():
            assert t.dtype == b.optimizer.state[q][key].dtype
            assert torch.equal(t, b.optimizer.state[q][key])


def test_checkpoint_restores_best_tracking(tmp_path):
    splits = _splits(5)
    a = _trainer(splits)
    a.fit()
    a.save_checkpoint(str(tmp_path / "ckpt"))
    b = _trainer(splits, seed=1)
    b.load_checkpoint(str(tmp_path / "ckpt"))
    assert b.best_value == a.best_value
    assert b.best_epoch == a.best_epoch
    for key, v in a.best_state.items():
        assert torch.equal(v, b.best_state[key])


def test_checkpoint_is_a_weights_only_torch_file(tmp_path):
    a = _trainer(_splits(6), moment_dtype="bfloat16")
    a.train_epoch()
    a.save_checkpoint(str(tmp_path))
    state = torch.load(os.path.join(tmp_path, CHECKPOINT),
                       weights_only=True)
    assert set(state) == {"model", "optimizer", "rows", "generator", "step",
                          "best"}
    assert state["step"] == a.step and state["best"]["state"] is None
    mu = state["optimizer"]["state"]["user_embeddings.weight"]["mu"]
    assert mu.dtype == torch.bfloat16
    with pytest.raises(FileNotFoundError, match="checkpoint"):
        a.load_checkpoint(str(tmp_path / "empty"))


def test_debug_nans_raises_in_both_packages():
    """One user row of +inf: its dot products meet items of both signs
    and the loss is NaN. JAX (``jax_debug_nans``) and the port
    (``debug_nans``) both raise ``FloatingPointError``; without the flag
    the port's step runs and leaves a NaN loss."""
    jsp = jax_splits(n_users=40, n_items=50, n_interactions=700, seed=4,
                     with_features=False)
    model = JaxMF(n_users=40, n_items=50, embedding_dim=8)
    jt = JaxTrainer(model, jsp["train"],
                    JaxEvaluator(JaxEvalConfig(top_k=[5]), jsp["val"]),
                    JaxLearningConfig(n_epochs=1, lr=1e-2, rec_loss="bpr",
                                      max_batches_per_epoch=2),
                    JaxDatasetConfig(), batch_size=32, seed=0)
    params = jax.tree_util.tree_map(np.asarray, jt.state.params)
    params["user_embeddings"]["embedding"] = np.full((40, 8), np.inf,
                                                     np.float32)
    jt.state = jt.state.replace(params=jax.tree_util.tree_map(
        jax.numpy.asarray, params))
    jax.config.update("jax_debug_nans", True)
    try:
        with pytest.raises(FloatingPointError):
            jt.train_epoch()
    finally:
        jax.config.update("jax_debug_nans", False)

    splits = _splits(4)
    for debug in (True, False):
        t = _trainer(splits, max_batches_per_epoch=2)
        t.debug_nans = debug
        with torch.no_grad():
            t.model.user_embeddings.weight.fill_(float("inf"))
        if debug:
            with pytest.raises(FloatingPointError, match="step 0"):
                t.train_epoch()
            assert t.step == 0  # raised before the update
        else:
            assert np.isnan(t.train_epoch()["train/loss"])


def test_debug_nans_names_an_updated_parameter():
    """A NaN that first shows after the update (lr NaN) is reported as an
    updated parameter of that step."""
    t = _trainer(_splits(4), max_batches_per_epoch=2)
    t.debug_nans = True
    t.optimizer.lr = float("nan")
    with pytest.raises(FloatingPointError,
                       match="updated parameter 'user_embeddings.weight' at "
                             "train step 0"):
        t.train_epoch()
    assert t.step == 0
