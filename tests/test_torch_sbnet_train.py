"""The port's SBNet training slice against the JAX package, on the CPU.

One train step at narrow widths with the JAX weights transplanted, the
negatives and the modality routing shift injected into both (the JAX side's
``jax.random.randint`` held at the shift for the call): logits, rec and reg
losses, every parameter gradient, the new batch statistics and the
parameters after one AdamW step from a transplanted non-zero optax state,
on the dense first layer (K5's plain version against the Pallas ``dw_matmul``
in interpret mode) and on the spmm first layer (K6/K7 against
``spmm_onehot`` in interpret mode). Tolerances: logits and losses rtol =
1e-5 (f32, sums in other orders); gradients, statistics and stepped
parameters rtol = 1e-4, atol = 1e-6 (longer f32 chains; the step uses lr
1e-2 so the atol is 1e-4 of an update).

Then `Trainer.train_epoch` on tiny data, and the chip smoke run's training
configuration against the YAML."""
import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sibrar_tpu.config.loader import get_config
from sibrar_tpu.config.schema import LearningConfig as JaxLearningConfig
from sibrar_tpu.models import layers as jlayers
from sibrar_tpu.models.base import collect_reg_loss
from sibrar_tpu.train.losses import build_rec_loss as jax_rec_loss
from sibrar_tpu.train.trainer import build_optimizer as jax_build_optimizer
from sibrar_tpu_torch import config_from_dict
from sibrar_tpu_torch.models import layers as tlayers
from sibrar_tpu_torch.models.sbnet import SingleBranchNet
from sibrar_tpu_torch.models.transplant import _pairs, transplant_opt_state
from sibrar_tpu_torch.ops import dw, spmm
from sibrar_tpu_torch.train.losses import build_rec_loss
from sibrar_tpu_torch.train.trainer import (
    DatasetConfig,
    LearningConfig,
    Trainer,
    build_optimizer,
)
from test_torch_sbnet_serve import CONF, ROOT, _both, _chip_smoke, _models, \
    _narrow_conf

F32 = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
B, N_NEG, DELTA, LR, WD = 16, 3, 7, 1e-2, 1e-3


def _step_inputs(tsplits):
    """Users, their positive plus negatives (global item ids) and labels."""
    train = tsplits["train"]
    rng = np.random.default_rng(5)
    pick = rng.choice(len(train.interactions), B, replace=False)
    users = train.interactions[pick, 0].astype(np.int32)
    items = np.concatenate(
        [train.interactions[pick, 1:2],
         rng.integers(0, train.n_items, (B, N_NEG))], 1).astype(np.int32)
    labels = np.zeros(items.shape, np.float32)
    labels[:, 0] = 1.0
    return users, items, labels


def _random_adamw_state(tx, params, rng):
    """A non-zero optax adamw state: count 3, random moments."""
    state = tx.init(params)
    adam = state[0]
    mu = jax.tree_util.tree_map(
        lambda p: jnp.asarray(0.01 * rng.standard_normal(p.shape),
                              jnp.float32), params)
    nu = jax.tree_util.tree_map(
        lambda p: jnp.asarray(1e-4 * rng.random(p.shape), jnp.float32),
        params)
    return (adam._replace(count=jnp.asarray(3, jnp.int32), mu=mu, nu=nu),
            *state[1:])


@pytest.mark.parametrize("first_layer,reg_type", [
    ("dense", "pairwise_single"), ("spmm", "pairwise_single"),
    ("dense", "central_modality")])
def test_sbnet_train_step_matches_jax(first_layer, reg_type, monkeypatch):
    js, ts = _both(n_users=300, n_items=400, n_interactions=8000)
    conf = _narrow_conf()
    conf["item"]["single_branch_input_dropout"] = None
    conf["item"]["embedding_regularization_type"] = reg_type
    conf["item"]["central_modality"] = "bert"
    jm, variables, tm = _models(js, ts, conf)
    if first_layer == "spmm":
        monkeypatch.setattr(jlayers, "INTERACTION_SPMM", "interpret")
        monkeypatch.setattr(tlayers, "INTERACTION_SPMM", True)
    else:
        monkeypatch.setattr(jlayers, "DW_KERNEL", "interpret")
    users, items, labels = _step_inputs(ts)
    rec_kw = dict(n_items=400, n_neg=N_NEG)

    # ---- JAX: model.apply(train=True) + rec loss + sown reg loss + adamw
    params = variables["params"]

    def loss_fn(p):
        logits, aux = jm.apply(
            {**variables, "params": p}, jnp.asarray(users),
            jnp.asarray(items), train=True,
            rngs={"sample": jax.random.PRNGKey(1),
                  "dropout": jax.random.PRNGKey(2)},
            mutable=["losses", "batch_stats"])
        loss = jax_rec_loss("bpr", **rec_kw)(logits, jnp.asarray(labels))
        reg = collect_reg_loss(aux)
        return loss + reg, (logits, loss, reg, aux["batch_stats"])

    with monkeypatch.context() as m:  # the routing shift
        m.setattr(jax.random, "randint",
                  lambda key, shape, *a, **k: jnp.full(shape, DELTA,
                                                       jnp.int32))
        (_, (jlogits, jloss, jreg, jstats)), jgrads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
    tx = jax_build_optimizer(JaxLearningConfig(optimizer="adamw", lr=LR,
                                               wd=WD))
    jstate = _random_adamw_state(tx, params, np.random.default_rng(6))
    updates, _ = tx.update(jgrads, jstate, params)
    jnew = optax.apply_updates(params, updates)

    # ---- the port
    counts = (dw.dw_matmul.launches, spmm.spmm_fwd.launches)
    tm.train()
    logits, reg = tm(torch.as_tensor(users), torch.as_tensor(items),
                     gen=torch.Generator().manual_seed(0), delta=DELTA)
    loss = build_rec_loss("bpr", **rec_kw)(logits, torch.as_tensor(labels))
    opt = build_optimizer(LearningConfig(optimizer="adamw", lr=LR, wd=WD),
                          tm.parameters())
    transplant_opt_state(tm, opt, jstate)
    assert opt.count == 3
    opt.zero_grad()
    (loss + reg).backward()
    # CPU tensors take the plain versions: no kernel launches
    assert (dw.dw_matmul.launches, spmm.spmm_fwd.launches) == counts

    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **F32)
    np.testing.assert_allclose(loss.item(), float(jloss), **F32)
    assert float(jreg) > 0
    np.testing.assert_allclose(reg.item(), float(jreg), **F32)
    pairs = _pairs(tm, jgrads, jstats)
    n_params = 0
    for dst, src, transpose in pairs:
        want = np.asarray(src).T if transpose else np.asarray(src)
        if isinstance(dst, torch.nn.Parameter):
            n_params += 1
            assert dst.grad is not None
            np.testing.assert_allclose(dst.grad.numpy(), want, **GRAD)
        else:  # batch statistics after the step's update
            np.testing.assert_allclose(dst.numpy(), want, **GRAD)
    assert n_params == len(list(tm.parameters()))
    opt.step()
    for dst, src, transpose in _pairs(tm, jnew, None):
        want = np.asarray(src).T if transpose else np.asarray(src)
        np.testing.assert_allclose(dst.detach().numpy(), want, **GRAD)


@pytest.mark.parametrize("reg_type", ["no_regularization", "pairwise_single",
                                      "central_modality"])
def test_compute_all_modality_sampling_trains_every_modality(reg_type):
    """``routed_modality_sampling: false``: every modality projects the
    whole batch and each example keeps k sampled ones (the JAX draws cannot
    be injected here, so the contract is checked, not the values)."""
    _, ts = _both(n_users=300, n_items=400, n_interactions=8000)
    conf = _narrow_conf()
    conf["item"].update(routed_modality_sampling=False,
                        embedding_regularization_type=reg_type,
                        central_modality="bert")
    train = ts["train"]
    tm = SingleBranchNet.build_from_conf(conf, train, train.to_device("cpu"),
                                         seed=2)
    users, items, _ = _step_inputs(ts)
    tm.train()
    logits, reg = tm(torch.as_tensor(users), torch.as_tensor(items),
                     gen=torch.Generator().manual_seed(0))
    assert logits.shape == items.shape and torch.isfinite(logits).all()
    assert (reg.item() > 0) == (reg_type != "no_regularization")
    (logits.sum() + reg).backward()
    for m in tm.item_module.modalities:
        assert any(p.grad is not None and p.grad.abs().sum() > 0
                   for p in m.parameters())


def _tiny_trainer(**learn):
    _, ts = _both(n_users=120, n_items=300, n_interactions=3000)
    train = ts["train"]
    data = train.to_device("cpu")
    model = SingleBranchNet.build_from_conf(_narrow_conf(), train, data,
                                            seed=1)
    learn = LearningConfig(**{"optimizer": "adam", "lr": 3e-3,
                              "rec_loss": "bpr", **learn})
    return Trainer(model, train, learn, DatasetConfig(n_negative_samples=4),
                   batch_size=128, seed=0, device_data=data)


def test_trainer_epochs_with_tail_batch_lower_the_loss():
    trainer = _tiny_trainer()
    n_inter = int(trainer.data.train_users.shape[0])
    assert n_inter % 128  # the epoch ends in a tail batch
    before = [p.detach().clone() for p in trainer.model.parameters()]
    logs = [trainer.train_epoch() for _ in range(3)]
    n_steps = -(-n_inter // 128)
    assert trainer.step == 3 * n_steps
    assert trainer.epoch_losses.shape == (n_steps, 3)
    for log in logs:
        assert all(np.isfinite(v) for v in log.values())
        assert log["train/reg_loss"] > 0
        np.testing.assert_allclose(
            log["train/loss"], log["train/rec_loss"] + log["train/reg_loss"],
            rtol=1e-5)
    # the epoch mean weighs the tail step by tail / bs
    w = torch.ones(n_steps)
    w[-1] = (n_inter % 128) / 128
    np.testing.assert_allclose(
        logs[-1]["train/loss"],
        float((trainer.epoch_losses[:, 0] * w).sum() / w.sum()), rtol=1e-5)
    assert logs[-1]["train/loss"] < logs[0]["train/loss"]
    assert all(not torch.equal(a, b) for a, b in
               zip(before, trainer.model.parameters()))


def test_trainer_caps_batches_and_refuses_unported_options():
    trainer = _tiny_trainer(max_batches_per_epoch=2)
    trainer.train_epoch()
    assert trainer.step == 2 and trainer.epoch_losses.shape == (2, 3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _tiny_trainer(sparse_tables=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _tiny_trainer(moment_dtype="bfloat16")


def test_chip_smoke_train_confs_match_yaml():
    """The chip run's learn / dataset / loader dicts are the YAML's, as the
    JAX package's loader resolves it (base configs folded in), and the
    port's configs take them."""
    resolved = get_config(os.path.join(ROOT, CONF))
    smoke = _chip_smoke()
    assert smoke.LEARN_CONF == dataclasses.asdict(resolved.learn)
    assert smoke.LOADER_CONF == dataclasses.asdict(resolved.loader)
    for key, value in smoke.DATASET_CONF.items():
        assert getattr(resolved.dataset, key) == value
    learn = config_from_dict(LearningConfig, smoke.LEARN_CONF)
    assert dataclasses.asdict(learn) == smoke.LEARN_CONF
    dataset = config_from_dict(DatasetConfig, smoke.DATASET_CONF)
    assert dataclasses.asdict(dataset) == smoke.DATASET_CONF
    assert copy.deepcopy(smoke.MODEL_CONF) == resolved.model
