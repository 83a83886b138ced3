"""The port's evaluation slice against the JAX package, on the CPU.

A small SBNet with weights transplanted from flax (batch-norm scales and
biases drawn so that item scores spread, the JAX side scoring through
``model.apply`` with ``dot_interpret`` set to reach its Pallas dot path):
`evaluate_model` gives JAX's metric dict (same keys, values within 1e-5)
under every ``topk_method``, with group metrics and population stds;
`FullEvaluator.eval_batch` and ``eval_batch_from_topk`` match JAX's; a
forced exactness trip takes the redo and keeps the metrics exact. Then
`Trainer.fit` with a scripted validation sequence (patience, strict best,
best state restored, the missing-metric error, ``save`` / ``load``) and on
real validations, and the chip run's ``eval:`` block against the YAML.
JAX's scanned ``Trainer.fit`` is never compiled here (minutes on a CPU)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sibrar_tpu.config.loader import get_config
from sibrar_tpu.config.schema import EvalConfig as JaxEvalConfig
from sibrar_tpu.config.schema import FeatureDefinition, FeatureType
from sibrar_tpu.data.feature import Feature
from sibrar_tpu.data.synthetic import make_synthetic_splits
from sibrar_tpu.eval.evaluator import FullEvaluator as JaxEvaluator
from sibrar_tpu.eval.evaluator import evaluate_model as jax_evaluate_model
from sibrar_tpu.models.base import init_model_abstract
from sibrar_tpu.models.sbnet import SingleBranchNet as JaxSBNet
from sibrar_tpu_torch import config_from_dict
from sibrar_tpu_torch.data.dataset import FeatureTable, RecDataset
from sibrar_tpu_torch.eval.evaluator import FullEvaluator, evaluate_model
from sibrar_tpu_torch.models.sbnet import SingleBranchNet
from sibrar_tpu_torch.models.transplant import transplant
from sibrar_tpu_torch.ops.topk import METHODS
from sibrar_tpu_torch.train.scoring import make_score_fn
from sibrar_tpu_torch.train.trainer import (
    DatasetConfig,
    EvalConfig,
    LearningConfig,
    Trainer,
)
from test_torch_sbnet_serve import CONF, ROOT, _both, _chip_smoke, \
    _narrow_conf

N_USERS, N_ITEMS = 200, 5000  # C > 4096: auto takes the peel
KS = [1, 5, 10]


def _draw(rng):
    """Parameters and statistics whose item representations spread: batch
    norm scales near 1 and small biases (at scale-0.1 draws the towers
    collapse every item to nearly one score)."""
    def draw(path, leaf):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        scale = 1.0 / np.sqrt(leaf.shape[0]) if name == "kernel" else 0.01
        return rng.normal(0.0, scale, leaf.shape).astype(np.float32)
    return draw


@pytest.fixture(scope="module")
def slice_():
    """Both packages' val splits (with a categorical user feature), the
    JAX scorer with dot parts, and the port's scorer over its SBNet."""
    js, ts = _both(n_users=N_USERS, n_items=N_ITEMS, n_interactions=4000)
    jval, tval = js["val"], ts["val"]
    labels = list(np.random.default_rng(2).choice(["m", "f", "x"],
                                                  N_USERS))
    feat = Feature.build(FeatureDefinition("gender", FeatureType.CATEGORICAL),
                         labels, N_USERS)
    jval.user_features["gender"] = feat
    tval.user_features["gender"] = FeatureTable(
        feat.table, "categorical", n_categories=len(feat.value_map),
        value_map=dict(feat.value_map))

    conf = _narrow_conf()
    jtrain = js["train"]
    jm = JaxSBNet.build_from_conf(conf, jtrain, jtrain.to_device())
    shaped = init_model_abstract(jm, jax.random.PRNGKey(0),
                                 jtrain.to_device())
    draw = _draw(np.random.default_rng(1))
    params = jax.tree_util.tree_map_with_path(draw, shaped["params"])
    stats = jax.tree_util.tree_map_with_path(draw, shaped["batch_stats"])
    variables = {**shaped, "params": params, "batch_stats": stats}
    i_repr = jm.apply(variables, jval.to_device().catalog,
                      method=jm.item_repr, train=False)
    u_repr = jm.apply(variables, jnp.arange(N_USERS, dtype=jnp.int32),
                      method=jm.user_repr, train=False)

    def jax_score(u):
        return u_repr[u] @ i_repr.T

    jax_score.dot_parts = (lambda u: u_repr[u], i_repr)

    ttrain = ts["train"]
    tm = SingleBranchNet.build_from_conf(conf, ttrain,
                                         ttrain.to_device("cpu"))
    transplant(tm, {"params": params, "batch_stats": stats})
    tdata = tval.to_device("cpu")
    return dict(jval=jval, tval=tval, tdata=tdata, jax_score=jax_score,
                score_fn=make_score_fn(tm, tdata.catalog))


def _jax_eval(s, conf, score_fn=None, batch_size=64):
    ev = JaxEvaluator(JaxEvalConfig(**conf), s["jval"], evaluator_name="val")
    ev.dot_interpret = True  # the Pallas dot path, in interpret mode
    return jax_evaluate_model(score_fn or s["jax_score"], ev,
                              batch_size=batch_size)


def _port_evaluator(s, conf):
    return FullEvaluator(EvalConfig(**conf), s["tval"], s["tdata"],
                         evaluator_name="val")


def _assert_same(got, want, atol=1e-5):
    assert list(got) == list(want)  # same keys, same natsorted order
    for key, v in want.items():
        np.testing.assert_allclose(got[key], v, rtol=0, atol=atol,
                                   err_msg=key)


@pytest.mark.parametrize("method", METHODS)
def test_evaluate_model_matches_jax(slice_, method):
    conf = dict(top_k=KS, topk_method=method)
    want = _jax_eval(slice_, conf)
    ev = _port_evaluator(slice_, conf)
    got = evaluate_model(slice_["score_fn"], ev, batch_size=64)
    _assert_same(got, want)
    # 200 users in 4 batches of 64; only auto / peel take the dot path and
    # record its redo counts (none on these scores)
    assert ev.redo_rows == ([0] * 4 if method in ("auto", "peel") else [])
    assert len(got) == 3 * 6 * 2 + 3  # mean and std of 6 metrics, coverage


def test_scores_path_without_dot_parts_matches_jax(slice_):
    """A scorer without dot parts under auto: the peel over its scores (K8's
    plain version), against JAX's scores path."""
    conf = dict(top_k=KS)
    want = _jax_eval(slice_, conf, score_fn=lambda u: slice_["jax_score"](u))
    ev = _port_evaluator(slice_, conf)
    sf = slice_["score_fn"]
    got = evaluate_model(lambda u: sf(u), ev, batch_size=64)
    _assert_same(got, want)
    assert ev.redo_rows == [0] * 4  # the peel ran on every batch


def test_group_metrics_and_std_match_jax(slice_):
    conf = dict(group_metrics=["gender"])  # every default metric and cutoff
    want = _jax_eval(slice_, conf, batch_size=128)
    got = evaluate_model(slice_["score_fn"], _port_evaluator(slice_, conf),
                         batch_size=128)
    _assert_same(got, want)
    assert "val/gender/f/ndcg@10_std" in got
    assert "val/coverage@100" in got and "val/ap@100_std" in got


def test_eval_batch_and_from_topk_match_jax(slice_):
    """The per-batch entry points on the same scores, with a padded last
    batch."""
    conf = dict(top_k=KS, compute_std=False)
    jev = JaxEvaluator(JaxEvalConfig(**conf), slice_["jval"],
                       evaluator_name="val")
    tev = _port_evaluator(slice_, conf)
    scores = np.asarray(slice_["jax_score"](jnp.arange(N_USERS)))
    excl = slice_["jval"].exclude_matrix().tocsr()
    masked = np.where(excl.toarray() > 0, -1e30, scores)
    topk = np.argsort(-masked, axis=1, kind="stable")[:, :10].astype(np.int32)
    for start in range(0, N_USERS, 96):
        u = np.arange(start, start + 96) % N_USERS
        valid = np.arange(start, start + 96) < N_USERS
        jev.eval_batch(jnp.asarray(u, jnp.int32), jnp.asarray(scores[u]),
                       valid=valid)
        tev.eval_batch(torch.as_tensor(u), torch.as_tensor(scores[u]),
                       valid=valid)
    _assert_same(tev.get_results(), jev.get_results())
    for start in range(0, N_USERS, 96):
        u = np.arange(start, min(start + 96, N_USERS))
        jev.eval_batch_from_topk(jnp.asarray(u, jnp.int32),
                                 jnp.asarray(topk[u]))
        tev.eval_batch_from_topk(torch.as_tensor(u),
                                 torch.as_tensor(topk[u]))
    _assert_same(tev.get_results(), jev.get_results())
    with pytest.raises(ValueError, match="k_max"):
        tev.eval_batch_from_topk(torch.arange(4), torch.zeros((4, 5)))


def _port_split(jds):
    return RecDataset(split_set=jds.split_set, n_users=jds.n_users,
                      n_items=jds.n_items, interactions=jds.interactions,
                      train_interactions=jds.train_interactions,
                      val_interactions=jds.val_interactions)


def test_forced_exactness_trip_takes_the_redo():
    """tests/test_evaluator.py:156: every winner in one window, k = 100, so
    the peel's completeness check trips on the dot path and on the scores
    path; the redone rows keep the metrics exact (JAX's scores path as the
    reference)."""
    splits = make_synthetic_splits(n_users=32, n_items=32768,
                                   n_interactions=2000, seed=11,
                                   with_features=False)
    jval = splits["val"]
    rng = np.random.default_rng(4)
    u_mat = np.abs(rng.standard_normal((32, 8))).astype(np.float32)
    items = np.zeros((jval.n_items_in_split, 8), np.float32)
    items[256:384] = np.abs(rng.standard_normal((128, 8))) + 5.0
    conf = dict(top_k=[10, 100])
    want = jax_evaluate_model(
        lambda u: jnp.asarray(u_mat)[u] @ jnp.asarray(items).T,
        JaxEvaluator(JaxEvalConfig(**conf), jval, evaluator_name="val"),
        batch_size=16)

    tval = _port_split(jval)
    tdata = tval.to_device("cpu")
    u_t, items_t = torch.as_tensor(u_mat), torch.as_tensor(items)

    def score_fn(u):
        return u_t[u.long()] @ items_t.T

    def dot_fn(u):
        return score_fn(u)

    dot_fn.dot_parts = (lambda u: u_t[u.long()], items_t)
    for fn in (dot_fn, score_fn):
        ev = FullEvaluator(EvalConfig(**conf), tval, tdata,
                           evaluator_name="val")
        got = evaluate_model(fn, ev, batch_size=16)
        assert sum(ev.redo_rows) > 0 and len(ev.redo_rows) == 2
        _assert_same(got, want, atol=1e-6)


def test_evaluator_refuses_unported_options(slice_):
    with pytest.raises(NotImplementedError, match="queue 1, item 1"):
        _port_evaluator(slice_, dict(score_dtype="bfloat16"))
    with pytest.raises(ValueError, match="topk_method"):
        _port_evaluator(slice_, dict(topk_method="approx"))
    with pytest.raises(NotImplementedError, match="item 10"):
        FullEvaluator(EvalConfig(), slice_["tval"], slice_["tdata"],
                      mesh=object())
    feats = slice_["tval"].user_features
    feats["age"] = FeatureTable(np.zeros((N_USERS, 2), np.float32),
                                "numeric")
    try:
        with pytest.raises(ValueError, match="not categorical"):
            _port_evaluator(slice_, dict(group_metrics=["age"]))
    finally:
        del feats["age"]


def test_users_in_split_follow_the_split_type():
    ts = make_synthetic_splits(n_users=40, n_items=60, n_interactions=600,
                               seed=3, with_features=False)
    for split_type in ("random", "cold_start_user"):
        jds = ts["val"]
        port = RecDataset(split_set="val", n_users=40, n_items=60,
                          interactions=jds.interactions,
                          train_interactions=jds.train_interactions,
                          split_type=split_type)
        want = (np.arange(40) if split_type == "random"
                else np.unique(jds.interactions[:, 0]))
        np.testing.assert_array_equal(port.users_in_split, want)
        np.testing.assert_array_equal(
            port.to_device("cpu").users_in_split.numpy(), want)


# ------------------------------------------------------------------- fit
def _trainer(tmp_path=None, top_k=(5, 10), **learn):
    _, ts = _both(n_users=120, n_items=300, n_interactions=3000)
    train, val = ts["train"], ts["val"]
    data = train.to_device("cpu")
    model = SingleBranchNet.build_from_conf(_narrow_conf(), train, data,
                                            seed=1)
    learn = LearningConfig(**{"optimizer": "adam", "lr": 3e-3,
                              "max_batches_per_epoch": 2, **learn})
    ev = FullEvaluator(EvalConfig(top_k=list(top_k)), val, device="cpu",
                       evaluator_name="val")
    logs = []
    trainer = Trainer(model, train, learn, DatasetConfig(), batch_size=64,
                      device_data=data, val_evaluator=ev,
                      eval_batch_size=64, log_fn=logs.append,
                      results_path=None if tmp_path is None
                      else str(tmp_path))
    return trainer, logs


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_fit_scripted_patience_best_state_and_save_load(tmp_path):
    trainer, logs = _trainer(tmp_path, n_epochs=10, max_patience=2)
    values = iter([0.1, 0.3, 0.2, 0.3, 0.9])  # initial, then per epoch
    trainer.validate = lambda: {"val/ndcg@10": next(values)}
    states = []
    real_epoch = trainer.train_epoch

    def epoch():
        out = real_epoch()
        bn = next(m for m in trainer.model.modules()
                  if hasattr(m, "running_var"))
        bn.running_var.add_(1.0)  # a buffer moves too
        states.append(_state(trainer.model))
        return out

    trainer.train_epoch = epoch
    best = trainer.fit()
    # 0.3 at epoch 0 is best; 0.2 and the equal 0.3 are not strictly
    # better, so patience 2 stops after epoch 2 and 0.9 is never seen
    assert best == {"val/ndcg@10": 0.3}
    assert trainer.best_epoch == 0 and trainer.best_value == 0.3
    assert [r["epoch"] for r in logs] == [-1, 0, 1, 2]
    assert len(states) == 3
    assert any(not torch.equal(v, states[2][k])
               for k, v in states[0].items())
    for key, v in _state(trainer.model).items():
        assert torch.equal(v, states[0][key]), key

    fresh, _ = _trainer()
    fresh.load(str(tmp_path))
    for key, v in _state(fresh.model).items():
        assert torch.equal(v, states[0][key]), key


def test_fit_refuses_a_metric_the_evaluator_does_not_produce():
    trainer, _ = _trainer(top_k=(5,), optimizing_metric="ndcg@10")
    with pytest.raises(ValueError, match="optimizing metric"):
        trainer.fit()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trainer.save_checkpoint("unused")


def test_fit_on_real_validations_restores_the_best_state():
    trainer, logs = _trainer(n_epochs=2)
    best = trainer.fit()
    assert [r["epoch"] for r in logs][:2] == [-1, 0]
    assert all(np.isfinite(v) for v in best.values())
    assert set(best) == set(logs[0]) - {"epoch"}
    assert trainer.validate() == best  # the best state is back, exactly


def test_chip_smoke_eval_conf_matches_yaml():
    resolved = get_config(os.path.join(ROOT, CONF))
    smoke = _chip_smoke()
    assert smoke.EVAL_CONF == dataclasses.asdict(resolved.eval)
    ev = config_from_dict(EvalConfig, smoke.EVAL_CONF)
    assert dataclasses.asdict(ev) == smoke.EVAL_CONF
