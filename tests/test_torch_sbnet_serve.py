"""The port's serving slice against the JAX package, on the CPU: synthetic
data and device data bit-equal, SBNet representations with transplanted
weights within rtol = 1e-4 / atol = 1e-5 (f32, different summation orders),
and the `Recommender`'s lists equal up to ties (scores within 1e-5)."""
import copy
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sibrar_tpu.config.loader import get_config
from sibrar_tpu.data.synthetic import make_onion_scale_splits as jax_splits
from sibrar_tpu.models import layers as jlayers
from sibrar_tpu.models.base import init_model_abstract
from sibrar_tpu.models.sbnet import SingleBranchNet as JaxSBNet
from sibrar_tpu.serve import Recommender as JaxRecommender
from sibrar_tpu_torch.data.dataset import make_splits
from sibrar_tpu_torch.data.synthetic import make_onion_scale_splits
from sibrar_tpu_torch.models.layers import InteractionTower
from sibrar_tpu_torch.models.sbnet import SingleBranchNet
from sibrar_tpu_torch.models.transplant import transplant
from sibrar_tpu_torch.serve import Recommender
from sibrar_tpu_torch.train.scoring import make_score_fn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = "conf/single/sbnet_onion18_huge_no-user.yml"
FEATURES = {"ivec256": 16, "bert": 24, "musicnn": 8}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _narrow_conf(id_embeddings: bool = False):
    """The main path's model dict at narrow widths. ``id_embeddings`` swaps
    in the id-embedding towers: a plain ``user_embedding`` user tower, an
    ``item_embedding`` item modality, max aggregation and one batch norm
    after the last branch layer."""
    conf = copy.deepcopy(_chip_smoke().MODEL_CONF)
    conf["shared_common_dim"] = 8
    conf["user"]["embedding_dim"] = 8
    conf["item"]["common_modality_dim"] = 16
    conf["item"]["single_branch_hidden_layers"] = [16, 16, 8, 8]
    if id_embeddings:
        conf["user"]["feature_name"] = "user_embedding"
        conf["item"]["features"].append({"feature_name": "item_embedding"})
        conf["item"]["aggregation_fn"] = "max"
        conf["item"]["apply_batch_norm_every"] = 0
    return conf


def _both(**kw):
    kw = dict(n_clusters=8, seed=7, feature_dims=FEATURES, **kw)
    return jax_splits(**kw), make_splits(make_onion_scale_splits(**kw))


def _models(jsplits, tsplits, conf):
    """JAX model + variables (every parameter and batch-norm statistic drawn
    from a seeded numpy rng) and the port's model with them transplanted."""
    jtrain = jsplits["train"]
    jm = JaxSBNet.build_from_conf(conf, jtrain, jtrain.to_device())
    shaped = init_model_abstract(jm, jax.random.PRNGKey(0),
                                 jtrain.to_device())
    rng = np.random.default_rng(1)

    def draw(path, leaf):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        scale = 1.0 / np.sqrt(leaf.shape[0]) if name == "kernel" else 0.1
        return rng.normal(0.0, scale, leaf.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shaped["params"])
    stats = jax.tree_util.tree_map_with_path(draw, shaped["batch_stats"])
    variables = {**shaped, "params": params, "batch_stats": stats}
    ttrain = tsplits["train"]
    tm = SingleBranchNet.build_from_conf(conf, ttrain,
                                      ttrain.to_device("cpu"))
    transplant(tm, {"params": params, "batch_stats": stats})
    return jm, variables, tm


def test_synthetic_arrays_and_device_data_match_jax():
    js, ts = _both(n_users=300, n_items=400, n_interactions=8000)
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(ts[split].interactions,
                                      js[split].interactions)
    for name in FEATURES:
        np.testing.assert_array_equal(ts["test"].item_features[name].table,
                                      js["test"].item_features[name].table)
    jg, tg = js["test"].item_features["genres"], ts["test"].item_features[
        "genres"]
    assert tg.n_categories == jg.padding_idx == len(jg.unique_values)
    assert [set(r) for r in tg.table.tolist()] == [
        set(r) for r in jg.table.tolist()]
    for split in ("val", "test"):
        jd, td = js[split].to_device(), ts[split].to_device("cpu")
        np.testing.assert_array_equal(td.catalog.numpy(),
                                      np.asarray(jd.catalog))
        for field in ("exclude_csr", "user_inter_csr", "item_inter_csr"):
            jc, tc = getattr(jd, field), getattr(td, field)
            np.testing.assert_array_equal(tc.indptr.numpy(),
                                          np.asarray(jc.indptr))
            np.testing.assert_array_equal(tc.indices.numpy(),
                                          np.asarray(jc.indices))
            assert (tc.n_rows, tc.n_cols, tc.max_row_len) == (
                jc.n_rows, jc.n_cols, jc.max_row_len)
        for name, table in td.item_features.items():
            np.testing.assert_array_equal(table.numpy(),
                                          np.asarray(jd.item_features[name]))


def test_chip_smoke_model_conf_matches_yaml():
    resolved = get_config(os.path.join(ROOT, CONF)).model
    assert _chip_smoke().MODEL_CONF == resolved


@pytest.mark.parametrize("first_layer", ["dense", "bag", "id_embeddings"])
def test_sbnet_reprs_match_jax_with_transplanted_weights(first_layer,
                                                         monkeypatch):
    js, ts = _both(n_users=300, n_items=400, n_interactions=8000)
    if first_layer == "bag":  # both towers gather kernel rows instead
        monkeypatch.setattr(jlayers, "BAG_BREAK_EVEN_FACTOR", 0)
    ids = first_layer == "id_embeddings"
    jm, variables, tm = _models(js, ts, _narrow_conf(id_embeddings=ids))
    towers = [m for m in tm.modules() if isinstance(m, InteractionTower)]
    assert len(towers) == 1 + (not ids)
    for tower in towers:
        tower.bag_break_even_factor = (0 if first_layer == "bag"
                                       else jlayers.BAG_BREAK_EVEN_FACTOR)
        assert tower.use_bag(64) == (first_layer == "bag")
    users = np.arange(300, dtype=np.int32)
    items = np.arange(400, dtype=np.int32).reshape(20, 20)  # 2-D batch too
    ju = jm.apply(variables, jnp.asarray(users), method=jm.user_repr)
    ji = jm.apply(variables, jnp.asarray(items), method=jm.item_repr)
    with torch.no_grad():
        tu = tm.user_repr(torch.as_tensor(users))
        ti = tm.item_repr(torch.as_tensor(items))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("n_items,exclude_seen", [(4096, True),
                                                   (4096, False),
                                                   (400, True)])
def test_recommender_matches_jax(n_items, exclude_seen):
    """JAX Recommender (CPU: scatter + top-k) against the port's (CPU: plain
    kernels; the fused dot / peel path at 4096 items, scatter + top-k at
    400, where peeling is not viable), with request padding."""
    js, ts = _both(n_users=300, n_items=n_items, n_interactions=3000)
    jm, variables, tm = _models(js, ts, _narrow_conf())
    jtest, ttest = js["test"], ts["test"]
    jdata = jtest.to_device()
    i_repr = jm.apply(variables, jdata.catalog, method=jm.item_repr)

    def jax_user(u):
        return jm.apply(variables, u, method=jm.user_repr)

    def jax_score(u):
        return jax_user(u) @ i_repr.T

    k, users = 10, np.arange(150)
    jrec = JaxRecommender(jax_score, jtest, jdata, k=k, batch_size=64,
                          exclude_seen=exclude_seen)
    jids, jv = jrec.recommend(users, return_scores=True)

    tdata = ttest.to_device("cpu")
    score_fn = make_score_fn(tm, tdata.catalog, item_chunk=1000)  # padded
    np.testing.assert_allclose(score_fn.items.numpy(), np.asarray(i_repr),
                               rtol=1e-4, atol=1e-5)
    trec = Recommender(score_fn, ttest, tdata, k=k, batch_size=64,
                       exclude_seen=exclude_seen)
    assert trec.use_dot == (n_items == 4096)
    tids, tv = trec.recommend(users, return_scores=True)
    assert tids.shape == jids.shape == (150, k)
    # 150 users padded to 3 batches of 64; the peel records each batch
    assert len(trec.redo_rows) == (3 if trec.use_dot else 0)

    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
    scores = np.asarray(jax_score(jnp.asarray(users, jnp.int32)))
    np.testing.assert_allclose(  # index sets equal up to ties
        np.take_along_axis(scores, tids, 1), jv, rtol=1e-5, atol=1e-5)
    excl = jtest.exclude_matrix().tocsr()
    seen = np.asarray(excl[np.repeat(users, k), tids.reshape(-1)])
    if exclude_seen:  # train + val items are never returned
        assert not seen.any()
    assert all(len(set(r)) == k for r in tids.tolist())


BLOCKED_SLICE = r"""
import sys
for name in ("jax", "flax", "optax", "yaml", "pandas", "sibrar_tpu"):
    sys.modules[name] = None  # any import of these now fails
import copy, numpy as np, torch
import sibrar_tpu_torch
from sibrar_tpu_torch.data.dataset import make_splits
from sibrar_tpu_torch.data.synthetic import make_onion_scale_splits
from sibrar_tpu_torch.models.sbnet import SingleBranchNet
from sibrar_tpu_torch.serve import Recommender
from sibrar_tpu_torch.train.scoring import make_score_fn
from sibrar_tpu_torch.data import sampling
from sibrar_tpu_torch.eval import metrics
from sibrar_tpu_torch.eval.evaluator import FullEvaluator, evaluate_model
from sibrar_tpu_torch.ops import (dw, gemm_probe, mask, peel, roll, spmm,
                                  topk, window)
from sibrar_tpu_torch.tools import (probe_gemm_bisect, probe_gemm_precision,
                                    probe_gemm_variants, probe_pred_input,
                                    probe_roll)
from sibrar_tpu_torch.train import losses
from sibrar_tpu_torch.train.trainer import (DatasetConfig, EvalConfig,
                                            LearningConfig, Trainer)
conf = copy.deepcopy(MODEL_CONF)
conf["shared_common_dim"] = 8
conf["user"]["embedding_dim"] = 8
conf["item"]["common_modality_dim"] = 16
conf["item"]["single_branch_hidden_layers"] = [16, 8]
splits = make_splits(make_onion_scale_splits(
    n_users=200, n_items=4096, n_interactions=2000, n_clusters=8,
    feature_dims={"ivec256": 8, "bert": 8, "musicnn": 8}))
test = splits["test"]
data = test.to_device("cpu")
model = SingleBranchNet.build_from_conf(conf, test, data, seed=3)
train = splits["train"]
val_ev = FullEvaluator(EvalConfig(top_k=[5, 10]), splits["val"],
                       device="cpu", evaluator_name="val")
trainer = Trainer(model, train, LearningConfig(max_batches_per_epoch=2),
                  DatasetConfig(), batch_size=64,
                  device_data=train.to_device("cpu"), val_evaluator=val_ev,
                  eval_batch_size=64)
assert np.isfinite(trainer.train_epoch()["train/loss"])
val = trainer.validate()
assert len(val) == 2 * 6 * 2 + 2 and all(np.isfinite(list(val.values())))
assert val_ev.redo_rows  # the dot path ran: it records each batch's redo

rec = Recommender(make_score_fn(model, data.catalog), test, data, k=5,
                  batch_size=32)
assert rec.use_dot
ids = rec.recommend(np.arange(70))
assert ids.shape == (70, 5)
excl = test.exclude_matrix().tocsr()
assert not np.asarray(excl[np.repeat(np.arange(70), 5), ids.reshape(-1)]).any()
assert probe_roll.PROBES["segment"]("cpu")
assert probe_pred_input.try_mask("int8", device="cpu")
probe_gemm_bisect.main(["wmax_lanes", "1024", "--device", "cpu"])
loaded = [m for m in ("jax", "flax", "optax", "yaml", "pandas", "sibrar_tpu")
          if sys.modules.get(m) is not None]
assert not loaded, loaded
print("slice ok")
"""


def test_port_runs_the_slice_without_jax_yaml_pandas():
    conf = repr(_chip_smoke().MODEL_CONF)
    proc = subprocess.run(
        [sys.executable, "-c", f"MODEL_CONF = {conf}\n" + BLOCKED_SLICE],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "slice ok" in proc.stdout
