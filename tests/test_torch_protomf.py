"""The port's ProtoMF family against the JAX package, on the CPU: the six
variants with the same (numpy-drawn) weights in both packages (the train
forward's logits, each regularizer by JAX's name, every gradient, catalog
scores and dot parts; rtol 1e-5, atol 1e-6), ``jnp.clip``'s and ``min``'s
gradients at ties, the initializers, the registry, ``protomf_post_val``
against JAX's (keys, values within 1e-6, the report's items), and the CLI
with serving from its run directory. Helpers for ``test_torch_ecf.py``
and ``test_torch_gather_combine.py`` live here."""
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sibrar_tpu.eval import explanations as jexpl
from sibrar_tpu.models import protomf as jproto
from sibrar_tpu_torch.config.schema import EvalConfig
from sibrar_tpu_torch.data.synthetic import (
    make_synthetic_splits,
    write_reference_artifacts,
)
from sibrar_tpu_torch.eval import explanations as texpl
from sibrar_tpu_torch.models import layers as tlayers
from sibrar_tpu_torch.models import protomf as tproto
from sibrar_tpu_torch.run_experiment import main as run_experiment
from sibrar_tpu_torch.train.row_adam import find_sparse_tables
from test_torch_dmf import (
    CLI_BASE,
    F32,
    N_ITEMS,
    N_USERS,
    check_catalog,
    check_registry,
    check_served,
    check_train_forward,
    inputs,
    models,
    one_torch_thread,  # noqa: F401 (autouse fixture)
)
from test_torch_sbnet_serve import _chip_smoke

CONFS = {
    "uprotomf": {"embedding_dim": 6, "n_prototypes": 4,
                 "sim_proto_weight": 0.7, "sim_batch_weight": 1.3},
    "iprotomf": {"embedding_dim": 6, "n_prototypes": 4,
                 "sim_batch_weight": 0.5},
    "uiprotomf": {"embedding_dim": 6, "u_n_prototypes": 4,
                  "i_n_prototypes": 3, "u_sim_proto_weight": 0.7,
                  "i_sim_batch_weight": 0.4},
    "uprotomfs": {"embedding_dim": 6, "n_prototypes": 4},
    "iprotomfs": {"embedding_dim": 6, "n_prototypes": 4},
    "uiprotomfs": {"embedding_dim": 6, "u_n_prototypes": 4,
                   "i_n_prototypes": 3},
}
CLASSES = {"uprotomf": tproto.UProtoMF, "iprotomf": tproto.IProtoMF,
           "uiprotomf": tproto.UIProtoMF, "uprotomfs": tproto.UProtoMFs,
           "iprotomfs": tproto.IProtoMFs, "uiprotomfs": tproto.UIProtoMFs}
LOSSES = {"uprotomf": {"proto_loss", "batch_loss"},
          "iprotomf": {"proto_loss", "batch_loss"},
          "uiprotomf": {"user_proto_loss", "user_batch_loss",
                        "item_proto_loss", "item_batch_loss"}}


def check_losses(jm, variables, tm, users, items):
    """Each loss the JAX model sows in its train forward against the
    port's `forward_losses` dict, by name; returns the port's dict."""
    _, aux = jm.apply(variables, jnp.asarray(users), jnp.asarray(items),
                      train=True, mutable=["losses"])
    want = {k: float(v[0]) for k, v in aux.get("losses", {}).items()}
    tm.train()
    _, got = tm.forward_losses(torch.as_tensor(users), torch.as_tensor(items))
    tm.eval()
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].item(), value, **F32,
                                   err_msg=key)
    return got


@pytest.mark.parametrize("name", sorted(CONFS))
def test_protomf_train_forward_losses_and_grads_match_flax(name):
    jm, variables, tm = models(name, CONFS[name])
    reg, grads = check_train_forward(jm, variables, tm)
    losses = check_losses(jm, variables, tm, *inputs())
    assert set(losses) == LOSSES.get(name, set())
    assert (reg > 0) == name.endswith("protomf")
    assert all(g.any() for g in grads)  # every parameter trains


@pytest.mark.parametrize("name", sorted(CONFS))
def test_protomf_catalog_scores_and_dot_parts_match_flax(name):
    jm, variables, tm = models(name, CONFS[name])
    if name == "uiprotomfs":  # JAX gives it no dot parts: the scores path
        users = inputs()[0]
        catalog = jnp.arange(N_ITEMS, dtype=jnp.int32)
        want = jm.apply(variables, jnp.asarray(users), catalog,
                        method=lambda m, u, c: m.combine(m.user_repr(u),
                                                         m.item_repr(c)))
        none = jm.apply(variables, catalog, method=lambda m, c: (
            m.eval_rank_dot_parts(m.user_repr, m.item_repr(c)) is None))
        score_fn = tproto_score_fn(tm)
        assert none and score_fn.dot_parts is None
        np.testing.assert_allclose(score_fn(torch.as_tensor(users)).numpy(),
                                   np.asarray(want), **F32)
        return
    scores, dots = check_catalog(jm, variables, tm)
    np.testing.assert_allclose(scores.numpy(), dots.numpy(), **F32)


def tproto_score_fn(tm):
    from sibrar_tpu_torch.train.scoring import make_score_fn

    return make_score_fn(tm, torch.arange(N_ITEMS, dtype=torch.int32),
                         item_chunk=16)


def test_clip_and_cosine_pass_half_the_gradient_at_a_bound():
    """``layers.clip`` against ``jnp.clip`` (``torch.clamp`` would give
    1 at the bounds), and `cosine_sim` of a matrix with itself whose rows
    are unit vectors (self-cosine exactly 1.0) against JAX's gradient."""
    x = np.array([1.0, 0.5, 1.5, -1.0], np.float32)
    jg = jax.grad(lambda v: jnp.clip(v, -1.0, 1.0).sum())(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    tlayers.clip(t, -1.0, 1.0).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(t.grad.numpy(), [0.5, 1.0, 0.0, 0.5])

    rng = np.random.default_rng(0)
    c = rng.normal(size=(5, 6)).astype(np.float32)
    c[0] = [1, 0, 0, 0, 0, 0]  # norm and self-dot exactly 1
    c[3] = [0, 0, 0, -1, 0, 0]
    w = rng.normal(size=(5, 5)).astype(np.float32)
    for jfn, tfn in ((jproto.cosine_sim, tproto.cosine_sim),
                     (jproto.shifted_cosine_sim, tproto.shifted_cosine_sim)):
        jval, jgrad = jax.value_and_grad(
            lambda v: (jfn(v, v) * w).sum())(jnp.asarray(c))
        t = torch.tensor(c, requires_grad=True)
        out = (tfn(t, t) * torch.as_tensor(w)).sum()
        out.backward()
        np.testing.assert_allclose(out.item(), float(jval), **F32)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), **F32)
    assert float(tproto.cosine_sim(torch.tensor(c[:1]),
                                   torch.tensor(c[:1]))) == 1.0


def test_proto_reg_splits_the_minimum_gradient_among_tied_rows():
    """A batch that repeats a user gives tied rows: JAX's ``min`` and the
    port's ``amin`` split the gradient between them."""
    rng = np.random.default_rng(1)
    sim = rng.random((5, 3)).astype(np.float32)
    sim[3] = sim[1]  # the same user twice
    sim[4, 2] = sim[4, 0]  # a tie along the prototypes

    def jloss(s):
        a, b = jproto._proto_reg(s, 3)
        return 2.0 * a + 3.0 * b

    jg = jax.grad(jloss)(jnp.asarray(sim))
    t = torch.tensor(sim, requires_grad=True)
    a, b = tproto._proto_reg(t, 3)
    (2.0 * a + 3.0 * b).backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), **F32)
    np.testing.assert_allclose(a.item(), float(jproto._proto_reg(
        jnp.asarray(sim), 3)[0]), **F32)
    assert t.grad[1].abs().sum() > 0 and torch.equal(t.grad[1], t.grad[3])


def test_initializers_draw_jax_distributions():
    """``_proto_init`` N(0, 0.1 / dim) (the scale, not its root) and
    ``_pos_weight_init`` in 0.5 +- 2 * 0.1 / P, both packages."""
    dim, p = 50, 20
    jp = np.asarray(jproto._proto_init(jax.random.PRNGKey(0), (4000, dim)))
    tp = tproto._proto_init(4000, dim, torch.Generator().manual_seed(0))
    for arr in (jp, tp.detach().numpy()):
        assert abs(arr.std() - 0.1 / dim) < 0.05 * 0.1 / dim
    jw = np.asarray(jproto._pos_weight_init(jax.random.PRNGKey(1),
                                            (4000, p)))
    tw = torch.empty(4000, p)
    tproto._pos_weight_init(tw, torch.Generator().manual_seed(1))
    for arr in (jw, tw.numpy()):
        dev = np.abs(arr - 0.5)
        assert dev.max() <= 2 * 0.1 / p + 1e-6 and dev.max() > 0.9 * 0.2 / p
        assert abs(arr.mean() - 0.5) < 1e-3


@pytest.mark.parametrize("name", sorted(CONFS))
def test_registry_builds_protomf_on_the_data_device(name):
    # tables of 8 columns: narrower ones stay dense in any model
    model = check_registry(name, {**CONFS[name], "embedding_dim": 8,
                                  "n_prototypes": 8, "u_n_prototypes": 8,
                                  "i_n_prototypes": 8}, CLASSES[name])
    weight_side = {"uprotomfs": "item_embed", "iprotomfs": "user_embed"}
    sparse = find_sparse_tables(model, 1)
    assert sparse == {k: v for k, v in {"user_embed": "user",
                                        "item_embed": "item"}.items()
                      if k != weight_side.get(name)}
    if name in weight_side:  # relu'd weights around 0.5
        w = getattr(model, weight_side[name]).weight
        assert float((w.detach() - 0.5).abs().max()) <= 0.2 / 8 + 1e-6


@pytest.mark.parametrize("name,entity", [("uprotomf", "user"),
                                         ("iprotomfs", "item"),
                                         ("uiprotomf", "user"),
                                         ("uiprotomf", "item")])
def test_protomf_post_val_matches_jax(name, entity, tmp_path):
    """The same weights' diagnostics in both packages: key sets, values
    within 1e-6, the item report's ``item_idx`` columns equal; the weight
    side of a model gives ``{}`` in both."""
    jm, variables, tm = models(name, CONFS[name])
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jexpl.protomf_post_val(params, entity, 3, results_dir=jdir)
    got = texpl.protomf_post_val(tm, entity, 3, results_dir=tdir)
    assert set(got) == set(want) and got
    for key, value in want.items():
        if isinstance(value, str):  # a file in the results directory
            assert os.path.basename(got[key]) == os.path.basename(value)
        else:
            np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-6,
                                       err_msg=key)
    if entity == "item":
        cols = []
        for path in (want["item_proto_top_items"],
                     got["item_proto_top_items"]):
            with open(path) as fh:
                cols.append([r["item_idx"] for r in csv.DictReader(fh)])
        assert cols[0] == cols[1] and len(cols[0]) == 10 * len(
            tm.prototypes if name != "uiprotomf" else tm.i_prototypes)
    other = {"user": "item", "item": "user"}[entity]
    if name != "uiprotomf":
        assert jexpl.protomf_post_val(params, other, 3) == {}
        assert texpl.protomf_post_val(tm, other, 3) == {}


def test_prototype_top_items_matches_jax():
    import pandas as pd

    rng = np.random.default_rng(3)
    w = rng.random((20, 3)).astype(np.float32)
    info = pd.DataFrame({"item_idx": [0, 1, 2, 2, 5, 19],
                         "title": list("abcdef")})
    for kw in ({}, {"invert": True}, {"item_info": info, "top_k": 7}):
        assert (texpl.prototype_top_items(w, 1, **kw) ==
                jexpl.prototype_top_items(w, 1, **kw))
    assert (texpl.prototype_top_items_report(w, top_k=4) ==
            jexpl.prototype_top_items_report(w, top_k=4))
    with pytest.raises(ValueError, match="out of range"):
        texpl.prototype_top_items(w, 3)


# ------------------------------------------------- the CLI and serving
def cli_train_val(root, name, model_conf, item_features=()):
    """The port's CLI ``-t train_val`` (in this process) on synthetic
    artifacts, ``item_features`` added to the dataset block; returns the
    run directory and the metrics after checking ``metrics_val.yml``
    against them and their keys against JAX's (plus, for ProtoMF, the
    post-validation keys)."""
    art, res = str(root / "data"), str(root / "run")
    write_reference_artifacts(art, make_synthetic_splits(
        n_users=N_USERS, n_items=N_ITEMS, n_interactions=600, seed=5))
    base = {**CLI_BASE, "dataset": {
        **CLI_BASE["dataset"],
        "item_features": [*CLI_BASE["dataset"]["item_features"],
                          *item_features]}}
    conf_path = str(root / "conf.yml")
    with open(conf_path, "w") as fh:
        yaml.safe_dump({**base, "model": model_conf, "results_path": res},
                       fh)
    metrics = run_experiment(["-a", name, "-d", art, "-t", "train_val",
                              "-c", conf_path])
    with open(os.path.join(res, "metrics_val.yml")) as fh:
        assert yaml.safe_load(fh) == metrics
    keys = _chip_smoke().expected_keys(EvalConfig(**CLI_BASE["eval"]), "val")
    assert keys <= set(metrics)
    assert all(np.isfinite(metrics[k]) for k in keys)
    assert {"conf.yml", "metrics_val.yml", "model.pt"} <= set(
        os.listdir(res))
    return res, {k: v for k, v in metrics.items() if k not in keys}


@pytest.mark.parametrize("name", ["uiprotomf", "iprotomfs"])
def test_cli_train_val_and_serving_run_protomf(name, tmp_path, monkeypatch):
    """The tuple representations (``uiprotomf``) and the weight side
    (``iprotomfs``) through the CLI: after each epoch's validation the
    post-validation diagnostics with JAX's keys and their files in the
    run directory (among the best metrics when a trained epoch was best),
    then `Recommender.from_run_dir`'s lists."""
    from sibrar_tpu_torch import experiment

    records, make = [], experiment._post_val_fn

    def recorded(conf, results_path):
        fn = make(conf, results_path)
        return lambda model, epoch: records.append(fn(model, epoch)) or \
            records[-1]

    monkeypatch.setattr(experiment, "_post_val_fn", recorded)
    run, extra = cli_train_val(tmp_path, name, CONFS[name])
    entities = ("user", "item") if name == "uiprotomf" else ("item",)
    stats = {f"{e}_proto_{s}" for e in entities for s in (
        "sim_mean", "sim_max_mean", "sim_min_mean", "utilization_entropy",
        "dead_fraction")}
    files = {f"{e}_tsne_plot" for e in entities} | {"item_proto_top_items"}
    assert len(records) == CLI_BASE["learn"]["n_epochs"]
    for out in records:
        assert set(out) == stats | files
        assert all(os.path.exists(out[k]) for k in files)
    assert extra in ({}, records[0], records[1])
    check_served(run)
