"""The port's interaction tower options and DMF against the JAX package, on
the CPU.

The tower's ``normalize`` and ``scale`` on the bag, dense and
``INTERACTION_SPMM`` paths (JAX's Pallas ``dw_matmul`` and ``spmm_onehot``
in interpret mode; the port's K5 / K6 / K7 plain versions), forward and
every gradient, and its torch-default init; DMF with the same (numpy-drawn)
weights in both packages: the train forward's logits, every parameter's
gradient, catalog scores and the dot-ranking parts. Tolerances rtol 1e-5,
atol 1e-6 (f32, sums in other orders). Then the registry, the CLI, serving
from the run directory and a toy trained floor; the helpers here serve
``test_torch_feat_mf.py`` and ``test_torch_dropoutnet.py`` too."""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
import yaml

from sibrar_tpu.config.loader import get_config as jax_get_config
from sibrar_tpu.data.synthetic import make_synthetic_splits as jax_splits
from sibrar_tpu.models import layers as jlayers
from sibrar_tpu.models.base import collect_reg_loss, init_model_abstract
from sibrar_tpu.models.registry import get_algorithm as jax_get_algorithm
from sibrar_tpu.ops.sparse import DeviceCSR as JaxCSR
from sibrar_tpu_torch.config.loader import get_config
from sibrar_tpu_torch.config.schema import DatasetConfig, EvalConfig, \
    LearningConfig
from sibrar_tpu_torch.data.synthetic import (
    make_synthetic_splits,
    write_reference_artifacts,
)
from sibrar_tpu_torch.eval.evaluator import FullEvaluator
from sibrar_tpu_torch.models import layers as tlayers
from sibrar_tpu_torch.models.dmf import DeepMatrixFactorization
from sibrar_tpu_torch.models.registry import get_algorithm
from sibrar_tpu_torch.models.transplant import _pairs, transplant
from sibrar_tpu_torch.ops.sparse import DeviceCSR
from sibrar_tpu_torch.run_experiment import main as run_experiment
from sibrar_tpu_torch.serve import Recommender
from sibrar_tpu_torch.train.scoring import make_score_fn
from sibrar_tpu_torch.train.trainer import Trainer
from test_torch_sbnet_serve import ROOT, _chip_smoke

F32 = dict(rtol=1e-5, atol=1e-6)
N_USERS, N_ITEMS, B, N = 30, 40, 6, 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: beside other test workers, torch's
    spinning threads made the toy trainings' CPU ``index_add_`` ~100x
    slower (18 s against 0.2 s for one floor run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------- the tower
def _towers(normalize, torch_default_init=False, layer_sizes=(16, 8),
            n_rows=12, n_cols=64, nnz=10, seed=0):
    """JAX's tower with its tables and the port's over the same CSR, the
    JAX parameters drawn from a numpy rng and transplanted."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n_rows), nnz)
    cols = np.concatenate([rng.choice(n_cols, nnz, replace=False)
                           for _ in range(n_rows)])
    keep = rng.random(len(rows)) > 0.3  # ragged rows, one of them empty
    keep[rows == 2] = False
    mat = sp.csr_matrix((np.ones(keep.sum()), (rows[keep], cols[keep])),
                        shape=(n_rows, n_cols))
    jcsr = JaxCSR.from_scipy(mat)
    jt = jlayers.InteractionTower(
        entity="user", n_rows=n_rows, n_cols=n_cols,
        max_row_len=jcsr.max_row_len, nnz=jcsr.nnz,
        layer_sizes=tuple(layer_sizes), normalize=normalize,
        torch_default_init=torch_default_init)
    tables = {"user__inter_indptr": jcsr.indptr,
              "user__inter_indices": jcsr.indices}
    shaped = jt.init(jax.random.PRNGKey(0), jnp.zeros((2,), jnp.int32))
    params = jax.tree_util.tree_map(
        lambda p: rng.normal(0.0, 0.3, p.shape).astype(np.float32),
        shaped["params"])
    tt = tlayers.InteractionTower(
        DeviceCSR.from_scipy(mat, "cpu"), list(layer_sizes),
        torch.Generator().manual_seed(0), normalize=normalize,
        torch_default_init=torch_default_init)
    _put_tower(tt, params)
    return jt, tables, params, tt


def _put_tower(tt, p):
    with torch.no_grad():
        tt.kernel.copy_(torch.as_tensor(np.asarray(p["kernel"])))
        tt.bias.copy_(torch.as_tensor(np.asarray(p["bias"])))
        for i, lin in enumerate(tt.rest.linears):
            q = p["rest"][f"linear_{i}"]
            lin.weight.copy_(torch.as_tensor(np.asarray(q["kernel"]).T))
            lin.bias.copy_(torch.as_tensor(np.asarray(q["bias"])))


@pytest.mark.parametrize("path", ["bag", "dense", "spmm"])
@pytest.mark.parametrize("normalize,scaled", [(False, True), (True, False),
                                              (True, True)])
def test_tower_normalize_and_scale_match_jax(path, normalize, scaled,
                                             monkeypatch):
    """Forward and every gradient of ``sum(out * w)`` on each first-layer
    path, with ``normalize`` (rows of 0-10 entries, one empty) and a random
    per-row ``scale`` (zeros among them: DropoutNet's dropped rows)."""
    jt, tables, params, tt = _towers(normalize)
    if path == "bag":
        monkeypatch.setattr(jlayers, "BAG_BREAK_EVEN_FACTOR", 0)
        tt.bag_break_even_factor = 0
    elif path == "spmm":
        monkeypatch.setattr(jlayers, "INTERACTION_SPMM", "interpret")
        monkeypatch.setattr(tlayers, "INTERACTION_SPMM", True)
    else:
        monkeypatch.setattr(jlayers, "DW_KERNEL", "interpret")
    assert tt.use_bag(5) == (path == "bag")
    rng = np.random.default_rng(1)
    idxs = np.array([[0, 2, 5], [7, 2, 11]], np.int32)
    scale = None
    if scaled:
        scale = rng.random(idxs.shape + (1,)).astype(np.float32)
        scale[0, 1] = 0.0
    w = rng.normal(size=idxs.shape + (8,)).astype(np.float32)

    def loss(p):
        out = jt.apply({"params": p, "tables": tables}, jnp.asarray(idxs),
                       scale=None if scale is None else jnp.asarray(scale))
        return (out * w).sum(), out

    (_, jout), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    out = tt(torch.as_tensor(idxs),
             scale=None if scale is None else torch.as_tensor(scale))
    (out * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **F32)
    np.testing.assert_allclose(tt.kernel.grad.numpy(),
                               np.asarray(jgrads["kernel"]), **F32)
    np.testing.assert_allclose(tt.bias.grad.numpy(),
                               np.asarray(jgrads["bias"]), **F32)
    lin = tt.rest.linears[0]
    np.testing.assert_allclose(lin.weight.grad.numpy(), np.asarray(
        jgrads["rest"]["linear_0"]["kernel"]).T, **F32)
    np.testing.assert_allclose(lin.bias.grad.numpy(), np.asarray(
        jgrads["rest"]["linear_0"]["bias"]), **F32)
    assert np.abs(np.asarray(jout)).max() > 0


def test_tower_torch_default_init_bounds_and_draw_order():
    """``torch_default_init``: kernel and bias in U(+-1/sqrt(n_cols)), the
    rest in U(+-1/sqrt(fan_in)), in both packages, filling their range;
    drawn kernel, bias, rest from the generator. The default init draws
    the kernel (kaiming), then the rest (SBNet's seeded builds keep their
    bits)."""
    n_cols = 4096
    jt, _, _, _ = _towers(False, True, n_cols=n_cols, n_rows=4, nnz=3)
    jparams = jt.init(jax.random.PRNGKey(3),
                      jnp.zeros((2,), jnp.int32))["params"]
    csr = DeviceCSR.from_scipy(sp.csr_matrix((4, n_cols)), "cpu")
    tt = tlayers.InteractionTower(csr, [16, 8], torch.Generator()
                                  .manual_seed(5), torch_default_init=True)
    bound = 1 / math.sqrt(n_cols)
    for j, t in ((jparams["kernel"], tt.kernel), (jparams["bias"], tt.bias)):
        for arr in (np.asarray(j), t.detach().numpy()):
            assert np.abs(arr).max() <= bound
            assert np.abs(arr).max() > 0.8 * bound
    lin = tt.rest.linears[0]
    for arr in (np.asarray(jparams["rest"]["linear_0"]["kernel"]),
                lin.weight.detach().numpy(), lin.bias.detach().numpy()):
        assert 0.5 / 4 < np.abs(arr).max() <= 1 / 4  # fan_in 16
    gen = torch.Generator().manual_seed(5)
    kernel = torch.empty(n_cols, 16).uniform_(-bound, bound, generator=gen)
    bias = torch.empty(16).uniform_(-bound, bound, generator=gen)
    rest = tlayers.PolyLinear([16, 8], gen, torch_default_init=True)
    assert torch.equal(tt.kernel, kernel) and torch.equal(tt.bias, bias)
    assert torch.equal(lin.weight, rest.linears[0].weight)
    default = tlayers.InteractionTower(csr, [16, 8],
                                       torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    kb = math.sqrt(6.0 / n_cols)
    kernel = torch.empty(n_cols, 16).uniform_(-kb, kb, generator=gen)
    rest = tlayers.PolyLinear([16, 8], gen)
    assert torch.equal(default.kernel, kernel) and not default.bias.any()
    assert torch.equal(default.rest.linears[0].weight,
                       rest.linears[0].weight)


# ------------------------------------------------ models against flax
def _both_splits(seed=3, n_interactions=600):
    kw = dict(n_users=N_USERS, n_items=N_ITEMS,
              n_interactions=n_interactions, seed=seed)
    return jax_splits(**kw), make_synthetic_splits(**kw)


def _draw(rng):
    def draw(path, leaf):
        scale = (1.0 / np.sqrt(leaf.shape[0])
                 if path[-1].key == "kernel" else 0.3)
        return rng.normal(0.0, scale, leaf.shape).astype(np.float32)
    return draw


def models(name, conf, seed=3):
    """JAX's model (registry build) and variables with every parameter
    drawn from a seeded numpy rng, and the port's registry build with them
    transplanted, on the same synthetic splits."""
    js, ts = _both_splits(seed)
    jtrain = js["train"]
    jm = jax_get_algorithm(name).build(conf, jtrain, jtrain.to_device())
    shaped = init_model_abstract(jm, jax.random.PRNGKey(0),
                                 jtrain.to_device())
    params = jax.tree_util.tree_map_with_path(
        _draw(np.random.default_rng(1)), shaped["params"])
    variables = {**shaped, "params": params}
    variables.pop("losses", None)
    ttrain = ts["train"]
    tm = get_algorithm(name).build(conf, ttrain, ttrain.to_device("cpu"), 0)
    transplant(tm, {"params": params})
    return jm, variables, tm


def inputs():
    rng = np.random.default_rng(4)
    return (rng.integers(0, N_USERS, B).astype(np.int32),
            rng.integers(0, N_ITEMS, (B, 1 + N)).astype(np.int32))


def check_train_forward(jm, variables, tm, keep=None):
    """Train-mode logits, regularization loss and every gradient of
    ``sum(logits * w) + reg`` against flax; returns ``(reg, grads)`` of the
    port (a parameter without a gradient reads as zeros). ``keep()``, when
    given, returns the port's ``keep=`` after the JAX call."""
    users, items = inputs()
    w = np.random.default_rng(5).normal(size=items.shape).astype(np.float32)
    params = variables["params"]

    def loss_fn(p):
        logits, aux = jm.apply(
            {**variables, "params": p}, jnp.asarray(users),
            jnp.asarray(items), train=True,
            rngs={"sample": jax.random.PRNGKey(1),
                  "dropout": jax.random.PRNGKey(2)},
            mutable=["losses", "batch_stats"])
        reg = collect_reg_loss(aux)
        return (logits * w).sum() + reg, (logits, reg)

    (_, (jlogits, jreg)), jgrads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    tm.train()
    kw = {} if keep is None else {"keep": keep()}
    logits, reg = tm(torch.as_tensor(users), torch.as_tensor(items),
                     gen=torch.Generator().manual_seed(0), **kw)
    ((logits * torch.as_tensor(w)).sum() + reg).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **F32)
    np.testing.assert_allclose(reg.item(), float(jreg), **F32)
    pairs = _pairs(tm, jgrads, None)
    assert len(pairs) == len(list(tm.parameters()))
    grads = []
    for dst, src, transpose in pairs:
        want = np.asarray(src).T if transpose else np.asarray(src)
        got = (dst.grad if dst.grad is not None
               else torch.zeros_like(dst)).numpy()
        np.testing.assert_allclose(got, want, **F32)
        grads.append(got)
    tm.eval()
    return reg.item(), grads


def check_catalog(jm, variables, tm):
    """Eval: catalog scores ``combine(user_repr(u), item_repr(catalog))``
    and the dot-ranking parts, against flax."""
    users, _ = inputs()
    catalog = jnp.arange(N_ITEMS, dtype=jnp.int32)
    want = jm.apply(variables, jnp.asarray(users), catalog,
                    method=lambda m, u, c: m.combine(m.user_repr(u),
                                                     m.item_repr(c)))

    def dot_parts(m, u, c):
        fn, items = m.eval_rank_dot_parts(m.user_repr, m.item_repr(c))
        return fn(u), items

    ju, jitems = jm.apply(variables, jnp.asarray(users), catalog,
                          method=dot_parts)
    score_fn = make_score_fn(tm, torch.arange(N_ITEMS, dtype=torch.int32),
                             item_chunk=16)  # three chunks
    got = score_fn(torch.as_tensor(users))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    u_fn, items = score_fn.dot_parts
    np.testing.assert_allclose(u_fn(torch.as_tensor(users)).numpy(),
                               np.asarray(ju), **F32)
    np.testing.assert_allclose(items.numpy(), np.asarray(jitems), **F32)
    return got, u_fn(torch.as_tensor(users)) @ items.T


DMF_CONFS = {
    "default": {"u_mid_layers": [8], "i_mid_layers": [8],
                "final_dimension": 4},
    "normalized": {"u_mid_layers": [8], "i_mid_layers": [6, 5],
                   "final_dimension": 4, "normalize_interactions": True,
                   "normalize_representations": True,
                   "use_output_activation_fn": True, "mu": 0.05},
}


@pytest.mark.parametrize("path", ["dense", "bag"])
@pytest.mark.parametrize("variant", sorted(DMF_CONFS))
def test_dmf_train_forward_and_grads_match_flax(variant, path, monkeypatch):
    jm, variables, tm = models("dmf", DMF_CONFS[variant])
    if path == "bag":
        monkeypatch.setattr(jlayers, "BAG_BREAK_EVEN_FACTOR", 0)
        for tower in (tm.user_nn, tm.item_nn):
            tower.bag_break_even_factor = 0
    else:
        monkeypatch.setattr(jlayers, "DW_KERNEL", "interpret")
    assert tm.user_nn.use_bag(B) == (path == "bag")
    reg, _ = check_train_forward(jm, variables, tm)
    assert reg == 0.0


@pytest.mark.parametrize("variant", sorted(DMF_CONFS))
def test_dmf_catalog_scores_and_dot_parts_match_flax(variant):
    jm, variables, tm = models("dmf", DMF_CONFS[variant])
    scores, dots = check_catalog(jm, variables, tm)
    mu = DMF_CONFS[variant].get("mu", 1e-6)
    np.testing.assert_allclose(dots.clamp(min=mu).numpy(), scores.numpy(),
                               **F32)  # the dot ranks as the clamped cosine
    assert (scores > mu).any()


# ------------------------------------- registry, CLI, serving, floors
def check_registry(name, conf, cls):
    _, ts = _both_splits()
    train = ts["train"]
    data = train.to_device("cpu")
    model = get_algorithm(name).build(conf, train, data, 4)
    assert isinstance(model, cls) and not model.training
    assert all(p.device.type == "cpu" for p in model.parameters())
    again = get_algorithm(name).build(conf, train, data, 4)
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)  # weights from the seed
    return model


def test_registry_builds_dmf_on_the_data_device():
    model = check_registry("dmf", {**DMF_CONFS["normalized"], "mu": 0.1},
                           DeepMatrixFactorization)
    assert model.mu == 0.1 and model.normalize_representations
    assert model.user_nn.normalize and model.item_nn.normalize
    assert model.user_nn.kernel.shape == (N_ITEMS, 8)
    assert model.item_nn.kernel.shape == (N_USERS, 6)
    assert model.user_nn.out_fn is torch.relu


CLI_BASE = {
    "learn": {"n_epochs": 2, "lr": 0.005, "rec_loss": "bpr",
              "optimizing_metric": "ndcg@5"},
    "eval": {"top_k": [1, 5], "metrics": ["ndcg", "recall"]},
    "loader": {"batch_size": 32, "eval_batch_size": 16},
    "dataset": {"n_negative_samples": 2,
                "user_features": [{"name": "gender", "type": "categorical"},
                                  {"name": "profile_vec",
                                   "type": "vector"}],
                "item_features": [{"name": "audio", "type": "vector"}]},
    "run_settings": {"device": "cpu"},
}


def cli_run(root, name, model_conf):
    """The port's CLI (``-t train_val``, in this process) on synthetic
    artifacts; returns the run directory after
    checking its files and JAX's metric keys."""
    art, res = str(root / "data"), str(root / "run")
    write_reference_artifacts(art, make_synthetic_splits(
        n_users=N_USERS, n_items=N_ITEMS, n_interactions=600, seed=5))
    conf_path = str(root / "conf.yml")
    with open(conf_path, "w") as fh:
        yaml.safe_dump({**CLI_BASE, "model": model_conf,
                        "results_path": res}, fh)
    metrics = run_experiment(["-a", name, "-d", art, "-t", "train_val",
                              "-c", conf_path])
    assert sorted(os.listdir(res)) == ["conf.yml", "metrics_val.yml",
                                       "model.pt"]
    with open(os.path.join(res, "conf.yml")) as fh:
        conf = yaml.safe_load(fh)
    assert conf["algorithm"] == name and conf["model"] == model_conf
    keys = _chip_smoke().expected_keys(
        EvalConfig(**CLI_BASE["eval"]), "val")
    with open(os.path.join(res, "metrics_val.yml")) as fh:
        assert yaml.safe_load(fh) == metrics
    assert set(metrics) == keys
    assert all(np.isfinite(v) for v in metrics.values())
    return res


def check_served(run_dir):
    """``Recommender.from_run_dir`` (val split) scoring through the
    model's dot parts (K2's plain version; at 40 items the peel is not
    viable, so the scores path selects): each list is the top-5 of the
    user's masked catalog scores from ``combine`` (the oracle), up to
    ties."""
    rec = Recommender.from_run_dir(run_dir, split="val", batch_size=8,
                                   device="cpu")
    assert rec._dot and not rec.use_dot and rec.k == 5
    users = np.arange(N_USERS)
    ids, vals = rec.recommend(users, return_scores=True)
    scores = rec.score_fn(torch.as_tensor(users, dtype=torch.int32)).numpy()
    excl = rec.data.exclude_csr
    indptr, indices = excl.indptr.numpy(), excl.indices.numpy()
    catalog = np.asarray(rec.dataset.items_in_split)
    position = {int(item): c for c, item in enumerate(catalog)}
    for r, u in enumerate(users):
        row = scores[r].copy()
        row[indices[indptr[u]:indptr[u + 1]]] = -np.inf
        top = np.sort(row)[::-1][:5]
        got = row[[position[int(i)] for i in ids[r]]]
        np.testing.assert_allclose(got, top, rtol=1e-5, atol=1e-6)
        assert np.isfinite(got).all()
    return ids, vals


def check_floor(model, splits, data, **learn):
    """Two epochs of ``Trainer.fit`` beat the untrained validation
    ndcg@10 (``tests/test_model_zoo.py``'s toy splits)."""
    records = []
    ev = FullEvaluator(EvalConfig(top_k=[10], metrics=["ndcg"]),
                       splits["val"], device="cpu", evaluator_name="val")
    trainer = Trainer(
        model, splits["train"], LearningConfig(
            n_epochs=2, lr=learn.pop("lr", 5e-3), rec_loss="bpr",
            max_patience=50, optimizing_metric="ndcg@10", **learn),
        DatasetConfig(), batch_size=64, seed=0, device_data=data,
        val_evaluator=ev, log_fn=records.append)
    trainer.fit()
    untrained = records[0]["val/ndcg@10"]
    trained = max(r["val/ndcg@10"] for r in records[1:])
    assert records[0]["epoch"] == -1 and trained > untrained, records
    return trainer


def floor_splits():
    splits = make_synthetic_splits(n_users=80, n_items=100,
                                   n_interactions=2400, seed=5)
    return splits, splits["train"].to_device("cpu")


def test_cli_train_val_and_serving_run_dmf(tmp_path):
    run = cli_run(tmp_path, "dmf", DMF_CONFS["normalized"])
    check_served(run)


def test_dmf_trains_past_its_untrained_floor():
    splits, data = floor_splits()
    model = DeepMatrixFactorization.build_from_conf(
        {"u_mid_layers": [32], "i_mid_layers": [32], "final_dimension": 16},
        splits["train"], data, torch.Generator().manual_seed(0))
    check_floor(model, splits, data)


# -------------------------------------------------- the chip run's zoo
@pytest.mark.parametrize("name", ["dmf", "ifeatmf", "ufeatmf", "dropoutnet"])
def test_chip_smoke_zoo_models_match_yaml(name):
    """``chip_smoke.ZOO_MODELS`` are the resolved ``model:`` blocks of the
    onion18 YAMLs, by the port's loader and by JAX's."""
    path = os.path.join(ROOT, "conf", "single", f"{name}_onion18.yml")
    resolved = get_config(path, algorithm=name).model
    assert _chip_smoke().ZOO_MODELS[name] == resolved
    assert jax_get_config(path, algorithm=name).model == resolved


def test_chip_smoke_zoo_user_features():
    """The zoo's in-memory user features: gender and country categorical
    (3 and at most 50 values), the 768-wide vector around the centre of
    the cluster ``make_onion_scale_splits`` gives each user."""
    n_users, n_items, n_clusters = 400, 500, 8
    feats = _chip_smoke().zoo_user_features(n_users, n_items,
                                            n_clusters=n_clusters)
    gender, country = feats["gender"], feats["country"]
    vec = feats["acg_with_unknown_mpnet"]
    assert (gender.kind, gender.n_categories) == ("categorical", 3)
    assert country.kind == "categorical" and country.n_categories <= 50
    assert gender.table.shape == country.table.shape == (n_users,)
    assert vec.kind == "numeric" and vec.table.shape == (n_users, 768)
    assert vec.table.dtype == np.float32
    rng = np.random.default_rng(7)  # the generator's first two draws
    rng.integers(0, n_clusters, n_items)
    cluster = rng.integers(0, n_clusters, n_users)
    centres = np.stack([vec.table[cluster == c].mean(0)
                        for c in range(n_clusters)])
    own = np.linalg.norm(vec.table - centres[cluster], axis=1)
    other = np.linalg.norm(vec.table - centres[(cluster + 1) % n_clusters],
                           axis=1)
    assert (own < other).all()
