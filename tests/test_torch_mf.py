"""The port's MF family and row-sparse Adam against the JAX package, on the
CPU.

``sgdbias`` / ``mf`` / ``acf`` with the same (numpy-drawn) weights in both
packages: the train forward's logits and regularization loss, the
catalog scores, and every parameter's gradient of one step, rtol 1e-5 (f32,
sums in other orders). ``coalesce_rows`` bit-equal in its ids and within
f32 rounding in its sums (the same order of additions: equal here);
``row_adam_update`` against JAX's over two steps, rtol 1e-6; then the
sparse-table trainer, mirroring ``tests/test_row_adam.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sibrar_tpu.models import mf as jmf
from sibrar_tpu.models.base import collect_reg_loss
from sibrar_tpu.train import row_adam as jrow
from sibrar_tpu_torch.config.schema import (
    DatasetConfig,
    EvalConfig,
    LearningConfig,
)
from sibrar_tpu_torch.data.synthetic import make_synthetic_splits
from sibrar_tpu_torch.eval.evaluator import FullEvaluator
from sibrar_tpu_torch.models import mf as tmf
from sibrar_tpu_torch.models.layers import Embedding
from sibrar_tpu_torch.models.registry import get_algorithm
from sibrar_tpu_torch.models.transplant import _pairs, transplant
from sibrar_tpu_torch.ops import spmm
from sibrar_tpu_torch.train.row_adam import (
    coalesce_rows,
    find_sparse_tables,
    row_adam_init,
    row_adam_update,
)
from sibrar_tpu_torch.train.trainer import Trainer

F32 = dict(rtol=1e-5, atol=1e-6)
N_USERS, N_ITEMS, D, B, N = 30, 40, 8, 6, 4

MODELS = {
    "sgdbias": (lambda: jmf.SGDBaseline(n_users=N_USERS, n_items=N_ITEMS),
                lambda gen: tmf.SGDBaseline(N_USERS, N_ITEMS, gen)),
    "mf": (lambda: jmf.SGDMatrixFactorization(
        n_users=N_USERS, n_items=N_ITEMS, embedding_dim=D),
        lambda gen: tmf.SGDMatrixFactorization(N_USERS, N_ITEMS, gen,
                                               embedding_dim=D)),
    "mf_biases": (lambda: jmf.SGDMatrixFactorization(
        n_users=N_USERS, n_items=N_ITEMS, embedding_dim=D,
        use_user_bias=True, use_item_bias=True, use_global_bias=True),
        lambda gen: tmf.SGDMatrixFactorization(
            N_USERS, N_ITEMS, gen, embedding_dim=D, use_user_bias=True,
            use_item_bias=True, use_global_bias=True)),
    "acf": (lambda: jmf.ACF(n_users=N_USERS, n_items=N_ITEMS,
                            embedding_dim=D, n_anchors=5),
            lambda gen: tmf.ACF(N_USERS, N_ITEMS, gen, embedding_dim=D,
                                n_anchors=5)),
}


def _models(kind):
    """The JAX model with every parameter drawn from a seeded numpy rng
    (non-zero biases), and the port's model with them transplanted."""
    jm = MODELS[kind][0]()
    u = jnp.zeros((2,), jnp.int32)
    i = jnp.zeros((2, 3), jnp.int32)
    shaped = jm.init(jax.random.PRNGKey(0), u, i, train=True)["params"]
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda p: rng.normal(0.0, 0.5, p.shape).astype(np.float32), shaped)
    tm = MODELS[kind][1](torch.Generator().manual_seed(0))
    transplant(tm, {"params": params})
    return jm, params, tm


def _inputs():
    rng = np.random.default_rng(4)
    return (rng.integers(0, N_USERS, B).astype(np.int32),
            rng.integers(0, N_ITEMS, (B, 1 + N)).astype(np.int32))


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_mf_family_train_forward_and_grads_match_flax(kind):
    jm, params, tm = _models(kind)
    users, items = _inputs()
    w = np.random.default_rng(5).normal(size=items.shape).astype(np.float32)

    def loss_fn(p):
        logits, aux = jm.apply({"params": p}, jnp.asarray(users),
                               jnp.asarray(items), train=True,
                               mutable=["losses"])
        reg = collect_reg_loss(aux)
        return (logits * w).sum() + reg, (logits, reg)

    (_, (jlogits, jreg)), jgrads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    tm.train()
    logits, reg = tm(torch.as_tensor(users), torch.as_tensor(items))
    ((logits * torch.as_tensor(w)).sum() + reg).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **F32)
    np.testing.assert_allclose(reg.item(), float(jreg), **F32)
    assert (float(jreg) > 0) == (kind == "acf")
    pairs = _pairs(tm, jgrads, None)
    assert len(pairs) == len(list(tm.parameters()))
    for dst, src, _ in pairs:
        np.testing.assert_allclose(dst.grad.numpy(), np.asarray(src), **F32)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_mf_family_catalog_scores_match_flax(kind):
    """Eval: ``combine(user_repr(u), item_repr(catalog))`` [B, C], and for
    the dot-ranked models the ranking parts (``eval_rank_dot_parts``)."""
    from sibrar_tpu_torch.train.scoring import make_score_fn

    jm, params, tm = _models(kind)
    users, _ = _inputs()
    catalog = jnp.arange(N_ITEMS, dtype=jnp.int32)
    want = jm.apply({"params": params}, jnp.asarray(users), catalog,
                    method=lambda m, u, c: m.combine(m.user_repr(u),
                                                     m.item_repr(c)))
    score_fn = make_score_fn(tm, torch.arange(N_ITEMS, dtype=torch.int32),
                             item_chunk=16)  # three chunks, tuples joined
    got = score_fn(torch.as_tensor(users))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    if score_fn.dot_parts is not None:  # the scores up to a user's shift
        u_fn, items = score_fn.dot_parts
        diff = (u_fn(torch.as_tensor(users)) @ items.T - got).numpy()
        np.testing.assert_allclose(diff, diff[:, :1].repeat(N_ITEMS, 1),
                                   atol=1e-5)
    assert (score_fn.dot_parts is not None) == kind.startswith("mf")


def test_registry_builds_the_mf_family_on_the_data_device():
    sp = make_synthetic_splits(n_users=N_USERS, n_items=N_ITEMS,
                               n_interactions=300, with_features=False)
    data = sp["train"].to_device("cpu")
    mf = get_algorithm("mf").build(
        {"embedding_dim": 16, "use_item_bias": True}, sp["train"], data, 4)
    assert mf.item_embeddings.weight.shape == (N_ITEMS, 16)
    assert mf.use_item_bias and not mf.use_user_bias and not mf.training
    acf = get_algorithm("acf").build({"n_anchors": 7}, sp["train"], data, 4)
    assert acf.anchors.shape == (7, 100)
    bias = get_algorithm("sgdbias").build({}, sp["train"], data, 4)
    assert bias.user_bias.weight.shape == (N_USERS, 1)
    again = get_algorithm("mf").build(
        {"embedding_dim": 16, "use_item_bias": True}, sp["train"], data, 4)
    assert torch.equal(again.user_embeddings.weight,
                       mf.user_embeddings.weight)  # weights from the seed
    w = mf.user_embeddings.weight.detach()
    assert abs(float(w.std()) - 0.1 / 16) < 0.1 / 16 * 0.2


# ----------------------------------------------------------- row-sparse Adam
def test_coalesce_rows_matches_jax():
    rng = np.random.default_rng(0)
    idx = np.array([3, 1, 3, 3, 0, 1, 7, 3], np.int32)
    g = rng.normal(size=(8, 4)).astype(np.float32)
    js, jg = jrow.coalesce_rows(jnp.asarray(idx), jnp.asarray(g))
    ts, tg = coalesce_rows(torch.as_tensor(idx), torch.as_tensor(g))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
    for p, i in enumerate(ts.numpy()):
        np.testing.assert_allclose(tg[p].numpy(), g[idx == i].sum(0),
                                   rtol=1e-6)
    launches = spmm.spmm_bwd.launches
    coalesce_rows(torch.as_tensor(idx), torch.as_tensor(g))
    assert spmm.spmm_bwd.launches == launches  # CPU: the plain version


def test_rows_grad_equals_dense_table_grad():
    """Injected rows' gradient, coalesced, equals the table's gradient of
    the same lookup (duplicates included); a wrong shape raises."""
    n, d = 12, 8
    emb = Embedding(n, d, torch.Generator().manual_seed(0))
    idxs = torch.tensor([2, 5, 2, 7])
    scale = torch.arange(1.0, d + 1.0)
    (torch.sin(emb(idxs)) * scale).sum().backward()
    rows = emb.weight.detach()[idxs].requires_grad_()
    emb.rows = rows
    (torch.sin(emb(idxs)) * scale).sum().backward()
    s_idx, g_c = coalesce_rows(idxs.int(), rows.grad)
    for p, i in enumerate(s_idx.tolist()):
        np.testing.assert_allclose(g_c[p].numpy(), emb.weight.grad[i].numpy(),
                                   rtol=1e-6)
    untouched = sorted(set(range(n)) - set(idxs.tolist()))
    assert not emb.weight.grad[untouched].any()
    with pytest.raises(ValueError, match="table_index_map"):
        emb(idxs[:3])


def test_row_adam_steps_match_jax():
    rng = np.random.default_rng(1)
    n, d, lr, wd = 10, 8, 0.01, 0.05
    table = rng.normal(size=(n, d)).astype(np.float32)
    steps = [(np.array([4, 1, 4], np.int32), rng.normal(size=(3, d))),
             (np.array([1, 9], np.int32), rng.normal(size=(2, d)))]
    jt, jo = jnp.asarray(table), jrow.row_adam_init(jnp.asarray(table))
    tt = torch.as_tensor(table.copy())
    to = row_adam_init(tt)
    for t, (idx, g) in enumerate(steps, start=1):
        g = g.astype(np.float32)
        jt, jo = jrow.row_adam_update(jt, jo, jnp.asarray(idx),
                                      jnp.asarray(g), jnp.asarray(t), lr=lr,
                                      wd=wd)
        row_adam_update(tt, to, torch.as_tensor(idx), torch.as_tensor(g), t,
                        lr=lr, wd=wd)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6,
                                   atol=1e-7)
        for key in ("mu", "nu"):
            np.testing.assert_allclose(to[key].numpy(), np.asarray(jo[key]),
                                       rtol=1e-6, atol=1e-9)
    untouched = [0, 2, 3, 5, 6, 7, 8]
    assert not to["mu"][untouched].any() and not to["nu"][untouched].any()
    np.testing.assert_array_equal(tt.numpy()[untouched], table[untouched])


def test_find_sparse_tables_gates_match_jax():
    jm = jmf.SGDMatrixFactorization(n_users=100, n_items=100,
                                    embedding_dim=16, use_user_bias=True)
    params = {"user_embeddings": {"embedding": jnp.zeros((100, 16))},
              "item_embeddings": {"embedding": jnp.zeros((100, 16))},
              "user_bias": {"embedding": jnp.zeros((100, 1))}}
    tm = tmf.SGDMatrixFactorization(100, 100, torch.Generator(),
                                    embedding_dim=16, use_user_bias=True)
    for min_rows in (50, 100, 101):
        assert find_sparse_tables(tm, min_rows) == jrow.find_sparse_tables(
            jm, params, min_rows)
    assert find_sparse_tables(tm, 50) == {"user_embeddings": "user",
                                          "item_embeddings": "item"}


def _tiny_trainer(sparse: bool, seed: int = 0, kind: str = "mf"):
    sp = make_synthetic_splits(n_users=40, n_items=60, n_interactions=800,
                               seed=1)
    train = sp["train"]
    data = train.to_device("cpu")
    conf = ({"embedding_dim": 16} if kind == "mf"
            else {"embedding_dim": 16, "n_anchors": 4})
    model = get_algorithm(kind).build(conf, train, data, seed)
    learn = LearningConfig(n_epochs=2, lr=5e-3, rec_loss="bpr",
                           optimizing_metric="ndcg@10", sparse_tables=sparse,
                           sparse_table_min_rows=1)
    ev = FullEvaluator(EvalConfig(top_k=[10], metrics=["ndcg"]), sp["val"],
                       device="cpu")
    return Trainer(model, train, learn, DatasetConfig(n_negative_samples=4),
                   batch_size=32, seed=seed, device_data=data,
                   val_evaluator=ev)


def test_trainer_sparse_tables_learns_and_freezes_cold_rows():
    tr = _tiny_trainer(sparse=True)
    assert tr.sparse == {"user_embeddings": "user",
                         "item_embeddings": "item"}
    assert tr.optimizer.params == []  # no dense moments for the tables
    init_user = tr.model.user_embeddings.weight.detach().clone()
    m0 = tr.train_epoch()
    m1 = tr.train_epoch()
    assert m1["train/loss"] < m0["train/loss"]
    assert np.isfinite(tr.validate()["ndcg@10"])
    touched = set(tr.data.train_users.tolist())
    cold = [u for u in range(40) if u not in touched]
    after = tr.model.user_embeddings.weight.detach()
    assert torch.equal(after[cold], init_user[cold])
    assert not tr.row_state["user_embeddings"]["mu"][cold].any()
    hot = sorted(touched)
    assert not torch.allclose(after[hot], init_user[hot])


def test_trainer_sparse_checkpoint_roundtrip(tmp_path):
    tr = _tiny_trainer(sparse=True)
    tr.train_epoch()
    tr.save_checkpoint(str(tmp_path))
    tr2 = _tiny_trainer(sparse=True, seed=3)
    tr2.load_checkpoint(str(tmp_path))
    for name in ("user_embeddings", "item_embeddings"):
        assert torch.equal(getattr(tr.model, name).weight,
                           getattr(tr2.model, name).weight)
        for key in ("mu", "nu"):
            assert torch.equal(tr.row_state[name][key],
                               tr2.row_state[name][key])
    m1, m2 = tr.train_epoch(), tr2.train_epoch()
    assert m1["train/loss"] == pytest.approx(m2["train/loss"], rel=1e-6)
    for a, b in zip(tr.model.parameters(), tr2.model.parameters()):
        assert torch.equal(a, b)


def test_acf_sparse_tables_still_trains_the_anchors():
    tr = _tiny_trainer(sparse=True, kind="acf")
    assert tr.sparse == {"user_embed": "user", "item_embed": "item"}
    p0 = tr.model.anchors.detach().clone()
    losses = [tr.train_epoch()["train/loss"] for _ in range(3)]
    assert losses[-1] < losses[0]
    assert (tr.model.anchors.detach() - p0).abs().max() > 0
    assert np.isfinite(tr.validate()["ndcg@10"])
