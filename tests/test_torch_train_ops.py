"""The port's training-slice ops against the JAX package, on the CPU: the
first-layer kernels' plain versions (K5 ``dw_matmul``, K6/K7
``spmm_onehot``) against the Pallas kernels in interpret mode, losses,
membership tests, samplers (with the ``jax.random`` draws injected),
routing tables, batch plans, batch norm, dropout and the optimizers.

Tolerances: integer and boolean outputs bit-equal; f32 forwards and losses
rtol = 1e-5 (sums taken in other orders); gradients and optimizer steps
rtol = 1e-4 / atol = 1e-6 (longer chains of f32 rounding)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch

from sibrar_tpu.config.schema import LearningConfig as JaxLearningConfig
from sibrar_tpu.data import sampling as jsampling
from sibrar_tpu.models import layers as jlayers
from sibrar_tpu.ops import sparse as jsparse
from sibrar_tpu.ops.pallas_dw import dw_matmul as jax_dw_matmul
from sibrar_tpu.ops.pallas_spmm import _spmm_bwd as jax_spmm_bwd
from sibrar_tpu.ops.pallas_spmm import spmm_onehot as jax_spmm_onehot
from sibrar_tpu.train import losses as jlosses
from sibrar_tpu.train.trainer import Trainer as JaxTrainer
from sibrar_tpu.train.trainer import build_optimizer as jax_build_optimizer
from sibrar_tpu_torch.data import sampling as tsampling
from sibrar_tpu_torch.models import layers as tlayers
from sibrar_tpu_torch.ops import sparse as tsparse
from sibrar_tpu_torch.ops.dw import dense_first_matmul, dw_matmul
from sibrar_tpu_torch.ops.spmm import spmm_bwd, spmm_fwd, spmm_onehot
from sibrar_tpu_torch.train import losses as tlosses
from sibrar_tpu_torch.train.trainer import (
    LearningConfig,
    Trainer,
    build_optimizer,
)

F32 = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _csr(rng, n_rows, n_cols, lens):
    rows, cols = [], []
    for r, n in enumerate(lens):
        rows += [r] * n
        cols += sorted(rng.choice(n_cols, size=n, replace=False).tolist())
    return sp.csr_matrix((np.ones(len(rows), np.int8), (rows, cols)),
                         shape=(n_rows, n_cols))


# -------------------------------------------------------- K5 and its caller
@pytest.mark.parametrize("r,c,h", [(16, 256, 128), (37, 300, 130),
                                   (24, 1111, 20)])
def test_dw_matmul_plain_matches_pallas(r, c, h):
    rng = np.random.default_rng(0)
    vec = (rng.random((r, c)) < 0.1).astype(np.float32)
    g = rng.standard_normal((r, h)).astype(np.float32)
    want = jax_dw_matmul(jnp.asarray(vec), jnp.asarray(g), interpret=True)
    got = dw_matmul(torch.as_tensor(vec), torch.as_tensor(g))
    assert got.shape == (c, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_dense_first_matmul_grad_matches_jax(monkeypatch):
    monkeypatch.setattr(jlayers, "DW_KERNEL", "interpret")
    rng = np.random.default_rng(1)
    vec = (rng.random((24, 300)) < 0.05).astype(np.float32)
    kernel = rng.standard_normal((300, 16)).astype(np.float32)
    w = rng.standard_normal((24, 16)).astype(np.float32)

    def jloss(k):
        return (jlayers._dense_first_matmul(jnp.asarray(vec), k) * w).sum()

    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(kernel))
    tk = torch.tensor(kernel, requires_grad=True)
    tv = torch.as_tensor(vec)
    out = dense_first_matmul(tv, tk)
    (out * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), vec @ kernel, **F32)
    np.testing.assert_allclose(tk.grad.numpy(), np.asarray(jgrad), **GRAD)
    assert tv.grad is None  # the densified rows are data


# ---------------------------------------------------- K6 / K7 and their op
def _spmm_inputs(b=12, length=9, n_cols=300, h=16, seed=2):
    rng = np.random.default_rng(seed)
    cols = np.stack([rng.choice(n_cols, size=length, replace=False)
                     for _ in range(b)]).astype(np.int32)
    mask = rng.random((b, length)) < 0.7
    mask[3] = False  # an empty row
    kernel = rng.standard_normal((n_cols, h)).astype(np.float32)
    w = rng.standard_normal((b, h)).astype(np.float32)
    return cols, mask, kernel, w


@pytest.mark.parametrize("n_cols", [300, 5000])  # one and three JAX tiles
def test_spmm_onehot_forward_and_grad_match_pallas(n_cols):
    cols, mask, kernel, w = _spmm_inputs(n_cols=n_cols)

    def jloss(k):
        out = jax_spmm_onehot(jnp.asarray(cols), jnp.asarray(mask), k, True)
        return (out * w).sum(), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(kernel))
    tk = torch.tensor(kernel, requires_grad=True)
    out = spmm_onehot(torch.as_tensor(cols), torch.as_tensor(mask), tk)
    (out * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **F32)
    np.testing.assert_allclose(tk.grad.numpy(), np.asarray(jgrad), **GRAD)
    # the plain versions on their own, against densify + matmul
    dense = np.zeros((cols.shape[0], n_cols), np.float32)
    for b in range(cols.shape[0]):
        dense[b, cols[b][mask[b]]] = 1.0
    np.testing.assert_allclose(
        spmm_fwd(torch.as_tensor(cols), torch.as_tensor(mask),
                 torch.as_tensor(kernel)).numpy(), dense @ kernel, **F32)
    np.testing.assert_allclose(
        spmm_bwd(torch.as_tensor(cols), torch.as_tensor(mask),
                 torch.as_tensor(w), n_cols).numpy(), dense.T @ w, **F32)


# (B, L, n_cols, H, a column in most rows): B = 21 is no multiple of the
# row group of 8; n_cols = 5,000 spans three kc = 2,048 tiles
SPMM_BWD_CASES = {
    "b21_h16": (21, 12, 300, 16, False),
    "b21_h13": (21, 12, 300, 13, False),
    "shared_column_h16": (24, 12, 40, 16, True),
    "three_tiles_h13": (21, 30, 5000, 13, True),
}


@pytest.mark.parametrize("case", list(SPMM_BWD_CASES))
def test_plain_spmm_bwd_bit_equal_to_pallas(case):
    """K7's plain version sums each column in JAX's order, row groups of 8,
    then slots, then rows (``bwd_order``), so it is bit-equal to
    ``_spmm_bwd`` in interpret mode: with an empty row, a column that most
    rows hold at different slots (ties within a group of 8 at different
    slots), and columns no slot hits (+0.0)."""
    b, length, n_cols, h, shared = SPMM_BWD_CASES[case]
    rng = np.random.default_rng(11)
    cols = np.stack([rng.choice(n_cols, size=length, replace=False)
                     for _ in range(b)]).astype(np.int32)
    mask = rng.random((b, length)) < 0.7
    if shared:  # column 7 in every row but every fifth, at a random slot
        cols[cols == 7] = n_cols - 1
        for r in range(b):
            if r % 5:
                slot = rng.integers(length)
                cols[r, slot], mask[r, slot] = 7, True
    mask[3] = False  # an empty row
    g = (rng.standard_normal((b, h)) * 10.0 ** rng.integers(
        -3, 4, (b, 1))).astype(np.float32)
    safe = np.where(mask, cols, n_cols + 4096).astype(np.int32)
    want = np.asarray(jax_spmm_bwd(jnp.asarray(safe), jnp.asarray(g), n_cols,
                                   interpret=True))
    got = spmm_bwd(torch.as_tensor(cols), torch.as_tensor(mask),
                   torch.as_tensor(g), n_cols).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    hit = np.zeros(n_cols, bool)
    hit[cols[mask]] = True
    assert (got[~hit].view(np.uint32) == 0).all()  # +0.0, not -0.0
    if shared:  # the row-major slot order gives other bits: the order counts
        rows, slots = np.nonzero(mask)
        row_major = torch.zeros(n_cols, h).index_add_(
            0, torch.as_tensor(cols[rows, slots]).long(),
            torch.as_tensor(g[rows]))
        assert not np.array_equal(row_major.numpy()[7], want[7])


# ----------------------------------------------------------------- losses
@pytest.mark.parametrize("name", ["bce", "bpr", "sampled_softmax"])
@pytest.mark.parametrize("aggregator", ["mean", "sum"])
@pytest.mark.parametrize("strategy", ["uniform", "popular"])
def test_rec_losses_match_jax(name, aggregator, strategy):
    rng = np.random.default_rng(3)
    logits = (3 * rng.standard_normal((16, 5))).astype(np.float32)
    labels = np.zeros_like(logits)
    labels[:, 0] = 1.0
    kw = dict(n_items=1000, n_neg=4, aggregator=aggregator,
              train_neg_strategy=strategy)
    want = jlosses.build_rec_loss(name, **kw)(jnp.asarray(logits),
                                              jnp.asarray(labels))
    got = tlosses.build_rec_loss(name, **kw)(torch.as_tensor(logits),
                                             torch.as_tensor(labels))
    np.testing.assert_allclose(got.item(), float(want), **F32)


@pytest.mark.parametrize("shape", [(6, 4, 8), (10, 8)])  # items / users
def test_info_nce_matches_jax(shape):
    rng = np.random.default_rng(4)
    a = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    want = jlosses.info_nce(jnp.asarray(a), jnp.asarray(b), temperature=0.2)
    got = tlosses.info_nce(torch.as_tensor(a), torch.as_tensor(b),
                           temperature=0.2)
    np.testing.assert_allclose(got.item(), float(want), **F32)


# ------------------------------------------------------- membership tests
@pytest.mark.parametrize("long_row", [False, True])  # compare / bisection
def test_membership_tests_match_jax(long_row):
    rng = np.random.default_rng(5)
    lens = [int(rng.integers(0, 12)) for _ in range(30)]
    lens[4] = 0
    if long_row:
        lens[7] = 2100  # past the compare path's 2048
    mat = _csr(rng, 30, 3000, lens)
    jc, tc = jsparse.DeviceCSR.from_scipy(mat), \
        tsparse.DeviceCSR.from_scipy(mat, "cpu")
    rows = rng.integers(0, 30, 16).astype(np.int32)
    rows[0] = 7
    # half the queries are stored entries, half random
    queries = rng.integers(0, 3000, (16, 10)).astype(np.int32)
    for b, r in enumerate(rows):
        stored = mat.indices[mat.indptr[r]:mat.indptr[r + 1]]
        if len(stored):
            queries[b, :5] = rng.choice(stored, 5)
    want = np.asarray(jsparse.csr_contains_rows(jc, jnp.asarray(rows),
                                                jnp.asarray(queries)))
    got = tsparse.csr_contains_rows(tc, torch.as_tensor(rows),
                                    torch.as_tensor(queries))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (tsparse.contains_rows_pregather(tc, torch.as_tensor(rows))
            is None) == long_row
    np.testing.assert_array_equal(
        tsparse.csr_contains(tc, torch.as_tensor(rows)[:, None],
                             torch.as_tensor(queries)).numpy(), want)
    jpre = jsparse.csr_row_gather(jc, jnp.asarray(rows))
    np.testing.assert_array_equal(
        tsparse.contains_pregathered(
            torch.as_tensor(np.array(jpre[0])),
            torch.as_tensor(np.array(jpre[1])),
            torch.as_tensor(queries)).numpy(),
        np.asarray(jsparse.contains_pregathered(*jpre,
                                                jnp.asarray(queries))))


# ----------------------------------------------------------------- samplers
def _pos_csr(seed=6):
    rng = np.random.default_rng(seed)
    mat = _csr(rng, 40, 60, [int(rng.integers(0, 30)) for _ in range(40)])
    return (mat, jsparse.DeviceCSR.from_scipy(mat),
            tsparse.DeviceCSR.from_scipy(mat, "cpu"))


def _fold_draws(key, draw, n_rounds):
    """The draws a JAX rejection sampler makes: the first candidates, then
    one per round from ``fold_in(kloop, i)``."""
    k0, kloop = jax.random.split(key)
    return np.stack([np.asarray(draw(k0))] + [
        np.asarray(draw(jax.random.fold_in(kloop, i)))
        for i in range(n_rounds)])


@pytest.mark.parametrize("distinct", [True, False])  # uniform / recbole
def test_uniform_negatives_bit_equal_with_jax_draws(distinct):
    mat, jcsr, tcsr = _pos_csr()
    users = np.arange(40, dtype=np.int32)
    key = jax.random.PRNGKey(11)
    want = jsampling.sample_negatives_uniform(
        key, jnp.asarray(users), jcsr, n_catalog=60, n_neg=6,
        distinct=distinct)
    draws = _fold_draws(key, lambda k: jax.random.randint(
        k, (40, 6), 0, 60, dtype=jnp.int32), 8)
    got = tsampling.sample_negatives_uniform(
        None, torch.as_tensor(users), tcsr, n_catalog=60, n_neg=6,
        distinct=distinct, draws=torch.as_tensor(draws))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and the rejection did its work: (almost) no positive survives
    hits = np.asarray(mat[np.repeat(users, 6), got.numpy().reshape(-1)])
    assert hits.sum() < 5


def test_popular_negatives_bit_equal_with_jax_draws():
    _, jcsr, tcsr = _pos_csr(7)
    rng = np.random.default_rng(7)
    pop = rng.random(60).astype(np.float32) ** 3
    pop /= pop.sum()
    users = np.arange(40, dtype=np.int32)
    key = jax.random.PRNGKey(12)
    logits = 0.5 * jnp.log(jnp.maximum(jnp.asarray(pop), 1e-12))
    want = jsampling.sample_negatives_popular(
        key, jnp.asarray(users), jcsr, jnp.asarray(pop), n_neg=5,
        squashing_factor=0.5)
    draws = _fold_draws(key, lambda k: jax.random.categorical(
        k, logits, shape=(40, 5)).astype(jnp.int32), 4)
    got = tsampling.sample_negatives_popular(
        None, torch.as_tensor(users), tcsr, torch.as_tensor(pop), n_neg=5,
        squashing_factor=0.5, draws=torch.as_tensor(draws))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampler_draws_from_the_generator():
    mat, _, tcsr = _pos_csr(8)
    users = torch.arange(40, dtype=torch.int32)
    pop = torch.rand(60, generator=torch.Generator().manual_seed(0))
    for strategy in ("uniform", "uniform_recbole", "popular"):
        runs = [tsampling.sample_negatives(
            torch.Generator().manual_seed(seed), users, tcsr, pop / pop.sum(),
            strategy=strategy, n_catalog=60, n_neg=6) for seed in (1, 1, 2)]
        assert runs[0].shape == (40, 6) and runs[0].dtype == torch.int32
        assert torch.equal(runs[0], runs[1])
        assert not torch.equal(runs[0], runs[2])
        assert ((runs[0] >= 0) & (runs[0] < 60)).all()
    with pytest.raises(ValueError, match="unknown"):
        tsampling.sample_negatives(None, users, tcsr, pop, strategy="x",
                                   n_catalog=60, n_neg=6)


@pytest.mark.parametrize("k,central", [(1, None), (2, None), (2, 3)])
def test_sample_k_modalities_contract(k, central):
    gen = torch.Generator().manual_seed(0)
    s = tsampling.sample_k_modalities(gen, (400, 3), 5, k, central,
                                      device="cpu")
    assert s.shape == (400, 3, k)
    assert ((s >= 0) & (s < 5)).all()
    counts = torch.bincount(s.reshape(-1), minlength=5).float()
    if k == 2:
        assert (s[..., 0] != s[..., 1]).all()
    if central is None:  # uniform marginals
        assert (counts / counts.sum() - 0.2).abs().max() < 0.03
    else:  # the central modality in every pair, in either slot
        assert ((s == central).sum(-1) == 1).all()
        assert 0.4 < (s[..., 0] == central).float().mean() < 0.6


@pytest.mark.parametrize("n,k,central", [(1, 1, None), (5, 1, None),
                                         (2, 2, None), (5, 2, None),
                                         (4, 2, 0), (5, 2, 3)])
def test_balanced_routing_equals_jax(n, k, central):
    assert (tsampling.balanced_routing(n, k, central)
            == jsampling.balanced_routing(n, k, central))


@pytest.mark.parametrize("n_inter,bs,cap", [
    (1000, 128, None), (1024, 128, None), (1000, 128, 3), (1000, 128, 7),
    (1000, 128, 8), (100, 128, None), (0, 4, None), (1000, 128, 0)])
def test_epoch_batch_plan_equals_jax(n_inter, bs, cap):
    assert (Trainer.epoch_batch_plan(n_inter, bs, cap)
            == JaxTrainer.epoch_batch_plan(n_inter, bs, cap))


# ------------------------------------------------------ batch norm, dropout
def test_train_batch_norm_matches_flax():
    """N = 4 rows, where the biased batch variance is 3/4 of torch's
    unbiased one: output and running statistics as flax computes them."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 2, 6)).astype(np.float32)  # leading axes too
    jpoly = jlayers.PolyLinear([6, 5, 3], apply_batch_norm_every=1,
                               output_fn=None)
    variables = jpoly.init(jax.random.PRNGKey(0), jnp.asarray(x))
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        variables["batch_stats"])
    params = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        variables["params"])
    jout, aux = jpoly.apply({"params": params, "batch_stats": stats},
                            jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
    tpoly = tlayers.PolyLinear([6, 5, 3], torch.Generator(),
                               apply_batch_norm_every=1, output_fn=None)
    with torch.no_grad():
        for i, lin in enumerate(tpoly.linears):
            dense = params[f"linear_{i}"]
            lin.weight.copy_(torch.as_tensor(dense["kernel"].T))
            lin.bias.copy_(torch.as_tensor(dense["bias"]))
            bn = tpoly.batch_norm[str(i)]
            name = f"batch_norm_{i}"
            bn.weight.copy_(torch.as_tensor(params[name]["scale"]))
            bn.bias.copy_(torch.as_tensor(params[name]["bias"]))
            bn.running_mean.copy_(torch.as_tensor(stats[name]["mean"]))
            bn.running_var.copy_(torch.as_tensor(stats[name]["var"]))
    tpoly.train()
    tout = tpoly(torch.as_tensor(x))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **F32)
    for i in range(2):
        new = aux["batch_stats"][f"batch_norm_{i}"]
        bn = tpoly.batch_norm[str(i)]
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(new["mean"]), **F32)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(new["var"]), **F32)
    tpoly.eval()  # eval mode reads the running statistics, updates nothing
    before = tpoly.batch_norm["0"].running_var.clone()
    tpoly(torch.as_tensor(x))
    assert torch.equal(before, tpoly.batch_norm["0"].running_var)


def test_l2_normalize_gradient_is_zero_safe():
    """A zero row (an entity without interactions, zero tower bias) gets a
    finite gradient, not NaN: the clamp puts it on the constant branch of
    the norm, as in the JAX package."""
    x = np.zeros((3, 4), np.float32)
    x[1] = [1.0, -2.0, 0.5, 3.0]
    jgrad = jax.grad(lambda a: jlayers.l2_normalize(a, eps=1e-12).sum())(
        jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    tlayers.l2_normalize(tx, eps=1e-12).sum().backward()
    assert torch.isfinite(tx.grad).all()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad), **F32)


def test_dropout_keep_rate_and_scaling():
    x = torch.ones(200, 500)
    y = tlayers.dropout(x, 0.2, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.01
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.8))
    poly = tlayers.PolyLinear([500, 4], torch.Generator(), input_dropout=0.2)
    poly.eval()  # no dropout in eval mode, no generator needed
    assert torch.equal(poly(x), poly(x))
    poly.train()
    with pytest.raises(ValueError, match="Generator"):
        poly(x)
    a = poly(x, torch.Generator().manual_seed(1))
    b = poly(x, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, poly.eval()(x))


# --------------------------------------------------------------- optimizers
@pytest.mark.parametrize("kind,wd", [("adam", 1e-2), ("adagrad", 1e-2),
                                     ("adamw", 1e-2)])
def test_optimizers_match_optax_over_three_steps(kind, wd):
    rng = np.random.default_rng(10)
    shapes = [(7, 3), (5,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    grads[1][1][:] = 0.0  # a zero gradient (adagrad's accumulator at 0)
    learn = JaxLearningConfig(optimizer=kind, lr=1e-2, wd=wd)
    tx = jax_build_optimizer(learn)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.as_tensor(p.copy())) for p in params]
    opt = build_optimizer(LearningConfig(optimizer=kind, lr=1e-2, wd=wd), tp)
    for step in range(3):
        updates, state = tx.update([jnp.asarray(g) for g in grads[step]],
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, grads[step]):
            p.grad = torch.as_tensor(g)
        opt.step()
        for p, want in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                       **GRAD)


def test_unported_optimizer_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_optimizer(LearningConfig(moment_dtype="bfloat16"), [])
    with pytest.raises(ValueError, match="unsupported"):
        build_optimizer(LearningConfig(optimizer="sgd"), [])
