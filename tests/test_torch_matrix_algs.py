"""The port's matrix algorithms against the JAX package's, on the CPU.

Both packages fit on the same train CSR (`make_synthetic_splits` of one
seed, bit-equal in the two). What is compared, and how closely:

- the similarities: the hand-computed cases of ``tests/test_matrix_algs.py``
  (rtol 1e-4, as there); `compute_similarity_top_k` on 0/1 rows under each
  of the six names: the CSR (data, indices, indptr) bit-equal to JAX's
  (integer counts are exact in f32, and both select in ``lax.top_k``'s
  order), except the data of ``asymmetric_cosine`` and ``tversky``, whose
  fractional powers and weights XLA rounds its own way (rtol 5e-7, indices
  still equal); on real-valued rows (negative cosines): the same indices, data
  within rtol 1e-5, atol 1e-6 (f32 sums in other orders); the unknown
  names of the shipped sweep grids raise KeyError in both;
- the KNN family's ``pred_mtx`` bit-equal (the same scipy products of
  equal similarity CSRs); EASE, SLIM (and its ``weights``) and P3alpha
  within rtol 1e-4, atol 1e-6 (inverse, FISTA iterations and products in
  f32, another order of sums); ALS from JAX's initial item factors within
  rtol 1e-4, atol 1e-5 of its predictions (the port forms the same
  systems from one product instead of per-entity copies); SVD and RBMF by
  their predictions (factors are fixed only up to sign) within rtol 1e-5,
  atol 1e-5 (both run the same host code, but ``svds`` on the f32 matrix
  differs between two calls by ~1e-6 even from one numpy seed);
  `maxvol` indices equal; ``rand`` and ``pop`` predictions equal;
- ``model.npz`` written by one package and loaded by the other gives the
  same scores (bit-equal for stored matrices; 1e-6 for factor products);
- `evaluate_model` metrics of ``pop`` and ``iknn`` against JAX's under
  every ``topk_method`` (JAX's evaluator selecting as its accelerator
  branch does, its Pallas pipelines in interpret mode), within 1e-6 (the
  ranked lists are equal; the means are taken in another order);
- ``rand``'s scorer: values in [0, 1), one batch's scores a function of its
  first user, and its val recall@10 within four standard deviations of
  the rate random ranking gives (the hypergeometric mean and variance per
  user);
- the dataset's ``user_sampling_matrix`` / ``pop_distribution`` and
  `FeatureTable.dense_table` against JAX's.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sibrar_tpu.config.schema import EvalConfig as JaxEvalConfig
from sibrar_tpu.config.schema import FeatureDefinition as JaxFeatureDef
from sibrar_tpu.config.schema import FeatureType as JaxFeatureType
from sibrar_tpu.data import feature as jfeature
from sibrar_tpu.data.synthetic import make_synthetic_splits as jax_splits
from sibrar_tpu.eval import evaluator as jevaluator
from sibrar_tpu.eval.evaluator import FullEvaluator as JaxEvaluator
from sibrar_tpu.eval.evaluator import evaluate_model as jax_evaluate_model
from sibrar_tpu.models import matrix_algs as jm
from sibrar_tpu.models.registry import get_algorithm as jax_get_algorithm
from sibrar_tpu.ops import pallas_peel as jpeel
from sibrar_tpu.ops import pallas_window as jwindow
from sibrar_tpu.ops import sparse as jsparse
from sibrar_tpu.ops.topk import masked_topk as jax_masked_topk
from sibrar_tpu_torch.config.schema import EvalConfig, FeatureDefinition, \
    FeatureType
from sibrar_tpu_torch.data import feature as tfeature
from sibrar_tpu_torch.data.synthetic import make_synthetic_splits
from sibrar_tpu_torch.eval.evaluator import FullEvaluator, evaluate_model
from sibrar_tpu_torch.models import matrix_algs as tm
from sibrar_tpu_torch.models.registry import get_algorithm
from sibrar_tpu_torch.ops.topk import METHODS
from test_matrix_algs import _hand_similarity, _toy_interactions

# tests/test_experiment.py's MODEL_CONFS for the eleven names
MODEL_CONFS = {
    "uknn": {"k": 5}, "iknn": {"k": 5},
    "ifknn": {"k": 5, "feature_name": "audio"},
    "svd": {"n_factors": 4},
    "als": {"factors": 4, "n_iterations": 2, "regularization": 0.1,
            "alpha": 1.0},
    "rbmf": {"n_representatives": 4, "lam": 0.1},
    "slim": {"alpha": 0.01, "l1_ratio": 0.5, "max_iter": 5},
    "ease": {"lam": 1.0}, "p3alpha": {"alpha": 1.0}, "rand": {}, "pop": {},
}
SIMS = ("cosine", "dense_cosine", "jaccard", "sorensen_dice",
        "asymmetric_cosine", "tversky")


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def splits():
    return (jax_splits(n_users=40, n_items=70, n_interactions=900, seed=5),
            make_synthetic_splits(n_users=40, n_items=70,
                                  n_interactions=900, seed=5))


def _fit_both(name, jtrain, ttrain, conf=None):
    conf = MODEL_CONFS[name] if conf is None else conf
    ja = jax_get_algorithm(name).build(conf, jtrain)
    ta = get_algorithm(name).build(conf, ttrain, "cpu")
    kwargs_j, kwargs_t = {}, {}
    if name == "ifknn":
        kwargs_j["feature_matrix"] = jtrain.item_features[
            conf["feature_name"]].dense_table()
        kwargs_t["feature_matrix"] = ttrain.item_features[
            conf["feature_name"]].dense_table()
    if name == "als":  # JAX's initial item factors, drawn as its fit does
        _, ki = jax.random.split(jax.random.PRNGKey(0))
        kwargs_t["items_init"] = np.asarray(0.01 * jax.random.normal(
            ki, (jtrain.n_items, conf["factors"])))
    np.random.seed(0)
    ja.fit(matrix=jtrain.user_sampling_matrix, **kwargs_j)
    np.random.seed(0)
    ta.fit(matrix=ttrain.user_sampling_matrix, **kwargs_t)
    return ja, ta


# ------------------------------------------------------------ similarities
@pytest.mark.parametrize("kind,shrinkage", [
    ("cosine", 0.0), ("cosine", 2.5), ("jaccard", 0.0),
    ("sorensen_dice", 0.0), ("asymmetric_cosine", 0.0), ("tversky", 0.0),
    ("tversky", 1.5),
])
def test_similarity_kernels_match_hand_computed(kind, shrinkage):
    m = _toy_interactions(7, 12, density=0.4, seed=5)
    kwargs = {}
    if kind == "asymmetric_cosine":
        kwargs["alpha"] = 0.3
    if kind == "tversky":
        kwargs.update(alpha=0.7, beta=1.2)
    got = tm.compute_similarity_top_k(sp.csr_matrix(m), kind, k=7,
                                      shrinkage=shrinkage, device="cpu",
                                      **kwargs)
    ref = _hand_similarity(m, kind, shrinkage=shrinkage, **kwargs)
    np.testing.assert_allclose(got.toarray(), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", SIMS)
def test_similarity_top_k_on_binary_rows_is_jax_csr(name):
    """0/1 rows with many tied counts, k below the row count, two blocks:
    the CSR's arrays bit-equal to JAX's."""
    m = sp.csr_matrix(_toy_interactions(37, 25, density=0.2, seed=8))
    kw = {"asymmetric_cosine": {"alpha": 0.3},
          "tversky": {"alpha": 0.7, "beta": 1.2}}.get(name, {})
    want = jm.compute_similarity_top_k(m, name, k=6, shrinkage=3.0, **kw)
    got = tm.compute_similarity_top_k(m, name, k=6, shrinkage=3.0,
                                      block_size=16, device="cpu", **kw)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    if name in ("asymmetric_cosine", "tversky"):
        # fractional powers and weights: XLA rounds these expressions in
        # its own way (1 ulp here and there)
        np.testing.assert_allclose(got.data, want.data, rtol=5e-7, atol=0)
    else:
        np.testing.assert_array_equal(got.data, want.data)


def test_similarity_top_k_on_real_rows_matches_jax():
    """Real-valued rows: negative cosines, so a row can rank its zeroed
    self above them and keep fewer than k entries."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(30, 8)).astype(np.float32)
    want = jm.compute_similarity_top_k(x, "cosine", k=20)
    got = tm.compute_similarity_top_k(x, "cosine", k=20, device="cpu")
    assert np.diff(want.indptr).min() < 20  # a short row exists
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["dice", "asymmetric"])
def test_sweep_grid_similarity_names_raise_as_in_jax(name):
    m = sp.csr_matrix(_toy_interactions(5, 6, seed=1))
    for fn, kw in ((jm.compute_similarity_top_k, {}),
                   (tm.compute_similarity_top_k, {"device": "cpu"})):
        with pytest.raises(KeyError):
            fn(m, name, k=2, **kw)


def test_ifknn_over_tag_feature_hand_checked():
    """tests/test_matrix_algs.py's case on the port: the similarity over
    the multi-hot rows of a TAG feature, not its codes."""
    feat = tfeature.build_feature(
        FeatureDefinition("genres", FeatureType.TAG),
        ["a", "a|b", "b", "c"], n_entities=4)
    alg = tm.ItemFeatureKNN(k=4, feature_name="genres")
    alg.device = "cpu"
    train = sp.csr_matrix(np.array([[1, 0, 0, 0], [0, 0, 0, 1]],
                                   dtype=np.float32))
    alg.fit(matrix=train, feature_matrix=feat.dense_table())
    s = 1.0 / np.sqrt(2.0)
    np.testing.assert_allclose(alg.pred_mtx[0], [0.0, s, 0.0, 0.0],
                               atol=1e-5)
    np.testing.assert_allclose(alg.pred_mtx[1], [0.0, 0.0, 0.0, 0.0],
                               atol=1e-5)


# ------------------------------------------------------------- data layer
def test_sampling_matrix_and_popularity_match_jax(splits):
    js, ts = splits
    for split in ("train", "val", "test"):
        want, got = js[split].user_sampling_matrix, ts[split]\
            .user_sampling_matrix
        assert got.dtype == want.dtype == np.int8
        assert (got != want).nnz == 0
        np.testing.assert_array_equal(ts[split].pop_distribution,
                                      js[split].pop_distribution)
        assert ts[split].pop_distribution.dtype == np.float64


@pytest.mark.parametrize("kind", ["tag", "categorical", "vector",
                                  "continuous", "matrix"])
def test_dense_table_matches_jax(kind):
    rng = np.random.default_rng(2)
    idx = np.array([0, 2, 3, 5])  # entities 1 and 4 have no row
    raw = {"tag": ["x|y", "z", "y", "x|z"],
           "categorical": ["b", "a", "c", "a"],
           "vector": rng.normal(size=(4, 3)).astype(np.float32),
           "continuous": rng.normal(size=4).astype(np.float32),
           "matrix": rng.normal(size=(4, 2, 3)).astype(np.float32)}[kind]
    jf = jfeature.Feature.build(JaxFeatureDef("f", JaxFeatureType(kind)),
                                raw, 6, indices=idx)
    tf = tfeature.build_feature(FeatureDefinition("f", FeatureType(kind)),
                                raw, 6, indices=idx)
    want, got = jf.dense_table(), tf.dense_table()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_dense_table_budget_raises_jax_error(monkeypatch):
    raw = ["a|b", "c"]
    jf = jfeature.Feature.build(JaxFeatureDef("g", JaxFeatureType.TAG),
                                raw, 2)
    tf = tfeature.build_feature(FeatureDefinition("g", FeatureType.TAG),
                                raw, 2)
    monkeypatch.setattr(jfeature, "DENSE_TABLE_MAX_BYTES", 8)
    monkeypatch.setattr(tfeature, "DENSE_TABLE_MAX_BYTES", 8)
    with pytest.raises(ValueError) as want:
        jf.dense_table()
    with pytest.raises(ValueError) as got:
        tf.dense_table()
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------------- fits
@pytest.mark.parametrize("name", list(MODEL_CONFS))
def test_fit_matches_jax(splits, name):
    js, ts = splits
    ja, ta = _fit_both(name, js["train"], ts["train"])
    users, items = np.arange(40), np.arange(70)
    want = np.asarray(ja.predict(users, items))
    got = np.asarray(ta.predict(users, items))
    if name in ("rand", "pop", "uknn", "iknn"):
        np.testing.assert_array_equal(got, want)
    elif name == "ifknn":  # real-valued features: f32 sums in other orders
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    elif name in ("als", "svd", "rbmf"):
        np.testing.assert_allclose(got, want, rtol=1e-4 if name == "als"
                                   else 1e-5, atol=1e-5)
    else:  # ease, slim, p3alpha
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    if name == "slim":
        np.testing.assert_allclose(ta.weights, ja.weights, rtol=1e-4,
                                   atol=1e-6)
        assert (np.diag(ta.weights) == 0).all() and (ta.weights >= 0).all()
    if name == "rbmf":
        assert ta.users_factors.dtype == np.float64


def test_maxvol_indices_equal_jax():
    rng = np.random.default_rng(4)
    for shape in ((60, 5), (200, 12), (31, 31)):
        a = rng.normal(size=shape)
        np.testing.assert_array_equal(tm.maxvol(a), jm.maxvol(a))


def test_als_draws_its_own_start_and_solves_normal_equations(splits):
    """Without ``items_init`` the port draws its start (seeded 0, so two
    fits agree bit for bit), and the item factors solve the last half
    step's normal equations (tests/test_matrix_algs.py's check)."""
    ttrain = splits[1]["train"]
    fits = []
    for _ in range(2):
        als = tm.AlternatingLeastSquare(alpha=2.0, factors=6,
                                        regularization=0.5, n_iterations=3)
        als.device = "cpu"
        als.fit(ttrain.user_sampling_matrix)
        fits.append(als)
    np.testing.assert_array_equal(fits[0].items_factors,
                                  fits[1].items_factors)
    p = (ttrain.user_sampling_matrix.toarray() > 0).astype(np.float64)
    x = fits[0].users_factors.astype(np.float64)
    y = fits[0].items_factors.astype(np.float64)
    for i in range(p.shape[1]):
        m = (x.T @ x + (x * (2.0 * p[:, i])[:, None]).T @ x
             + 0.5 * np.eye(6))
        np.testing.assert_allclose(m @ y[i], x.T @ (3.0 * p[:, i]),
                                   rtol=2e-3, atol=2e-4)


# ------------------------------------------------------------- model.npz
@pytest.mark.parametrize("name", list(MODEL_CONFS))
def test_model_npz_loads_across_packages(splits, name, tmp_path):
    js, ts = splits
    ja, ta = _fit_both(name, js["train"], ts["train"])
    items = js["val"].items_in_split
    u = np.array([3, 0, 17, 39], np.int32)
    for direction, saver in (("jax_to_port", ja), ("port_to_jax", ta)):
        d = tmp_path / direction
        d.mkdir()
        saver.save(str(d))
        jl = jax_get_algorithm(name).build(MODEL_CONFS[name], js["train"])
        tl = get_algorithm(name).build(MODEL_CONFS[name], ts["train"], "cpu")
        jl.load(str(d))
        tl.load(str(d))
        want = np.asarray(jl.score_fn(items)(jnp.asarray(u)))
        got = tl.score_fn(items)(torch.as_tensor(u)).numpy()
        assert got.shape == want.shape == (4, len(items))
        if name == "rand":  # JAX's fold_in bits are not the port's draws
            assert int(np.load(d / "model.npz")["seed"]) == tl.seed
            continue
        if isinstance(tl, tm.FactorRecommender):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ evaluation
@pytest.fixture(scope="module")
def eval_splits():
    """C = 5,000 > 4,096: ``auto`` takes the peel on the port."""
    return (jax_splits(n_users=64, n_items=5000, n_interactions=4000,
                       seed=3, popularity_alpha=1.0),
            make_synthetic_splits(n_users=64, n_items=5000,
                                  n_interactions=4000, seed=3,
                                  popularity_alpha=1.0))


@pytest.fixture(scope="module")
def eval_fits(eval_splits):
    js, ts = eval_splits
    return {name: _fit_both(name, js["train"], ts["train"],
                            {"k": 20, "shrinkage": 10.0} if name == "iknn"
                            else {})
            for name in ("pop", "iknn")}


def _accelerator_masked_topk(scores, exclude_csr, u_idxs, k, method="auto",
                            return_ok=False):
    """JAX's `masked_topk` as its accelerator branch runs it (off the TPU
    it degrades ``peel`` and ``pallas`` to ``scatter``): the peel (with its
    in-graph fallback) or the windowed pipeline, in interpret mode."""
    c = scores.shape[-1]
    e = exclude_csr.max_row_len
    if method == "auto" and c > 4096 and k < c and jpeel.peel_viable(c, k, e):
        method = "peel"
    if method == "peel" and not jpeel.peel_viable(c, k, e):
        method = "scatter"
    if method not in ("peel", "pallas"):
        return jax_masked_topk(scores, exclude_csr, u_idxs, k, method=method,
                               return_ok=return_ok)
    cols, mask = jsparse.csr_row_gather(exclude_csr, u_idxs)
    tb = min(256, -(-scores.shape[0] // 8) * 8)
    if method == "peel":
        v, i = jpeel.peel_masked_topk_scores(scores, cols, mask, k, tb=tb,
                                             interpret=True)
    else:
        v, i = jwindow.pallas_masked_topk_scores(scores, cols, mask, k,
                                                 tb=tb, interpret=True)
    return (v, i, jnp.ones(scores.shape[0], bool)) if return_ok else (v, i)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", ["pop", "iknn"])
def test_evaluate_model_matches_jax(eval_splits, eval_fits, name, method,
                                    monkeypatch):
    """JAX's evaluator with its accelerator branch's selection (interpret
    mode): where ties span windows of different maxima, its CPU
    ``scatter`` orders them otherwise (``tests/test_torch_topk_ties.py``)."""
    monkeypatch.setattr(jevaluator, "masked_topk", _accelerator_masked_topk)
    js, ts = eval_splits
    ja, ta = eval_fits[name]
    conf = dict(top_k=[1, 5, 10, 50], topk_method=method)
    jev = JaxEvaluator(JaxEvalConfig(**conf), js["val"],
                       evaluator_name="val")
    want = jax_evaluate_model(ja.score_fn(js["val"].items_in_split), jev,
                              batch_size=16)
    tev = FullEvaluator(EvalConfig(**conf), ts["val"], device="cpu",
                        evaluator_name="val")
    got = evaluate_model(ta.score_fn(ts["val"].items_in_split), tev,
                         batch_size=16)
    assert list(got) == list(want)
    for key, v in want.items():
        np.testing.assert_allclose(got[key], v, rtol=0, atol=1e-6,
                                   err_msg=key)


def test_rand_scorer_is_uniform_deterministic_and_random_ranking(
        eval_splits):
    ts = eval_splits[1]
    alg = get_algorithm("rand").build({}, ts["train"], "cpu")
    items = ts["val"].items_in_split
    score = alg.score_fn(items)
    a = score(torch.tensor([5, 6, 7]))
    b = score(torch.tensor([5, 9, 1]))
    c = score(torch.tensor([6, 5, 7]))
    assert a.shape == (3, len(items)) and a.dtype == torch.float32
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    assert torch.equal(a, b) and not torch.equal(a, c)
    np.testing.assert_array_equal(
        alg.predict(np.arange(3), np.arange(8)),
        np.random.default_rng(0).random(8))

    k = 10
    ev = FullEvaluator(EvalConfig(top_k=[k], metrics=["recall"]), ts["val"],
                       device="cpu", evaluator_name="val")
    got = evaluate_model(score, ev, batch_size=16)["val/recall@10"]
    excl = ts["val"].exclude_matrix()
    pos = ts["val"].user_sampling_matrix
    mean = var = 0.0
    for u in ts["val"].users_in_split:  # hypergeometric hits per user
        n_pos = pos.indptr[u + 1] - pos.indptr[u]
        if not n_pos:
            continue
        n = len(items) - (excl.indptr[u + 1] - excl.indptr[u])
        p = n_pos / n
        mean += k / n
        var += k * p * (1 - p) * (n - k) / (n - 1) / n_pos ** 2
    n_users = len(ts["val"].users_in_split)
    mean, sd = mean / n_users, math.sqrt(var) / n_users
    assert abs(got - mean) <= 4 * sd, (got, mean, sd)
