"""The matrix algorithms (port of ``sibrar_tpu/models/matrix_algs.py``):
the KNN family over six similarities, EASE, SLIM, SVD, ALS, RBMF, P3alpha
and the Random / Popular baselines. Each fits once over the train CSR and
scores a batch of users against the catalog.

- similarities: dense blocks of rows times the whole matrix on the device
  (``torch.matmul`` in full f32, so 0/1 co-occurrence counts are exact),
  the self-similarity set to 0.0, then K13 `exact_topk` per block, which
  keeps ``lax.top_k``'s order; the rows go back to the host as a CSR in
  that order, zeros dropped;
- the KNN predictions are the JAX package's scipy products on the host;
- EASE, SLIM (batched FISTA), ALS and P3alpha compute on the device, SVD
  and RBMF on the host (``svds``, the greedy `maxvol`), as in JAX;
- every scorer (``score_fn(items_in_split)``) holds its f32 table on the
  algorithm's ``device`` once and gathers rows of it, or multiplies the
  factors.

``model.npz`` carries JAX's keys (``pred_mtx``; ``users_factors`` /
``items_factors``; ``seed``; ``pop_distribution``), so a run directory
loads in either package. ALS's initial item factors come from a
``torch.Generator`` seeded 0 (JAX draws them from ``PRNGKey(0)``), and the
random scorer's scores from a generator seeded by the batch's first user
(JAX folds it into its key): both follow the same rule with other draws.
"""
from __future__ import annotations

import math
import os
from typing import Callable, Optional

import numpy as np
import scipy.sparse as sp
import torch

from sibrar_tpu_torch import full_f32
from sibrar_tpu_torch.ops.exact_topk import exact_topk


# ---------------------------------------------------------------- similarities
def _pair_counts(block: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """Co-occurrence counts ``block @ matrix.T``."""
    return block @ matrix.T


def _ratio(num: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """``num / denom`` where ``denom > 0``, else 0.0 (a NaN denominator,
    from a negative row sum raised to a fractional power, included)."""
    return torch.where(denom > 0, num / denom, 0.0)


def _shrink(sim: torch.Tensor, co: torch.Tensor,
            shrinkage: float) -> torch.Tensor:
    if shrinkage > 0:
        sim = sim * (co / (co + shrinkage))
    return sim


def sim_cosine(block, matrix, row_stats, col_stats, shrinkage, **_):
    co = _pair_counts(block, matrix)
    denom = row_stats["norm"][:, None] * col_stats["norm"][None, :]
    return _shrink(_ratio(co, denom), co, shrinkage)


def sim_jaccard(block, matrix, row_stats, col_stats, shrinkage, **_):
    co = _pair_counts(block, matrix)
    denom = row_stats["count"][:, None] + col_stats["count"][None, :] - co
    return _shrink(_ratio(co, denom), co, shrinkage)


def sim_sorensen_dice(block, matrix, row_stats, col_stats, shrinkage, **_):
    co = _pair_counts(block, matrix)
    denom = row_stats["count"][:, None] + col_stats["count"][None, :]
    return _shrink(_ratio(2.0 * co, denom), co, shrinkage)


def sim_asymmetric_cosine(block, matrix, row_stats, col_stats, shrinkage, *,
                          alpha=0.5, **_):
    co = _pair_counts(block, matrix)
    denom = (row_stats["count"][:, None] ** alpha) * (
        col_stats["count"][None, :] ** (1.0 - alpha))
    return _shrink(_ratio(co, denom), co, shrinkage)


def sim_tversky(block, matrix, row_stats, col_stats, shrinkage, *,
                alpha=1.0, beta=1.0, **_):
    co = _pair_counts(block, matrix)
    denom = (co + alpha * (row_stats["count"][:, None] - co)
             + beta * (col_stats["count"][None, :] - co))
    return _shrink(_ratio(co, denom), co, shrinkage)


# JAX's six names; any other (the shipped sweep grids' "dice" and
# "asymmetric" among them) raises KeyError, as in JAX
SIMILARITY_FUNCTIONS: dict[str, Callable] = {
    "cosine": sim_cosine,
    "dense_cosine": sim_cosine,
    "jaccard": sim_jaccard,
    "sorensen_dice": sim_sorensen_dice,
    "asymmetric_cosine": sim_asymmetric_cosine,
    "tversky": sim_tversky,
}


def dense_on(matrix, device) -> torch.Tensor:
    """``matrix`` (scipy sparse or array-like) as a dense f32 tensor on
    ``device``; a sparse matrix is scattered there from its entries, so the
    host never holds its dense form."""
    if not sp.issparse(matrix):
        return torch.as_tensor(np.asarray(matrix, dtype=np.float32),
                               device=device)
    coo = sp.coo_matrix(matrix)
    coo.sum_duplicates()
    out = torch.zeros(coo.shape, dtype=torch.float32, device=device)
    out[torch.as_tensor(coo.row, device=device).long(),
        torch.as_tensor(coo.col, device=device).long()] = torch.as_tensor(
            coo.data.astype(np.float32), device=device)
    return out


def compute_similarity_top_k(matrix, sim_func_name: str = "cosine",
                             k: int = 100, shrinkage: float = 0.0,
                             block_size: int = 4096, device="cuda",
                             **sim_kwargs) -> sp.csr_matrix:
    """The top-``k`` similarities between the rows of ``matrix`` (JAX
    ``compute_similarity_top_k``): blocks of ``block_size`` rows against
    every row on ``device``, the self-similarity set to 0.0 before K13
    selects ``min(k, n - 1)`` per row. Returns a host CSR ``[n, n]`` whose
    rows keep the top-k order, exact zeros dropped (a row of real-valued
    features can rank its zeroed self above negative cosines and keep fewer
    than k entries)."""
    fn = SIMILARITY_FUNCTIONS[sim_func_name]
    full_f32()
    mat = dense_on(matrix, device)
    n = mat.shape[0]
    stats = {"norm": torch.linalg.norm(mat, dim=1), "count": mat.sum(dim=1)}
    k_eff = min(k, n - 1) if n > 1 else 1
    vals, cols = [], []
    for start in range(0, n, block_size):
        end = min(start + block_size, n)
        rows = torch.arange(start, end, device=mat.device)
        sim = fn(mat[start:end], mat, {s: v[start:end] for s, v in
                                       stats.items()},
                 stats, shrinkage, **sim_kwargs)
        sim[rows - start, rows] = 0.0
        v, i = exact_topk(sim.contiguous(), k_eff)
        vals.append(v.cpu().numpy())
        cols.append(i.to(torch.int32).cpu().numpy())
        del sim
    del mat
    indptr = np.arange(0, n * k_eff + 1, k_eff)
    out = sp.csr_matrix((np.concatenate(vals).ravel(),
                         np.concatenate(cols).ravel(), indptr), shape=(n, n))
    out.eliminate_zeros()
    return out


# ------------------------------------------------------------------------ base
class MatrixRecommender:
    """Base of the fit-once algorithms with a dense prediction matrix.
    ``device`` is where `fit` computes and where `score_fn` keeps its table
    (the registry's build sets it)."""

    def __init__(self):
        self.pred_mtx: Optional[np.ndarray] = None
        self.device = "cuda"

    def fit(self, matrix: sp.spmatrix, **kwargs):
        raise NotImplementedError

    def predict(self, u_idxs: np.ndarray, i_idxs: np.ndarray) -> np.ndarray:
        assert self.pred_mtx is not None, \
            "Prediction matrix not computed, run fit!"
        if sp.issparse(self.pred_mtx):
            self.pred_mtx = np.asarray(self.pred_mtx.todense())
        return self.pred_mtx[np.asarray(u_idxs)[:, None], np.asarray(i_idxs)]

    def score_fn(self, items_in_split: np.ndarray) -> Callable:
        """``fn(u_idxs) -> [B, C]``: rows of ``pred_mtx[:, items_in_split]``,
        moved to ``device`` once as f32 (no host copy when the split's
        catalog is every item in order)."""
        assert self.pred_mtx is not None
        pm = self.pred_mtx
        if sp.issparse(pm):
            pm = np.asarray(pm.todense())
        pm = np.asarray(pm)
        items = np.asarray(items_in_split)
        if not (len(items) == pm.shape[1]
                and np.array_equal(items, np.arange(pm.shape[1]))):
            pm = pm[:, items]
        sub = torch.as_tensor(pm.astype(np.float32, copy=False),
                              device=self.device)
        return lambda u_idxs: sub[u_idxs.long()]

    def save(self, path: str):
        np.savez(os.path.join(path, "model.npz"), pred_mtx=self.pred_mtx)

    def load(self, path: str):
        with np.load(os.path.join(path, "model.npz")) as d:
            self.pred_mtx = d["pred_mtx"]


class FactorRecommender(MatrixRecommender):
    """Factor-based variant: pred = users_factors @ items_factors.T."""

    def __init__(self):
        super().__init__()
        self.users_factors: Optional[np.ndarray] = None
        self.items_factors: Optional[np.ndarray] = None

    def predict(self, u_idxs, i_idxs):
        bu = self.users_factors[np.asarray(u_idxs)]
        bi = self.items_factors[np.asarray(i_idxs)]
        return (bu[:, None, :] * bi).sum(-1)

    def score_fn(self, items_in_split: np.ndarray) -> Callable:
        """``fn(u_idxs) -> uf[u] @ itf.T`` in full f32, both factor tables
        moved to ``device`` once as f32."""
        full_f32()
        uf = torch.as_tensor(np.asarray(self.users_factors, np.float32),
                             device=self.device)
        itf = torch.as_tensor(np.asarray(
            self.items_factors[np.asarray(items_in_split)], np.float32),
            device=self.device)
        return lambda u_idxs: uf[u_idxs.long()] @ itf.T

    def save(self, path: str):
        np.savez(os.path.join(path, "model.npz"),
                 users_factors=self.users_factors,
                 items_factors=self.items_factors)

    def load(self, path: str):
        with np.load(os.path.join(path, "model.npz")) as d:
            self.users_factors = d["users_factors"]
            self.items_factors = d["items_factors"]


# ------------------------------------------------------------------------- KNN
class KNNAlgorithm(MatrixRecommender):
    def __init__(self, sim_func_name: str = "cosine", k: int = 100,
                 shrinkage: float = 0.0, **sim_kwargs):
        super().__init__()
        self.sim_func_name = sim_func_name
        self.k = k
        self.shrinkage = shrinkage
        self.sim_kwargs = {k_: v for k_, v in sim_kwargs.items()
                           if v is not None}

    @staticmethod
    def build_from_conf(conf: dict, dataset):
        p = conf.get("sim_func_params", {})
        cls = {"uknn": UserKNN, "iknn": ItemKNN,
               "ifknn": ItemFeatureKNN}[conf["alg"]]
        kwargs = {}
        if conf["alg"] == "ifknn":
            kwargs["feature_name"] = conf.get("feature_name")
        return cls(sim_func_name=p.get("sim_func_name", "cosine"),
                   k=conf["k"], shrinkage=conf.get("shrinkage", 0.0),
                   alpha=p.get("alpha"), beta=p.get("beta"), **kwargs)

    def _sim(self, mat):
        return compute_similarity_top_k(
            mat, self.sim_func_name, self.k, self.shrinkage,
            device=self.device, **self.sim_kwargs)


class UserKNN(KNNAlgorithm):
    def fit(self, matrix: sp.spmatrix, **kwargs):
        sim = self._sim(matrix)
        self.pred_mtx = np.asarray((sim @ matrix).todense())


class ItemKNN(KNNAlgorithm):
    def fit(self, matrix: sp.spmatrix, **kwargs):
        sim = self._sim(matrix.T)
        self.pred_mtx = np.asarray((matrix @ sim.T).todense())


class ItemFeatureKNN(KNNAlgorithm):
    def __init__(self, *args, feature_name: Optional[str] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.feature_name = feature_name

    def fit(self, matrix: sp.spmatrix, feature_matrix: np.ndarray = None,
            **kwargs):
        sim = self._sim(feature_matrix)
        self.pred_mtx = np.asarray((matrix @ sim.T).todense())


# ------------------------------------------------------------------------ EASE
class EASE(MatrixRecommender):
    def __init__(self, lam: float):
        super().__init__()
        self.lam = lam

    def fit(self, matrix: sp.spmatrix, **kwargs):
        full_f32()
        a = dense_on(matrix, self.device)
        g = a.T @ a
        g = g + self.lam * torch.eye(g.shape[0], device=a.device)
        p = torch.linalg.inv(g)
        b = p / (-torch.diagonal(p))[None, :]
        b.fill_diagonal_(0.0)
        self.pred_mtx = (a @ b).cpu().numpy()

    @staticmethod
    def build_from_conf(conf: dict, dataset):
        return EASE(conf["lam"])


# ------------------------------------------------------------------------ SLIM
class SLIM(MatrixRecommender):
    """SLIM's ElasticNet objective per column j, ``0.5/n ||a_j - A w||^2 +
    alpha l1_ratio ||w||_1 + 0.5 alpha (1 - l1_ratio) ||w||^2`` with ``w >=
    0`` and ``diag(W) = 0``, solved for every column at once by FISTA on
    the device (JAX's arithmetic: the step from 21 power iterations, ``t``
    carried in f32). ``weights`` keeps W."""

    def __init__(self, alpha: float, l1_ratio: float, max_iter: int):
        super().__init__()
        self.alpha = alpha
        self.l1_ratio = l1_ratio
        self.max_iter = max_iter

    def fit(self, matrix: sp.spmatrix, **kwargs):
        full_f32()
        a = dense_on(matrix, self.device)
        n_users, n_items = a.shape
        l1 = self.alpha * self.l1_ratio * n_users
        l2 = self.alpha * (1.0 - self.l1_ratio) * n_users
        g = a.T @ a
        v = torch.ones(n_items, device=a.device) / math.sqrt(n_items)
        for _ in range(21):  # JAX: one step, then a fori_loop of 20
            v = g @ v + l2 * v
            v = v / torch.clamp(torch.linalg.norm(v), min=1e-12)
        lip = torch.clamp(v @ (g @ v) + l2, min=1e-6)
        step = 1.0 / lip
        eye_mask = 1.0 - torch.eye(n_items, device=a.device)
        w = torch.zeros((n_items, n_items), device=a.device)
        z, t = w, torch.ones((), device=a.device)
        for _ in range(self.max_iter):
            grad = g @ z - g + l2 * z
            w_new = z - step * grad
            w_new = torch.clamp(w_new - step * l1, min=0.0) * eye_mask
            t_new = (1.0 + torch.sqrt(1.0 + 4.0 * t * t)) / 2.0
            z = w_new + ((t - 1.0) / t_new) * (w_new - w)
            w, t = w_new, t_new
        self.pred_mtx = (a @ w).cpu().numpy()
        self.weights = w.cpu().numpy()

    @staticmethod
    def build_from_conf(conf: dict, dataset):
        return SLIM(conf["alpha"], conf["l1_ratio"], conf["max_iter"])


# ------------------------------------------------------------------------- SVD
class SVDAlgorithm(FactorRecommender):
    def __init__(self, factors: int = 100):
        super().__init__()
        self.factors = factors

    def fit(self, matrix: sp.spmatrix, **kwargs):
        from scipy.sparse.linalg import svds

        matrix = sp.csr_matrix(matrix).asfptype()
        u, s, vt = svds(matrix, k=self.factors)
        self.users_factors = u * s
        self.items_factors = vt.T

    @staticmethod
    def build_from_conf(conf: dict, dataset):
        return SVDAlgorithm(conf.get("n_factors", conf.get("factors", 100)))


# ------------------------------------------------------------------------- ALS
class AlternatingLeastSquare(FactorRecommender):
    """Implicit-feedback ALS (Hu et al. 2008) on the device. Each half step
    solves every entity's ridge system ``(Y^T Y + alpha Y^T diag(p) Y + reg
    I) x = (1 + alpha) Y^T p`` (p the entity's 0/1 row) in one batched
    ``torch.linalg.solve``; the systems' middle terms come from one product
    ``P @ Z`` with ``Z[o] = vec(y_o y_o^T)``, not from JAX's per-entity
    ``[n_other, f]`` copies. The item factors start as ``0.01 N(0, 1)``
    from a generator seeded 0 (``items_init`` replaces them); the users'
    are solved first, so they need no start."""

    def __init__(self, alpha: float, factors: int, regularization: float,
                 n_iterations: int):
        super().__init__()
        self.alpha = alpha
        self.factors = factors
        self.regularization = regularization
        self.n_iterations = n_iterations

    def _half_step(self, y: torch.Tensor, pref: torch.Tensor) -> torch.Tensor:
        """The factors of ``pref``'s rows given the other side's ``y``."""
        n_other, f = y.shape
        z = (y[:, :, None] * y[:, None, :]).reshape(n_other, f * f)
        m = (y.T @ y + self.alpha * (pref @ z).view(-1, f, f)
             + self.regularization * torch.eye(f, device=y.device))
        b = (pref * (1.0 + self.alpha)) @ y
        return torch.linalg.solve(m, b)

    def fit(self, matrix: sp.spmatrix, items_init: Optional[np.ndarray] = None,
            **kwargs):
        full_f32()
        p = (dense_on(matrix, self.device) > 0).float()
        n_items = p.shape[1]
        if items_init is None:
            gen = torch.Generator().manual_seed(0)
            y = 0.01 * torch.randn((n_items, self.factors), generator=gen)
        else:
            y = torch.tensor(np.asarray(items_init, np.float32))
        y = y.to(p.device)
        pt = p.T.contiguous()
        for _ in range(self.n_iterations):
            x = self._half_step(y, p)
            y = self._half_step(x, pt)
        self.users_factors = x.cpu().numpy()
        self.items_factors = y.cpu().numpy()

    @staticmethod
    def build_from_conf(conf: dict, dataset):
        return AlternatingLeastSquare(
            conf["alpha"], conf["factors"], conf["regularization"],
            conf["n_iterations"])


# ------------------------------------------------------------------------ RBMF
def maxvol(a: np.ndarray, tol: float = 1.05,
           max_iters: int = 100) -> np.ndarray:
    """Greedy maxvol: indices of ``a.shape[1]`` rows of ``a`` with a large
    ``|det|`` of the submatrix (Goreinov et al.): greedy pivots by residual
    norm, then single-row swaps while a coefficient exceeds ``tol``. The
    JAX package's host code."""
    n, r = a.shape
    idx = []
    rest = a.copy()
    chosen = np.zeros(n, dtype=bool)
    for _ in range(r):
        norms = np.linalg.norm(rest, axis=1)
        norms[chosen] = -1
        j = int(np.argmax(norms))
        idx.append(j)
        chosen[j] = True
        v = rest[j] / max(rest[j] @ rest[j], 1e-12)
        rest = rest - np.outer(rest @ rest[j], v)
    idx = np.array(idx)
    for _ in range(max_iters):
        b = a @ np.linalg.pinv(a[idx])  # [n, r]
        i, j = np.unravel_index(np.argmax(np.abs(b)), b.shape)
        if np.abs(b[i, j]) <= tol:
            break
        idx[j] = i
    return idx


class RBMF(FactorRecommender):
    def __init__(self, n_representatives: int, lam: float = 1e-2):
        super().__init__()
        self.n_representatives = n_representatives
        self.lam = lam

    def fit(self, matrix: sp.spmatrix, **kwargs):
        from scipy.sparse.linalg import svds

        matrix = sp.csr_matrix(matrix).asfptype()
        u, _, _ = svds(matrix, k=self.n_representatives)
        idxs = maxvol(u)
        c = matrix[idxs].toarray()  # [r, n_items]
        inv = np.linalg.inv(c @ c.T
                            + self.lam * np.eye(self.n_representatives))
        self.users_factors = np.asarray(matrix @ c.T @ inv)  # f64 [n_users, r]
        self.items_factors = c.T  # [n_items, r]

    @staticmethod
    def build_from_conf(conf: dict, dataset):
        return RBMF(conf["n_representatives"], conf.get("lam", 1e-2))


# --------------------------------------------------------------------- P3alpha
class P3alpha(MatrixRecommender):
    def __init__(self, alpha: float = 1.9):
        super().__init__()
        assert alpha >= 0
        self.alpha = alpha

    def fit(self, matrix: sp.spmatrix, **kwargs):
        full_f32()
        m = dense_on(matrix, self.device)
        user_deg = torch.clamp(m.sum(dim=1, keepdim=True), min=1e-12)
        item_deg = torch.clamp(m.sum(dim=0, keepdim=True), min=1e-12)
        p_ui = m / user_deg  # user -> item transitions
        p_iu = (m / item_deg).T  # item -> user transitions
        # three steps on the bipartite graph, u -> i -> u -> i; the power on
        # the host, as in JAX
        self.pred_mtx = np.power((p_ui @ (p_iu @ p_ui)).cpu().numpy(),
                                 self.alpha)

    @staticmethod
    def build_from_conf(conf: dict, dataset):
        return P3alpha(alpha=conf["alpha"])


# ----------------------------------------------------------------------- naive
class RandomItems(MatrixRecommender):
    def __init__(self, seed: int = 0):
        super().__init__()
        self.seed = seed

    def fit(self, matrix: sp.spmatrix = None, **kwargs):
        pass

    def predict(self, u_idxs, i_idxs):
        rng = np.random.default_rng(self.seed)
        return rng.random(np.asarray(i_idxs).shape)

    def score_fn(self, items_in_split: np.ndarray) -> Callable:
        """``fn(u_idxs) -> U[0, 1) [B, C]``, a pure function of the seed and
        the batch's first user: a generator on ``device`` seeded with a
        32-bit hash of both (JAX folds the user into its key; the CPU
        generator keeps 32 bits of a seed)."""
        n, device = len(items_in_split), self.device

        def score(u_idxs: torch.Tensor) -> torch.Tensor:
            key = np.random.SeedSequence([self.seed, int(u_idxs[0])])
            gen = torch.Generator(device=device).manual_seed(
                int(key.generate_state(1)[0]))
            return torch.rand((u_idxs.shape[0], n), generator=gen,
                              device=device)

        return score

    def save(self, path: str):
        np.savez(os.path.join(path, "model.npz"), seed=self.seed)

    def load(self, path: str):
        with np.load(os.path.join(path, "model.npz")) as d:
            self.seed = int(d["seed"])

    @staticmethod
    def build_from_conf(conf: dict, dataset):
        return RandomItems()


class PopularItems(MatrixRecommender):
    def __init__(self, pop_distribution: np.ndarray):
        super().__init__()
        self.pop_distribution = np.asarray(pop_distribution)

    def fit(self, matrix: sp.spmatrix = None, **kwargs):
        pass

    def predict(self, u_idxs, i_idxs):
        return self.pop_distribution[np.asarray(i_idxs)]

    def score_fn(self, items_in_split: np.ndarray) -> Callable:
        """``fn(u_idxs) -> [B, C]``: the f32 popularity of the catalog in
        every row."""
        pop = torch.as_tensor(np.asarray(
            self.pop_distribution[np.asarray(items_in_split)], np.float32),
            device=self.device)
        return lambda u_idxs: pop.expand(u_idxs.shape[0], -1).contiguous()

    def save(self, path: str):
        np.savez(os.path.join(path, "model.npz"),
                 pop_distribution=self.pop_distribution)

    def load(self, path: str):
        with np.load(os.path.join(path, "model.npz")) as d:
            self.pop_distribution = d["pop_distribution"]

    @staticmethod
    def build_from_conf(conf: dict, dataset):
        return PopularItems(dataset.pop_distribution)
