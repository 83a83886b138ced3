"""ECF: cluster-anchored collaborative filtering with tag supervision (port
of ``sibrar_tpu/models/ecf.py``).

Items are affiliated to learned cluster anchors, ``x_i = sigmoid(x~_i) *
m_i`` with ``x~_i`` the cosine of the item's embedding to each anchor and
``m_i`` a straight-through top-``top_m`` mask; users by their train rows,
``a_u = sigmoid(a~_u) * m_u`` with ``a~_u = y_u @ x~`` and a top-``top_n``
mask; the score is ``<a_u, x_i>``. The train forward adds three losses:
the tag loss (``ts_loss``, the negated top-``top_p`` log-softmax of the
clusters' tag affinities, summed), the independence loss (``ind_loss``,
the negated log-softmax diagonal of the anchors' cosines) and a BPR on
the raw embeddings (``cf_loss``).

The hard masks come from `ops.exact_topk.exact_topk` (K13 on the card, its
plain version on the CPU): ``lax.top_k``'s order, ties to the lower index,
which decides the mask of a user with an empty train row (every entry
ties). The masks are ``m~ + (m_hard - m~).detach()`` with ``m~`` the
softmax at ``temp_masking``, which in floats is not ``m_hard``. Every
table lookup is `layers.lookup` (K6 / K7 on the card); ``y_u @ x~`` is a
plain product.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from sibrar_tpu_torch.models.base import NamedLossModel
from sibrar_tpu_torch.models.layers import (
    InteractionVectorModule,
    embedding_init_,
    lookup,
)
from sibrar_tpu_torch.models.protomf import cosine_sim
from sibrar_tpu_torch.ops.exact_topk import exact_topk


def ecf_tag_matrix_from_feature(tag_feature, n_items: int) -> np.ndarray:
    """Dense ``[n_items, n_tags]`` multi-hot of a tag feature (pad id ==
    ``n_categories``), each tag's column weighted by its log-IDF
    ``log(n_items / (frequency + 1e-6))``."""
    table = np.asarray(tag_feature.table)
    n_tags = tag_feature.n_categories
    mat = np.zeros((n_items, n_tags), dtype=np.float32)
    rows = np.repeat(np.arange(n_items), table.shape[1])
    cols = table.ravel()
    valid = cols != n_tags
    mat[rows[valid], cols[valid]] = 1.0
    tag_frequency = mat.sum(axis=0)
    tag_weight = np.log(n_items / (tag_frequency + 1e-6))
    return mat * tag_weight[None, :]


def topk_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices ``[..., k]`` of the top-k of the last axis in
    ``lax.top_k``'s order (`exact_topk`), without gradient."""
    flat = x.detach().reshape(-1, x.shape[-1]).contiguous()
    _, idx = exact_topk(flat, k)
    return idx.reshape(*x.shape[:-1], idx.shape[-1])


def hard_topk_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The 0/1 mask of each row's top-k (`topk_indices`)."""
    idx = topk_indices(scores, k)
    return torch.zeros_like(scores).scatter_(-1, idx, 1.0)


class ECF(NamedLossModel):
    def __init__(self, n_users: int, n_items: int, tag_matrix: np.ndarray,
                 interactions: InteractionVectorModule,
                 gen: torch.Generator, embedding_dim: int = 100,
                 n_clusters: int = 64, top_n: int = 20, top_m: int = 20,
                 temp_masking: float = 2.0, temp_tags: float = 2.0,
                 top_p: int = 4, lam_cf: float = 0.6, lam_ind: float = 1.0,
                 lam_ts: float = 1.0):
        super().__init__()
        self.top_n, self.top_m, self.top_p = top_n, top_m, top_p
        self.temp_masking, self.temp_tags = temp_masking, temp_tags
        self.lam_cf, self.lam_ind, self.lam_ts = lam_cf, lam_ind, lam_ts
        self.user_embedding = nn.Parameter(embedding_init_(
            torch.empty(n_users, embedding_dim), gen))
        self.item_embedding = nn.Parameter(embedding_init_(
            torch.empty(n_items, embedding_dim), gen))
        self.clusters = nn.Parameter(embedding_init_(
            torch.empty(n_clusters, embedding_dim), gen))
        # a constant of the data (JAX's `tables` collection)
        self.register_buffer("tag_matrix", torch.as_tensor(
            np.asarray(tag_matrix, np.float32)), persistent=False)
        self.interactions = interactions

    # --------------------------------------------------------- internals
    def _masked_affiliation(self, tilde: torch.Tensor, k: int
                            ) -> torch.Tensor:
        m_tilde = torch.softmax(tilde / self.temp_masking, dim=-1)
        m_hard = hard_topk_mask(tilde, min(k, tilde.shape[-1]))
        m_hat = m_tilde + (m_hard - m_tilde).detach()
        return torch.sigmoid(tilde) * m_hat

    def _x_tildes(self) -> torch.Tensor:
        """``[n_items, n_clusters]`` cosines of every item to the anchors."""
        return cosine_sim(self.item_embedding, self.clusters)

    def _xs(self, x_tildes=None) -> torch.Tensor:
        x_tildes = self._x_tildes() if x_tildes is None else x_tildes
        return self._masked_affiliation(x_tildes, self.top_m)

    # ------------------------------------------------------------- reprs
    def user_repr(self, u_idxs: torch.Tensor, x_tildes=None):
        """``(a_u, user embedding)``; ``x_tildes`` given saves recomputing
        the catalog's cosines (one train step uses them twice)."""
        x_tildes = self._x_tildes() if x_tildes is None else x_tildes
        y_u = self.interactions(u_idxs)  # [B, n_items]
        a_tilde = y_u @ x_tildes
        a_u = self._masked_affiliation(a_tilde, self.top_n)
        return a_u, lookup(self.user_embedding, u_idxs)

    def item_repr(self, i_idxs: torch.Tensor, xs=None):
        xs = self._xs() if xs is None else xs
        return lookup(xs, i_idxs), lookup(self.item_embedding, i_idxs)

    def eval_rank_dot_parts(self, user_repr_fn, i_repr):
        """The score is the dot of the affiliations; the embeddings only
        feed the train losses."""
        x_i, _ = i_repr
        return (lambda u_idxs: user_repr_fn(u_idxs)[0]), x_i

    def combine(self, u_repr, i_repr):
        a_u, x_i = u_repr[0], i_repr[0]
        if x_i.ndim == 2:
            return a_u @ x_i.T
        return torch.einsum("bk,bck->bc", a_u, x_i)

    def forward_losses(self, u_idxs: torch.Tensor, i_idxs: torch.Tensor
                       ) -> tuple[torch.Tensor, dict]:
        """``(logits, {"ts_loss", "ind_loss", "cf_loss"})``, the losses in
        train mode only."""
        x_tildes = self._x_tildes()  # once: JAX's XLA merges the two uses
        xs = self._xs(x_tildes)
        u_repr = self.user_repr(u_idxs, x_tildes)
        i_repr = self.item_repr(i_idxs, xs)
        dots = self.combine(u_repr, i_repr)
        if not self.training:
            return dots, {}
        d_c = xs.T @ self.tag_matrix  # [n_clusters, n_tags]
        log_b_c = torch.log_softmax(d_c / self.temp_tags, dim=-1)
        top = topk_indices(log_b_c, min(self.top_p, log_b_c.shape[-1]))
        top_log = log_b_c.gather(-1, top)
        sim = cosine_sim(self.clusters, self.clusters)
        diag = torch.diagonal(-torch.log_softmax(sim, dim=-1))
        u_emb, i_emb = u_repr[1], i_repr[1]
        logits = (torch.einsum("be,bce->bc", u_emb, i_emb) if i_emb.ndim == 3
                  else u_emb @ i_emb.T)
        diff = logits[:, :1] - logits[:, 1:]
        bpr = torch.nn.functional.softplus(-diff).mean()
        return dots, {"ts_loss": self.lam_ts * (-top_log).sum(),
                      "ind_loss": self.lam_ind * diag.sum(),
                      "cf_loss": self.lam_cf * bpr}

    @staticmethod
    def build_from_conf(conf: dict, dataset, device_data,
                        gen: torch.Generator) -> "ECF":
        """JAX's keys and defaults; the tag matrix from the item feature
        ``tag_feature`` (default ``tags``)."""
        tag_feature = dataset.item_features[conf.get("tag_feature", "tags")]
        return ECF(
            dataset.n_users, dataset.n_items,
            ecf_tag_matrix_from_feature(tag_feature, dataset.n_items),
            InteractionVectorModule(device_data.user_inter_csr), gen,
            embedding_dim=conf.get("embedding_dim", 100),
            n_clusters=conf.get("n_clusters", 64),
            top_n=conf.get("top_n", 20), top_m=conf.get("top_m", 20),
            temp_masking=conf.get("temp_masking", 2.0),
            temp_tags=conf.get("temp_tags", 2.0),
            top_p=conf.get("top_p", 4), lam_cf=conf.get("lam_cf", 0.6),
            lam_ind=conf.get("lam_ind", 1.0),
            lam_ts=conf.get("lam_ts", 1.0))
