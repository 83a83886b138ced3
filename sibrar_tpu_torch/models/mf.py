"""Bias baseline, matrix factorization and anchor CF (port of
``sibrar_tpu/models/mf.py``: ``SGDBaseline`` ``sgdbias``,
``SGDMatrixFactorization`` ``mf``, ``ACF`` ``acf``).

Each model keeps the JAX package's ``table_index_map``: the id-embedding
tables it looks up exactly once per train forward, with the user batch
``[B]`` or the item batch ``[B, 1 + n]``, which the row-sparse table
optimizer (``train/row_adam.py``) may update row by row. Tables are
`layers.Embedding` (N(0, 0.1 / dim) init, drawn from the CPU generator of
``seed``); the built model lands on the device of its ``DeviceData``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from sibrar_tpu_torch.models.base import RecModel
from sibrar_tpu_torch.models.layers import Embedding


class SGDBaseline(RecModel):
    """Global + user + item bias model (Koren's baseline predictor)."""

    table_index_map = {"user_bias": "user", "item_bias": "item"}

    def __init__(self, n_users: int, n_items: int, gen: torch.Generator):
        super().__init__()
        self.user_bias = Embedding(n_users, 1, gen)
        self.item_bias = Embedding(n_items, 1, gen)
        self.global_bias = nn.Parameter(torch.zeros(1))

    def user_repr(self, u_idxs: torch.Tensor) -> torch.Tensor:
        return self.user_bias(u_idxs)  # [B, 1]

    def item_repr(self, i_idxs: torch.Tensor) -> torch.Tensor:
        return self.item_bias(i_idxs)[..., 0]  # [B, 1 + n] or [C]

    def combine(self, u_repr, i_repr):
        if i_repr.ndim == 1:  # catalog layout [C]
            return u_repr + i_repr[None, :] + self.global_bias
        return u_repr + i_repr + self.global_bias


class SGDMatrixFactorization(RecModel):
    """Embedding dot-product MF with optional user / item / global
    biases."""

    table_index_map = {"user_embeddings": "user", "item_embeddings": "item",
                       "user_bias": "user", "item_bias": "item"}

    def __init__(self, n_users: int, n_items: int, gen: torch.Generator,
                 embedding_dim: int = 100, use_user_bias: bool = False,
                 use_item_bias: bool = False, use_global_bias: bool = False):
        super().__init__()
        self.use_user_bias = use_user_bias
        self.use_item_bias = use_item_bias
        self.use_global_bias = use_global_bias
        self.user_embeddings = Embedding(n_users, embedding_dim, gen)
        self.item_embeddings = Embedding(n_items, embedding_dim, gen)
        if use_user_bias:
            self.user_bias = Embedding(n_users, 1, gen)
        if use_item_bias:
            self.item_bias = Embedding(n_items, 1, gen)
        if use_global_bias:
            self.global_bias = nn.Parameter(torch.zeros(1))

    def user_repr(self, u_idxs: torch.Tensor):
        if self.use_user_bias:
            return self.user_embeddings(u_idxs), self.user_bias(u_idxs)
        return self.user_embeddings(u_idxs)

    def item_repr(self, i_idxs: torch.Tensor):
        if self.use_item_bias:
            return (self.item_embeddings(i_idxs),
                    self.item_bias(i_idxs)[..., 0])
        return self.item_embeddings(i_idxs)

    @property
    def combine_is_dot(self) -> bool:
        return not (self.use_user_bias or self.use_item_bias
                    or self.use_global_bias)

    def eval_rank_dot_parts(self, user_repr_fn, i_repr):
        """User and global biases shift every item of a user equally (rank
        invariant); the item bias joins the dot as a last column against a
        constant 1, so every bias combination ranks like a dot product."""
        i_embed, i_bias = (i_repr if isinstance(i_repr, tuple)
                           else (i_repr, None))

        def u_fn(u_idxs):
            r = user_repr_fn(u_idxs)
            u_embed = r[0] if isinstance(r, tuple) else r
            if i_bias is None:
                return u_embed
            return torch.cat([u_embed, u_embed.new_ones(
                u_embed.shape[0], 1)], dim=1)

        items = (i_embed if i_bias is None
                 else torch.cat([i_embed, i_bias[:, None]], dim=1))
        return u_fn, items

    def combine(self, u_repr, i_repr):
        u_embed, u_bias = (u_repr if isinstance(u_repr, tuple)
                           else (u_repr, None))
        i_embed, i_bias = (i_repr if isinstance(i_repr, tuple)
                           else (i_repr, None))
        if i_embed.ndim == 2:  # catalog layout
            out = u_embed @ i_embed.T
            if i_bias is not None:
                out = out + i_bias[None, :]
        else:
            out = torch.einsum("be,bce->bc", u_embed, i_embed)
            if i_bias is not None:
                out = out + i_bias
        if u_bias is not None:
            out = out + u_bias
        if self.use_global_bias:
            out = out + self.global_bias
        return out

    @staticmethod
    def build_from_conf(conf: dict, dataset, gen: torch.Generator
                        ) -> "SGDMatrixFactorization":
        return SGDMatrixFactorization(
            dataset.n_users, dataset.n_items, gen,
            embedding_dim=conf.get("embedding_dim", 100),
            use_user_bias=conf.get("use_user_bias", False),
            use_item_bias=conf.get("use_item_bias", False),
            use_global_bias=conf.get("use_global_bias", False))


class ACF(RecModel):
    """Anchor-based CF: softmax attention over shared anchors; the train
    forward adds the exclusiveness (entropy) and inclusiveness losses."""

    table_index_map = {"user_embed": "user", "item_embed": "item"}

    def __init__(self, n_users: int, n_items: int, gen: torch.Generator,
                 embedding_dim: int = 100, n_anchors: int = 20,
                 delta_exc: float = 1e-1, delta_inc: float = 1e-2):
        super().__init__()
        self.n_anchors = n_anchors
        self.delta_exc = delta_exc
        self.delta_inc = delta_inc
        # the anchors need a non-small init for stability (N(0, 1))
        self.anchors = nn.Parameter(torch.randn(
            n_anchors, embedding_dim, generator=gen))
        self.user_embed = Embedding(n_users, embedding_dim, gen)
        self.item_embed = Embedding(n_items, embedding_dim, gen)

    def user_repr(self, u_idxs: torch.Tensor) -> torch.Tensor:
        c_u = torch.softmax(self.user_embed(u_idxs) @ self.anchors.T, dim=-1)
        return c_u @ self.anchors

    def item_repr(self, i_idxs: torch.Tensor):
        c_i_unnorm = self.item_embed(i_idxs) @ self.anchors.T
        c_i = torch.softmax(c_i_unnorm, dim=-1)
        return c_i @ self.anchors, c_i, c_i_unnorm

    def combine(self, u_repr, i_repr):
        i_anc = i_repr[0]
        if i_anc.ndim == 2:
            return u_repr @ i_anc.T
        return torch.einsum("be,bce->bc", u_repr, i_anc)

    def forward(self, u_idxs: torch.Tensor, i_idxs: torch.Tensor, *,
                gen=None, delta=None):
        """``(dots, reg)``; in train mode ``reg`` is ``delta_exc`` times the
        mean entropy of the items' anchor assignments (from the
        unnormalized logits) plus ``delta_inc`` times ``log(n_anchors)``
        less the entropy of the overall anchor usage."""
        u_repr = self.user_repr(u_idxs)
        i_repr = self.item_repr(i_idxs)
        dots = self.combine(u_repr, i_repr)
        reg = torch.zeros((), device=dots.device)
        if self.training:
            _, c_i, c_i_unnorm = i_repr
            lse = torch.logsumexp(c_i_unnorm, dim=-1, keepdim=True)
            exc = (-(c_i * (c_i_unnorm - lse)).sum(-1)).mean()
            q_k = c_i.reshape(-1, self.n_anchors).sum(0) / c_i.sum()
            inc = math.log(self.n_anchors) - (-q_k * torch.log(q_k)).sum()
            reg = self.delta_exc * exc + self.delta_inc * inc
        return dots, reg
