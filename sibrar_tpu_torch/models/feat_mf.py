"""Feature matrix factorization, CLCRec style (port of
``sibrar_tpu/models/feat_mf.py``: ``ItemFeatureMatrixFactorization``
``ifeatmf`` and ``UserFeatureMatrixFactorization`` ``ufeatmf``).

MF with optional user / item / global biases, plus a content tower on one
feature of one entity (``entity``: ``"item"`` or ``"user"``). The train
forward adds ``lambda_content`` times the InfoNCE between the profile
embeddings and the content embeddings of that entity. With
``aggregate_for_rec`` the profile and content embeddings are averaged for
the score; otherwise the score uses the profile embeddings alone.

On the user side JAX contrasts ``[B, 1, d]`` against ``[B, 1, d]``: a
contrast set of one, whose log-softmax is exactly 0, so the InfoNCE term is
exactly 0 and trains nothing. The port keeps that (the content tower of
``ufeatmf`` only enters the score under ``aggregate_for_rec``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sibrar_tpu_torch.models.base import RecModel
from sibrar_tpu_torch.models.layers import (
    Embedding,
    FeatureEmbeddingModule,
    feature_module_from,
)
from sibrar_tpu_torch.train.losses import info_nce


class FeatureMF(RecModel):
    """Representations are tuples, as in JAX: ``(profile, content?,
    bias?)`` with the content only on ``entity``'s side and the bias only
    where it is used; a single part is returned bare."""

    # row-sparse optimizer eligibility (LearningConfig.sparse_tables)
    table_index_map = {"user_embeddings": "user", "item_embeddings": "item",
                       "user_bias": "user", "item_bias": "item"}

    def __init__(self, n_users: int, n_items: int, entity: str,
                 content_net: FeatureEmbeddingModule, gen: torch.Generator,
                 *, embedding_dim: int = 100, aggregate_for_rec: bool = False,
                 lambda_content: float = 1e-4, temperature: float = 0.1,
                 embedding_loss_aggregator: str = "mean",
                 use_user_bias: bool = False, use_item_bias: bool = False,
                 use_global_bias: bool = False):
        super().__init__()
        if entity not in ("user", "item"):
            raise ValueError(f"entity must be 'user' or 'item', got "
                             f"{entity!r}")
        self.entity = entity
        self.aggregate_for_rec = aggregate_for_rec
        self.lambda_content = lambda_content
        self.temperature = temperature
        self.embedding_loss_aggregator = embedding_loss_aggregator
        self.use_user_bias = use_user_bias
        self.use_item_bias = use_item_bias
        self.use_global_bias = use_global_bias
        self.user_embeddings = Embedding(n_users, embedding_dim, gen)
        self.item_embeddings = Embedding(n_items, embedding_dim, gen)
        self.content_net = content_net
        if use_user_bias:
            self.user_bias = Embedding(n_users, 1, gen)
        if use_item_bias:
            self.item_bias = Embedding(n_items, 1, gen)
        if use_global_bias:
            self.global_bias = nn.Parameter(torch.zeros(1))

    # ---------------------------------------------------- representations
    def _repr(self, entity: str, idxs: torch.Tensor):
        table = (self.user_embeddings if entity == "user"
                 else self.item_embeddings)
        parts = [table(idxs)]
        if self.entity == entity:
            parts.append(self.content_net(idxs))
        if entity == "user" and self.use_user_bias:
            parts.append(self.user_bias(idxs)[..., 0])
        if entity == "item" and self.use_item_bias:
            parts.append(self.item_bias(idxs)[..., 0])
        return tuple(parts) if len(parts) > 1 else parts[0]

    def user_repr(self, u_idxs: torch.Tensor):
        return self._repr("user", u_idxs)

    def item_repr(self, i_idxs: torch.Tensor):
        return self._repr("item", i_idxs)

    # ---------------------------------------------------------- combining
    def _fuse(self, parts, has_content: bool
              ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``(embedding used for the score, bias or None)``."""
        if not isinstance(parts, tuple):
            return parts, None
        parts = list(parts)
        has_bias = len(parts) == 3 or (len(parts) == 2 and not has_content)
        bias = parts.pop() if has_bias else None
        if has_content and self.aggregate_for_rec:
            return (parts[0] + parts[1]) / 2.0, bias
        return parts[0], bias

    def eval_rank_dot_parts(self, user_repr_fn, i_repr):
        """User and global biases shift every item of a user equally (rank
        invariant); the item bias joins the dot as a last column against a
        constant 1, so every variant ranks like a dot product."""
        i_embed, i_bias = self._fuse(i_repr, self.entity == "item")

        def u_fn(u_idxs):
            u_embed, _ = self._fuse(user_repr_fn(u_idxs),
                                    self.entity == "user")
            if i_bias is None:
                return u_embed
            return torch.cat([u_embed, u_embed.new_ones(
                u_embed.shape[0], 1)], dim=1)

        items = (i_embed if i_bias is None
                 else torch.cat([i_embed, i_bias[:, None]], dim=1))
        return u_fn, items

    def combine(self, u_repr, i_repr) -> torch.Tensor:
        u_embed, u_bias = self._fuse(u_repr, self.entity == "user")
        i_embed, i_bias = self._fuse(i_repr, self.entity == "item")
        if i_embed.ndim == 2:  # catalog layout
            out = u_embed @ i_embed.T
            if i_bias is not None:
                out = out + i_bias[None, :]
        else:
            out = torch.einsum("be,bce->bc", u_embed, i_embed)
            if i_bias is not None:
                out = out + i_bias
        if u_bias is not None:
            out = out + u_bias[:, None]
        if self.use_global_bias:
            out = out + self.global_bias
        return out

    def forward(self, u_idxs: torch.Tensor, i_idxs: torch.Tensor, *,
                gen=None, delta=None):
        """``(dots, reg)``; in train mode ``reg`` is ``lambda_content``
        times the InfoNCE between the profile and content embeddings of
        ``entity`` (items: the candidates of a row contrast each other;
        users: a contrast set of one, exactly 0)."""
        u_repr = self.user_repr(u_idxs)
        i_repr = self.item_repr(i_idxs)
        dots = self.combine(u_repr, i_repr)
        reg = torch.zeros((), device=dots.device)
        if self.training:
            if self.entity == "item":
                profile, content = i_repr[0], i_repr[1]
            else:
                profile, content = u_repr[0][:, None], u_repr[1][:, None]
            reg = self.lambda_content * info_nce(
                profile, content, temperature=self.temperature,
                aggregator=self.embedding_loss_aggregator)
        return dots, reg

    @staticmethod
    def build_from_conf(entity: str, conf: dict, dataset, device_data,
                        gen: torch.Generator) -> "FeatureMF":
        """JAX's keys and defaults: ``feature_name``, ``embedding_dim`` 100,
        ``intermediate_layers`` (the content net's hidden layers),
        ``aggregate_for_rec`` off, ``lambda_content`` 1e-4,
        ``temperature`` 0.1, ``embedding_loss_aggregator`` mean, the three
        biases off. The content net is drawn first, then the tables."""
        embedding_dim = conf.get("embedding_dim", 100)
        content = feature_module_from(
            dataset, device_data, entity, conf["feature_name"], gen,
            embedding_dim=embedding_dim,
            pre_embedding_layers=conf.get("intermediate_layers") or None)
        return FeatureMF(
            dataset.n_users, dataset.n_items, entity, content, gen,
            embedding_dim=embedding_dim,
            aggregate_for_rec=conf.get("aggregate_for_rec", False),
            lambda_content=conf.get("lambda_content", 1e-4),
            temperature=conf.get("temperature", 0.1),
            embedding_loss_aggregator=conf.get("embedding_loss_aggregator",
                                               "mean"),
            use_user_bias=conf.get("use_user_bias", False),
            use_item_bias=conf.get("use_item_bias", False),
            use_global_bias=conf.get("use_global_bias", False))


class ItemFeatureMatrixFactorization:
    """``ifeatmf``: `FeatureMF` with the content on the item side."""

    @staticmethod
    def build_from_conf(conf: dict, dataset, device_data,
                        gen: torch.Generator) -> FeatureMF:
        return FeatureMF.build_from_conf("item", conf, dataset, device_data,
                                         gen)


class UserFeatureMatrixFactorization:
    """``ufeatmf``: `FeatureMF` with the content on the user side."""

    @staticmethod
    def build_from_conf(conf: dict, dataset, device_data,
                        gen: torch.Generator) -> FeatureMF:
        return FeatureMF.build_from_conf("user", conf, dataset, device_data,
                                         gen)
