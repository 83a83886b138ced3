"""The ProtoMF family (port of ``sibrar_tpu/models/protomf.py``).

- ``UProtoMF`` / ``IProtoMF`` / ``UIProtoMF``: an entity's embedding is
  scored by the *shifted* cosine (1 + cos, clipped to [0, 2]) against
  learned prototypes, and the other entity holds per-prototype weights
  (``UIProtoMF``: both sides, with bias-free cross projections). Their
  train forward adds two regularizers over ``dis = 2 - sim``: the mean
  over prototypes of the batch minimum (``proto_loss``) and the mean over
  the batch of the prototype minimum (``batch_loss``), each weighted.
- ``UProtoMFs`` / ``IProtoMFs`` / ``UIProtoMFs``: plain cosine, no
  regularizer, the weight side through a relu (initialized around 0.5).
- ``UIProtoMFsCombine``: the score sum of two fitted runs, predict only.

The JAX package sows the regularizers into a ``losses`` collection; here
`ProtoModel.forward_losses` returns them by JAX's names and the model call
returns their sum (`base.NamedLossModel`). Every table lookup is
`layers.lookup` (K6 / K7 on the card); the weight side of ``UProtoMFs``
(items) and ``IProtoMFs`` (users)
is a flax ``nn.Embed`` in JAX, outside ``table_index_map``, so it stays
with the dense optimizer here too.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sibrar_tpu_torch.models.base import NamedLossModel
from sibrar_tpu_torch.models.layers import (
    Embedding,
    clip,
    embedding_init_,
    l2_normalize,
)
from sibrar_tpu_torch.parallel.mesh import gather_batch


# ----------------------------------------------------------------- cosines
def _l2normalize(x: torch.Tensor) -> torch.Tensor:
    return l2_normalize(x, eps=1e-12)


def cosine_sim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise cosine ``[n, m]``, clipped to [-1, 1] (`layers.clip`:
    ``jnp.clip``'s gradient at the bounds)."""
    return clip(_l2normalize(x) @ _l2normalize(y).T, -1.0, 1.0)


def shifted_cosine_sim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """1 + cosine, clipped to [0, 2]."""
    return clip(1.0 + _l2normalize(x) @ _l2normalize(y).T, 0.0, 2.0)


# ------------------------------------------------------------ initializers
def _proto_init(n: int, dim: int, gen: torch.Generator) -> nn.Parameter:
    """N(0, 0.1 / dim): the scale itself, not its square root."""
    return nn.Parameter(embedding_init_(torch.empty(n, dim), gen))


def _pos_weight_init(t: torch.Tensor, gen: torch.Generator) -> None:
    """``clip(0.5 + truncnorm(-2, 2) * 0.1 / dim, 0, 1)`` in place."""
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    t.mul_(0.1 / t.shape[-1]).add_(0.5).clamp_(0.0, 1.0)


def _projection(d_in: int, d_out: int, gen: torch.Generator) -> nn.Linear:
    """flax ``nn.Dense(d_out, use_bias=False, kernel_init=embedding_init)``
    (the init on the ``[d_in, d_out]`` kernel: N(0, 0.1 / d_out))."""
    layer = nn.Linear(d_in, d_out, bias=False)
    embedding_init_(layer.weight.T, gen)
    return layer


def _proto_reg(sim: torch.Tensor, n_prototypes: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(proto_loss, batch_loss)`` of a ``[..., P]`` similarity. ``amin``
    splits a minimum's gradient evenly among ties, as JAX's ``min`` does
    (a train batch repeats users and items, so rows tie exactly). Both are
    over the global batch in a data-parallel step."""
    dis = gather_batch((2.0 - sim).reshape(-1, n_prototypes))
    return dis.amin(0).mean(), dis.amin(1).mean()


def _sim_rows(emb: torch.Tensor, protos: torch.Tensor, sim_fn
              ) -> torch.Tensor:
    """``sim_fn`` over the rows of ``emb [..., d]``, shaped ``[..., P]``."""
    sim = sim_fn(emb.reshape(-1, emb.shape[-1]), protos)
    return sim.reshape(*emb.shape[:-1], protos.shape[0])


class ProtoModel(NamedLossModel):
    """Train forward of the family: ``user_repr`` / ``item_repr`` add their
    weighted regularizers to ``losses`` when given one in train mode."""

    def forward_losses(self, u_idxs: torch.Tensor, i_idxs: torch.Tensor
                       ) -> tuple[torch.Tensor, dict]:
        """``(logits, {name: weighted loss})``; the dict is empty in eval
        mode and for the simplified variants."""
        losses: Optional[dict] = {} if self.training else None
        u_repr = self.user_repr(u_idxs, losses)
        i_repr = self.item_repr(i_idxs, losses)
        return self.combine(u_repr, i_repr), losses or {}


# ------------------------------------------------------------ full variants
class UProtoMF(ProtoModel):
    """User prototypes; items hold per-prototype weights."""

    table_index_map = {"user_embed": "user", "item_embed": "item"}

    def __init__(self, n_users: int, n_items: int, gen: torch.Generator,
                 embedding_dim: int = 100, n_prototypes: int = 20,
                 sim_proto_weight: float = 1.0,
                 sim_batch_weight: float = 1.0):
        super().__init__()
        self.n_prototypes = n_prototypes
        self.sim_proto_weight = sim_proto_weight
        self.sim_batch_weight = sim_batch_weight
        self.user_embed = Embedding(n_users, embedding_dim, gen)
        self.item_embed = Embedding(n_items, n_prototypes, gen)
        self.prototypes = _proto_init(n_prototypes, embedding_dim, gen)

    def user_repr(self, u_idxs, losses: Optional[dict] = None):
        sim = shifted_cosine_sim(self.user_embed(u_idxs), self.prototypes)
        if losses is not None:
            proto, batch = _proto_reg(sim, self.n_prototypes)
            losses["proto_loss"] = self.sim_proto_weight * proto
            losses["batch_loss"] = self.sim_batch_weight * batch
        return sim

    def item_repr(self, i_idxs, losses: Optional[dict] = None):
        return self.item_embed(i_idxs)

    @staticmethod
    def build_from_conf(conf: dict, dataset, device_data,
                        gen: torch.Generator) -> "UProtoMF":
        return UProtoMF(
            dataset.n_users, dataset.n_items, gen,
            embedding_dim=conf.get("embedding_dim", 100),
            n_prototypes=conf.get("n_prototypes", 20),
            sim_proto_weight=conf.get("sim_proto_weight", 1.0),
            sim_batch_weight=conf.get("sim_batch_weight", 1.0))


class IProtoMF(ProtoModel):
    """Item prototypes; users hold per-prototype weights."""

    table_index_map = {"user_embed": "user", "item_embed": "item"}

    def __init__(self, n_users: int, n_items: int, gen: torch.Generator,
                 embedding_dim: int = 100, n_prototypes: int = 20,
                 sim_proto_weight: float = 1.0,
                 sim_batch_weight: float = 1.0):
        super().__init__()
        self.n_prototypes = n_prototypes
        self.sim_proto_weight = sim_proto_weight
        self.sim_batch_weight = sim_batch_weight
        self.user_embed = Embedding(n_users, n_prototypes, gen)
        self.item_embed = Embedding(n_items, embedding_dim, gen)
        self.prototypes = _proto_init(n_prototypes, embedding_dim, gen)

    def user_repr(self, u_idxs, losses: Optional[dict] = None):
        return self.user_embed(u_idxs)

    def item_repr(self, i_idxs, losses: Optional[dict] = None):
        sim = _sim_rows(self.item_embed(i_idxs), self.prototypes,
                        shifted_cosine_sim)
        if losses is not None:
            proto, batch = _proto_reg(sim, self.n_prototypes)
            losses["proto_loss"] = self.sim_proto_weight * proto
            losses["batch_loss"] = self.sim_batch_weight * batch
        return sim

    @staticmethod
    def build_from_conf(conf: dict, dataset, device_data,
                        gen: torch.Generator) -> "IProtoMF":
        return IProtoMF(
            dataset.n_users, dataset.n_items, gen,
            embedding_dim=conf.get("embedding_dim", 100),
            n_prototypes=conf.get("n_prototypes", 20),
            sim_proto_weight=conf.get("sim_proto_weight", 1.0),
            sim_batch_weight=conf.get("sim_batch_weight", 1.0))


def _cross_combine(u_repr, i_repr) -> torch.Tensor:
    """``<u_sim, i_proj> + <u_proj, i_sim>``: ``[B, C]`` for catalog
    representations ``[C, P]``, ``[B, 1 + n]`` for candidates."""
    u_sim, u_proj = u_repr
    i_sim, i_proj = i_repr
    if i_sim.ndim == 2:
        return u_sim @ i_proj.T + u_proj @ i_sim.T
    return (torch.einsum("bp,bcp->bc", u_sim, i_proj)
            + torch.einsum("bp,bcp->bc", u_proj, i_sim))


class _UIBase(ProtoModel):
    """Both entities embedded, each against its own prototypes, with
    bias-free projections into the other side's prototype space."""

    table_index_map = {"user_embed": "user", "item_embed": "item"}

    def __init__(self, n_users: int, n_items: int, gen: torch.Generator,
                 embedding_dim: int, u_n_prototypes: int,
                 i_n_prototypes: int):
        super().__init__()
        self.u_n_prototypes = u_n_prototypes
        self.i_n_prototypes = i_n_prototypes
        self.user_embed = Embedding(n_users, embedding_dim, gen)
        self.item_embed = Embedding(n_items, embedding_dim, gen)
        self.u_prototypes = _proto_init(u_n_prototypes, embedding_dim, gen)
        self.i_prototypes = _proto_init(i_n_prototypes, embedding_dim, gen)
        self.u_to_i = _projection(embedding_dim, i_n_prototypes, gen)
        self.i_to_u = _projection(embedding_dim, u_n_prototypes, gen)

    def combine(self, u_repr, i_repr):
        return _cross_combine(u_repr, i_repr)


class UIProtoMF(_UIBase):
    """User and item prototypes: ``score = <u_sim, i_proj> + <u_proj,
    i_sim>``, each side with its own regularizers (``user_*`` /
    ``item_*``)."""

    def __init__(self, n_users: int, n_items: int, gen: torch.Generator,
                 embedding_dim: int = 100, u_n_prototypes: int = 20,
                 i_n_prototypes: int = 20, u_sim_proto_weight: float = 1.0,
                 u_sim_batch_weight: float = 1.0,
                 i_sim_proto_weight: float = 1.0,
                 i_sim_batch_weight: float = 1.0):
        super().__init__(n_users, n_items, gen, embedding_dim,
                         u_n_prototypes, i_n_prototypes)
        self.weights = {"user": (u_sim_proto_weight, u_sim_batch_weight),
                        "item": (i_sim_proto_weight, i_sim_batch_weight)}

    def _reg(self, sim, n_prototypes, entity, losses) -> None:
        if losses is not None:
            proto, batch = _proto_reg(sim, n_prototypes)
            w_proto, w_batch = self.weights[entity]
            losses[f"{entity}_proto_loss"] = w_proto * proto
            losses[f"{entity}_batch_loss"] = w_batch * batch

    def user_repr(self, u_idxs, losses: Optional[dict] = None):
        emb = self.user_embed(u_idxs)
        u_sim = shifted_cosine_sim(emb, self.u_prototypes)
        self._reg(u_sim, self.u_n_prototypes, "user", losses)
        return u_sim, self.u_to_i(emb)

    def item_repr(self, i_idxs, losses: Optional[dict] = None):
        emb = self.item_embed(i_idxs)
        i_sim = _sim_rows(emb, self.i_prototypes, shifted_cosine_sim)
        self._reg(i_sim, self.i_n_prototypes, "item", losses)
        return i_sim, self.i_to_u(emb)

    def eval_rank_dot_parts(self, user_repr_fn, i_repr):
        """The score is the dot of ``[u_sim, u_proj]`` with ``[i_proj,
        i_sim]``."""
        i_sim, i_proj = i_repr

        def u_fn(u_idxs):
            u_sim, u_proj = user_repr_fn(u_idxs)
            return torch.cat([u_sim, u_proj], dim=1)

        return u_fn, torch.cat([i_proj, i_sim], dim=1)

    @staticmethod
    def build_from_conf(conf: dict, dataset, device_data,
                        gen: torch.Generator) -> "UIProtoMF":
        return UIProtoMF(
            dataset.n_users, dataset.n_items, gen,
            embedding_dim=conf.get("embedding_dim", 100),
            u_n_prototypes=conf.get("u_n_prototypes", 20),
            i_n_prototypes=conf.get("i_n_prototypes", 20),
            u_sim_proto_weight=conf.get("u_sim_proto_weight", 1.0),
            u_sim_batch_weight=conf.get("u_sim_batch_weight", 1.0),
            i_sim_proto_weight=conf.get("i_sim_proto_weight", 1.0),
            i_sim_batch_weight=conf.get("i_sim_batch_weight", 1.0))


# ------------------------------------------------------ simplified variants
class UProtoMFs(ProtoModel):
    """User prototypes by plain cosine; relu'd item weights."""

    # the item table is outside the row-sparse optimizer (JAX's nn.Embed)
    table_index_map = {"user_embed": "user"}

    def __init__(self, n_users: int, n_items: int, gen: torch.Generator,
                 embedding_dim: int = 100, n_prototypes: int = 20):
        super().__init__()
        self.user_embed = Embedding(n_users, embedding_dim, gen)
        self.item_embed = Embedding(n_items, n_prototypes, gen,
                                    init=_pos_weight_init)
        self.prototypes = _proto_init(n_prototypes, embedding_dim, gen)

    def user_repr(self, u_idxs, losses: Optional[dict] = None):
        return cosine_sim(self.user_embed(u_idxs), self.prototypes)

    def item_repr(self, i_idxs, losses: Optional[dict] = None):
        return torch.relu(self.item_embed(i_idxs))

    @staticmethod
    def build_from_conf(conf: dict, dataset, device_data,
                        gen: torch.Generator) -> "UProtoMFs":
        return UProtoMFs(dataset.n_users, dataset.n_items, gen,
                         embedding_dim=conf.get("embedding_dim", 100),
                         n_prototypes=conf.get("n_prototypes", 20))


class IProtoMFs(ProtoModel):
    """Item prototypes by plain cosine; relu'd user weights."""

    # the user table is outside the row-sparse optimizer (JAX's nn.Embed)
    table_index_map = {"item_embed": "item"}

    def __init__(self, n_users: int, n_items: int, gen: torch.Generator,
                 embedding_dim: int = 100, n_prototypes: int = 20):
        super().__init__()
        self.user_embed = Embedding(n_users, n_prototypes, gen,
                                    init=_pos_weight_init)
        self.item_embed = Embedding(n_items, embedding_dim, gen)
        self.prototypes = _proto_init(n_prototypes, embedding_dim, gen)

    def user_repr(self, u_idxs, losses: Optional[dict] = None):
        return torch.relu(self.user_embed(u_idxs))

    def item_repr(self, i_idxs, losses: Optional[dict] = None):
        return _sim_rows(self.item_embed(i_idxs), self.prototypes,
                         cosine_sim)

    @staticmethod
    def build_from_conf(conf: dict, dataset, device_data,
                        gen: torch.Generator) -> "IProtoMFs":
        return IProtoMFs(dataset.n_users, dataset.n_items, gen,
                         embedding_dim=conf.get("embedding_dim", 100),
                         n_prototypes=conf.get("n_prototypes", 20))


class UIProtoMFs(_UIBase):
    """Both sides by plain cosine, relu'd projections; JAX gives it
    ``UIProtoMF.combine`` and no dot parts, so it ranks on the scores
    path."""

    def __init__(self, n_users: int, n_items: int, gen: torch.Generator,
                 embedding_dim: int = 100, u_n_prototypes: int = 20,
                 i_n_prototypes: int = 20):
        super().__init__(n_users, n_items, gen, embedding_dim,
                         u_n_prototypes, i_n_prototypes)

    def user_repr(self, u_idxs, losses: Optional[dict] = None):
        emb = self.user_embed(u_idxs)
        return (cosine_sim(emb, self.u_prototypes),
                torch.relu(self.u_to_i(emb)))

    def item_repr(self, i_idxs, losses: Optional[dict] = None):
        emb = self.item_embed(i_idxs)
        return (_sim_rows(emb, self.i_prototypes, cosine_sim),
                torch.relu(self.i_to_u(emb)))

    @staticmethod
    def build_from_conf(conf: dict, dataset, device_data,
                        gen: torch.Generator) -> "UIProtoMFs":
        return UIProtoMFs(dataset.n_users, dataset.n_items, gen,
                          embedding_dim=conf.get("embedding_dim", 100),
                          u_n_prototypes=conf.get("u_n_prototypes", 20),
                          i_n_prototypes=conf.get("i_n_prototypes", 20))


class UIProtoMFsCombine:
    """Score sum of two separately fitted scorers (typically a UProtoMFs
    and an IProtoMFs run): predict only, no training."""

    def __init__(self, u_score_fn, i_score_fn):
        self.u_score_fn = u_score_fn
        self.i_score_fn = i_score_fn

    def __call__(self, u_idxs: torch.Tensor) -> torch.Tensor:
        return self.u_score_fn(u_idxs) + self.i_score_fn(u_idxs)
