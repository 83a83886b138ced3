"""DropoutNet (port of ``sibrar_tpu/models/dropoutnet.py``): cold start by
preference dropout.

Each entity tower concatenates its content embeddings and a preference MLP
over its train-interaction row (an `InteractionTower`), then encodes them
with a common MLP. In train mode each batch row keeps its preference input
with probability 0.5 (the row's 1 + n candidates share the draw, as JAX
draws per batch row); a dropped row's interaction sum is multiplied by 0,
which the tower takes as its ``scale``. Evaluation uses full information.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch
from torch import nn

from sibrar_tpu_torch import config_from_dict
from sibrar_tpu_torch.models.base import RecModel
from sibrar_tpu_torch.models.layers import (
    FeatureEmbeddingModule,
    InteractionTower,
    PolyLinear,
    feature_module_from,
    interaction_tower_from,
)
from sibrar_tpu_torch.parallel.mesh import local_draw


@dataclass
class DropoutNetFeature:
    feature_name: str
    embedding_dim: int
    pre_embedding_layers: Optional[list[int]] = None
    post_embedding_layers: Optional[list[int]] = None
    activation_fn: str = "relu"


@dataclass
class DropoutNetEntityConfig:
    features: list[DropoutNetFeature] = field(default_factory=list)
    preference_layers: list[int] = field(default_factory=lambda: [64])
    common_hidden_layers: list[int] = field(default_factory=lambda: [64])
    activation_fn: str = "relu"


class DropoutNetEntity(RecModel):
    """One entity tower: ``net([*content, pref_net(interactions)])``.
    ``content`` holds the feature modules as ``cont_{entity}__{feature}``
    in config order."""

    def __init__(self, pref_net: InteractionTower,
                 content: dict[str, FeatureEmbeddingModule], net: PolyLinear):
        super().__init__()
        self.pref_net = pref_net
        self.content = nn.ModuleDict(content)
        self.net = net

    def forward(self, idxs: torch.Tensor,
                gen: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """In train mode the preference input of batch row ``b`` is kept
        where ``keep[b]`` is 1: ``keep`` ``[B]`` is drawn from ``gen``
        (Bernoulli(0.5)) unless given."""
        scale = None
        if self.training:
            if keep is None:
                keep = local_draw(lambda shape: torch.bernoulli(torch.full(
                    shape, 0.5, device=idxs.device), generator=gen),
                    idxs.shape[:1])
            keep = keep.to(torch.float32).reshape(
                idxs.shape[:1] + (1,) * idxs.ndim)
            scale = keep.expand(*idxs.shape, 1)
        pref = self.pref_net(idxs, scale=scale)
        cont = [m(idxs) for m in self.content.values()]
        return self.net(torch.cat([*cont, pref], dim=-1))


class DropoutNet(RecModel):
    def __init__(self, user_net: DropoutNetEntity,
                 item_net: DropoutNetEntity):
        super().__init__()
        self.user_net = user_net
        self.item_net = item_net

    def user_repr(self, u_idxs: torch.Tensor) -> torch.Tensor:
        return self.user_net(u_idxs)

    def item_repr(self, i_idxs: torch.Tensor) -> torch.Tensor:
        return self.item_net(i_idxs)

    def forward(self, u_idxs: torch.Tensor, i_idxs: torch.Tensor, *,
                gen: Optional[torch.Generator] = None, delta=None,
                keep: Optional[Sequence[torch.Tensor]] = None):
        """The model call; in train mode the user tower draws its keep mask
        from ``gen``, then the item tower draws its own (``keep``: the two
        masks, user's first, instead of the draws)."""
        if not self.training:
            return super().forward(u_idxs, i_idxs)
        keep_u, keep_i = keep if keep is not None else (None, None)
        u = self.user_net(u_idxs, gen, keep_u)
        i = self.item_net(i_idxs, gen, keep_i)
        return self.combine(u, i), torch.zeros((), device=u.device)

    @staticmethod
    def build_from_conf(conf: dict, dataset, device_data,
                        gen: torch.Generator) -> "DropoutNet":
        """JAX's keys: ``shared_common_dim`` and a `DropoutNetEntityConfig`
        per entity. The preference tower and the common net take the torch
        default init (U(+-1/sqrt(fan_in)) weights and biases), the content
        modules their own. Drawn in order: the user tower (preference,
        content, common net), then the item tower."""
        shared = conf["shared_common_dim"]

        def entity_net(entity: str) -> DropoutNetEntity:
            ec = config_from_dict(DropoutNetEntityConfig, conf[entity])
            pref = interaction_tower_from(
                device_data, entity, list(ec.preference_layers), gen,
                activation_fn=ec.activation_fn, output_fn=ec.activation_fn,
                torch_default_init=True)
            content = {
                f"cont_{entity}__{f.feature_name}": feature_module_from(
                    dataset, device_data, entity, f.feature_name, gen,
                    embedding_dim=f.embedding_dim,
                    pre_embedding_layers=f.pre_embedding_layers or None,
                    post_embedding_layers=f.post_embedding_layers or None,
                    activation_fn=f.activation_fn)
                for f in ec.features}
            cont_dim = sum(m.output_dim for m in content.values())
            net = PolyLinear(
                [ec.preference_layers[-1] + cont_dim,
                 *ec.common_hidden_layers, shared], gen,
                activation_fn=ec.activation_fn, output_fn=ec.activation_fn,
                torch_default_init=True)
            return DropoutNetEntity(pref, content, net)

        return DropoutNet(entity_net("user"), entity_net("item"))
