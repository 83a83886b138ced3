"""SingleBranchNet (SiBraR), eval forward (port of
``sibrar_tpu/models/sbnet.py``).

Each entity projects its modalities to ``common_modality_dim``, ONE shared
single-branch MLP encodes every projection, and evaluation averages (or
maxes) the encodings over the eval modalities. This slice serves a trained
model; the training forward (modality routing, InfoNCE) comes with the
training slice.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch import nn

from sibrar_tpu_torch.models.base import RecModel
from sibrar_tpu_torch.models.layers import (
    Embedding,
    FeatureEmbeddingModule,
    InteractionTower,
    PolyLinear,
    l2_normalize,
)


@dataclass
class SingleBranchFeatureConfig:
    feature_name: str
    feature_hidden_layers: Optional[list] = None


@dataclass
class SingleBranchNetEntityConfig:
    """The JAX config's fields that shape the eval forward; the training
    fields (regularization, sampling, input dropout) are accepted and
    ignored here."""

    features: list = field(default_factory=list)
    single_branch_hidden_layers: list = field(default_factory=list)
    common_modality_dim: int = 128
    activation_fn: str = "relu"
    train_modalities: Optional[list] = None
    eval_modalities: Optional[list] = None
    aggregation_fn: str = "mean"
    normalize_single_branch_input: bool = False
    apply_output_activation: bool = False
    apply_batch_normalization: bool = True
    apply_batch_norm_every: int = 0


@dataclass
class SBFeatureModuleConfig:
    """Plain (non-single-branch) entity tower: one embedded feature."""

    feature_name: str
    embedding_dim: int
    pre_embedding_layers: Optional[list] = None
    post_embedding_layers: Optional[list] = None
    activation_fn: str = "relu"


def _from_dict(cls, data: dict):
    """Dataclass from a config dict; unknown keys are ignored."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in data.items() if k in names})


class SingleBranchNetEntity(RecModel):
    """Per-modality projections + one shared single-branch MLP for one entity.

    ``modalities`` holds one module per train modality, in train order (an
    `Embedding` for ``{entity}_embedding``, an `InteractionTower` for
    ``interactions``, a `FeatureEmbeddingModule` otherwise)."""

    def __init__(self, modality_names, eval_modality_ids, modalities,
                 sb_net: PolyLinear, *, aggregation_fn: str = "mean",
                 normalize_single_branch_input: bool = False):
        super().__init__()
        self.modality_names = tuple(modality_names)
        self.eval_modality_ids = tuple(eval_modality_ids)
        self.modalities = nn.ModuleList(modalities)
        self.sb_net = sb_net
        self.aggregation_fn = aggregation_fn
        self.normalize_single_branch_input = normalize_single_branch_input

    def _branch(self, x: torch.Tensor) -> torch.Tensor:
        if self.normalize_single_branch_input:
            x = l2_normalize(x, eps=1e-12)
        return self.sb_net(x)

    def _aggregate(self, x: torch.Tensor) -> torch.Tensor:
        if self.aggregation_fn == "mean":
            return x.mean(dim=-2)
        if self.aggregation_fn == "max":
            return x.amax(dim=-2)
        raise ValueError(f"aggregation {self.aggregation_fn!r} not supported")

    def forward(self, idxs: torch.Tensor) -> torch.Tensor:
        projections = [self.modalities[i](idxs)
                       for i in self.eval_modality_ids]
        stacked = torch.stack(projections, dim=-2)  # [..., n_eval_mod, d]
        return self._aggregate(self._branch(stacked))


class PlainEntityModule(RecModel):
    """Non-single-branch entity tower: one embedded feature or the entity's
    interaction row."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, idxs: torch.Tensor) -> torch.Tensor:
        return self.net(idxs)


class PlainIdEmbeddingModule(RecModel):
    """Plain id-embedding tower for the synthetic ``{entity}_embedding``."""

    def __init__(self, n_entities: int, dim: int, gen: torch.Generator):
        super().__init__()
        self.embedding = Embedding(n_entities, dim, gen)

    def forward(self, idxs: torch.Tensor) -> torch.Tensor:
        return self.embedding(idxs.long())


class SingleBranchNet(RecModel):
    def __init__(self, user_module: nn.Module, item_module: nn.Module):
        super().__init__()
        self.user_module = user_module
        self.item_module = item_module

    def user_repr(self, u_idxs: torch.Tensor) -> torch.Tensor:
        return self.user_module(u_idxs)

    def item_repr(self, i_idxs: torch.Tensor) -> torch.Tensor:
        return self.item_module(i_idxs)

    # ------------------------------------------------------------ construction
    @staticmethod
    def build_from_conf(conf: dict, dataset, device_data, *,
                        seed: int = 0) -> "SingleBranchNet":
        """Build from the ``model:`` dict of a config, as the JAX package
        does. ``dataset`` is the host split (`data.dataset.RecDataset`) and
        ``device_data`` its `DeviceData`, whose device the model lands on, in
        eval mode. Weights are random from ``seed`` (load trained ones with
        `models.transplant.transplant`)."""
        gen = torch.Generator().manual_seed(seed)
        shared_common_dim = conf["shared_common_dim"]

        def feature_module(entity, name, **kwargs):
            feats = (dataset.user_features if entity == "user"
                     else dataset.item_features)
            tables = (device_data.user_features if entity == "user"
                      else device_data.item_features)
            f = feats[name]
            return FeatureEmbeddingModule(
                tables[name], f.kind, gen, n_categories=f.n_categories,
                **kwargs)

        def inter_csr(entity):
            return (device_data.user_inter_csr if entity == "user"
                    else device_data.item_inter_csr)

        def build_entity(entity: str) -> RecModel:
            econf = conf[entity]
            n_entities = (dataset.n_users if entity == "user"
                          else dataset.n_items)
            if not ("features" in econf and not econf.get("embedding_dim")):
                fc = _from_dict(SBFeatureModuleConfig, econf)
                emb_dim = (fc.embedding_dim if fc.embedding_dim != -1
                           else shared_common_dim)
                if fc.feature_name == f"{entity}_embedding":
                    return PlainIdEmbeddingModule(n_entities, emb_dim, gen)
                if fc.feature_name == "interactions":
                    return PlainEntityModule(InteractionTower(
                        inter_csr(entity),
                        [*(fc.pre_embedding_layers or []), emb_dim], gen,
                        activation_fn=fc.activation_fn, output_fn=None))
                return PlainEntityModule(feature_module(
                    entity, fc.feature_name, embedding_dim=emb_dim,
                    pre_embedding_layers=fc.pre_embedding_layers,
                    post_embedding_layers=fc.post_embedding_layers,
                    activation_fn=fc.activation_fn))

            ec = _from_dict(SingleBranchNetEntityConfig, econf)
            features = [_from_dict(SingleBranchFeatureConfig, f)
                        for f in ec.features]
            available = [f.feature_name for f in features]
            train_mods = list(ec.train_modalities or available)
            for m in train_mods:
                if m not in available:
                    raise ValueError(f"Network definitions for modalities "
                                     f"{{{m!r}}} are not available!")
            eval_mods = list(ec.eval_modalities or train_mods)
            for m in eval_mods:
                if m not in train_mods:
                    raise ValueError(
                        f'Cannot use modality "{m}" during evaluation, '
                        f"if it is not used during training.")
            is_cold = (dataset.is_cold_start_user if entity == "user"
                       else dataset.is_cold_start_item)
            if is_cold:  # cold-start entities have no eval-time interactions
                eval_mods = [m for m in eval_mods if m != "interactions"]
            if not eval_mods:
                raise ValueError("No single modality is available during "
                                 "evaluation")

            hidden = {f.feature_name: f.feature_hidden_layers or []
                      for f in features}
            modalities = []
            for name in train_mods:
                if name == "interactions":
                    modalities.append(InteractionTower(
                        inter_csr(entity),
                        [*hidden[name], ec.common_modality_dim], gen,
                        activation_fn=ec.activation_fn,
                        output_fn=ec.activation_fn))
                elif name == f"{entity}_embedding":
                    modalities.append(Embedding(
                        n_entities, ec.common_modality_dim, gen))
                else:
                    modalities.append(feature_module(
                        entity, name, embedding_dim=ec.common_modality_dim,
                        pre_embedding_layers=hidden[name] or None,
                        activation_fn=ec.activation_fn))

            bn_every = (ec.apply_batch_norm_every
                        if ec.apply_batch_normalization else 0)
            if ec.apply_batch_normalization and ec.apply_batch_norm_every == 0:
                bn_every = -1  # batch norm only after the last layer
            sb_net = PolyLinear(
                [ec.common_modality_dim, *ec.single_branch_hidden_layers,
                 shared_common_dim], gen,
                activation_fn=ec.activation_fn,
                output_fn=(ec.activation_fn if ec.apply_output_activation
                           else None),
                apply_batch_norm_every=bn_every, torch_default_init=True)
            return SingleBranchNetEntity(
                train_mods, [train_mods.index(m) for m in eval_mods],
                modalities, sb_net, aggregation_fn=ec.aggregation_fn,
                normalize_single_branch_input=(
                    ec.normalize_single_branch_input))

        model = SingleBranchNet(build_entity("user"), build_entity("item"))
        return model.to(device_data.catalog.device).eval()
