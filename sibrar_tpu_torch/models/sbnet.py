"""SingleBranchNet (SiBraR), eval and train forwards (port of
``sibrar_tpu/models/sbnet.py``).

Each entity projects its modalities to ``common_modality_dim``, ONE shared
single-branch MLP encodes every projection, and evaluation averages (or
maxes) the encodings over the eval modalities. Training samples one or two
modalities per example (balanced routing by default), drops the branch's
inputs, encodes, and adds the InfoNCE loss between the two sampled
encodings, weighted by ``regularization_weight``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
from torch import nn

from sibrar_tpu_torch import config_from_dict
from sibrar_tpu_torch.data.sampling import (
    balanced_routing,
    sample_k_modalities,
)
from sibrar_tpu_torch.models.base import RecModel
from sibrar_tpu_torch.models.layers import (
    Embedding,
    FeatureEmbeddingModule,
    InteractionTower,
    PolyLinear,
    l2_normalize,
)
from sibrar_tpu_torch.train.losses import info_nce


@dataclass
class SingleBranchFeatureConfig:
    feature_name: str
    feature_hidden_layers: Optional[list[int]] = None


@dataclass
class SingleBranchNetEntityConfig:
    """The JAX config's fields. Two are accepted and ignored:
    ``preference_hidden_layers`` (read by no SBNet module) and
    ``sampling_seed`` (draws come from the trainer's generator)."""

    features: list[SingleBranchFeatureConfig] = field(default_factory=list)
    single_branch_hidden_layers: list[int] = field(default_factory=list)
    preference_hidden_layers: list[int] = field(default_factory=list)
    common_modality_dim: int = 128
    activation_fn: str = "relu"
    train_modalities: Optional[list[str]] = None
    eval_modalities: Optional[list[str]] = None
    sampling_seed: int = 42
    single_branch_input_dropout: Optional[float] = None
    aggregation_fn: str = "mean"
    normalize_single_branch_input: bool = False
    embedding_regularization_type: str = "no_regularization"
    central_modality: Optional[str] = None
    regularization_temperature: float = 1.0
    regularization_weight: float = 1.0
    apply_output_activation: bool = False
    apply_batch_normalization: bool = True
    apply_batch_norm_every: int = 0
    routed_modality_sampling: Optional[bool] = None


@dataclass
class SBFeatureModuleConfig:
    """Plain (non-single-branch) entity tower: one embedded feature."""

    feature_name: str
    embedding_dim: int
    pre_embedding_layers: Optional[list[int]] = None
    post_embedding_layers: Optional[list[int]] = None
    activation_fn: str = "relu"


REG_TYPES = ("no_regularization", "pairwise_single", "central_modality")


class SingleBranchNetEntity(RecModel):
    """Per-modality projections + one shared single-branch MLP for one entity.

    ``modalities`` holds one module per train modality, in train order (an
    `Embedding` for ``{entity}_embedding``, an `InteractionTower` for
    ``interactions``, a `FeatureEmbeddingModule` otherwise). ``k`` modalities
    are sampled per train example (1, or 2 with a regularization), with
    ``central`` fixing the first for central-modality regularization."""

    def __init__(self, modality_names, eval_modality_ids, modalities,
                 sb_net: PolyLinear, *, aggregation_fn: str = "mean",
                 normalize_single_branch_input: bool = False, k: int = 1,
                 central: Optional[int] = None,
                 regularization_temperature: float = 1.0,
                 regularization_weight: float = 1.0,
                 routed_modality_sampling: Optional[bool] = None):
        super().__init__()
        self.modality_names = tuple(modality_names)
        self.eval_modality_ids = tuple(eval_modality_ids)
        self.modalities = nn.ModuleList(modalities)
        self.sb_net = sb_net
        self.aggregation_fn = aggregation_fn
        self.normalize_single_branch_input = normalize_single_branch_input
        self.k = k
        self.central = central
        self.regularization_temperature = regularization_temperature
        self.regularization_weight = regularization_weight
        self.routed_modality_sampling = routed_modality_sampling

    def _branch(self, x: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.normalize_single_branch_input:
            x = l2_normalize(x, eps=1e-12)
        return self.sb_net(x, gen)

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

    def train_forward(self, idxs: torch.Tensor,
                      gen: Optional[torch.Generator] = None, delta=None):
        """Train-mode representation ``[..., d]`` and the weighted InfoNCE
        loss between the two sampled encodings (0 when k = 1)."""
        if self.routed_modality_sampling is not False and len(
                self.modalities) > 1:
            picked = self._routed_projections(idxs, gen, delta)
        else:  # compute every modality, keep the k sampled per example
            sampled = sample_k_modalities(
                gen, idxs.shape, len(self.modalities), self.k,
                central=self.central, device=idxs.device)
            every = torch.stack([m(idxs) for m in self.modalities], dim=-2)
            picked = every.gather(-2, sampled.unsqueeze(-1).expand(
                *sampled.shape, every.shape[-1]))  # [..., k, d]
        encoded = self._branch(picked, gen)  # [..., k, out]
        reg = torch.zeros((), device=encoded.device)
        if self.k == 2:
            # item batches [B, 1 + n, d]: a row's candidates contrast each
            # other; user batches [B, d]: users contrast across the batch
            reg = self.regularization_weight * info_nce(
                encoded[..., 0, :], encoded[..., 1, :],
                temperature=self.regularization_temperature)
        return self._aggregate(encoded), reg

    def _routed_projections(self, idxs: torch.Tensor,
                            gen: Optional[torch.Generator],
                            delta: Optional[int]) -> torch.Tensor:
        """Balanced modality routing: rows are assigned to modalities by
        their flat position mod P (`balanced_routing`) after a cyclic shift
        by ``delta`` (uniform in [0, P), drawn from ``gen`` unless given; an
        int or a 0-d tensor), so each modality projects only its own rows,
        by static column slices of the rolled [G, P] view. Pad rows are
        dropped."""
        slots = balanced_routing(len(self.modalities), self.k, self.central)
        p = len(slots)
        flat = idxs.reshape(-1)
        t = flat.shape[0]
        g = -(-t // p)
        pad = g * p - t
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        if delta is None:  # stays on the device: no host sync
            delta = torch.randint(0, p, (), generator=gen,
                                  device=flat.device)
        pos = torch.arange(g * p, device=flat.device)
        blocks = flat[(pos + delta) % (g * p)].reshape(g, p)  # roll by -delta
        assign: dict[int, list[tuple[int, int]]] = {}
        for rho, row in enumerate(slots):
            for j, m in enumerate(row):
                assign.setdefault(m, []).append((rho, j))
        out: list[list] = [[None] * self.k for _ in range(p)]
        for m in sorted(assign):
            pairs = assign[m]
            proj = self.modalities[m](blocks[:, [rho for rho, _ in pairs]])
            for col, (rho, j) in enumerate(pairs):
                out[rho][j] = proj[:, col]
        picked = torch.stack([torch.stack(col, dim=1) for col in out], dim=1)
        picked = picked.reshape(g * p, self.k, -1)[(pos - delta) % (g * p)]
        return picked[:t].reshape(*idxs.shape, self.k, picked.shape[-1])


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

    def forward(self, u_idxs: torch.Tensor, i_idxs: torch.Tensor, *,
                gen: Optional[torch.Generator] = None, delta=None):
        """The model call; in train mode each tower takes its train forward
        (random draws from ``gen``, routing shift ``delta`` when given) and
        the towers' regularization losses are summed."""
        if not self.training:
            return super().forward(u_idxs, i_idxs)
        u, reg_u = self.user_module.train_forward(u_idxs, gen, delta)
        i, reg_i = self.item_module.train_forward(i_idxs, gen, delta)
        return self.combine(u, i), reg_u + reg_i

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
                fc = config_from_dict(SBFeatureModuleConfig, econf)
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

            ec = config_from_dict(SingleBranchNetEntityConfig, econf)
            features = ec.features
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

            if ec.embedding_regularization_type not in REG_TYPES:
                raise ValueError(f"unknown embedding_regularization_type "
                                 f"{ec.embedding_regularization_type!r}")
            central = None
            if ec.embedding_regularization_type == "central_modality":
                if ec.central_modality not in train_mods:
                    raise ValueError(f"central modality "
                                     f"{ec.central_modality!r} not in train "
                                     f"modalities")
                central = train_mods.index(ec.central_modality)
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
                input_dropout=ec.single_branch_input_dropout,
                apply_batch_norm_every=bn_every, torch_default_init=True)
            return SingleBranchNetEntity(
                train_mods, [train_mods.index(m) for m in eval_mods],
                modalities, sb_net, aggregation_fn=ec.aggregation_fn,
                normalize_single_branch_input=(
                    ec.normalize_single_branch_input),
                k=(1 if ec.embedding_regularization_type
                   == "no_regularization" else 2),
                central=central,
                regularization_temperature=ec.regularization_temperature,
                regularization_weight=ec.regularization_weight,
                routed_modality_sampling=ec.routed_modality_sampling)

        model = SingleBranchNet(build_entity("user"), build_entity("item"))
        return model.to(device_data.catalog.device).eval()
