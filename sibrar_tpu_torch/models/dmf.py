"""Deep Matrix Factorization (port of ``sibrar_tpu/models/dmf.py``).

Two `InteractionTower` MLPs, ``user_nn`` over the user's train row and
``item_nn`` over the item's train column, each ``[*mid, final]`` wide; the
score is the cosine of the two representations clamped below at ``mu``.
``normalize_interactions`` L2-normalizes the interaction rows inside the
towers, ``normalize_representations`` the towers' outputs, and
``use_output_activation_fn`` ends each tower with a relu.
"""
from __future__ import annotations

import torch

from sibrar_tpu_torch.models.base import RecModel
from sibrar_tpu_torch.models.layers import (
    InteractionTower,
    interaction_tower_from,
    l2_normalize,
)


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    # zero-safe backward: entities with no train interaction reach the
    # cosine as exact-zero tower outputs
    return l2_normalize(x, eps=1e-8)


class DeepMatrixFactorization(RecModel):
    def __init__(self, user_nn: InteractionTower, item_nn: InteractionTower,
                 *, mu: float = 1e-6,
                 normalize_representations: bool = False):
        super().__init__()
        self.user_nn = user_nn
        self.item_nn = item_nn
        self.mu = mu
        self.normalize_representations = normalize_representations

    def user_repr(self, u_idxs: torch.Tensor) -> torch.Tensor:
        u = self.user_nn(u_idxs)
        return _l2norm(u) if self.normalize_representations else u

    def item_repr(self, i_idxs: torch.Tensor) -> torch.Tensor:
        i = self.item_nn(i_idxs)
        return _l2norm(i) if self.normalize_representations else i

    def eval_rank_dot_parts(self, user_repr_fn, i_repr):
        """``max(cos, mu)`` ranks as the cosine does (the clamp only ties
        scores below ``mu``), so both sides are normalized and the ranking
        takes the dot path."""
        return (lambda u: _l2norm(user_repr_fn(u))), _l2norm(i_repr)

    def combine(self, u_repr: torch.Tensor,
                i_repr: torch.Tensor) -> torch.Tensor:
        u, i = _l2norm(u_repr), _l2norm(i_repr)
        if i.ndim == 2:
            sim = u @ i.T
        else:
            sim = torch.einsum("be,bce->bc", u, i)
        return sim.clamp(min=self.mu)

    @staticmethod
    def build_from_conf(conf: dict, dataset, device_data,
                        gen: torch.Generator) -> "DeepMatrixFactorization":
        """JAX's keys and defaults: ``u_mid_layers`` / ``i_mid_layers``
        (default none), ``final_dimension``, ``mu`` 1e-6,
        ``normalize_interactions``, ``normalize_representations`` and
        ``use_output_activation_fn`` (all off). The user tower is drawn
        first."""
        out_fn = "relu" if conf.get("use_output_activation_fn",
                                    False) else None
        normalize = conf.get("normalize_interactions", False)
        final = conf["final_dimension"]

        def tower(entity: str, mid_key: str) -> InteractionTower:
            mid = list(conf.get(mid_key, []) or [])
            return interaction_tower_from(
                device_data, entity, [*mid, final], gen, output_fn=out_fn,
                normalize=normalize)

        return DeepMatrixFactorization(
            tower("user", "u_mid_layers"), tower("item", "i_mid_layers"),
            mu=conf.get("mu", 1e-6),
            normalize_representations=conf.get("normalize_representations",
                                               False))
