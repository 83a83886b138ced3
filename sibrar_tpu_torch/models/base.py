"""Model base contract (port of ``sibrar_tpu/models/base.py`` ``RecModel``).

The three-way representation split lets full-catalog scoring encode the
items once and reuse them for every user batch:
``user_repr(u_idxs)``, ``item_repr(i_idxs)`` and ``combine(u_repr, i_repr)``.
The model call ``model(u_idxs, i_idxs)`` returns the logits and the sum of
the regularization losses the train forward computed (the JAX package sows
them into a ``losses`` collection); nothing carries over between calls.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class RecModel(nn.Module):
    def user_repr(self, u_idxs: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def item_repr(self, i_idxs: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def train_forward(self, idxs: torch.Tensor,
                      gen: Optional[torch.Generator] = None,
                      delta=None) -> tuple[torch.Tensor, torch.Tensor]:
        """An entity tower's train-mode representation and regularization
        loss; towers without one return 0."""
        return self(idxs), torch.zeros((), device=idxs.device)

    def forward(self, u_idxs: torch.Tensor, i_idxs: torch.Tensor, *,
                gen: Optional[torch.Generator] = None, delta=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(logits [B, 1 + n], reg_loss)`` for users ``[B]`` and their
        candidate items ``[B, 1 + n]``: the eval representations and a zero
        loss. A model with a train forward overrides this in train mode,
        taking its random draws from ``gen`` (and the modality routing shift
        ``delta``, when given)."""
        zero = torch.zeros((), device=u_idxs.device)
        return self.combine(self.user_repr(u_idxs),
                            self.item_repr(i_idxs)), zero

    @property
    def combine_is_dot(self) -> bool:
        """True when `combine` is exactly the base dot product."""
        return type(self).combine is RecModel.combine

    def eval_rank_dot_parts(self, user_repr_fn, i_repr):
        """``(user_fn, item_matrix)`` whose dot-product ranking equals
        `combine`'s, or None; enables the fused GEMM -> top-k serving path."""
        if self.combine_is_dot:
            return user_repr_fn, i_repr
        return None

    def combine(self, u_repr: torch.Tensor, i_repr: torch.Tensor
                ) -> torch.Tensor:
        """Dot-product scores: ``[B, C]`` for catalog representations
        ``[C, d]``, ``[B, 1 + n]`` for per-user candidates
        ``[B, 1 + n, d]``."""
        if i_repr.ndim == 2:
            return u_repr @ i_repr.T
        return torch.einsum("be,bce->bc", u_repr, i_repr)


class NamedLossModel(RecModel):
    """A model whose train forward names its regularization losses (the
    JAX package's sown ``losses`` entries): `forward_losses` returns
    ``(logits, {name: loss})``, and the model call their sum."""

    def forward_losses(self, u_idxs: torch.Tensor, i_idxs: torch.Tensor
                       ) -> tuple[torch.Tensor, dict]:
        raise NotImplementedError

    def forward(self, u_idxs: torch.Tensor, i_idxs: torch.Tensor, *,
                gen: Optional[torch.Generator] = None, delta=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        logits, losses = self.forward_losses(u_idxs, i_idxs)
        reg = torch.zeros((), device=logits.device)
        for v in losses.values():
            reg = reg + v
        return logits, reg
