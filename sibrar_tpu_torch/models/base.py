"""Model base contract (port of ``sibrar_tpu/models/base.py`` ``RecModel``).

The three-way representation split lets full-catalog scoring encode the
items once and reuse them for every user batch:
``user_repr(u_idxs)``, ``item_repr(i_idxs)`` and ``combine(u_repr, i_repr)``.
"""
from __future__ import annotations

import torch
from torch import nn


class RecModel(nn.Module):
    def user_repr(self, u_idxs: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def item_repr(self, i_idxs: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

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
        """Dot-product scores ``[B, C]`` of user and catalog representations
        (the training layout [B, 1+n, d] comes with the training slice)."""
        return u_repr @ i_repr.T
