"""Catalog encode and user-batch scorer (port of
``sibrar_tpu/train/trainer.py:454 Trainer.make_score_fn``)."""
from __future__ import annotations

import torch

from sibrar_tpu_torch import full_f32


class ScoreFn:
    """``score_fn(u_idxs [B]) -> scores [B, C]`` over the encoded catalog.
    ``dot_parts = (user_repr_fn, items)`` is set when the model ranks like a
    dot product, which routes serving through the fused GEMM -> top-k path."""

    def __init__(self, model, items: torch.Tensor):
        self.model = model
        self.items = items
        self.dot_parts = model.eval_rank_dot_parts(self.user_repr, items)

    @torch.no_grad()
    def user_repr(self, u_idxs: torch.Tensor) -> torch.Tensor:
        return self.model.user_repr(u_idxs)

    @torch.no_grad()
    def __call__(self, u_idxs: torch.Tensor) -> torch.Tensor:
        return self.model.combine(self.model.user_repr(u_idxs), self.items)


@torch.no_grad()
def encode_catalog(model, catalog: torch.Tensor,
                   item_chunk: int = 8192) -> torch.Tensor:
    """Item representations of the whole catalog, in ``item_chunk`` pieces
    (the last one edge-padded) so per-item intermediates, such as the dense
    [chunk, n_users] interaction rows, never exist for the whole catalog."""
    c = catalog.shape[0]
    if c <= item_chunk:
        return model.item_repr(catalog)
    pad = (-c) % item_chunk
    cat_p = torch.cat([catalog, catalog[-1:].expand(pad)])
    out = [model.item_repr(chunk) for chunk in cat_p.split(item_chunk)]
    return torch.cat(out)[:c]


def make_score_fn(model, catalog: torch.Tensor,
                  item_chunk: int = 8192) -> ScoreFn:
    """Encode the catalog once and return the user-batch scorer."""
    full_f32()
    model.eval()
    return ScoreFn(model, encode_catalog(model, catalog, item_chunk))
