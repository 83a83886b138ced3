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
        # the model's method, not one of self: a bound method of self kept
        # on self is a reference cycle, which holds the model, its device
        # data and the encoded catalog until the garbage collector runs
        self.dot_parts = model.eval_rank_dot_parts(
            torch.no_grad()(model.user_repr), items)

    @torch.no_grad()
    def __call__(self, u_idxs: torch.Tensor) -> torch.Tensor:
        return self.model.combine(self.model.user_repr(u_idxs), self.items)


@torch.no_grad()
def encode_catalog(model, catalog: torch.Tensor,
                   item_chunk: int = 8192) -> torch.Tensor:
    """Item representations of the whole catalog, in ``item_chunk`` pieces
    (the last one edge-padded) so per-item intermediates, such as the dense
    [chunk, n_users] interaction rows, never exist for the whole catalog;
    a model whose item representation is a tuple gets a tuple."""
    c = catalog.shape[0]
    if c <= item_chunk:
        return model.item_repr(catalog)
    pad = (-c) % item_chunk
    cat_p = torch.cat([catalog, catalog[-1:].expand(pad)])
    out = [model.item_repr(chunk) for chunk in cat_p.split(item_chunk)]
    if isinstance(out[0], tuple):  # several item representations (MF, ACF)
        return tuple(torch.cat(parts)[:c] for parts in zip(*out))
    return torch.cat(out)[:c]


def make_score_fn(model, catalog: torch.Tensor,
                  item_chunk: int = 8192) -> ScoreFn:
    """Encode the catalog once and return the user-batch scorer."""
    full_f32()
    model.eval()
    return ScoreFn(model, encode_catalog(model, catalog, item_chunk))
