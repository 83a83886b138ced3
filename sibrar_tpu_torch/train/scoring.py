"""Catalog encode and user-batch scorer (port of
``sibrar_tpu/train/trainer.py:454 Trainer.make_score_fn``).

On a device mesh the catalog's chunks shard their rows over the batch's
ranks (every rank with pure data parallelism, the data axis when tower
kernels are row-sliced, whose item group then encodes the same rows), the
encoded rows are gathered, and each rank keeps its item slice
(`parallel.mesh.shard_catalog`, zero rows past the catalog): the scorer
then gives this rank's ``[B, local_c]`` columns and ``dot_parts`` its
``[local_c, d]`` slice."""
from __future__ import annotations

import torch

from sibrar_tpu_torch import full_f32
from sibrar_tpu_torch.parallel.mesh import (
    gather_rows,
    shard_catalog,
    shard_rows,
)


class ScoreFn:
    """``score_fn(u_idxs [B]) -> scores [B, C]`` over the encoded catalog.
    ``dot_parts = (user_repr_fn, items)`` is set when the model ranks like a
    dot product, which routes serving through the fused GEMM -> top-k path.
    On a mesh ``items`` is this rank's catalog slice, ``n_catalog`` the
    whole catalog's size."""

    def __init__(self, model, items: torch.Tensor, mesh=None,
                 n_catalog: int | None = None):
        self.model = model
        self.items = items
        self.mesh = mesh
        self.n_catalog = n_catalog
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
                   item_chunk: int = 8192, mesh=None,
                   flat: bool = True) -> torch.Tensor:
    """Item representations of the whole catalog, in ``item_chunk`` pieces
    (the last one edge-padded) so per-item intermediates, such as the dense
    [chunk, n_users] interaction rows, never exist for the whole catalog;
    a model whose item representation is a tuple gets a tuple. On a mesh
    each chunk's rows shard over the batch's ranks and come back
    gathered."""
    c = catalog.shape[0]

    def encode(chunk):
        if mesh is None:
            return model.item_repr(chunk)
        out = model.item_repr(shard_rows(chunk, mesh, flat=flat))
        if isinstance(out, tuple):
            return tuple(gather_rows(o, mesh, chunk.shape[0], flat=flat)
                         for o in out)
        return gather_rows(out, mesh, chunk.shape[0], flat=flat)

    if c <= item_chunk:
        return encode(catalog)
    pad = (-c) % item_chunk
    cat_p = torch.cat([catalog, catalog[-1:].expand(pad)])
    out = [encode(chunk) for chunk in cat_p.split(item_chunk)]
    if isinstance(out[0], tuple):  # several item representations (MF, ACF)
        return tuple(torch.cat(parts)[:c] for parts in zip(*out))
    return torch.cat(out)[:c]


def make_score_fn(model, catalog: torch.Tensor,
                  item_chunk: int = 8192, mesh=None,
                  flat: bool = True) -> ScoreFn:
    """Encode the catalog once and return the user-batch scorer (on a mesh
    over this rank's catalog slice)."""
    full_f32()
    model.eval()
    items = encode_catalog(model, catalog, item_chunk, mesh, flat)
    if mesh is None:
        return ScoreFn(model, items)
    local = (tuple(shard_catalog(x, mesh) for x in items)
             if isinstance(items, tuple) else shard_catalog(items, mesh))
    return ScoreFn(model, local, mesh, catalog.shape[0])
