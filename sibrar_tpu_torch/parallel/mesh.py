"""The (data, item) device mesh and the sharded selections (port of
``sibrar_tpu/parallel/mesh.py``).

The JAX package places arrays on a ``Mesh`` of devices and lets GSPMD and
``shard_map`` split the work. Here every device is one process (SPMD over
``torch.distributed``) and rank ``r`` sits at ``(r // item, r % item)`` of
a ``DeviceMesh`` with axes ``("data", "item")``, JAX's row-major layout.
Each rank holds:

- its data-axis slice of every batch (`shard_rows`; `gather_rows` puts the
  batch back together on every rank);
- its item-axis slice of the catalog (`shard_catalog`) and of the
  interaction towers' first-layer kernels (`shard_tower_state`);
- full copies of everything else.

The sharded selections take this rank's tile of the global problem (its
rows, its catalog columns) and return its rows of the global answer:
per-shard selection by the port's single-device chains, then an all-gather
of the ``[rows, k]`` candidates over the item group and a re-selection with
K13 (`_merge_local_topk`).

While the trainer runs a data-parallel step it opens `batch_shard`: the
layers then draw their random masks for the whole batch and keep their own
rows (`local_draw`), batch norm reduces its statistics over the batch's
ranks, and the losses that contrast or compare rows across the batch
gather them first (`gather_batch`).
"""
from __future__ import annotations

import contextlib
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from sibrar_tpu_torch.parallel import distributed as pdist

DATA_AXIS = "data"
ITEM_AXIS = "item"
NEG = -1e30


class Mesh:
    """The world's ranks as a ``(data, item)`` grid. ``shape`` maps each
    axis to its size; ``data_index`` / ``item_index`` are this rank's
    coordinates; ``data_group`` holds the ranks of this rank's item column
    (its batch rows differ), ``item_group`` those of its data row (its
    catalog slices differ), ``world_group`` every rank of the mesh.
    ``nodes[d, i]`` is the node of the rank at ``(d, i)``."""

    def __init__(self, data: int, item: int):
        self.shape = {DATA_AXIS: data, ITEM_AXIS: item}
        self.size = data * item
        self.rank = pdist.rank() if self.size > 1 else 0
        self.data_index, self.item_index = divmod(self.rank, item)
        self.nodes = (np.arange(self.size).reshape(data, item)
                      // max(pdist.local_world_size(), 1))
        self.device_mesh = None
        if self.size == 1:
            self.data_group = self.item_group = pdist.SOLO
            self.world_group = pdist.SOLO
        else:
            from torch.distributed.device_mesh import init_device_mesh

            kind = "cuda" if torch.cuda.is_available() else "cpu"
            self.device_mesh = init_device_mesh(
                kind, (data, item), mesh_dim_names=(DATA_AXIS, ITEM_AXIS))
            self.data_group = self.device_mesh.get_group(DATA_AXIS)
            self.item_group = self.device_mesh.get_group(ITEM_AXIS)
            self.world_group = None
        self._sub_groups: dict = {}

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape[DATA_AXIS]}, "
                f"item={self.shape[ITEM_AXIS]}, rank={self.rank})")

    def sub_groups(self, groups: tuple) -> tuple:
        """This rank's process groups of the hierarchical merge over item
        positions ``groups``: ``(stage 1, stage 2)``, stage 1 its own
        group of positions in its data row, stage 2 the positions at its
        place in every group. Every rank makes every group, in one order,
        the first time ``groups`` is asked for."""
        if groups not in self._sub_groups:
            import torch.distributed as dist

            item = self.shape[ITEM_AXIS]
            stage2 = tuple(tuple(g[j] for g in groups)
                           for j in range(len(groups[0])))
            mine = []
            for stage in (groups, stage2):
                own = None
                for d in range(self.shape[DATA_AXIS]):
                    for g in stage:
                        pg = dist.new_group([d * item + j for j in g])
                        if d == self.data_index and self.item_index in g:
                            own = pg
                mine.append(own)
            self._sub_groups[groups] = tuple(mine)
        return self._sub_groups[groups]


def make_mesh(n_devices: Optional[int] = None, *,
              item_parallelism: Optional[int] = None) -> Mesh:
    """The (data, item) mesh over the world's ranks (the first
    ``n_devices`` of them, at most the world). ``item_parallelism`` fixes
    the item axis; by default it is the largest power of two whose square
    is at most n and that divides n, so 8 ranks give (4, 2) and one gives
    (1, 1). A mesh of more than one rank spans the whole world: every rank
    runs the same program."""
    world = pdist.world_size()
    n = world if n_devices is None else min(n_devices, world)
    if item_parallelism is None:
        item_parallelism = 1
        while (item_parallelism * 2) ** 2 <= n and n % (item_parallelism * 2) == 0:
            item_parallelism *= 2
    if n % item_parallelism:
        raise ValueError(f"{n} devices not divisible by item_parallelism="
                         f"{item_parallelism}")
    if 1 < n < world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}: a "
                         f"mesh spans every rank or one")
    return Mesh(n // item_parallelism, item_parallelism)


def make_mesh_from_config(parallel) -> Optional[Mesh]:
    """A `ParallelConfig` as a mesh, or None for one device. The world
    size plays the part of JAX's device count; ``enabled: null`` turns the
    mesh on only for a world of more than one rank on CUDA (JAX: on a
    TPU), and one device never gets a mesh, ``enabled: true`` or not."""
    if parallel is None:
        return None
    n = pdist.world_size()
    if parallel.n_devices is not None:
        n = min(parallel.n_devices, n)
    enabled = parallel.enabled
    if enabled is None:
        enabled = n > 1 and torch.cuda.is_available()
    if not enabled or n <= 1:
        return None
    return make_mesh(n, item_parallelism=parallel.item_parallelism)


def batch_multiple(mesh: Optional[Mesh]) -> int:
    """Train batches divide over every rank of the mesh (pure data
    parallelism shards them over both axes)."""
    return mesh.size if mesh is not None else 1


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


# ------------------------------------------------------------ batch and catalog
def batch_group(mesh: Mesh, flat: bool = False):
    """``(group, index, size)`` of the ranks a batch shards over: every
    rank of the mesh with ``flat`` (nothing tensor-parallel), else the data
    axis (the item axis then splits the towers' contraction)."""
    if flat:
        return mesh.world_group, mesh.rank, mesh.size
    return mesh.data_group, mesh.data_index, mesh.shape[DATA_AXIS]


def shard_rows(x: torch.Tensor, mesh: Optional[Mesh], *, flat: bool = False,
               fill=None) -> torch.Tensor:
    """This rank's rows of ``x``. Rows are padded to a multiple of the
    group with ``fill`` (None repeats the last row) first."""
    if mesh is None:
        return x
    _, idx, n = batch_group(mesh, flat)
    b = x.shape[0]
    pad = (-b) % n
    if pad:
        tail = (x[-1:].expand(pad, *x.shape[1:]) if fill is None else
                torch.full((pad, *x.shape[1:]), fill, dtype=x.dtype,
                           device=x.device))
        x = torch.cat([x, tail])
    rows = x.shape[0] // n
    return x[idx * rows:(idx + 1) * rows]


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh], b: Optional[int] = None,
                *, flat: bool = False) -> torch.Tensor:
    """Every rank's rows of ``x`` in batch order, the first ``b`` of them
    (the inverse of `shard_rows`)."""
    if mesh is None:
        return x if b is None else x[:b]
    group = batch_group(mesh, flat)[0]
    out = torch.cat(pdist.all_gather(x, group))
    return out if b is None else out[:b]


def catalog_slice(c: int, mesh: Optional[Mesh]) -> tuple[int, int]:
    """``(lo, local_c)``: this rank's first catalog position and slice
    width, the catalog padded to a multiple of the item axis."""
    if mesh is None:
        return 0, c
    local_c = pad_to_multiple(c, mesh.shape[ITEM_AXIS]) // mesh.shape[ITEM_AXIS]
    return mesh.item_index * local_c, local_c


def shard_catalog(x: torch.Tensor, mesh: Optional[Mesh], *, dim: int = 0,
                  fill: float = 0.0) -> torch.Tensor:
    """This rank's item slice of ``x`` along ``dim`` (the catalog padded
    with ``fill`` to a multiple of the item axis)."""
    if mesh is None:
        return x
    c = x.shape[dim]
    lo, local_c = catalog_slice(c, mesh)
    pad = local_c * mesh.shape[ITEM_AXIS] - c
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, torch.full(shape, fill, dtype=x.dtype,
                                     device=x.device)], dim=dim)
    return x.narrow(dim, lo, local_c)


# --------------------------------------------------------- data-parallel steps
_SHARD: Optional[SimpleNamespace] = None


@contextlib.contextmanager
def batch_shard(mesh: Optional[Mesh], flat: bool):
    """Within it, the layers treat their batch as this rank's rows of a
    global batch sharded over `batch_group` (nothing without a mesh)."""
    global _SHARD
    if mesh is None:
        yield
        return
    group, idx, n = batch_group(mesh, flat)
    prev, _SHARD = _SHARD, SimpleNamespace(group=group, index=idx, size=n)
    try:
        yield
    finally:
        _SHARD = prev


def local_draw(draw, shape) -> torch.Tensor:
    """``draw(shape)``; inside `batch_shard`, ``draw`` of the global batch's
    shape (dim 0 times the group) and this rank's rows of it, so every
    rank consumes its generator as the single-device step does."""
    shape = tuple(shape)
    if _SHARD is None or _SHARD.size == 1 or not shape:
        return draw(shape)
    rows = shape[0]
    full = draw((rows * _SHARD.size, *shape[1:]))
    return full[_SHARD.index * rows:(_SHARD.index + 1) * rows]


def batch_sharded() -> bool:
    """Inside `batch_shard`, over more than one rank."""
    return _SHARD is not None and _SHARD.size > 1


def row_offset(rows: int) -> int:
    """The global position of this rank's first row of ``rows`` (0 outside
    `batch_shard`)."""
    return 0 if _SHARD is None else _SHARD.index * rows


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """Inside `batch_shard`, the global batch of ``x`` (rows of every
    rank, differentiable); ``x`` itself outside."""
    if _SHARD is None:
        return x
    return pdist.gather_rows_grad(x, _SHARD.group)


def reduce_batch(x: torch.Tensor) -> torch.Tensor:
    """Inside `batch_shard`, the sum of ``x`` over the batch's ranks
    (differentiable); ``x`` itself outside."""
    if _SHARD is None:
        return x
    return pdist.all_reduce_grad(x, _SHARD.group)


# ------------------------------------------------------- tower tensor parallel
def _is_tower_kernel(name: str, leaf: torch.Tensor, n_shards: int,
                     min_rows: int) -> bool:
    """First-layer kernels of interaction towers, by JAX's structural
    rule: a 2-D parameter named ``kernel`` whose input dim (rows) is
    entity-sized (>= ``min_rows``) and divides over the item axis."""
    if getattr(leaf, "ndim", 0) != 2 or name.rsplit(".", 1)[-1] != "kernel":
        return False
    return leaf.shape[0] >= min_rows and leaf.shape[0] % n_shards == 0


def shard_tower_state(model: torch.nn.Module, mesh: Optional[Mesh], *,
                      min_rows: int = 8192, optimizer=None) -> dict:
    """Row-slice every tower kernel (`_is_tower_kernel`) over the item axis,
    with its optimizer moments; every other parameter stays a full copy.
    Returns ``{parameter name: (lo, hi, full rows)}`` of the sliced ones
    (empty without a mesh or with an item axis of 1). The module owning a
    kernel must have ``set_row_slice``."""
    if mesh is None or mesh.shape[ITEM_AXIS] <= 1:
        return {}
    n_shards = mesh.shape[ITEM_AXIS]
    sliced = {}
    state = getattr(optimizer, "state", {})
    for mod_name, module in model.named_modules():
        for p_name, p in module.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            if not _is_tower_kernel(name, p, n_shards, min_rows):
                continue
            if not hasattr(module, "set_row_slice"):
                raise TypeError(f"{name}: {type(module).__name__} has no "
                                f"row-parallel forward")
            n = p.shape[0]
            rows = n // n_shards
            lo = mesh.item_index * rows
            with torch.no_grad():
                p.data = p.data[lo:lo + rows].clone()
                for key, t in state.get(p, {}).items():
                    state[p][key] = t[lo:lo + rows].clone()
            module.set_row_slice(lo, lo + rows, mesh.item_group)
            sliced[name] = (lo, lo + rows, n)
    return sliced


def full_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A row-sliced tensor put back together over the item group."""
    return torch.cat(pdist.all_gather(t, mesh.item_group))


# --------------------------------------------------------------- top-k merge
def hierarchical_item_groups(mesh) -> Optional[tuple]:
    """Item positions grouped by node, for the two-stage merge: a tuple of
    equal-sized contiguous groups, one per node, or None where the flat
    merge already suits (one node, one shard a node, uneven groups, or data
    rows that map item positions to nodes differently). ``mesh.nodes[d, i]``
    is the node of the rank at ``(d, i)`` (``rank // LOCAL_WORLD_SIZE``).
    Any uniform partition merges exactly; the grouping only decides which
    gathers stay inside a node."""
    n_items = mesh.shape[ITEM_AXIS]
    if n_items <= 1:
        return None
    rows = [list(r) for r in np.asarray(mesh.nodes).reshape(-1, n_items)]
    if any(r != rows[0] for r in rows[1:]):
        return None
    procs = rows[0]
    groups, cur = [], [0]
    for j in range(1, n_items):
        if procs[j] == procs[j - 1]:
            cur.append(j)
        else:
            groups.append(cur)
            cur = [j]
    groups.append(cur)
    sizes = {len(g) for g in groups}
    if len(groups) <= 1 or len(sizes) != 1 or sizes == {1}:
        return None
    return tuple(tuple(g) for g in groups)


def _select(v_all: torch.Tensor, i_all: torch.Tensor, k: int):
    from sibrar_tpu_torch.ops.topk import lax_topk

    vk, pos = lax_topk(v_all.contiguous(), k)
    return vk, i_all.gather(1, pos)


def _gather_cols(x: torch.Tensor, group) -> torch.Tensor:
    """``[rows, w]`` of every rank of ``group`` side by side, in group-rank
    order (JAX ``all_gather(axis=1, tiled=True)``)."""
    return torch.cat(pdist.all_gather(x, group), dim=1)


def _merge_local_topk(v, i, k: int, kk: int, local_c: int, mesh: Mesh,
                      ok=None, item_groups=None):
    """The candidate merge every sharded top-k shares: globalize the local
    ids, pad ``kk -> k`` with -inf and id 0, all-gather the ``[rows, k]``
    candidates over the item group in shard-major order (which is global
    id order), re-select with K13 (`ops.topk.lax_topk`) and take the ids
    exactly. ``ok`` flags AND over the item group. With ``item_groups``
    (`hierarchical_item_groups`) the gather runs in two stages: within each
    node's group of shards, then across nodes among the ranks at one place
    in every group."""
    i = i.long() + mesh.item_index * local_c
    if kk < k:
        v = torch.nn.functional.pad(v, (0, k - kk), value=float("-inf"))
        i = torch.nn.functional.pad(i, (0, k - kk))
    if item_groups is not None:
        g1, g2 = mesh.sub_groups(tuple(tuple(g) for g in item_groups))
        vh, ih = _select(_gather_cols(v, g1), _gather_cols(i, g1), k)
        vk, idx = _select(_gather_cols(vh, g2), _gather_cols(ih, g2), k)
    else:
        vk, idx = _select(_gather_cols(v, mesh.item_group),
                          _gather_cols(i, mesh.item_group), k)
    if ok is None:
        return vk, idx
    ok = pdist.all_reduce(ok.to(torch.int32), "min", mesh.item_group)
    return vk, idx, ok.bool()


def _local_exclusions(cols, mask, local_c: int, mesh: Mesh):
    """Global exclusion columns down to this shard's local slice."""
    lc = cols - mesh.item_index * local_c
    lmask = mask & (lc >= 0) & (lc < local_c)
    return torch.where(lmask, lc, 0).to(torch.int32), lmask


def _groups(mesh: Mesh, item_groups):
    return hierarchical_item_groups(mesh) if item_groups == "auto" else item_groups


def sharded_topk(scores: torch.Tensor, k: int, mesh: Mesh, *,
                 item_groups="auto") -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the catalog from this rank's tile ``scores [rows,
    local_c]`` (`shard_rows` of its `shard_catalog` columns): the exact
    windowed top-k of the slice, then `_merge_local_topk`. Returns this
    rank's rows ``(values [rows, k], global ids [rows, k])``; the [B, C]
    matrix never exists on any rank."""
    from sibrar_tpu_torch.ops.topk import windowed_topk

    local_c = scores.shape[1]
    kk = min(k, local_c)
    v, i = windowed_topk(scores, kk)
    return _merge_local_topk(v, i, k, kk, local_c, mesh,
                             item_groups=_groups(mesh, item_groups))


def sharded_masked_topk(scores: torch.Tensor, excl_cols: torch.Tensor,
                        excl_mask: torch.Tensor, k: int, mesh: Mesh, *,
                        use_peel: Optional[bool] = None,
                        return_ok: bool = False, item_groups="auto"):
    """Exclusion + exact top-k from this rank's tile ``scores [rows,
    local_c]`` and its rows' global exclusions ``[rows, E]``, without a
    scatter over the whole catalog: each shard masks the exclusions that
    land in its slice and selects over it (the peel,
    `ops.peel.peel_masked_topk_scores` with K8, K3, K4, where
    `peel_viable`; else the -1e30 scatter and `ops.topk.windowed_topk`),
    then `_merge_local_topk`.

    The peel runs without its dense redo: with ``return_ok`` the rows it
    could not prove exact come back flagged (AND over the item group) for
    the caller to redo with ``use_peel=False``; without it the scatter
    path is forced. Pad rows (`shard_rows` with ``fill=NEG`` scores and no
    exclusions) select among ties and are sliced off by `gather_rows`."""
    from sibrar_tpu_torch.ops.peel import peel_masked_topk_scores, peel_viable
    from sibrar_tpu_torch.ops.sparse import scatter_fill_rows
    from sibrar_tpu_torch.ops.topk import windowed_topk

    local_c = scores.shape[1]
    kk = min(k, local_c)
    if use_peel is None:
        use_peel = peel_viable(local_c, kk, excl_cols.shape[1])
    if not return_ok:
        use_peel = False
    lc, lmask = _local_exclusions(excl_cols, excl_mask, local_c, mesh)
    if use_peel:
        v, i, ok = peel_masked_topk_scores(scores, lc, lmask, kk,
                                           with_fallback=False)
    else:
        s = scatter_fill_rows(scores, lc, lmask, fill=NEG)
        v, i = windowed_topk(s, kk)
        ok = torch.ones(scores.shape[0], dtype=torch.bool,
                        device=scores.device)
    v, idx, ok = _merge_local_topk(v, i, k, kk, local_c, mesh, ok=ok,
                                   item_groups=_groups(mesh, item_groups))
    return (v, idx, ok) if return_ok else (v, idx)


def sharded_dot_viable(c: int, k: int, e: int, mesh: Mesh) -> bool:
    """Gate of `sharded_masked_topk_dot`: an item axis of more than one
    shard whose slice passes the single-device peel margins, the catalog's
    pad positions counted as exclusions."""
    from sibrar_tpu_torch.ops.peel import peel_viable

    n_shards = mesh.shape[ITEM_AXIS]
    if n_shards <= 1:
        return False
    cp = pad_to_multiple(c, n_shards)
    local_c = cp // n_shards
    return peel_viable(local_c, min(k, local_c), e + (cp - c))


def sharded_masked_topk_dot(u: torch.Tensor, items: torch.Tensor,
                            excl_cols: torch.Tensor, excl_mask: torch.Tensor,
                            k: int, mesh: Mesh, *, n_catalog: int,
                            local_c: Optional[int] = None,
                            score_dtype: Optional[str] = None,
                            item_groups="auto"):
    """The dot path on a mesh: this rank's users ``u [rows, D]`` against
    its catalog slice ``items`` (`shard_catalog` of the ``[C, D]`` table;
    it may come padded further to the GEMM's chunk, ``local_c`` then the
    slice width) through the single-device chain,
    `ops.peel.peel_masked_topk_dot` (K2 scores and window maxima, the peel
    with K3 / K4), without its redo, then `_merge_local_topk`. The
    catalog's pad positions (C up to a multiple of the item axis) are
    excluded through the exclusion channel; the slice that holds them is
    the only one that keeps them. Returns ``(values, ids, ok)`` for this
    rank's rows, ids clamped to ``n_catalog - 1`` (a user with fewer
    than k unseen items ties into the -1e30 tail)."""
    from sibrar_tpu_torch.ops.peel import (
        peel_masked_topk,
        peel_masked_topk_dot,
        peel_viable,
    )

    n_shards = mesh.shape[ITEM_AXIS]
    c = n_catalog
    cp = pad_to_multiple(c, n_shards)
    local_c = cp // n_shards if local_c is None else local_c
    b = u.shape[0]
    if cp != c:
        pad_cols = torch.arange(c, cp, dtype=excl_cols.dtype,
                                device=excl_cols.device).expand(b, cp - c)
        excl_cols = torch.cat([excl_cols, pad_cols], dim=1)
        excl_mask = torch.cat([excl_mask, torch.ones(
            (b, cp - c), dtype=torch.bool, device=excl_mask.device)], dim=1)
    kk = min(k, local_c)
    lc, lmask = _local_exclusions(excl_cols, excl_mask, local_c, mesh)
    if peel_viable(local_c, kk, lc.shape[1]):
        v, i, ok = peel_masked_topk_dot(
            u, items, lc, lmask, kk, with_fallback=False,
            c_real=None if items.shape[0] == local_c else local_c,
            score_dtype=score_dtype)
    else:
        v, i, ok = peel_masked_topk(u, items[:local_c], lc, lmask, kk,
                                    with_fallback=False)
    v, idx, ok = _merge_local_topk(v, i, k, kk, local_c, mesh, ok=ok,
                                   item_groups=_groups(mesh, item_groups))
    return v, idx.clamp(max=c - 1), ok
