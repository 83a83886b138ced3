"""Top-k recommendation serving (port of ``sibrar_tpu/serve.py``: the
single-device ``Recommender``, its ``dtype`` / ``selection`` modes,
``quantize_rows_int8`` and ``from_run_dir``).

- item representations are computed once (`train.scoring.make_score_fn`);
- requests are padded to a fixed batch size;
- each user's already-interacted items (train for a val split, train + val
  for a test split) are excluded through the split's exclusion CSR;
- a dot-product model takes the fused path where the peel is viable: K2
  scores + window maxima (K15 under ``dtype="bfloat16"``), the peel
  selection (K3, K4) and a dense redo of rows whose exactness flag
  tripped; otherwise scores, then ``masked_topk(method="auto")`` (the peel
  with K8's window maxima where it is viable), or, under
  ``selection="approx"``, the exclusion fill and K13 ``exact_topk``;
- catalog positions are mapped back to global item ids.

A dot-product model's scores come from the port's kernels in every mode
and on every branch, so the fast path, the redo and the scores path rank
the same scores: K2 in f32, K15 in bf16, ``torch._int_mm`` in int8. A
scorer without ``dot_parts`` is called as it is.

JAX's ``Recommender`` has one more branch (``sibrar_tpu/serve.py:296-334``):
``peel_masked_topk`` (window planes, ``ops/peel.py`` here) when
``peel_viable(c, k, E, fused=True)`` holds and ``peel_viable(c, k, E)``
does not. Under JAX's own gates that never happens: the [B, C] path fails
its gather gate only above m = 1228 selected windows, the planes path needs
m <= 768. The port's `peel_viable` has no VMEM gates, so its fused and
unfused forms coincide, and the port takes the [B, C] path wherever JAX
does (``tests/test_torch_windowed.py`` pins the JAX fact).

On a device mesh (``mesh=``; JAX ``serve.py:217-277``) each served batch
shards its users over the data axis and the catalog over the item axis:
a dot-product model takes the per-shard dot chain
(`parallel.mesh.sharded_masked_topk_dot`, K2 or K15 and the peel) where
`sharded_dot_viable`, with a per-shard scatter redo of the rows the peel
flags; any other scorer, and int8, ranks its tile's scores with the
per-shard scatter (`sharded_masked_topk`). Ids are clamped into the
catalog, the lists are gathered, and every rank returns all of them.
``selection="approx"`` warns and serves exact there, as JAX does. A mesh
whose item axis is 1 runs the single-device path on each rank's rows.
"""
from __future__ import annotations

import logging
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from sibrar_tpu_torch import full_f32
from sibrar_tpu_torch.data.dataset import DeviceData, RecDataset
from sibrar_tpu_torch.ops.exact_topk import exact_topk
from sibrar_tpu_torch.ops.gemm_probe import score_bf16
from sibrar_tpu_torch.ops.peel import peel_masked_topk_dot, peel_viable
from sibrar_tpu_torch.ops.sparse import (
    DeviceCSR,
    csr_row_gather,
    scatter_fill_rows,
)
from sibrar_tpu_torch.ops.topk import NEG, masked_topk, resolve_method
from sibrar_tpu_torch.ops.window import pad_catalog, score_wmax
from sibrar_tpu_torch.parallel.mesh import (
    ITEM_AXIS,
    catalog_slice,
    gather_rows,
    shard_catalog,
    shard_rows,
    sharded_dot_viable,
    sharded_masked_topk,
    sharded_masked_topk_dot,
)

logger = logging.getLogger(__name__)

DTYPES = ("float32", "bfloat16", "int8")
# torch._int_mm on the card: more than 16 rows, depth and columns multiples
# of 8; the int8 operands are zero-padded to these (zeros add nothing)
INT8_MIN_ROWS = 17
INT8_MULTIPLE = 8


def quantize_rows_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization, JAX's arithmetic in its order:
    ``s = max(max|row| / 127, 1e-12)`` (an all-zero row stays zero), ``q =
    clip(round(x / s), -127, 127)`` with ties to even. Returns ``(q int8
    [R, D], s f32 [R])``; dequantization is ``q.float() * s[:, None]``."""
    x = x.float()
    # a tensor divisor: PyTorch multiplies by the reciprocal of a Python
    # scalar divisor on the card, which is not JAX's (or the CPU's) division
    s = (x.abs().amax(dim=1) / x.new_tensor(127.0)).clamp_min(1e-12)
    q = torch.round(x / s[:, None]).clamp(-127, 127).to(torch.int8)
    return q, s


def _pad_int8(q: torch.Tensor, rows: int) -> torch.Tensor:
    """``q [R, D]`` zero-padded to at least ``rows`` rows and to multiples
    of `INT8_MULTIPLE` in both dimensions."""
    r, d = q.shape
    rp = -(-max(r, rows) // INT8_MULTIPLE) * INT8_MULTIPLE
    dp = -(-d // INT8_MULTIPLE) * INT8_MULTIPLE
    return q if (rp, dp) == (r, d) else F.pad(q, (0, dp - d, 0, rp - r))


def quantize_items_int8(items: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The item table for `int8_scores`: `quantize_rows_int8`, with ``q``
    zero-padded to multiples of 8 in rows and depth (``s`` unpadded)."""
    q, s = quantize_rows_int8(items)
    return _pad_int8(q, 0), s


def int8_scores(u_repr: torch.Tensor, q_items: torch.Tensor,
                s_items: torch.Tensor) -> torch.Tensor:
    """Scores ``[B, C]`` of the int8 x int8 -> int32 product (JAX
    ``_int8_scores``): ``u_repr`` is quantized per row here, then
    ``(acc.float() * s_u[:, None]) * s_items[None, :]`` in that order.
    ``q_items`` is `quantize_items_int8`'s (C = ``len(s_items)`` live
    rows). The product is ``torch._int_mm``, exact in int32 (|acc| <= D
    127^2), so the card and the CPU give the same bits; JAX computes it
    outside any Pallas kernel."""
    b, c = u_repr.shape[0], s_items.shape[0]
    q_u, s_u = quantize_rows_int8(u_repr)
    q_u = _pad_int8(q_u, INT8_MIN_ROWS)
    if q_u.shape[1] != q_items.shape[1]:
        raise ValueError(f"int8_scores: depth {u_repr.shape[1]} against "
                         f"the table's padded {q_items.shape[1]}")
    acc = torch._int_mm(q_u, q_items.T)[:b, :c]
    # int32 x f32 converts acc to f32 inside the multiply: the bits of
    # acc.float() * s_u, one pass over [B, C] fewer
    return (acc * s_u[:, None]).mul_(s_items)


class Recommender:
    """Serve top-k recommendations for user ids of a fitted model.

    ``score_fn(u_idxs [B]) -> scores [B, n_catalog]`` is the scorer over the
    split's catalog; its ``dot_parts = (user_repr_fn, items)`` attribute,
    when set, routes serving through the port's dot kernels. ``dataset`` is
    the split the scorer was built against. ``redo_rows`` lists, per served
    batch, the rows the peel flagged and the dense path redid.

    ``dtype`` (dot-product models; JAX's keyword): ``None`` or
    ``"float32"`` serves f32 scores (K2). ``"bfloat16"`` rounds both GEMM
    operands to bf16 with f32 sums (K15, which rounds the f32 table as it
    reads it): the fused path where the peel is viable, else K15's scores
    on the scores path. ``"int8"`` quantizes the item table once here and
    the user side per batch (`quantize_rows_int8`), and ranks
    `int8_scores` on the scores path. Selection stays exact for the scores
    it is given, and exclusion is exact. On a scorer without ``dot_parts``
    it logs one warning and serves in the scorer's own precision.

    ``selection="approx"`` (JAX's ``lax.approx_max_k`` at
    ``recall_target``, which has no torch counterpart): the exclusions are
    filled with -1e30 exactly (`scatter_fill_rows`), then K13
    `exact_topk` ranks, so the port's "approx" lists are exact, with
    recall 1.0, at or above any ``recall_target``; JAX's CPU path gives
    the same lists. As in JAX, approx never takes the fused dot path.

    ``mesh`` serves on every rank of a device mesh (see the module's
    docstring); ``score_fn`` may be a mesh scorer (``score_fn.mesh``, its
    ``dot_parts`` this rank's catalog slice) or a whole-catalog one."""

    def __init__(self, score_fn: Callable, dataset: RecDataset,
                 device_data: Optional[DeviceData] = None, *,
                 k: int = 100, batch_size: int = 256,
                 exclude_seen: bool = True, device="cuda", mesh=None,
                 dtype: Optional[str] = None, selection: str = "exact",
                 recall_target: float = 0.95):
        if selection not in ("exact", "approx"):
            raise ValueError(f"unknown selection mode {selection!r} "
                             "(expected 'exact' or 'approx')")
        if not (0.0 < recall_target <= 1.0):
            raise ValueError(f"recall_target must be in (0, 1], got "
                             f"{recall_target}")
        if dtype is not None and dtype not in DTYPES:
            raise ValueError(f"unsupported serving dtype {dtype!r} (use "
                             f"one of {DTYPES})")
        full_f32()
        if device_data is None:
            device_data = dataset.to_device(device)
        self.dataset = dataset
        self.data = device_data
        self.device = device_data.catalog.device
        self.k = min(k, dataset.n_items_in_split)
        self.batch_size = batch_size
        self.score_fn = score_fn
        self.selection = selection
        self.recall_target = recall_target
        self.redo_rows: list[int] = []
        self._catalog_items = np.asarray(dataset.items_in_split)
        if exclude_seen:
            self.csr = device_data.exclude_csr
        else:  # an empty exclusion CSR: plain top-k
            self.csr = DeviceCSR.empty(dataset.n_users,
                                       dataset.n_items_in_split, self.device)
        self.c = dataset.n_items_in_split
        self.mesh = mesh
        self._sharded = mesh is not None and mesh.shape[ITEM_AXIS] > 1
        if self._sharded and selection == "approx":
            logger.warning("selection='approx' is a single-device knob; the "
                           "mesh path selects exactly per shard; serving "
                           "exact")
            self.selection = "exact"
        self._lo, self._local_c = catalog_slice(self.c, mesh)
        self._local_cols = getattr(score_fn, "mesh", None) is not None
        dot_parts = getattr(score_fn, "dot_parts", None)
        self.dtype = None if dtype == "float32" else dtype
        if self.dtype is not None and dot_parts is None:
            logger.warning("dtype=%s requested but the score_fn exposes no "
                           "dot_parts; serving stays in the score_fn's own "
                           "precision", self.dtype)
            self.dtype = None
        self.use_dot = (dot_parts is not None and self.selection == "exact"
                        and self.dtype != "int8"
                        and (sharded_dot_viable(
                            self.c, self.k, max(self.csr.max_row_len, 1),
                            mesh) if self._sharded else peel_viable(
                            self.c, self.k, self.csr.max_row_len)))
        self._peel_scores = resolve_method(
            "auto", self.c, self.k, self.csr.max_row_len) == "peel"
        self._dot = dot_parts is not None
        if self._dot:
            self.user_repr_fn, items = dot_parts
            if self._sharded and items.shape[0] == self.c:
                items = shard_catalog(items, mesh)
            if self.dtype == "int8":  # quantized once, held instead
                self.q_items, self.s_items = quantize_items_int8(items)
            else:  # padded ONCE to the GEMM's chunk multiple
                self.items = pad_catalog(items)

    def _scores(self, u_idxs: torch.Tensor) -> torch.Tensor:
        """The scores path's ``[B, C]`` scores of a batch (on an
        item-sharded mesh this rank's ``[B, local_c]`` columns, those past
        the catalog at -1e30)."""
        if not self._dot:
            scores = self.score_fn(u_idxs)
            if self._sharded and not self._local_cols:
                scores = shard_catalog(scores, self.mesh, dim=1, fill=NEG)
        else:
            u_repr = self.user_repr_fn(u_idxs)
            if self.dtype == "int8":
                scores = int8_scores(u_repr, self.q_items, self.s_items)
            else:
                score = score_bf16 if self.dtype == "bfloat16" else score_wmax
                scores = score(u_repr, self.items)[0]
                width = self._local_c if self._sharded else self.c
                if scores.shape[1] != width:
                    scores = scores[:, :width].contiguous()
        live = self.c - self._lo
        if self._sharded and live < self._local_c:
            scores = torch.cat([scores[:, :live], scores.new_full(
                (scores.shape[0], self._local_c - live), NEG)], dim=1)
        return scores

    def _sharded_step(self, u_idxs: torch.Tensor):
        """This rank's rows of a batch on an item-sharded mesh."""
        cols, mask = csr_row_gather(self.csr, u_idxs)
        if self.use_dot:
            v, i, ok = sharded_masked_topk_dot(
                self.user_repr_fn(u_idxs), self.items, cols, mask, self.k,
                self.mesh, n_catalog=self.c, local_c=self._local_c,
                score_dtype=self.dtype)
            bad = (~ok).nonzero().squeeze(1)  # shared by the item group
            self.redo_rows.append(int(bad.numel()))
            if bad.numel():
                v[bad], i[bad] = sharded_masked_topk(
                    self._scores(u_idxs[bad]), cols[bad], mask[bad], self.k,
                    self.mesh, use_peel=False)
        else:
            v, i = sharded_masked_topk(self._scores(u_idxs), cols, mask,
                                       self.k, self.mesh, use_peel=False)
        return v, i.clamp(max=self.c - 1)

    @torch.no_grad()
    def _step(self, u_idxs: torch.Tensor):
        if self.mesh is not None:
            u = shard_rows(u_idxs, self.mesh)
            v, i = (self._sharded_step(u) if self._sharded
                    else self._local_step(u))
            b = u_idxs.shape[0]
            return gather_rows(v, self.mesh, b), gather_rows(i, self.mesh, b)
        return self._local_step(u_idxs)

    def _local_step(self, u_idxs: torch.Tensor):
        if self.use_dot:
            cols, mask = csr_row_gather(self.csr, u_idxs)
            v, i, ok = peel_masked_topk_dot(
                self.user_repr_fn(u_idxs), self.items, cols, mask, self.k,
                c_real=self.c, score_dtype=self.dtype)
            self.redo_rows.append(int((~ok).sum()))
            return v, i
        scores = self._scores(u_idxs)
        if self.selection == "approx":
            if self.csr.max_row_len:
                cols, mask = csr_row_gather(self.csr, u_idxs)
                scores = scatter_fill_rows(scores, cols, mask, fill=NEG)
            return exact_topk(scores.contiguous(), self.k)
        if not self._peel_scores:
            return masked_topk(scores, self.csr, u_idxs, self.k,
                               method="auto")
        v, i, ok = masked_topk(scores, self.csr, u_idxs, self.k,
                               method="peel", return_ok=True)
        bad = (~ok).nonzero().squeeze(1)
        self.redo_rows.append(int(bad.numel()))
        if bad.numel():
            v[bad], i[bad] = masked_topk(scores[bad], self.csr, u_idxs[bad],
                                         self.k, method="full")
        return v, i

    def recommend(self, user_ids, k: Optional[int] = None,
                  return_scores: bool = False):
        """Top-k global item ids for ``user_ids``: ``ids [N, k]``, or
        ``(ids, scores)`` with ``return_scores=True``."""
        k = self.k if k is None else min(k, self.k)
        users = np.asarray(user_ids, dtype=np.int64).reshape(-1)
        if len(users) and (users.min() < 0
                           or users.max() >= self.dataset.n_users):
            raise ValueError(f"user ids must lie in [0, "
                             f"{self.dataset.n_users})")
        users = users.astype(np.int32)
        n = len(users)
        if n == 0:
            ids = np.zeros((0, k), dtype=self._catalog_items.dtype)
            vals = np.zeros((0, k), np.float32)
            return (ids, vals) if return_scores else ids
        pad = (-n) % self.batch_size
        if pad:
            users = np.concatenate([users, np.repeat(users[-1:], pad)])
        vals, idxs = [], []
        for start in range(0, len(users), self.batch_size):
            batch = torch.as_tensor(users[start:start + self.batch_size],
                                    device=self.device)
            v, i = self._step(batch)
            vals.append(v)
            idxs.append(i)
        v = torch.cat(vals)[:n, :k].cpu().numpy()
        i = torch.cat(idxs)[:n, :k].cpu().numpy()
        ids = self._catalog_items[i]  # catalog position -> global item id
        return (ids, v) if return_scores else ids

    @classmethod
    def from_run_dir(cls, run_dir: str, split: str = "test", *,
                     device=None, **kwargs) -> "Recommender":
        """Rebuild a fitted run (``conf.yml``, ``model.pt``) for serving
        (`experiment.load_for_serving`). ``split`` picks the catalog and
        exclusion context: ``"test"`` excludes train + val interactions,
        ``"val"`` train only. ``device`` defaults to the run's
        ``run_settings.device``; ``k`` to the largest ``eval.top_k``. The
        run's ``parallel`` block applies to serving too (a mesh under
        torchrun, none in one process); pass ``mesh=None`` for one
        device."""
        from sibrar_tpu_torch.experiment import _run_conf, load_for_serving
        from sibrar_tpu_torch.parallel.mesh import make_mesh_from_config

        if "mesh" not in kwargs:
            kwargs["mesh"] = make_mesh_from_config(_run_conf(run_dir).parallel)
        score_fn, dataset, device_data, k = load_for_serving(
            run_dir, split, device, mesh=kwargs["mesh"])
        kwargs.setdefault("k", k)
        return cls(score_fn, dataset, device_data, **kwargs)
