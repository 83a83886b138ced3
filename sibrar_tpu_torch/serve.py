"""Exact top-k recommendation serving (port of ``sibrar_tpu/serve.py``
``Recommender``, single-device f32 path).

- item representations are computed once (`train.scoring.make_score_fn`);
- requests are padded to a fixed batch size;
- each user's already-interacted items (train for a val split, train + val
  for a test split) are excluded through the split's exclusion CSR;
- a dot-product model takes the fused path: K2 scores + window maxima, the
  peel selection (K3, K4) and a dense redo of rows whose exactness flag
  tripped; other scorers take ``masked_topk(method="auto")`` on their
  scores (the peel with K8's window maxima where it is viable);
- catalog positions are mapped back to global item ids.

JAX's ``Recommender`` has one more branch (``sibrar_tpu/serve.py:296-334``):
``peel_masked_topk`` (window planes, ``ops/peel.py`` here) when
``peel_viable(c, k, E, fused=True)`` holds and ``peel_viable(c, k, E)``
does not. Under JAX's own gates that never happens: the [B, C] path fails
its gather gate only above m = 1228 selected windows, the planes path needs
m <= 768. The port's `peel_viable` has no VMEM gates, so its fused and
unfused forms coincide, and the port takes the [B, C] path wherever JAX
does (``tests/test_torch_windowed.py`` pins the JAX fact).

Not in this slice: the ``bfloat16`` / ``int8`` serving dtypes,
``selection="approx"``, the multi-device path and ``from_run_dir``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from sibrar_tpu_torch import full_f32
from sibrar_tpu_torch.data.dataset import DeviceData, RecDataset
from sibrar_tpu_torch.ops.peel import peel_masked_topk_dot, peel_viable
from sibrar_tpu_torch.ops.sparse import DeviceCSR, csr_row_gather
from sibrar_tpu_torch.ops.topk import masked_topk
from sibrar_tpu_torch.ops.window import pad_catalog


class Recommender:
    """Serve exact top-k recommendations for user ids of a fitted model.

    ``score_fn(u_idxs [B]) -> scores [B, n_catalog]`` is the scorer over the
    split's catalog; its ``dot_parts`` attribute, when set, routes serving
    through the fused dot kernels. ``dataset`` is the split the scorer was
    built against. ``redo_rows`` lists, per served batch, the rows the peel
    flagged and the dense path redid."""

    def __init__(self, score_fn: Callable, dataset: RecDataset,
                 device_data: Optional[DeviceData] = None, *,
                 k: int = 100, batch_size: int = 256,
                 exclude_seen: bool = True, device="cuda"):
        full_f32()
        if device_data is None:
            device_data = dataset.to_device(device)
        self.dataset = dataset
        self.data = device_data
        self.device = device_data.catalog.device
        self.k = min(k, dataset.n_items_in_split)
        self.batch_size = batch_size
        self.score_fn = score_fn
        self.redo_rows: list[int] = []
        self._catalog_items = np.asarray(dataset.items_in_split)
        if exclude_seen:
            self.csr = device_data.exclude_csr
        else:  # an empty exclusion CSR: plain top-k
            self.csr = DeviceCSR.empty(dataset.n_users,
                                       dataset.n_items_in_split, self.device)
        self.c = dataset.n_items_in_split
        dot_parts = getattr(score_fn, "dot_parts", None)
        self.use_dot = (dot_parts is not None
                        and peel_viable(self.c, self.k, self.csr.max_row_len))
        if self.use_dot:
            self.user_repr_fn, items = dot_parts
            # pad the catalog ONCE to the GEMM's chunk multiple
            self.items = pad_catalog(items)

    @torch.no_grad()
    def _step(self, u_idxs: torch.Tensor):
        if not self.use_dot:
            scores = self.score_fn(u_idxs)
            return masked_topk(scores, self.csr, u_idxs, self.k,
                               method="auto")
        u_repr = self.user_repr_fn(u_idxs)
        cols, mask = csr_row_gather(self.csr, u_idxs)
        v, i, ok = peel_masked_topk_dot(u_repr, self.items, cols, mask,
                                        self.k, c_real=self.c)
        self.redo_rows.append(int((~ok).sum()))
        return v, i

    def recommend(self, user_ids, k: Optional[int] = None,
                  return_scores: bool = False):
        """Exact top-k global item ids for ``user_ids``: ``ids [N, k]``, or
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
