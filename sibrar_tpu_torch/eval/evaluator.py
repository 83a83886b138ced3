"""Full-catalog evaluation (port of ``sibrar_tpu/eval/evaluator.py``:
``FullEvaluator`` and ``evaluate_model``).

Users of the split are ranked against the whole catalog in batches, with
their already-seen items (train for val, train + val for test) excluded; the
exact top-``k_max`` lists are hit-tested against the split's positives CSR
and turned into per-user metrics (``eval/metrics.py``) and coverage flags,
which stay on the device until `FullEvaluator.get_results` moves them to the
host in one transfer. Keys follow the JAX package: ``{name}/{metric}@{k}``,
``..._std`` (population std), group keys ``{name}/{feature}/{label}/...``.

Two ways to rank a batch:

- the dot path (`FullEvaluator.make_dot_eval_batch`): for scorers that
  expose ``dot_parts``, K2 writes scores and window maxima and the peel
  selects (``ops/peel.py``);
- the scores path: ``score_fn(u_idxs)`` then `masked_topk` with the
  config's ``topk_method``.

The peel flags rows it cannot prove exact; only those rows are redone
densely (JAX redoes whole batches), and ``redo_rows`` records how many per
batch. Everything runs eagerly, one batch after the other.

Not in this slice: the item-sharded ``mesh`` (ROADMAP.md queue 1, item 10)
and ``score_dtype: bfloat16`` (queue 1, item 1; `EvalConfig.validate`
raises).
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Optional

import numpy as np
import torch

from sibrar_tpu_torch.data.dataset import DeviceData, RecDataset
from sibrar_tpu_torch.eval.metrics import (
    DISTRIBUTION_METRICS,
    USER_METRICS,
    coverage_flags,
    user_metrics_from_hits,
)
from sibrar_tpu_torch.ops.peel import peel_masked_topk_dot, peel_viable
from sibrar_tpu_torch.ops.sparse import csr_contains_rows, csr_row_gather
from sibrar_tpu_torch.ops.topk import masked_topk
from sibrar_tpu_torch.ops.window import pad_catalog


def natsort_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


class FullEvaluator:
    """Batch-incremental metric accumulation over full-catalog rankings,
    on the device of its `DeviceData` (the card unless ``device`` says
    otherwise). ``config`` is an `EvalConfig` (``train/trainer.py``)."""

    def __init__(self, config, dataset: RecDataset,
                 device_data: Optional[DeviceData] = None,
                 evaluator_name: Optional[str] = None, mesh=None,
                 device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "the item-sharded evaluator is not ported yet (ROADMAP.md "
                "queue 1, item 10)")
        config.validate()
        self.config = config
        self.name = evaluator_name
        self.dataset = dataset
        self.data = (device_data if device_data is not None
                     else dataset.to_device(device))
        self.device = self.data.catalog.device

        known = set(USER_METRICS) | set(DISTRIBUTION_METRICS)
        invalid = set(config.metrics) - known
        if invalid:
            raise ValueError(f"Metric(s) {invalid} are not supported. Choose "
                             f"from {known}.")
        self._user_metrics = [m for m in config.metrics if m in USER_METRICS]
        self._dist_metrics = [m for m in config.metrics
                              if m in DISTRIBUTION_METRICS]
        self.ks = tuple(sorted(config.top_k))
        self.k_max = min(max(self.ks), dataset.n_items_in_split)

        # group-metric features must be categorical (reference
        # eval/eval.py:85-87), with labels for their codes
        self._group_features = {}
        for fname in config.group_metrics:
            feat = dataset.user_features.get(fname)
            if feat is None:
                raise ValueError(f'Dataset does not contain user feature '
                                 f'"{fname}".')
            if feat.kind != "categorical":
                raise ValueError(f'User feature "{fname}" is not '
                                 f'categorical.')
            if feat.value_map is None:
                raise ValueError(f'User feature "{fname}" has no value_map '
                                 f'to label its groups.')
            self._group_features[fname] = feat
        self.method = config.topk_method
        # only the peel can flag rows that need the dense redo
        self._peel_possible = self.method in ("auto", "peel")
        self.redo_rows: list[int] = []
        self.reset()

    def reset(self) -> None:
        self._per_user: Dict[str, list] = {}
        self._per_user_users: list = []
        self._valid: list = []
        self._cov_flags: Dict[str, torch.Tensor] = {}

    def _metrics_from_topk(self, topk_idx: torch.Tensor,
                           u_idxs: torch.Tensor):
        """Hit-test the top-k catalog positions against the positives CSR
        and derive every requested user metric and the coverage flags."""
        pos = self.data.pos_csr
        hits = csr_contains_rows(pos, u_idxs, topk_idx)
        u = u_idxs.long()
        n_pos = pos.indptr[u + 1] - pos.indptr[u]
        return (user_metrics_from_hits(hits, n_pos, self.ks,
                                       metrics=tuple(self._user_metrics)),
                coverage_flags(topk_idx, self.ks,
                               self.dataset.n_items_in_split))

    def _eval_batch(self, scores: torch.Tensor, u_idxs: torch.Tensor):
        """``(metrics, cov)`` of one batch on the scores path; rows the peel
        flags are redone with the scatter top-k."""
        _, topk_idx, ok = masked_topk(scores, self.data.exclude_csr, u_idxs,
                                      self.k_max, method=self.method,
                                      return_ok=True)
        if self._peel_possible:
            n_bad = int((~ok).sum())
            self.redo_rows.append(n_bad)
            if n_bad:
                bad = (~ok).nonzero().squeeze(1)
                _, topk_idx[bad] = masked_topk(
                    scores[bad], self.data.exclude_csr, u_idxs[bad],
                    self.k_max, method="scatter")
        return self._metrics_from_topk(topk_idx, u_idxs)

    def make_dot_eval_batch(self, user_repr_fn: Callable,
                            items: torch.Tensor) -> Optional[Callable]:
        """The dot path's batch function ``fn(u_idxs) -> (metrics, cov)``: K2
        scores and window maxima, the peel, a dense redo of the rows it
        flags. None where it does not apply: an explicit
        ``topk_method`` other than ``auto`` / ``peel`` pins the scores path,
        and the peel must be viable for the catalog, ``k_max`` and the
        longest exclusion row."""
        if self.method not in ("auto", "peel"):
            return None
        n_catalog = self.dataset.n_items_in_split
        csr = self.data.exclude_csr
        if (items.shape[0] != n_catalog
                or not peel_viable(n_catalog, self.k_max, csr.max_row_len)):
            return None
        # pad the catalog to the GEMM's chunk multiple once per evaluation
        items_p = pad_catalog(items)

        def eval_batch(u_idxs: torch.Tensor):
            cols, mask = csr_row_gather(csr, u_idxs)
            _, topk_idx, ok = peel_masked_topk_dot(
                user_repr_fn(u_idxs), items_p, cols, mask, self.k_max,
                c_real=n_catalog)
            self.redo_rows.append(int((~ok).sum()))
            return self._metrics_from_topk(topk_idx, u_idxs)

        return eval_batch

    # ---------------------------------------------------------- accumulate
    @torch.no_grad()
    def eval_batch(self, u_idxs: torch.Tensor, scores: torch.Tensor,
                   valid: Optional[np.ndarray] = None) -> None:
        """Accumulate one user batch; ``scores`` is [B, n_catalog] and
        ``valid`` masks padded rows out of every statistic."""
        self._accumulate(u_idxs, valid, *self._eval_batch(scores, u_idxs))

    @torch.no_grad()
    def eval_batch_from_topk(self, u_idxs: torch.Tensor,
                             topk_idx: torch.Tensor,
                             valid: Optional[np.ndarray] = None) -> None:
        """Accumulate one batch from already selected, exclusion-masked
        top-k catalog positions ``topk_idx [B, >= k_max]``."""
        if topk_idx.shape[1] < self.k_max:
            raise ValueError(f"topk_idx provides k={topk_idx.shape[1]} < "
                             f"k_max={self.k_max}")
        metrics, cov = self._metrics_from_topk(topk_idx[:, :self.k_max],
                                               u_idxs)
        self._accumulate(u_idxs, valid, metrics, cov)

    def _accumulate(self, u_idxs, valid, metrics, cov) -> None:
        self._per_user_users.append(u_idxs)
        self._valid.append(np.ones(int(u_idxs.shape[0]), bool)
                           if valid is None else np.asarray(valid, bool))
        for k, v in metrics.items():
            self._per_user.setdefault(k, []).append(v)
        for k, flags in cov.items():
            # padded rows repeat a real user of the split, whose items are
            # counted anyway
            self._cov_flags[k] = (self._cov_flags[k] | flags
                                  if k in self._cov_flags else flags)

    # ------------------------------------------------------------- results
    def _key(self, base: str) -> str:
        return f"{self.name}/{base}" if self.name else base

    def get_results(self) -> dict:
        """Means (and population stds with ``compute_std``) of the per-user
        metrics over the valid rows, coverage, group breakdowns; natsorted
        keys. One device-to-host transfer, then `reset`."""
        valid = (np.concatenate(self._valid) if self._valid
                 else np.zeros(0, bool))
        names = [k for k in self._per_user
                 if k.split("@")[0] in self._user_metrics]
        cov_names = [k for k in self._cov_flags
                     if k.split("@")[0] in self._dist_metrics]
        n, n_cat, dev = len(valid), self.dataset.n_items_in_split, self.device
        per_user = (torch.stack([torch.cat(self._per_user[k]) for k in names])
                    if names else torch.zeros((0, n), device=dev))
        cov = (torch.stack([self._cov_flags[k] for k in cov_names])
               if cov_names else torch.zeros((0, n_cat), device=dev))
        users = (torch.cat(self._per_user_users)
                 if self._group_features and self._per_user_users
                 else torch.zeros(0, device=dev))
        # user ids < 2**24 are exact in f32
        host = torch.cat([per_user.flatten(), cov.float().flatten(),
                          users.float()]).cpu().numpy()
        per_user = host[:per_user.numel()].reshape(len(names), n)
        cov = host[per_user.size:per_user.size + cov.numel()].reshape(
            len(cov_names), n_cat) > 0
        users = host[per_user.size + cov.size:].astype(np.int64)

        raw = {self._key(k): per_user[i][valid] for i, k in enumerate(names)}
        out = {k: float(v.mean()) for k, v in raw.items()}
        if self.config.compute_std:
            out.update({f"{k}_std": float(v.std()) for k, v in raw.items()})
        for i, k in enumerate(cov_names):
            out[self._key(k)] = float(cov[i].mean())

        if self._group_features:
            users = users[valid]
            for fname, feat in self._group_features.items():
                codes = np.asarray(feat.table)[users]
                inv = {v: k for k, v in feat.value_map.items()}
                for code in np.unique(codes):
                    sel = codes == code
                    label = str(inv[int(code)]).lower()
                    for i, mk in enumerate(names):
                        v = per_user[i][valid][sel]
                        key = self._key(f"{fname}/{label}/{mk}")
                        out[key] = float(v.mean())
                        if self.config.compute_std:
                            out[f"{key}_std"] = float(v.std())

        out = {k: out[k] for k in sorted(out, key=natsort_key)}
        self.reset()
        return out


@torch.no_grad()
def evaluate_model(score_fn: Callable[[torch.Tensor], torch.Tensor],
                   evaluator: FullEvaluator, batch_size: int = 256) -> dict:
    """Evaluate the split's users: ``score_fn(u_idxs [B]) -> scores [B,
    n_catalog]``. Users are padded to whole batches by repeating the last
    one, and the padded rows are masked out of every statistic. A
    ``score_fn.dot_parts = (user_repr_fn, items)`` takes the dot path where
    `FullEvaluator.make_dot_eval_batch` allows it, otherwise the scores
    path. Returns `FullEvaluator.get_results`."""
    users = evaluator.data.users_in_split
    n = int(users.shape[0])
    bs = min(batch_size, max(n, 1))
    pad = (-n) % bs
    if pad:
        users = torch.cat([users, users[-1:].expand(pad)])
    valid = np.arange(n + pad) < n
    dot_parts = getattr(score_fn, "dot_parts", None)
    dot_batch = (evaluator.make_dot_eval_batch(*dot_parts)
                 if dot_parts is not None else None)
    for start in range(0, n + pad, bs):
        u = users[start:start + bs]
        metrics, cov = (dot_batch(u) if dot_batch is not None
                        else evaluator._eval_batch(score_fn(u), u))
        evaluator._accumulate(u, valid[start:start + bs], metrics, cov)
    return evaluator.get_results()
