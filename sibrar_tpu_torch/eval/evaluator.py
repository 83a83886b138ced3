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

- the dot path (`FullEvaluator.make_dot_ranker`): for scorers that
  expose ``dot_parts``, K2 writes scores and window maxima and the peel
  selects (``ops/peel.py``);
- the scores path: ``score_fn(u_idxs)`` then `masked_topk` with the
  config's ``topk_method``.

The peel flags rows it cannot prove exact; only those rows are redone
densely (JAX redoes whole batches), and ``redo_rows`` records how many per
batch (on the dot path, the count the peel's own redo returns).
Everything runs eagerly, one batch after the other; `evaluate_model`
records the spans ``evaluator.rank`` (a batch's scores and selection) and
``evaluator.metrics`` (its hit tests, metrics and accumulation) per batch,
and ``evaluator.get_results`` per pass.

``eval.score_dtype: bfloat16`` (JAX's ``evaluate_model``): a scorer with
``dot_parts`` is scored from its operands rounded to bf16 with f32 sums,
K15 in place of K2, on the dot path and the scores path alike, so both
rank the same scores; without ``dot_parts`` it warns and stays in f32.

On a device mesh (``mesh=``, `parallel.mesh.make_mesh`) every rank runs the
same global batches: each takes its data-axis rows (`shard_rows`) and its
item-axis slice of the catalog, selects per shard and merges the candidates
over the item group (`parallel.mesh.sharded_masked_topk`, or
`sharded_masked_topk_dot` on the dot path), redoes the rows the peel flags
(flags the item group shares) with the per-shard scatter, and keeps its
rows' per-user metrics. `FullEvaluator.get_results` gathers them over the
data axis in batch order and ORs the coverage flags, so every rank returns
the single-device results up to summation order. A scorer built on the mesh
(``score_fn.mesh``) gives this rank's catalog columns; any other gives the
whole catalog, and this rank keeps its columns.
"""
from __future__ import annotations

import logging
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
from sibrar_tpu_torch.ops.gemm_probe import score_bf16
from sibrar_tpu_torch.ops.peel import peel_masked_topk_dot, peel_viable
from sibrar_tpu_torch.ops.sparse import csr_contains_rows, csr_row_gather
from sibrar_tpu_torch.ops.topk import NEG, masked_topk
from sibrar_tpu_torch.ops.window import WINDOW, pad_catalog, score_wmax
from sibrar_tpu_torch.parallel import distributed as pdist
from sibrar_tpu_torch.parallel.mesh import (
    ITEM_AXIS,
    catalog_slice,
    shard_catalog,
    shard_rows,
    sharded_dot_viable,
    sharded_masked_topk,
    sharded_masked_topk_dot,
)
from sibrar_tpu_torch.utils import trace


def natsort_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


class FullEvaluator:
    """Batch-incremental metric accumulation over full-catalog rankings,
    on the device of its `DeviceData` (the card unless ``device`` says
    otherwise). ``config`` is an `EvalConfig` (``train/trainer.py``).
    ``mesh`` shards batches over its data axis and the catalog over its
    item axis; the eager `eval_batch` / `eval_batch_from_topk` then take
    this rank's rows (and its catalog columns)."""

    def __init__(self, config, dataset: RecDataset,
                 device_data: Optional[DeviceData] = None,
                 evaluator_name: Optional[str] = None, mesh=None,
                 device="cuda"):
        config.validate()
        self.mesh = mesh
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
        self._batch_rows: list[int] = []

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
        """``(metrics, cov)`` of one batch on the scores path."""
        return self._metrics_from_topk(self._scores_topk(scores, u_idxs),
                                       u_idxs)

    def _scores_topk(self, scores: torch.Tensor, u_idxs: torch.Tensor
                     ) -> torch.Tensor:
        """Top-``k_max`` catalog positions of one batch on the scores path;
        rows the peel flags are redone with the scatter top-k. On a mesh
        ``scores`` is this rank's tile (its rows, its catalog columns)."""
        if self.mesh is not None:
            return self._sharded_topk(scores, u_idxs)
        _, topk_idx, ok = masked_topk(scores, self.data.exclude_csr, u_idxs,
                                      self.k_max, method=self.method,
                                      return_ok=True)
        if self._peel_possible:
            with trace.host_wait("evaluator.redo"):
                bad = (~ok).nonzero().squeeze(1)
            self.redo_rows.append(int(bad.numel()))
            if bad.numel():
                _, topk_idx[bad] = masked_topk(
                    scores[bad], self.data.exclude_csr, u_idxs[bad],
                    self.k_max, method="scatter")
        return topk_idx

    def _pad_columns(self, scores: torch.Tensor) -> torch.Tensor:
        """A tile's columns past the catalog (its padding to the item
        axis) at -1e30."""
        lo, local_c = catalog_slice(self.dataset.n_items_in_split, self.mesh)
        live = self.dataset.n_items_in_split - lo
        if live >= local_c:
            return scores
        return torch.cat([scores[:, :live], scores.new_full(
            (scores.shape[0], local_c - live), NEG)], dim=1)

    def _sharded_topk(self, scores: torch.Tensor, u_idxs: torch.Tensor
                      ) -> torch.Tensor:
        """Top-``k_max`` catalog positions of this rank's rows from its tile
        ``scores``: `sharded_masked_topk` (the peel per shard where
        ``topk_method`` allows it and `peel_viable`, an explicit other
        method forcing the scatter), the rows it flags redone with the
        scatter."""
        scores = self._pad_columns(scores)
        cols, mask = csr_row_gather(self.data.exclude_csr, u_idxs)
        use_peel = None if self._peel_possible else False
        _, topk_idx, ok = sharded_masked_topk(
            scores, cols, mask, self.k_max, self.mesh, use_peel=use_peel,
            return_ok=True)
        return self._redo_flagged(topk_idx, ok, lambda rows: scores[rows],
                                  cols, mask)

    def _redo_flagged(self, topk_idx, ok, scores_of, cols, mask):
        """``topk_idx`` with the rows ``ok`` flags redone by the per-shard
        scatter over their tiles ``scores_of(rows)``; the item group
        shares the flags, so its ranks redo together."""
        if not self._peel_possible:
            return topk_idx
        with trace.host_wait("evaluator.redo"):
            bad = (~ok).nonzero().squeeze(1)
        self.redo_rows.append(int(bad.numel()))
        if bad.numel():
            topk_idx[bad] = sharded_masked_topk(
                scores_of(bad), cols[bad], mask[bad], self.k_max, self.mesh,
                use_peel=False)[1]
        return topk_idx

    def make_dot_ranker(self, user_repr_fn: Callable, items: torch.Tensor,
                        score_dtype: Optional[str] = None
                        ) -> Optional[Callable]:
        """The dot path's ranking ``fn(u_idxs) -> topk_idx``, whose lists
        `_metrics_from_topk` scores: K2 scores and window maxima (K15's
        under ``score_dtype="bfloat16"``), the peel, a dense redo of the
        rows it flags. None where it does not apply: an
        explicit ``topk_method`` other than ``auto`` / ``peel`` pins the
        scores path, and the peel must be viable for the catalog, ``k_max``
        and the longest exclusion row."""
        if self.method not in ("auto", "peel"):
            return None
        n_catalog = self.dataset.n_items_in_split
        csr = self.data.exclude_csr
        if self.mesh is not None and self.mesh.shape[ITEM_AXIS] > 1:
            return self._sharded_dot_ranker(user_repr_fn, items, score_dtype)
        if (items.shape[0] != n_catalog
                or not peel_viable(n_catalog, self.k_max, csr.max_row_len)):
            return None
        # pad the catalog to the GEMM's chunk multiple once per evaluation
        items_p = pad_catalog(items)

        def rank(u_idxs: torch.Tensor) -> torch.Tensor:
            cols, mask = csr_row_gather(csr, u_idxs)
            _, topk_idx, _, redone = peel_masked_topk_dot(
                user_repr_fn(u_idxs), items_p, cols, mask, self.k_max,
                c_real=n_catalog, score_dtype=score_dtype,
                return_redone=True)
            self.redo_rows.append(redone)
            return topk_idx

        return rank

    def _sharded_dot_ranker(self, user_repr_fn: Callable,
                            items: torch.Tensor, score_dtype: Optional[str]
                            ) -> Optional[Callable]:
        """The dot path on an item-sharded mesh: every shard runs K2 (K15)
        and the peel on its slice (`sharded_masked_topk_dot`); flagged rows
        are redone by the per-shard scatter over the same kernel's scores.
        ``items`` is this rank's slice or the whole catalog (sliced here).
        None where `sharded_dot_viable` fails."""
        n_catalog = self.dataset.n_items_in_split
        lo, local_c = catalog_slice(n_catalog, self.mesh)
        if not sharded_dot_viable(n_catalog, self.k_max,
                                  self.data.exclude_csr.max_row_len,
                                  self.mesh):
            return None
        if items.shape[0] == n_catalog:
            items = shard_catalog(items, self.mesh)
        if items.shape[0] != local_c:
            return None
        items_p = pad_catalog(items)
        score = score_bf16 if score_dtype == "bfloat16" else score_wmax

        def rank(u_idxs: torch.Tensor) -> torch.Tensor:
            u = user_repr_fn(u_idxs)
            cols, mask = csr_row_gather(self.data.exclude_csr, u_idxs)
            _, topk_idx, ok = sharded_masked_topk_dot(
                u, items_p, cols, mask, self.k_max, self.mesh,
                n_catalog=n_catalog, local_c=local_c,
                score_dtype=score_dtype)
            return self._redo_flagged(
                topk_idx, ok,
                lambda rows: self._pad_columns(
                    score(u[rows], items_p)[0][:, :local_c]),
                cols, mask)

        return rank

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
        self._batch_rows.append(int(u_idxs.shape[0]))
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

    def _gather_ranks(self, per_user, cov, users, valid):
        """Every data rank's per-user values in global batch order (each
        batch's rows rank after rank, as `shard_rows` split them), the
        coverage flags OR-ed over the data axis."""
        group = self.mesh.data_group

        def interleave(x):
            parts = pdist.all_gather(x.contiguous(), group)
            out, start = [], 0
            for rows in self._batch_rows:
                out += [p[..., start:start + rows] for p in parts]
                start += rows
            return torch.cat(out, -1) if out else x

        cov = pdist.all_reduce(cov.to(torch.int32), "max", group) > 0
        users = interleave(users) if users.numel() else users
        per_user = interleave(per_user)
        valid = interleave(torch.as_tensor(valid, device=self.device))
        with trace.host_wait("evaluator.valid"):
            valid = valid.cpu().numpy()
        return per_user, cov, users, valid

    def get_results(self, return_raw_results: bool = False):
        """Means (and population stds with ``compute_std``) of the per-user
        metrics over the valid rows, coverage, group breakdowns; natsorted
        keys. One device-to-host transfer, then `reset`. With
        ``return_raw_results``, ``(metrics, raw)``: ``raw`` maps each
        per-user metric's key to its values over the valid rows, in the
        order the batches came (``-t gather``'s ``raw_metrics``)."""
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
        if self.mesh is not None:
            per_user, cov, users, valid = self._gather_ranks(
                per_user, cov, users, valid)
            n = len(valid)
        # user ids < 2**24 are exact in f32
        with trace.host_wait("evaluator.results"):
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
        if return_raw_results:
            return out, raw
        return out


@torch.no_grad()
def evaluate_model(score_fn: Callable[[torch.Tensor], torch.Tensor],
                   evaluator: FullEvaluator, batch_size: int = 256) -> dict:
    """Evaluate the split's users: ``score_fn(u_idxs [B]) -> scores [B,
    n_catalog]``. Users are padded to whole batches by repeating the last
    one, and the padded rows are masked out of every statistic. A
    ``score_fn.dot_parts = (user_repr_fn, items)`` takes the dot path where
    `FullEvaluator.make_dot_ranker` allows it, otherwise the scores
    path. Under ``evaluator.config.score_dtype == "bfloat16"`` both paths
    rank K15's scores of the dot parts (a scorer without them warns and
    stays in f32). Returns `FullEvaluator.get_results`."""
    dot_parts = getattr(score_fn, "dot_parts", None)
    sd = evaluator.config.score_dtype
    if sd in (None, "float32"):
        sd = None
    elif sd != "bfloat16":
        # also where EvalConfig.validate never ran (a config built in code)
        raise ValueError(f"unsupported score_dtype {sd!r} (use 'float32' or "
                         f"'bfloat16')")
    elif dot_parts is None:
        logging.getLogger(__name__).warning(
            "eval.score_dtype=%s requested but the score_fn exposes no "
            "dot_parts; evaluation stays in the score_fn's own precision",
            sd)
        sd = None
    else:
        score_fn = _bf16_scorer(*dot_parts, getattr(score_fn, "mesh", None))
    users = evaluator.data.users_in_split
    n = int(users.shape[0])
    bs = min(batch_size, max(n, 1))
    pad = (-n) % bs
    if pad:
        users = torch.cat([users, users[-1:].expand(pad)])
    valid = np.arange(n + pad) < n
    mesh = evaluator.mesh
    rank = (evaluator.make_dot_ranker(*dot_parts, score_dtype=sd)
            if dot_parts is not None else None)
    local_cols = getattr(score_fn, "mesh", None) is not None
    for start in range(0, n + pad, bs):
        u = shard_rows(users[start:start + bs], mesh)
        v = valid[start:start + bs]
        if mesh is not None:
            v = shard_rows(torch.from_numpy(v), mesh, fill=False).numpy()
        with trace.span("evaluator.rank"):
            if rank is not None:
                topk_idx = rank(u)
            else:
                scores = score_fn(u)
                if mesh is not None and not local_cols:
                    scores = shard_catalog(scores, mesh, dim=1, fill=NEG)
                topk_idx = evaluator._scores_topk(scores, u)
        with trace.span("evaluator.metrics"):
            metrics, cov = evaluator._metrics_from_topk(topk_idx, u)
            evaluator._accumulate(u, v, metrics, cov)
    with trace.span("evaluator.get_results"):
        return evaluator.get_results()


def _bf16_scorer(user_repr_fn: Callable, items: torch.Tensor, mesh=None
                 ) -> Callable:
    """``fn(u_idxs) -> [B, C]``: K15's scores of the dot parts ``[C, D]``
    (on a mesh this rank's slice, ``fn.mesh`` set), the catalog padded
    once to a 128 multiple (K15's tile)."""
    c = items.shape[0]
    items_p = pad_catalog(items, WINDOW)

    def score_fn(u_idxs: torch.Tensor) -> torch.Tensor:
        scores = score_bf16(user_repr_fn(u_idxs), items_p)[0]
        return scores if scores.shape[1] == c else scores[:, :c].contiguous()

    score_fn.mesh = mesh
    return score_fn
