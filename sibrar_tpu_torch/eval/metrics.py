"""Ranking metrics from top-k hit vectors (port of
``sibrar_tpu/eval/metrics.py``).

Every user-level metric is derived from ``hits [B, k_max]`` (was each
top-ranked item a positive?) and ``n_pos [B]``, so no dense label matrix is
built. Binary relevance; users without positives score 0; NDCG is clamped
to <= 1 and its IDCG runs over the top ``min(n_pos, k)`` ideal ranks. All
arithmetic is f32, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from sibrar_tpu_torch.utils import trace

USER_METRICS = ("ndcg", "wndcg", "recall", "precision", "f_score", "hitrate",
                "ap")
DISTRIBUTION_METRICS = ("coverage",)


def user_metrics_from_hits(hits: torch.Tensor, n_pos: torch.Tensor,
                           ks: tuple[int, ...],
                           metrics: tuple[str, ...] | None = None
                           ) -> dict[str, torch.Tensor]:
    """Per-user ndcg / wndcg / recall / precision / f_score / hitrate / ap
    at every cutoff in ``ks``: ``{f"{metric}@{k}": [B] f32}``, restricted to
    ``metrics`` when given."""
    k_max = hits.shape[1]
    hits = hits.float()
    ranks = torch.arange(k_max, dtype=torch.float32, device=hits.device)
    discount = 1.0 / torch.log2(ranks + 2.0)  # [k_max]
    disc_cumsum = torch.cumsum(discount, 0)  # IDCG prefix sums
    hit_cumsum = torch.cumsum(hits, 1)  # [B, k_max]
    dcg_cumsum = torch.cumsum(hits * discount, 1)
    prec_at_i = hit_cumsum / (ranks + 1.0)  # precision at every rank (AP)
    ap_num_cumsum = torch.cumsum(prec_at_i * hits, 1)

    n_pos_f = n_pos.float()
    zero = torch.zeros((), device=hits.device)
    out: dict[str, torch.Tensor] = {}
    for k in ks:
        kk = min(k, k_max)
        num_hits = hit_cumsum[:, kk - 1]
        dcg = dcg_cumsum[:, kk - 1]
        ideal_n = n_pos.clamp(0, kk).long()
        idcg = torch.where(ideal_n > 0,
                           disc_cumsum[(ideal_n - 1).clamp(min=0)], zero)
        # wNDCG (reference eval/metrics.py:108-128): with binary relevance
        # the per-user sum of rank weights is NDCG without the clamp
        wndcg = torch.where(idcg > 0, dcg / idcg, zero)
        ndcg = wndcg.clamp(0.0, 1.0)
        recall = torch.where(n_pos_f > 0, num_hits / n_pos_f, zero)
        precision = num_hits / kk
        f_den = precision + recall
        f_score = torch.where(f_den > 0, 2 * precision * recall / f_den, zero)
        hitrate = (num_hits > 0).float()
        ap_den = n_pos.clamp(0, kk).clamp(min=1).float()
        ap = torch.where(n_pos > 0, ap_num_cumsum[:, kk - 1] / ap_den, zero)
        for name, val in (("wndcg", wndcg), ("ndcg", ndcg),
                          ("recall", recall), ("precision", precision),
                          ("f_score", f_score), ("hitrate", hitrate),
                          ("ap", ap)):
            if metrics is None or name in metrics:
                out[f"{name}@{k}"] = val
    return out


def coverage_flags(topk_idx: torch.Tensor, ks: tuple[int, ...],
                   n_catalog: int) -> dict[str, torch.Tensor]:
    """Per cutoff, bool ``[n_catalog]`` flags of the items recommended to
    any user of the batch within its top-k; OR-accumulated over batches,
    coverage@k is their mean."""
    out = {}
    for k in ks:
        kk = min(k, topk_idx.shape[1])
        flags = torch.zeros(n_catalog, dtype=torch.bool,
                            device=topk_idx.device)
        with trace.host_wait("metrics.coverage"):  # True is copied first
            flags[topk_idx[:, :kk].reshape(-1).long()] = True
        out[f"coverage@{k}"] = flags
    return out


def weight_ndcg_at_k(n_pos: int, k: int = 10) -> np.ndarray:
    """wNDCG@k rank weights ``(1 / log2(pos + 2)) / IDCG`` over the first
    ``n_pos`` ranks (reference eval/metrics.py:108-128). Returns [k] f32."""
    discount = 1.0 / np.log2(np.arange(2, k + 2, dtype=np.float32))
    return (discount / discount[:n_pos].sum()).astype(np.float32)
