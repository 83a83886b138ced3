"""Recommendation and regularization losses (port of
``sibrar_tpu/train/losses.py``).

Every rec loss takes ``logits [B, 1 + n_neg]`` whose first column is the
positive; ``info_nce`` is the symmetric CLIP-style InfoNCE between two
aligned embedding sets.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Callable

import torch
import torch.nn.functional as F

from sibrar_tpu_torch.parallel.mesh import gather_batch


def _aggregate(x: torch.Tensor, aggregator: str) -> torch.Tensor:
    if aggregator == "mean":
        return x.mean()
    if aggregator == "sum":
        return x.sum()
    raise ValueError(f"unknown aggregator {aggregator!r}")


def _bce_with_logits(logits: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise BCE with logits (the JAX spelling)."""
    return (logits.clamp(min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def rec_bce(logits, labels, *, aggregator: str = "mean", **_):
    """BCE over all logits; labels are 1 in the first column, 0 elsewhere."""
    return _aggregate(_bce_with_logits(logits, labels), aggregator)


def rec_bpr(logits, labels, *, aggregator: str = "mean", **_):
    """Bayesian Personalized Ranking: BCE on (pos - neg) differences."""
    diff = logits[:, :1] - logits[:, 1:]
    return _aggregate(_bce_with_logits(diff, torch.ones_like(diff)),
                      aggregator)


def rec_sampled_softmax(logits, labels, *, aggregator: str = "mean",
                        n_items: int, n_neg: int,
                        train_neg_strategy: str = "uniform", **_):
    """Sampled softmax with the uniform-proposal correction
    ``log(n_items / n_neg)`` added to the negative logits."""
    pos = logits[:, 0]
    if train_neg_strategy == "uniform":
        correction = math.log(n_items / n_neg)
        logits = torch.cat([logits[:, :1], logits[:, 1:] + correction], 1)
    return _aggregate(torch.logsumexp(logits, dim=-1) - pos, aggregator)


REC_LOSSES: dict[str, Callable] = {
    "bce": rec_bce,
    "bpr": rec_bpr,
    "sampled_softmax": rec_sampled_softmax,
}


def build_rec_loss(name: str, *, n_items: int, n_neg: int,
                   aggregator: str = "mean",
                   train_neg_strategy: str = "uniform") -> Callable:
    return partial(REC_LOSSES[name], aggregator=aggregator, n_items=n_items,
                   n_neg=n_neg, train_neg_strategy=train_neg_strategy)


def info_nce(first_emb: torch.Tensor, second_emb: torch.Tensor, *,
             temperature: float = 1.0,
             aggregator: str = "mean") -> torch.Tensor:
    """Symmetric InfoNCE over ``[..., m, d]`` pairs: the contrast set is the
    last-but-one axis, the diagonal holds the positives. Where that axis is
    the batch (``[B, d]`` pairs), a data-parallel step contrasts the global
    batch (`parallel.mesh.gather_batch`)."""
    if first_emb.ndim == 2:
        first_emb = gather_batch(first_emb)
        second_emb = gather_batch(second_emb)
    logits = torch.einsum("...md,...nd->...mn", first_emb,
                          second_emb) / temperature
    m = logits.shape[-1]
    loss_ab = -torch.diagonal(F.log_softmax(logits, dim=-1), dim1=-2,
                              dim2=-1)
    loss_ba = -torch.diagonal(F.log_softmax(logits.transpose(-1, -2),
                                            dim=-1), dim1=-2, dim2=-1)
    return (_aggregate(loss_ab.reshape(-1, m), aggregator)
            + _aggregate(loss_ba.reshape(-1, m), aggregator))
