"""Negative sampling and modality sampling on the device (port of
``sibrar_tpu/data/sampling.py``).

Every sampler works in catalog space (positions within ``items_in_split``)
and draws from an explicit ``torch.Generator`` on the tensors' device. The
rejection samplers keep the JAX package's fixed number of rounds and fetch
the users' positive rows once, outside the round loop. Their random draws
are injectable (``draws``: the first candidates and one fresh draw per
round, ``[n_rounds + 1, B, n_neg]``), so a test can feed in the exact
``jax.random`` draws and compare the results bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from sibrar_tpu_torch.ops.sparse import (
    DeviceCSR,
    contains_pregathered,
    contains_rows_pregather,
    csr_contains,
)


def _bad_mask(csr: DeviceCSR, users: torch.Tensor, cand: torch.Tensor,
              distinct: bool, pre) -> torch.Tensor:
    """True where a candidate is a positive of its user or, with
    ``distinct``, repeats an earlier candidate of the same row."""
    if pre is not None:
        bad = contains_pregathered(*pre, cand)
    else:
        bad = csr_contains(csr, users.unsqueeze(-1), cand)
    if distinct:
        n = cand.shape[-1]
        eq = cand.unsqueeze(2) == cand.unsqueeze(1)  # [B, n, n]
        earlier = torch.ones((n, n), dtype=torch.bool,
                             device=cand.device).tril(-1)
        bad = bad | (eq & earlier).any(-1)
    return bad


def _reject(pos_csr: DeviceCSR, users: torch.Tensor, draws: torch.Tensor,
            distinct: bool) -> torch.Tensor:
    """Round ``i`` replaces the bad candidates with ``draws[i + 1]``."""
    pre = contains_rows_pregather(pos_csr, users)  # hoisted row fetch
    cand = draws[0]
    for fresh in draws[1:]:
        bad = _bad_mask(pos_csr, users, cand, distinct, pre)
        cand = torch.where(bad, fresh, cand)
    return cand


def sample_negatives_uniform(gen: Optional[torch.Generator],
                             users: torch.Tensor, pos_csr: DeviceCSR, *,
                             n_catalog: int, n_neg: int,
                             distinct: bool = True, n_rounds: int = 8,
                             draws: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Uniform negatives ``[B, n_neg]`` int32, rejecting the user's
    positives (and, with ``distinct``, repeats within a row) for
    ``n_rounds`` rounds (``distinct=False`` is the recbole variant)."""
    b = users.shape[0]
    if draws is None:
        draws = torch.randint(0, n_catalog, (n_rounds + 1, b, n_neg),
                              generator=gen, device=users.device,
                              dtype=torch.int32)
    return _reject(pos_csr, users, draws, distinct)


def sample_negatives_popular(gen: Optional[torch.Generator],
                             users: torch.Tensor, pos_csr: DeviceCSR,
                             popularity: torch.Tensor, *, n_neg: int,
                             squashing_factor: float = 1.0,
                             n_rounds: int = 4,
                             exclude_positives: bool = True,
                             draws: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Negatives ``[B, n_neg]`` drawn with probability proportional to
    ``popularity ** squashing_factor`` (floored at 1e-12 before the power),
    rejecting positives for ``n_rounds`` rounds."""
    b = users.shape[0]
    if draws is None:
        logits = squashing_factor * torch.log(popularity.clamp(min=1e-12))
        probs = torch.softmax(logits, dim=0)
        rounds = n_rounds + 1 if exclude_positives else 1
        draws = torch.multinomial(probs, rounds * b * n_neg,
                                  replacement=True, generator=gen)
        draws = draws.to(torch.int32).reshape(rounds, b, n_neg)
    if not exclude_positives:
        return draws[0]
    return _reject(pos_csr, users, draws, distinct=False)


def sample_negatives(gen: Optional[torch.Generator], users: torch.Tensor,
                     pos_csr: DeviceCSR, popularity: torch.Tensor, *,
                     strategy: str, n_catalog: int, n_neg: int,
                     squashing_factor: float = 1.0) -> torch.Tensor:
    """Dispatch over the three reference sampling strategies."""
    if strategy == "uniform":
        return sample_negatives_uniform(gen, users, pos_csr,
                                        n_catalog=n_catalog, n_neg=n_neg,
                                        distinct=True)
    if strategy == "uniform_recbole":
        return sample_negatives_uniform(gen, users, pos_csr,
                                        n_catalog=n_catalog, n_neg=n_neg,
                                        distinct=False)
    if strategy == "popular":
        return sample_negatives_popular(gen, users, pos_csr, popularity,
                                        n_neg=n_neg,
                                        squashing_factor=squashing_factor)
    raise ValueError(f"unknown negative sampling strategy {strategy!r}")


def sample_k_modalities(gen: Optional[torch.Generator], shape: tuple,
                        n_modalities: int, k: int,
                        central: Optional[int] = None,
                        device="cuda") -> torch.Tensor:
    """``k`` distinct modality ids per element, ``shape + (k,)`` int64:
    one uniform id (k = 1); two distinct uniform ids (k = 2); or the
    ``central`` id and one uniform other, in random order (JAX
    ``sample_k_modalities``)."""
    if k not in (1, 2):
        raise ValueError("only k in (1, 2) occur in SBNet configurations")
    shape = tuple(shape)

    def randint(high):
        return torch.randint(0, high, shape, generator=gen, device=device)

    if k == 1:
        return randint(n_modalities).unsqueeze(-1)
    if central is None:
        first = randint(n_modalities)
        second = randint(n_modalities - 1)
        second = torch.where(second >= first, second + 1, second)
    else:
        first = torch.full(shape, central, device=device)
        second = randint(n_modalities - 1)
        second = torch.where(second >= central, second + 1, second)
    pair = torch.stack([first, second], dim=-1)
    flip = torch.rand(shape, generator=gen, device=device) < 0.5
    return torch.where(flip.unsqueeze(-1), pair.flip(-1), pair)


def balanced_routing(n_modalities: int, k: int,
                     central: Optional[int] = None) -> list[list[int]]:
    """Static residue -> modality tables of balanced modality routing:
    ``slots[rho][j]`` is the modality of sampling slot ``j`` for batch rows
    at position ``rho`` mod ``P = len(slots)``. k = 1: P = n; pairwise
    (k = 2): P = n (n - 1), every ordered pair of distinct modalities once;
    central: P = n - 1, the central modality then each other one."""
    if k == 1:
        return [[m] for m in range(n_modalities)]
    if k != 2:
        raise ValueError("only k in (1, 2) occur in SBNet configurations")
    if central is not None:
        return [[central, m] for m in range(n_modalities) if m != central]
    slots = []
    for rho in range(n_modalities * (n_modalities - 1)):
        m1 = rho % n_modalities
        off = (rho // n_modalities) % (n_modalities - 1)
        slots.append([m1, (m1 + 1 + off) % n_modalities])
    return slots
