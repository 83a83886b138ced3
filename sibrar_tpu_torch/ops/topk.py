"""Exact top-k with per-user exclusion (port of ``sibrar_tpu/ops/topk.py``).

`masked_topk` dispatches over six methods, all exact:

- ``full``: scatter -1e30 into the excluded columns, then ``torch.topk``
  (`topk_excluding`). It is also the redo for peel rows whose exactness flag
  tripped, and the oracle the tests and the chip smoke compare with;
- ``scatter``: the same scatter, then the two-phase `windowed_topk`;
- ``noscatter``: `windowed_topk_excluded`, exclusion by CSR bisection on
  the candidates of ``k + E`` windows;
- ``peel``: the value-peel selection over the scores (``ops/peel.py``,
  kernels K8, K3, K4);
- ``pallas``: the windowed retile and finalist re-ranking
  (``ops/window.py``, kernels K9 and K3 on the tiling);
- ``auto``: the JAX package's accelerator branch on every device.
"""
from __future__ import annotations

import logging

import torch
import torch.nn.functional as F

from sibrar_tpu_torch.ops.sparse import (
    DeviceCSR,
    csr_contains,
    csr_row_gather,
    scatter_fill_rows,
)

NEG = -1e30
METHODS = ("auto", "full", "scatter", "noscatter", "peel", "pallas")


def topk_excluding(scores: torch.Tensor, cols: torch.Tensor,
                   mask: torch.Tensor, k: int, *, c_real: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``min(k, c_real)`` of each row of ``scores`` with ``cols[mask]``
    and the padded columns ``>= c_real`` set to -1e30."""
    c = scores.shape[1]
    c_real = c if c_real is None else c_real
    scores = scatter_fill_rows(scores, cols, mask, fill=NEG)
    if c_real < c:
        live = torch.arange(c, device=scores.device) < c_real
        scores = torch.where(live, scores, NEG)
    return torch.topk(scores, min(k, c_real), dim=1)


def _window_candidates(scores: torch.Tensor, m: int, window: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Values and column ids ``[B, m * window]`` of the top-``m`` windows by
    maximum (the row padded to a ``window`` multiple with -1e30)."""
    b, c = scores.shape
    pad = (-c) % window
    if pad:
        scores = F.pad(scores, (0, pad), value=NEG)
    sw = scores.view(b, -1, window)
    widx = torch.topk(sw.amax(-1), min(m, sw.shape[1]), dim=1).indices
    cand_v = sw.gather(1, widx[:, :, None].expand(-1, -1, window))
    cand_c = widx[:, :, None] * window + torch.arange(window,
                                                      device=scores.device)
    return cand_v.reshape(b, -1), cand_c.reshape(b, -1)


def windowed_topk(scores: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the last axis by the two-phase window algorithm: the
    top-k 128-wide windows by maximum hold the top-k values (JAX
    ``windowed_topk``)."""
    c = scores.shape[1]
    if k >= c or c <= 2 * 128:
        return torch.topk(scores, min(k, c), dim=1)
    cand_v, cand_c = _window_candidates(scores, k, 128)
    v, p = torch.topk(cand_v, k, dim=1)
    return v, cand_c.gather(1, p)


def windowed_topk_excluded(scores: torch.Tensor, exclude_csr: DeviceCSR,
                           u_idxs: torch.Tensor, k: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k with each user's CSR row treated as -1e30, without a
    scatter into [B, C]: the top ``k + E`` 64-wide windows by raw maximum
    (an excluded item displaces at most its own window; E the longest
    row), then the candidates are tested against the row by bisection (JAX
    ``windowed_topk_excluded``)."""
    cand_v, cand_c = _window_candidates(scores, k + exclude_csr.max_row_len,
                                        64)
    hit = csr_contains(exclude_csr, u_idxs[:, None], cand_c)
    v, p = torch.topk(torch.where(hit, NEG, cand_v), k, dim=1)
    return v, cand_c.gather(1, p)


def masked_topk(scores: torch.Tensor, exclude_csr: DeviceCSR,
                u_idxs: torch.Tensor, k: int, method: str = "auto",
                return_ok: bool = False):
    """Top-k of ``scores[b]`` with user ``u_idxs[b]``'s CSR row excluded
    (set to -1e30): ``(values, indices int64)``, or with ``return_ok=True``
    ``(values, indices, ok [B])``, where the peel skips its dense redo and
    ``ok`` flags the rows it could not prove exact (all True for every
    other method).

    ``auto`` follows the JAX package's accelerator branch on every device:
    ``full`` when C <= 4096 or k >= C, ``peel`` when `peel_viable`,
    ``scatter`` otherwise. On the CPU that runs the kernels' plain versions,
    so the CPU tests reach the same orchestration as the card; the results
    are exact either way. ``pallas`` runs as asked on every device (JAX
    degrades it to ``scatter`` off the TPU). An explicit ``peel`` that
    `peel_viable` refuses takes ``scatter``, as in JAX: its merge would
    have fewer peeled values than k."""
    from sibrar_tpu_torch.ops.peel import peel_masked_topk_scores, peel_viable
    from sibrar_tpu_torch.ops.window import pallas_masked_topk_scores

    if method not in METHODS:
        raise ValueError(f"unknown top-k method {method!r}; choose from "
                         f"{METHODS}")
    c = scores.shape[1]
    e = exclude_csr.max_row_len
    if method == "auto":
        if c <= 4096 or k >= c:
            method = "full"
        else:
            method = "peel" if peel_viable(c, k, e) else "scatter"
    elif method == "peel" and not peel_viable(c, k, e):
        logging.getLogger(__name__).warning(
            "topk method 'peel' is not viable at C=%d, k=%d, E=%d; using "
            "'scatter'", c, k, e)
        method = "scatter"

    if method == "peel":
        cols, mask = csr_row_gather(exclude_csr, u_idxs)
        v, i, ok = peel_masked_topk_scores(scores, cols, mask, k,
                                           with_fallback=not return_ok)
        return (v, i, ok) if return_ok else (v, i)
    if method == "noscatter" and e > 0:
        v, i = windowed_topk_excluded(scores, exclude_csr, u_idxs, k)
    else:
        cols, mask = csr_row_gather(exclude_csr, u_idxs)
        if method == "pallas":
            v, i = pallas_masked_topk_scores(scores, cols, mask, k)
        elif method in ("scatter", "noscatter"):
            v, i = windowed_topk(scatter_fill_rows(scores, cols, mask,
                                                   fill=NEG), k)
        else:
            v, i = topk_excluding(scores, cols, mask, k)
    if return_ok:
        return v, i, torch.ones(scores.shape[0], dtype=torch.bool,
                                device=scores.device)
    return v, i
