"""Dot-product scores with 128-wide window maxima (port of
``sibrar_tpu/ops/pallas_window.py``: ``score_native_wmax`` and ``_pad_excl``).

Kernel K2 (`score_wmax`, ``csrc/score_wmax.cu``) writes the [B, C] score
matrix and its window maxima in one pass, so the peel selection never reads
the full matrix to find its windows.
"""
from __future__ import annotations

import torch

from sibrar_tpu_torch.ops import _cuda

WINDOW = 128


def score_wmax_plain(u: torch.Tensor, items: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: ``scores = u @ items.T`` [B, C] and
    ``wmax`` [B, C / 128]."""
    scores = u @ items.T
    b, c = scores.shape
    return scores, scores.view(b, c // WINDOW, WINDOW).amax(-1)


def score_wmax(u: torch.Tensor, items: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2: scores and window maxima for f32 ``u [B, D]`` and ``items [C, D]``
    with C a multiple of 128 (pad the catalog upstream)."""
    b, d = u.shape
    c, di = items.shape
    if d != di or c % WINDOW:
        raise ValueError(f"score_wmax: u {tuple(u.shape)} and items "
                         f"{tuple(items.shape)} need equal D and C % 128 == 0")
    if not _cuda.use_kernel(u, items):
        return score_wmax_plain(u, items)
    if u.dtype != torch.float32 or items.dtype != torch.float32:
        raise ValueError(f"score_wmax: f32 only, got {u.dtype}, {items.dtype}")
    u, items = u.contiguous(), items.contiguous()
    scores = torch.empty((b, c), dtype=torch.float32, device=u.device)
    wmax = torch.empty((b, c // WINDOW), dtype=torch.float32, device=u.device)
    _cuda.launch("sibrar_score_wmax", u.data_ptr(), items.data_ptr(), b, c, d,
                 scores.data_ptr(), wmax.data_ptr())
    score_wmax.launches += 1
    return scores, wmax


score_wmax.launches = 0


def pad_excl(excl_cols: torch.Tensor | None, excl_mask: torch.Tensor | None,
             b: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Exclusion lists for a batch of ``b`` rows; ``None`` means none."""
    if excl_cols is None:
        return (torch.zeros((b, 0), dtype=torch.int32, device=device),
                torch.zeros((b, 0), dtype=torch.bool, device=device))
    return excl_cols, excl_mask
