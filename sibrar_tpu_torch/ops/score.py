"""Catalog-major scores with window maxima, and the exact top-k over them
(port of ``sibrar_tpu/ops/pallas_score.py``).

Kernel K12 (`fused_score_wmax`, ``csrc/fused_score_wmax.cu``) writes
``scores_t [C, B] = items @ u.T`` and the maxima of every ``window``
consecutive catalog rows in one pass. `fused_masked_topk` then selects the
top ``k + L`` windows by maximum (an excluded item displaces at most its own
window), gathers their candidates, masks the excluded and padded ones and
re-ranks exactly.
"""
from __future__ import annotations

import torch

from sibrar_tpu_torch.ops import _cuda
from sibrar_tpu_torch.ops.window import (
    NEG,
    _dot_operands,
    _topk_stable,
    max_like_jax,
    pad_catalog,
)

BC_SCORE = 512  # catalog block of the JAX kernel: C and the window divide it


def _check_window(window: int) -> None:
    if window <= 0 or window % 8 or BC_SCORE % window:
        raise ValueError(f"window={window}: must be a multiple of 8 that "
                         f"divides {BC_SCORE}")


# ----------------------------------------------------------------- kernel K12
def fused_score_wmax_plain(u: torch.Tensor, items: torch.Tensor,
                           window: int = 64
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K12: ``(scores_t [C, B], wmax_t [C/window, B])``."""
    scores_t = items @ u.T
    c, b = scores_t.shape
    return scores_t, max_like_jax(scores_t.view(c // window, window, b), 1)


def fused_score_wmax(u: torch.Tensor, items: torch.Tensor, *,
                     window: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """K12: catalog-major scores ``scores_t [C, B] = items @ u.T`` and the
    maxima ``wmax_t [C/window, B]`` of each ``window`` consecutive catalog
    rows, for f32 ``u [B, D]`` and ``items [C, D]`` with C a multiple of 512
    and ``window`` a multiple of 8 dividing 512 (JAX ``fused_score_wmax``;
    its B and D alignments are not needed). The scores are K2's, bit for
    bit, transposed."""
    _check_window(window)
    b, d = u.shape
    c, di = items.shape
    if d != di or c % BC_SCORE:
        raise ValueError(f"fused_score_wmax: u {tuple(u.shape)} and items "
                         f"{tuple(items.shape)} need equal D and C % "
                         f"{BC_SCORE} == 0")
    if not _cuda.use_kernel(u, items):
        return fused_score_wmax_plain(u, items, window)
    u, items = _dot_operands(u, items, "fused_score_wmax")
    scores_t = torch.empty((c, b), dtype=torch.float32, device=u.device)
    wmax_t = torch.empty((c // window, b), dtype=torch.float32,
                         device=u.device)
    _cuda.launch("sibrar_fused_score_wmax", u.data_ptr(), items.data_ptr(), b,
                 c, d, window, scores_t.data_ptr(), wmax_t.data_ptr())
    fused_score_wmax.launches += 1
    return scores_t, wmax_t


fused_score_wmax.launches = 0


# ------------------------------------------------------------ orchestration
def fused_masked_topk(u: torch.Tensor, items: torch.Tensor,
                      excl_cols: torch.Tensor, k: int, *, window: int = 64
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dot-product scores with exclusion, then the exact top-``min(k, C)``
    (JAX ``fused_masked_topk``). ``excl_cols [B, L]`` are the excluded
    catalog columns, padded with any sentinel >= C.

    The catalog is padded to a multiple of 512 with zero rows; K12 gives the
    scores and window maxima; the top ``k + L`` windows (one more when the
    catalog is padded: the partial window's zero-score pads can displace a
    real window when every score is negative) by maximum are gathered, the
    padded and excluded candidates set to -1e30, and the candidates
    re-ranked. Ties go to the earlier candidate, as in JAX. Returns
    ``(v, idx int64)``."""
    b, c = u.shape[0], items.shape[0]
    n_excl = excl_cols.shape[1]
    scores_t, wmax_t = fused_score_wmax(u, pad_catalog(items, BC_SCORE),
                                        window=window)
    n_win = wmax_t.shape[0]
    padded = n_win * window > c
    wmax = wmax_t.T
    if padded:  # fully padded tail windows can't win
        win_ok = torch.arange(n_win, device=u.device) * window < c
        wmax = torch.where(win_ok, wmax, NEG)
    m = min(k + n_excl + int(padded), n_win)
    widx = _topk_stable(wmax, m)[1]  # [B, m]
    # candidates [B, m * window] off the catalog-major scores
    users = torch.arange(b, device=u.device)[:, None]
    cand_v = scores_t.view(n_win, window, b)[widx, :, users].reshape(b, -1)
    cand_c = (widx[:, :, None] * window
              + torch.arange(window, device=u.device)).reshape(b, -1)
    hit = cand_c >= c  # padded tail
    if n_excl:  # membership through the sorted exclusion row
        srt = excl_cols.long().sort(dim=1).values.contiguous()
        pos = torch.searchsorted(srt, cand_c).clamp(max=n_excl - 1)
        hit |= srt.gather(1, pos) == cand_c
    v, p = _topk_stable(torch.where(hit, NEG, cand_v), min(k, c))
    return v, cand_c.gather(1, p)
