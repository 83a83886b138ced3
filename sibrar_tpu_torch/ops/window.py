"""Window maxima and windowed tilings of the score matrix (port of
``sibrar_tpu/ops/pallas_window.py``: ``score_native_wmax``,
``window_scores_from``, ``gather_windows``, ``window_topk_phase2``,
``pallas_masked_topk_scores`` and ``_pad_excl``).

Kernel K2 (`score_wmax`, ``csrc/score_wmax.cu``) writes the [B, C] score
matrix and its window maxima in one pass, so the peel selection never reads
the full matrix to find its windows.

The ``topk_method: pallas`` path over a precomputed score matrix: kernel K9
(`window_scores_from`, ``csrc/window_retile.cu``) retiles the scores into
window planes ``sw_t [C / 128, B, 128]`` with their maxima, the top
``k + E`` windows by maximum are selected, K3 with a window stride
(`gather_windows_tiled`) gathers them, and exclusion is applied by finalist
re-ranking (`window_topk_phase2`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from sibrar_tpu_torch.ops import _cuda

WINDOW = 128
BC = 1024  # catalog padding multiple of both paths (JAX bc)
NEG = -1e30


def _topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along dim 1, ties to the lower index (``lax.top_k``'s rule)."""
    v, i = torch.sort(x, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


# ------------------------------------------------------------------ kernel K2
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


# ------------------------------------------------------------------ kernel K9
def window_scores_from_plain(scores: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K9: ``(sw_t [C/128, B, 128], wmax [B, C/128])``."""
    b, c = scores.shape
    sw = scores.view(b, c // WINDOW, WINDOW)
    return sw.transpose(0, 1).contiguous(), sw.amax(-1)


def window_scores_from(scores: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """K9: the window planes of ``scores [B, C]`` (C a multiple of 128) and
    their maxima in one pass (see ``csrc/window_retile.cu``)."""
    if scores.ndim != 2 or scores.shape[1] % WINDOW:
        raise ValueError(f"window_scores_from: scores must be [B, n*128], "
                         f"got {tuple(scores.shape)}")
    if not _cuda.use_kernel(scores):
        return window_scores_from_plain(scores)
    if scores.dtype != torch.float32 or not scores.is_contiguous():
        raise ValueError("window_scores_from: contiguous f32 scores only")
    b, c = scores.shape
    nw = c // WINDOW
    sw_t = torch.empty((nw, b, WINDOW), dtype=torch.float32,
                       device=scores.device)
    wmax = torch.empty((b, nw), dtype=torch.float32, device=scores.device)
    _cuda.launch("sibrar_window_retile", scores.data_ptr(), b, nw,
                 sw_t.data_ptr(), wmax.data_ptr())
    window_scores_from.launches += 1
    return sw_t, wmax


window_scores_from.launches = 0


# ------------------------------------------------------ kernel K3, tiled
def gather_windows_tiled_plain(sw_t: torch.Tensor, widx: torch.Tensor
                               ) -> torch.Tensor:
    """Plain version of K3 on the tiling:
    ``cand[b, 128 j : +128] = sw_t[widx[b, j], b, :]``, as [B, m * 128]."""
    nw, b, w = sw_t.shape
    m = widx.shape[1]
    return sw_t.permute(1, 0, 2).gather(
        1, widx.long()[:, :, None].expand(-1, -1, w)).reshape(b, m * w)


def gather_windows_tiled(sw_t: torch.Tensor, widx: torch.Tensor
                         ) -> torch.Tensor:
    """K3 with the window stride B * 128: windows ``widx [B, m]`` of each
    user's planes of ``sw_t [NW, B, 128]`` as ``[B, m * 128]`` (JAX
    ``pallas_window.gather_windows``; see ``csrc/gather_windows.cu``)."""
    if (sw_t.ndim != 3 or sw_t.shape[2] != WINDOW or widx.ndim != 2
            or widx.shape[0] != sw_t.shape[1]):
        raise ValueError(f"gather_windows_tiled: sw_t {tuple(sw_t.shape)} "
                         f"must be [NW, B, 128] and widx {tuple(widx.shape)} "
                         "[B, m]")
    if not _cuda.use_kernel(sw_t, widx):
        return gather_windows_tiled_plain(sw_t, widx)
    if (sw_t.dtype != torch.float32 or widx.dtype != torch.int32
            or not sw_t.is_contiguous() or not widx.is_contiguous()):
        raise ValueError("gather_windows_tiled: contiguous f32 sw_t, int32 "
                         "widx")
    b, m = widx.shape
    out = torch.empty((b, m * WINDOW), dtype=torch.float32,
                      device=sw_t.device)
    _cuda.launch("sibrar_gather_windows", sw_t.data_ptr(), WINDOW,
                 b * WINDOW, widx.data_ptr(), b, m, None, out.data_ptr())
    gather_windows_tiled.launches += 1
    return out


gather_windows_tiled.launches = 0


# ------------------------------------------------------------ orchestration
def window_topk_phase2(sw_t: torch.Tensor, wmax: torch.Tensor,
                       excl_cols: torch.Tensor, excl_mask: torch.Tensor,
                       k: int, c_real: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-``min(k, c_real)`` from window planes with per-user column
    exclusion by finalist re-ranking (JAX ``window_topk_phase2``).

    The top ``k + E`` windows by raw maximum (one more when the catalog is
    padded) cover the post-exclusion top-k; their pad lanes are set to
    -1e30 before the finalist top-``k + E`` (+127 if padded), whose excluded
    and pad ids are then set to -1e30 and the final k re-ranked. Plain
    index gathers replace JAX's one-hot einsums (MXU workarounds). Returns
    ``(v, idx int64)``."""
    nw, b, w = sw_t.shape
    e = excl_cols.shape[1]
    dev = sw_t.device
    padded = nw * w > c_real
    if padded:  # fully padded tail windows can't win
        wmax = torch.where(torch.arange(nw, device=dev) * w < c_real,
                           wmax, NEG)
    m = min(k + e + int(padded), nw)
    widx = _topk_stable(wmax, m)[1]
    cand_v = gather_windows_tiled(sw_t, widx.to(torch.int32).contiguous())
    lane = torch.arange(w, device=dev)
    if padded:  # pad lanes must not take finalist slots
        gid = (widx[:, :, None] * w + lane).reshape(b, m * w)
        cand_v = torch.where(gid >= c_real, NEG, cand_v)
    k2 = min(k + e + (w - 1 if padded else 0), m * w)
    v2, p2 = _topk_stable(cand_v, k2)  # finalists
    cidx = widx.gather(1, p2 // w) * w + p2 % w  # [B, k2] catalog ids
    bad = cidx >= c_real
    if e:
        sent = torch.where(excl_mask, excl_cols.long(), -1)  # -1: no match
        bad |= (cidx[:, None, :] == sent[:, :, None]).any(dim=1)
    v, p3 = _topk_stable(torch.where(bad, NEG, v2), min(k, c_real))
    return v, cidx.gather(1, p3)


def pallas_masked_topk_scores(scores: torch.Tensor,
                              excl_cols: torch.Tensor | None,
                              excl_mask: torch.Tensor | None, k: int
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exclusion + exact top-k over a precomputed [B, C] score matrix (JAX
    ``pallas_masked_topk_scores``): the catalog is padded to a `BC`
    multiple with -1e30, K9 retiles it, then `window_topk_phase2`."""
    b, c = scores.shape
    cp = -(-c // BC) * BC
    if cp != c:
        scores = F.pad(scores, (0, cp - c), value=NEG)
    excl_cols, excl_mask = pad_excl(excl_cols, excl_mask, b, scores.device)
    sw_t, wmax = window_scores_from(scores.contiguous())
    return window_topk_phase2(sw_t, wmax, excl_cols, excl_mask, k, c)
