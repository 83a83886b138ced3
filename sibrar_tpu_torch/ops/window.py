"""Window maxima and windowed tilings of the score matrix (port of
``sibrar_tpu/ops/pallas_window.py``: ``score_native_wmax``,
``score_windows``, ``window_scores_from``, ``gather_windows``,
``window_topk_phase2``, ``pallas_masked_topk``,
``pallas_masked_topk_scores`` and ``_pad_excl``).

Kernel K2 (`score_wmax`, ``csrc/score_wmax.cu``) writes the [B, C] score
matrix and its window maxima in one pass, so the peel selection never reads
the full matrix to find its windows. Kernel K10 (`score_windows`, the same
source and main loop) writes the same scores as window planes
``sw_t [C / 128, B, 128]``, bit for bit.

The windowed ranking (``topk_method: pallas`` over a precomputed score
matrix, `pallas_masked_topk` over dot products): kernel K9
(`window_scores_from`, ``csrc/window_retile.cu``) or K10 gives the window
planes with their maxima, the top ``k + E`` windows by maximum are
selected, K3 with a window stride (`gather_windows_tiled`) gathers them, and
exclusion is applied by finalist re-ranking (`window_topk_phase2`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from sibrar_tpu_torch.ops import _cuda

WINDOW = 128
BC = 1024  # catalog padding multiple of both paths (JAX bc)
NEG = -1e30


def max_like_jax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x.amax(dim)`` under JAX's max, the rule of every window maximum of
    the port (plain versions and kernels): NaN where any value is NaN, and
    +0.0 where the maximum is a zero and +0.0 is among the values, in any
    order (``lax.max(-0.0, +0.0)`` is +0.0; ``amax`` keeps either zero)."""
    m = x.amax(dim)
    plus_zero = ((x == 0) & ~torch.signbit(x)).any(dim)
    return torch.where(plus_zero & (m == 0), 0.0, m)


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
    return scores, max_like_jax(scores.view(b, c // WINDOW, WINDOW), -1)


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
    u, items = _dot_operands(u, items, "score_wmax")
    scores = torch.empty((b, c), dtype=torch.float32, device=u.device)
    wmax = torch.empty((b, c // WINDOW), dtype=torch.float32, device=u.device)
    _cuda.launch("sibrar_score_wmax", u.data_ptr(), items.data_ptr(), b, c, d,
                 scores.data_ptr(), wmax.data_ptr())
    score_wmax.launches += 1
    return scores, wmax


score_wmax.launches = 0


def _dot_operands(u: torch.Tensor, items: torch.Tensor, name: str
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Contiguous f32 ``u [B, D]`` and ``items [C, D]`` for the score
    kernels, which take any B and D (depths past D read as zeros, as the
    Pallas kernels' zero padding of D to 128 gives)."""
    if u.dtype != torch.float32 or items.dtype != torch.float32:
        raise ValueError(f"{name}: f32 only, got {u.dtype}, {items.dtype}")
    return u.contiguous(), items.contiguous()


# ----------------------------------------------------------------- kernel K10
def score_windows_plain(u: torch.Tensor, items: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K10: ``(sw_t [C/128, B, 128], wmax [B, C/128])`` of
    ``u @ items.T``."""
    return window_scores_from_plain(u @ items.T)


def score_windows(u: torch.Tensor, items: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """K10: the scores ``u @ items.T`` written once as window planes
    ``sw_t [C/128, B, 128]`` plus their maxima ``wmax [B, C/128]``, C a
    multiple of 128 (JAX ``score_windows``; K2's tile and arithmetic with
    another store address, so ``sw_t`` holds K2's scores bit for bit)."""
    b, d = u.shape
    c, di = items.shape
    if d != di or c % WINDOW:
        raise ValueError(f"score_windows: u {tuple(u.shape)} and items "
                         f"{tuple(items.shape)} need equal D and C % 128 == 0")
    if not _cuda.use_kernel(u, items):
        return score_windows_plain(u, items)
    u, items = _dot_operands(u, items, "score_windows")
    sw_t = torch.empty((c // WINDOW, b, WINDOW), dtype=torch.float32,
                       device=u.device)
    wmax = torch.empty((b, c // WINDOW), dtype=torch.float32, device=u.device)
    _cuda.launch("sibrar_score_windows", u.data_ptr(), items.data_ptr(), b, c,
                 d, sw_t.data_ptr(), wmax.data_ptr())
    score_windows.launches += 1
    return sw_t, wmax


score_windows.launches = 0


def pad_catalog(items: torch.Tensor, multiple: int = BC) -> torch.Tensor:
    """``items [C, D]`` with zero rows appended up to a ``multiple`` of
    rows (zero scores; the rankers dead-mask every column past C)."""
    c = items.shape[0]
    cp = -(-c // multiple) * multiple
    return items if cp == c else F.pad(items, (0, 0, 0, cp - c))


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
    return sw.transpose(0, 1).contiguous(), max_like_jax(sw, -1)


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
def gather_windows_tiled_plain(sw_t: torch.Tensor, widx: torch.Tensor,
                               dead: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Plain version of K3 on the tiling: ``out[b, j] = sw_t[widx[b, j], b]``
    as [B, m, 128], -inf where ``dead``."""
    out = sw_t.permute(1, 0, 2).gather(
        1, widx.long()[:, :, None].expand(-1, -1, sw_t.shape[2]))
    return out if dead is None else out.masked_fill(dead, float("-inf"))


def gather_planes(sw_t: torch.Tensor, widx: torch.Tensor,
                  dead: torch.Tensor | None, counted) -> torch.Tensor:
    """K3 with the window stride B * 128: windows ``widx [B, m]`` of each
    user's planes of ``sw_t [NW, B, 128]`` as ``[B, m, 128]``, with ``dead
    [B, m, 128]`` lanes set to -inf on copy (see ``csrc/gather_windows.cu``).
    A launch adds one to ``counted.launches``: the entry point it serves,
    `gather_windows_tiled` or ``peel.gather_windows_rows``."""
    tensors = (sw_t, widx) if dead is None else (sw_t, widx, dead)
    if (sw_t.ndim != 3 or sw_t.shape[2] != WINDOW or widx.ndim != 2
            or widx.shape[0] != sw_t.shape[1]):
        raise ValueError(f"gather_planes: sw_t {tuple(sw_t.shape)} must be "
                         f"[NW, B, 128] and widx {tuple(widx.shape)} [B, m]")
    if not _cuda.use_kernel(*tensors):
        return gather_windows_tiled_plain(sw_t, widx, dead)
    b, m = widx.shape
    if (sw_t.dtype != torch.float32 or widx.dtype != torch.int32
            or not sw_t.is_contiguous() or not widx.is_contiguous()):
        raise ValueError("gather_planes: contiguous f32 sw_t, int32 widx")
    if dead is not None and (dead.dtype != torch.bool
                             or not dead.is_contiguous()
                             or tuple(dead.shape) != (b, m, WINDOW)):
        raise ValueError("gather_planes: dead must be contiguous bool "
                         f"[{b}, {m}, {WINDOW}]")
    out = torch.empty((b, m, WINDOW), dtype=torch.float32, device=sw_t.device)
    _cuda.launch("sibrar_gather_windows", sw_t.data_ptr(), WINDOW,
                 b * WINDOW, widx.data_ptr(), b, m,
                 None if dead is None else dead.data_ptr(), out.data_ptr())
    counted.launches += 1
    return out


def gather_windows_tiled(sw_t: torch.Tensor, widx: torch.Tensor,
                         dead: torch.Tensor | None = None) -> torch.Tensor:
    """`gather_planes` for `window_topk_phase2` (JAX
    ``pallas_window.gather_windows``)."""
    return gather_planes(sw_t, widx, dead, gather_windows_tiled)


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
    cand_v = gather_windows_tiled(sw_t, widx.to(torch.int32).contiguous()
                                  ).reshape(b, m * w)
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


def pallas_masked_topk(u: torch.Tensor, items: torch.Tensor,
                       excl_cols: torch.Tensor | None,
                       excl_mask: torch.Tensor | None, k: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dot-product scores + exclusion + exact top-k (JAX
    ``pallas_masked_topk``): the catalog is padded to a `BC` multiple with
    zero rows, K10 writes the window planes and their maxima, then
    `window_topk_phase2`. JAX also pads B to its user block and D to 128;
    K10 takes any B and D, and its zero-filled depth tail adds the same
    zeros. Returns ``(v, idx int64)``."""
    b, c = u.shape[0], items.shape[0]
    excl_cols, excl_mask = pad_excl(excl_cols, excl_mask, b, u.device)
    sw_t, wmax = score_windows(u, pad_catalog(items))
    return window_topk_phase2(sw_t, wmax, excl_cols, excl_mask, k, c)
