"""Exact top-k with per-user exclusion by value peeling (port of
``sibrar_tpu/ops/pallas_peel.py``).

Pipeline (`_peel_select`) over scores and their 128-wide window maxima, in
one of two layouts: a [B, C] score matrix (from kernel K2, ``ops/window.py``,
on the dot path, or K15 with bf16 operands; the maxima from kernel K8,
`window_max`, on the scores path), or the window planes ``sw_t [C / 128,
B, 128]`` of kernel K10 (`peel_masked_topk`). Only the window gather
differs: K3 off the rows, or K3 with the window stride B * 128 off the
planes (`gather_windows_rows`).

1. on the corrected-wmax path, recompute the maxima of the windows that hold
   a user's excluded items; otherwise select ``k + E`` windows (margin path);
2. select the top-``m`` windows per user by maximum (covering theorem);
3. gather them with the excluded and padded lanes set to -inf (K3);
4. peel the top-``t`` distinct values of every window (K4);
5. merge the ``m * t`` peeled values with one top-k;
6. in one launch of kernel K11 (`recover_winners`), recover each winner's
   catalog index from its window row and flag each row
   ``ok = complete & unique & all_live``. The entry points redo the rows
   that are not ok with the dense path (``ops/topk.py``); only those rows,
   not the whole batch as in JAX. JAX's two spellings of the recovery (its
   ``_RECOVER_KERNEL`` switch) give the same bits.

Both top-k selections are stable sorts, so ties go to the lower index as in
``lax.top_k`` and the ok flags match the JAX package on identical scores.
Window selection is always exact: JAX's ``approx_max_k`` branch is TPU-only,
and at the serving catalog (784 windows) JAX takes the exact branch as well.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from sibrar_tpu_torch.ops import _cuda
from sibrar_tpu_torch.ops.gemm_probe import score_bf16_wmax
from sibrar_tpu_torch.ops.topk import topk_excluding
from sibrar_tpu_torch.ops.window import (
    BC,
    NEG,
    WINDOW,
    _topk_stable,
    gather_planes,
    max_like_jax,
    pad_catalog,
    pad_excl,
    score_wmax,
    score_windows,
)
from sibrar_tpu_torch.utils import trace

PEELED = float("-inf")  # below any live score, the -1e30 mask included

# JAX's gates for the corrected-wmax path: at most this many excluded items
# per user, and score rows of at most this many bytes.
_CORR_MAX_E = 512
_CORR_MAX_ROW_BYTES = 1 << 20
PEEL_T = 8  # peel depth before the adaptive deepening (JAX default t)


def _use_corrected_wmax(c_real: int, e: int) -> bool:
    """The JAX package's cost gate, kept identical so both packages select
    the same windows: correct the maxima when E > C / 1024."""
    return (0 < e <= _CORR_MAX_E and c_real * 4 <= _CORR_MAX_ROW_BYTES
            and e > c_real // 1024)


def _round_m(m: int, nw: int) -> int:
    """Selected-window count rounded up to a multiple of 8 while 2m <= nw
    (JAX ``_round_m``); the extra windows are the next-best ones."""
    r = -(-m // 8) * 8
    return r if 2 * r <= nw else min(m, nw)


def peel_viable(c: int, k: int, e: int) -> bool:
    """Peeling is used when the selected windows are a small share of the
    catalog. The JAX predicate also bounds Mosaic's VMEM blocks; those gates
    have no counterpart here."""
    nw = -(-c // WINDOW)
    corrected = e > 0 and _use_corrected_wmax(c, e)
    margin = 1 if (e == 0 or corrected) else e + 1
    m = _round_m(k + margin, nw)
    return m * PEEL_T >= k and 2 * m <= nw


# ------------------------------------------------------------------ kernel K8
def window_max_plain(scores: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: the [B, C / 128] maxima of the 128-wide windows
    of ``scores [B, C]``."""
    b, c = scores.shape
    return max_like_jax(scores.view(b, c // WINDOW, WINDOW), -1)


def window_max(scores: torch.Tensor) -> torch.Tensor:
    """K8: window maxima of ``scores [B, C]``, C a multiple of 128 (JAX
    ``window_max``; see ``csrc/window_max.cu``). A window with a NaN lane
    has a NaN maximum, as from JAX's max (`max_like_jax`)."""
    if scores.ndim != 2 or scores.shape[1] % WINDOW:
        raise ValueError(f"window_max: scores must be [B, n*128], got "
                         f"{tuple(scores.shape)}")
    if not _cuda.use_kernel(scores):
        return window_max_plain(scores)
    if scores.dtype != torch.float32 or not scores.is_contiguous():
        raise ValueError("window_max: contiguous f32 scores only")
    b, c = scores.shape
    out = torch.empty((b, c // WINDOW), dtype=torch.float32,
                      device=scores.device)
    _cuda.launch("sibrar_window_max", scores.data_ptr(), b * (c // WINDOW),
                 out.data_ptr())
    window_max.launches += 1
    return out


window_max.launches = 0


# ------------------------------------------------------------------ kernel K3
def gather_windows_plain(src: torch.Tensor, idx: torch.Tensor,
                         dead: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K3: ``out[b, j] = src[b, 128 idx[b, j] : +128]``,
    -inf where ``dead``."""
    b = src.shape[0]
    out = src.reshape(b, -1, WINDOW).gather(
        1, idx.long()[:, :, None].expand(-1, -1, WINDOW))
    return out if dead is None else out.masked_fill(dead, PEELED)


def gather_windows(src: torch.Tensor, idx: torch.Tensor,
                   dead: torch.Tensor | None = None) -> torch.Tensor:
    """K3: windows ``idx [B, m]`` of the rows of ``src [B, n * 128]`` as
    ``[B, m, 128]``, with ``dead [B, m, 128]`` lanes set to -inf on copy
    (see ``csrc/gather_windows.cu``)."""
    tensors = (src, idx) if dead is None else (src, idx, dead)
    if src.ndim != 2 or src.shape[1] % WINDOW or idx.ndim != 2:
        raise ValueError(f"gather_windows: src {tuple(src.shape)} must be "
                         f"[B, n*128] and idx {tuple(idx.shape)} [B, m]")
    if not _cuda.use_kernel(*tensors):
        return gather_windows_plain(src, idx, dead)
    b, m = idx.shape
    if (src.dtype != torch.float32 or idx.dtype != torch.int32
            or not src.is_contiguous() or not idx.is_contiguous()):
        raise ValueError("gather_windows: contiguous f32 src, int32 idx")
    if dead is not None and (dead.dtype != torch.bool
                             or not dead.is_contiguous()
                             or tuple(dead.shape) != (b, m, WINDOW)):
        raise ValueError("gather_windows: dead must be contiguous bool "
                         f"[{b}, {m}, {WINDOW}]")
    out = torch.empty((b, m, WINDOW), dtype=torch.float32, device=src.device)
    _cuda.launch("sibrar_gather_windows", src.data_ptr(), src.stride(0),
                 WINDOW, idx.data_ptr(), b, m,
                 None if dead is None else dead.data_ptr(), out.data_ptr())
    gather_windows.launches += 1
    return out


gather_windows.launches = 0


def gather_score_windows(scores: torch.Tensor, widx: torch.Tensor,
                         dead: torch.Tensor | None = None) -> torch.Tensor:
    """Windows ``widx [B, m]`` straight off the [B, C] score matrix (JAX
    ``gather_score_windows``, whose chunked spellings are VMEM workarounds):
    K3 on the scores."""
    return gather_windows(scores, widx, dead)


def gather_subwindows(g: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """``out[b, s] = g[b, slots[b, s]]`` from the gathered ``g [B, m, 128]``
    (JAX ``gather_subwindows``): K3 on g viewed as [B, m * 128]. The peel
    does not call it: K11 reads the winners' rows itself."""
    b, m, w = g.shape
    out = gather_windows(g.reshape(b, m * w), slots)
    if g.is_cuda:
        gather_subwindows.launches += 1
    return out


gather_subwindows.launches = 0  # its K3 launches, also in gather_windows'


# ------------------------------------------------------------------ kernel K4
def peel_values_plain(x: torch.Tensor, t: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4: ``(vals [R, t], last [R])``, the top-t distinct
    values of each row of ``x [R, 128]``, descending, -inf padded."""
    cur, cols = x, []
    for r in range(t):
        v = cur.amax(dim=1, keepdim=True)
        cols.append(v)
        if r + 1 < t:
            cur = torch.where(cur == v, PEELED, cur)  # clear ALL tied lanes
    vals = torch.cat(cols, dim=1)
    return vals, vals[:, t - 1]


def peel_values(x: torch.Tensor, t: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K4 over ``x [R, 128]`` (see ``csrc/peel_values.cu``); JAX
    ``peel_values``, which returns only ``vals``."""
    if x.ndim != 2 or x.shape[1] != WINDOW:
        raise ValueError(f"peel_values: x must be [R, {WINDOW}], "
                         f"got {tuple(x.shape)}")
    t = min(t, WINDOW)
    if not _cuda.use_kernel(x):
        return peel_values_plain(x, t)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("peel_values: contiguous f32 only")
    r = x.shape[0]
    vals = torch.empty((r, t), dtype=torch.float32, device=x.device)
    last = torch.empty((r,), dtype=torch.float32, device=x.device)
    _cuda.launch("sibrar_peel_values", x.data_ptr(), r, t, vals.data_ptr(),
                 last.data_ptr())
    peel_values.launches += 1
    return vals, last


peel_values.launches = 0


def peel_values_grouped(g: torch.Tensor, t: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4 over ``g [B, m, 128]``: ``(vals [B, m * t], last [B, m])`` where
    ``vals[b, s * t + r]`` is window s's round-r value (JAX
    ``peel_values_grouped``)."""
    b, m, w = g.shape
    vals, last = peel_values(g.reshape(b * m, w), t)
    return vals.reshape(b, m * vals.shape[1]), last.reshape(b, m)


# ------------------------------------------------------ kernel K3, planes
def gather_windows_rows(sw_t: torch.Tensor, widx: torch.Tensor,
                        dead: torch.Tensor | None = None) -> torch.Tensor:
    """Windows ``widx [B, m]`` of each user's planes of ``sw_t [NW, B, 128]``
    as ``[B, m, 128]``, ``dead`` lanes -inf (JAX ``gather_windows_rows``):
    the K3 launch of `window.gather_windows_tiled`, counted here; its plain
    version is ``window.gather_windows_tiled_plain``."""
    return gather_planes(sw_t, widx, dead, gather_windows_rows)


gather_windows_rows.launches = 0


# ----------------------------------------------------------------- kernel K11
def recover_winners_plain(g: torch.Tensor, widx: torch.Tensor,
                          slots: torch.Tensor, v: torch.Tensor
                          ) -> tuple[torch.Tensor, ...]:
    """JAX ``recover_winners``' three outputs: for each winner ``(b, s)``
    with value ``v [B, kk]`` in window slot ``slots [B, kk]`` of the
    gathered ``g [B, m, 128]``, the first lane of ``g[b, slots[b, s]]``
    equal to it (128 if none), the count of equal lanes, and its catalog
    window ``widx[b, slots[b, s]]``; int32 [B, kk]. The first half of K11's
    plain version (`recover_plain`)."""
    rows = g.gather(1, slots.long()[:, :, None].expand(-1, -1, g.shape[2]))
    hit = rows == v[:, :, None]
    lane_iota = torch.arange(g.shape[2], device=g.device)
    lane = torch.where(hit, lane_iota, g.shape[2]).amin(dim=-1)
    return (lane.to(torch.int32), hit.sum(dim=-1, dtype=torch.int32),
            widx.gather(1, slots.long()).to(torch.int32))


def recover_plain(g: torch.Tensor, widx: torch.Tensor, p: torch.Tensor,
                  t: int, v: torch.Tensor, last: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K11: `recover_winners_plain` on the winners' window
    slots ``p // t``, then the tail of JAX's ``_peel_select``: the catalog
    ids and the row flag ``ok = complete & unique & all_live``."""
    lane, n_hit, wsel = recover_winners_plain(g, widx, p // t, v)
    idx = wsel.long() * WINDOW + lane.long().clamp(max=WINDOW - 1)
    # exactness: no window's t-th value beats the k-th winner (complete),
    # every winner matched one lane (unique), no -inf winner (all_live)
    complete = (last <= v[:, -1:]).all(dim=1)
    unique = (n_hit == 1).all(dim=1)
    all_live = (v > PEELED).all(dim=1)
    return idx, complete & unique & all_live


_K11_DTYPES = (torch.float32, torch.float32, torch.float32, torch.int32,
               torch.int64)  # g, v, last, widx, p


def recover_winners(g: torch.Tensor, widx: torch.Tensor, p: torch.Tensor,
                    t: int, v: torch.Tensor, last: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """K11, the end of every peel selection (see
    ``csrc/recover_winners.cu``). For the merge's winners ``v [B, kk]`` at
    positions ``p [B, kk]`` (int64) of the ``m * t`` peeled values of the
    gathered windows ``g [B, m, 128]``, whose catalog windows are
    ``widx [B, m]`` and whose deepest peeled values are ``last [B, m]``:
    ``(idx [B, kk] int64, ok [B] bool)``, each winner's catalog id and each
    row's exactness flag (`recover_plain`). ``p`` and ``v`` may be row
    slices (unit stride along a row), as the merge's top-k gives them."""
    b, m, w = g.shape
    if (w != WINDOW or widx.shape != (b, m) or last.shape != (b, m)
            or v.ndim != 2 or v.shape[0] != b or not v.shape[1]
            or p.shape != v.shape):
        raise ValueError(f"recover_winners: g {tuple(g.shape)} must be "
                         f"[B, m, 128], widx {tuple(widx.shape)} and last "
                         f"{tuple(last.shape)} [B, m], p {tuple(p.shape)} "
                         f"and v {tuple(v.shape)} [B, kk], kk >= 1")
    if not _cuda.use_kernel(g, widx, p, v, last):
        return recover_plain(g, widx, p, t, v, last)
    if (g.dtype, v.dtype, last.dtype, widx.dtype, p.dtype) != _K11_DTYPES:
        raise ValueError("recover_winners: f32 g, v and last, int32 widx, "
                         "int64 p")
    if (not g.is_contiguous() or not widx.is_contiguous()
            or not last.is_contiguous() or p.stride(1) != 1
            or v.stride(1) != 1):
        raise ValueError("recover_winners: contiguous g, widx and last; p "
                         "and v with unit stride along a row")
    kk = v.shape[1]
    n = b * kk
    # one allocation: idx, then ok in the bytes after it
    out = torch.empty(n + (b + 7) // 8, dtype=torch.int64, device=g.device)
    ptr = out.data_ptr()
    _cuda.launch("sibrar_recover_winners", g.data_ptr(), widx.data_ptr(),
                 p.data_ptr(), p.stride(0), v.data_ptr(), v.stride(0),
                 last.data_ptr(), b, m, kk, t, ptr, ptr + 8 * n)
    recover_winners.launches += 1
    return (out.as_strided((b, kk), (kk, 1)),
            out.view(torch.bool).as_strided((b,), (1,), 8 * n))


recover_winners.launches = 0


# ------------------------------------------------------------ orchestration
def _flat_mask(b: int, width: int, pos: torch.Tensor, hit: torch.Tensor,
               device) -> torch.Tensor:
    """Bool [b, width] with True at ``pos[i, j]`` of row i where
    ``hit[i, j]``; misses land in one spare trailing slot that is cut off."""
    base = torch.arange(b, device=device)[:, None] * width
    flat = torch.where(hit, base + pos, b * width).reshape(-1)
    out = torch.zeros(b * width + 1, dtype=torch.bool, device=device)
    with trace.host_wait("peel.flat_mask"):  # True is copied first
        out[flat] = True
    return out[:-1].view(b, width)


def _corrected_wmax(gather_fn, wmax: torch.Tensor, excl_cols: torch.Tensor,
                    excl_mask: torch.Tensor) -> torch.Tensor:
    """Exact post-exclusion maxima of the windows holding excluded items
    (JAX ``_peel_select`` corrected branch, without its [B, E, NW]
    one-hot broadcasts): gather each window once, with every excluded lane of
    that window dead, re-max, and splice the result into ``wmax``."""
    b, e = excl_cols.shape
    nw = wmax.shape[1]
    excl_w = torch.where(excl_mask, excl_cols // WINDOW, nw).to(torch.int32)
    key = excl_w.sort(dim=1).values.contiguous()  # ascending, pads (nw) last
    first = torch.searchsorted(key, excl_w.contiguous())  # window's 1st slot
    dead = _flat_mask(b, e * WINDOW, first * WINDOW + excl_cols % WINDOW,
                      excl_mask, wmax.device).view(b, e, WINDOW)
    ge = gather_fn(key.clamp(max=nw - 1), dead)
    corr = max_like_jax(ge, -1)  # [B, E]
    key_first = torch.searchsorted(key, key)
    n_same = torch.searchsorted(key, key, right=True) - key_first
    # JAX takes the max over every slot with -1e30 for slots of other
    # windows, so a fully excluded window reads -1e30 unless it fills all E
    corr = torch.where(n_same < e, corr.clamp(min=NEG), corr)
    is_first = (key < nw) & (key_first == torch.arange(e, device=key.device))
    target = torch.where(is_first, key, nw).long()
    spliced = torch.cat([wmax, wmax.new_zeros(b, 1)], dim=1)
    spliced.scatter_(1, target, corr)  # misses write the spare column
    return spliced[:, :nw]


def _dead_lanes(widx: torch.Tensor, excl_cols: torch.Tensor,
                excl_mask: torch.Tensor, c_real: int, padded: bool
                ) -> torch.Tensor | None:
    """[B, m, 128] lanes of the selected (ascending) windows that must not
    peel: the user's excluded items and, if the catalog is padded, the pad
    items (zero scores) of the partial window."""
    b, m = widx.shape
    dead = None
    if excl_cols.shape[1]:
        excl_w = (excl_cols // WINDOW).to(torch.int32).contiguous()
        slot = torch.searchsorted(widx, excl_w).clamp(max=m - 1)
        hit = excl_mask & (widx.gather(1, slot) == excl_w)
        dead = _flat_mask(b, m * WINDOW, slot * WINDOW + excl_cols % WINDOW,
                          hit, widx.device).view(b, m, WINDOW)
    if padded:
        gid = (widx.long()[:, :, None] * WINDOW
               + torch.arange(WINDOW, device=widx.device))
        pad_dead = gid >= c_real
        dead = pad_dead if dead is None else dead | pad_dead
    return dead


def _peel_select(gather_fn, wmax: torch.Tensor, excl_cols: torch.Tensor,
                 excl_mask: torch.Tensor, k: int, c_real: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The peel pipeline shared by both score layouts (JAX ``_peel_select``
    with ``with_fallback=False``). ``gather_fn(widx [B, m], dead)`` returns
    the windows ``widx`` of each user's scores as [B, m, 128] with the
    ``dead`` lanes (or None) set to -inf; ``wmax [B, NW]`` are their maxima;
    columns >= ``c_real`` are padding.

    Returns ``(v [B, k'], idx [B, k'] int64, ok [B] bool)`` with
    ``k' = min(k, c_real)``; rows with ``ok`` False need the dense redo."""
    b, nw = wmax.shape
    e = excl_cols.shape[1]
    dev = wmax.device
    padded = nw * WINDOW > c_real
    if padded:  # fully padded tail windows can't win
        win_ok = torch.arange(nw, device=dev) * WINDOW < c_real
        wmax = torch.where(win_ok, wmax, NEG)
    if _use_corrected_wmax(c_real, e):
        wmax = _corrected_wmax(gather_fn, wmax, excl_cols, excl_mask)
        m = _round_m(k + int(padded), nw)  # exact maxima: no margin
    else:
        m = _round_m(k + e + int(padded), nw)
    # adaptive depth toward t >= k where few live windows hold the top-k
    kk = min(k, c_real)
    nw_real = -(-c_real // WINDOW)
    t = min(max(PEEL_T, min(-(-3 * kk) // nw_real, kk)), WINDOW)

    # ascending window order: every later stage is invariant to it
    widx = _topk_stable(wmax, m)[1].sort(dim=1).values.to(torch.int32)
    g = gather_fn(widx, _dead_lanes(widx, excl_cols, excl_mask, c_real,
                                    padded))  # [B, m, 128]
    vals_flat, last = peel_values_grouped(g, t)
    v, p = _topk_stable(vals_flat, kk)  # merge over m*t << m*128 values

    # winner-only index recovery from the dead-masked windows and the row
    # flags, in one launch
    idx, ok = recover_winners(g, widx, p, t, v, last)
    return v, idx, ok


def peel_topk_from_scores(scores: torch.Tensor, wmax: torch.Tensor,
                          excl_cols: torch.Tensor, excl_mask: torch.Tensor,
                          k: int, c_real: int
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact top-k with exclusion off a [B, C] score matrix (C a multiple of
    128, columns >= ``c_real`` padding) and its window maxima ``wmax``
    (JAX ``peel_topk_from_scores``): `_peel_select` with K3 gathering the
    windows off the rows. Returns ``(v, idx, ok)``."""
    return _peel_select(lambda widx, dead: gather_score_windows(scores, widx,
                                                                dead),
                        wmax, excl_cols, excl_mask, k, c_real)


def peel_topk_windows(sw_t: torch.Tensor, wmax: torch.Tensor,
                      excl_cols: torch.Tensor, excl_mask: torch.Tensor,
                      k: int, c_real: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact top-k with exclusion off the window planes ``sw_t [NW, B, 128]``
    (columns >= ``c_real`` padding) and their maxima ``wmax`` (JAX
    ``peel_topk_windows``): `_peel_select` with `gather_windows_rows`
    gathering the windows off the planes. Returns ``(v, idx, ok)``."""
    return _peel_select(lambda widx, dead: gather_windows_rows(sw_t, widx,
                                                               dead),
                        wmax, excl_cols, excl_mask, k, c_real)


def peel_masked_topk(u: torch.Tensor, items: torch.Tensor,
                     excl_cols: torch.Tensor | None,
                     excl_mask: torch.Tensor | None, k: int, *,
                     with_fallback: bool = True
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dot-product scores + exclusion + exact top-k through the window
    planes (JAX ``peel_masked_topk``): the catalog is padded to a `BC`
    multiple with zero rows, K10 writes the planes and their maxima, then
    `peel_topk_windows`. JAX also pads B to its user block and D to 128; K10
    takes any B and D, and its zero-filled depth tail adds the same zeros.

    Returns ``(v, idx, ok)``. With ``with_fallback`` the rows whose ``ok``
    is False are redone densely from their planes before returning, as in
    `peel_masked_topk_dot`."""
    b, c = u.shape[0], items.shape[0]
    excl_cols, excl_mask = pad_excl(excl_cols, excl_mask, b, u.device)
    sw_t, wmax = score_windows(u, pad_catalog(items))
    v, idx, ok = peel_topk_windows(sw_t, wmax, excl_cols, excl_mask, k, c)
    if with_fallback:
        _redo(lambda rows: sw_t[:, rows].transpose(0, 1).reshape(
            rows.shape[0], -1), excl_cols, excl_mask, c, v, idx, ok)
    return v, idx, ok


def peel_masked_topk_dot(u: torch.Tensor, items: torch.Tensor,
                         excl_cols: torch.Tensor | None,
                         excl_mask: torch.Tensor | None, k: int, *,
                         c_real: int | None = None,
                         with_fallback: bool = True,
                         score_dtype: str | None = None,
                         return_redone: bool = False
                         ) -> tuple[torch.Tensor, ...]:
    """Dot-product scores + exclusion + exact top-k: K2 writes the scores and
    their window maxima, then the peel selects (JAX
    ``peel_masked_topk_dot``). With ``score_dtype="bfloat16"`` K15 writes
    them instead, from the f32 operands rounded to bf16 (JAX's kernel with
    bf16 operands), and the redo ranks the same K15 scores.

    ``items`` is either the live catalog (padded here to a `BC` multiple
    with zero rows) or already padded once by the caller, with ``c_real``
    the live count. Returns ``(v, idx, ok)``. With ``with_fallback`` the
    rows whose ``ok`` is False are redone densely (``ops/topk.py``) before
    returning, so ``v``/``idx`` are exact for every row and ``ok`` tells
    which rows took the redo; ``return_redone`` adds their number, taken
    from the redo's own read of ``ok``: ``(v, idx, ok, n_redone)``."""
    if score_dtype not in (None, "float32", "bfloat16"):
        raise ValueError(f"unsupported score_dtype {score_dtype!r} (use "
                         f"'float32' or 'bfloat16')")
    b = u.shape[0]
    c = items.shape[0]
    if c_real is None:
        c_real = c
    elif not (c % BC == 0 and c_real <= c < c_real + BC):
        raise ValueError(f"c_real={c_real}: items must be pre-padded to the "
                         f"next {BC} multiple (got {c} rows)")
    excl_cols, excl_mask = pad_excl(excl_cols, excl_mask, b, u.device)
    score = score_bf16_wmax if score_dtype == "bfloat16" else score_wmax
    scores, wmax = score(u, pad_catalog(items))
    v, idx, ok = peel_topk_from_scores(scores, wmax, excl_cols, excl_mask, k,
                                       c_real)
    redone = (_redo(lambda rows: scores[rows], excl_cols, excl_mask, c_real,
                    v, idx, ok) if with_fallback else 0)
    return (v, idx, ok, redone) if return_redone else (v, idx, ok)


def peel_masked_topk_scores(scores: torch.Tensor,
                            excl_cols: torch.Tensor | None,
                            excl_mask: torch.Tensor | None, k: int, *,
                            with_fallback: bool = True
                            ) -> tuple[torch.Tensor, ...]:
    """Exclusion + exact top-k over a precomputed [B, C] score matrix (JAX
    ``peel_masked_topk_scores``): the catalog is padded to a `BC` multiple
    with -1e30 (the dot path pads with zero scores; either way the lanes
    past C are dead-masked), K8 takes the window maxima, then the peel.
    Returns ``(v, idx, ok)`` as `peel_masked_topk_dot` does."""
    b, c = scores.shape
    cp = -(-c // BC) * BC
    if cp != c:
        scores = F.pad(scores, (0, cp - c), value=NEG)
    scores = scores.contiguous()
    excl_cols, excl_mask = pad_excl(excl_cols, excl_mask, b, scores.device)
    v, idx, ok = peel_topk_from_scores(scores, window_max(scores), excl_cols,
                                       excl_mask, k, c)
    if with_fallback:
        _redo(lambda rows: scores[rows], excl_cols, excl_mask, c, v, idx,
              ok)
    return v, idx, ok


def _redo(scores_of, excl_cols: torch.Tensor, excl_mask: torch.Tensor,
          c_real: int, v: torch.Tensor, idx: torch.Tensor,
          ok: torch.Tensor) -> int:
    """Overwrite the rows of ``(v, idx)`` whose ``ok`` is False with the
    dense top-k of their scores, ``scores_of(rows) -> [len(rows), C]`` (one
    host sync on ``ok``, the span ``host_wait.peel.flag``). Returns the
    number of rows redone, also counted as ``peel.redo_rows``."""
    with trace.host_wait("peel.flag"):
        exact = bool(ok.all())
    if exact:
        return 0
    with trace.host_wait("peel.redo"):
        redo = (~ok).nonzero().squeeze(1)
    n = int(redo.numel())
    trace.count("peel.redo_rows", n)
    fv, fi = topk_excluding(scores_of(redo), excl_cols[redo], excl_mask[redo],
                            v.shape[1], c_real=c_real)
    v[redo] = fv
    idx[redo] = fi
    return n
