"""Exact top-k with per-user exclusion (port of ``sibrar_tpu/ops/topk.py``).

`masked_topk` dispatches over six methods, all exact:

- ``full``: scatter -1e30 into the excluded columns, then `lax_topk`
  (`topk_excluding`). It is also the redo for peel rows whose exactness
  flag tripped, and the yardstick of the tests' methods (the chip smoke
  holds it, like the others, to K13's plain version);
- ``scatter``: the same scatter, then the two-phase `windowed_topk`;
- ``noscatter``: `windowed_topk_excluded`, exclusion by CSR bisection on
  the candidates of ``k + E`` windows;
- ``peel``: the value-peel selection over the scores (``ops/peel.py``,
  kernels K8, K3, K4, K11);
- ``pallas``: the windowed retile and finalist re-ranking
  (``ops/window.py``, kernels K9 and K3 on the tiling);
- ``auto``: the JAX package's accelerator branch on every device.

Every selection here is K13 (its plain version on the CPU), which keeps
``lax.top_k``'s order: the larger value first, equal values to the lower
index (`lax_topk` narrows a row longer than K13's `MAX_N` to the top-k
of its chunks first, or at k' >= `MAX_N` ranks it by a stable sort of
the total-order keys). The windowed methods select windows by maximum the
same way and keep their candidates in that window order, as JAX's do, so
each method returns JAX's ids on tied scores too (``torch.topk`` leaves
the order of ties unspecified).
"""
from __future__ import annotations

import logging

import torch
import torch.nn.functional as F

from sibrar_tpu_torch.config.schema import TOPK_METHODS as METHODS
from sibrar_tpu_torch.ops.exact_topk import (
    MAX_N,
    exact_topk,
    exact_topk_plain,
)
from sibrar_tpu_torch.ops.window import max_like_jax
from sibrar_tpu_torch.ops.sparse import (
    DeviceCSR,
    csr_contains,
    csr_row_gather,
    scatter_fill_rows,
)

NEG = -1e30


def lax_topk(x: torch.Tensor, k: int, max_n: int = MAX_N
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` of each row of ``x [R, n]`` (``k' = min(k, n)``): K13
    on rows of up to ``max_n`` values. JAX has no row limit, and neither
    has this: a longer row goes through `_chunked_topk` (K13 over chunks
    of ``max_n`` values), or, where k' is too large for a chunk to shrink
    the row (k' >= ``max_n``), through a stable sort of the total-order
    keys (`exact_topk_plain`; ``lax.top_k`` is an XLA op, not a Pallas
    kernel). Half-precision rows rank as f32, which is exact, and keep
    their dtype."""
    n = x.shape[1]
    k = min(k, n)
    xf = x.float() if x.dtype in (torch.float16, torch.bfloat16) else x
    if n <= max_n:
        v, i = exact_topk(xf.contiguous(), k)
        return v.to(x.dtype), i
    if k < max_n:
        i = _chunked_topk(xf, k, max_n)
    else:
        i = exact_topk_plain(xf, k)[1]
    return x.gather(1, i), i


def _chunked_topk(x: torch.Tensor, k: int, max_n: int) -> torch.Tensor:
    """Ids of `lax_topk` for rows longer than ``max_n`` with ``k < max_n``:
    K13's top-k of each chunk of ``max_n`` values, the candidates
    concatenated in chunk order, again until one K13 call takes the rest.
    Equal values keep their catalog order among the candidates (within a
    chunk K13 puts them lower index first, and the chunks go in catalog
    order), so each round keeps ``lax.top_k``'s tie order."""
    r = x.shape[0]
    cand_v, cand_c = x, None
    while cand_v.shape[1] > max_n:
        n = cand_v.shape[1]
        full = n // max_n * max_n
        v, p = exact_topk(cand_v[:, :full].reshape(-1, max_n).contiguous(),
                          k)
        p = p.view(r, -1, k) + torch.arange(0, full, max_n,
                                            device=x.device)[:, None]
        parts_v, parts_p = [v.view(r, -1)], [p.view(r, -1)]
        if full < n:
            v, p = exact_topk(cand_v[:, full:].contiguous(), k)
            parts_v.append(v)
            parts_p.append(p + full)
        p = torch.cat(parts_p, 1)
        cand_v = torch.cat(parts_v, 1)
        cand_c = p if cand_c is None else cand_c.gather(1, p)
    return cand_c.gather(1, exact_topk(cand_v, k)[1])


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
    return lax_topk(scores, min(k, c_real))


def _window_candidates(scores: torch.Tensor, m: int, window: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Values and column ids ``[B, m * window]`` of the top-``m`` windows by
    maximum (the row padded to a ``window`` multiple with -1e30), in order
    of their maxima as JAX keeps them."""
    b, c = scores.shape
    pad = (-c) % window
    if pad:
        scores = F.pad(scores, (0, pad), value=NEG)
    sw = scores.view(b, -1, window)
    widx = exact_topk(max_like_jax(sw, -1), min(m, sw.shape[1]))[1]
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
        return lax_topk(scores, k)
    cand_v, cand_c = _window_candidates(scores, k, 128)
    v, p = lax_topk(cand_v, k)
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
    v, p = lax_topk(torch.where(hit, NEG, cand_v), k)
    return v, cand_c.gather(1, p)


def resolve_method(method: str, c: int, k: int, e: int) -> str:
    """The method `masked_topk` runs when asked for ``method`` over C = ``c``
    columns, top ``k``, exclusion rows of at most ``e`` items."""
    from sibrar_tpu_torch.ops.peel import peel_viable

    if method not in METHODS:
        raise ValueError(f"unknown top-k method {method!r}; choose from "
                         f"{METHODS}")
    if method == "auto":
        if c <= 4096 or k >= c:
            return "full"
        return "peel" if peel_viable(c, k, e) else "scatter"
    if method == "peel" and not peel_viable(c, k, e):
        logging.getLogger(__name__).warning(
            "topk method 'peel' is not viable at C=%d, k=%d, E=%d; using "
            "'scatter'", c, k, e)
        return "scatter"
    return method


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
    from sibrar_tpu_torch.ops.peel import peel_masked_topk_scores
    from sibrar_tpu_torch.ops.window import pallas_masked_topk_scores

    e = exclude_csr.max_row_len
    method = resolve_method(method, scores.shape[1], k, e)
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
