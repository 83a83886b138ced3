"""The score GEMM's epilogue variants and its one-pass bf16 spelling (port
of the Pallas kernels of ``tools/probe_gemm_bisect.py``,
``tools/probe_gemm_variants.py`` and ``tools/probe_gemm_precision.py``).

Kernel K14 (``csrc/score_variants.cu``) runs K2's f32 main loop
(``csrc/score_tile.cuh``) under the bisect probe's six epilogues, each its
own kernel name so that a profiler's rows tell them apart. For f32
``u [B, D]`` and ``items [C, D]``, with ``s = u @ items.T`` and ``m [B,
C/128]`` the maxima of its 128-wide windows, each variant returns a tuple:

=============  ==========================================================
``full``       ``(s [B, C], wmax_t [C/128, B])``, ``wmax_t = m.T``
``noscores``   ``(wmax_t,)``
``nowmax``     ``(s,)``: the hand-written GEMM and nothing else
``wmax_contig`` ``(s, wmax_t.view(C/1024, 8, B))``: the same bytes as
               ``wmax_t`` (the TPU variant moved its out block, and at B
               = 1,024 the layouts coincide)
``wmax_T``     as ``full``, the maxima staged in shared memory and stored
               along B in one coalesced run (the TPU's one transpose per
               step)
``wmax_lanes`` ``(s, m)``: K2's layout
=============  ==========================================================

The scores of every variant are K2's (`window.score_wmax`) bit for bit,
and its maxima are K2's in its layout.

Kernel K15 (``csrc/score_bf16.cu``) is the precision probe's ``default``:
on the TPU, precision DEFAULT is one bf16 pass of the matrix unit with f32
sums. K15 rounds ``u`` and ``items`` to bf16 (round to nearest even) and
multiplies them on the tensor cores (``wgmma``) with f32 accumulators,
returning ``full``'s ``(s, wmax_t)``; each item is read from device memory
once.

The precision probe's modes map so: ``default`` is K15; ``highest`` and
``asis`` (no precision argument) are K14 ``full``, K2's f32 FFMA loop,
because the port's production GEMM takes no precision and computes in f32.
There is no TF32 mode: the JAX probe has none.
"""
from __future__ import annotations

import torch

from sibrar_tpu_torch.ops import _cuda
from sibrar_tpu_torch.ops.window import WINDOW, _dot_operands, score_wmax_plain

BC = 1024  # the probes' catalog block: wmax_contig's leading dimension
# the C entry's variant codes (csrc/score_variants.cu kKernels)
VARIANT_CODES = {"full": 0, "noscores": 1, "nowmax": 2, "wmax_contig": 3,
                 "wmax_T": 4, "wmax_lanes": 5}


def variant_outputs(variant: str, scores: torch.Tensor, wmax: torch.Tensor
                    ) -> tuple[torch.Tensor, ...]:
    """``variant``'s outputs from K2's ``scores [B, C]`` and ``wmax [B,
    C/128]``."""
    b, c = scores.shape
    if variant == "nowmax":
        return (scores,)
    if variant == "wmax_lanes":
        return scores, wmax
    wmax_t = wmax.T.contiguous()
    if variant == "noscores":
        return (wmax_t,)
    if variant == "wmax_contig":
        return scores, wmax_t.view(c // BC, BC // WINDOW, b)
    return scores, wmax_t  # full, wmax_T


def score_variant_plain(u: torch.Tensor, items: torch.Tensor, variant: str
                        ) -> tuple[torch.Tensor, ...]:
    """Plain version of K14: ``u @ items.T`` and its window maxima in
    ``variant``'s layout."""
    return variant_outputs(variant, *score_wmax_plain(u, items))


def _shapes(u: torch.Tensor, items: torch.Tensor, name: str,
            multiple: int = WINDOW) -> tuple[int, int, int]:
    b, d = u.shape
    c, di = items.shape
    if d != di or c % multiple:
        raise ValueError(f"{name}: u {tuple(u.shape)} and items "
                         f"{tuple(items.shape)} need equal D and C % "
                         f"{multiple} == 0")
    return b, c, d


def _score_variant(u: torch.Tensor, items: torch.Tensor, variant: str,
                   counted) -> tuple[torch.Tensor, ...]:
    """K14 under ``variant``; a launch adds one to ``counted.launches``."""
    b, c, d = _shapes(u, items, f"score_{variant}",
                      BC if variant == "wmax_contig" else WINDOW)
    if not _cuda.use_kernel(u, items):
        return score_variant_plain(u, items, variant)
    u, items = _dot_operands(u, items, f"score_{variant}")
    nw = c // WINDOW
    shapes = {"full": [(b, c), (nw, b)], "noscores": [(nw, b)],
              "nowmax": [(b, c)], "wmax_contig": [(b, c), (c // BC, 8, b)],
              "wmax_T": [(b, c), (nw, b)],
              "wmax_lanes": [(b, c), (b, nw)]}[variant]
    outs = tuple(torch.empty(shape, dtype=torch.float32, device=u.device)
                 for shape in shapes)
    scores = 0 if variant == "noscores" else outs[0].data_ptr()
    wmax = 0 if variant == "nowmax" else outs[-1].data_ptr()
    _cuda.launch("sibrar_score_variant", u.data_ptr(), items.data_ptr(), b, c,
                 d, VARIANT_CODES[variant], scores, wmax)
    counted.launches += 1
    return outs


def score_full(u, items):
    """K14 ``full``: ``(scores [B, C], wmax_t [C/128, B])``."""
    return _score_variant(u, items, "full", score_full)


def score_noscores(u, items):
    """K14 ``noscores``: ``(wmax_t [C/128, B],)``, no score store."""
    return _score_variant(u, items, "noscores", score_noscores)


def score_nowmax(u, items):
    """K14 ``nowmax``: ``(scores [B, C],)``, no maxima."""
    return _score_variant(u, items, "nowmax", score_nowmax)


def score_wmax_contig(u, items):
    """K14 ``wmax_contig``: ``(scores, wmax [C/1024, 8, B])``; C % 1024 ==
    0."""
    return _score_variant(u, items, "wmax_contig", score_wmax_contig)


def score_wmax_T(u, items):
    """K14 ``wmax_T``: ``full``'s outputs, the maxima staged through shared
    memory and stored along B in one coalesced run."""
    return _score_variant(u, items, "wmax_T", score_wmax_T)


def score_wmax_lanes(u, items):
    """K14 ``wmax_lanes``: ``(scores, wmax [B, C/128])``."""
    return _score_variant(u, items, "wmax_lanes", score_wmax_lanes)


VARIANTS = {"full": score_full, "noscores": score_noscores,
            "nowmax": score_nowmax, "wmax_contig": score_wmax_contig,
            "wmax_T": score_wmax_T, "wmax_lanes": score_wmax_lanes}
for _fn in VARIANTS.values():
    _fn.launches = 0


# ----------------------------------------------------------------- kernel K15
def score_bf16_plain(u: torch.Tensor, items: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K15: the f32 product of the bf16-rounded operands
    (exact products, f32 sums; TF32 must be off, `sibrar_tpu_torch.full_f32`)
    and its maxima as ``wmax_t [C/128, B]``."""
    return score_variant_plain(u.bfloat16().float(), items.bfloat16().float(),
                               "full")


def score_bf16(u: torch.Tensor, items: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """K15: ``(scores [B, C], wmax_t [C/128, B])`` from one bf16 pass on
    the tensor cores (operands rounded to bf16, f32 accumulators), for f32
    ``u [B, D]`` and ``items [C, D]`` with C % 128 == 0 and D % 4 == 0.
    Takes a workspace for ``u`` rounded once (``sibrar_score_bf16_workspace``
    bytes: 32 KB per 64 users and 256 depths)."""
    b, c, d = _shapes(u, items, "score_bf16")
    if not _cuda.use_kernel(u, items):
        return score_bf16_plain(u, items)
    if d % 4:
        raise ValueError(f"score_bf16: D = {d} must be a multiple of 4")
    u, items = _dot_operands(u, items, "score_bf16")
    scores = torch.empty((b, c), dtype=torch.float32, device=u.device)
    wmax_t = torch.empty((c // WINDOW, b), dtype=torch.float32,
                         device=u.device)
    work = torch.empty(_cuda.query("sibrar_score_bf16_workspace", b, d),
                       dtype=torch.uint8, device=u.device)
    _cuda.launch("sibrar_score_bf16", u.data_ptr(), items.data_ptr(), b, c, d,
                 scores.data_ptr(), wmax_t.data_ptr(), work.data_ptr())
    score_bf16.launches += 1
    return scores, wmax_t


score_bf16.launches = 0
