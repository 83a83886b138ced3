"""Exact per-row top-k in ``lax.top_k``'s order (port of
``sibrar_tpu/ops/pallas_topk.py``): kernel K13 (``csrc/exact_topk.cu``).

The contract is the JAX docstring's: the values and indices of
``lax.top_k``, equal values to the lower index first, indices distinct and
below n. ``lax.top_k`` compares floats in their total order (-0.0 below
+0.0), which ``torch.sort`` does not, so the plain version sorts the total
order's integer keys. The JAX kernel masks an extracted element with -inf
and so repeats an index once a row has fewer than k values above -inf; K13
selects by a threshold (the k-th largest 128-window maximum), sorts the
elements that pass it, and keeps the contract there too.
"""
from __future__ import annotations

import torch

from sibrar_tpu_torch.ops import _cuda
from sibrar_tpu_torch.ops.window import WINDOW

# The longest row K13 takes, unchanged since its first version (which kept
# 20 bytes of shared memory per 128 values); it now keeps 4 bytes per 128
# values plus 17 KB of buffers, 63 KB at MAX_N
MAX_N = (226 * 1024 // 20) * WINDOW


def exact_topk_plain(x: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K13: a stable descending sort of the f32 rows'
    total-order keys (the bits as int32, magnitude bits flipped where the
    sign is set), cut to k."""
    bits = x.float().contiguous().view(torch.int32)
    keys = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.sort(keys, dim=1, descending=True, stable=True).indices[:, :k]
    return x.gather(1, idx), idx


def exact_topk(x: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """K13: ``(vals [R, k'], idx [R, k'] int64)`` with ``k' = min(k, n)``,
    the exact top-k' of each row of ``x [R, n]`` (JAX ``exact_topk``). JAX
    hands rows shorter than its ``min_n`` and ``k >= n`` to ``lax.top_k``;
    K13 takes any row up to `MAX_N` values and any k' and returns the same
    values and indices, so a tensor on the card always launches it."""
    if x.ndim != 2:
        raise ValueError(f"exact_topk: x must be [R, n], got {tuple(x.shape)}")
    r, n = x.shape
    k = min(k, n)
    if not _cuda.use_kernel(x):
        return exact_topk_plain(x, k)
    if x.dtype != torch.float32 or not x.is_contiguous() or n > MAX_N:
        raise ValueError(f"exact_topk: contiguous f32 rows of at most "
                         f"{MAX_N} values only")
    vals = torch.empty((r, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((r, k), dtype=torch.int64, device=x.device)
    _cuda.launch("sibrar_exact_topk", x.data_ptr(), r, n, k, vals.data_ptr(),
                 idx.data_ptr())
    exact_topk.launches += 1
    return vals, idx


exact_topk.launches = 0
