"""The interaction towers' dense first layer and its weight gradient (port of
``sibrar_tpu/ops/pallas_dw.py`` and of ``_dense_first_matmul`` in
``sibrar_tpu/models/layers.py``).

Kernel K5 (`dw_matmul`, ``csrc/dw_matmul.cu``) computes ``vec.T @ g`` while
reading ``vec`` in its own row-major layout. The forward product stays
``torch.matmul``, as the JAX package leaves it to XLA. The JAX block-size
gates (`dw_viable`, the padding fallback) exist for Mosaic's VMEM blocks and
have no counterpart: K5 masks its ragged edges itself.
"""
from __future__ import annotations

import torch

from sibrar_tpu_torch.ops import _cuda


def dw_matmul_plain(vec: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: ``dw = vec.T @ g``, f32 ``[C, H]``."""
    return vec.T.float() @ g


def dw_matmul(vec: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K5: ``dw[c, h] = sum_r vec[r, c] * g[r, h]`` for f32 ``vec [R, C]``
    and ``g [R, H]``, without a transposed copy of ``vec``."""
    r, c = vec.shape
    r2, h = g.shape
    if r != r2:
        raise ValueError(f"dw_matmul: vec {tuple(vec.shape)} and g "
                         f"{tuple(g.shape)} need equal row counts")
    if not _cuda.use_kernel(vec, g):
        return dw_matmul_plain(vec, g)
    if vec.dtype != torch.float32 or g.dtype != torch.float32:
        raise ValueError(f"dw_matmul: f32 only, got {vec.dtype}, {g.dtype}")
    vec, g = vec.contiguous(), g.contiguous()
    dw = torch.empty((c, h), dtype=torch.float32, device=vec.device)
    _cuda.launch("sibrar_dw_matmul", vec.data_ptr(), g.data_ptr(), r, c, h,
                 dw.data_ptr())
    dw_matmul.launches += 1
    return dw


dw_matmul.launches = 0


class DenseFirstMatmul(torch.autograd.Function):
    """``vec @ kernel`` whose backward treats ``vec`` (densified CSR rows:
    0/1, or L2-normalized under the tower's ``normalize``) as data, with no
    gradient, and computes the kernel's gradient with K5, which takes any
    f32 rows."""

    @staticmethod
    def forward(ctx, vec, kernel):
        ctx.save_for_backward(vec)
        return vec @ kernel

    @staticmethod
    def backward(ctx, g):
        (vec,) = ctx.saved_tensors
        return None, dw_matmul(vec, g.contiguous())


def dense_first_matmul(vec: torch.Tensor, kernel: torch.Tensor
                       ) -> torch.Tensor:
    return DenseFirstMatmul.apply(vec, kernel)
