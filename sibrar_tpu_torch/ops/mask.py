"""A masked fill over a byte mask (port of the Pallas kernel of
``tools/probe_pred_input.py``, ``try_mask``).

Kernel K17 (``csrc/mask_where.cu``): ``where(mask, fill, x)`` for f32 ``x``
and a ``torch.bool`` mask, or an ``int8`` one where non-zero means masked,
of the same shape: the dead-lane fill of the peel's window gather, which
the TPU probe tried as a kernel input block of either type.
"""
from __future__ import annotations

import torch

from sibrar_tpu_torch.ops import _cuda

NEG = -1e30


def mask_where_plain(mask: torch.Tensor, x: torch.Tensor,
                     fill: float = NEG) -> torch.Tensor:
    """Plain version: ``torch.where``."""
    return torch.where(mask if mask.dtype == torch.bool else mask != 0,
                       fill, x)


def mask_where(mask: torch.Tensor, x: torch.Tensor,
               fill: float = NEG) -> torch.Tensor:
    """K17: ``fill`` where ``mask`` (bool, or int8 non-zero), else ``x``
    (f32, same shape)."""
    if mask.shape != x.shape:
        raise ValueError(f"mask_where: mask {tuple(mask.shape)} and x "
                         f"{tuple(x.shape)} differ")
    if not _cuda.use_kernel(mask, x):
        return mask_where_plain(mask, x, fill)
    if x.dtype != torch.float32 or mask.dtype not in (torch.bool, torch.int8):
        raise ValueError(f"mask_where: f32 x and a bool or int8 mask, got "
                         f"{x.dtype}, {mask.dtype}")
    x, mask = x.contiguous(), mask.contiguous()
    if x.data_ptr() % 16:  # the kernel's float4 loads
        x = x.clone()
    if mask.data_ptr() % 4:  # its 4-byte mask loads
        mask = mask.clone()
    out = torch.empty_like(x)
    _cuda.launch("sibrar_mask_where", mask.data_ptr(), x.data_ptr(), fill,
                 x.numel(), out.data_ptr())
    mask_where.launches += 1
    return out


mask_where.launches = 0
