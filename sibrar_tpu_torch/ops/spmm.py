"""The interaction towers' first layer straight from padded CSR rows (port of
``sibrar_tpu/ops/pallas_spmm.py``).

``spmm_onehot(cols, mask, kernel)`` is ``densify(rows) @ kernel`` for 0/1
rows given as the K1 row gather's ``(cols, mask)``: kernel K6 (`spmm_fwd`)
sums the rows' kernel rows, and its backward, kernel K7 (`spmm_bwd`),
scatters the output gradient back into those rows (``csrc/spmm_onehot.cu``).
Masked slots contribute nothing; the result is differentiable in ``kernel``
only. Live ``cols`` must lie in ``[0, n_cols)``.

K7 and its plain version sum each kernel row's gradient in JAX's order
(`bwd_order`), so both are bit-equal to JAX's ``_spmm_bwd`` and the same on
every call.
"""
from __future__ import annotations

import torch

from sibrar_tpu_torch.ops import _cuda


def _check(cols: torch.Tensor, mask: torch.Tensor, dense: torch.Tensor,
           name: str) -> None:
    if (cols.ndim != 2 or cols.shape != mask.shape
            or cols.dtype != torch.int32 or mask.dtype != torch.bool
            or dense.dtype != torch.float32 or dense.ndim != 2):
        raise ValueError(
            f"{name}: needs int32 cols and bool mask of one [B, L] shape and "
            f"an f32 matrix; got {cols.dtype} {tuple(cols.shape)}, "
            f"{mask.dtype} {tuple(mask.shape)}, {dense.dtype} "
            f"{tuple(dense.shape)}")


# ------------------------------------------------------------------ kernel K6
def _live(cols: torch.Tensor, mask: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Row ids and columns of the live slots, in row-major slot order."""
    rows, slots = torch.nonzero(mask, as_tuple=True)
    return rows, cols[rows, slots].long()


def spmm_fwd_plain(cols: torch.Tensor, mask: torch.Tensor,
                   kernel: torch.Tensor) -> torch.Tensor:
    """Plain version of K6:
    ``out[b] = sum_{l: mask[b, l]} kernel[cols[b, l]]``."""
    rows, c = _live(cols, mask)
    out = torch.zeros((cols.shape[0], kernel.shape[1]), dtype=kernel.dtype,
                      device=kernel.device)
    return out.index_add_(0, rows, kernel[c])


def spmm_fwd(cols: torch.Tensor, mask: torch.Tensor,
             kernel: torch.Tensor) -> torch.Tensor:
    """K6: the masked sum of kernel rows, ``[B, H]`` f32, the same bits on
    every call (a row of more than 32 live slots sums its runs apart, so
    its last bits may differ from a serial sum; see
    ``csrc/spmm_onehot.cu``). Takes a workspace fixed by B, L and H: the
    packed live ids, the plan and the partial sums."""
    if not _cuda.use_kernel(cols, mask, kernel):
        return spmm_fwd_plain(cols, mask, kernel)
    _check(cols, mask, kernel, "spmm_fwd")
    cols, mask = cols.contiguous(), mask.contiguous()
    kernel = kernel.contiguous()
    b, length = cols.shape
    h = kernel.shape[1]
    out = torch.empty((b, h), dtype=torch.float32, device=kernel.device)
    work = torch.empty(_cuda.query("sibrar_spmm_fwd_workspace", b, length, h),
                       dtype=torch.uint8, device=kernel.device)
    _cuda.launch("sibrar_spmm_fwd", cols.data_ptr(), mask.data_ptr(),
                 kernel.data_ptr(), b, length, h, out.data_ptr(),
                 work.data_ptr())
    spmm_fwd.launches += 1
    return out


spmm_fwd.launches = 0


# ------------------------------------------------------------------ kernel K7
def bwd_order(rows: torch.Tensor, slots: torch.Tensor,
              length: int) -> torch.Tensor:
    """The order in which JAX's ``_spmm_bwd`` adds the live slots ``(rows,
    slots)`` into a column: row groups of 8, then slots, then rows within
    the group, i.e. ascending key ``(b >> 3, l, b & 7)``."""
    key = ((rows >> 3) * length + slots) * 8 + (rows & 7)
    return torch.argsort(key)


def spmm_bwd_plain(cols: torch.Tensor, mask: torch.Tensor, g: torch.Tensor,
                   n_cols: int) -> torch.Tensor:
    """Plain version of K7:
    ``dk[c] = sum_{(b, l): mask[b, l], cols[b, l] == c} g[b]``, each sum
    from +0.0 in `bwd_order` (``index_add_`` on the CPU adds in index
    order, so there it is bit-equal to JAX's ``_spmm_bwd``)."""
    rows, slots = torch.nonzero(mask, as_tuple=True)
    order = bwd_order(rows, slots, cols.shape[1])
    rows, slots = rows[order], slots[order]
    dk = torch.zeros((n_cols, g.shape[1]), dtype=g.dtype, device=g.device)
    return dk.index_add_(0, cols[rows, slots].long(), g[rows])


def spmm_bwd(cols: torch.Tensor, mask: torch.Tensor, g: torch.Tensor,
             n_cols: int) -> torch.Tensor:
    """K7: the kernel's gradient ``[n_cols, H]`` f32, every row written by
    the kernel (+0.0 where no live slot hits it), each sum in `bwd_order`:
    the same bits on every call, and JAX's. Takes a workspace fixed by B, L
    and n_cols: the per-column counts and starts and one key per slot."""
    if not _cuda.use_kernel(cols, mask, g):
        return spmm_bwd_plain(cols, mask, g, n_cols)
    _check(cols, mask, g, "spmm_bwd")
    cols, mask, g = cols.contiguous(), mask.contiguous(), g.contiguous()
    b, length = cols.shape
    h = g.shape[1]
    dk = torch.empty((n_cols, h), dtype=torch.float32, device=g.device)
    work = torch.empty(_cuda.query("sibrar_spmm_bwd_workspace", b, length,
                                   n_cols),
                       dtype=torch.uint8, device=g.device)
    _cuda.launch("sibrar_spmm_bwd", cols.data_ptr(), mask.data_ptr(),
                 g.data_ptr(), b, length, h, n_cols, dk.data_ptr(),
                 work.data_ptr())
    spmm_bwd.launches += 1
    return dk


spmm_bwd.launches = 0


class SpmmOnehot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cols, mask, kernel):
        ctx.save_for_backward(cols, mask)
        ctx.n_cols = kernel.shape[0]
        return spmm_fwd(cols, mask, kernel)

    @staticmethod
    def backward(ctx, g):
        cols, mask = ctx.saved_tensors
        return None, None, spmm_bwd(cols, mask, g.contiguous(), ctx.n_cols)


def spmm_onehot(cols: torch.Tensor, mask: torch.Tensor,
                kernel: torch.Tensor) -> torch.Tensor:
    """``out[b] = sum_{l: mask[b, l]} kernel[cols[b, l]]`` ``[B, H]``,
    differentiable in ``kernel`` only (JAX ``spmm_onehot``)."""
    return SpmmOnehot.apply(cols, mask, kernel)
