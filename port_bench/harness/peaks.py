"""The yardstick: the card's published peaks and the operations and bytes
each measured kernel and step needs.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 67 TFLOP/s in f32 outside the tensor cores, 3.35 TB/s of HBM.
Every share is stated against them, beside the card's ``power.limit``.
"""
from __future__ import annotations

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
F32 = 4  # bytes


def bound_s(n_ops: float, n_bytes: float) -> float:
    """The least time the card could take: the larger of the operations over
    the f32 peak and the bytes over the HBM rate."""
    return max(n_ops / F32_FLOPS, n_bytes / HBM_BYTES_PER_S)


def dw_matmul(r: int, c: int, h: int) -> tuple[float, float]:
    """K5, ``dw [C, H] = vec[R, C].T @ g [R, H]``: operations and bytes
    (each input read once, the output written once)."""
    return 2.0 * r * c * h, F32 * (r * c + r * h + c * h)


def score_wmax(b: int, c: int, d: int) -> tuple[float, float]:
    """K2, ``scores [B, C] = u [B, D] @ items [C, D].T`` and the window
    maxima ``[B, C / 128]``: operations and bytes."""
    return 2.0 * b * c * d, F32 * (b * d + c * d + b * c + b * c // 128)


def linear_flops(rows: int, d_in: int, d_out: int, train: bool,
                 input_grad: bool) -> float:
    """A dense layer's operations: the forward product, and in training the
    weight gradient and, where the input needs one, the input gradient."""
    one = 2.0 * rows * d_in * d_out
    if not train:
        return one
    return one * (2 + (1 if input_grad else 0))


def sparse_first_layer_flops(nnz: int, h: int, train: bool) -> float:
    """An interaction tower's first layer, ``row @ kernel`` over a 0/1 row:
    what the inputs need is a sum of the ``nnz`` live kernel rows (2 nnz H
    operations), and in training the same for the kernel's gradient. The
    dense product the program may run instead is not counted."""
    return 2.0 * nnz * h * (2 if train else 1)
