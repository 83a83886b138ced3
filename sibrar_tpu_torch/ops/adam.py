"""The optimizer's Adam / AdamW step over every parameter at once.

Kernel K18 (`adam_step`, ``csrc/adam_step.cu``) updates each f32 parameter
and its two moments in place in one pass (28 bytes an element), up to 64
tensors a launch, their table passed in the launch's arguments. It replaces
no Pallas kernel: on the TPU, XLA fuses optax's update chain into one pass
over each parameter, and K18 stands in for that fusion. `adam_step_plain`
is the same step one PyTorch operation at a time, the arithmetic of
`train.trainer.Optimizer`'s loop.
"""
from __future__ import annotations

import array
from typing import Optional, Sequence

import torch

from sibrar_tpu_torch.ops import _cuda


@torch.no_grad()
def adam_step_plain(params: Sequence[torch.Tensor],
                    grads: Sequence[Optional[torch.Tensor]],
                    mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor],
                    *, lr: float, wd: float, b1: float, b2: float,
                    eps: float, count: int, decoupled: bool) -> None:
    """Plain version of K18: each parameter's step in turn, in place."""
    for p, g, mu, nu in zip(params, grads, mus, nus, strict=True):
        if g is None:
            g = torch.zeros_like(p)
        if not decoupled and wd:
            g = g + wd * p
        mu.mul_(b1).add_(g, alpha=1 - b1)
        adam_update_plain(p, g, mu, nu, lr=lr, wd=wd, b1=b1, b2=b2, eps=eps,
                          count=count, decoupled=decoupled)


def adam_update_plain(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                      nu: torch.Tensor, *, lr: float, wd: float, b1: float,
                      b2: float, eps: float, count: int,
                      decoupled: bool) -> None:
    """One parameter's step after its first moment: ``nu``'s update (in
    place), both bias corrections, the update with ``eps`` and AdamW's
    decay, taken from ``p`` in place. ``mu`` is the new first moment in
    ``p``'s dtype and ``g`` the gradient with Adam's decay already added
    (the optimizer's bf16-moment loop shares this with `adam_step_plain`)."""
    nu.mul_(b2).addcmul_(g, g, value=1 - b2)
    upd = (mu / (1 - b1 ** count)) / ((nu / (1 - b2 ** count)).sqrt() + eps)
    if decoupled and wd:
        upd = upd + wd * p
    p.sub_(lr * upd)


def adam_step(params: Sequence[torch.Tensor],
              grads: Sequence[Optional[torch.Tensor]],
              mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor], *,
              lr: float, wd: float, b1: float, b2: float, eps: float,
              count: int, decoupled: bool) -> None:
    """K18: one step of the f32 ``params`` and their first and second
    moments ``mus`` / ``nus``, in place. Adam adds the decay ``wd * p`` to
    the gradient, AdamW (``decoupled``) to the update; ``count`` is the
    step's number from 1, for the bias corrections. A None gradient steps
    as zeros. Each tensor must be contiguous and of its parameter's
    size. The launch reads the pointers from the tensors as they are now
    (a checkpoint load or a row slice may have replaced them)."""
    live = [g for g in grads if g is not None]
    if not _cuda.use_kernel(*params, *live, *mus, *nus):
        adam_step_plain(params, grads, mus, nus, lr=lr, wd=wd, b1=b1, b2=b2,
                        eps=eps, count=count, decoupled=decoupled)
        return
    f32 = torch.float32
    rows = array.array("q")  # the C entry's table: (p, g, mu, nu, n) rows
    for p, g, mu, nu in zip(params, grads, mus, nus, strict=True):
        n = p.numel()
        for t in (p, mu, nu) if g is None else (p, g, mu, nu):
            if t.dtype is not f32 or t.numel() != n or not t.is_contiguous():
                raise ValueError(
                    f"adam_step: contiguous f32 tensors of the parameter's "
                    f"size {tuple(p.shape)} only, got {t.dtype} "
                    f"{tuple(t.shape)} (contiguous: {t.is_contiguous()})")
        if n:
            rows.extend((p.data_ptr(), 0 if g is None else g.data_ptr(),
                         mu.data_ptr(), nu.data_ptr(), n))
    scalars = (b1, 1 - b1, b2, 1 - b2, 1 - b1 ** count, 1 - b2 ** count, eps,
               wd, lr, int(not decoupled and wd != 0),
               int(decoupled and wd != 0))
    per_launch = _cuda.query("sibrar_adam_step_max_tensors")
    for k in range(0, len(rows) // 5, per_launch):
        table = rows[5 * k:5 * (k + per_launch)]
        _cuda.launch("sibrar_adam_step", table.buffer_info()[0],
                     len(table) // 5, *scalars)
        adam_step.launches += 1


adam_step.launches = 0
