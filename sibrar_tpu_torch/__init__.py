"""sibrar_tpu_torch: the PyTorch / CUDA port of sibrar_tpu for NVIDIA Hopper.

The JAX package ``sibrar_tpu`` stays the reference; every module here names
its counterpart there. This package imports torch, numpy and scipy only.
"""
import torch


def full_f32() -> None:
    """Keep f32 matmuls and convolutions in full f32 (no TF32), as the JAX
    reference computes them; called by the serving and scoring entry points."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
