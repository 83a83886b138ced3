"""sibrar_tpu_torch: the PyTorch / CUDA port of sibrar_tpu for NVIDIA Hopper.

The JAX package ``sibrar_tpu`` stays the reference; every module here names
its counterpart there. This package imports torch, numpy and scipy only.
"""
import dataclasses

import torch


def config_from_dict(cls, data):
    """Dataclass ``cls`` from a config dict (``None`` reads as empty); keys
    it has no field for are ignored, as the JAX package's loader does."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in (data or {}).items() if k in names})


def full_f32() -> None:
    """Keep f32 matmuls and convolutions in full f32 (no TF32), as the JAX
    reference computes them; called by the serving and scoring entry points."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
