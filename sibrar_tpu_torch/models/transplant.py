"""Load the flax variables of a JAX ``SingleBranchNet`` into the port.

``variables`` is ``{"params": ..., "batch_stats": ...}`` as nested dicts of
arrays (anything ``numpy.asarray`` takes), the layout the JAX package's
``init_model`` and checkpoints hold. Two layout rules:

- a flax ``Dense`` kernel is ``[in, out]``; an ``nn.Linear`` weight is
  ``[out, in]``, so it is transposed. The interaction towers keep the flax
  ``[n_cols, h]`` layout and copy as they are;
- flax BatchNorm ``scale`` / ``bias`` are the affine weight / bias, and its
  ``batch_stats`` ``mean`` / ``var`` become the running statistics.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from sibrar_tpu_torch.models.layers import (
    FeatureEmbeddingModule,
    InteractionTower,
    PolyLinear,
    TagEmbeddingBag,
)
from sibrar_tpu_torch.models.sbnet import (
    PlainEntityModule,
    PlainIdEmbeddingModule,
    SingleBranchNet,
    SingleBranchNetEntity,
)


def _copy(dst: torch.Tensor, src, transpose: bool = False) -> None:
    arr = np.asarray(src, dtype=np.float32)
    if transpose:
        arr = arr.T
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"transplant shape mismatch: {arr.shape} into "
                         f"{tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.tensor(arr))


def _poly(mod: PolyLinear, p: dict, s: dict) -> None:
    for i, lin in enumerate(mod.linears):
        _copy(lin.weight, p[f"linear_{i}"]["kernel"], transpose=True)
        _copy(lin.bias, p[f"linear_{i}"]["bias"])
    for key, bn in mod.batch_norm.items():
        name = (f"batch_norm_{key}" if mod.apply_batch_norm_every > 0
                else "batch_norm")
        _copy(bn.weight, p[name]["scale"])
        _copy(bn.bias, p[name]["bias"])
        _copy(bn.running_mean, s[name]["mean"])
        _copy(bn.running_var, s[name]["var"])


def _module(mod: nn.Module, p: dict, s: dict) -> None:
    if isinstance(mod, InteractionTower):
        _copy(mod.kernel, p["kernel"])
        _copy(mod.bias, p["bias"])
        if mod.rest is not None:
            _poly(mod.rest, p["rest"], s.get("rest", {}))
    elif isinstance(mod, FeatureEmbeddingModule):
        if isinstance(mod.embedding, TagEmbeddingBag):
            _copy(mod.embedding.embedding.weight, p["embedding"]["embedding"])
        elif mod.embedding is not None:
            _copy(mod.embedding.weight, p["embedding"]["embedding"])
        for name in ("pre_embedding", "post_embedding"):
            if getattr(mod, name) is not None:
                _poly(getattr(mod, name), p[name], s.get(name, {}))
    elif isinstance(mod, nn.Embedding):  # '{entity}_embedding' modality
        _copy(mod.weight, p["embedding"])
    else:
        raise TypeError(f"no transplant rule for {type(mod).__name__}")


def _entity(mod: nn.Module, p: dict, s: dict) -> None:
    if isinstance(mod, SingleBranchNetEntity):
        for i, (name, sub) in enumerate(zip(mod.modality_names,
                                            mod.modalities)):
            # flax names the cloned modality modules by their list slot, and
            # keeps the explicit name of the id-embedding one it creates
            key = (f"mod_{name}" if isinstance(sub, nn.Embedding)
                   else f"_mods_{i}")
            _module(sub, p[key], s.get(key, {}))
        _poly(mod.sb_net, p["sb_net"], s.get("sb_net", {}))
    elif isinstance(mod, PlainEntityModule):
        _module(mod.net, p["net"], s.get("net", {}))
    elif isinstance(mod, PlainIdEmbeddingModule):
        _copy(mod.embedding.weight, p["embedding"]["embedding"])
    else:
        raise TypeError(f"no transplant rule for {type(mod).__name__}")


def transplant(model: SingleBranchNet, variables: dict) -> SingleBranchNet:
    """Copy JAX ``SingleBranchNet`` variables into ``model`` in place."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    for name in ("user_module", "item_module"):
        _entity(getattr(model, name), params[name], stats.get(name, {}))
    return model
