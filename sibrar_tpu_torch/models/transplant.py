"""Load the flax variables of a JAX ``SingleBranchNet`` into the port.

``variables`` is ``{"params": ..., "batch_stats": ...}`` as nested dicts of
arrays (anything ``numpy.asarray`` takes), the layout the JAX package's
``init_model`` and checkpoints hold. Two layout rules:

- a flax ``Dense`` kernel is ``[in, out]``; an ``nn.Linear`` weight is
  ``[out, in]``, so it is transposed. The interaction towers keep the flax
  ``[n_cols, h]`` layout and copy as they are;
- flax BatchNorm ``scale`` / ``bias`` are the affine weight / bias, and its
  ``batch_stats`` ``mean`` / ``var`` become the running statistics.

`transplant_opt_state` carries an optax ``adam`` / ``adamw`` state (``count``,
``mu``, ``nu``; trees shaped like ``params``) or an ``adagrad`` state
(``sum_of_squares``) into the port's `train.trainer.Optimizer` by the same
rules.
"""
from __future__ import annotations

from typing import Optional

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


def _pairs(model: SingleBranchNet, params: dict, stats: Optional[dict]
           ) -> list[tuple[torch.Tensor, object, bool]]:
    """``(port tensor, flax leaf, transpose)`` for every parameter, and for
    every batch-norm statistic unless ``stats`` is None."""
    out = []

    def put(dst, src, transpose=False):
        out.append((dst, src, transpose))

    def poly(mod: PolyLinear, p: dict, s: Optional[dict]) -> None:
        for i, lin in enumerate(mod.linears):
            put(lin.weight, p[f"linear_{i}"]["kernel"], True)
            put(lin.bias, p[f"linear_{i}"]["bias"])
        for key, bn in mod.batch_norm.items():
            name = (f"batch_norm_{key}" if mod.apply_batch_norm_every > 0
                    else "batch_norm")
            put(bn.weight, p[name]["scale"])
            put(bn.bias, p[name]["bias"])
            if s is not None:
                put(bn.running_mean, s[name]["mean"])
                put(bn.running_var, s[name]["var"])

    def sub(s: Optional[dict], key: str) -> Optional[dict]:
        return None if s is None else s.get(key, {})

    def module(mod: nn.Module, p: dict, s: Optional[dict]) -> None:
        if isinstance(mod, InteractionTower):
            put(mod.kernel, p["kernel"])
            put(mod.bias, p["bias"])
            if mod.rest is not None:
                poly(mod.rest, p["rest"], sub(s, "rest"))
        elif isinstance(mod, FeatureEmbeddingModule):
            emb = mod.embedding
            if isinstance(emb, TagEmbeddingBag):
                put(emb.embedding.weight, p["embedding"]["embedding"])
            elif emb is not None:
                put(emb.weight, p["embedding"]["embedding"])
            for name in ("pre_embedding", "post_embedding"):
                if getattr(mod, name) is not None:
                    poly(getattr(mod, name), p[name], sub(s, name))
        elif isinstance(mod, nn.Embedding):  # '{entity}_embedding' modality
            put(mod.weight, p["embedding"])
        else:
            raise TypeError(f"no transplant rule for {type(mod).__name__}")

    def entity(mod: nn.Module, p: dict, s: Optional[dict]) -> None:
        if isinstance(mod, SingleBranchNetEntity):
            for i, (name, m) in enumerate(zip(mod.modality_names,
                                              mod.modalities)):
                # flax names the cloned modality modules by their list slot,
                # and keeps the explicit name of the id-embedding one
                key = (f"mod_{name}" if isinstance(m, nn.Embedding)
                       else f"_mods_{i}")
                module(m, p[key], sub(s, key))
            poly(mod.sb_net, p["sb_net"], sub(s, "sb_net"))
        elif isinstance(mod, PlainEntityModule):
            module(mod.net, p["net"], sub(s, "net"))
        elif isinstance(mod, PlainIdEmbeddingModule):
            put(mod.embedding.weight, p["embedding"]["embedding"])
        else:
            raise TypeError(f"no transplant rule for {type(mod).__name__}")

    for name in ("user_module", "item_module"):
        entity(getattr(model, name), params[name], sub(stats, name))
    return out


def _array(dst: torch.Tensor, src, transpose: bool) -> torch.Tensor:
    arr = np.asarray(src, dtype=np.float32)
    if transpose:
        arr = arr.T
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"transplant shape mismatch: {arr.shape} into "
                         f"{tuple(dst.shape)}")
    return torch.tensor(arr, device=dst.device)


def transplant(model: SingleBranchNet, variables: dict) -> SingleBranchNet:
    """Copy JAX ``SingleBranchNet`` variables into ``model`` in place."""
    stats = variables.get("batch_stats", {})
    with torch.no_grad():
        for dst, src, transpose in _pairs(model, variables["params"], stats):
            dst.copy_(_array(dst, src, transpose))
    return model


def _find_state(opt_state, fields: tuple[str, ...]):
    """The first node of an optax state tree that has all ``fields``."""
    if all(hasattr(opt_state, f) for f in fields):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for item in opt_state:
            found = _find_state(item, fields)
            if found is not None:
                return found
    return None


def transplant_opt_state(model: SingleBranchNet, optimizer,
                         opt_state) -> None:
    """Load an optax state of ``build_optimizer`` into ``optimizer`` (a
    `train.trainer.Optimizer` over ``model``'s parameters) in place."""
    names = (("sum_of_squares",) if optimizer.kind == "adagrad"
             else ("mu", "nu"))
    state = _find_state(opt_state, names)
    if state is None:
        raise ValueError(f"no optax state with {names} in {type(opt_state)}")
    if optimizer.kind != "adagrad":
        optimizer.count = int(np.asarray(state.count))
    for name in names:
        for dst, src, transpose in _pairs(model, getattr(state, name), None):
            optimizer.state[dst][name] = _array(dst, src, transpose)
