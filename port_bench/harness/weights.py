"""Weights from the seed, made on the device in three draws.

A reference module's ``parameter_spec`` lists every parameter as ``(name,
shape, kind, scale)``: ``uniform`` draws U(-scale, scale), ``normal``
N(0, scale^2), ``const`` fills ``scale``. All uniform parameters share one
draw of U(-1, 1) and all normal ones one draw of N(0, 1), each then scaled
by its slice, so set-up makes the weights in a few large calls in f32.
"""
from __future__ import annotations

import math

import torch


def make(spec: list, seed: int, device) -> dict:
    """``{name: f32 tensor}`` of ``spec`` from ``seed``, on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    sizes = {kind: sum(math.prod(shape) for _, shape, k, _ in spec
                       if k == kind) for kind in ("uniform", "normal")}
    flat = {"uniform": torch.rand(sizes["uniform"], generator=g,
                                  device=device).mul_(2).sub_(1),
            "normal": torch.randn(sizes["normal"], generator=g,
                                  device=device)}
    start = {"uniform": 0, "normal": 0}
    out = {}
    for name, shape, kind, scale in spec:
        n = math.prod(shape)
        if kind == "const":
            out[name] = torch.full(shape, float(scale), device=device)
            continue
        if kind not in flat:
            raise ValueError(f"unknown init {kind!r} for {name}")
        out[name] = flat[kind][start[kind]:start[kind] + n].view(
            shape).mul(scale)
        start[kind] += n
    return out


def load_into(model, weights: dict) -> None:
    """Copy ``weights`` into ``model``'s parameters; the names and shapes
    must be exactly the model's, and its batch-norm statistics start at
    mean 0 and variance 1."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(
            "the program's parameters differ from the reference's: "
            f"{sorted(set(params) ^ set(weights))}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: program {tuple(p.shape)}, "
                                 f"reference {tuple(weights[name].shape)}")
            p.copy_(weights[name])
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.zero_()
            elif name.endswith("running_var"):
                buf.fill_(1.0)
