"""Neural building blocks (port of ``sibrar_tpu/models/layers.py``).

Every module has the JAX package's eval and train forwards (``module.train()``
selects batch statistics and input dropout, as flax's ``train=True``) and its
random initialization, drawn on the CPU from an explicit ``torch.Generator``
(move the built model with ``.to(device)``). Train-time dropout draws from the
generator the caller passes. Weights trained by the JAX package come in
through ``models/transplant.py``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from sibrar_tpu_torch.ops.dw import dense_first_matmul
from sibrar_tpu_torch.ops.sparse import (
    DeviceCSR,
    csr_row_gather,
    csr_rows_to_dense,
)
from sibrar_tpu_torch.ops.spmm import spmm_onehot

ACTIVATIONS = {"relu": torch.relu, "tanh": torch.tanh,
               "sigmoid": torch.sigmoid, "selu": torch.selu}


def get_activation_fn(name):
    if name is None or callable(name):
        return name
    return ACTIVATIONS[name]


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-8) -> torch.Tensor:
    """``x / max(||x||, eps)`` spelled as the JAX package spells it, with the
    squared norm clamped before the rsqrt."""
    sq = x.square().sum(dim=dim, keepdim=True)
    return x * torch.rsqrt(sq.clamp(min=eps * eps))


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator):
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=gen)


def linear(d_in: int, d_out: int, gen: torch.Generator, *,
           torch_default_init: bool = False) -> nn.Linear:
    """`Dense`: kaiming-uniform(relu) weight and zero bias (the reference's
    general_weight_init), or with ``torch_default_init`` U(+-1/sqrt(fan_in))
    for weight and bias (`torch_default_uniform`)."""
    layer = nn.Linear(d_in, d_out)
    if torch_default_init:
        bound = 1.0 / math.sqrt(d_in)
        _uniform_(layer.weight, bound, gen)
        _uniform_(layer.bias, bound, gen)
    else:
        _uniform_(layer.weight, math.sqrt(6.0 / d_in), gen)
        nn.init.zeros_(layer.bias)
    return layer


class Embedding(nn.Embedding):
    """``nn.Embedding`` with the reference's N(0, 0.1 / dim) init."""

    def __init__(self, num: int, dim: int, gen: torch.Generator):
        super().__init__(num, dim)
        with torch.no_grad():
            self.weight.normal_(0.0, 0.1 / dim, generator=gen)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the last axis.

    Train mode normalizes with the batch mean and the biased batch variance
    over every leading axis (``E[x^2] - E[x]^2``, clipped at 0, flax's fast
    variance) and moves the running statistics by
    ``0.9 * running + 0.1 * batch``, the variance biased too, which is where
    ``nn.BatchNorm1d`` (unbiased) differs. Eval mode uses the running
    statistics."""

    def __init__(self, dim: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            flat = x.reshape(-1, x.shape[-1])
            mean = flat.mean(0)
            var = ((flat * flat).mean(0) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * scale + self.bias


def dropout(x: torch.Tensor, rate: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with the keep mask drawn from ``gen``: kept entries
    scaled by ``1 / (1 - rate)`` (flax ``nn.Dropout``)."""
    if gen is None:
        raise ValueError("train-mode dropout needs a torch.Generator")
    keep_prob = 1.0 - rate
    keep = torch.bernoulli(torch.full_like(x, keep_prob), generator=gen)
    return torch.where(keep.bool(), x / keep_prob, 0.0)


class PolyLinear(nn.Module):
    """Configurable MLP: ``layer_config=[100, 50, 2]`` is Linear(100, 50), act,
    Linear(50, 2); `BatchNorm` before the activation every
    ``apply_batch_norm_every`` layers, or after the last layer when -1;
    ``output_fn`` at the end. In train mode, ``input_dropout`` drops inputs
    with the keep mask drawn from the ``gen`` passed to `forward`."""

    def __init__(self, layer_config: Sequence[int], gen: torch.Generator, *,
                 activation_fn="relu", output_fn="relu",
                 input_dropout: Optional[float] = None,
                 apply_batch_norm_every: int = 0,
                 torch_default_init: bool = False):
        super().__init__()
        if len(layer_config) < 2:
            raise ValueError(f"PolyLinear needs in and out dims, got "
                             f"{list(layer_config)}")
        self.act = get_activation_fn(activation_fn)
        self.out_fn = get_activation_fn(output_fn)
        self.input_dropout = input_dropout
        dims = list(layer_config)
        self.apply_batch_norm_every = apply_batch_norm_every
        self.linears = nn.ModuleList(
            linear(a, b, gen, torch_default_init=torch_default_init)
            for a, b in zip(dims[:-1], dims[1:]))
        every = apply_batch_norm_every
        # batch_norm[i] follows linears[i]; mode -1 puts one after the last
        self.batch_norm = nn.ModuleDict({
            str(i): BatchNorm(d)
            for i, d in enumerate(dims[1:])
            if (every > 0 and (i + 1) % every == 0)
            or (every == -1 and i == len(dims) - 2)})

    def forward(self, x: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.training and self.input_dropout is not None:
            x = dropout(x, self.input_dropout, gen)
        n = len(self.linears)
        for i, lin in enumerate(self.linears):
            x = lin(x)
            if str(i) in self.batch_norm:
                x = self.batch_norm[str(i)](x)
            if i < n - 1:
                x = self.act(x)
        if self.out_fn is not None:
            x = self.out_fn(x)
        return x


class TagEmbeddingBag(nn.Module):
    """Masked-mean embedding of padded tag id rows (pad id == n_tags), i.e.
    ``nn.EmbeddingBag(mode="mean")`` that skips the padding."""

    def __init__(self, n_tags: int, dim: int, gen: torch.Generator):
        super().__init__()
        self.n_tags = n_tags
        self.embedding = Embedding(n_tags, dim, gen)

    def forward(self, tags: torch.Tensor) -> torch.Tensor:
        mask = (tags < self.n_tags).unsqueeze(-1)
        emb = self.embedding(tags.clamp(max=self.n_tags - 1))
        summed = torch.where(mask, emb, 0.0).sum(dim=-2)
        return summed / mask.sum(dim=-2).clamp(min=1)


class FeatureEmbeddingModule(nn.Module):
    """Embed one feature of an entity from its device table: categorical
    codes through an `Embedding`, tag rows through a `TagEmbeddingBag`,
    numeric rows through a PolyLinear ``[width, *pre, embedding_dim]``;
    then the optional post PolyLinear."""

    def __init__(self, table: torch.Tensor, kind: str, gen: torch.Generator,
                 *, n_categories: int = 0,
                 embedding_dim: Optional[int] = None,
                 pre_embedding_layers: Optional[Sequence[int]] = None,
                 post_embedding_layers: Optional[Sequence[int]] = None,
                 activation_fn: str = "relu"):
        super().__init__()
        self.register_buffer("table", table, persistent=False)
        self.kind = kind
        self.embedding = None
        self.pre_embedding = None
        self.post_embedding = None
        if kind in ("categorical", "tag"):
            if embedding_dim is None:
                raise ValueError(f"{kind} feature needs embedding_dim")
            cls = Embedding if kind == "categorical" else TagEmbeddingBag
            self.embedding = cls(n_categories, embedding_dim, gen)
            out = embedding_dim
        else:
            width = int(math.prod(table.shape[1:])) if table.ndim > 1 else 1
            cfg = [width, *(pre_embedding_layers or [])]
            if embedding_dim is not None:
                cfg.append(embedding_dim)
            if len(cfg) > 1:
                self.pre_embedding = PolyLinear(
                    cfg, gen, activation_fn=activation_fn,
                    output_fn=activation_fn)
            out = cfg[-1]
        if post_embedding_layers:
            self.post_embedding = PolyLinear(
                [out, *post_embedding_layers], gen,
                activation_fn=activation_fn, output_fn=activation_fn)

    def forward(self, idxs: torch.Tensor) -> torch.Tensor:
        raw = self.table[idxs.long()]
        if self.embedding is not None:
            x = self.embedding(raw.long() if self.kind == "categorical"
                               else raw)
        else:
            x = raw.float()
            if x.shape == idxs.shape:  # scalar features -> width-1 vectors
                x = x.unsqueeze(-1)
            x = x.reshape(*idxs.shape, -1)
            if self.pre_embedding is not None:
                x = self.pre_embedding(x)
        if self.post_embedding is not None:
            x = self.post_embedding(x)
        return x


# Bag-vs-densify break-even of the JAX package (calibrated on a TPU; the
# port keeps it as a parameter until a card measurement sets its own):
# gather kernel rows when factor * max_row_len <= n_cols.
BAG_BREAK_EVEN_FACTOR = 2048
# densify budget: past it the bag path is taken if its gather is smaller
DENSIFY_MAX_BYTES = 2 << 30
# First layer of the non-bag path from the CSR rows with K6/K7
# (`ops.spmm.spmm_onehot`) instead of densify + matmul with K5; off by
# default, as the JAX package's flag (its "auto" means "on a TPU", and the
# port has no TPU, so only a truthy value turns it on).
INTERACTION_SPMM = False


class InteractionTower(nn.Module):
    """MLP over an entity's train-interaction row with a sparse first layer.

    The first layer is ``row @ kernel + bias`` over the 0/1 row of the train
    CSR. The bag path gathers the row's kernel rows and sums them (K1 row
    gather, then a masked sum; its backward is autograd's scatter-add); the
    dense path densifies the rows (K1, then a scatter into zeros) and
    multiplies, with K5 for the kernel's gradient; with `INTERACTION_SPMM`
    the non-bag path runs K1 then K6, with K7 for the gradient. Which one
    runs follows the JAX package's static gate, with the break-even factor
    a parameter. The JAX tower's ``normalize``, ``scale`` and torch-default
    init serve DMF and DropoutNet, not SBNet, and come with those models."""

    def __init__(self, csr: DeviceCSR, layer_sizes: Sequence[int],
                 gen: torch.Generator, *, activation_fn: str = "relu",
                 output_fn: Optional[str] = "relu",
                 bag_break_even_factor: int = BAG_BREAK_EVEN_FACTOR):
        super().__init__()
        if not layer_sizes:
            raise ValueError("InteractionTower needs at least one layer size")
        self.csr = csr
        self.bag_break_even_factor = bag_break_even_factor
        self.act = get_activation_fn(activation_fn)
        self.out_fn = get_activation_fn(output_fn)
        h = layer_sizes[0]
        n = csr.n_cols
        # kernel kept [n_cols, h] (the flax layout): rows are what the bag
        # path gathers, and the dense path multiplies by it directly
        self.kernel = nn.Parameter(torch.empty(n, h))
        self.bias = nn.Parameter(torch.zeros(h))
        _uniform_(self.kernel, math.sqrt(6.0 / n), gen)  # kaiming, zero bias
        self.rest = None
        if len(layer_sizes) > 1:
            self.rest = PolyLinear(list(layer_sizes), gen,
                                   activation_fn=activation_fn,
                                   output_fn=output_fn)

    def use_bag(self, n_rows: int) -> bool:
        h = self.kernel.shape[1]
        max_len = max(self.csr.max_row_len, 1)
        bag = self.bag_break_even_factor * max_len <= self.csr.n_cols
        dense_bytes = n_rows * self.csr.n_cols * 4
        if not bag and dense_bytes > DENSIFY_MAX_BYTES:
            bag = n_rows * max_len * h * 4 < dense_bytes
        return bag

    def forward(self, idxs: torch.Tensor) -> torch.Tensor:
        h = self.kernel.shape[1]
        if self.use_bag(idxs.numel()):
            cols, mask = csr_row_gather(self.csr, idxs)  # [..., L]
            pre = (self.kernel[cols.long()] * mask.unsqueeze(-1)).sum(dim=-2)
        elif INTERACTION_SPMM:
            cols, mask = csr_row_gather(self.csr, idxs.reshape(-1))
            pre = spmm_onehot(cols, mask, self.kernel).reshape(*idxs.shape, h)
        else:
            vec = csr_rows_to_dense(self.csr, idxs.reshape(-1))
            pre = dense_first_matmul(vec, self.kernel).reshape(*idxs.shape, h)
        x = pre + self.bias
        if self.rest is None:
            return self.out_fn(x) if self.out_fn is not None else x
        return self.rest(self.act(x))
