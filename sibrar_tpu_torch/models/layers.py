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
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from sibrar_tpu_torch.ops.dw import dense_first_matmul
from sibrar_tpu_torch.parallel import distributed as pdist
from sibrar_tpu_torch.parallel.mesh import (
    batch_sharded,
    local_draw,
    reduce_batch,
)
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


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)`` with tensor bounds, so
    a value exactly at a bound passes half its gradient, as in JAX
    (``torch.clamp`` passes all of it)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def embedding_init_(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """N(0, 0.1 / dim) in place, ``dim`` the last axis (JAX
    ``embedding_init``; for an ``nn.Linear`` weight ``[out, in]`` pass its
    transpose's last axis, ``out``)."""
    with torch.no_grad():
        return t.normal_(0.0, 0.1 / t.shape[-1], generator=gen)


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


def lookup(table: torch.Tensor, idxs: torch.Tensor) -> torch.Tensor:
    """``table[idxs]`` as `spmm_onehot` over rows of one live slot (K6
    forward, K7 backward on the card), differentiable in ``table``."""
    flat = idxs.reshape(-1, 1).to(torch.int32)
    mask = torch.ones(flat.shape, dtype=torch.bool, device=flat.device)
    out = spmm_onehot(flat, mask, table)
    return out.reshape(*idxs.shape, table.shape[-1])


class Embedding(nn.Embedding):
    """``nn.Embedding`` with the reference's N(0, 0.1 / dim) init, looked
    up as `spmm_onehot` over rows of one live slot: K6 forward, K7 backward
    on the card. Autograd's own backward of an embedding gather
    (``embedding_dense_backward``) adds duplicate ids in another order on
    each call on the card; K7 sums each row in a fixed order, so a train
    step repeats bit for bit.

    Row injection (sparse-table training, ``train/row_adam.py``): while
    ``rows`` is set (the trainer gathers ``weight[idxs]`` without autograd
    and sets the rows as a leaf that requires grad), the call returns the
    injected rows instead of gathering, so the backward never builds a
    dense ``[n, d]`` gradient. The rows must be the gather of exactly the
    ``idxs`` the call receives; a shape that differs raises (JAX's
    ``Embedding`` check). ``init(weight, gen)``, when given, fills the
    table in place of the N(0, 0.1 / dim) draw."""

    def __init__(self, num: int, dim: int, gen: torch.Generator,
                 init: Optional[Callable] = None):
        super().__init__(num, dim)
        self.rows: Optional[torch.Tensor] = None
        with torch.no_grad():
            if init is None:
                self.weight.normal_(0.0, 0.1 / dim, generator=gen)
            else:  # init(weight, gen) fills the table in place
                init(self.weight, gen)

    def forward(self, idxs: torch.Tensor) -> torch.Tensor:
        if self.rows is None:
            return lookup(self.weight, idxs)
        expect = (*idxs.shape, self.embedding_dim)
        if tuple(self.rows.shape) != expect:
            raise ValueError(
                f"injected rows {tuple(self.rows.shape)} do not match the "
                f"gather {expect} for a table of {self.num_embeddings} rows: "
                f"table_index_map source mismatch")
        return self.rows


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the last axis.

    Train mode normalizes with the batch mean and the biased batch variance
    over every leading axis (``E[x^2] - E[x]^2``, clipped at 0, flax's fast
    variance) and moves the running statistics by
    ``0.9 * running + 0.1 * batch``, the variance biased too, which is where
    ``nn.BatchNorm1d`` (unbiased) differs. Eval mode uses the running
    statistics. In a data-parallel step (`parallel.mesh.batch_shard`) the
    sums of ``x``, ``x^2`` and the row count are reduced over the batch's
    ranks first, so the statistics are the global batch's, as GSPMD gives
    them in JAX."""

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
            if batch_sharded():  # the global batch's statistics
                sums = reduce_batch(torch.stack([flat.sum(0),
                                                 (flat * flat).sum(0)]))
                count = reduce_batch(flat.new_tensor(float(flat.shape[0])))
                mean, mean_sq = sums / count
            else:
                mean = flat.mean(0)
                mean_sq = (flat * flat).mean(0)
            var = (mean_sq - mean * mean).clamp(min=0.0)
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
    scaled by ``1 / (1 - rate)`` (flax ``nn.Dropout``). In a data-parallel
    step the mask is the global batch's, this rank's rows of it."""
    if gen is None:
        raise ValueError("train-mode dropout needs a torch.Generator")
    keep_prob = 1.0 - rate
    keep = local_draw(lambda shape: torch.bernoulli(
        torch.full(shape, keep_prob, dtype=x.dtype, device=x.device),
        generator=gen), x.shape)
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
    ``nn.EmbeddingBag(mode="mean")`` that skips the padding; the masked sum
    is `spmm_onehot` (K6 / K7), so its gradient repeats bit for bit."""

    def __init__(self, n_tags: int, dim: int, gen: torch.Generator):
        super().__init__()
        self.n_tags = n_tags
        self.embedding = Embedding(n_tags, dim, gen)

    def forward(self, tags: torch.Tensor) -> torch.Tensor:
        mask = tags < self.n_tags
        width = tags.shape[-1]
        summed = spmm_onehot(
            tags.clamp(max=self.n_tags - 1).reshape(-1, width).to(
                torch.int32), mask.reshape(-1, width), self.embedding.weight)
        summed = summed.reshape(*tags.shape[:-1], summed.shape[-1])
        return summed / mask.sum(dim=-1, keepdim=True).clamp(min=1)


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
            out = post_embedding_layers[-1]
        self.output_dim = out

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
    CSR. The bag path sums the row's kernel rows: K1 row gather, then K6,
    with K7 for the kernel's gradient (JAX gathers and sums, the same
    function; K6 sums a row of more than 32 live slots by runs, within the
    f32 sum bound of a serial sum). The dense path densifies the rows (K1,
    then a scatter into zeros) and multiplies, with K5 for the kernel's
    gradient; with `INTERACTION_SPMM` the non-bag path takes the bag
    path's K1, K6 and K7. Which one runs follows the JAX package's static
    gate, with the break-even factor a parameter.

    ``normalize`` divides each row by its L2 norm, ``max(sqrt(nnz),
    1e-8)``: the bag and spmm paths divide the row sum, the dense path the
    densified row before the matmul (so K5 gets rows that are not 0/1). ``scale`` (``idxs.shape + (1,)``, given
    to `forward`) multiplies the pre-bias sum on every path: DropoutNet's
    preference dropout. ``torch_default_init`` draws the kernel and the bias
    from U(+-1/sqrt(n_cols)) and builds ``rest`` with the same init;
    otherwise the kernel is kaiming-uniform and the bias zero. The kernel is
    drawn first, then the bias (only under ``torch_default_init``), then
    ``rest``.

    Tensor parallel (`set_row_slice`, from `parallel.mesh.shard_tower_state`):
    the kernel holds rows ``[lo, hi)`` of the full one, every path keeps
    the row's columns in that range (the dense path densifies only them),
    and the ``[R, h]`` partial sums add up over the item group in the
    forward; the backward passes the gradient through unchanged
    (Megatron's row-parallel layer), so K5 / K7 compute this slice's
    kernel gradient. Every rank of the item group must run the tower on the
    same rows."""

    def __init__(self, csr: DeviceCSR, layer_sizes: Sequence[int],
                 gen: torch.Generator, *, activation_fn: str = "relu",
                 output_fn: Optional[str] = "relu", normalize: bool = False,
                 torch_default_init: bool = False,
                 bag_break_even_factor: int = BAG_BREAK_EVEN_FACTOR):
        super().__init__()
        if not layer_sizes:
            raise ValueError("InteractionTower needs at least one layer size")
        self.csr = csr
        self.normalize = normalize
        self.bag_break_even_factor = bag_break_even_factor
        self.act = get_activation_fn(activation_fn)
        self.out_fn = get_activation_fn(output_fn)
        h = layer_sizes[0]
        n = csr.n_cols
        # kernel kept [n_cols, h] (the flax layout): rows are what the bag
        # path gathers, and the dense path multiplies by it directly
        self.kernel = nn.Parameter(torch.empty(n, h))
        self.bias = nn.Parameter(torch.zeros(h))
        if torch_default_init:
            _uniform_(self.kernel, 1.0 / math.sqrt(n), gen)
            _uniform_(self.bias, 1.0 / math.sqrt(n), gen)
        else:  # kaiming, zero bias
            _uniform_(self.kernel, math.sqrt(6.0 / n), gen)
        # kernel rows [lo, hi) of the full one, partial sums reduced over
        # the group: all of them on one device
        self.row_slice: tuple = (0, n, pdist.SOLO)
        self.rest = None
        if len(layer_sizes) > 1:
            self.rest = PolyLinear(list(layer_sizes), gen,
                                   activation_fn=activation_fn,
                                   output_fn=output_fn,
                                   torch_default_init=torch_default_init)

    def set_row_slice(self, lo: int, hi: int, group) -> None:
        """The kernel now holds rows ``[lo, hi)``; partial sums reduce over
        ``group``."""
        self.row_slice = (lo, hi, group)

    def use_bag(self, n_rows: int) -> bool:
        h = self.kernel.shape[1]
        max_len = max(self.csr.max_row_len, 1)
        bag = self.bag_break_even_factor * max_len <= self.csr.n_cols
        dense_bytes = n_rows * self.csr.n_cols * 4
        if not bag and dense_bytes > DENSIFY_MAX_BYTES:
            bag = n_rows * max_len * h * 4 < dense_bytes
        return bag

    def forward(self, idxs: torch.Tensor,
                scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.kernel.shape[1]
        pre = self._first_layer(idxs.reshape(-1))
        pre = pre.reshape(*idxs.shape, h)
        if scale is not None:
            pre = pre * scale
        x = pre + self.bias
        if self.rest is None:
            return self.out_fn(x) if self.out_fn is not None else x
        return self.rest(self.act(x))

    def _first_layer(self, rows: torch.Tensor) -> torch.Tensor:
        """``[R, h]`` first-layer sums of ``rows`` from the kernel rows
        this module holds (`row_slice`), reduced over its group; the path
        (bag, dense, spmm) follows the full row length."""
        lo, hi, group = self.row_slice
        cols, mask = csr_row_gather(self.csr, rows)
        lc = cols - lo
        lmask = mask & (lc >= 0) & (lc < hi - lo)
        lc = torch.where(lmask, lc, 0)
        nnz = mask.sum(-1, keepdim=True).float()
        if self.use_bag(rows.numel()) or INTERACTION_SPMM:
            pre = spmm_onehot(lc, lmask, self.kernel)
            if self.normalize:
                pre = pre / nnz.sqrt().clamp(min=1e-8)
        else:
            vec = torch.zeros((rows.shape[0], hi - lo), device=rows.device)
            vec.scatter_add_(1, lc.long(), lmask.float())
            if self.normalize:  # the full 0/1 row's norm, sqrt(nnz)
                vec = vec / nnz.sqrt().clamp(min=1e-8)
            pre = dense_first_matmul(vec, self.kernel)
        return pdist.reduce_forward(pre, group)


class InteractionVectorModule(nn.Module):
    """Dense 0/1 train-interaction rows ``[..., n_cols]`` of a batch of
    entity ids: K1 row gather, then a scatter into zeros
    (`ops.sparse.csr_rows_to_dense`). A constant of the data: nothing
    trains."""

    def __init__(self, csr: DeviceCSR):
        super().__init__()
        self.csr = csr

    def forward(self, idxs: torch.Tensor) -> torch.Tensor:
        return csr_rows_to_dense(self.csr, idxs)


def interaction_tower_from(device_data, entity: str,
                           layer_sizes: Sequence[int], gen: torch.Generator,
                           **kwargs) -> InteractionTower:
    """The `InteractionTower` over ``entity``'s train-interaction rows
    (``device_data.user_inter_csr`` or ``item_inter_csr``)."""
    csr = (device_data.user_inter_csr if entity == "user"
           else device_data.item_inter_csr)
    return InteractionTower(csr, layer_sizes, gen, **kwargs)


def feature_module_from(dataset, device_data, entity: str, name: str,
                        gen: torch.Generator,
                        **kwargs) -> FeatureEmbeddingModule:
    """The `FeatureEmbeddingModule` of ``entity``'s feature ``name``: the
    host split's `FeatureTable` gives its kind and category count, the
    device data its table."""
    feats = (dataset.user_features if entity == "user"
             else dataset.item_features)
    tables = (device_data.user_features if entity == "user"
              else device_data.item_features)
    f = feats[name]
    return FeatureEmbeddingModule(tables[name], f.kind, gen,
                                  n_categories=f.n_categories, **kwargs)
