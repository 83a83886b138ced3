"""Plain reference of SiBraR (the single-branch network) with a plain
interaction user tower, in f32 with TF32 off.

The user tower is one dense layer over the user's 0/1 train row (no
activation). Each item modality projects to ``common_modality_dim``: the
item's 0/1 train column through a dense layer and a relu, each item vector
through a dense layer and a relu, the genre tags as the mean of their
embedding rows. One shared MLP (``single_branch_hidden_layers`` then
``shared_common_dim``; batch norm after every second layer, relu between
layers and at the end) encodes the L2-normalized projections.

Training routes two distinct modalities to each row of the ``[B, 1 + n]``
item batch by balanced routing: position ``t`` of the flat batch takes the
ordered pair ``slots[(t - delta) mod P]``, every ordered pair of distinct
modalities once, ``delta`` uniform in [0, P). Input dropout drops the MLP's
inputs; the item representation is the mean of the two encodings, and the
symmetric InfoNCE between them over each row's candidates, times the
regularization weight, is added to the BPR loss. Evaluation averages the
encodings of every modality, with batch norm's running statistics.

Weights: the interaction layers kaiming-uniform with zero bias, the vector
layers kaiming-uniform with zero bias, the shared MLP U(+-1/sqrt(fan_in))
for weights and biases, tag embeddings N(0, 0.1 / dim), batch norm 1 and 0
(the program's initialisers).
"""
from __future__ import annotations

import math

import torch

from reference.common import (
    Rows,
    batch_norm_eval,
    batch_norm_train,
    info_nce,
    l2_normalize,
)


def _item_modalities(conf: dict) -> list:
    return [f["feature_name"] for f in conf["model"]["item"]["features"]]


def _sb_dims(conf: dict) -> list:
    item = conf["model"]["item"]
    return [item["common_modality_dim"], *item["single_branch_hidden_layers"],
            conf["model"]["shared_common_dim"]]


def _bn_layers(conf: dict) -> list:
    item = conf["model"]["item"]
    n = len(_sb_dims(conf)) - 1
    every = item["apply_batch_norm_every"]
    return [i for i in range(n) if every > 0 and (i + 1) % every == 0]


def check_supported(conf: dict) -> None:
    m = conf["model"]
    user, item = m["user"], m["item"]
    if user.get("features") or user["feature_name"] != "interactions":
        raise ValueError("the reference's user tower is a plain "
                         "interaction layer")
    if item["embedding_regularization_type"] != "pairwise_single":
        raise ValueError("the reference routes pairs of modalities")
    if not (item["apply_batch_normalization"]
            and item["apply_batch_norm_every"] > 0
            and item["normalize_single_branch_input"]
            and item["apply_output_activation"]):
        raise ValueError("the reference follows SiBraR-huge's branch")


def parameter_spec(conf: dict, sizes: dict) -> list:
    """``(name, shape, init, scale)`` of every parameter, in the program's
    names."""
    check_supported(conf)
    m = conf["model"]
    nu, ni = sizes["n_users"], sizes["n_items"]
    d_user = m["user"]["embedding_dim"]
    d_mod = m["item"]["common_modality_dim"]
    spec = [("user_module.net.kernel", (ni, d_user), "uniform",
             math.sqrt(6.0 / ni)),
            ("user_module.net.bias", (d_user,), "const", 0.0)]
    for j, name in enumerate(_item_modalities(conf)):
        pre = f"item_module.modalities.{j}"
        if name == "interactions":
            spec += [(f"{pre}.kernel", (nu, d_mod), "uniform",
                      math.sqrt(6.0 / nu)),
                     (f"{pre}.bias", (d_mod,), "const", 0.0)]
        elif name == "genres":
            spec.append((f"{pre}.embedding.embedding.weight",
                         (sizes["n_tags"], d_mod), "normal", 0.1 / d_mod))
        else:
            d = sizes["vectors"][name]
            spec += [(f"{pre}.pre_embedding.linears.0.weight", (d_mod, d),
                      "uniform", math.sqrt(6.0 / d)),
                     (f"{pre}.pre_embedding.linears.0.bias", (d_mod,),
                      "const", 0.0)]
    dims = _sb_dims(conf)
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        spec += [(f"item_module.sb_net.linears.{i}.weight", (b, a),
                  "uniform", 1.0 / math.sqrt(a)),
                 (f"item_module.sb_net.linears.{i}.bias", (b,), "uniform",
                  1.0 / math.sqrt(a))]
    for i in _bn_layers(conf):
        spec += [(f"item_module.sb_net.batch_norm.{i}.weight", (dims[i + 1],),
                  "const", 1.0),
                 (f"item_module.sb_net.batch_norm.{i}.bias", (dims[i + 1],),
                  "const", 0.0)]
    return spec


def context(data: dict, dev) -> dict:
    """The data the towers read: the users' train rows over items, the
    items' train columns over users, the item vectors and tags."""
    train = torch.as_tensor(data["train"], device=dev)
    return {"user_rows": Rows(train, data["n_users"], data["n_items"]),
            "item_rows": Rows(train.flip(1), data["n_items"],
                              data["n_users"]),
            "vectors": {k: torch.as_tensor(v, device=dev)
                        for k, v in data["vectors"].items()},
            "tags": torch.as_tensor(data["tags"], device=dev).long(),
            "n_tags": data["n_tags"]}


def _user(w: dict, ctx: dict, users: torch.Tensor) -> torch.Tensor:
    x = ctx["user_rows"].dense(users)
    return x @ w["user_module.net.kernel"] + w["user_module.net.bias"]


def _project(w: dict, conf: dict, ctx: dict, j: int,
             items: torch.Tensor) -> torch.Tensor:
    """Modality ``j``'s ``[n, common_modality_dim]`` projection of the
    items ``[n]``."""
    name = _item_modalities(conf)[j]
    pre = f"item_module.modalities.{j}"
    if name == "interactions":
        x = ctx["item_rows"].dense(items)
        return torch.relu(x @ w[f"{pre}.kernel"] + w[f"{pre}.bias"])
    if name == "genres":
        tags = ctx["tags"][items]
        live = tags < ctx["n_tags"]
        emb = w[f"{pre}.embedding.embedding.weight"][
            tags.clamp(max=ctx["n_tags"] - 1)]
        summed = (emb * live.unsqueeze(-1)).sum(-2)
        return summed / live.sum(-1, keepdim=True).clamp(min=1)
    x = ctx["vectors"][name][items]
    return torch.relu(x @ w[f"{pre}.pre_embedding.linears.0.weight"].T
                      + w[f"{pre}.pre_embedding.linears.0.bias"])


def _branch(w: dict, conf: dict, x: torch.Tensor, train: bool,
            gen=None, stats=None) -> torch.Tensor:
    """The shared MLP over L2-normalized inputs ``[..., d]``."""
    item = conf["model"]["item"]
    x = l2_normalize(x, 1e-12)
    if train and item.get("single_branch_input_dropout"):
        keep = 1.0 - item["single_branch_input_dropout"]
        mask = torch.bernoulli(torch.full(x.shape, keep, device=x.device),
                               generator=gen)
        x = torch.where(mask > 0, x / keep, 0.0)
    n = len(_sb_dims(conf)) - 1
    bn = set(_bn_layers(conf))
    for i in range(n):
        pre = f"item_module.sb_net.linears.{i}"
        x = x @ w[f"{pre}.weight"].T + w[f"{pre}.bias"]
        if i in bn:
            bw = w[f"item_module.sb_net.batch_norm.{i}.weight"]
            bb = w[f"item_module.sb_net.batch_norm.{i}.bias"]
            if train:
                x = batch_norm_train(x, bw, bb)
            else:
                mean = torch.zeros_like(bw) if stats is None else stats[i][0]
                var = torch.ones_like(bw) if stats is None else stats[i][1]
                x = batch_norm_eval(x, bw, bb, mean, var)
        x = torch.relu(x)  # between layers, and the output activation
    return x


def routing_slots(n: int) -> torch.Tensor:
    """``[n (n - 1), 2]``: every ordered pair of distinct modalities once,
    row ``rho`` = ``(rho mod n, (rho mod n + 1 + (rho div n) mod (n - 1))
    mod n)``."""
    rows = []
    for rho in range(n * (n - 1)):
        a = rho % n
        rows.append([a, (a + 1 + (rho // n) % (n - 1)) % n])
    return torch.tensor(rows)


def train_forward(w: dict, conf: dict, ctx: dict, users: torch.Tensor,
                  items: torch.Tensor, gen: torch.Generator):
    """``(logits [B, 1 + n], regularization loss)`` of a train step."""
    item = conf["model"]["item"]
    u = _user(w, ctx, users)
    n_mod = len(_item_modalities(conf))
    slots = routing_slots(n_mod).to(items.device)
    p = slots.shape[0]
    flat = items.reshape(-1)
    t = flat.numel()
    delta = torch.randint(0, p, (), generator=gen, device=items.device)
    pair = slots[(torch.arange(t, device=items.device) - delta) % p]
    proj = torch.stack([_project(w, conf, ctx, j, flat)
                        for j in range(n_mod)])  # [M, t, d]
    rows = torch.arange(t, device=items.device)
    picked = torch.stack([proj[pair[:, 0], rows], proj[pair[:, 1], rows]],
                         dim=1)  # [t, 2, d]
    picked = picked.reshape(*items.shape, 2, picked.shape[-1])
    enc = _branch(w, conf, picked, True, gen)
    reg = item["regularization_weight"] * info_nce(
        enc[..., 0, :], enc[..., 1, :], item["regularization_temperature"])
    i = enc.mean(-2)
    return torch.einsum("be,bce->bc", u, i), reg


def eval_parts(w: dict, conf: dict, ctx: dict, chunk: int = 8192):
    """``(user_fn, items [C, d])``: scores are ``user_fn(users) @
    items.T``."""
    n_items = ctx["item_rows"].n_rows
    n_mod = len(_item_modalities(conf))
    out = []
    for start in range(0, n_items, chunk):
        ids = torch.arange(start, min(start + chunk, n_items),
                           device=ctx["tags"].device)
        x = torch.stack([_project(w, conf, ctx, j, ids)
                         for j in range(n_mod)], dim=-2)
        out.append(_branch(w, conf, x, False).mean(-2))
    return (lambda users: _user(w, ctx, users)), torch.cat(out)


def scores(conf: dict, dots: torch.Tensor) -> torch.Tensor:
    """The model's scores are the dot products."""
    return dots
