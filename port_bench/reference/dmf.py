"""Plain reference of Deep Matrix Factorization, in f32 with TF32 off.

Each tower is a dense layer over the entity's 0/1 train row (the user's row
over items, the item's column over users), a relu, then dense layers
through ``*_mid_layers`` to ``final_dimension`` with a relu between them
and none at the end. The score is the cosine of the two representations,
clamped below at ``mu``; ranking takes the cosine's dot parts. Weights
kaiming-uniform with zero biases (the program's initialiser). Ranking
ranks the clamped scores, equal scores in catalog order.
"""
from __future__ import annotations

import math

import torch

from reference.common import Rows, l2_normalize

EPS = 1e-8


def check_supported(conf: dict) -> None:
    m = conf["model"]
    if (m.get("normalize_interactions") or m.get("normalize_representations")
            or m.get("use_output_activation_fn")):
        raise ValueError("the reference follows dmf_onion18's towers")


def _towers(conf: dict) -> dict:
    m = conf["model"]
    return {"user_nn": [*m.get("u_mid_layers", []), m["final_dimension"]],
            "item_nn": [*m.get("i_mid_layers", []), m["final_dimension"]]}


def parameter_spec(conf: dict, sizes: dict) -> list:
    check_supported(conf)
    n_cols = {"user_nn": sizes["n_items"], "item_nn": sizes["n_users"]}
    spec = []
    for tower, dims in _towers(conf).items():
        n = n_cols[tower]
        spec += [(f"{tower}.kernel", (n, dims[0]), "uniform",
                  math.sqrt(6.0 / n)),
                 (f"{tower}.bias", (dims[0],), "const", 0.0)]
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            spec += [(f"{tower}.rest.linears.{i}.weight", (b, a), "uniform",
                      math.sqrt(6.0 / a)),
                     (f"{tower}.rest.linears.{i}.bias", (b,), "const", 0.0)]
    return spec


def context(data: dict, dev) -> dict:
    train = torch.as_tensor(data["train"], device=dev)
    return {"user_nn": Rows(train, data["n_users"], data["n_items"]),
            "item_nn": Rows(train.flip(1), data["n_items"], data["n_users"])}


def _tower(w: dict, tower: str, rows: Rows, ids: torch.Tensor, n_layers: int
           ) -> torch.Tensor:
    shape = ids.shape
    x = rows.dense(ids) @ w[f"{tower}.kernel"] + w[f"{tower}.bias"]
    for i in range(n_layers):
        x = torch.relu(x)
        x = (x @ w[f"{tower}.rest.linears.{i}.weight"].T
             + w[f"{tower}.rest.linears.{i}.bias"])
    return x.reshape(*shape, x.shape[-1])


def train_forward(w: dict, conf: dict, ctx: dict, users: torch.Tensor,
                  items: torch.Tensor, gen: torch.Generator):
    dims = _towers(conf)
    u = l2_normalize(_tower(w, "user_nn", ctx["user_nn"], users,
                            len(dims["user_nn"]) - 1), EPS)
    i = l2_normalize(_tower(w, "item_nn", ctx["item_nn"], items,
                            len(dims["item_nn"]) - 1), EPS)
    cos = torch.einsum("be,bce->bc", u, i)
    return cos.clamp(min=conf["model"].get("mu", 1e-6)), torch.zeros(
        (), device=cos.device)


def eval_parts(w: dict, conf: dict, ctx: dict, chunk: int = 8192):
    dims = _towers(conf)
    n_items = ctx["item_nn"].n_rows
    dev = w["item_nn.kernel"].device
    out = []
    for start in range(0, n_items, chunk):
        ids = torch.arange(start, min(start + chunk, n_items), device=dev)
        out.append(l2_normalize(_tower(w, "item_nn", ctx["item_nn"], ids,
                                       len(dims["item_nn"]) - 1), EPS))

    def user_fn(users):
        return l2_normalize(_tower(w, "user_nn", ctx["user_nn"], users,
                                   len(dims["user_nn"]) - 1), EPS)

    return user_fn, torch.cat(out)


def scores(conf: dict, dots: torch.Tensor) -> torch.Tensor:
    """The model's scores: the cosine (the dot of the normalized parts)
    clamped below at ``mu``."""
    return dots.clamp(min=conf["model"].get("mu", 1e-6))
