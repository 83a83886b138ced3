"""Plain PyTorch pieces every reference shares: sparse rows, membership,
the uniform negative sampler, the losses, batch norm, AdamW, the training
steps the check follows and the full-catalog evaluation.

Nothing here imports the program or JAX. Random draws come from a
``torch.Generator`` seeded as the program's trainer is, in the program's
order and shapes (the epoch permutation, then per step the negatives'
candidates and whatever the family's forward draws), so the reference sees
the same negatives, routing and dropout masks from the seed alone.
"""
from __future__ import annotations

import statistics

import torch
import torch.nn.functional as F

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class Rows:
    """The 0/1 rows of a pair list ``[n, 2]`` (row id, column id), kept as
    a CSR of sorted keys on the device."""

    def __init__(self, pairs: torch.Tensor, n_rows: int, n_cols: int):
        keys = torch.sort(pairs[:, 0].long() * n_cols
                          + pairs[:, 1].long()).values
        self.keys = keys
        self.cols = keys % n_cols
        counts = torch.bincount(keys // n_cols, minlength=n_rows)
        self.indptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts,
                                                                   0)])
        self.n_rows, self.n_cols = n_rows, n_cols

    def lengths(self, rows: torch.Tensor) -> torch.Tensor:
        rows = rows.long()
        return self.indptr[rows + 1] - self.indptr[rows]

    def dense(self, rows: torch.Tensor) -> torch.Tensor:
        """``[len(rows), n_cols]`` f32 0/1 rows."""
        rows = rows.reshape(-1).long()
        lens = self.lengths(rows)
        out = torch.zeros(rows.numel(), self.n_cols, device=rows.device)
        if int(lens.sum()) == 0:
            return out
        which = torch.repeat_interleave(
            torch.arange(rows.numel(), device=rows.device), lens)
        first = torch.cumsum(lens, 0) - lens
        at = (torch.arange(which.numel(), device=rows.device)
              - first[which] + self.indptr[rows][which])
        out[which, self.cols[at]] = 1.0
        return out

    def contains(self, rows: torch.Tensor, cols: torch.Tensor
                 ) -> torch.Tensor:
        """Whether ``(rows[b], cols[b, j])`` is a pair."""
        q = rows.long().unsqueeze(-1) * self.n_cols + cols.long()
        at = torch.searchsorted(self.keys, q.reshape(-1)).clamp(
            max=max(self.keys.numel() - 1, 0))
        hit = self.keys[at] == q.reshape(-1) if self.keys.numel() else (
            torch.zeros_like(q.reshape(-1), dtype=torch.bool))
        return hit.view(q.shape)


def l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    """``x / max(||x||, eps)`` along the last axis."""
    return x / x.norm(dim=-1, keepdim=True).clamp(min=eps)


def batch_norm_train(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """Batch statistics over every leading axis, the biased variance."""
    flat = x.reshape(-1, x.shape[-1])
    mean = flat.mean(0)
    var = flat.var(0, unbiased=False)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def batch_norm_eval(x, w, b, mean, var, eps: float = 1e-5):
    return (x - mean) / torch.sqrt(var + eps) * w + b


def bpr(logits: torch.Tensor) -> torch.Tensor:
    """Mean of ``-log sigmoid(pos - neg)`` over every negative."""
    return -F.logsigmoid(logits[:, :1] - logits[:, 1:]).mean()


def info_nce(a: torch.Tensor, b: torch.Tensor, temperature: float
             ) -> torch.Tensor:
    """Symmetric InfoNCE over ``[..., m, d]`` pairs, the contrast set the
    last-but-one axis: the mean cross entropy of each row's diagonal, both
    ways."""
    logits = a @ b.transpose(-1, -2) / temperature
    m = logits.shape[-1]
    target = torch.arange(m, device=a.device).expand(logits.shape[:-1])
    ab = F.cross_entropy(logits.reshape(-1, m), target.reshape(-1))
    ba = F.cross_entropy(logits.transpose(-1, -2).reshape(-1, m),
                         target.reshape(-1))
    return ab + ba


def sample_negatives(gen: torch.Generator, users: torch.Tensor,
                     positives: Rows, n_catalog: int, n_neg: int,
                     n_rounds: int = 8) -> torch.Tensor:
    """Uniform negatives ``[B, n_neg]``: ``n_rounds + 1`` candidate sets
    drawn at once; each round replaces a candidate that is a positive of
    its user, or repeats an earlier candidate of its row, with the next
    set's."""
    draws = torch.randint(0, n_catalog, (n_rounds + 1, users.shape[0], n_neg),
                          generator=gen, device=users.device,
                          dtype=torch.int32)
    cand = draws[0]
    earlier = torch.ones(n_neg, n_neg, dtype=torch.bool,
                         device=users.device).tril(-1)
    for fresh in draws[1:]:
        repeat = ((cand.unsqueeze(2) == cand.unsqueeze(1)) & earlier).any(-1)
        bad = positives.contains(users, cand) | repeat
        cand = torch.where(bad, fresh, cand)
    return cand


class AdamW:
    """Adam (b1 0.9, b2 0.999, eps 1e-8 outside the root) with the bias
    correction, then the decoupled decay ``wd * p`` added to the update,
    then ``p -= lr * update``."""

    def __init__(self, params: dict, lr: float, wd: float):
        self.params, self.lr, self.wd = params, lr, wd
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.count += 1
        c1 = 1 - ADAM_B1 ** self.count
        c2 = 1 - ADAM_B2 ** self.count
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k] = ADAM_B1 * self.mu[k] + (1 - ADAM_B1) * g
            self.nu[k] = ADAM_B2 * self.nu[k] + (1 - ADAM_B2) * g * g
            upd = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2)
                                       + ADAM_EPS) + self.wd * p
            p -= self.lr * upd


def train_readings(family, conf: dict, data: dict, weights: dict, seed: int,
                   n_steps: int, fault: str | None = None) -> dict:
    """The first ``n_steps`` steps of training from ``weights`` on the
    epoch permutation of ``data['train']``: each step's loss, each leaf's
    first gradient norm, each leaf's change norm after the last step.
    ``fault="half_batch"`` takes each step's loss over the first half of
    its rows (a planted fault, for the limits)."""
    dev = weights[next(iter(weights))].device
    learn, loader = conf["learn"], conf["loader"]
    if learn["optimizer"] != "adamw" or learn["rec_loss"] != "bpr":
        raise ValueError("the reference trains adamw with the bpr loss")
    if conf["dataset"]["negative_sampling_strategy"] != "uniform":
        raise ValueError("the reference samples uniform negatives")
    params = {k: v.clone().requires_grad_() for k, v in weights.items()}
    opt = AdamW(params, learn["lr"], learn["wd"])
    train = torch.as_tensor(data["train"], device=dev)
    positives = Rows(train, data["n_users"], data["n_items"])
    ctx = family.context(data, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    perm = torch.randperm(train.shape[0], generator=gen, device=dev)
    bs, n_neg = loader["batch_size"], conf["dataset"]["n_negative_samples"]
    losses, first_grad = [], {}
    for k in range(n_steps):
        rows = train[perm[k * bs:(k + 1) * bs]]
        users, pos = rows[:, 0], rows[:, 1]
        negs = sample_negatives(gen, users, positives, data["n_items"],
                                n_neg)
        items = torch.cat([pos.unsqueeze(1), negs.long()], dim=1)
        logits, reg = family.train_forward(params, conf, ctx, users, items,
                                           gen)
        if fault == "half_batch":
            half = logits.shape[0] // 2
            loss = bpr(logits[:half]) + reg
        else:
            loss = bpr(logits) + reg
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()), allow_unused=True)))
        grads = {n: g if g is not None else torch.zeros_like(params[n])
                 for n, g in grads.items()}
        if k == 0:
            first_grad = {n: float(g.norm()) for n, g in grads.items()}
        opt.step(grads)
        losses.append(float(loss.detach()))
    change = {n: float((p.detach() - weights[n]).norm())
              for n, p in params.items()}
    return {"loss": losses, "grad": first_grad, "change": change}


def evaluate(family, conf: dict, data: dict, weights: dict, block: int = 1024
             ) -> dict:
    """Full-catalog ranking of every user: the family's scores from its dot
    parts (``u @ items.T`` in blocks of users, then the family's
    ``scores``), the user's train items at -inf, the top k by a stable sort
    (equal scores in catalog order). Returns per user the top-k items
    ``ids [U, k]``, their scores ``top [U, k]`` and the row's score scale
    ``scale [U]``, the block scorer ``score(users) -> [B, C]`` (train items
    -inf) for judging other lists, and ``metrics_of(ids, dtype)``: the
    metrics (the program's keys) of any lists against the val pairs,
    worked out in ``dtype``."""
    ev = conf["eval"]
    dev = weights[next(iter(weights))].device
    ks = sorted(ev["top_k"])
    n_items, n_users = data["n_items"], data["n_users"]
    k_max = min(max(ks), n_items)
    train = Rows(torch.as_tensor(data["train"], device=dev), n_users,
                 n_items)
    val = Rows(torch.as_tensor(data["val"], device=dev), n_users, n_items)
    users = torch.arange(n_users, device=dev)
    with torch.no_grad():
        user_fn, items = family.eval_parts(weights, conf,
                                           family.context(data, dev))

        def score(rows: torch.Tensor) -> torch.Tensor:
            s = family.scores(conf, user_fn(rows) @ items.T)
            seen = train.dense(rows) > 0
            return s.masked_fill(seen, float("-inf"))

        tops, scales, ids = [], [], []
        for start in range(0, n_users, block):
            s = score(users[start:start + block])
            top = torch.sort(s, dim=1, descending=True, stable=True)
            tops.append(top.values[:, :k_max])
            ids.append(top.indices[:, :k_max])
            scales.append(s.masked_fill(torch.isinf(s), 0).abs().amax(1))

    def metrics_of(lists: torch.Tensor, dtype=torch.float64) -> dict:
        with torch.no_grad():
            return rank_metrics(lists.to(dev).long(), users, val, ks,
                                ev["metrics"], ev["compute_std"], n_items,
                                name="val", dtype=dtype)

    return {"ids": torch.cat(ids), "top": torch.cat(tops),
            "scale": torch.cat(scales), "score": score,
            "metrics_of": metrics_of}


def rank_metrics(top_ids: torch.Tensor, users: torch.Tensor, positives: Rows,
                 ks: list, names: list, with_std: bool, n_catalog: int,
                 name: str, dtype=torch.float64) -> dict:
    """Binary-relevance metrics of the lists ``top_ids [U, k_max]`` at each
    cut-off: per user ndcg (IDCG over the top ``min(n_pos, k)`` ranks,
    clamped to 1), recall, precision, f_score, hitrate and ap (precision at
    each hit over ``min(n_pos, k)``), 0 for a user without positives;
    their means and population stds; coverage, the share of the catalog in
    some user's top k. Every step in ``dtype`` (the control asks for
    bfloat16)."""
    dev = top_ids.device
    hits = positives.contains(users, top_ids).to(dtype)
    n_pos = positives.lengths(users).to(dtype)
    k_max = top_ids.shape[1]
    ranks = torch.arange(1, k_max + 1, device=dev).to(dtype)
    disc = 1.0 / torch.log2(ranks + 1.0)
    out = {}
    for k in ks:
        kk = min(k, k_max)
        h = hits[:, :kk]
        n_hit = h.sum(1)
        dcg = (h * disc[:kk]).sum(1)
        ideal = torch.clamp(n_pos, max=kk).long()
        idcg = torch.cat([torch.zeros(1, device=dev, dtype=dtype),
                          torch.cumsum(disc[:kk], 0)])[ideal]
        has = n_pos > 0
        zero = torch.zeros_like(n_hit)
        ndcg = torch.where(idcg > 0, dcg / idcg.clamp(min=1e-30),
                           zero).clamp(0, 1)
        recall = torch.where(has, n_hit / n_pos.clamp(min=1), zero)
        precision = n_hit / kk
        f_den = precision + recall
        f_score = torch.where(f_den > 0, 2 * precision * recall
                              / f_den.clamp(min=1e-30), zero)
        hitrate = (n_hit > 0).to(dtype)
        prec_at = torch.cumsum(h, 1) / ranks[:kk]
        ap = torch.where(has, (prec_at * h).sum(1)
                         / torch.clamp(n_pos, max=kk).clamp(min=1), zero)
        per_user = {"ndcg": ndcg, "recall": recall, "precision": precision,
                    "f_score": f_score, "hitrate": hitrate, "ap": ap}
        for m in names:
            if m == "coverage":
                seen = torch.zeros(n_catalog, dtype=torch.bool, device=dev)
                seen[top_ids[:, :kk].reshape(-1)] = True
                out[f"{name}/coverage@{k}"] = float(seen.to(dtype).mean())
                continue
            v = per_user[m]
            out[f"{name}/{m}@{k}"] = float(v.mean())
            if with_std:
                out[f"{name}/{m}@{k}_std"] = float(v.std(unbiased=False))
    return out


def median(values) -> float:
    return statistics.median(list(values))
