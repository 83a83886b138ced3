"""The benchmark's one data generator: an onion-scale interaction data set
drawn on the device from the seed.

It makes the distribution of ``make_onion_scale_splits`` (a Zipf popularity
tail, 64 item and user clusters, each draw half from global popularity and
half from the user's cluster; per-user 0.6 / 0.2 / 0.2 splits by position;
cluster-correlated item vectors and a three-tag genre set) with torch draws
on the card instead of numpy draws on the host, so set-up spends well under
a second on it. The program's own generator is not called: it may change.

Parameters come from a configuration's ``data`` block, overridden key by key
by a mix's ``data`` block.
"""
from __future__ import annotations

import numpy as np
import torch

DEFAULTS = {
    "n_users": 50_000,
    "n_items": 100_352,
    "n_interactions": 2_000_000,
    "draw_factor": 1.6,
    "n_clusters": 64,
    "zipf_offset": 10.0,
    "zipf_exponent": 0.8,
    "popular_share": 0.5,
    "split_fractions": [0.6, 0.2],
    "min_split_count": 3,
    "feature_noise": 0.6,
    "item_vectors": {"ivec256": 256, "bert": 384, "musicnn": 128},
    "extra_tags": 2,
}


def parameters(config_data: dict, mix_data: dict | None = None) -> dict:
    """The generator's parameters: its defaults, then the configuration's
    ``data`` block, then the mix's; an unknown key raises."""
    out = dict(DEFAULTS)
    for block in (config_data or {}, mix_data or {}):
        unknown = set(block) - set(DEFAULTS)
        if unknown:
            raise ValueError(f"unknown data parameters {sorted(unknown)}")
        out.update(block)
    return out


def make(params: dict, seed: int, device) -> dict:
    """The data set of ``seed``: ``n_users``, ``n_items``, ``train`` and
    ``val`` (user, item) pairs as int64 ``[n, 2]`` numpy arrays (rows of one
    user together, in a random order within the user), ``vectors`` (name ->
    float32 ``[n_items, d]`` numpy) and ``tags`` (int32 ``[n_items, w]``
    codes padded with ``n_tags``) with ``n_tags``."""
    p = params
    g = torch.Generator(device=device).manual_seed(seed)
    nu, ni, ncl = p["n_users"], p["n_items"], p["n_clusters"]

    def randint(high, size):
        return torch.randint(0, high, size, generator=g, device=device)

    item_cluster = randint(ncl, (ni,))
    user_cluster = randint(ncl, (nu,))
    ranks = torch.randperm(ni, generator=g, device=device).double()
    pop = 1.0 / (ranks + p["zipf_offset"]) ** p["zipf_exponent"]
    pop /= pop.sum()

    draws = int(p["n_interactions"] * p["draw_factor"])
    users = randint(nu, (draws,))
    from_pop = torch.rand(draws, generator=g, device=device) < p[
        "popular_share"]
    items = torch.empty(draws, dtype=torch.int64, device=device)
    n_pop = int(from_pop.sum())
    items[from_pop] = torch.multinomial(pop, n_pop, replacement=True,
                                        generator=g)
    by_cluster = torch.sort(item_cluster, stable=True).indices
    sizes = torch.bincount(item_cluster, minlength=ncl)
    offsets = torch.cumsum(sizes, 0) - sizes
    cl = user_cluster[users[~from_pop]]
    within = (torch.rand(draws - n_pop, generator=g, device=device,
                         dtype=torch.float64) * sizes[cl]).long()
    within = torch.minimum(within, (sizes[cl] - 1).clamp(min=0))
    items[~from_pop] = by_cluster[offsets[cl] + within]

    keys = torch.unique(users * ni + items)
    keys = keys[torch.randperm(keys.numel(), generator=g, device=device)]
    keys = keys[:p["n_interactions"]]
    keys = keys[torch.sort(keys // ni, stable=True).indices]
    u, i = keys // ni, keys % ni
    counts = torch.bincount(u, minlength=nu)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(u.numel(), device=device) - starts[u]
    cnt = counts[u]
    frac = pos.double() / cnt.double()
    f_train, f_val = p["split_fractions"]
    bucket = torch.where(
        cnt < p["min_split_count"], 0,
        torch.where(frac < f_train, 0,
                    torch.where(frac < f_train + f_val, 1, 2)))
    pairs = torch.stack([u, i], dim=1)

    vectors = {}
    for name, d in p["item_vectors"].items():
        centers = torch.randn(ncl, d, generator=g, device=device)
        vectors[name] = (centers[item_cluster] + p["feature_noise"]
                         * torch.randn(ni, d, generator=g, device=device))
    extra = randint(ncl, (ni, p["extra_tags"]))
    tag_ids = torch.cat([item_cluster.unsqueeze(1), extra], dim=1)
    tags, n_tags = tag_table(tag_ids.cpu().numpy())
    return {"n_users": nu, "n_items": ni,
            "train": pairs[bucket == 0].cpu().numpy(),
            "val": pairs[bucket == 1].cpu().numpy(),
            "vectors": {k: v.cpu().numpy() for k, v in vectors.items()},
            "tags": tags, "n_tags": n_tags}


def tag_table(tag_ids: np.ndarray) -> tuple[np.ndarray, int]:
    """Padded tag codes of the tags ``g{id}``: codes in the sorted string
    order of the names that occur, each row's distinct codes ascending,
    the pad code ``n_tags``. Returns ``(rows int32 [n, w], n_tags)``."""
    present = np.unique(tag_ids)
    names = [f"g{t}" for t in present]
    order = sorted(range(len(names)), key=names.__getitem__)
    code = np.zeros(int(present.max()) + 1, np.int32)
    code[present[order]] = np.arange(len(present), dtype=np.int32)
    pad = len(present)
    rows = np.sort(code[tag_ids], axis=1)
    rows[:, 1:][rows[:, 1:] == rows[:, :-1]] = pad  # a repeated tag
    rows = np.sort(rows, axis=1)
    width = max(int((rows != pad).sum(axis=1).max()), 1)
    return np.ascontiguousarray(rows[:, :width]), pad
