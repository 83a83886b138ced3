"""Onion-scale synthetic data (port of
``sibrar_tpu/data/synthetic.py:make_onion_scale_splits``).

Numpy only. The generator draws from the rng in exactly the JAX package's
order, so one seed gives bit-identical pairs and feature tables in both.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from sibrar_tpu_torch.data.dataset import FeatureTable


def make_onion_scale_splits(
    n_users: int = 50_000,
    n_items: int = 100_352,
    n_interactions: int = 2_000_000,
    n_clusters: int = 64,
    seed: int = 7,
    feature_dims: Optional[dict] = None,
) -> dict:
    """The paper's onion18 regime as plain arrays: ``n_users``, ``n_items``,
    the ``train`` / ``val`` / ``test`` (user, item) pair arrays (int64
    [n, 2]) and ``item_features`` (name -> `FeatureTable`).

    Items carry a Zipf popularity tail and a cluster; each user draws half
    their items from global popularity and half from their own cluster.
    Splits are per-user 0.6 / 0.2 / 0.2 (users with < 3 interactions stay
    train-only). Item features: cluster-correlated vectors plus a ``genres``
    tag set (the item's cluster tag and two random tags)."""
    rng = np.random.default_rng(seed)
    feature_dims = feature_dims or {"ivec256": 256, "bert": 384,
                                    "musicnn": 128}
    item_cluster = rng.integers(0, n_clusters, n_items)
    user_cluster = rng.integers(0, n_clusters, n_users)
    ranks = rng.permutation(n_items).astype(np.float64)
    pop = 1.0 / (ranks + 10.0) ** 0.8
    pop /= pop.sum()

    draws = int(n_interactions * 1.6)
    users = rng.integers(0, n_users, draws)
    from_pop = rng.random(draws) < 0.5
    items = np.empty(draws, np.int64)
    items[from_pop] = rng.choice(n_items, size=int(from_pop.sum()), p=pop)
    items_by_cluster = [np.where(item_cluster == c)[0]
                        for c in range(n_clusters)]
    sizes = np.array([len(x) for x in items_by_cluster])
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    flat_items = np.concatenate(items_by_cluster)
    cl = user_cluster[users[~from_pop]]
    within = (rng.random(int((~from_pop).sum())) * sizes[cl]).astype(np.int64)
    items[~from_pop] = flat_items[offsets[cl] + within]

    pairs = np.unique(np.stack([users, items], axis=1), axis=0)
    rng.shuffle(pairs)
    pairs = pairs[:n_interactions]
    order = np.lexsort((rng.random(len(pairs)), pairs[:, 0]))
    pairs = pairs[order]
    _u, starts, counts = np.unique(pairs[:, 0], return_index=True,
                                   return_counts=True)
    pos = np.arange(len(pairs)) - np.repeat(starts, counts)
    cnt = np.repeat(counts, counts)
    frac = pos / cnt
    bucket = np.where(cnt < 3, 0,
                      np.where(frac < 0.6, 0, np.where(frac < 0.8, 1, 2)))

    centers = {name: rng.normal(size=(n_clusters, d)).astype(np.float32)
               for name, d in feature_dims.items()}
    item_features = {}
    for name, d in feature_dims.items():
        table = (centers[name][item_cluster]
                 + 0.6 * rng.normal(size=(n_items, d))).astype(np.float32)
        item_features[name] = FeatureTable(table, "numeric")
    extra = rng.integers(0, n_clusters, (n_items, 2))
    tag_ids = np.stack([item_cluster, extra[:, 0], extra[:, 1]], axis=1)
    item_features["genres"] = _tag_table(tag_ids)
    return {"n_users": n_users, "n_items": n_items,
            "train": pairs[bucket == 0], "val": pairs[bucket == 1],
            "test": pairs[bucket == 2], "item_features": item_features}


def _tag_table(tag_ids: np.ndarray) -> FeatureTable:
    """Padded tag-code table of the tags ``g{id}``. Codes follow the SORTED
    STRING order of the tag names that occur ("g10" sorts before "g2"), each
    row holds its distinct codes ascending, and the pad code is n_tags."""
    present = np.unique(tag_ids)
    names = [f"g{t}" for t in present]
    order = sorted(range(len(names)), key=names.__getitem__)
    code = np.zeros(int(present.max()) + 1, np.int32)
    code[present[order]] = np.arange(len(present), dtype=np.int32)
    pad = len(present)
    rows = np.sort(code[tag_ids], axis=1)
    rows[:, 1:][rows[:, 1:] == rows[:, :-1]] = pad  # drop repeated tags
    rows = np.sort(rows, axis=1)
    width = max(int((rows != pad).sum(axis=1).max()), 1)
    return FeatureTable(np.ascontiguousarray(rows[:, :width]), "tag",
                        n_categories=pad)
