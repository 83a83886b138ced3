"""Synthetic data and the artifact writer (port of
``sibrar_tpu/data/synthetic.py``: ``make_synthetic_splits``,
``make_onion_scale_splits``, ``write_reference_artifacts``).

Numpy and the ``csv`` module only. The generator draws from the rng in
exactly the JAX package's order, so one seed gives bit-identical pairs and
feature tables in both.
"""
from __future__ import annotations

import csv
import os
from typing import Optional

import numpy as np

from sibrar_tpu_torch.config.schema import (
    DatasetSplitType,
    FeatureDefinition,
    FeatureType,
)
from sibrar_tpu_torch.data.dataset import RecDataset
from sibrar_tpu_torch.data.feature import FeatureTable, build_feature

USED_CONFIG = """interactions:
  k_core: 0
  min_n_interactions: 0
item_features: []
split:
{split}user_features: []
"""


def make_synthetic_splits(
    n_users: int = 60,
    n_items: int = 80,
    n_interactions: int = 1500,
    split_type: DatasetSplitType = DatasetSplitType.RANDOM,
    seed: int = 0,
    with_features: bool = True,
    feature_dim: int = 12,
    latent_dim: int = 6,
    popularity_alpha: float = 0.0,
) -> dict[str, RecDataset]:
    """Train / val / test `RecDataset`s with planted low-rank preferences:
    unique (user, item) pairs drawn with probability ``exp(score / 2)``,
    ``score = u_lat @ i_lat + noise`` (minus ``2 alpha ln(rank + 1)`` per
    item with ``popularity_alpha``, a Zipf tail); per-user 0.6 / 0.2 / 0.2
    splits, or disjoint entity groups for the cold-start split types; item
    features ``audio`` / ``text`` (vectors from the item latents) and
    ``genres`` (tags), user features ``gender`` and ``profile_vec``. The
    rng draws in the JAX package's order, so one seed gives the same
    arrays and tables bit for bit."""
    split_type = DatasetSplitType(split_type)
    rng = np.random.default_rng(seed)
    u_lat = rng.normal(size=(n_users, latent_dim)).astype(np.float32)
    i_lat = rng.normal(size=(n_items, latent_dim)).astype(np.float32)
    scores = u_lat @ i_lat.T + 0.5 * rng.normal(size=(n_users, n_items))
    if popularity_alpha > 0.0:
        ranks = rng.permutation(n_items).astype(np.float32)
        scores = scores - 2.0 * popularity_alpha * np.log1p(ranks)[None, :]
    flat_p = np.exp(scores.ravel() / 2.0)
    flat_p /= flat_p.sum()
    n_pairs = min(n_interactions, n_users * n_items // 2)
    chosen = rng.choice(n_users * n_items, size=n_pairs, replace=False,
                        p=flat_p)
    users, items = np.divmod(chosen, n_items)
    order = rng.permutation(n_pairs)
    inter = np.stack([users[order], items[order]], axis=1).astype(np.int64)

    if not split_type.is_cold_start:
        tr, va, te = [], [], []
        for u in range(n_users):
            rows = inter[inter[:, 0] == u]
            if len(rows) == 0:
                continue
            n = len(rows)
            n_tr = max(int(n * 0.6), 1)
            n_va = (max(int(n * 0.2), 1) if n - n_tr >= 2
                    else max(n - n_tr - 1, 0))
            tr.append(rows[:n_tr])
            if n_va:
                va.append(rows[n_tr:n_tr + n_va])
            if n - n_tr - n_va > 0:
                te.append(rows[n_tr + n_va:])
        tr_i, va_i, te_i = (np.concatenate(x) if x
                            else np.zeros((0, 2), np.int64)
                            for x in (tr, va, te))
    else:
        def cold_groups(n_entities):
            perm = rng.permutation(n_entities)
            n_tr = int(n_entities * 0.7)
            n_va = int(n_entities * 0.15)
            return (set(perm[:n_tr]), set(perm[n_tr:n_tr + n_va]),
                    set(perm[n_tr + n_va:]))

        cold_user = split_type in (DatasetSplitType.COLD_START_USER,
                                   DatasetSplitType.COLD_START_BOTH)
        cold_item = split_type in (DatasetSplitType.COLD_START_ITEM,
                                   DatasetSplitType.COLD_START_BOTH)
        u_groups = cold_groups(n_users) if cold_user else (None,) * 3
        i_groups = cold_groups(n_items) if cold_item else (None,) * 3
        names = ("train", "val", "test")
        buckets = {name: [] for name in names}
        for row in inter:
            u, i = row
            for name, ug, ig in zip(names, u_groups, i_groups):
                if (not cold_user or u in ug) and (not cold_item or i in ig):
                    buckets[name].append(row)
                    break
        tr_i, va_i, te_i = (np.array(buckets[name], np.int64).reshape(-1, 2)
                            for name in names)

    user_features, item_features = {}, {}
    if with_features:
        def feature(name, kind, values, n):
            return build_feature(FeatureDefinition(name, kind), values, n)

        proj_a = rng.normal(size=(latent_dim, feature_dim)).astype(np.float32)
        proj_b = rng.normal(size=(latent_dim, feature_dim * 2)).astype(
            np.float32)
        item_features["audio"] = feature(
            "audio", FeatureType.VECTOR,
            (i_lat @ proj_a + 0.1 * rng.normal(size=(n_items, feature_dim))
             ).astype(np.float32), n_items)
        item_features["text"] = feature(
            "text", FeatureType.VECTOR,
            (i_lat @ proj_b + 0.1 * rng.normal(
                size=(n_items, feature_dim * 2))).astype(np.float32),
            n_items)
        genres = ["action", "comedy", "drama", "horror", "scifi"]
        item_features["genres"] = feature(
            "genres", FeatureType.TAG,
            ["|".join(rng.choice(genres, size=rng.integers(1, 4),
                                 replace=False)) for _ in range(n_items)],
            n_items)
        user_features["gender"] = feature(
            "gender", FeatureType.CATEGORICAL,
            list(rng.choice(["m", "f", "x"], size=n_users)), n_users)
        uproj = rng.normal(size=(latent_dim, feature_dim)).astype(np.float32)
        user_features["profile_vec"] = feature(
            "profile_vec", FeatureType.VECTOR,
            (u_lat @ uproj).astype(np.float32), n_users)

    def split(name, inter_s):
        return RecDataset(
            split_set=name, n_users=n_users, n_items=n_items,
            interactions=inter_s, train_interactions=tr_i,
            val_interactions=va_i if name == "test" else None,
            split_type=split_type, user_features=dict(user_features),
            item_features=dict(item_features))

    return {"train": split("train", tr_i), "val": split("val", va_i),
            "test": split("test", te_i)}


def write_reference_artifacts(out_dir: str, splits: dict[str, RecDataset],
                              seed: int = 0) -> str:
    """Write ``splits`` (`data.dataset.make_splits`) to ``out_dir`` in the
    artifact layout the JAX package's writer uses: ``user_idxs.csv``,
    ``item_idxs.csv``, ``used_config.yaml`` (the splits' split type, with
    the same keys, as the text ``yaml.safe_dump`` gives), per split
    ``listening_history_{split}.csv``,
    ``{entity}_features_{split}.csv`` (categorical labels, tags joined by
    ``|``, 1-D numeric columns) and ``{entity}_{name}_{split}.npz``
    (tables of rank 2 and more: ``indices``, ``values``), each over the
    split's users or items. The feature tables need the labels of their
    codes (``value_map``)."""
    os.makedirs(out_dir, exist_ok=True)
    any_split = next(iter(splits.values()))

    def write(name, header, rows):
        with open(os.path.join(out_dir, name), "w", newline="") as fh:
            w = csv.writer(fh, lineterminator="\n")
            w.writerow(header)
            w.writerows(rows)

    for entity, n in (("user", any_split.n_users),
                      ("item", any_split.n_items)):
        ids = np.arange(n).tolist()
        write(f"{entity}_idxs.csv", [entity, f"{entity}_idx"],
              zip(ids, ids))

    st = any_split.split_type
    if st.startswith("cold_start_"):
        split = (f"  cold_start_type: {st[len('cold_start_'):]}\n"
                 f"  ratios:\n  - 0.7\n  - 0.15\n  - 0.15\n"
                 f"  seed: {seed}\n  split_type: coldstart\n")
    else:
        split = (f"  ratios:\n  - 0.6\n  - 0.2\n  - 0.2\n"
                 f"  seed: {seed}\n  split_type: {st}\n")
    with open(os.path.join(out_dir, "used_config.yaml"), "w") as fh:
        fh.write(USED_CONFIG.format(split=split))

    for name, ds in splits.items():
        write(f"listening_history_{name}.csv", ["user_idx", "item_idx"],
              ds.interactions.tolist())
        for entity, feats, in_split in (
                ("user", ds.user_features, ds.users_in_split),
                ("item", ds.item_features, ds.items_in_split)):
            cols = {}
            for fname, feat in feats.items():
                rows = feat.table[in_split]
                if feat.kind == "numeric" and rows.ndim > 1:
                    np.savez(os.path.join(
                        out_dir, f"{entity}_{fname}_{name}.npz"),
                        indices=in_split, values=rows)
                    continue
                if feat.kind == "numeric":
                    cols[fname] = rows.tolist()
                    continue
                label = {v: k for k, v in feat.value_map.items()}
                cols[fname] = (
                    [label[int(c)] for c in rows] if feat.kind ==
                    "categorical" else
                    ["|".join(str(label[int(t)]) for t in row
                              if t != feat.n_categories) for row in rows])
            if cols:
                write(f"{entity}_features_{name}.csv",
                      [f"{entity}_idx", *cols],
                      zip(in_split.tolist(), *cols.values()))
    return out_dir


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
    row holds its distinct codes ascending, and the pad code is n_tags;
    ``value_map`` maps each name to its code."""
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
                        n_categories=pad,
                        value_map={names[i]: c for c, i in enumerate(order)})
