"""Train / val / test splitting (port of
``sibrar_tpu/preprocessing/splitting.py``): per-user ratio (temporal or
random) and cold-start.

- temporal: per user, the earliest interactions go to train, then val,
  the last to test; the (timestamp, user_idx, item_idx) order is a stable
  sort on the device;
- random: the same ratios over a seeded shuffle, drawn on the host as
  ``DataFrame.sample(frac=1.0, random_state=seed)`` draws it
  (``RandomState(seed).choice(n, n, replace=False)``);
- cold-start: disjoint entity bands from one ``default_rng(seed)``, users
  first, then items; a split keeps the rows whose user and item are both
  in its band (a mask on the device). Features are restricted per split.

A user's n rows split as n_test = ceil(n r_test), n_val = ceil(n r_val),
n_train = n - n_val - n_test, in float64 as numpy computes them; a row's
place in its user's rows is its position in a stable sort by ``user_idx``
minus its user's segment start.
"""
from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from sibrar_tpu_torch.preprocessing.filtering import (
    as_device,
    filter_features_by_ids,
    lexsort,
    order_keys,
)
from sibrar_tpu_torch.preprocessing.ppconfig import (
    ColdStartType,
    SplitConfig,
    SplitType,
)
from sibrar_tpu_torch.preprocessing.records import (
    AllSplitsData,
    RawData,
    SplitData,
)


def _column(lhs: pd.DataFrame, name: str, dev: torch.device) -> torch.Tensor:
    values = lhs[name].to_numpy(dtype=np.int64, copy=True)
    return torch.from_numpy(values).to(dev)


def _per_user_ratio_assign(user: torch.Tensor, ratios) -> torch.Tensor:
    """Each row's bucket (0 train, 1 val, 2 test) by its place among its
    user's rows in the given order."""
    order = torch.sort(user, stable=True).indices
    counts = torch.bincount(user)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(user)
    pos[order] = (torch.arange(user.shape[0], device=user.device)
                  - starts[user[order]])
    n = counts[user].double()
    n_test = torch.ceil(n * ratios[2]).long()
    n_val = torch.ceil(n * ratios[1]).long()
    n_train = counts[user] - n_val - n_test
    return torch.where(pos < n_train, 0,
                       torch.where(pos < n_train + n_val, 1, 2))


def _ratio_split_sizes(n: int, ratios) -> tuple[int, int, int]:
    n_test = int(np.ceil(n * ratios[2]))
    n_val = int(np.ceil(n * ratios[1]))
    return n - n_val - n_test, n_val, n_test


def split_per_user_ratio(data: RawData, config: SplitConfig, temporal: bool,
                         device="cuda") -> AllSplitsData:
    dev = as_device(device)
    lhs = data.interactions
    user = _column(lhs, "user_idx", dev)
    if temporal:
        time = torch.from_numpy(order_keys(lhs["timestamp"])).to(dev)
        order = lexsort(time, user, _column(lhs, "item_idx", dev))
    else:
        order = torch.from_numpy(np.random.RandomState(config.seed).choice(
            len(lhs), size=len(lhs), replace=False).astype(np.int64)).to(dev)
    bucket = _per_user_ratio_assign(user[order], config.ratios)

    user_indices = np.sort(lhs["user_idx"].unique())
    item_indices = np.sort(lhs["item_idx"].unique())
    splits = []
    for b in (0, 1, 2):
        splits.append(SplitData(
            interactions=lhs.iloc[order[bucket == b].cpu().numpy()],
            user_indices=user_indices,
            item_indices=item_indices,
            # warm splits share all users / items, so they share features
            user_features=data.user_features,
            item_features=data.item_features,
        ))
    return AllSplitsData(*splits)


def split_cold_start(data: RawData, config: SplitConfig, device="cuda"
                     ) -> AllSplitsData:
    dev = as_device(device)
    rng = np.random.default_rng(config.seed)
    lhs = data.interactions
    cold = config.cold_start_type

    def entity_bands(col: str, is_cold: bool):
        uniq = np.sort(lhs[col].unique())
        if not is_cold:
            return uniq, uniq, uniq
        shuffled = uniq.copy()
        rng.shuffle(shuffled)
        n_train, n_val, n_test = _ratio_split_sizes(len(shuffled),
                                                    config.ratios)
        return (shuffled[:n_train], shuffled[n_train:n_train + n_val],
                shuffled[n_train + n_val:])

    def band_of_rows(col: str, bands, is_cold: bool):
        """Each row's band, or None where every band holds every id."""
        if not is_cold:
            return None
        ids = _column(lhs, col, dev)
        band = torch.full((int(ids.max()) + 1,), -1, dtype=torch.int8,
                          device=dev)
        for b, members in enumerate(bands):
            band[torch.from_numpy(members.astype(np.int64)).to(dev)] = b
        return band[ids]

    cold_user = cold in (ColdStartType.USER, ColdStartType.BOTH)
    cold_item = cold in (ColdStartType.ITEM, ColdStartType.BOTH)
    user_bands = entity_bands("user_idx", cold_user)
    item_bands = entity_bands("item_idx", cold_item)
    row_bands = [band_of_rows("user_idx", user_bands, cold_user),
                 band_of_rows("item_idx", item_bands, cold_item)]

    splits = []
    for b, (users, items) in enumerate(zip(user_bands, item_bands)):
        mask = torch.ones(len(lhs), dtype=torch.bool, device=dev)
        for band in row_bands:
            if band is not None:
                mask &= band == b
        u_set, i_set = set(users.tolist()), set(items.tolist())
        # features are reindexed to the dense idx space at split time
        splits.append(SplitData(
            interactions=lhs.iloc[torch.nonzero(mask).squeeze(1)
                                  .cpu().numpy()],
            user_indices=np.sort(users),
            item_indices=np.sort(items),
            user_features=filter_features_by_ids(
                "user", data.user_features, u_set, id_col="user_idx"),
            item_features=filter_features_by_ids(
                "item", data.item_features, i_set, id_col="item_idx"),
        ))
    return AllSplitsData(*splits)


def split_ratio_based(data: RawData, config: SplitConfig, device="cuda"
                      ) -> AllSplitsData:
    """The split ``config.split_type`` names."""
    config.validate()
    if config.split_type == SplitType.TEMPORAL:
        return split_per_user_ratio(data, config, temporal=True,
                                    device=device)
    if config.split_type == SplitType.RANDOM:
        return split_per_user_ratio(data, config, temporal=False,
                                    device=device)
    if config.split_type == SplitType.COLDSTART:
        return split_cold_start(data, config, device=device)
    raise ValueError(f"split type {config.split_type!r} is not supported")
