"""Host-side splits and their device-resident bundle (port of
``sibrar_tpu/data/dataset.py``: ``RecDataset``, ``exclude_matrix``,
``to_device``, ``DeviceData``).

A `RecDataset` holds one split on the host (numpy / scipy); `to_device`
packs what serving, training and evaluation touch into a `DeviceData` of
torch tensors: the catalog, the split's users, the exclusion CSR, the
train-interaction CSRs of both entities, the split's (user, catalog item)
pairs with their positives CSR and the item popularity, and the feature
tables. Artifact loading (pandas, yaml) is
not part of the port yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch

from sibrar_tpu_torch.ops.sparse import DeviceCSR

COLD_START = ("cold_start_user", "cold_start_item", "cold_start_both")


@dataclass
class FeatureTable:
    """One feature over all entities, row-aligned to the entity index:
    ``kind`` "numeric" (float rows), "tag" (padded tag codes, pad id ==
    ``n_categories``) or "categorical" (codes). ``value_map`` (label ->
    code) names the codes; group metrics need it for their labels."""

    table: np.ndarray
    kind: str
    n_categories: int = 0
    value_map: Optional[dict] = None


class DeviceData(NamedTuple):
    """Device-resident view of one split, in catalog space where noted."""

    n_users: int
    n_items: int
    catalog: torch.Tensor  # [n_catalog] int32, global ids of items_in_split
    users_in_split: torch.Tensor  # [n_users_in_split] int32
    exclude_csr: DeviceCSR  # user -> catalog positions to exclude
    user_inter_csr: DeviceCSR  # user -> global item ids (train split)
    item_inter_csr: DeviceCSR  # item -> global user ids (train split)
    train_users: torch.Tensor  # [n] int32, users of the split's pairs
    train_items_cat: torch.Tensor  # [n] int32, their items' catalog positions
    pos_csr: DeviceCSR  # user -> catalog positions of the split's pairs
    popularity: torch.Tensor  # [n_catalog] f32 train popularity, sums to 1
    user_features: Dict[str, torch.Tensor]
    item_features: Dict[str, torch.Tensor]


@dataclass
class RecDataset:
    """One split of a dataset, host-side."""

    split_set: str  # 'train' | 'val' | 'test'
    n_users: int
    n_items: int
    interactions: np.ndarray  # [n, 2] int64 (user, item) of this split
    train_interactions: np.ndarray
    val_interactions: Optional[np.ndarray] = None  # test-time exclusion
    split_type: str = "random"
    user_features: Dict[str, FeatureTable] = field(default_factory=dict)
    item_features: Dict[str, FeatureTable] = field(default_factory=dict)

    def __post_init__(self):
        if self.split_set not in ("train", "val", "test"):
            raise ValueError(f"unknown split {self.split_set!r}")
        self.is_cold_start = self.split_type in COLD_START
        self.is_cold_start_user = self.split_type in (
            "cold_start_user", "cold_start_both")
        self.is_cold_start_item = self.split_type in (
            "cold_start_item", "cold_start_both")
        if self.is_cold_start:  # users and catalog of this split only
            self.users_in_split = np.unique(
                self.interactions[:, 0]).astype(np.int64)
            self.items_in_split = np.unique(
                self.interactions[:, 1]).astype(np.int64)
        else:
            self.users_in_split = np.arange(self.n_users, dtype=np.int64)
            self.items_in_split = np.arange(self.n_items, dtype=np.int64)
        self.n_items_in_split = len(self.items_in_split)
        self.interaction_matrix_train = self._matrix(self.train_interactions)

    def _matrix(self, inter: np.ndarray) -> sp.csr_matrix:
        return sp.csr_matrix(
            (np.ones(len(inter), np.int8), (inter[:, 0], inter[:, 1])),
            shape=(self.n_users, self.n_items))

    def exclude_matrix(self) -> sp.csr_matrix:
        """Interactions removed from ranking: train for val, train + val for
        test, none for train."""
        mask = sp.csr_matrix((self.n_users, self.n_items), dtype=np.int8)
        if self.split_set != "train":
            mask = mask + self.interaction_matrix_train
        if self.split_set == "test":
            if self.val_interactions is None:
                raise ValueError("test split requires val interactions")
            mask = mask + self._matrix(self.val_interactions)
        return mask.tocsr()

    def to_device(self, device="cuda") -> DeviceData:
        cat = self.items_in_split
        train_t = self.interaction_matrix_train.T.tocsr()
        item_to_catalog = np.full(self.n_items, -1, dtype=np.int64)
        item_to_catalog[cat] = np.arange(len(cat))
        users = self.interactions[:, 0]
        items_cat = item_to_catalog[self.interactions[:, 1]]
        pos_sp = sp.csr_matrix(
            (np.ones(len(users), np.int8), (users, items_cat)),
            shape=(self.n_users, len(cat)))
        pop = np.asarray(self.interaction_matrix_train.sum(axis=0)).ravel()
        pop = pop[cat].astype(np.float32)
        pop = pop / max(pop.sum(), 1.0)
        return DeviceData(
            n_users=self.n_users, n_items=self.n_items,
            catalog=torch.as_tensor(cat.astype(np.int32), device=device),
            users_in_split=torch.as_tensor(
                self.users_in_split.astype(np.int32), device=device),
            exclude_csr=DeviceCSR.from_scipy(
                self.exclude_matrix()[:, cat], device),
            user_inter_csr=DeviceCSR.from_scipy(
                self.interaction_matrix_train, device),
            item_inter_csr=DeviceCSR.from_scipy(train_t, device),
            train_users=torch.as_tensor(users.astype(np.int32),
                                        device=device),
            train_items_cat=torch.as_tensor(items_cat.astype(np.int32),
                                            device=device),
            pos_csr=DeviceCSR.from_scipy(pos_sp, device),
            popularity=torch.as_tensor(pop, device=device),
            user_features={k: torch.as_tensor(f.table, device=device)
                           for k, f in self.user_features.items()},
            item_features={k: torch.as_tensor(f.table, device=device)
                           for k, f in self.item_features.items()})


def make_splits(data: dict) -> dict[str, RecDataset]:
    """The train / val / test `RecDataset`s of a generator's arrays
    (`data.synthetic.make_onion_scale_splits`)."""
    def mk(split):
        return RecDataset(
            split_set=split, n_users=data["n_users"], n_items=data["n_items"],
            interactions=data[split], train_interactions=data["train"],
            val_interactions=data["val"] if split == "test" else None,
            user_features=dict(data.get("user_features", {})),
            item_features=dict(data.get("item_features", {})))
    return {s: mk(s) for s in ("train", "val", "test")}
