"""Host-side splits, the artifact reader and the device-resident bundle
(port of ``sibrar_tpu/data/dataset.py``: ``RecDataset`` with ``load``,
``exclude_matrix`` and ``to_device``, ``DeviceData``).

A `RecDataset` holds one split on the host (numpy / scipy); `to_device`
packs what serving, training and evaluation touch into a `DeviceData` of
torch tensors: the catalog, the split's users, the exclusion CSR, the
train-interaction CSRs of both entities, the split's (user, catalog item)
pairs with their positives CSR and the item popularity, and the feature
tables.

`RecDataset.load` reads a preprocessed artifact directory (``user_idxs.csv``,
``item_idxs.csv``, ``listening_history_{split}.csv``,
``{entity}_features_{split}.csv``, ``{entity}_{name}_{split}.npz``) with the
``csv`` module and numpy. `read_csv` types each column as pandas'
``read_csv`` does (int, then float, then bool, else the strings; an empty
or NA cell is NaN, which makes an int column float), and `concat_columns`
joins columns as ``pd.concat`` does, so the features get the JAX package's
values and labels. The split type comes from the caller
(``config.loader.load_split_type``): this layer reads no YAML.
"""
from __future__ import annotations

import csv
import io
import os
from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from sibrar_tpu_torch.config.schema import FeatureDefinition, FeatureType
from sibrar_tpu_torch.data.feature import FeatureTable, build_feature
from sibrar_tpu_torch.ops.sparse import DeviceCSR

COLD_START = ("cold_start_user", "cold_start_item", "cold_start_both")
# pandas.read_csv's default NA strings and boolean words
NA_STRINGS = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))
BOOL_WORDS = {"True": True, "TRUE": True, "true": True,
              "False": False, "FALSE": False, "false": False}


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
    split_type: str = "random"  # or a DatasetSplitType
    user_features: Dict[str, FeatureTable] = field(default_factory=dict)
    item_features: Dict[str, FeatureTable] = field(default_factory=dict)

    def __post_init__(self):
        if self.split_set not in ("train", "val", "test"):
            raise ValueError(f"unknown split {self.split_set!r}")
        self.split_type = str(getattr(self.split_type, "value",
                                      self.split_type))
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
        self._sampling: Optional[sp.csr_matrix] = None
        self._pop: Optional[np.ndarray] = None

    @property
    def user_sampling_matrix(self) -> sp.csr_matrix:
        """The split's own interactions as an int8 CSR [n_users, n_items]
        (JAX ``interaction_matrix``): what the matrix algorithms fit on."""
        if self._sampling is None:
            self._sampling = self._matrix(self.interactions)
        return self._sampling

    @property
    def pop_distribution(self) -> np.ndarray:
        """Each item's count in the split over the total, float64 (JAX
        ``pop_distribution``)."""
        if self._pop is None:
            counts = np.asarray(self.user_sampling_matrix.sum(axis=0)).ravel()
            self._pop = counts / max(counts.sum(), 1)
        return self._pop

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

    @staticmethod
    def load(data_path: str, split_set: str,
             user_feature_definitions: Optional[
                 Sequence[FeatureDefinition]] = None,
             item_feature_definitions: Optional[
                 Sequence[FeatureDefinition]] = None,
             split_type: str = "random") -> "RecDataset":
        """One split of the artifact directory ``data_path``, as the JAX
        package's ``RecDataset.load`` reads it: the entity counts are the
        rows of ``user_idxs.csv`` / ``item_idxs.csv``, the pairs the
        ``user_idx`` / ``item_idx`` columns of the split's history; train
        also loads val's features; npz rows keep their first occurrence
        (split before val), CSV rows their first row per entity, and the
        labels of tag and categorical features range over all three
        splits."""
        def path(name):
            return os.path.join(data_path, name)

        n_users = len(next(iter(read_csv(path("user_idxs.csv")).values())))
        n_items = len(next(iter(read_csv(path("item_idxs.csv")).values())))

        def history(split):
            cols = read_csv(path(f"listening_history_{split}.csv"))
            return np.stack([cols["user_idx"], cols["item_idx"]],
                            axis=1).astype(np.int64)

        inter = history(split_set)
        feature_splits = ((split_set, "val") if split_set == "train"
                          else (split_set,))
        frames: dict = {}  # (entity, split) -> the parsed feature csv

        def frame(entity, split):
            key = (entity, split)
            if key not in frames:
                f = path(f"{entity}_features_{split}.csv")
                frames[key] = read_csv(f) if os.path.exists(f) else None
            return frames[key]

        def load_features(entity, defs, n_entities):
            feats: Dict[str, FeatureTable] = {}
            for fd in defs or ():
                if fd.type in (FeatureType.VECTOR, FeatureType.MATRIX):
                    vals, idxs = [], []
                    for s in feature_splits:
                        f = path(f"{entity}_{fd.name}_{s}.npz")
                        if os.path.exists(f):
                            with np.load(f) as z:
                                vals.append(z["values"])
                                idxs.append(z["indices"])
                    if not vals:
                        raise FileNotFoundError(
                            f"no npz found for {entity} feature "
                            f"{fd.name!r} in {data_path}")
                    indices, first = np.unique(np.concatenate(idxs),
                                               return_index=True)
                    feats[fd.name] = build_feature(
                        fd, np.concatenate(vals)[first], n_entities, indices)
                    continue
                own = [frame(entity, s) for s in feature_splits]
                own = [c for c in own if c is not None]
                if not own:
                    raise FileNotFoundError(
                        f"no feature csv for {entity} in {data_path}")
                ref = [frame(entity, s) for s in ("train", "val", "test")]
                ref = [c for c in ref if c is not None] or own
                idx = concat_columns(own, f"{entity}_idx")
                keep = np.sort(np.unique(idx, return_index=True)[1])
                feats[fd.name] = build_feature(
                    fd, concat_columns(own, fd.name)[keep].tolist(),
                    n_entities, indices=idx[keep],
                    reference_values=concat_columns(ref, fd.name).tolist())
            return feats

        return RecDataset(
            split_set=split_set, n_users=n_users, n_items=n_items,
            interactions=inter,
            train_interactions=(inter if split_set == "train"
                                else history("train")),
            val_interactions=history("val") if split_set == "test" else None,
            split_type=split_type,
            user_features=load_features("user", user_feature_definitions,
                                        n_users),
            item_features=load_features("item", item_feature_definitions,
                                        n_items))


def _typed(cells: list) -> np.ndarray:
    """One CSV column as pandas types it: int64, else float64 (NA cells
    NaN), else bool, else an object array of the strings (NA cells NaN).
    A column without rows is an object array."""
    if not cells:
        return np.array([], dtype=object)
    numeric = "_" not in "".join(cells)  # Python would read 1_0 as 10
    if numeric:
        try:  # no NA string parses as an int
            return np.array(cells, dtype=np.int64)
        except (ValueError, OverflowError):
            pass
    na = [c in NA_STRINGS for c in cells]
    present = [c for c, n in zip(cells, na) if not n]
    if not present:  # every cell NA
        return np.full(len(cells), np.nan)
    if numeric:
        try:
            return np.array([c if not n else "nan"
                             for c, n in zip(cells, na)], dtype=np.float64)
        except ValueError:
            pass
    if all(c in BOOL_WORDS for c in present):
        if not any(na):
            return np.array([BOOL_WORDS[c] for c in cells], dtype=bool)
        return np.array([float("nan") if n else BOOL_WORDS[c]
                         for c, n in zip(cells, na)], dtype=object)
    out = np.empty(len(cells), dtype=object)
    out[:] = [float("nan") if n else c for c, n in zip(cells, na)]
    return out


def _split_fields(text: str) -> tuple[list, list]:
    """(header, columns of strings) of a CSV text: by ``str.split`` when it
    holds no quote and no carriage return (a history's integer columns),
    else by the ``csv`` module. Blank lines are skipped."""
    if '"' in text or "\r" in text:
        rows = [r for r in csv.reader(io.StringIO(text)) if r]
        header, rows = rows[0], rows[1:]
        if any(len(r) != len(header) for r in rows):
            raise ValueError("a CSV row's field count differs from the "
                             "header's")
        return header, [list(c) for c in zip(*rows)] if rows else [
            [] for _ in header]
    lines = [line for line in text.split("\n") if line]
    header = lines[0].split(",")
    n = len(header)
    flat = ",".join(lines[1:]).split(",") if len(lines) > 1 else []
    if len(flat) != n * (len(lines) - 1):
        raise ValueError("a CSV row's field count differs from the header's")
    return header, [flat[i::n] for i in range(n)]


def read_csv(file_path: str) -> Dict[str, np.ndarray]:
    """The columns of a CSV file with a header row, by name, each typed as
    `pandas.read_csv` types it (`_typed`); blank lines are skipped."""
    with open(file_path, newline="") as fh:
        header, columns = _split_fields(fh.read())
    return {name: _typed(col) for name, col in zip(header, columns)}


def concat_columns(frames: Sequence[Dict[str, np.ndarray]],
                   name: str) -> np.ndarray:
    """Column ``name`` of ``frames`` joined as ``pd.concat`` joins it: int
    with float gives float, any other mix an object array whose values keep
    their types; a frame without the column adds NaNs."""
    cols = [f[name] if name in f
            else np.full(len(next(iter(f.values()), ())), np.nan)
            for f in frames]
    kinds = {c.dtype.kind for c in cols}
    if len(kinds) > 1:
        dtype = np.float64 if kinds <= {"i", "f"} else object
        cols = [c.astype(dtype) for c in cols]
    return np.concatenate(cols)


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
