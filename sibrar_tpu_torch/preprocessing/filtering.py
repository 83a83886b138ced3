"""Interaction and feature filtering (port of
``sibrar_tpu/preprocessing/filtering.py``).

The interaction stages run on a torch device over int64 codes: raw user
and item ids (and timestamps that are not integers) are factorized once on
the host into the codes of their sorted unique values
(`encode_interactions`), so comparing codes compares the raw values,
strings included. A stage is then a sort, a count
(``torch.unique`` / ``bincount``) and a mask, and keeps the surviving rows
in the order the JAX package's pandas code keeps them:

- `filter_min_interactions`: pairs seen at least ``m`` times, row order
  kept;
- `filter_unique`: each pair's first row by timestamp, rows in timestamp
  order. pandas sorts the one timestamp column with an unstable quicksort;
  this sort is stable, so among rows of one timestamp the order (and which
  of a pair's rows of one timestamp is kept) is one that pandas may
  return, and `create_index`'s full sort makes the final order and the
  stored columns the same;
- `filter_k_core`: items, then users, with fewer than k rows dropped,
  until the row count stops changing;
- `create_index`: users and items numbered by first appearance in
  (timestamp, user, item) order, rows returned in that order (the left-key
  order of pandas' inner merge).

The host frame is gathered once, by the surviving rows' positions, in
`create_index`. The tabular feature filters, the cross-filters and
`reindex_features` work on the feature tables on the host.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Iterable

import numpy as np
import pandas as pd
import torch

from sibrar_tpu_torch.preprocessing.ppconfig import PPFeatureConfig
from sibrar_tpu_torch.preprocessing.records import EntityFeatures, MultiDFeature

log = logging.getLogger(__name__)


def as_device(device) -> torch.device:
    """``device`` as a torch device: a CUDA device raises without a card
    (there is no fallback to the CPU; pass ``"cpu"`` for it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"preprocessing device {str(device)!r} asks for the card, and "
            f"torch.cuda.is_available() is false; pass device='cpu' "
            f"(--device cpu) for the CPU")
    return dev


def lexsort(*keys: torch.Tensor) -> torch.Tensor:
    """The stable order of rows by ``keys``, the first key most
    significant (one stable sort a key, the last key first)."""
    order = None
    for key in reversed(keys):
        k = key if order is None else key[order]
        p = torch.sort(k, stable=True).indices
        order = p if order is None else order[p]
    return order


def factorize(values: pd.Series) -> tuple[np.ndarray, pd.Index]:
    """``(codes, uniques)``: int64 codes of ``values`` into their sorted
    unique values (``np.unique``'s order, by hashing)."""
    codes, uniques = pd.factorize(values, sort=True, use_na_sentinel=False)
    return codes.astype(np.int64), uniques


def order_keys(values: pd.Series) -> np.ndarray:
    """int64 keys that sort as ``values`` sort: an integer column as it
    is, any other its `factorize` codes."""
    if pd.api.types.is_integer_dtype(values.dtype):
        return values.to_numpy(dtype=np.int64, copy=True)
    return factorize(values)[0]


# ------------------------------------------------------------------ interactions
@dataclass
class CodedInteractions:
    """Interaction rows on a device: ``user`` / ``item`` are codes into
    the sorted unique raw ids ``users`` / ``items``, ``time`` keys that
    sort as the timestamps (`order_keys`), ``row`` each row's position in
    the host ``frame``."""

    frame: pd.DataFrame
    users: pd.Index
    items: pd.Index
    user: torch.Tensor
    item: torch.Tensor
    time: torch.Tensor
    row: torch.Tensor

    def __len__(self) -> int:
        return self.row.shape[0]

    def take(self, sel: torch.Tensor) -> "CodedInteractions":
        """The rows a bool mask or an index tensor selects, in its order."""
        return CodedInteractions(self.frame, self.users, self.items,
                                 self.user[sel], self.item[sel],
                                 self.time[sel], self.row[sel])

    def pair(self) -> torch.Tensor:
        return self.user * len(self.items) + self.item

    def to_frame(self) -> pd.DataFrame:
        """The host frame's rows in this order, with their labels."""
        return self.frame.iloc[self.row.cpu().numpy()]

    def user_ids(self) -> set:
        """The raw ids of the users left."""
        return set(self.users.take(torch.unique(self.user).cpu().numpy()))

    def item_ids(self) -> set:
        return set(self.items.take(torch.unique(self.item).cpu().numpy()))


def encode_interactions(lhs: pd.DataFrame, device="cuda"
                        ) -> CodedInteractions:
    """Factorize ``user`` and ``item`` on the host, key the timestamps
    (`order_keys`) and move the codes to ``device``."""
    dev = as_device(device)
    (user, users), (item, items) = (factorize(lhs[c])
                                    for c in ("user", "item"))
    return CodedInteractions(
        lhs, users, items, *(torch.from_numpy(c).to(dev) for c in (
            user, item, order_keys(lhs["timestamp"]))),
        torch.arange(len(lhs), device=dev))


def filter_min_interactions(lhs: CodedInteractions, min_interactions: int
                            ) -> CodedInteractions:
    """Keep (user, item) pairs that occur at least `min_interactions`
    times."""
    if min_interactions <= 1:
        return lhs
    _, inverse, counts = torch.unique(lhs.pair(), return_inverse=True,
                                      return_counts=True)
    out = lhs.take(counts[inverse] >= min_interactions)
    log.info("min-interaction filter (%d): %d -> %d rows",
             min_interactions, len(lhs), len(out))
    return out


def filter_unique(lhs: CodedInteractions) -> CodedInteractions:
    """Deduplicate (user, item), keeping the earliest interaction by
    timestamp; rows in timestamp order."""
    order = lexsort(lhs.time)
    pairs = torch.sort(lhs.pair()[order], stable=True)
    head = torch.ones_like(pairs.values, dtype=torch.bool)
    head[1:] = pairs.values[1:] != pairs.values[:-1]
    keep = torch.zeros_like(head)
    keep[pairs.indices[head]] = True
    out = lhs.take(order[keep])
    log.info("dedup: %d -> %d rows", len(lhs), len(out))
    return out


def filter_k_core(lhs: CodedInteractions, k: int) -> CodedInteractions:
    """Iterated k-core: drop items then users with < k interactions until
    stable."""
    if k <= 0:
        return lhs
    while True:
        before = len(lhs)
        counts = torch.bincount(lhs.item, minlength=len(lhs.items))
        lhs = lhs.take(counts[lhs.item] >= k)
        counts = torch.bincount(lhs.user, minlength=len(lhs.users))
        lhs = lhs.take(counts[lhs.user] >= k)
        if len(lhs) == before:
            return lhs


def _first_appearance(codes: torch.Tensor, n: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(index_of_code [n], firsts)``: the codes present in ``codes``
    numbered 0.. by first appearance (-1 for absent codes), and the
    position of each one's first appearance, in that numbering."""
    pos = torch.arange(codes.shape[0], device=codes.device)
    first = torch.full((n,), codes.shape[0], device=codes.device,
                       dtype=torch.int64).scatter_reduce(
        0, codes, pos, "amin")
    present = torch.nonzero(first < codes.shape[0]).squeeze(1)
    firsts, order = torch.sort(first[present])
    index_of = torch.full((n,), -1, device=codes.device, dtype=torch.int64)
    index_of[present[order]] = torch.arange(present.shape[0],
                                            device=codes.device)
    return index_of, firsts


def create_index(lhs: CodedInteractions
                 ) -> tuple[pd.DataFrame, pd.DataFrame, pd.DataFrame]:
    """Assign dense 0..N indices by first appearance in (timestamp, user,
    item) order, for determinism; the indexed frame (the raw columns, then
    ``user_idx`` and ``item_idx``) in that order, and the id maps."""
    order = lexsort(lhs.time, lhs.user, lhs.item)
    lhs = lhs.take(order)
    frame = lhs.to_frame().reset_index(drop=True)
    out = [frame]
    for entity, codes, n in (("user", lhs.user, len(lhs.users)),
                             ("item", lhs.item, len(lhs.items))):
        index_of, firsts = _first_appearance(codes, n)
        out.append(pd.DataFrame({
            entity: frame[entity].iloc[firsts.cpu().numpy()]
            .reset_index(drop=True),
            f"{entity}_idx": np.arange(firsts.shape[0], dtype=np.int64)}))
        frame[f"{entity}_idx"] = index_of[codes].cpu().numpy()
    return tuple(out)


# --------------------------------------------------------------- tabular features
def filter_values(df: pd.DataFrame, column: str, values: Iterable
                  ) -> pd.DataFrame:
    return df[df[column].isin(set(values))]


def filter_range(df: pd.DataFrame, column: str, low=None, high=None
                 ) -> pd.DataFrame:
    mask = pd.Series(True, index=df.index)
    if low is not None:
        mask &= df[column] >= low
    if high is not None:
        mask &= df[column] <= high
    return df[mask]


def filter_missing(df: pd.DataFrame, column: str) -> pd.DataFrame:
    return df[df[column].notna()]


def filter_top_categories(df: pd.DataFrame, column: str, n: int
                          ) -> pd.DataFrame:
    top = df[column].value_counts().index[:n]
    return df[df[column].isin(set(top))]


_TABULAR_FILTERS = {
    "filter_values": filter_values,
    "filter_range": filter_range,
    "filter_missing": filter_missing,
    "filter_top": filter_top_categories,
}


def apply_tabular_filters(entity: str, features: EntityFeatures,
                          configs: list[PPFeatureConfig]) -> EntityFeatures:
    """Run each feature's preprocessing step list over the tabular
    frame."""
    df = features.tabular
    if df is None:
        return features
    for fc in configs:
        for step in fc.preprocessing:
            if step.kind not in _TABULAR_FILTERS:
                raise ValueError(
                    f"preprocessing kind {step.kind!r} not supported; "
                    f"choose from {sorted(_TABULAR_FILTERS)}")
            before = len(df)
            df = _TABULAR_FILTERS[step.kind](df, fc.name, **step.parameters)
            log.info("%s %s on %r: %d -> %d", entity, step.kind, fc.name,
                     before, len(df))
    return EntityFeatures(tabular=df, multidimensional=features.multidimensional)


# ---------------------------------------------------------------- cross-filtering
def entity_ids_with_all_features(features: EntityFeatures) -> set | None:
    """Ids present in the tabular frame and every nd feature (None: no
    features)."""
    sets = []
    if features.tabular is not None:
        id_col = features.tabular.columns[0]  # '{entity}' id column
        sets.append(set(features.tabular[id_col]))
    for f in features.multidimensional.values():
        sets.append(set(np.asarray(f.indices).tolist()))
    if not sets:
        return None
    out = sets[0]
    for s in sets[1:]:
        out &= s
    return out


def filter_history_by_features(lhs: pd.DataFrame, entity: str,
                               features: EntityFeatures) -> pd.DataFrame:
    """Drop interactions of entities lacking any configured feature."""
    ids = entity_ids_with_all_features(features)
    if ids is None:
        return lhs
    return lhs[lhs[entity].isin(ids)]


def filter_features_by_ids(entity: str, features: EntityFeatures,
                           ids: Iterable, id_col: str | None = None
                           ) -> EntityFeatures:
    """Restrict features to the given entity ids. `id_col` names the
    tabular column holding the ids (default the raw ``'{entity}'``
    column; ``'{entity}_idx'`` after reindexing)."""
    ids = set(ids)
    id_col = id_col or entity
    tabular = None
    if features.tabular is not None:
        tabular = features.tabular[features.tabular[id_col].isin(ids)]
    multi = {}
    for name, f in features.multidimensional.items():
        mask = np.isin(np.asarray(f.indices), list(ids))
        multi[name] = MultiDFeature(f.indices[mask], f.values[mask])
    return EntityFeatures(tabular=tabular, multidimensional=multi)


# --------------------------------------------------------------------- reindexing
def reindex_features(entity: str, features: EntityFeatures,
                     id_map: pd.DataFrame) -> EntityFeatures:
    """Attach ``'{entity}_idx'`` to tabular features and remap nd feature
    indices to the dense index space; entities absent from the map are
    dropped."""
    idx_col = f"{entity}_idx"
    tabular = None
    if features.tabular is not None:
        tabular = features.tabular.merge(id_map, on=entity)
    mapping = dict(zip(id_map[entity], id_map[idx_col]))
    multi = {}
    for name, f in features.multidimensional.items():
        keep = np.array([i in mapping for i in np.asarray(f.indices)],
                        dtype=bool)
        new_idx = np.array([mapping[i] for i in np.asarray(f.indices)[keep]],
                           dtype=np.int64)
        order = np.argsort(new_idx)
        multi[name] = MultiDFeature(new_idx[order], f.values[keep][order])
    return EntityFeatures(tabular=tabular, multidimensional=multi)
