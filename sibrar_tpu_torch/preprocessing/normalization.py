"""Feature normalization with the cold-start leakage rule (port of
``sibrar_tpu/preprocessing/normalization.py``).

Scalers {standard, minmax, robust, normal(izer), identity} are applied per
feature, column-wise as sklearn defines them, in numpy on the host with
the JAX package's operations, so the written tables are its bytes. The fit basis is
the train split only for cold-start splits and all splits for random /
temporal ones: in warm splits the same entities appear everywhere, while
fitting on cold val / test entities would leak.
"""
from __future__ import annotations

import numpy as np
import pandas as pd

from sibrar_tpu_torch.config.schema import FeatureType
from sibrar_tpu_torch.preprocessing.ppconfig import (
    PPFeatureConfig,
    PreprocessingConfig,
    SplitType,
)
from sibrar_tpu_torch.preprocessing.records import (
    AllSplitsData,
    EntityFeatures,
)


class _Scaler:
    def fit(self, x: np.ndarray) -> "_Scaler":
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        return x


class StandardScaler(_Scaler):
    def fit(self, x):
        self.mean = x.mean(axis=0)
        self.std = x.std(axis=0)
        return self

    def transform(self, x):
        return (x - self.mean) / np.where(self.std == 0, 1.0, self.std)


class MinMaxScaler(_Scaler):
    def __init__(self, feature_range=(0.0, 1.0)):
        self.lo, self.hi = feature_range

    def fit(self, x):
        self.min = x.min(axis=0)
        span = x.max(axis=0) - self.min
        self.span = np.where(span == 0, 1.0, span)
        return self

    def transform(self, x):
        return (x - self.min) / self.span * (self.hi - self.lo) + self.lo


class RobustScaler(_Scaler):
    def fit(self, x):
        self.median = np.median(x, axis=0)
        q75, q25 = np.percentile(x, [75, 25], axis=0)
        iqr = q75 - q25
        self.iqr = np.where(iqr == 0, 1.0, iqr)
        return self

    def transform(self, x):
        return (x - self.median) / self.iqr


class Normalizer(_Scaler):
    """Row-wise L2 normalization (stateless, like sklearn's Normalizer)."""

    def transform(self, x):
        norm = np.linalg.norm(x, axis=-1, keepdims=True)
        return x / np.where(norm == 0, 1.0, norm)


def get_normalizer(kind: str | None, parameters: dict | None = None
                   ) -> _Scaler:
    parameters = parameters or {}
    if kind is None or kind == "identity":
        return _Scaler()
    if kind == "standard":
        return StandardScaler()
    if kind == "minmax":
        return MinMaxScaler(**parameters)
    if kind == "robust":
        return RobustScaler()
    if kind == "normal":
        return Normalizer()
    raise ValueError(
        f"normalizer kind {kind!r} not supported; choose from "
        f"['standard', 'minmax', 'robust', 'normal', 'identity']")


def _merged_basis(entity: str, splits: list[EntityFeatures], name: str,
                  feature_type: FeatureType) -> np.ndarray:
    """Union of the feature's values across splits (first occurrence
    wins)."""
    if feature_type in (FeatureType.VECTOR, FeatureType.MATRIX):
        seen: dict = {}
        for ef in splits:
            f = ef.multidimensional[name]
            for i, v in zip(np.asarray(f.indices), f.values):
                seen.setdefault(int(i), v)
        return np.stack(list(seen.values()))
    frames = [ef.tabular for ef in splits if ef.tabular is not None]
    df = pd.concat(frames).drop_duplicates(subset=f"{entity}_idx") \
        if f"{entity}_idx" in frames[0].columns else pd.concat(frames)
    return df[name].to_numpy().reshape(-1, 1)


def _normalize_entity(entity: str, splits: list[EntityFeatures],
                      configs: list[PPFeatureConfig], train_only_basis: bool):
    for fc in configs:
        if not fc.normalization:
            continue
        if fc.type in (FeatureType.CATEGORICAL, FeatureType.TAG):
            raise ValueError(
                f"{fc.type.value} feature {fc.name!r} cannot be normalized")
        for step in fc.normalization:
            normalizer = get_normalizer(step.kind, step.parameters)
            if train_only_basis:
                basis = _merged_basis(entity, splits[:1], fc.name, fc.type)
            else:
                basis = _merged_basis(entity, splits, fc.name, fc.type)
            normalizer.fit(basis)
            # warm splits share one EntityFeatures object across train,
            # val and test (splitting.py): transform each distinct object
            # exactly once
            seen_ids: set[int] = set()
            unique_splits = [
                ef for ef in splits
                if not (id(ef) in seen_ids or seen_ids.add(id(ef)))]
            for ef in unique_splits:
                if fc.type in (FeatureType.VECTOR, FeatureType.MATRIX):
                    f = ef.multidimensional[fc.name]
                    f.values = normalizer.transform(f.values)
                else:
                    vals = ef.tabular[fc.name].to_numpy().reshape(-1, 1)
                    ef.tabular = ef.tabular.assign(
                        **{fc.name: normalizer.transform(vals).reshape(-1)})


def normalize_features(data: AllSplitsData, config: PreprocessingConfig
                       ) -> AllSplitsData:
    train_only = config.split.split_type == SplitType.COLDSTART
    _normalize_entity(
        "user",
        [data.train.user_features, data.val.user_features,
         data.test.user_features],
        config.user_features, train_only)
    _normalize_entity(
        "item",
        [data.train.item_features, data.val.item_features,
         data.test.item_features],
        config.item_features, train_only)
    return data
