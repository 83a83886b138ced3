"""Preprocessing data containers (port of
``sibrar_tpu/preprocessing/records.py``): dataclasses over pandas and
numpy. Interaction frames carry at least ``user, item, timestamp`` (raw)
or ``user_idx, item_idx`` (indexed).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import pandas as pd

SPLIT_NAMES = ("train", "val", "test")


@dataclass
class MultiDFeature:
    """One vector / matrix feature: ``values[i]`` belongs to entity
    ``indices[i]``."""

    indices: np.ndarray
    values: np.ndarray

    def __post_init__(self):
        if len(self.indices) != len(self.values):
            raise ValueError(
                f"feature indices ({len(self.indices)}) and values "
                f"({len(self.values)}) length mismatch")


@dataclass
class EntityFeatures:
    """All features of one entity type: one tabular frame (with the
    ``'{entity}'`` id column) and the named nd features."""

    tabular: Optional[pd.DataFrame] = None
    multidimensional: Dict[str, MultiDFeature] = field(default_factory=dict)

    def copy(self) -> "EntityFeatures":
        return EntityFeatures(
            tabular=None if self.tabular is None else self.tabular.copy(),
            multidimensional={
                k: MultiDFeature(v.indices.copy(), v.values.copy())
                for k, v in self.multidimensional.items()
            },
        )


@dataclass
class RawData:
    """Interactions and features before or after filtering and indexing."""

    interactions: pd.DataFrame
    user_features: EntityFeatures = field(default_factory=EntityFeatures)
    item_features: EntityFeatures = field(default_factory=EntityFeatures)


@dataclass
class SplitData:
    interactions: pd.DataFrame  # indexed (user_idx, item_idx)
    user_indices: np.ndarray
    item_indices: np.ndarray
    user_features: EntityFeatures
    item_features: EntityFeatures


@dataclass
class AllSplitsData:
    train: SplitData
    val: SplitData
    test: SplitData

    def items(self):
        return zip(SPLIT_NAMES, (self.train, self.val, self.test))
