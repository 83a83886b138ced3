"""Preprocessing configuration schema (port of
``sibrar_tpu/preprocessing/ppconfig.py``): split ratios, type, cold-start
type and seed; the interaction filters (min count, dedup, k-core); each
feature's preprocessing and normalization steps. Loaded by
``sibrar_tpu_torch.config_from_dict``, which coerces to the annotations
and runs ``validate()``.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

from sibrar_tpu_torch.config.schema import FeatureType


class SplitType(str, enum.Enum):
    RANDOM = "random"
    TEMPORAL = "temporal"
    COLDSTART = "coldstart"


class ColdStartType(str, enum.Enum):
    USER = "user"
    ITEM = "item"
    BOTH = "both"


@dataclass
class SplitConfig:
    ratios: list[float] = field(default_factory=lambda: [0.8, 0.1, 0.1])
    split_type: SplitType = SplitType.RANDOM
    cold_start_type: ColdStartType = ColdStartType.USER
    seed: int = 13

    def validate(self) -> None:
        if len(self.ratios) != 3:
            raise ValueError("ratios must be (train, val, test)")
        if abs(sum(self.ratios) - 1.0) > 1e-9:
            raise ValueError("ratios do not sum up to 1")


@dataclass
class InteractionConfig:
    min_interactions: int = 1  # keep (user, item) pairs seen this often
    deduplicate: bool = True  # keep a pair's first interaction by timestamp
    k_core: int = 0  # 0 disables k-core filtering


@dataclass
class FeatureStep:
    # filter_values | filter_range | filter_missing | filter_top, or
    # standard | minmax | robust | normal | identity
    kind: str
    parameters: dict = field(default_factory=dict)


@dataclass
class PPFeatureConfig:
    name: str
    type: FeatureType = FeatureType.VECTOR
    preprocessing: list[FeatureStep] = field(default_factory=list)
    normalization: list[FeatureStep] = field(default_factory=list)


@dataclass
class PreprocessingConfig:
    dataset_name: str = ""
    split: SplitConfig = field(default_factory=SplitConfig)
    interactions: InteractionConfig = field(default_factory=InteractionConfig)
    user_features: list[PPFeatureConfig] = field(default_factory=list)
    item_features: list[PPFeatureConfig] = field(default_factory=list)
    # drop entities that do not have every configured feature
    require_all_features: bool = True
