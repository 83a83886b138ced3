"""Artifact storage in the layout both packages read (port of
``sibrar_tpu/preprocessing/store.py``, the same files, dtypes and bytes):

    user_idxs.csv, item_idxs.csv
    listening_history_{split}.csv          (user_idx, item_idx[, timestamp])
    {entity}_features_{split}.csv          (tabular features + {entity}_idx)
    {entity}_{feature}_{split}.npz         (indices=..., values=...)
    used_config.yaml                       (split type etc., read back by
                                            RecDataset)
"""
from __future__ import annotations

import os

import numpy as np

from sibrar_tpu_torch.config.loader import yaml_save
from sibrar_tpu_torch.config.schema import as_dict
from sibrar_tpu_torch.preprocessing.ppconfig import (
    PreprocessingConfig,
    SplitType,
)
from sibrar_tpu_torch.preprocessing.records import AllSplitsData, SplitData


def split_dir_name(config: PreprocessingConfig) -> str:
    if config.split.split_type == SplitType.COLDSTART:
        return f"cold_start_{config.split.cold_start_type.value}"
    return f"{config.split.split_type.value}_split"


def store_split(out_dir: str, split: str, data: SplitData) -> None:
    cols = [c for c in ("user_idx", "item_idx", "timestamp")
            if c in data.interactions.columns]
    data.interactions[cols].to_csv(
        os.path.join(out_dir, f"listening_history_{split}.csv"), index=False)
    for entity, feats in (("user", data.user_features),
                          ("item", data.item_features)):
        if feats.tabular is not None and len(feats.tabular.columns):
            feats.tabular.to_csv(
                os.path.join(out_dir, f"{entity}_features_{split}.csv"),
                index=False)
        for name, f in feats.multidimensional.items():
            np.savez(os.path.join(out_dir, f"{entity}_{name}_{split}.npz"),
                     indices=np.asarray(f.indices),
                     values=np.asarray(f.values))


def store_splits(out_dir: str, data: AllSplitsData,
                 config: PreprocessingConfig, user_idxs=None,
                 item_idxs=None) -> str:
    os.makedirs(out_dir, exist_ok=True)
    if user_idxs is not None:
        user_idxs.to_csv(os.path.join(out_dir, "user_idxs.csv"), index=False)
    if item_idxs is not None:
        item_idxs.to_csv(os.path.join(out_dir, "item_idxs.csv"), index=False)
    for split, sd in data.items():
        store_split(out_dir, split, sd)
    used = as_dict(config)
    used["split"]["split_type"] = config.split.split_type.value
    yaml_save(os.path.join(out_dir, "used_config.yaml"), used)
    return out_dir
