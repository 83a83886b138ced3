"""End-to-end preprocessing (port of
``sibrar_tpu/preprocessing/pipeline.py``): load, then cross-filter the
history against the features, the tabular feature filters, the
interaction filters (min count, dedup, k-core), reindex, split (random,
temporal, cold-start), normalize (fit on train only iff cold-start) and
store in the artifact layout.

The interaction stages run on ``device``: the card by default, raising
without one; ``"cpu"`` runs the same torch code on the CPU. Both write the
same bytes.
"""
from __future__ import annotations

import logging
import os
import time
from contextlib import contextmanager

import numpy as np
import pandas as pd
import torch

from sibrar_tpu_torch.config.schema import FeatureType
from sibrar_tpu_torch.preprocessing.filtering import (
    apply_tabular_filters,
    as_device,
    create_index,
    encode_interactions,
    filter_features_by_ids,
    filter_history_by_features,
    filter_k_core,
    filter_min_interactions,
    filter_unique,
    reindex_features,
)
from sibrar_tpu_torch.preprocessing.normalization import normalize_features
from sibrar_tpu_torch.preprocessing.ppconfig import PreprocessingConfig
from sibrar_tpu_torch.preprocessing.records import (
    AllSplitsData,
    EntityFeatures,
    MultiDFeature,
    RawData,
)
from sibrar_tpu_torch.preprocessing.splitting import split_ratio_based
from sibrar_tpu_torch.preprocessing.store import split_dir_name, store_splits

log = logging.getLogger(__name__)

@contextmanager
def timed(timings: dict | None, stage: str, dev: torch.device):
    """Add the stage's wall seconds to ``timings[stage]`` (the card's work
    included: synchronized at the end)."""
    t0 = time.perf_counter()
    yield
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if timings is not None:
        timings[stage] = timings.get(stage, 0.0) + time.perf_counter() - t0


def load_raw(data_dir: str, config: PreprocessingConfig) -> RawData:
    """Read ``listening_history.csv`` and the feature files of a raw
    dataset directory."""
    lhs = pd.read_csv(os.path.join(data_dir, "listening_history.csv"))
    if "timestamp" not in lhs.columns:
        lhs = lhs.assign(timestamp=np.arange(len(lhs)))

    def load_entity(entity: str, feature_configs) -> EntityFeatures:
        tabular = None
        csv = os.path.join(data_dir, f"{entity}_features.csv")
        tab_names = [fc.name for fc in feature_configs
                     if fc.type not in (FeatureType.VECTOR,
                                        FeatureType.MATRIX)]
        if tab_names:
            if not os.path.exists(csv):
                raise FileNotFoundError(f"feature file {csv!r} does not "
                                        f"exist")
            tabular = pd.read_csv(csv)
            missing = set(tab_names) - set(tabular.columns)
            if missing:
                raise ValueError(f"columns for {entity} feature(s) "
                                 f"{sorted(missing)} are missing in {csv}")
            tabular = tabular[[entity, *tab_names]]
        multi = {}
        for fc in feature_configs:
            if fc.type in (FeatureType.VECTOR, FeatureType.MATRIX):
                f = os.path.join(data_dir, f"{entity}_{fc.name}.npz")
                if not os.path.exists(f):
                    raise FileNotFoundError(f"data file for {entity} feature "
                                            f"{fc.name!r} does not exist")
                loaded = np.load(f, allow_pickle=True)
                multi[fc.name] = MultiDFeature(loaded["indices"],
                                               loaded["values"])
        return EntityFeatures(tabular=tabular, multidimensional=multi)

    return RawData(
        interactions=lhs,
        user_features=load_entity("user", config.user_features),
        item_features=load_entity("item", config.item_features),
    )


def preprocess(data: RawData, config: PreprocessingConfig,
               out_base: str | None = None, device="cuda",
               timings: dict | None = None) -> AllSplitsData:
    """Run the pipeline, the interaction stages on ``device``; write the
    artifacts iff ``out_base`` is given (into
    ``{out_base}/{split_dir_name}``). ``timings``, where given, gets each
    stage's seconds: filters, k_core, reindex, split, normalize, store
    (the CLI adds read, `load_raw`)."""
    dev = as_device(device)
    with timed(timings, "filters", dev):
        # 1. tabular feature filters, then cross-filter history and features
        user_features = apply_tabular_filters("user", data.user_features,
                                              config.user_features)
        item_features = apply_tabular_filters("item", data.item_features,
                                              config.item_features)
        lhs = data.interactions
        if config.require_all_features:
            lhs = filter_history_by_features(lhs, "user", user_features)
            lhs = filter_history_by_features(lhs, "item", item_features)

        # 2. interaction filters, on the device
        coded = encode_interactions(lhs, dev)
        coded = filter_min_interactions(coded,
                                        config.interactions.min_interactions)
        if config.interactions.deduplicate:
            coded = filter_unique(coded)
    with timed(timings, "k_core", dev):
        coded = filter_k_core(coded, config.interactions.k_core)
    if len(coded) == 0:
        raise ValueError("no interactions left after filtering")

    with timed(timings, "reindex", dev):
        # 3. restrict features to surviving entities, reindex everything
        user_features = filter_features_by_ids("user", user_features,
                                               coded.user_ids())
        item_features = filter_features_by_ids("item", item_features,
                                               coded.item_ids())
        lhs, user_idxs, item_idxs = create_index(coded)
        user_features = reindex_features("user", user_features, user_idxs)
        item_features = reindex_features("item", item_features, item_idxs)
        indexed = RawData(interactions=lhs, user_features=user_features,
                          item_features=item_features)

    # 4. split, 5. normalize (the fit basis rule inside)
    with timed(timings, "split", dev):
        splits = split_ratio_based(indexed, config.split, device=dev)
    with timed(timings, "normalize", dev):
        splits = normalize_features(splits, config)

    # 6. store
    if out_base:
        with timed(timings, "store", dev):
            out_dir = os.path.join(out_base, split_dir_name(config))
            store_splits(out_dir, splits, config, user_idxs, item_idxs)
        log.info("stored splits to %s", out_dir)
    return splits
