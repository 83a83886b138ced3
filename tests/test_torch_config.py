"""The port's config loader (``sibrar_tpu_torch.config_from_dict``) against
the JAX package's ``sibrar_tpu.config.schema.from_dict`` on the same dicts:
coercion of string numerics, ``None`` under ``Optional``, lists, tuples,
enums and nested dataclasses, unknown keys, and every ``validate`` error of
the configs the port has."""
from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Optional, Union

import pytest

from sibrar_tpu.config import schema as jax_schema
from sibrar_tpu.models import sbnet as jax_sbnet
from sibrar_tpu_torch import config_from_dict
from sibrar_tpu_torch.models import sbnet
from sibrar_tpu_torch.train.trainer import (
    DatasetConfig,
    EvalConfig,
    LearningConfig,
)


class Color(str, enum.Enum):
    RED = "red"
    BLUE = "blue"


@dataclass
class Leaf:
    name: str
    size: int = 1


@dataclass
class Shapes:
    """Every annotation the coercion handles, in one dataclass both
    packages load."""

    kind: Color = Color.RED
    kinds: list[Color] = field(default_factory=list)
    dims: tuple[int, ...] = ()
    scale: Optional[tuple[float, ...]] = None
    either: Union[int, str] = 0
    flag: bool = False
    opts: dict = field(default_factory=dict)
    leaf: Optional[Leaf] = None
    leaves: list[Leaf] = field(default_factory=list)
    raw: list = field(default_factory=list)


def plain(obj):
    """Dataclasses as dicts, enums as their values: the two packages' own
    classes compare by content."""
    if dataclasses.is_dataclass(obj):
        return {f.name: plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return type(obj)(plain(v) for v in obj)
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    return obj


def port_fields(port_obj, jax_obj) -> dict:
    """The JAX object's values of the port class's fields."""
    full = plain(jax_obj)
    return {f.name: full[f.name] for f in dataclasses.fields(port_obj)}


# (port class, JAX class, dict): each loaded by both packages
CASES = {
    "learn_string_numerics": (
        LearningConfig, jax_schema.LearningConfig,
        {"lr": "1e-4", "n_epochs": "3", "wd": "0.01", "max_patience": "5",
         "sparse_table_min_rows": "8"}),
    "learn_optional_none": (
        LearningConfig, jax_schema.LearningConfig,
        {"max_batches_per_epoch": None, "epoch_scan_chunk": None,
         "moment_dtype": None}),
    "learn_optional_from_string": (
        LearningConfig, jax_schema.LearningConfig,
        {"max_batches_per_epoch": "7", "epoch_scan_chunk": "64",
         "sparse_tables": 1}),
    "learn_unknown_keys": (
        LearningConfig, jax_schema.LearningConfig,
        {"optimizer": "adamw", "not_a_field": 3, "profile": {"a": 1}}),
    "learn_none": (LearningConfig, jax_schema.LearningConfig, None),
    "eval_int_list_from_strings": (
        EvalConfig, jax_schema.EvalConfig,
        {"top_k": ["1", "5", "10"], "metrics": ["ndcg"],
         "topk_method": "pallas", "compute_std": 0}),
    "eval_score_dtype": (
        EvalConfig, jax_schema.EvalConfig,
        {"score_dtype": "float32", "group_metrics": ["gender"]}),
    "dataset_numerics": (
        DatasetConfig, jax_schema.DatasetConfig,
        {"n_negative_samples": "10", "popularity_squashing_factor": "0.5",
         "negative_sampling_strategy": "popular", "dataset_path": "x"}),
    "sbnet_entity_nested": (
        sbnet.SingleBranchNetEntityConfig,
        jax_sbnet.SingleBranchNetEntityConfig,
        {"features": [{"feature_name": "interactions"},
                      {"feature_name": "bert",
                       "feature_hidden_layers": ["64", 32]}],
         "single_branch_hidden_layers": ["512", "256"],
         "common_modality_dim": "512", "train_modalities": ["bert"],
         "single_branch_input_dropout": "0.2",
         "embedding_regularization_type": "pairwise_single",
         "regularization_weight": "0.5", "apply_batch_norm_every": "2",
         "routed_modality_sampling": None}),
    "sbnet_entity_enum_default": (
        sbnet.SingleBranchNetEntityConfig,
        jax_sbnet.SingleBranchNetEntityConfig,
        {"features": [], "eval_modalities": None}),
    "sbnet_feature": (
        sbnet.SingleBranchFeatureConfig, jax_sbnet.SingleBranchFeatureConfig,
        {"feature_name": "genres", "feature_hidden_layers": None}),
    "sbnet_feature_module": (
        sbnet.SBFeatureModuleConfig, jax_sbnet.SBFeatureModuleConfig,
        {"feature_name": "interactions", "embedding_dim": "256",
         "pre_embedding_layers": ["128"], "activation_fn": "tanh"}),
    "shapes_enums_tuples_unions": (
        Shapes, Shapes,
        {"kind": "blue", "kinds": ["red", Color.BLUE], "dims": ["3", 4],
         "scale": ["0.5"], "either": "7", "flag": 1, "opts": [("a", 1)],
         "leaf": {"name": "x", "size": "2"},
         "leaves": [{"name": "y"}, {"name": "z", "size": 9.0}],
         "raw": ["1", 2]}),
    "shapes_union_falls_through": (
        Shapes, Shapes, {"either": "seven", "scale": None, "leaf": None}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_config_from_dict_matches_jax_from_dict(case):
    port_cls, jax_cls, data = CASES[case]
    got = config_from_dict(port_cls, data)
    want = jax_schema.from_dict(jax_cls, data)
    assert plain(got) == port_fields(got, want)
    for f in dataclasses.fields(got):  # same types, not only equal values
        assert type(plain(getattr(got, f.name))) is type(
            port_fields(got, want)[f.name]), f.name


def test_config_from_dict_acceptance_values():
    learn = config_from_dict(LearningConfig, {"lr": "1e-4", "n_epochs": "3"})
    assert learn.lr == 1e-4 and type(learn.lr) is float
    assert learn.n_epochs == 3 and type(learn.n_epochs) is int
    ec = config_from_dict(sbnet.SingleBranchNetEntityConfig,
                          {"features": [{"feature_name": "bert"}]})
    assert ec.features == [sbnet.SingleBranchFeatureConfig("bert")]


# (port class, JAX class, dict): each must fail validation in both
INVALID = {
    "learn_epoch_scan_chunk": (LearningConfig, jax_schema.LearningConfig,
                               {"epoch_scan_chunk": 0}),
    "learn_optimizer": (LearningConfig, jax_schema.LearningConfig,
                        {"optimizer": "sgd"}),
    "learn_sparse_tables": (LearningConfig, jax_schema.LearningConfig,
                            {"sparse_tables": True, "optimizer": "adamw"}),
    "learn_sparse_table_min_rows": (LearningConfig,
                                    jax_schema.LearningConfig,
                                    {"sparse_table_min_rows": "0"}),
    "learn_moment_dtype": (LearningConfig, jax_schema.LearningConfig,
                           {"moment_dtype": "float16"}),
    "learn_rec_loss": (LearningConfig, jax_schema.LearningConfig,
                       {"rec_loss": "hinge"}),
    "learn_loss_aggregator": (LearningConfig, jax_schema.LearningConfig,
                              {"loss_aggregator": "max"}),
    "learn_lr": (LearningConfig, jax_schema.LearningConfig, {"lr": "0"}),
    "learn_wd": (LearningConfig, jax_schema.LearningConfig, {"wd": -1e-3}),
    "dataset_strategy": (DatasetConfig, jax_schema.DatasetConfig,
                         {"negative_sampling_strategy": "hard"}),
    "eval_top_k": (EvalConfig, jax_schema.EvalConfig, {"top_k": ["0", 5]}),
    "eval_topk_method": (EvalConfig, jax_schema.EvalConfig,
                         {"topk_method": "bogus"}),
    "eval_score_dtype": (EvalConfig, jax_schema.EvalConfig,
                         {"score_dtype": "float16"}),
    "not_an_int": (LearningConfig, jax_schema.LearningConfig,
                   {"n_epochs": "three"}),
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_validate_errors_raise_in_both_packages(case):
    port_cls, jax_cls, data = INVALID[case]
    with pytest.raises(ValueError):
        jax_schema.from_dict(jax_cls, data)
    with pytest.raises(ValueError):
        config_from_dict(port_cls, data)


def test_bf16_scores_stay_unported_at_load():
    """``score_dtype: bfloat16`` loads in the port as in JAX (it was refused
    here before the bf16 path was ported), and another dtype raises
    ``ValueError`` in both."""
    want = jax_schema.from_dict(jax_schema.EvalConfig,
                                {"score_dtype": "bfloat16"})
    got = config_from_dict(EvalConfig, {"score_dtype": "bfloat16"})
    assert got.score_dtype == want.score_dtype == "bfloat16"
    for data in ({"score_dtype": "float16"}, {"score_dtype": "int8"}):
        with pytest.raises(ValueError, match="unsupported score_dtype"):
            jax_schema.from_dict(jax_schema.EvalConfig, data)
        with pytest.raises(ValueError, match="unsupported score_dtype"):
            config_from_dict(EvalConfig, data)


NESTED = {"learn": {"lr": 0.01, "opt": None}, "model": {"item": {
    "features": [{"name": "a"}], "dim": 0}}, "flat": 3, "none": None}


@pytest.mark.parametrize("key", [
    "learn.lr", "learn.opt", "learn.missing", "model.item.dim",
    "model.item.features", "model.item.dim.deeper", "model.user.dim",
    "flat", "flat.x", "none.x", "absent", "model"])
def test_nested_dict_get_matches_jax(key):
    """``nested_dict_get`` (JAX ``config/loader.py:100``): the value at a
    dotted key, or the default where a level is missing or not a dict."""
    from sibrar_tpu.config.loader import nested_dict_get as jax_get
    from sibrar_tpu_torch.config.loader import nested_dict_get

    for default in (None, "dflt"):
        assert nested_dict_get(NESTED, key, default) == jax_get(
            NESTED, key, default)
