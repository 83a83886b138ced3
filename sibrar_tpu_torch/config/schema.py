"""Typed experiment configuration (port of ``sibrar_tpu/config/schema.py``).

The dataclasses of a run's config, loaded from the merged YAML dict by
``sibrar_tpu_torch.config_from_dict`` (JAX's ``from_dict``: coercion to the
annotations, unknown keys ignored, ``validate()``). Standard library only.

Fields that only the TPU package acts on are accepted and ignored:
``learn.epoch_scan_chunk`` (the port runs its steps eagerly),
``loader.num_workers`` / ``prefetch_factor`` / ``shuffle`` (batches are
drawn on the device) and ``run_settings.device: tpu``, which means the card
(`experiment.py`). ``parallel.*`` sets the device mesh of a run under
torchrun (`parallel.mesh.make_mesh_from_config`); in one process it asks
for one device, whatever it says.
"""
from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Any, Optional

# the exact top-k strategies of ``ops/topk.py`` (``eval.topk_method``)
TOPK_METHODS = ("auto", "full", "scatter", "noscatter", "peel", "pallas")


class FeatureType(str, enum.Enum):
    CATEGORICAL = "categorical"
    TAG = "tag"
    DISCRETE = "discrete"
    CONTINUOUS = "continuous"
    SEQUENCE = "sequence"
    VECTOR = "vector"
    MATRIX = "matrix"


class DatasetSplitType(str, enum.Enum):
    RANDOM = "random"
    TEMPORAL = "temporal"
    COLD_START_USER = "cold_start_user"
    COLD_START_ITEM = "cold_start_item"
    COLD_START_BOTH = "cold_start_both"

    @property
    def is_cold_start(self) -> bool:
        return self.value.startswith("cold_start_")

    @property
    def dir_name(self) -> str:
        """The split's artifact and results sub-directory."""
        return {DatasetSplitType.RANDOM: "random_split",
                DatasetSplitType.TEMPORAL: "temporal_split"}.get(
                    self, self.value)


def as_dict(obj: Any) -> Any:
    """Dataclass -> plain dict; enums become their string values."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: as_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [as_dict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: as_dict(v) for k, v in obj.items()}
    return obj


@dataclass
class RunSettings:
    """``device``: ``tpu`` or ``cuda`` run on the card, ``cpu`` on the
    CPU. ``debug_nans`` raises at the first train step with a NaN
    (``train/trainer.py``)."""

    seed: int = 64
    device: str = "tpu"
    in_tune: bool = False
    use_wandb: bool = False
    debug_nans: bool = False

    def validate(self) -> None:
        if self.device not in ("tpu", "cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device!r} (use "
                             f"'cuda', 'tpu' for the card, or 'cpu')")


@dataclass
class DataLoaderConfig:
    batch_size: int = 64
    eval_batch_size: int = 256
    num_workers: int = 0
    shuffle: bool = True
    prefetch_factor: int = 2

    def validate(self) -> None:
        if self.batch_size <= 0 or self.eval_batch_size <= 0:
            raise ValueError("batch sizes must be positive")


@dataclass
class LearningConfig:
    """The ``learn:`` block. ``n_epochs``, ``max_patience`` and
    ``optimizing_metric`` belong to ``Trainer.fit``."""

    n_epochs: int = 50
    lr: float = 1e-3
    wd: float = 0.0
    optimizer: str = "adam"
    rec_loss: str = "bce"
    loss_aggregator: str = "mean"
    max_patience: int = 10
    optimizing_metric: str = "ndcg@10"
    max_batches_per_epoch: Optional[int] = None
    moment_dtype: Optional[str] = None
    sparse_tables: bool = False
    sparse_table_min_rows: int = 16384
    epoch_scan_chunk: Optional[int] = 512

    def validate(self) -> None:
        if self.epoch_scan_chunk is not None and self.epoch_scan_chunk < 1:
            raise ValueError("epoch_scan_chunk must be >= 1 or null")
        if self.optimizer not in ("adam", "adagrad", "adamw"):
            raise ValueError(f"unsupported optimizer {self.optimizer!r}")
        if self.sparse_tables and self.optimizer != "adam":
            raise ValueError(
                "sparse_tables requires optimizer='adam' (SparseAdam "
                f"semantics); got {self.optimizer!r}")
        if self.sparse_table_min_rows < 1:
            raise ValueError("sparse_table_min_rows must be >= 1")
        if self.moment_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(
                f"unsupported moment_dtype {self.moment_dtype!r}")
        if self.rec_loss not in ("bce", "bpr", "sampled_softmax"):
            raise ValueError(f"unsupported rec_loss {self.rec_loss!r}")
        if self.loss_aggregator not in ("mean", "sum"):
            raise ValueError(
                f"unsupported loss aggregator {self.loss_aggregator!r}")
        if not self.lr > 0:
            raise ValueError("lr must be > 0")
        if self.wd < 0:
            raise ValueError("wd must be >= 0")


@dataclass
class EvalConfig:
    """The ``eval:`` block (defaults: the reference's metric surface).
    ``score_dtype``: None / ``float32``, or ``bfloat16`` (dot-product
    scores from bf16-rounded operands, `eval.evaluator.evaluate_model`)."""

    top_k: list[int] = field(
        default_factory=lambda: [1, 3, 5, 10, 20, 50, 100])
    metrics: list[str] = field(default_factory=lambda: [
        "ndcg", "recall", "precision", "f_score", "hitrate", "ap",
        "coverage"])
    group_metrics: list[str] = field(default_factory=list)
    compute_std: bool = True
    topk_method: str = "auto"
    score_dtype: Optional[str] = None

    def validate(self) -> None:
        if any(k <= 0 for k in self.top_k):
            raise ValueError("top_k cut-offs must be positive")
        if self.topk_method not in TOPK_METHODS:
            raise ValueError(f"unsupported topk_method {self.topk_method!r}")
        if self.score_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(
                f"unsupported score_dtype {self.score_dtype!r} "
                "(use 'float32' or 'bfloat16')")


@dataclass
class FeatureDefinition:
    name: str
    type: FeatureType = FeatureType.VECTOR


@dataclass
class DatasetConfig:
    """The ``dataset:`` block: the artifact directory, the features to load
    and the negative sampling the trainer reads."""

    dataset_path: str = ""
    is_cold_start_dataset: bool = False
    n_negative_samples: int = 4
    negative_sampling_strategy: str = "uniform"
    popularity_squashing_factor: float = 1.0
    user_features: list[FeatureDefinition] = field(default_factory=list)
    item_features: list[FeatureDefinition] = field(default_factory=list)

    def validate(self) -> None:
        if self.negative_sampling_strategy not in ("uniform",
                                                   "uniform_recbole",
                                                   "popular"):
            raise ValueError(f"unsupported sampling strategy "
                             f"{self.negative_sampling_strategy!r}")


@dataclass
class ParallelConfig:
    """The multi-device block (`parallel.mesh.make_mesh_from_config`):
    ``enabled: null`` turns the mesh on for a world of more than one rank
    on CUDA, ``n_devices`` caps the ranks, ``item_parallelism`` fixes the
    item axis, ``adjust_batch_sizes`` rounds the train batch up to divide
    over the mesh, ``shard_towers`` / ``tower_min_rows`` row-slice the
    interaction towers' kernels over the item axis."""

    enabled: Optional[bool] = None
    n_devices: Optional[int] = None
    item_parallelism: Optional[int] = None
    adjust_batch_sizes: bool = True
    shard_towers: bool = True
    tower_min_rows: int = 8192

    def validate(self) -> None:
        if self.n_devices is not None and self.n_devices <= 0:
            raise ValueError("n_devices must be positive")
        if self.item_parallelism is not None and self.item_parallelism <= 0:
            raise ValueError("item_parallelism must be positive")
        if self.tower_min_rows < 0:
            raise ValueError("tower_min_rows must be non-negative")


@dataclass
class WandbConfig:
    use_wandb: bool = False
    project: str = "sibrar_tpu"
    entity: Optional[str] = None
    sweep_id: Optional[str] = None
    wandb_path: Optional[str] = None
    tags: list[str] = field(default_factory=list)


@dataclass
class ExperimentConfig:
    run_id: str = ""
    algorithm: str = "mf"
    dataset_name: str = "synthetic"
    split_type: DatasetSplitType = DatasetSplitType.RANDOM
    results_path: str = ""
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    model: dict = field(default_factory=dict)
    learn: LearningConfig = field(default_factory=LearningConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    loader: DataLoaderConfig = field(default_factory=DataLoaderConfig)
    run_settings: RunSettings = field(default_factory=RunSettings)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    wandb: WandbConfig = field(default_factory=WandbConfig)
    train_eval: bool = False
    profile_training: bool = False
