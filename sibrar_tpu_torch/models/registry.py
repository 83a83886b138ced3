"""Algorithm registry: name -> build function (port of
``sibrar_tpu/models/registry.py``).

The names and families are the JAX registry's, so the CLI offers the same
``-a`` choices: ``sgd`` models train with `train.trainer.Trainer`,
``matrix`` algorithms fit once over the train CSR. An ``sgd`` build takes
``(model_conf, dataset, device_data, seed)`` and returns the model on the
device of ``device_data``, in eval mode. A ``matrix`` build takes
``(model_conf, dataset, device)`` and returns the unfitted algorithm
(``models/matrix_algs.py``), which fits and scores on ``device``. Every
name of the JAX registry is ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from sibrar_tpu_torch.models import matrix_algs
from sibrar_tpu_torch.models.dmf import DeepMatrixFactorization
from sibrar_tpu_torch.models.dropoutnet import DropoutNet
from sibrar_tpu_torch.models.ecf import ECF
from sibrar_tpu_torch.models.feat_mf import (
    ItemFeatureMatrixFactorization,
    UserFeatureMatrixFactorization,
)
from sibrar_tpu_torch.models.mf import ACF, SGDBaseline, SGDMatrixFactorization
from sibrar_tpu_torch.models.protomf import (
    IProtoMF,
    IProtoMFs,
    UIProtoMF,
    UIProtoMFs,
    UProtoMF,
    UProtoMFs,
)
from sibrar_tpu_torch.models.sbnet import SingleBranchNet


@dataclass(frozen=True)
class AlgorithmSpec:
    name: str
    kind: str  # 'sgd' | 'matrix'
    build: Callable


def _sbnet(conf: dict, dataset, device_data, seed: int) -> SingleBranchNet:
    return SingleBranchNet.build_from_conf(conf, dataset, device_data,
                                           seed=seed)


def _on_device(build: Callable) -> Callable:
    """A build of the models besides SBNet: weights from a CPU generator of
    ``seed`` (``build(conf, dataset, device_data, gen)``), then the model
    moved to ``device_data``'s device, in eval mode."""
    def wrapped(conf: dict, dataset, device_data, seed: int):
        model = build(conf, dataset, device_data,
                      torch.Generator().manual_seed(seed))
        return model.to(device_data.catalog.device).eval()
    return wrapped


BUILDS: dict[str, Callable] = {
    "sbnet": _sbnet,
    "sgdbias": _on_device(lambda c, d, dd, gen: SGDBaseline(
        d.n_users, d.n_items, gen)),
    "mf": _on_device(lambda c, d, dd, gen:
                     SGDMatrixFactorization.build_from_conf(c, d, gen)),
    "acf": _on_device(lambda c, d, dd, gen: ACF(
        d.n_users, d.n_items, gen,
        embedding_dim=c.get("embedding_dim", 100),
        n_anchors=c.get("n_anchors", 20),
        delta_exc=c.get("delta_exc", 1e-1),
        delta_inc=c.get("delta_inc", 1e-2))),
    "uprotomf": _on_device(UProtoMF.build_from_conf),
    "iprotomf": _on_device(IProtoMF.build_from_conf),
    "uiprotomf": _on_device(UIProtoMF.build_from_conf),
    "uprotomfs": _on_device(UProtoMFs.build_from_conf),
    "iprotomfs": _on_device(IProtoMFs.build_from_conf),
    "uiprotomfs": _on_device(UIProtoMFs.build_from_conf),
    "ecf": _on_device(ECF.build_from_conf),
    "dmf": _on_device(DeepMatrixFactorization.build_from_conf),
    "ifeatmf": _on_device(ItemFeatureMatrixFactorization.build_from_conf),
    "ufeatmf": _on_device(UserFeatureMatrixFactorization.build_from_conf),
    "dropoutnet": _on_device(DropoutNet.build_from_conf),
}


def _matrix(build: Callable) -> Callable:
    """A matrix algorithm's build: JAX's ``build(conf, dataset)``, the
    algorithm then set to fit and score on ``device``."""
    def wrapped(conf: dict, dataset, device="cuda"):
        alg = build(conf, dataset)
        alg.device = device
        return alg
    return wrapped


def _knn(alg: str) -> Callable:
    return lambda conf, dataset: matrix_algs.KNNAlgorithm.build_from_conf(
        {**conf, "alg": alg}, dataset)


MATRIX_BUILDS: dict[str, Callable] = {
    "uknn": _knn("uknn"),
    "iknn": _knn("iknn"),
    "ifknn": _knn("ifknn"),
    "svd": matrix_algs.SVDAlgorithm.build_from_conf,
    "als": matrix_algs.AlternatingLeastSquare.build_from_conf,
    "rbmf": matrix_algs.RBMF.build_from_conf,
    "slim": matrix_algs.SLIM.build_from_conf,
    "ease": matrix_algs.EASE.build_from_conf,
    "p3alpha": matrix_algs.P3alpha.build_from_conf,
    "rand": matrix_algs.RandomItems.build_from_conf,
    "pop": matrix_algs.PopularItems.build_from_conf,
}


SGD = ("sgdbias", "mf", "acf", "uprotomf", "iprotomf", "uiprotomf",
       "uprotomfs", "iprotomfs", "uiprotomfs", "ecf", "dmf", "ifeatmf",
       "ufeatmf", "dropoutnet", "sbnet")
ALGORITHMS: dict[str, AlgorithmSpec] = {
    **{n: AlgorithmSpec(n, "sgd", BUILDS[n]) for n in SGD},
    **{n: AlgorithmSpec(n, "matrix", _matrix(b))
       for n, b in MATRIX_BUILDS.items()},
}


def get_algorithm(name: str) -> AlgorithmSpec:
    if name not in ALGORITHMS:
        raise ValueError(
            f"unknown algorithm {name!r}; choose from {sorted(ALGORITHMS)}")
    return ALGORITHMS[name]
