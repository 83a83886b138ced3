"""The system under test, built from the benchmark's data and weights:
the program's splits and device data, its model (by the program's own
registry), the weights drawn from the seed loaded into it, and its
``Trainer`` with the configuration's learn, dataset and loader blocks."""
from __future__ import annotations

import time

import torch

from harness import weights as bench_weights


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def sizes(data: dict) -> dict:
    return {"n_users": data["n_users"], "n_items": data["n_items"],
            "n_tags": data["n_tags"],
            "vectors": {k: v.shape[1] for k, v in data["vectors"].items()}}


def build(conf: dict, data: dict, spec: list, seeds: dict, device,
          with_val: bool, times: dict):
    """``(trainer, weights)``: the program's trainer over the train split
    (with a ``val`` evaluator when ``with_val``) whose model holds the
    weights of ``seeds['weights']``; ``times`` gets each part's seconds."""
    t = time.perf_counter()
    from sibrar_tpu_torch import config_from_dict
    from sibrar_tpu_torch.data.dataset import RecDataset
    from sibrar_tpu_torch.data.feature import FeatureTable
    from sibrar_tpu_torch.eval.evaluator import FullEvaluator
    from sibrar_tpu_torch.models.registry import get_algorithm
    from sibrar_tpu_torch.train.trainer import (
        DatasetConfig,
        EvalConfig,
        LearningConfig,
        Trainer,
    )

    times["program_imports_s"] = time.perf_counter() - t
    t = time.perf_counter()
    feats = {k: FeatureTable(v, "numeric") for k, v in
             data["vectors"].items()}
    feats["genres"] = FeatureTable(data["tags"], "tag",
                                   n_categories=data["n_tags"])
    wanted = [f["name"] for f in conf["dataset"]["item_features"]]
    feats = {k: feats[k] for k in wanted}

    def split(name):
        return RecDataset(split_set=name, n_users=data["n_users"],
                          n_items=data["n_items"], interactions=data[name],
                          train_interactions=data["train"],
                          item_features=dict(feats))

    train = split("train")
    tdata = train.to_device(device)
    val = vdata = None
    if with_val:
        val = split("val")
        vdata = val.to_device(device)
    times["splits_s"] = time.perf_counter() - t

    t = time.perf_counter()
    model = get_algorithm(conf["algorithm"]).build(conf["model"], train,
                                                   tdata, seeds["weights"])
    w = bench_weights.make(spec, seeds["weights"], device)
    bench_weights.load_into(model, w)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    times["model_s"] = time.perf_counter() - t

    evaluator = (FullEvaluator(config_from_dict(EvalConfig, conf["eval"]),
                               val, vdata, evaluator_name="val")
                 if with_val else None)
    trainer = Trainer(
        model, train, config_from_dict(LearningConfig, conf["learn"]),
        config_from_dict(DatasetConfig, conf["dataset"]),
        batch_size=conf["loader"]["batch_size"], seed=seeds["trainer"],
        device_data=tdata, val_evaluator=evaluator,
        eval_batch_size=conf["loader"]["eval_batch_size"])
    return trainer, w
