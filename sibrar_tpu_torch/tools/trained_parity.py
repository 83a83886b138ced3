"""The port's side of the trained-quality parity run (no JAX): the best
validation ndcg@10 of ``sbnet``, ``mf``, ``dmf``, ``dropoutnet``,
``ifeatmf`` and ``ufeatmf`` trained by the port on the synthetic artifacts
of ``tools/trained_parity.py``.

Each ``train_port_<family>`` is JAX's ``train_ours_<family>`` line for
line on the port's API: the same artifact
reader, model, learn / eval / dataset settings and seeds. The artifacts
come from the port's `make_synthetic_splits` and
`write_reference_artifacts`, which give JAX's arrays and files bit for bit,
so both packages train on the same directory. ``trained_parity_jax.json``
beside this file holds JAX's per-seed values (``torch_trained_parity.py
jax``, on a CPU); ``torch_trained_parity.py join`` pairs them with this
tool's ``--out``.

    python -m sibrar_tpu_torch.tools.trained_parity --family sbnet mf \
        dmf dropoutnet ifeatmf ufeatmf --seeds 0 1 2 3 4 --out port.json \
        [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from sibrar_tpu_torch.config.schema import (
    DatasetConfig,
    EvalConfig,
    FeatureDefinition,
    FeatureType,
    LearningConfig,
)
from sibrar_tpu_torch.data.dataset import RecDataset
from sibrar_tpu_torch.data.synthetic import (
    make_synthetic_splits,
    write_reference_artifacts,
)
from sibrar_tpu_torch.eval.evaluator import FullEvaluator
from sibrar_tpu_torch.models.dmf import DeepMatrixFactorization
from sibrar_tpu_torch.models.dropoutnet import DropoutNet
from sibrar_tpu_torch.models.feat_mf import FeatureMF
from sibrar_tpu_torch.models.mf import SGDMatrixFactorization
from sibrar_tpu_torch.models.sbnet import SingleBranchNet
from sibrar_tpu_torch.train.trainer import Trainer

JAX_RUNS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "trained_parity_jax.json")

# copies of tools/trained_parity.py's settings
MF_HPARAMS = dict(embedding_dim=16, epochs=25, lr=5e-3, wd=0.0, n_neg=4,
                  batch_size=128, loss="bpr")
SBNET_HPARAMS = dict(epochs=12, lr=1e-3, wd=0.0, n_neg=4, batch_size=64,
                     loss="bpr", shared_common_dim=16, common_modality_dim=16,
                     hidden=(32,), reg_weight=0.1)
_SBNET_ITEM_FEATURES = ("interactions", "audio")
DN_HPARAMS = dict(epochs=12, lr=1e-3, wd=0.0, n_neg=4, batch_size=64,
                  loss="bpr", shared_common_dim=16)
DMF_HPARAMS = dict(epochs=12, lr=1e-3, wd=0.0, n_neg=4, batch_size=64,
                   loss="bpr", u_mid=(32,), i_mid=(32,), final_dimension=16)
IFMF_HPARAMS = dict(epochs=15, lr=2e-3, wd=0.0, n_neg=4, batch_size=64,
                    loss="bpr", embedding_dim=16, lambda_content=1e-4,
                    temperature=0.1)
MIDSCALE_DATASET = dict(n_users=1000, n_items=1500, n_interactions=50_000,
                        popularity_alpha=0.8)
MIDSCALE_HPARAMS = {
    "mf": dict(epochs=20, embedding_dim=32, batch_size=256, lr=5e-3),
    "sbnet": dict(epochs=10, batch_size=256),
    "dropoutnet": dict(epochs=10, batch_size=256),
    "dmf": dict(epochs=10, batch_size=256),
    "ifeatmf": dict(epochs=10, batch_size=256, embedding_dim=32),
    "ufeatmf": dict(epochs=10, batch_size=256, embedding_dim=32),
}


def make_artifacts(out_dir: str, n_users: int = 100, n_items: int = 120,
                   n_interactions: int = 3000, seed: int = 3,
                   split_type=None, popularity_alpha: float = 0.0) -> str:
    kw = {} if split_type is None else {"split_type": split_type}
    splits = make_synthetic_splits(
        n_users=n_users, n_items=n_items, n_interactions=n_interactions,
        seed=seed, popularity_alpha=popularity_alpha, **kw)
    write_reference_artifacts(out_dir, splits)
    return out_dir


def make_midscale_artifacts(out_dir: str, seed: int = 3) -> str:
    return make_artifacts(out_dir, seed=seed, **MIDSCALE_DATASET)


def _our_sbnet_conf(h: dict) -> dict:
    return {
        "shared_common_dim": h["shared_common_dim"],
        "user": {"feature_name": "user_embedding",
                 "embedding_dim": h["shared_common_dim"]},
        "item": {
            "features": [{"feature_name": f, "feature_hidden_layers": [16]}
                         for f in _SBNET_ITEM_FEATURES],
            "single_branch_hidden_layers": list(h["hidden"]),
            "common_modality_dim": h["common_modality_dim"],
            "embedding_regularization_type": "pairwise_single",
            "regularization_weight": h["reg_weight"],
        },
    }


def _fit(model, tr, va, dd, h: dict, seed: int, device) -> float:
    learn = LearningConfig(
        n_epochs=h["epochs"], lr=h["lr"], wd=h["wd"], rec_loss=h["loss"],
        max_patience=h["epochs"] + 1, optimizing_metric="ndcg@10")
    ev = FullEvaluator(EvalConfig(top_k=[10], metrics=["ndcg"]), va,
                       device=device, evaluator_name="val")
    trainer = Trainer(model, tr, learn,
                      DatasetConfig(n_negative_samples=h["n_neg"]),
                      batch_size=h["batch_size"], seed=seed, device_data=dd,
                      val_evaluator=ev)
    return float(trainer.fit()["val/ndcg@10"])


def _load(artifact_dir: str, device, user=(), item=()):
    """The train and val splits with the named vector features, and the
    train split's device data."""
    kw = dict(user_feature_definitions=[
        FeatureDefinition(f, FeatureType.VECTOR) for f in user] or None,
        item_feature_definitions=[
        FeatureDefinition(f, FeatureType.VECTOR) for f in item] or None)
    tr = RecDataset.load(artifact_dir, "train", **kw)
    va = RecDataset.load(artifact_dir, "val", **kw)
    return tr, va, tr.to_device(device)


def train_port_mf(artifact_dir: str, seed: int = 0,
                  hparams: dict = MF_HPARAMS, device="cuda") -> float:
    h = dict(MF_HPARAMS, **hparams)
    tr, va, dd = _load(artifact_dir, device)
    model = SGDMatrixFactorization(
        tr.n_users, tr.n_items, torch.Generator().manual_seed(seed),
        embedding_dim=h["embedding_dim"]).to(device)
    return _fit(model, tr, va, dd, h, seed, device)


def train_port_sbnet(artifact_dir: str, seed: int = 0,
                     hparams: dict = SBNET_HPARAMS, device="cuda") -> float:
    h = dict(SBNET_HPARAMS, **hparams)
    tr, va, dd = _load(artifact_dir, device, item=("audio",))
    model = SingleBranchNet.build_from_conf(_our_sbnet_conf(h), tr, dd,
                                            seed=seed)
    return _fit(model, tr, va, dd, h, seed, device)


def train_port_dmf(artifact_dir: str, seed: int = 0,
                   hparams: dict = DMF_HPARAMS, device="cuda") -> float:
    h = dict(DMF_HPARAMS, **hparams)
    tr, va, dd = _load(artifact_dir, device)
    model = DeepMatrixFactorization.build_from_conf(
        {"u_mid_layers": list(h["u_mid"]), "i_mid_layers": list(h["i_mid"]),
         "final_dimension": h["final_dimension"]}, tr, dd,
        torch.Generator().manual_seed(seed)).to(device)
    return _fit(model, tr, va, dd, h, seed, device)


def _dn_entity_conf(feature: str) -> dict:
    return {"features": [{"feature_name": feature, "embedding_dim": 16}],
            "preference_layers": [32], "common_hidden_layers": [16]}


def train_port_dropoutnet(artifact_dir: str, seed: int = 0,
                          hparams: dict = DN_HPARAMS, device="cuda"
                          ) -> float:
    h = dict(DN_HPARAMS, **hparams)
    tr, va, dd = _load(artifact_dir, device, user=("profile_vec",),
                       item=("audio",))
    conf = {"shared_common_dim": h["shared_common_dim"],
            "user": _dn_entity_conf("profile_vec"),
            "item": _dn_entity_conf("audio")}
    model = DropoutNet.build_from_conf(
        conf, tr, dd, torch.Generator().manual_seed(seed)).to(device)
    return _fit(model, tr, va, dd, h, seed, device)


def _train_port_feat_mf(entity: str, feature: str, artifact_dir: str,
                        seed: int, hparams: dict, device) -> float:
    h = dict(IFMF_HPARAMS, **hparams)
    tr, va, dd = _load(artifact_dir, device, **{entity: (feature,)})
    model = FeatureMF.build_from_conf(
        entity, {"feature_name": feature, "embedding_dim": h["embedding_dim"],
                 "lambda_content": h["lambda_content"],
                 "temperature": h["temperature"]}, tr, dd,
        torch.Generator().manual_seed(seed)).to(device)
    return _fit(model, tr, va, dd, h, seed, device)


def train_port_ifeatmf(artifact_dir: str, seed: int = 0,
                       hparams: dict = IFMF_HPARAMS, device="cuda") -> float:
    return _train_port_feat_mf("item", "audio", artifact_dir, seed, hparams,
                               device)


def train_port_ufeatmf(artifact_dir: str, seed: int = 0,
                       hparams: dict = IFMF_HPARAMS, device="cuda") -> float:
    return _train_port_feat_mf("user", "profile_vec", artifact_dir, seed,
                               hparams, device)


FAMILIES = {"mf": (train_port_mf, MF_HPARAMS),
            "sbnet": (train_port_sbnet, SBNET_HPARAMS),
            "dmf": (train_port_dmf, DMF_HPARAMS),
            "dropoutnet": (train_port_dropoutnet, DN_HPARAMS),
            "ifeatmf": (train_port_ifeatmf, IFMF_HPARAMS),
            "ufeatmf": (train_port_ufeatmf, IFMF_HPARAMS)}


def hparams_for(family: str, scale: str) -> dict:
    h = dict(FAMILIES[family][1])
    if scale == "mid":
        h.update(MIDSCALE_HPARAMS[family])
    return h


def run(families, seeds, scale: str = "mid", device="cuda",
        log=print) -> dict:
    """Best validation ndcg@10 per family and seed, on the ``scale``
    artifacts (``mid`` or ``toy``) written to a temporary directory."""
    out = {"scale": scale, "device": str(device), "families": {}}
    if device != "cpu" and torch.device(device).type == "cuda":
        out["device"] = torch.cuda.get_device_name(0)
    with tempfile.TemporaryDirectory() as d:
        (make_midscale_artifacts if scale == "mid" else make_artifacts)(d)
        for family in families:
            fn = FAMILIES[family][0]
            h = hparams_for(family, scale)
            runs, secs = {}, {}
            for s in seeds:
                t0 = time.perf_counter()
                runs[str(s)] = fn(d, seed=s, hparams=h, device=device)
                secs[str(s)] = round(time.perf_counter() - t0, 1)
                log(f"port {family} seed {s}: {runs[str(s)]:.6f} "
                    f"({secs[str(s)]} s)")
            out["families"][family] = {"hparams": h, "runs": runs,
                                       "seconds": secs}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--family", nargs="+", default=["sbnet", "mf"],
                   choices=sorted(FAMILIES))
    p.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2, 3, 4])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA card; pass --device cpu")
    res = run(args.family, args.seeds, device=args.device)
    with open(args.out, "w") as fh:
        json.dump(res, fh, indent=1)
        fh.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
