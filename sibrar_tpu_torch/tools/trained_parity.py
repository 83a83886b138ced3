"""The port's side of the trained-quality parity run (no JAX): the best
validation ndcg@10 of ``sbnet``, ``mf``, ``dmf``, ``dropoutnet``,
``ifeatmf``, ``ufeatmf``, ``uprotomf`` and ``ecf`` trained by the port on
the synthetic artifacts of ``tools/trained_parity.py``, and the validation
ndcg@10 and recall@10 of the eleven matrix algorithms fitted there
(`MATRIX_HPARAMS`; ``rand`` scores with the run's seed).

Each ``train_port_<family>`` is JAX's ``train_ours_<family>`` line for
line on the port's API: the same artifact
reader, model, learn / eval / dataset settings and seeds. The artifacts
come from the port's `make_synthetic_splits` and
`write_reference_artifacts`, which give JAX's arrays and files bit for bit,
so both packages train on the same directory. ``trained_parity_jax.json``
beside this file holds JAX's per-seed values at mid scale
(``torch_trained_parity.py jax``, on a CPU), ``trained_parity_jax_toy.json``
ECF's at the toy scale (``--scale toy``: ECF barely learns at mid scale);
``torch_trained_parity.py join`` pairs them with this tool's ``--out``.

    python -m sibrar_tpu_torch.tools.trained_parity --family sbnet mf \
        dmf dropoutnet ifeatmf ufeatmf uprotomf ecf --seeds 0 1 2 3 4 \
        --out port.json [--device cpu] [--scale toy]
    python -m sibrar_tpu_torch.tools.trained_parity --family uknn iknn \
        ifknn ease slim p3alpha svd rbmf pop als --seeds 0 --out matrix.json
    python -m sibrar_tpu_torch.tools.trained_parity --family rand \
        --seeds 0 1 2 3 4 --out matrix_seeds.json

``--replay DIR`` trains ECF from JAX's initial parameters on JAX's draws,
as ``torch_trained_parity.py replay-jax`` recorded them into ``DIR``: the
same steps on the same data, so what is left between the two is the
packages' arithmetic, not their random streams.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import tempfile
import time
from typing import Optional

import numpy as np
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
from sibrar_tpu_torch.eval.evaluator import FullEvaluator, evaluate_model
from sibrar_tpu_torch.models.dmf import DeepMatrixFactorization
from sibrar_tpu_torch.models.dropoutnet import DropoutNet
from sibrar_tpu_torch.models.ecf import ECF, hard_topk_mask
from sibrar_tpu_torch.models.feat_mf import FeatureMF
from sibrar_tpu_torch.models.matrix_algs import RandomItems
from sibrar_tpu_torch.models.mf import SGDMatrixFactorization
from sibrar_tpu_torch.models.protomf import UProtoMF
from sibrar_tpu_torch.models.registry import get_algorithm
from sibrar_tpu_torch.models.sbnet import SingleBranchNet
from sibrar_tpu_torch.models.transplant import transplant
from sibrar_tpu_torch.train.trainer import Trainer

JAX_RUNS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "trained_parity_jax.json")
JAX_TOY_RUNS = os.path.join(os.path.dirname(JAX_RUNS),
                            "trained_parity_jax_toy.json")

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
PROTO_HPARAMS = dict(epochs=15, lr=2e-3, wd=0.0, n_neg=4, batch_size=64,
                     loss="bpr", embedding_dim=16, n_prototypes=8)
ECF_HPARAMS = dict(epochs=15, lr=2e-3, wd=0.0, n_neg=4, batch_size=64,
                   loss="bpr", embedding_dim=16, n_clusters=8, top_n=4,
                   top_m=4, top_p=2)
MIDSCALE_DATASET = dict(n_users=1000, n_items=1500, n_interactions=50_000,
                        popularity_alpha=0.8)
MIDSCALE_HPARAMS = {
    "mf": dict(epochs=20, embedding_dim=32, batch_size=256, lr=5e-3),
    "sbnet": dict(epochs=10, batch_size=256),
    "dropoutnet": dict(epochs=10, batch_size=256),
    "dmf": dict(epochs=10, batch_size=256),
    "ifeatmf": dict(epochs=10, batch_size=256, embedding_dim=32),
    "ufeatmf": dict(epochs=10, batch_size=256, embedding_dim=32),
    "uprotomf": dict(epochs=10, batch_size=256, embedding_dim=32,
                     n_prototypes=16),
    "ecf": dict(epochs=10, batch_size=256, embedding_dim=32),
}

# the matrix algorithms at mid scale: conf/single/knn.yml's KNN, EASE's
# lambda of Steck (2019), SLIM's and P3alpha's defaults, the `implicit`
# library's ALS defaults, 100 factors / representatives. ``exact`` names
# fit without random draws (gate: both metrics within MATRIX_TOLERANCE of
# JAX's). ``als`` starts from one fixed draw on each side whatever the seed
# (JAX's PRNGKey(0), the port's generator seeded 0): its seeds cannot
# differ, so it runs at seed 0 and the paired gate is |delta| <= 0.01 there.
# ``rand`` draws with the seed and takes the paired-seed gate over 0-4
_KNN = {"k": 100, "shrinkage": 10.0,
        "sim_func_params": {"sim_func_name": "cosine"}}
MATRIX_HPARAMS = {
    "uknn": _KNN, "iknn": _KNN, "ifknn": dict(_KNN, feature_name="audio"),
    "ease": {"lam": 500.0},
    "slim": {"alpha": 1e-3, "l1_ratio": 0.5, "max_iter": 100},
    "p3alpha": {"alpha": 1.9},
    "svd": {"n_factors": 100},
    "rbmf": {"n_representatives": 100, "lam": 1e-2},
    "pop": {},
    "als": {"factors": 100, "regularization": 0.01, "alpha": 1.0,
            "n_iterations": 15},
    "rand": {},
}
EXACT_MATRIX = ("uknn", "iknn", "ifknn", "ease", "slim", "p3alpha", "svd",
                "rbmf", "pop")
MATRIX_TOLERANCE = 1e-3


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


def _trainer(model, tr, va, dd, h: dict, seed: int, device,
             trainer_cls=Trainer, **trainer_kw) -> Trainer:
    learn = LearningConfig(
        n_epochs=h["epochs"], lr=h["lr"], wd=h["wd"], rec_loss=h["loss"],
        max_patience=h["epochs"] + 1, optimizing_metric="ndcg@10")
    ev = FullEvaluator(EvalConfig(top_k=[10], metrics=["ndcg"]), va,
                       device=device, evaluator_name="val")
    return trainer_cls(model, tr, learn,
                       DatasetConfig(n_negative_samples=h["n_neg"]),
                       batch_size=h["batch_size"], seed=seed,
                       device_data=dd, val_evaluator=ev, **trainer_kw)


def _fit(model, tr, va, dd, h: dict, seed: int, device, **kwargs) -> float:
    trainer = _trainer(model, tr, va, dd, h, seed, device, **kwargs)
    return float(trainer.fit()["val/ndcg@10"])


def _load(artifact_dir: str, device, user=(), item=(), train_tags=()):
    """The train and val splits with the named vector features (the train
    split also with the tag features ``train_tags``), and the train
    split's device data."""
    kw = dict(user_feature_definitions=[
        FeatureDefinition(f, FeatureType.VECTOR) for f in user] or None,
        item_feature_definitions=[
        FeatureDefinition(f, FeatureType.VECTOR) for f in item] or None)
    tags = [FeatureDefinition(f, FeatureType.TAG) for f in train_tags]
    tr = RecDataset.load(artifact_dir, "train", **{
        **kw, "item_feature_definitions": (
            (kw["item_feature_definitions"] or []) + tags) or None})
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


def train_port_uprotomf(artifact_dir: str, seed: int = 0,
                        hparams: dict = PROTO_HPARAMS, device="cuda"
                        ) -> float:
    h = dict(PROTO_HPARAMS, **hparams)
    tr, va, dd = _load(artifact_dir, device)
    model = UProtoMF(tr.n_users, tr.n_items,
                     torch.Generator().manual_seed(seed),
                     embedding_dim=h["embedding_dim"],
                     n_prototypes=h["n_prototypes"]).to(device)
    return _fit(model, tr, va, dd, h, seed, device)


def _port_ecf(artifact_dir: str, seed: int, h: dict, device):
    tr, va, dd = _load(artifact_dir, device, train_tags=("genres",))
    model = ECF.build_from_conf(
        {"embedding_dim": h["embedding_dim"], "n_clusters": h["n_clusters"],
         "top_n": h["top_n"], "top_m": h["top_m"], "top_p": h["top_p"],
         "tag_feature": "genres"}, tr, dd,
        torch.Generator().manual_seed(seed)).to(device)
    return model, tr, va, dd


def train_port_ecf(artifact_dir: str, seed: int = 0,
                   hparams: dict = ECF_HPARAMS, device="cuda") -> float:
    h = dict(ECF_HPARAMS, **hparams)
    return _fit(*_port_ecf(artifact_dir, seed, h, device), h, seed, device)


class ReplayTrainer(Trainer):
    """A `Trainer` whose steps take recorded users ``[n]`` and items ``[n,
    1 + n_neg]`` (global ids), cut into steps of ``sizes``, in order,
    instead of drawing them: another package's draws, replayed."""

    def __init__(self, *args, users: torch.Tensor, items: torch.Tensor,
                 sizes, **kwargs):
        super().__init__(*args, **kwargs)
        self.recorded_users = torch.split(users, list(sizes))
        self._steps = iter(zip(self.recorded_users,
                               torch.split(items, list(sizes))))

    def draw_batch(self, idxs: torch.Tensor):
        u, i_global = next(self._steps)
        if u.shape[0] != idxs.shape[0]:
            raise ValueError(f"recorded step of {u.shape[0]} pairs, the "
                             f"trainer's of {idxs.shape[0]}")
        return u, i_global


def _unflatten(rec: dict, prefix: str) -> dict:
    """The nested parameter tree of ``rec``'s ``<prefix>/<path>`` arrays."""
    params: dict = {}
    for key, arr in rec.items():
        if key.startswith(prefix + "/"):
            *path, leaf = key.split("/")[1:]
            node = params
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = arr
    return params


def _max_abs_diff(model, params: dict) -> float:
    return max(float(np.abs(p.detach().cpu().numpy() - params[name]).max())
               for name, p in model.named_parameters())


def _hard_masks(model: ECF, u: torch.Tensor) -> dict:
    """ECF's three hard top-k masks on the model's present weights: the
    items' (``top_m``), the users' ``u`` (``top_n``) and the clusters' tag
    top-p, with each row's margin between its k-th and (k+1)-th value."""
    x_t = model._x_tildes()
    d_c = model._xs(x_t).T @ model.tag_matrix
    out = {}
    for name, v, k in (
            ("items", x_t, model.top_m),
            ("users", model.interactions(u) @ x_t, model.top_n),
            ("tags", torch.log_softmax(d_c / model.temp_tags, -1),
             model.top_p)):
        top = torch.sort(v, -1, descending=True).values
        margin = (top[:, k - 1] - top[:, k] if k < v.shape[-1]
                  else torch.full_like(top[:, 0], torch.inf))
        out[name] = (hard_topk_mask(v, min(k, v.shape[-1])), margin)
    return out


class _FirstEpochProbe(ReplayTrainer):
    """`ReplayTrainer` that holds each first-epoch step's parameters to
    JAX's (``rec``'s ``step<j>``) and, at the first step that leaves them
    more than ``PART`` apart, compares ECF's hard masks before the step on
    the port's weights and on JAX's (``parting``: the rows that differ and
    their top-k margins on the port's weights)."""
    PART = 1e-4

    def __init__(self, *args, rec: dict, **kwargs):
        super().__init__(*args, **kwargs)
        self.rec, self.step_diffs, self.parting = rec, [], None
        self.n_probed = len({k.split("/")[0] for k in rec
                             if k.startswith("step")})

    def train_step(self, idxs):
        j = self.step
        if j >= self.n_probed:
            return super().train_step(idxs)
        before = {n: p.detach().clone()
                  for n, p in self.model.named_parameters()}
        u = self.recorded_users[j]
        out = super().train_step(idxs)
        d = _max_abs_diff(self.model, _unflatten(self.rec, f"step{j}"))
        self.step_diffs.append(d)
        if self.parting is None and d > self.PART:
            after = {n: p.detach().clone()
                     for n, p in self.model.named_parameters()}
            jax_before = _unflatten(self.rec, f"step{j - 1}" if j else "init")
            with torch.no_grad():
                for n, p in self.model.named_parameters():
                    p.copy_(before[n])
                mine = _hard_masks(self.model, u)
                for n, p in self.model.named_parameters():
                    p.copy_(torch.as_tensor(jax_before[n]))
                theirs = _hard_masks(self.model, u)
                for n, p in self.model.named_parameters():
                    p.copy_(after[n])
            self.parting = {"step": j, "diff_before": (
                self.step_diffs[-2] if j else 0.0), "diff_after": d}
            for name, (m, margin) in mine.items():
                rows = (m != theirs[name][0]).any(-1)
                self.parting[name] = {
                    "rows_that_differ": rows.nonzero().flatten().tolist(),
                    "their_margins_here": margin[rows].tolist(),
                    "smallest_margin": float(margin.min())}
        return out


def replay_port_ecf(artifact_dir: str, rec: dict, hparams: dict,
                    device="cuda") -> dict:
    """ECF trained by the port from JAX's initial parameters on JAX's
    draws, as ``torch_trained_parity.py replay-jax`` recorded them
    (``rec``): the best validation ndcg@10 beside JAX's, both sides' value
    before training and after each epoch, after each epoch the largest
    absolute difference of any parameter from JAX's, the same after each
    step of the first epoch where ``rec`` holds them, and at the first
    step that parts the two by more than 1e-4, which rows of the hard
    masks differ before it (on the port's weights and on JAX's) and their
    top-k margins."""
    h = dict(ECF_HPARAMS, **hparams)
    model, tr, va, dd = _port_ecf(artifact_dir, 0, h, device)
    transplant(model, {"params": _unflatten(rec, "init")})
    val, diff = [], []

    def log(record):
        val.append(record["val/ndcg@10"])
        if record["epoch"] >= 0:
            diff.append(_max_abs_diff(
                model, _unflatten(rec, f"epoch{record['epoch']}")))

    trainer = _trainer(
        model, tr, va, dd, h, 0, device, trainer_cls=_FirstEpochProbe,
        users=torch.as_tensor(rec["users"]).to(device, dd.train_users.dtype),
        items=torch.as_tensor(rec["items"]).to(device, dd.catalog.dtype),
        sizes=rec["sizes"].tolist(), rec=rec, log_fn=log)
    best = float(trainer.fit()["val/ndcg@10"])
    return {"best": best, "jax_best": float(rec["val"].max()),
            "val": val, "jax_val": rec["val"].tolist(),
            "max_abs_param_diff": diff,
            "first_epoch_step_diffs": trainer.step_diffs,
            "parting": trainer.parting}


def train_port_matrix(family: str, artifact_dir: str, seed: int = 0,
                      hparams: Optional[dict] = None, device="cuda") -> dict:
    """``{"ndcg", "recall"}`` at 10 on the val split of matrix algorithm
    ``family`` fitted on the train split (the registry's build, as the CLI
    fits it; ``rand`` as ``RandomItems(seed)``), users in batches of
    256."""
    h = dict(MATRIX_HPARAMS[family], **(hparams or {}))
    item = (h["feature_name"],) if family == "ifknn" else ()
    tr = RecDataset.load(artifact_dir, "train", item_feature_definitions=[
        FeatureDefinition(f, FeatureType.VECTOR) for f in item] or None)
    va = RecDataset.load(artifact_dir, "val")
    if family == "rand":
        alg = RandomItems(seed)
        alg.device = device
    else:
        alg = get_algorithm(family).build(h, tr, device)
    kwargs = ({"feature_matrix": tr.item_features[h["feature_name"]]
               .dense_table()} if item else {})
    alg.fit(matrix=tr.user_sampling_matrix, **kwargs)
    ev = FullEvaluator(EvalConfig(top_k=[10], metrics=["ndcg", "recall"]),
                       va, device=device, evaluator_name="val")
    m = evaluate_model(alg.score_fn(va.items_in_split), ev, 256)
    return {"ndcg": float(m["val/ndcg@10"]),
            "recall": float(m["val/recall@10"])}


FAMILIES = {"mf": (train_port_mf, MF_HPARAMS),
            "sbnet": (train_port_sbnet, SBNET_HPARAMS),
            "dmf": (train_port_dmf, DMF_HPARAMS),
            "dropoutnet": (train_port_dropoutnet, DN_HPARAMS),
            "ifeatmf": (train_port_ifeatmf, IFMF_HPARAMS),
            "ufeatmf": (train_port_ufeatmf, IFMF_HPARAMS),
            "uprotomf": (train_port_uprotomf, PROTO_HPARAMS),
            "ecf": (train_port_ecf, ECF_HPARAMS)}
for _name, _h in MATRIX_HPARAMS.items():
    FAMILIES[_name] = (functools.partial(train_port_matrix, _name), _h)


def hparams_for(family: str, scale: str) -> dict:
    h = dict(FAMILIES[family][1])
    if scale == "mid":
        h.update(MIDSCALE_HPARAMS.get(family, {}))
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
            runs, secs, recall = {}, {}, {}
            for s in seeds:
                t0 = time.perf_counter()
                r = fn(d, seed=s, hparams=h, device=device)
                if isinstance(r, dict):  # a matrix algorithm
                    r, recall[str(s)] = r["ndcg"], r["recall"]
                runs[str(s)] = r
                secs[str(s)] = round(time.perf_counter() - t0, 1)
                log(f"port {family} seed {s}: {runs[str(s)]:.6f} "
                    f"({secs[str(s)]} s)")
            out["families"][family] = {"hparams": h, "runs": runs,
                                       "seconds": secs}
            if recall:
                out["families"][family]["recall"] = recall
    return out


def run_replay(replay_dir: str, seeds, scale: str = "toy", device="cuda",
               log=print) -> dict:
    """`replay_port_ecf` per seed from ``replay_dir/ecf_<scale>_seed<s>.npz``
    and the mean and standard error of the best values' differences
    (port minus JAX)."""
    out = {"scale": scale, "device": str(device), "replay": {}}
    if device != "cpu" and torch.device(device).type == "cuda":
        out["device"] = torch.cuda.get_device_name(0)
    with tempfile.TemporaryDirectory() as d:
        (make_midscale_artifacts if scale == "mid" else make_artifacts)(d)
        for s in seeds:
            with np.load(os.path.join(replay_dir,
                                      f"ecf_{scale}_seed{s}.npz")) as z:
                rec = dict(z)
            r = replay_port_ecf(d, rec, hparams_for("ecf", scale), device)
            log(f"replay ecf seed {s}: port {r['best']:.6f}, JAX "
                f"{r['jax_best']:.6f}, last epoch's largest parameter "
                f"difference {r['max_abs_param_diff'][-1]:.3g}")
            out["replay"][str(s)] = r
    deltas = np.asarray([r["best"] - r["jax_best"]
                         for r in out["replay"].values()])
    out["delta_mean"] = float(deltas.mean())
    out["delta_sem"] = (float(deltas.std(ddof=1) / np.sqrt(len(deltas)))
                        if len(deltas) > 1 else 0.0)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--family", nargs="+", default=["sbnet", "mf"],
                   choices=sorted(FAMILIES))
    p.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2, 3, 4])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--scale", default="mid", choices=("mid", "toy"))
    p.add_argument("--replay", metavar="DIR",
                   help="replay ECF from JAX's recorded draws and init "
                   "(torch_trained_parity.py replay-jax) instead of training "
                   "on the port's own; --family is ignored")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA card; pass --device cpu")
    res = (run_replay(args.replay, args.seeds, args.scale, args.device)
           if args.replay else
           run(args.family, args.seeds, args.scale, device=args.device))
    with open(args.out, "w") as fh:
        json.dump(res, fh, indent=1)
        fh.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
