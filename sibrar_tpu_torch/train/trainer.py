"""Optimizers, the training loop and validation (port of
``sibrar_tpu/train/trainer.py``: ``build_optimizer``, the dense-optimizer
train step, ``epoch_batch_plan``, ``train_epoch``, ``make_score_fn``,
``validate``, ``fit`` with best-model tracking, ``save`` / ``load``; and of
the ``EvalConfig`` of ``sibrar_tpu/config/schema.py``).

A train step samples negatives on the device, runs the model's train
forward (logits and regularization loss), adds the rec loss, and steps the
optimizer; an epoch walks a permutation of the split's pairs in full
batches plus a tail batch. The JAX package scans the epoch inside one jit;
here the steps run eagerly, one after the other, and nothing waits for the
device until the epoch's losses are read. Every random draw comes from the
trainer's ``torch.Generator`` on the device. Validation runs the model in
eval mode without autograd (``train/scoring.py``); the next train step
switches it back.

Not ported yet (``ROADMAP.md`` queue 1, item 2): full-state checkpoints and
resume, ``profile_dir``, the row-sparse table optimizer (``sparse_tables``)
and bf16 Adam moments (``moment_dtype``).
"""
from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

import torch

from sibrar_tpu_torch.data.dataset import DeviceData, RecDataset
from sibrar_tpu_torch.data.sampling import sample_negatives
from sibrar_tpu_torch.eval.evaluator import FullEvaluator, evaluate_model
from sibrar_tpu_torch.ops.topk import METHODS
from sibrar_tpu_torch.train import scoring
from sibrar_tpu_torch.train.losses import build_rec_loss

NOT_PORTED = "not ported yet (ROADMAP.md queue 1, item 2)"


@dataclass
class LearningConfig:
    """The ``learn:`` fields of the JAX config. ``epoch_scan_chunk`` is
    accepted and ignored: it bounds the JAX package's scanned programs for
    a TPU runtime, and the port runs its steps eagerly. ``n_epochs``,
    ``max_patience`` and ``optimizing_metric`` belong to ``fit``."""

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
    """The ``eval:`` fields of the JAX config (defaults: the reference's
    metric surface). ``topk_method`` is one of ``ops/topk.py``'s methods;
    ``score_dtype`` other than f32 is not ported yet."""

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
        if self.topk_method not in METHODS:
            raise ValueError(f"unsupported topk_method {self.topk_method!r}")
        if self.score_dtype == "bfloat16":
            raise NotImplementedError(
                "score_dtype='bfloat16' is not ported yet (ROADMAP.md queue "
                "1, item 1)")
        if self.score_dtype not in (None, "float32"):
            raise ValueError(
                f"unsupported score_dtype {self.score_dtype!r} (use "
                "'float32')")


@dataclass
class DatasetConfig:
    """The sampling fields of the JAX ``dataset:`` config."""

    n_negative_samples: int = 4
    negative_sampling_strategy: str = "uniform"
    popularity_squashing_factor: float = 1.0

    def validate(self) -> None:
        if self.negative_sampling_strategy not in ("uniform",
                                                   "uniform_recbole",
                                                   "popular"):
            raise ValueError(f"unsupported sampling strategy "
                             f"{self.negative_sampling_strategy!r}")


class Optimizer:
    """The optax chains of the JAX ``build_optimizer`` over a parameter list.

    - ``adam``: weight decay added to the gradient, then Adam (b1 0.9, b2
      0.999, eps 1e-8 outside the root);
    - ``adagrad``: weight decay added to the gradient, then
      ``optax.scale_by_rss`` (accumulator from 0, eps 1e-7 inside the root,
      unlike ``torch.optim.Adagrad``);
    - ``adamw``: Adam, then decoupled decay ``wd * param``;
    each followed by ``-lr``. A parameter without a gradient steps with a
    zero gradient, as every parameter does in the JAX package.

    ``state[p]`` holds ``mu`` / ``nu`` (Adam) or ``sum_of_squares``
    (adagrad); ``count`` is the number of steps taken."""

    B1, B2, EPS, RSS_EPS = 0.9, 0.999, 1e-8, 1e-7

    def __init__(self, params: Iterable[torch.nn.Parameter], kind: str,
                 lr: float, wd: float = 0.0):
        if kind not in ("adam", "adagrad", "adamw"):
            raise ValueError(f"unsupported optimizer {kind!r}")
        self.kind, self.lr, self.wd = kind, lr, wd
        self.params = [p for p in params if p.requires_grad]
        self.count = 0
        names = ("sum_of_squares",) if kind == "adagrad" else ("mu", "nu")
        self.state = {p: {n: torch.zeros_like(p) for n in names}
                      for p in self.params}

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        for p in self.params:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            st = self.state[p]
            if self.kind != "adamw" and self.wd:
                g = g + self.wd * p
            if self.kind == "adagrad":
                ss = st["sum_of_squares"].addcmul_(g, g)
                upd = torch.where(ss > 0, torch.rsqrt(ss + self.RSS_EPS),
                                  0.0) * g
            else:
                mu = st["mu"].mul_(self.B1).add_(g, alpha=1 - self.B1)
                nu = st["nu"].mul_(self.B2).addcmul_(g, g, value=1 - self.B2)
                mu_hat = mu / (1 - self.B1 ** self.count)
                nu_hat = nu / (1 - self.B2 ** self.count)
                upd = mu_hat / (nu_hat.sqrt() + self.EPS)
                if self.kind == "adamw" and self.wd:
                    upd = upd + self.wd * p
            p.sub_(self.lr * upd)


def build_optimizer(learn: LearningConfig,
                    params: Iterable[torch.nn.Parameter]) -> Optimizer:
    """adam / adagrad / adamw as the JAX package chains them."""
    if learn.moment_dtype not in (None, "float32"):
        raise NotImplementedError(f"moment_dtype={learn.moment_dtype!r} is "
                                  f"{NOT_PORTED}")
    return Optimizer(params, learn.optimizer, learn.lr, learn.wd)


class Trainer:
    """Trains a `RecModel` on one split, on the device of its `DeviceData`
    (the card unless ``device`` says otherwise), and validates it with
    ``val_evaluator`` (needed by `fit` and `validate`).

    ``log_fn`` receives each epoch's record; ``post_val_fn(model, epoch)``
    may add metrics after each validation (JAX passes the params where this
    passes the model); ``results_path`` receives ``model.pt`` whenever the
    best model changes."""

    def __init__(self, model, train_data: RecDataset, learn: LearningConfig,
                 dataset_conf: DatasetConfig, batch_size: int = 128,
                 seed: int = 0, device_data: Optional[DeviceData] = None,
                 device="cuda", *,
                 val_evaluator: Optional[FullEvaluator] = None,
                 eval_batch_size: int = 256,
                 results_path: Optional[str] = None,
                 log_fn: Optional[Callable[[dict], None]] = None,
                 train_evaluator: Optional[FullEvaluator] = None,
                 post_val_fn: Optional[Callable[[Any, int], dict]] = None,
                 profile_dir: Optional[str] = None):
        if learn.sparse_tables:
            raise NotImplementedError(f"sparse_tables is {NOT_PORTED}")
        if profile_dir is not None:
            raise NotImplementedError(f"profile_dir is {NOT_PORTED}")
        self.model = model
        self.train_dataset = train_data
        self.data = (device_data if device_data is not None
                     else train_data.to_device(device))
        self.device = self.data.catalog.device
        self.learn = learn
        self.dataset_conf = dataset_conf
        self.batch_size = batch_size
        self.n_neg = dataset_conf.n_negative_samples
        self.rec_loss = build_rec_loss(
            learn.rec_loss, n_items=train_data.n_items_in_split,
            n_neg=self.n_neg, aggregator=learn.loss_aggregator,
            train_neg_strategy=dataset_conf.negative_sampling_strategy)
        self.optimizer = build_optimizer(learn, model.parameters())
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.step = 0
        self.epoch_losses: Optional[torch.Tensor] = None
        self.val_evaluator = val_evaluator
        self.train_evaluator = train_evaluator
        self.eval_batch_size = eval_batch_size
        self.results_path = results_path
        self.log_fn = log_fn or (lambda record: None)
        self.post_val_fn = post_val_fn
        self.best_state: Optional[dict] = None
        self.best_value = -math.inf
        self.best_epoch = -1

    def train_step(self, idxs: torch.Tensor) -> torch.Tensor:
        """One optimizer step on the pairs ``idxs``; returns the device
        tensor ``[total, rec_loss, reg_loss]``."""
        data = self.data
        u = data.train_users[idxs]
        pos = data.train_items_cat[idxs]
        negs = sample_negatives(
            self.gen, u, data.pos_csr, data.popularity,
            strategy=self.dataset_conf.negative_sampling_strategy,
            n_catalog=self.train_dataset.n_items_in_split, n_neg=self.n_neg,
            squashing_factor=self.dataset_conf.popularity_squashing_factor)
        i_cat = torch.cat([pos.unsqueeze(1), negs], dim=1)
        i_global = data.catalog[i_cat.long()]
        labels = torch.zeros(i_cat.shape, device=self.device)
        labels[:, 0] = 1.0
        self.model.train()
        logits, reg = self.model(u, i_global, gen=self.gen)
        loss = self.rec_loss(logits, labels)
        total = loss + reg
        self.optimizer.zero_grad()
        total.backward()
        self.optimizer.step()
        self.step += 1
        return torch.stack([total, loss, reg]).detach()

    @staticmethod
    def epoch_batch_plan(n_inter: int, batch_size: int,
                         max_batches: Optional[int]) -> tuple[int, int]:
        """(n_full_batches, tail_size): every pair lands in one batch per
        epoch unless ``max_batches_per_epoch`` caps the count (then no
        tail)."""
        n_batches = n_inter // batch_size
        tail = n_inter - n_batches * batch_size
        if max_batches and n_batches >= max_batches:
            return max_batches, 0
        return n_batches, tail

    def train_epoch(self) -> dict:
        """One epoch over a fresh permutation of the split's pairs; returns
        the step losses' mean, the tail step weighted by ``tail / bs``. The
        per-step losses stay in ``epoch_losses`` ``[n_steps, 3]``."""
        n_inter = int(self.data.train_users.shape[0])
        n_batches, tail = self.epoch_batch_plan(
            n_inter, self.batch_size, self.learn.max_batches_per_epoch)
        if n_batches == 0 and tail == 0:
            raise ValueError("not enough interactions for a single batch")
        if n_batches == 0:  # fewer interactions than one batch: tail only
            n_batches, tail = 1, 0
            self.batch_size = min(self.batch_size, n_inter)
        bs = self.batch_size
        perm = torch.randperm(n_inter, generator=self.gen, device=self.device)
        losses = [self.train_step(perm[k * bs:(k + 1) * bs])
                  for k in range(n_batches)]
        weights = [1.0] * n_batches
        if tail:
            losses.append(self.train_step(
                perm[n_batches * bs:n_batches * bs + tail]))
            weights.append(tail / bs)
        self.epoch_losses = torch.stack(losses)
        w = torch.tensor(weights, device=self.device).unsqueeze(1)
        total, rec, reg = ((self.epoch_losses * w).sum(0) / w.sum()).tolist()
        return {"train/loss": total, "train/rec_loss": rec,
                "train/reg_loss": reg}

    # ---------------------------------------------------------- validation
    def make_score_fn(self, item_chunk: int = 8192) -> scoring.ScoreFn:
        """Encode the val evaluator's catalog once and return the user-batch
        scorer (with ``dot_parts`` where the model ranks like a dot)."""
        return scoring.make_score_fn(self.model,
                                     self.val_evaluator.data.catalog,
                                     item_chunk)

    def validate(self) -> dict:
        return evaluate_model(self.make_score_fn(), self.val_evaluator,
                              self.eval_batch_size)

    def evaluate_on_train(self) -> dict:
        """Metrics over the training interactions (reference
        ``train_eval``)."""
        if self.train_evaluator is None:
            raise ValueError("evaluate_on_train needs a train_evaluator")
        return evaluate_model(self.make_score_fn(), self.train_evaluator,
                              self.eval_batch_size)

    def fit(self) -> dict:
        """Validate, then train up to ``n_epochs`` epochs, validating after
        each; stop after ``max_patience`` epochs without a strictly better
        ``optimizing_metric``. Restores the best parameters and batch-norm
        statistics and returns the best validation metrics."""
        if self.val_evaluator is None:
            raise ValueError("fit needs a val_evaluator")
        name = self.val_evaluator.name
        metric = self.learn.optimizing_metric
        key = f"{name}/{metric}" if name else metric

        metrics = self.validate()  # before training (reference :103-119)
        if key not in metrics:
            raise ValueError(
                f"optimizing metric {key!r} is not produced by the validation "
                f"evaluator (available: {sorted(metrics)}); check "
                f"learn.optimizing_metric against eval.top_k/eval.metrics")
        self.log_fn({"epoch": -1, **metrics})
        self._maybe_update_best(metrics[key], -1)
        best_metrics = metrics

        patience = 0
        for epoch in range(self.learn.n_epochs):
            t0 = time.perf_counter()
            train_metrics = self.train_epoch()
            train_wall = time.perf_counter() - t0
            metrics = self.validate()
            if self.train_evaluator is not None:
                train_metrics.update(self.evaluate_on_train())
            if self.post_val_fn is not None:
                metrics.update(self.post_val_fn(self.model, epoch) or {})
            self.log_fn({"epoch": epoch, **train_metrics, **metrics,
                         "train/epoch_wall_s": round(train_wall, 2),
                         "val/wall_s": round(
                             time.perf_counter() - t0 - train_wall, 2)})
            value = metrics.get(key, -math.inf)
            if value > self.best_value:
                self._maybe_update_best(value, epoch)
                best_metrics = metrics
                patience = 0
            else:
                patience += 1
                if patience >= self.learn.max_patience:
                    break
        if self.best_state is not None:
            self.model.load_state_dict(self.best_state)
        return best_metrics

    def _maybe_update_best(self, value: float, epoch: int) -> None:
        if value > self.best_value:
            self.best_value = value
            self.best_epoch = epoch
            # clones: the state dict shares storage with the parameters,
            # which the optimizer updates in place
            self.best_state = {k: v.detach().clone()
                               for k, v in self.model.state_dict().items()}
            if self.results_path:
                self.save(self.results_path)

    # --------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        """The best state (else the current one) as ``path/model.pt``: the
        model's state dict, parameters and batch-norm statistics."""
        os.makedirs(path, exist_ok=True)
        state = (self.best_state if self.best_state is not None
                 else self.model.state_dict())
        torch.save(state, os.path.join(path, "model.pt"))

    def load(self, path: str) -> None:
        state = torch.load(os.path.join(path, "model.pt"),
                           map_location=self.device, weights_only=True)
        self.model.load_state_dict(state)

    def save_checkpoint(self, path: str) -> None:
        raise NotImplementedError(f"full-state checkpoints are {NOT_PORTED}")

    def load_checkpoint(self, path: str) -> None:
        raise NotImplementedError(f"full-state checkpoints are {NOT_PORTED}")
