"""Optimizers, the training loop and validation (port of
``sibrar_tpu/train/trainer.py``: ``build_optimizer`` with bf16 first
moments, the train step with dense optimizers and row-sparse tables,
``epoch_batch_plan``, ``train_epoch``, ``make_score_fn``, ``validate``,
``fit`` with best-model tracking and its profiled first epoch, ``save`` /
``load`` and the full-state ``save_checkpoint`` / ``load_checkpoint``). Its
configs (``LearningConfig``, ``EvalConfig``, ``DatasetConfig``) live in
``config/schema.py``.

A train step samples negatives on the device, runs the model's train
forward (logits and regularization loss), adds the rec loss, and steps the
optimizer; an epoch walks a permutation of the split's pairs in full
batches plus a tail batch. The JAX package scans the epoch inside one jit;
here the steps run eagerly, one after the other, and nothing waits for the
device until the epoch's losses are read. Every random draw comes from the
trainer's ``torch.Generator`` on the device. Validation runs the model in
eval mode without autograd (``train/scoring.py``); the next train step
switches it back.

With ``learn.sparse_tables`` the id tables a model declares in its
``table_index_map`` (`train.row_adam.find_sparse_tables`) leave the dense
optimizer: their rows are injected into the forward and stepped by
`train.row_adam.row_adam_update`. ``debug_nans`` checks every step and
raises ``FloatingPointError`` at the first step whose loss, gradients or
updated parameters hold a NaN, naming the step and the tensor. JAX's
``jax_debug_nans`` traps the first operation that makes a NaN; this check
runs after the step's forward and backward (and again after its update),
so it names the first tensor of the step that holds one, not the
operation that made it, and it waits for the device twice per step (one
read of all the NaN flags after the backward, one after the update).

On a device mesh (``mesh=``, `parallel.mesh.make_mesh`) every rank runs
this loop (SPMD). Each step draws the global batch's negatives, routing and
dropout masks from the same generator on every rank and keeps the rank's
own rows; the batch shards over every rank, or over the data axis when
interaction-tower kernels are row-sliced over the item axis
(`parallel.mesh.shard_tower_state`, ``shard_towers``). The rec loss is
taken over the gathered logits, batch norm and the batch-wide losses see
the global batch, and the gradients are averaged over the batch's ranks
(one all-reduce) before the optimizer steps, so the step computes what
the single-device step computes up to summation order. An epoch's tail
batch is cut to a multiple of the batch's ranks (at most ranks - 1 pairs
sit out that epoch). Validation results are the same on every rank;
only rank 0 writes files.
"""
from __future__ import annotations

import math
import os
import time
from typing import Any, Callable, Iterable, Optional

import torch

from sibrar_tpu_torch.config.schema import (  # noqa: F401 (re-exported)
    DatasetConfig,
    EvalConfig,
    LearningConfig,
)
from sibrar_tpu_torch.data.dataset import DeviceData, RecDataset
from sibrar_tpu_torch.data.sampling import sample_negatives
from sibrar_tpu_torch.eval.evaluator import FullEvaluator, evaluate_model
from sibrar_tpu_torch.parallel import distributed as pdist
from sibrar_tpu_torch.parallel.mesh import (
    batch_group,
    batch_multiple,
    batch_shard,
    full_rows,
    gather_batch,
    shard_rows,
    shard_tower_state,
)
from sibrar_tpu_torch.train import scoring
from sibrar_tpu_torch.train.losses import build_rec_loss
from sibrar_tpu_torch.train.row_adam import (
    find_sparse_tables,
    row_adam_init,
    row_adam_update,
)

CHECKPOINT = "train_state.pt"


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

    ``mu_dtype=torch.bfloat16`` stores Adam's first moment in bf16, as
    optax's ``scale_by_adam(mu_dtype=bfloat16)``: the new moment is
    ``(1 - b1) g`` in f32 plus ``b1`` times the stored moment (a bf16
    product with ``b1`` rounded to bf16, as optax's weak-typed ``b1 *
    mu``), the update uses that f32 moment, and only the stored copy is
    rounded (to nearest even).

    ``state[p]`` holds ``mu`` / ``nu`` (Adam) or ``sum_of_squares``
    (adagrad); ``count`` is the number of steps taken."""

    B1, B2, EPS, RSS_EPS = 0.9, 0.999, 1e-8, 1e-7

    def __init__(self, params: Iterable[torch.nn.Parameter], kind: str,
                 lr: float, wd: float = 0.0,
                 mu_dtype: Optional[torch.dtype] = None):
        if kind not in ("adam", "adagrad", "adamw"):
            raise ValueError(f"unsupported optimizer {kind!r}")
        self.kind, self.lr, self.wd = kind, lr, wd
        self.params = [p for p in params if p.requires_grad]
        self.count = 0
        if kind == "adagrad":
            self.state = {p: {"sum_of_squares": torch.zeros_like(p)}
                          for p in self.params}
        else:
            self.state = {p: {"mu": torch.zeros_like(p, dtype=mu_dtype),
                              "nu": torch.zeros_like(p)}
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
                if st["mu"].dtype == p.dtype:
                    mu = st["mu"].mul_(self.B1).add_(g, alpha=1 - self.B1)
                else:  # bf16 storage, as optax: b1 * mu in bf16
                    b1 = torch.tensor(self.B1, dtype=st["mu"].dtype)
                    mu = (1 - self.B1) * g + (b1 * st["mu"]).to(p.dtype)
                    st["mu"] = mu.to(st["mu"].dtype)
                nu = st["nu"].mul_(self.B2).addcmul_(g, g, value=1 - self.B2)
                mu_hat = mu / (1 - self.B1 ** self.count)
                nu_hat = nu / (1 - self.B2 ** self.count)
                upd = mu_hat / (nu_hat.sqrt() + self.EPS)
                if self.kind == "adamw" and self.wd:
                    upd = upd + self.wd * p
            p.sub_(self.lr * upd)


def build_optimizer(learn: LearningConfig,
                    params: Iterable[torch.nn.Parameter]) -> Optimizer:
    """adam / adagrad / adamw as the JAX package chains them, with the
    first moment stored in bf16 when ``learn.moment_dtype`` says so."""
    mu_dtype = (torch.bfloat16 if learn.moment_dtype == "bfloat16"
                else None)
    return Optimizer(params, learn.optimizer, learn.lr, learn.wd, mu_dtype)


class Trainer:
    """Trains a `RecModel` on one split, on the device of its `DeviceData`
    (the card unless ``device`` says otherwise), and validates it with
    ``val_evaluator`` (needed by `fit` and `validate`).

    ``log_fn`` receives each epoch's record; ``post_val_fn(model, epoch)``
    may add metrics after each validation (JAX passes the params where this
    passes the model); ``results_path`` receives ``model.pt`` whenever the
    best model changes. ``debug_nans`` raises ``FloatingPointError`` at the
    first step with a NaN in its loss, gradients or updated parameters
    (``run_settings.debug_nans``).

    ``mesh`` runs the trainer on every rank of a device mesh; the batch
    size must divide over its ranks. With ``shard_towers`` the kernels of
    interaction towers with at least ``tower_min_rows`` rows are
    row-sliced over the item axis."""

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
                 profile_dir: Optional[str] = None,
                 debug_nans: bool = False, mesh=None,
                 shard_towers: bool = True, tower_min_rows: int = 8192):
        if mesh is not None and batch_size % batch_multiple(mesh):
            raise ValueError(
                f"batch_size {batch_size} must divide over the mesh "
                f"({batch_multiple(mesh)} devices)")
        for ev in (val_evaluator, train_evaluator):
            if ev is not None and ev.mesh is not mesh:
                raise ValueError("the trainer and its evaluators must share "
                                 "one mesh (or none)")
        self.model = model
        self.mesh = mesh
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
        # row-sparse tables: {module name: "user" | "item"}, their modules
        # and their row moments; every other parameter is the dense
        # optimizer's
        self.sparse = (find_sparse_tables(model, learn.sparse_table_min_rows)
                       if learn.sparse_tables else {})
        self.tables = {name: getattr(model, name) for name in self.sparse}
        self.row_state = {name: row_adam_init(t.weight.detach())
                          for name, t in self.tables.items()}
        sparse_ids = {id(t.weight) for t in self.tables.values()}
        self.optimizer = build_optimizer(
            learn, [p for p in model.parameters()
                    if id(p) not in sparse_ids])
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
        self.profile_dir = profile_dir
        self.debug_nans = debug_nans
        self._rows: dict = {}  # this step's injected rows: name -> (ids, rows)
        self.shard_towers = shard_towers
        self.tower_min_rows = tower_min_rows
        self._apply_tower_sharding()

    def _apply_tower_sharding(self) -> None:
        """Row-slice the tower kernels and their moments over the item axis
        (`parallel.mesh.shard_tower_state`); ``_tp`` maps each sliced
        parameter to ``(lo, hi, rows)``. Batches shard over every rank
        (``_flat``) unless a kernel is sliced."""
        self._tp = (shard_tower_state(self.model, self.mesh,
                                      min_rows=self.tower_min_rows,
                                      optimizer=self.optimizer)
                    if self.shard_towers else {})
        self._flat = not self._tp

    def train_step(self, idxs: torch.Tensor) -> torch.Tensor:
        """One optimizer step on the pairs ``idxs``; returns the device
        tensor ``[total, rec_loss, reg_loss]``."""
        self.optimizer.zero_grad()
        out = self.forward_backward(idxs)
        if self.mesh is not None:
            self._average_grads()
        if self.debug_nans:
            self._check_nans({
                ("loss", "total, rec, reg"): out,
                **{("gradient", n): p.grad
                   for n, p in self.model.named_parameters()
                   if p.grad is not None},
                **{("gradient", n): r.grad
                   for n, (_, r) in self._rows.items()
                   if r.grad is not None}})
        self.optimizer.step()
        for name, (ids, rows) in self._rows.items():
            g = rows.grad if rows.grad is not None else torch.zeros_like(rows)
            if self.mesh is not None:  # every rank steps every touched row
                group, _, n = batch_group(self.mesh, self._flat)
                ids = torch.cat(pdist.all_gather(ids, group))
                g = torch.cat(pdist.all_gather(g.contiguous(), group)) / n
            row_adam_update(self.tables[name].weight.data,
                            self.row_state[name], ids, g, self.step + 1,
                            lr=self.learn.lr, wd=self.learn.wd)
        self._rows = {}
        if self.debug_nans:
            self._check_nans({("updated parameter", n): p
                              for n, p in self.model.named_parameters()})
        self.step += 1
        return out

    def _average_grads(self) -> None:
        """Average every dense gradient over the batch's ranks, in one
        all-reduce (a parameter without a gradient counts as zeros)."""
        group, _, n = batch_group(self.mesh, self._flat)
        params = self.optimizer.params
        if not params:
            return
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in params])
        pdist.all_reduce(flat, group=group).div_(n)
        start = 0
        for p in params:
            p.grad = flat[start:start + p.numel()].view_as(p)
            start += p.numel()

    def draw_batch(self, idxs: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """The users ``[B]`` of the pairs ``idxs`` and their items ``[B, 1 +
        n_neg]`` (global ids, the positive first), the negatives drawn from
        the trainer's generator."""
        data = self.data
        u = data.train_users[idxs]
        pos = data.train_items_cat[idxs]
        negs = sample_negatives(
            self.gen, u, data.pos_csr, data.popularity,
            strategy=self.dataset_conf.negative_sampling_strategy,
            n_catalog=self.train_dataset.n_items_in_split, n_neg=self.n_neg,
            squashing_factor=self.dataset_conf.popularity_squashing_factor)
        i_cat = torch.cat([pos.unsqueeze(1), negs], dim=1)
        return u, data.catalog[i_cat.long()]

    def forward_backward(self, idxs: torch.Tensor) -> torch.Tensor:
        """The train step up to its gradients: draws (`draw_batch`), train
        forward, loss, backward into ``.grad`` (and, for row-sparse tables,
        into the injected rows' ``.grad``); returns ``[total, rec_loss,
        reg_loss]``. On a mesh ``idxs`` is the global batch: the draws are
        its, the forward runs this rank's rows and the rec loss the
        gathered logits."""
        u, i_global = self.draw_batch(idxs)
        if self.mesh is not None:
            u = shard_rows(u, self.mesh, flat=self._flat)
            i_global = shard_rows(i_global, self.mesh, flat=self._flat)
        self.model.train()
        source = {"user": u, "item": i_global}
        self._rows = {}
        for name, src in self.sparse.items():
            ids = source[src]
            rows = self.tables[name].weight.detach()[ids.long()]
            self._rows[name] = (ids, rows.requires_grad_())
            self.tables[name].rows = rows
        try:
            with batch_shard(self.mesh, self._flat):
                logits, reg = self.model(u, i_global, gen=self.gen)
                logits = gather_batch(logits)
        finally:
            for table in self.tables.values():
                table.rows = None
        labels = torch.zeros(logits.shape, device=self.device)
        labels[:, 0] = 1.0
        loss = self.rec_loss(logits, labels)
        total = loss + reg
        total.backward()
        return torch.stack([total, loss, reg]).detach()

    def _check_nans(self, tensors: dict) -> None:
        """Raise at the first of ``tensors`` (keyed ``(what, name)``)
        holding a NaN, naming it and this step (counted from 0). The
        tensors' flags are read from the device at once."""
        flags = torch.stack([torch.isnan(t).any()
                             for t in tensors.values()]).int()
        if self.mesh is not None:  # every rank raises, or none
            pdist.all_reduce(flags, "max", self.mesh.world_group)
        flags = flags.cpu()
        if bool(flags.any()):
            what, name = list(tensors)[int(flags.nonzero()[0])]
            raise FloatingPointError(
                f"NaN in the {what} {name!r} at train step {self.step}")

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
        if self.mesh is not None:  # whole rows for every rank of the batch
            ranks = batch_group(self.mesh, self._flat)[2]
            tail -= tail % ranks
            self.batch_size -= self.batch_size % ranks
            if self.batch_size == 0:
                raise ValueError(f"{n_inter} interactions do not fill one "
                                 f"row for each of {ranks} ranks")
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
        if self.mesh is not None:  # the regularizers' rank means, averaged
            group, _, n = batch_group(self.mesh, self._flat)
            self.epoch_losses = pdist.all_reduce(self.epoch_losses,
                                                 group=group) / n
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
                                     item_chunk, mesh=self.mesh,
                                     flat=self._flat)

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
            train_metrics = (self._profiled_epoch()
                             if epoch == 0 and self.profile_dir
                             else self.train_epoch())
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

    def _profiled_epoch(self) -> dict:
        """The first epoch of `fit` under ``torch.profiler``, its Chrome
        trace written to ``profile_dir/train_epoch0.json``: the same epoch,
        steps and draws as an unprofiled run (the JAX package traces its
        first epoch the same way). One session, opened after 2 s of idling
        (`tools._common.profiled`), so the epoch runs once."""
        from sibrar_tpu_torch.tools._common import profiled

        os.makedirs(self.profile_dir, exist_ok=True)
        out = {}
        profiled(lambda: out.update(self.train_epoch()),
                 os.path.join(self.profile_dir, "train_epoch0.json"),
                 idles=(2.0,))
        return out

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
    def _full(self, state: dict) -> dict:
        """``state`` with the row-sliced kernels put back together over the
        item group (a collective: every rank calls it)."""
        if not self._tp:
            return state
        return {k: full_rows(v, self.mesh) if k in self._tp else v
                for k, v in state.items()}

    def _local(self, state: dict) -> dict:
        """``state`` with this rank's rows of the sliced kernels."""
        if not self._tp:
            return state
        return {k: v[self._tp[k][0]:self._tp[k][1]] if k in self._tp else v
                for k, v in state.items()}

    def _full_moments(self, name: str, st: dict) -> dict:
        if name not in self._tp:
            return st
        return {k: full_rows(t, self.mesh) for k, t in st.items()}

    def save(self, path: str) -> None:
        """The best state (else the current one) as ``path/model.pt``: the
        model's state dict, parameters and batch-norm statistics. On a
        mesh rank 0 writes the file a single-device run writes, the
        kernel slices put back together."""
        state = self._full(self.best_state if self.best_state is not None
                           else self.model.state_dict())
        if pdist.is_main():
            os.makedirs(path, exist_ok=True)
            torch.save(state, os.path.join(path, "model.pt"))
        pdist.barrier()  # the file exists before any rank reads it

    def load(self, path: str) -> None:
        state = torch.load(os.path.join(path, "model.pt"),
                           map_location=self.device, weights_only=True)
        self.model.load_state_dict(self._local(state))

    def state_dict(self) -> dict:
        """The whole training state, as tensors and numbers (the row-sliced
        kernels and their moments whole, on a mesh): parameters
        and batch-norm statistics, the optimizer's step count and moments
        (by parameter name), the row moments of sparse tables, the state
        of the trainer's generator (on its device: every draw of training
        comes from it), the step, and the best state (None before the
        first validation), value and epoch."""
        names = {p: n for n, p in self.model.named_parameters()}
        return {
            "model": self._full(self.model.state_dict()),
            "optimizer": {"count": self.optimizer.count,
                          "state": {names[p]: self._full_moments(names[p], st)
                                    for p, st in
                                    self.optimizer.state.items()}},
            "rows": self.row_state,
            "generator": self.gen.get_state(),
            "step": self.step,
            "best": {"state": (None if self.best_state is None
                               else self._full(self.best_state)),
                     "value": self.best_value, "epoch": self.best_epoch}}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore `state_dict`'s state in place (tensors keep their
        dtype and move to this trainer's device)."""
        self.model.load_state_dict(self._local(state["model"]))
        params = dict(self.model.named_parameters())
        self.optimizer.count = int(state["optimizer"]["count"])
        for name, st in state["optimizer"]["state"].items():
            lo, hi, _ = self._tp.get(name, (None, None, None))
            for key, t in st.items():
                self.optimizer.state[params[name]][key] = t[lo:hi].to(
                    self.device)
        for name, st in state["rows"].items():
            for key, t in st.items():
                self.row_state[name][key].copy_(t)
        self.gen.set_state(state["generator"])
        self.step = int(state["step"])
        best = state["best"]
        self.best_state = (None if best["state"] is None else
                           {k: v.to(self.device) for k, v in
                            self._local(best["state"]).items()})
        self.best_value = float(best["value"])
        self.best_epoch = int(best["epoch"])

    def save_checkpoint(self, path: str) -> None:
        """The full training state (`state_dict`) as
        ``path/train_state.pt``, for resuming mid-training: the JAX
        package's ``save_checkpoint`` state in a torch format that
        ``torch.load(..., weights_only=True)`` reads."""
        state = self.state_dict()
        if pdist.is_main():
            os.makedirs(path, exist_ok=True)
            torch.save(state, os.path.join(path, CHECKPOINT))
        pdist.barrier()

    def load_checkpoint(self, path: str) -> None:
        """Resume from `save_checkpoint`'s file; raises
        ``FileNotFoundError`` when ``path`` holds none."""
        file = os.path.join(path, CHECKPOINT)
        if not os.path.exists(file):
            raise FileNotFoundError(f"no train-state checkpoint in {path!r}")
        self.load_state_dict(torch.load(file, map_location="cpu",
                                        weights_only=True))
