"""The training entry: ``Trainer.train_step`` over the epoch permutation's
batches, one after the other, as ``Trainer.train_epoch`` runs them.

Set-up builds the trainer once, draws the epoch permutation from its
generator as ``train_epoch`` does, and runs the first ``check_steps``
steps through the same call and feed as the window (the rows of a
permutation all differ): after the first, each leaf's first gradient is
read back from Adam's first moment (``mu / (1 - b1)``), after the last each
leaf's change from the weights the benchmark made. ``warmup_steps`` more
follow, then the window continues the same permutation; at its end a new
one is drawn (the tail batch of an epoch is skipped: every step has the
timed shape). The reference follows the first ``check_steps`` steps from
the same weights and seed.
"""
from __future__ import annotations

import math
import time

import torch

from harness import check, program
from harness import weights as bench_weights
from reference import common

UNIT = "train_step"


class Run:
    def __init__(self, conf: dict, mix: dict, data: dict, family, seeds: dict,
                 device, times: dict, trace: bool):
        self.spec = family.parameter_spec(conf, program.sizes(data))
        self.trainer, w = program.build(conf, data, self.spec, seeds, device,
                                        with_val=False, times=times)
        self.model = self.trainer.model
        self.bs = conf["loader"]["batch_size"]
        self.work_per_unit = self.bs
        self.n = int(self.trainer.data.train_users.shape[0])
        self.k = 0
        self.perm = self._perm()
        self.losses: list = []
        names = {p: n for n, p in self.model.named_parameters()}
        opt = self.trainer.optimizer
        t = time.perf_counter()
        for step in range(mix["check_steps"]):
            self.unit()
            if step == 0:
                self._grad = {names[p]: (opt.state[p]["mu"].float()
                                         / (1 - opt.B1)).norm()
                              for p in opt.params}
        self._change = {n: (p.detach() - w[n]).norm()
                        for n, p in self.model.named_parameters()}
        self.n_check = mix["check_steps"]
        del w
        times["check_steps_s"] = time.perf_counter() - t
        t = time.perf_counter()
        for _ in range(mix["warmup_steps"]):
            self.unit()
        program.sync(device)
        times["warmup_s"] = time.perf_counter() - t
        self.window_start = len(self.losses)

    def _perm(self) -> torch.Tensor:
        return torch.randperm(self.n, generator=self.trainer.gen,
                              device=self.trainer.device)

    def unit(self) -> None:
        if (self.k + 1) * self.bs > self.n:
            self.k, self.perm = 0, self._perm()
        idx = self.perm[self.k * self.bs:(self.k + 1) * self.bs]
        self.k += 1
        self.losses.append(self.trainer.train_step(idx))

    def record(self) -> dict:
        return {}

    def readings(self) -> dict:
        losses = torch.stack(self.losses).cpu()
        return {"loss": losses[:self.n_check, 0].tolist(),
                "grad": {n: float(v) for n, v in self._grad.items()},
                "change": {n: float(v) for n, v in self._change.items()},
                "window_losses": losses[self.window_start:, 0].tolist()}

    def failed(self, readings: dict) -> int:
        return sum(not math.isfinite(x) for x in readings["window_losses"])

    def close(self) -> None:
        self.trainer = self.model = self.perm = None
        self.losses = []


def reference_readings(family, conf: dict, mix: dict, data: dict,
                       seeds: dict, device, fault: str | None = None
                       ) -> dict:
    w = bench_weights.make(family.parameter_spec(conf, program.sizes(data)),
                           seeds["weights"], device)
    return common.train_readings(family, conf, data, w, seeds["trainer"],
                                 mix["check_steps"], fault=fault)


def numbers(prog: dict, ref: dict) -> dict:
    return check.train_numbers(prog, ref)


def control(ctrl: dict, ref: dict) -> dict:
    return ctrl


def details(prog: dict, ref: dict) -> dict:
    return check.train_details(prog, ref)
