"""The validation entry: whole ``Trainer.validate()`` passes, each one
catalog encode (``Trainer.make_score_fn``) and then, per batch of users,
the user encode, the scores, the train items' exclusion, the top-k
selection, the hit tests and the metrics, with one transfer to the host.

The top-k lists of every batch are kept as the evaluator hands them to its
metric step (a wrapper on that one method of the benchmark's evaluator
object); the last pass's lists and metrics are compared with the
reference's. Every pass must give the first pass's metrics (a pass that
does not counts as failed). In a traced run the catalog encode of each pass
is timed with CUDA events, and the score step's shape is recorded.
"""
from __future__ import annotations

import math
import time

import torch

from harness import check, program
from harness import weights as bench_weights
from reference import common

UNIT = "validate"


class Run:
    def __init__(self, conf: dict, mix: dict, data: dict, family, seeds: dict,
                 device, times: dict, trace: bool):
        spec = family.parameter_spec(conf, program.sizes(data))
        self.trainer, w = program.build(conf, data, spec, seeds, device,
                                        with_val=True, times=times)
        del w
        self.model = self.trainer.model
        ev = self.trainer.val_evaluator
        self.n_users = int(ev.data.users_in_split.shape[0])
        self.work_per_unit = self.n_users
        self._batch_lists: list = []
        metric_step = ev._metrics_from_topk

        def keep_lists(topk_idx, u_idxs):
            self._batch_lists.append(topk_idx)
            return metric_step(topk_idx, u_idxs)

        ev._metrics_from_topk = keep_lists
        self.encodes: list = []
        self.score_shape = None
        if trace:
            make = self.trainer.make_score_fn
            batch = conf["loader"]["eval_batch_size"]

            def timed_make(*args, **kwargs):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn = make(*args, **kwargs)
                end.record()
                self.encodes.append((start, end))
                items = fn.dot_parts[1] if fn.dot_parts else fn.items
                self.score_shape = (batch, *items.shape)
                return fn

            self.trainer.make_score_fn = timed_make
        self.metrics: list = []
        t = time.perf_counter()
        for _ in range(mix["warmup_passes"]):
            self.unit()
        program.sync(device)
        times["warmup_s"] = time.perf_counter() - t
        self.encodes = []  # the window's passes only
        self.window_start = len(self.metrics)

    def unit(self) -> None:
        self._batch_lists = []
        self.metrics.append(self.trainer.validate())
        self.lists = self._batch_lists

    def record(self) -> dict:
        ev = self.trainer.val_evaluator
        return {"catalog_encode_ms": [s.elapsed_time(e)
                                      for s, e in self.encodes],
                "score_shape": self.score_shape,
                "users_per_pass": self.n_users,
                "batches_per_pass": -(-self.n_users
                                      // self.trainer.eval_batch_size),
                "redo_rows": sum(ev.redo_rows)}

    def readings(self) -> dict:
        lists = torch.cat(self.lists)[:self.n_users]
        return {"lists": lists, "metrics": self.metrics[-1],
                "window_metrics": self.metrics[self.window_start:],
                "first": self.metrics[0]}

    def failed(self, readings: dict) -> int:
        first = readings["first"]
        return sum(m != first or not all(math.isfinite(v)
                                         for v in m.values())
                   for m in readings["window_metrics"])

    def close(self) -> None:
        self.trainer = self.model = None
        self.lists = self._batch_lists = []


def reference_readings(family, conf: dict, mix: dict, data: dict,
                       seeds: dict, device, fault: str | None = None
                       ) -> dict:
    if fault is not None:
        raise ValueError(f"no planted fault {fault!r} in the validation "
                         "reference")
    w = bench_weights.make(family.parameter_spec(conf, program.sizes(data)),
                           seeds["weights"], device)
    return common.evaluate(family, conf, data, w)


def numbers(prog: dict, ref: dict) -> dict:
    return {"list_gap": check.list_gap(prog["lists"], ref),
            "metric_gap": check.metric_gap(
                prog["metrics"], ref["metrics_of"](prog["lists"]))}


def control(ctrl: dict, ref: dict) -> dict:
    """The control's outputs in the program's layout: its own lists, their
    metrics worked out in bfloat16."""
    return {"lists": ctrl["ids"],
            "metrics": ref["metrics_of"](ctrl["ids"], torch.bfloat16)}


def details(prog: dict, ref: dict) -> dict:
    return {}
