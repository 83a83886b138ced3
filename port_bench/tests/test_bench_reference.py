"""The plain references against the program at small sizes on the CPU, the
faults a cell can have, each seen as ``correct`` false, and the control on
the card."""
import json

import pytest
import torch

from bench_tiny import SEED, TINY, run
from harness import catalog

CELLS = [c["name"] for c in catalog.benchmark()["workloads"]]
TRAIN = [c for c in CELLS if catalog.mix(catalog.cell(c)["traffic"])[
    "entry"] == "train"]
VALIDATE = [c for c in CELLS if c not in TRAIN]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_program(cell):
    result, _, _ = run(cell)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0


def _fails(cell, monkeypatch_fn, monkeypatch):
    monkeypatch_fn(monkeypatch)
    result, _, err = run(cell)
    assert result["correct"] is False, err
    return result["checks"]


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_the_state_unchanged_fails(cell, monkeypatch):
    from sibrar_tpu_torch.train.trainer import Optimizer

    def plant(mp):
        mp.setattr(Optimizer, "step", lambda self: None)

    checks = _fails(cell, plant, monkeypatch)
    assert checks["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_the_batch_left_out_fails(cell, monkeypatch):
    from sibrar_tpu_torch.train.trainer import Trainer

    full = Trainer.forward_backward

    def plant(mp):
        mp.setattr(Trainer, "forward_backward",
                   lambda self, idxs: full(self, idxs[:idxs.shape[0] // 2]))

    _fails(cell, plant, monkeypatch)


@pytest.mark.parametrize("cell", VALIDATE)
def test_an_answer_altered_where_it_is_produced_fails(cell, monkeypatch):
    from sibrar_tpu_torch.eval import evaluator

    def plant(mp):
        select = evaluator.masked_topk

        def altered(*args, **kwargs):
            out = select(*args, **kwargs)
            out[1][0, 0] = (out[1][0, 0] + 1) % TINY["n_items"]
            return out

        mp.setattr(evaluator, "masked_topk", altered)

    checks = _fails(cell, plant, monkeypatch)
    assert checks["list_gap"]["value"] != 0


@pytest.mark.parametrize("cell", VALIDATE)
def test_half_the_users_left_out_fails(cell, monkeypatch):
    from sibrar_tpu_torch.eval.evaluator import FullEvaluator

    accumulate = FullEvaluator._accumulate

    def half(self, u_idxs, valid, metrics, cov):
        keep = torch.arange(u_idxs.shape[0]) < u_idxs.shape[0] // 2
        if valid is not None:
            keep &= torch.as_tensor(valid)
        return accumulate(self, u_idxs, keep.numpy(), metrics, cov)

    def plant(mp):
        mp.setattr(FullEvaluator, "_accumulate", half)

    checks = _fails(cell, plant, monkeypatch)
    assert checks["metric_gap"]["value"] > checks["metric_gap"]["limit"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_on_the_card(cell, cuda):
    """The reference in the program's place with TF32 on fails a number
    of the cell at its own size (``readings.py`` reads it on more seeds)."""
    import readings

    got = readings.control_numbers(cell, SEED, cuda)["control"]
    limits = catalog.limits(cell)
    assert any(v > limits[k] for k, v in got.items()), json.dumps(got)
