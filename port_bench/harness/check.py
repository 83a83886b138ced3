"""The comparison that decides ``correct``, and the guard on loaded modules.

Training: the first step's loss, each leaf's first-gradient norm and each
leaf's change norm after the first steps, program against reference.
A norm's gap is ``|program - reference|`` over the reference's norm of
that leaf or of the median leaf, whichever is larger, taken at the worst
leaf. Leaves whose reference gradient is under a thousandth of the median
leaf's (a bias that batch norm cancels) move under Adam by round-off alone
and are left out of the change.

Validation: ``list_gap``, per user and rank, how far the reference's score
of the program's item lies from the reference's score at that rank, over the
row's score scale, worst over every user (an excluded, repeated or missing
item reads infinite); ``metric_gap``, the largest difference of a metric
value against the reference's metrics of the program's own lists, worked
out in float64 (a key missing on either side reads infinite). The lists
are judged against the reference's scores, the metrics against the lists.
"""
from __future__ import annotations

import math
import sys

import torch

from reference.common import median

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sibrar_tpu")
TINY_GRAD = 1e-3  # of the median leaf's first-gradient norm


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def _gap(got: dict, want: dict, keep=None) -> float:
    names = [n for n in want if keep is None or n in keep]
    if set(got) != set(want) or not names:
        return math.inf
    floor = median(abs(want[n]) for n in names)
    return max(abs(got[n] - want[n]) / max(abs(want[n]), floor)
               for n in names)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``first_loss_gap`` (the first step's loss), ``grad_gap`` and
    ``change_gap`` of the program's readings against the reference's
    (`reference.common.train_readings`' layout). The later steps' losses
    are not compared: Adam's first steps move every leaf by about the
    learning rate whatever its gradient, so round-off in a leaf of nought
    gradient moves the next losses by more than the control does (see
    `train_details`)."""
    if len(prog["loss"]) != len(ref["loss"]) or not prog["loss"]:
        return {"first_loss_gap": math.inf, "grad_gap": math.inf,
                "change_gap": math.inf}
    first = abs(prog["loss"][0] - ref["loss"][0]) / max(abs(ref["loss"][0]),
                                                         1e-30)
    if not all(math.isfinite(x) for x in prog["loss"]):
        first = math.inf
    return {"first_loss_gap": first,
            "grad_gap": _gap(prog["grad"], ref["grad"]),
            "change_gap": _gap(prog["change"], ref["change"],
                               moved_leaves(ref))}


def moved_leaves(ref: dict) -> set:
    """Leaves whose reference first gradient is at least a thousandth of
    the median leaf's."""
    floor = median(ref["grad"].values())
    return {n for n, g in ref["grad"].items() if g >= TINY_GRAD * floor}


def train_details(prog: dict, ref: dict) -> dict:
    """What the numbers do not show: every step's loss gap, the worst leaf
    of each norm with its gap, and the leaves left out of the change."""
    out = {"loss_gaps": [abs(p - r) / max(abs(r), 1e-30)
                         for p, r in zip(prog["loss"], ref["loss"])]}
    keep = moved_leaves(ref)
    for key, names in (("grad", ref["grad"]), ("change", keep)):
        floor = median(ref[key][n] for n in names)
        worst = max(names, key=lambda n: abs(prog[key].get(n, math.inf)
                                             - ref[key][n])
                    / max(ref[key][n], floor))
        out[f"worst_{key}"] = [worst, prog[key].get(worst), ref[key][worst],
                               ref["grad"][worst] / median(
                                   ref["grad"].values())]
    out["left_out_of_change"] = sorted(set(ref["grad"]) - keep)
    return out


@torch.no_grad()
def list_gap(ids: torch.Tensor, ref: dict, block: int = 1024) -> float:
    """Worst ``|ref top value at rank j - ref score of the program's j-th
    item| / row scale`` over users and ranks; ``ids [U, k]`` the program's
    lists in user order."""
    top, scale, score = ref["top"], ref["scale"], ref["score"]
    if ids.shape != top.shape:
        return math.inf
    worst = 0.0
    n_items = None
    for start in range(0, ids.shape[0], block):
        users = torch.arange(start, min(start + block, ids.shape[0]),
                             device=top.device)
        s = score(users)
        n_items = s.shape[1]
        got_ids = ids[start:start + block].to(top.device).long()
        if bool(((got_ids < 0) | (got_ids >= n_items)).any()):
            return math.inf
        srt = torch.sort(got_ids, dim=1).values
        if bool((srt[:, 1:] == srt[:, :-1]).any()):
            return math.inf
        got = s.gather(1, got_ids)
        if bool(torch.isinf(got).any()):
            return math.inf
        gap = (top[start:start + block] - got).abs() / scale[
            start:start + block].clamp(min=1e-30).unsqueeze(1)
        worst = max(worst, float(gap.max()))
    return worst


def metric_gap(got: dict, want: dict) -> float:
    if set(got) != set(want):
        return math.inf
    gaps = [abs(got[k] - want[k]) for k in want]
    if not all(math.isfinite(g) for g in gaps):
        return math.inf
    return max(gaps)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: correct when every number
    has a limit and is within it."""
    out = {}
    ok = True
    for name, value in numbers.items():
        limit = limits.get(name)
        out[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and value <= limit
    return ok and set(limits) <= set(numbers), out
