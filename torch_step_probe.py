#!/usr/bin/env python3
"""Train-step probes of the PyTorch port on one NVIDIA GPU, at the widths
of ``conf/single/sbnet_onion18_huge_no-user.yml`` on the onion-scale
synthetic train split (the helpers are ``chip_py``'s, beside this
file):

    # which gradients of one SBNet step differ between two calls from one
    # state, the user bag gradient by the gather-and-sum formula and by
    # K7, and two same-seed trainings of --steps steps
    python3 torch_step_probe.py determinism --steps 50
    # the same step under torch.use_deterministic_algorithms(True,
    # warn_only=True): logs every op PyTorch warns has no deterministic
    # kernel
    CUBLAS_WORKSPACE_CONFIG=:4096:8 python3 torch_step_probe.py determinism
    # device busy ms (profiler) and CUDA-event ms per train step, dense
    # first layer and INTERACTION_SPMM on
    python3 torch_step_probe.py step-times

Both probes run on whichever ``sibrar_tpu_torch`` is importable: to compare
two trees on one card, copy this file and ``chip_py`` to a directory
outside both and run them once per tree with ``PYTHONPATH`` set to it
(parent, change, change, parent).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from chip_smoke import (
    DEVICE,
    PROFILE_STEPS,
    SEED,
    bits_differ,
    card_line,
    log,
    max_abs_err,
    parent_bag,
    profile_window,
    sbnet_trainer,
    train_window,
    trainer_state,
)


def step_grads(trainer, idxs) -> dict:
    """Each parameter's gradient from one train step on ``idxs`` (draws,
    forward, backward; no optimizer step), with the trainer's generator
    and the batch-norm statistics put back afterwards."""
    gen_state = trainer.gen.get_state()
    buffers = {k: v.clone() for k, v in trainer.model.named_buffers()}
    trainer.model.zero_grad(set_to_none=True)
    trainer.forward_backward(idxs)
    grads = {name: p.grad.clone()
             for name, p in trainer.model.named_parameters()
             if p.grad is not None}
    trainer.model.zero_grad(set_to_none=True)
    trainer.gen.set_state(gen_state)
    for k, v in trainer.model.named_buffers():
        v.copy_(buffers[k])
    return grads


def parent_bag_grads(tower, users) -> list:
    """The kernel gradient of the user tower's bag branch by `parent_bag`
    and by ``spmm_onehot`` (K6 / K7), twice each, for the same output
    gradient."""
    import torch

    from sibrar_tpu_torch.ops.sparse import csr_row_gather
    from sibrar_tpu_torch.ops.spmm import spmm_onehot

    cols, mask = csr_row_gather(tower.csr, users)
    g = torch.randn(users.shape[0], tower.kernel.shape[1],
                    device=users.device, generator=torch.Generator(
                        device=users.device).manual_seed(SEED))
    out = []
    for fn in (lambda k: parent_bag(k, cols, mask),
               lambda k: spmm_onehot(cols, mask, k)):
        for _ in range(2):
            k = tower.kernel.detach().clone().requires_grad_()
            fn(k).backward(g)
            out.append(k.grad)
    return out


def step_device_times(steps: int = PROFILE_STEPS) -> None:
    """Device busy ms per SBNet train step (profiler) and CUDA-event ms per
    step, dense first layer and ``INTERACTION_SPMM`` on, for whichever
    ``sibrar_tpu_torch`` is importable: run it once per tree to compare
    two trees on one card."""
    import torch

    import sibrar_tpu_torch
    from sibrar_tpu_torch import full_f32
    from sibrar_tpu_torch.data.dataset import make_splits
    from sibrar_tpu_torch.data.synthetic import make_onion_scale_splits
    from sibrar_tpu_torch.models import layers
    from sibrar_tpu_torch.ops import _cuda

    full_f32()
    _cuda.build()
    train = make_splits(make_onion_scale_splits(seed=7))["train"]
    tdata = train.to_device(torch.device(DEVICE))
    trainer = sbnet_trainer(train, tdata)
    out = {"tree": os.path.dirname(os.path.dirname(
        os.path.abspath(sibrar_tpu_torch.__file__))), "card": card_line()}
    for spmm_on in (False, True):
        layers.INTERACTION_SPMM = spmm_on
        train_window(trainer, 5)
        trainer.learn.max_batches_per_epoch = steps
        key = "spmm" if spmm_on else "dense"
        out[f"{key}_device_ms"] = profile_window(trainer.train_epoch, steps,
                                                 f"train steps, {key}")
        out[f"{key}_event_ms"] = train_window(trainer, steps)["event_ms"]
    layers.INTERACTION_SPMM = False
    log(json.dumps(out))


def diagnose_determinism(steps: int = 20) -> None:
    """Which part of an SBNet train step differs between two calls from
    one state, at the YAML's widths on the onion-scale train split: the
    gradients of one step twice (and again under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` when
    ``CUBLAS_WORKSPACE_CONFIG`` is set, logging every op PyTorch warns has
    no deterministic kernel), the user tower's bag gradient alone, and two
    trainings of ``steps`` steps from one seed."""
    import warnings

    import torch

    from sibrar_tpu_torch import full_f32
    from sibrar_tpu_torch.data.dataset import make_splits
    from sibrar_tpu_torch.data.synthetic import make_onion_scale_splits
    from sibrar_tpu_torch.ops import _cuda

    log(f"card: {card_line()}")
    full_f32()
    _cuda.build()
    dev = torch.device(DEVICE)
    train = make_splits(make_onion_scale_splits(seed=7))["train"]
    tdata = train.to_device(dev)
    det = bool(os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    if det:
        torch.use_deterministic_algorithms(True, warn_only=True)
    trainer = sbnet_trainer(train, tdata)
    trainer.model.train()
    perm = torch.randperm(tdata.train_users.shape[0], device=dev,
                          generator=torch.Generator(device=dev).manual_seed(1))
    idxs = perm[:trainer.batch_size]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        g1 = step_grads(trainer, idxs)
        g2 = step_grads(trainer, idxs)
    for msg in sorted({str(w.message).split("\n")[0] for w in caught}):
        log(f"warning: {msg[:300]}")
    diff = bits_differ(g1, g2)
    log(f"one step twice (deterministic mode {det}): {len(diff)} of "
        f"{len(g1)} gradients differ")
    for name, (n, err) in diff.items():
        log(f"  {name}: {n} of {g1[name].numel()} entries, max abs "
            f"{err:.3e}")
    tower = trainer.model.user_module.net
    users = tdata.train_users[idxs]
    a, b, c, d = parent_bag_grads(tower, users)
    log(f"user bag gradient, gather + sum with autograd's backward: "
        f"{bits_differ({'k': a}, {'k': b}) or 'bit-equal'}; spmm_onehot "
        f"(K7): {bits_differ({'k': c}, {'k': d}) or 'bit-equal'}; the two "
        f"ways apart by {max_abs_err(a, c):.3e}")
    if det:
        return
    from sibrar_tpu_torch.models import layers

    for spmm_on in (False, True):
        layers.INTERACTION_SPMM = spmm_on
        runs = []
        for _ in range(2):
            tr = sbnet_trainer(train, tdata)
            train_window(tr, steps)
            runs.append(trainer_state(tr))
        diff = bits_differ(*runs)
        log(f"two trainings of {steps} steps from seed {SEED}, "
            f"INTERACTION_SPMM {spmm_on}: {len(diff)} of {len(runs[0])} "
            f"tensors differ")
        for name, (n, err) in sorted(diff.items())[:40]:
            log(f"  {name}: {n} entries, max abs {err:.3e}")
    layers.INTERACTION_SPMM = False


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("probe", choices=("determinism", "step-times"))
    p.add_argument("--steps", type=int, default=20,
                   help="steps of each training (determinism)")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_step_probe: needs a CUDA card")
    if args.probe == "determinism":
        diagnose_determinism(args.steps)
    else:
        step_device_times()
    return 0


if __name__ == "__main__":
    sys.exit(main())
