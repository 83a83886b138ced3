"""The masked fill with a bool or int8 mask, and the winner recovery at
bench shapes (port of ``tools/probe_pred_input.py``).

``try_mask`` runs kernel K17 (``ops/mask.py``) on x [b, 168, 128] and a mask
with 10 % of its lanes set, as ``bool`` or ``int8``, and checks it against
``torch.where``. ``try_recover`` runs kernel K11 (``peel.recover_winners``)
at b = 1,024, m = 168, w = 128, kk = 100 on the probe's ``default_rng(2)``
draws, checks its catalog ids and row flags against the plain version, and
reports K11's device time per call under ``torch.profiler`` (the kernels
whose names hold "recover", over 8 calls). The JAX probe checks lanes,
counts and windows, K11's first half (``peel.recover_winners_plain``).

    python -m sibrar_tpu_torch.tools.probe_pred_input [all|bool|int8|recover]

Left out: the JAX probe's ``enable_compilation_cache`` (a JAX-only
compilation cache).
"""
from __future__ import annotations

import numpy as np
import torch

from sibrar_tpu_torch.ops import mask as mask_ops
from sibrar_tpu_torch.ops import peel
from sibrar_tpu_torch.tools import _common


def mask_inputs(dtype_name: str, b: int = 16, device="cpu"):
    """The probe's draws: ``x`` from ``default_rng(0)``, the mask (lanes
    below 0.1 of ``default_rng(1)``) as bool, then in ``dtype_name``."""
    m, w = 168, 128
    x = np.random.default_rng(0).normal(size=(b, m, w)).astype(np.float32)
    d_bool = np.random.default_rng(1).random((b, m, w)) < 0.1
    d = d_bool if dtype_name == "bool" else d_bool.astype(np.int8)
    return (torch.from_numpy(x).to(device), torch.from_numpy(d_bool).to(device),
            torch.from_numpy(d).to(device))


def try_mask(dtype_name: str, b: int = 16, device="cuda") -> bool:
    """K17 with a ``bool`` or ``int8`` mask; True when it equals
    ``torch.where`` bit for bit."""
    x, d_bool, d = mask_inputs(dtype_name, b, device)
    out = mask_ops.mask_where(d, x)
    ok = torch.equal(out, torch.where(d_bool, mask_ops.NEG, x))
    print(f"mask input dtype={dtype_name}: compile+run OK, exact={ok}")
    return ok


def recover_inputs(device="cpu"):
    """The probe's ``default_rng(2)`` draws at its bench shapes, in its
    order: ``g``, ``slots``, ``widx``, then the winners' lanes; ``v`` is
    ``g`` at those lanes. Returns ``(g, widx, slots, v)``."""
    b, m, w, kk = 1024, 168, 128, 100
    rng = np.random.default_rng(2)
    g = rng.normal(size=(b, m, w)).astype(np.float32)
    slots = rng.integers(0, m, size=(b, kk)).astype(np.int32)
    widx = rng.integers(0, 784, size=(b, m)).astype(np.int32)
    lanes = rng.integers(0, w, (b, kk)).astype(np.int32)
    v = np.take_along_axis(g.reshape(b, m * w), slots * w + lanes, 1)
    return tuple(torch.from_numpy(a).to(device) for a in (g, widx, slots, v))


def try_recover(device="cuda") -> dict:
    """K11 at the bench shapes against its plain version, on the probe's
    draws as the windows, winners and window ids, each winner at position
    ``p = slot * t + s % t`` of a peel of depth t = 8 and each window's t-th
    largest value as ``last``; returns the two exactness flags (ids, row
    flags) and the device ms per call (None on the CPU)."""
    g, widx, slots, v = recover_inputs(device)
    t = peel.PEEL_T
    p = slots.long() * t + torch.arange(v.shape[1], device=g.device) % t
    last = torch.topk(g, t, dim=-1).values[..., -1].contiguous()
    got = peel.recover_winners(g, widx, p, t, v, last)
    want = peel.recover_plain(g, widx, p, t, v, last)
    flags = [torch.equal(a, b) for a, b in zip(got, want)]
    print("recover kernel: idx exact=", flags[0], "ok exact=", flags[1])
    ops = _common.device_ops_ms(
        lambda: peel.recover_winners(g, widx, p, t, v, last), g.device,
        match="recover")
    ms = None if ops is None else sum(ops.values())
    print("recover_winners device time: "
          + ("not measured (cpu)" if ms is None else f"{ms:.4f} ms/it"))
    return {"idx": flags[0], "ok": flags[1], "ms": ms}


def main(argv=None) -> None:
    p = _common.parser(__doc__)
    p.add_argument("which", nargs="?", default="all",
                   choices=("all", "bool", "int8", "recover"))
    args = p.parse_args(argv)
    if args.which in ("all", "bool"):
        try_mask("bool", device=args.device)
    if args.which in ("all", "int8"):
        try_mask("int8", device=args.device)
    if args.which in ("all", "recover"):
        try_recover(args.device)


if __name__ == "__main__":
    main()
