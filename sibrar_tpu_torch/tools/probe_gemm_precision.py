"""Time and check the score GEMM at each matmul precision of the JAX probe
(port of ``tools/probe_gemm_precision.py``).

Modes: ``default`` (one bf16 pass on the tensor cores, K15 ``score_bf16``),
``highest`` and ``asis`` (both K14 ``full``, the f32 FFMA loop: the port
computes f32 whenever no bf16 pass is asked for; it has no TF32 mode, as
the JAX probe has none). B = 1,024, D = 256, ``default_rng(1)`` draws.
``ms``: device time per call from CUDA events around ``iters`` calls after
one warm-up. ``rel_vs_xla_slice``: max |scores - ref| / max |ref| over the
first 8 users and 1,024 items, ``ref`` the f32 library product. On the TPU
XLA's own product ran at the same DEFAULT precision and hid the rounding;
here ``ref`` is f32, so ``default`` shows the bf16 rounding error.

    python -m sibrar_tpu_torch.tools.probe_gemm_precision [MODE] [C] [iters]

Left out: the JAX probe's ``enable_compilation_cache`` (a JAX-only
compilation cache).
"""
from __future__ import annotations

import json

import torch

from sibrar_tpu_torch.ops import gemm_probe
from sibrar_tpu_torch.tools import _common

MODES = ("default", "highest", "asis")


def step_for(mode: str):
    return gemm_probe.score_bf16 if mode == "default" else gemm_probe.score_full


def run(mode: str, u: torch.Tensor, items: torch.Tensor,
        iters: int = 25) -> dict:
    """The probe's JSON record for ``mode`` on these inputs."""
    step = step_for(mode)
    scores, _ = step(u, items)
    rel = _common.rel_vs_f32_slice(scores, u, items)
    del scores
    return {"mode": mode, "C": items.shape[0],
            "ms": _common.cuda_ms(lambda: step(u, items), iters, u.device),
            "rel_vs_xla_slice": rel}


def main(argv=None) -> None:
    p = _common.parser(__doc__)
    p.add_argument("mode", nargs="?", default="default", choices=MODES)
    p.add_argument("c", nargs="?", type=int, default=_common.C)
    p.add_argument("iters", nargs="?", type=int, default=25)
    args = p.parse_args(argv)
    u, items = _common.inputs(args.c, torch.device(args.device))
    print(json.dumps(run(args.mode, u, items, args.iters)))


if __name__ == "__main__":
    main()
