"""Time the score GEMM with and without each half of its epilogue (port of
``tools/probe_gemm_variants.py``).

Modes: ``full`` (scores + transposed window maxima, K14), ``noscores``
(no [B, C] store), ``nowmax`` (no maxima: the hand-written GEMM alone) and
``xla`` (the library GEMM, ``torch.matmul`` in f32). B = 1,024, D = 256,
``default_rng(1)`` draws. ``ms`` is device time per call from CUDA events
around ``iters`` calls after one warm-up.

    python -m sibrar_tpu_torch.tools.probe_gemm_variants MODE [C] [iters]

Left out: the JAX probe's ``enable_compilation_cache`` (a JAX-only
compilation cache; nothing here is compiled per call).
"""
from __future__ import annotations

import json

import torch

from sibrar_tpu_torch.tools import _common

MODES = ("full", "noscores", "nowmax", "xla")


def run(mode: str, u: torch.Tensor, items: torch.Tensor,
        iters: int = 25) -> dict:
    """The probe's JSON record for ``mode`` on these inputs."""
    step = _common.gemm_step(mode)
    return {"mode": mode, "C": items.shape[0],
            "ms": _common.cuda_ms(lambda: step(u, items), iters, u.device)}


def main(argv=None) -> None:
    p = _common.parser(__doc__)
    p.add_argument("mode", choices=MODES)
    p.add_argument("c", nargs="?", type=int, default=_common.C)
    p.add_argument("iters", nargs="?", type=int, default=25)
    args = p.parse_args(argv)
    u, items = _common.inputs(args.c, torch.device(args.device))
    print(json.dumps(run(args.mode, u, items, args.iters)))


if __name__ == "__main__":
    main()
