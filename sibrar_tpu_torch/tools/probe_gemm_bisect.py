"""Bisect the score GEMM's epilogue by device time per kernel (port of
``tools/probe_gemm_bisect.py``).

Modes: the six K14 epilogues, ``full``, ``noscores``, ``nowmax``,
``wmax_contig``, ``wmax_T``, ``wmax_lanes`` (``ops/gemm_probe.py``), each
its own kernel name, and ``xla`` (``torch.matmul`` in f32). B = 1,024, D =
256, ``default_rng(1)`` draws. ``device_ops_ms_per_it`` is device time per
call of the 6 largest kernels under ``torch.profiler`` over 8 calls (the
JAX probe read the same from a ``jax.profiler`` trace); ``ms`` is device
time per call from CUDA events over the same count, apart.

    python -m sibrar_tpu_torch.tools.probe_gemm_bisect MODE [C]

Left out: the JAX probe's ``enable_compilation_cache`` (a JAX-only
compilation cache) and its sum over each output (it forced XLA to
materialise them; eager PyTorch writes every output anyway).
"""
from __future__ import annotations

import json

import torch

from sibrar_tpu_torch.tools import _common

MODES = ("full", "noscores", "nowmax", "xla", "wmax_contig", "wmax_T",
         "wmax_lanes")


def run(mode: str, u: torch.Tensor, items: torch.Tensor) -> dict:
    """The probe's JSON record for ``mode`` on these inputs."""
    step = _common.gemm_step(mode)
    n = _common.PROFILED_ITERS
    return {"mode": mode, "C": items.shape[0],
            "ms": _common.cuda_ms(lambda: step(u, items), n, u.device),
            "device_ops_ms_per_it": _common.device_ops_ms(
                lambda: step(u, items), u.device, n)}


def main(argv=None) -> None:
    p = _common.parser(__doc__)
    p.add_argument("mode", choices=MODES)
    p.add_argument("c", nargs="?", type=int, default=_common.C)
    args = p.parse_args(argv)
    u, items = _common.inputs(args.c, torch.device(args.device))
    print(json.dumps(run(args.mode, u, items)))


if __name__ == "__main__":
    main()
