"""Time the score GEMM (K2, K14 ``full``) and K5 ``dw_matmul`` as built
from several kernel source trees, in turns on one card.

    python3 -m sibrar_tpu_torch.tools.compare_builds DIR [DIR ...]

Each DIR holds kernel sources laid out as ``sibrar_tpu_torch/csrc/`` (any
of ``dw_matmul.cu``, ``score_wmax.cu``, ``score_variants.cu`` with the
headers they include, and ``error_string.cu``), for example the port's own
``csrc`` and an unpacked older commit's. Each tree is built with the
port's nvcc flags into its own library under ``sibrar_tpu_torch/_build/``;
its kernels are checked against the plain versions (K2 and K14 within
``1e-5 (1 + max |s|)``, K5 within ``2 R eps |vec| . |g|`` per element), then
timed with CUDA events at the main paths' shapes in the order DIR1, DIR2,
..., DIRn, DIRn, ..., DIR1, so a drift of the card's clock cancels in each
tree's mean. One PyTorch call for the same product is timed beside them.
Prints one JSON line: the card, then per kernel each tree's times; each
build's registers and spills (``-Xptxas -v``) go to stderr.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

from sibrar_tpu_torch import full_f32
from sibrar_tpu_torch.ops import _cuda
from sibrar_tpu_torch.tools._common import cuda_ms

F32_EPS = 2.0 ** -24
SOURCES = ("dw_matmul.cu", "score_wmax.cu", "score_variants.cu",
           "error_string.cu")
# the main paths' shapes: K5 on the train step's item rows (R x C users x
# H), K2 at serving and validation width, K14 full at the probes' catalog
DW_SHAPE = (2256, 50_000, 512)
SCORE_SHAPE = (1024, 100_352, 256)
PROBE_C = 501_760


def build_tree(tree: Path) -> ctypes.CDLL:
    """Compile the sources of `tree` (one nvcc each, in parallel) and link
    them into a library keyed by their bytes; returns it loaded."""
    srcs = [tree / s for s in SOURCES if (tree / s).exists()]
    headers = b"".join(h.read_bytes() for h in sorted(tree.glob("*.cuh")))
    key = hashlib.sha256(b"".join(s.read_bytes() for s in srcs) + headers
                         + " ".join(_cuda.NVCC_FLAGS).encode()).hexdigest()
    out = _cuda.BUILD_DIR / f"compare_{key[:16]}"
    out.mkdir(parents=True, exist_ok=True)
    objs = [out / f"{s.stem}.o" for s in srcs]
    log = _cuda._run([_cuda._start([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-c",
                                    str(s)], o)
                      for s, o in zip(srcs, objs) if not o.exists()])
    for line in log.splitlines():  # registers and spills, to stderr
        if any(w in line for w in ("Compiling entry", "Used", "spill")):
            print(f"{tree}: {line.strip()}", file=sys.stderr)
    lib_path = out / "libcompare.so"
    if not lib_path.exists():
        _cuda._run([_cuda._start([_cuda._nvcc(), *_cuda.ARCH, "-shared",
                                  *map(str, objs)], lib_path)])
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _cuda._SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    return lib


def call(lib, name: str, *args) -> None:
    err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def cases(dev) -> dict:
    """name -> (C entry, step(lib), check(lib), iters, library call): one
    input set per kernel, shared by every tree. ``check`` raises where the
    tree's kernel disagrees with the plain version."""
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    r, n_cols, h = DW_SHAPE
    vec = (torch.rand(r, n_cols, device=dev, generator=gen) < 2.5e-4).float()
    g = torch.randn(r, h, device=dev, generator=gen)
    dw = torch.empty(n_cols, h, device=dev)

    def dw_step(lib):
        call(lib, "sibrar_dw_matmul", vec.data_ptr(), g.data_ptr(), r, n_cols,
             h, dw.data_ptr())

    def dw_check(lib):
        dw_step(lib)
        tol = 2 * r * F32_EPS * (vec.T @ g.abs())
        if not bool(((dw - vec.T @ g).abs() <= tol).all()):
            raise AssertionError("dw_matmul beyond the f32 GEMM bound")
    out["dw_matmul"] = ("sibrar_dw_matmul", dw_step, dw_check, 10,
                        lambda: torch.matmul(vec.T, g))
    b, _, d = SCORE_SHAPE
    u = torch.randn(b, d, device=dev, generator=gen)
    for name, entry, c in (("score_wmax", "sibrar_score_wmax",
                            SCORE_SHAPE[1]),
                           ("score_full", "sibrar_score_variant", PROBE_C)):
        items = torch.randn(c, d, device=dev, generator=gen) / d ** 0.5
        s = torch.empty(b, c, device=dev)
        wmax = torch.empty(c // 128 * b, device=dev)
        extra = () if entry == "sibrar_score_wmax" else (0,)  # 0: full

        def step(lib, items=items, s=s, wmax=wmax, c=c, entry=entry,
                 extra=extra):
            call(lib, entry, u.data_ptr(), items.data_ptr(), b, c, d, *extra,
                 s.data_ptr(), wmax.data_ptr())

        def check(lib, step=step, items=items, s=s, wmax=wmax, name=name):
            step(lib)
            ref = u @ items.T
            tol = 1e-5 * (1.0 + ref.abs().max().item())
            own = s.view(b, -1, 128).amax(-1)
            if name == "score_full":
                own = own.T
            if not ((s - ref).abs().max().item() <= tol
                    and torch.equal(wmax.view(own.shape), own)):
                raise AssertionError(f"{name}: scores beyond {tol} or "
                                     "maxima not those of its scores")
        out[name] = (entry, step, check, 20 if c < PROBE_C else 10,
                     lambda items=items: torch.matmul(u, items.T))
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trees", nargs="+", type=Path)
    args = p.parse_args(argv)
    full_f32()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    libs = [build_tree(t) for t in args.trees]
    order = list(range(len(libs))) + list(reversed(range(len(libs))))
    result = {"card": card, "trees": [str(t) for t in args.trees],
              "order": order, "kernels": {}}
    for name, (entry, step, check, iters, lib_call) in cases(dev).items():
        have = [hasattr(lib, entry) for lib in libs]
        for lib, ok in zip(libs, have):
            if ok:
                check(lib)
        times = [[] for _ in libs]
        for i in order:
            if have[i]:
                times[i].append(cuda_ms(lambda: step(libs[i]), iters, dev))
        result["kernels"][name] = {
            "ms": times, "library_ms": cuda_ms(lib_call, iters, dev)}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
