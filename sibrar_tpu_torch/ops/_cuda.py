"""Build, load and launch the hand-written Hopper kernels under ``csrc/``.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` into one shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), loaded
with ``ctypes``. The library lands in ``sibrar_tpu_torch/_build/`` under a
name keyed by the sources and flags, on the first launch in a process; a
later process with the same sources reuses it.

Dispatch rule for every wrapper (`use_kernel`): a CUDA tensor launches the
kernel, a CPU tensor takes the kernel's plain PyTorch version, anything else
raises. Nothing falls back from a failed build or launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C entry points: name -> argument types (every entry returns a cudaError_t)
_SIGNATURES = {
    "sibrar_segment_gather": [_P, _P, _P, _I, _I, _P, _P, _P],
    "sibrar_score_wmax": [_P, _P, _I, _I, _I, _P, _P, _P],
    "sibrar_gather_windows": [_P, _LL, _P, _I, _I, _P, _P, _P],
    "sibrar_peel_values": [_P, _LL, _I, _P, _P, _P],
}

_lib = None
build_info: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found (looked in {home}/bin and PATH)")
    return found


def build() -> ctypes.CDLL:
    """Compile (or reuse) the kernel library and load it. Records the wall
    seconds and nvcc's ``-Xptxas -v`` report in `build_info`."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib_path = BUILD_DIR / f"libsibrar_kernels_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sibrar_error_string.argtypes = [ctypes.c_int]
    lib.sibrar_error_string.restype = ctypes.c_char_p
    build_info.update(seconds=time.perf_counter() - t0, ptxas=log,
                      library=str(lib_path))
    _lib = lib
    return lib


def launch(name: str, *args) -> None:
    """Call C entry `name` on the current stream; raise on a launch error."""
    lib = build()
    err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        text = lib.sibrar_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({text})")


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (take
    the plain version); raises on mixed or other devices."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"tensors on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {dev}")
