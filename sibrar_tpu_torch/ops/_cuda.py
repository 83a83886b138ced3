"""Build, load and launch the hand-written Hopper kernels under ``csrc/``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) into an object file, and the objects are linked into one
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), loaded with ``ctypes``. Objects and library land in
``sibrar_tpu_torch/_build/`` under names keyed by their sources, the shared
``csrc/*.cuh`` headers and the flags, on the first launch in a process; a
later process with the same sources reuses them.

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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# C entry points: name -> argument types (every entry returns a cudaError_t)
_SIGNATURES = {
    "sibrar_segment_gather": [_P, _P, _P, _I, _I, _P, _P, _P],
    "sibrar_score_wmax": [_P, _P, _I, _I, _I, _P, _P, _P],
    "sibrar_score_windows": [_P, _P, _I, _I, _I, _P, _P, _P],
    "sibrar_fused_score_wmax": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    "sibrar_recover_winners": [_P, _P, _P, _LL, _P, _LL, _P, _I, _I, _I, _I,
                               _P, _P, _P],
    "sibrar_exact_topk": [_P, _I, _I, _I, _P, _P, _P],
    "sibrar_gather_windows": [_P, _LL, _LL, _P, _I, _I, _P, _P, _P],
    "sibrar_peel_values": [_P, _LL, _I, _P, _P, _P],
    "sibrar_dw_matmul": [_P, _P, _I, _I, _I, _P, _P],
    "sibrar_spmm_fwd": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
    "sibrar_spmm_bwd": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "sibrar_window_max": [_P, _LL, _P, _P],
    "sibrar_window_retile": [_P, _I, _I, _P, _P, _P],
    "sibrar_score_variant": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    "sibrar_score_bf16": [_P, _P, _I, _I, _I, _P, _P, _P, _P],
    "sibrar_roll_lanes": [_P, _P, _LL, _I, _P, _P],
    "sibrar_lane_slice": [_P, _P, _LL, _I, _I, _P, _P],
    "sibrar_segment_roll": [_P, _LL, _P, _I, _I, _P, _P],
    "sibrar_mask_where": [_P, _P, _F, _LL, _P, _P],
    "sibrar_adam_step": [_P, _I, *[_F] * 9, _I, _I, _P],
}
# Size queries: name -> argument types (each returns a byte count, or
# K18's tensors a launch)
_QUERIES = {"sibrar_spmm_fwd_workspace": [_I, _I, _I],
            "sibrar_spmm_bwd_workspace": [_I, _I, _I],
            "sibrar_score_bf16_workspace": [_I, _I],
            "sibrar_adam_step_max_tensors": []}

_lib = None
_fns: dict = {}  # C entry -> its ctypes function, resolved on first launch
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


def _key(*parts: bytes) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for part in parts:
        digest.update(part)
    return digest.hexdigest()[:16]


def _run(procs: list) -> str:
    """Wait for every ``(cmd, Popen, tmp, dst)``; move each output into
    place; raise on the first failure. Returns the compilers' reports."""
    log, failed = "", None
    for cmd, proc, tmp, dst in procs:
        out, _ = proc.communicate()
        log += out
        if proc.returncode != 0 and failed is None:
            failed = f"{' '.join(cmd)} failed ({proc.returncode}):\n{out}"
        elif proc.returncode == 0:
            os.replace(tmp, dst)
    if failed:
        raise RuntimeError(failed)
    return log


def _start(cmd: list, dst: Path) -> tuple:
    tmp = dst.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen([*cmd, "-o", str(tmp)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return cmd, proc, tmp, dst


def build() -> ctypes.CDLL:
    """Compile (or reuse) the kernel library and load it: one ``nvcc -c``
    per source, all at once, then one link. Records the wall seconds and
    nvcc's ``-Xptxas -v`` report in `build_info`."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for src in sources:
        obj = BUILD_DIR / f"{src.stem}_{_key(src.read_bytes(), headers)}.o"
        objs.append(obj)
        if not obj.exists():
            procs.append(_start([_nvcc(), *NVCC_FLAGS, "-c", str(src)], obj))
    log = _run(procs)
    lib_path = BUILD_DIR / (
        f"libsibrar_kernels_{_key(*(o.name.encode() for o in objs))}.so")
    if not lib_path.exists():
        _run([_start([_nvcc(), *ARCH, "-shared", *map(str, objs)],
                     lib_path)])
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, argtypes in _QUERIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_longlong
    lib.sibrar_error_string.argtypes = [ctypes.c_int]
    lib.sibrar_error_string.restype = ctypes.c_char_p
    build_info.update(seconds=time.perf_counter() - t0, ptxas=log,
                      library=str(lib_path))
    _lib = lib
    return lib


def current_stream() -> int:
    """The raw handle of PyTorch's current stream on the current device
    (what ``torch.cuda.current_stream().cuda_stream`` gives, without
    building a ``torch.cuda.Stream``)."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def launch(name: str, *args) -> None:
    """Call C entry `name` on the current stream; raise on a launch error.
    The entry's ctypes function is looked up once per process."""
    fn = _fns.get(name)
    if fn is None:
        fn = _fns[name] = getattr(build(), name)
    err = fn(*args, current_stream())
    if err != 0:
        text = build().sibrar_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({text})")


def query(name: str, *args) -> int:
    """Call size query `name` (no stream, no launch)."""
    return int(getattr(build(), name)(*args))


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (take
    the plain version); raises on mixed or other devices."""
    first, *rest = tensors  # loops, not generators: this runs every call
    if first.is_cuda:
        index = first.get_device()
        for t in rest:
            if not t.is_cuda or t.get_device() != index:
                break
        else:
            return True
    elif first.is_cpu:
        for t in rest:
            if not t.is_cpu:
                break
        else:
            return False
    devices = {str(t.device) for t in tensors}
    if len(devices) > 1:
        raise ValueError(f"tensors on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    raise ValueError(f"no kernel or plain version for device {devices.pop()}")
