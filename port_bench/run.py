#!/usr/bin/env python3
"""Benchmark of the PyTorch port (``sibrar_tpu_torch``) on NVIDIA cards.

Run from the root of a checkout on a machine with the cards the cell asks
for:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One run measures one cell of ``BENCHMARK.json``: set-up (imports, the data
and weights made on the card from the seed, the program's trainer, the
checked first units and the warm-up), then whole units for ``--seconds``,
then the comparison with the plain reference under ``reference/``. The
last line of standard output is the result as one JSON object; the numbers
compared, each with its limit, end standard error. Without enough CUDA
cards, or if JAX or the JAX package was loaded, it prints no result and
exits with code 1.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".bench_cache")
# kernel caches inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(var, os.path.join(CACHE, sub))
sys.path[:0] = [HERE, ROOT]


def bytecode_cache() -> None:
    """Where the installed torch has no bytecode beside its sources (the
    environment writes none), keep Python's bytecode inside the checkout:
    without it every run compiles torch's sources again (7-9 s on an H100
    machine's host), and only the first run should."""
    spec = importlib.util.find_spec("torch")
    if spec is None or not spec.cached or os.path.exists(spec.cached):
        return
    sys.pycache_prefix = os.path.join(CACHE, "pyc")
    sys.dont_write_bytecode = False


bytecode_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    times = {"python_s": time.perf_counter() - T_START}
    t = time.perf_counter()
    import torch
    times["torch_import_s"] = time.perf_counter() - t

    t = time.perf_counter()
    from harness import catalog, check, run_cell
    times["harness_imports_s"] = time.perf_counter() - t

    t = time.perf_counter()
    chips = catalog.cell(args.workload)["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"needs {chips} CUDA card(s); found {found}", file=sys.stderr)
        return 1
    torch.empty(0, device="cuda")  # the context, apart from the data
    times["cuda_init_s"] = time.perf_counter() - t
    result, out, err = run_cell.run(args.workload, args.seed, args.seconds,
                                    bool(args.trace), "cuda", T_START,
                                    times=times)
    loaded = check.forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 1
    for line in out:
        print(line)
    sys.stdout.flush()
    print("\n".join(err), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
