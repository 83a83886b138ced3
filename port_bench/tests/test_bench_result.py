"""The result line's keys, the module guard, and runs that must print no
result."""
import json
import os
import shutil
import subprocess
import sys

from bench_tiny import run
from harness import catalog, check

RUN = str(catalog.BENCH / "run.py")


def test_the_result_line_keys():
    result, out, err = run("sbnet_onion18.validate")
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"val_users_per_s", "setup_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(result["device"])
    for v in result["checks"].values():
        assert set(v) == {"value", "limit"}
    json.loads(json.dumps(result))  # finite numbers only
    assert err[-len(result["checks"]):] == [
        f"check {k}: {v['value']!r} (limit {v['limit']!r})"
        for k, v in result["checks"].items()]


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    for name in ("sibrar_tpu_torch", "sibrar_tpu_torch.ops", "jax_like"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert check.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sibrar_tpu.models", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert check.forbidden_modules() == ["jax", "sibrar_tpu"]


def test_the_references_import_neither_the_program_nor_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import reference.common, reference.sbnet, reference.dmf; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'sibrar_tpu_torch', 'sibrar_tpu', 'jax', 'jaxlib', 'flax', "
            "'optax'}))")
    got = subprocess.run([sys.executable, "-c", code, str(catalog.BENCH)],
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr
    assert got.stdout.strip() == "[]"


def test_no_card_no_result():
    got = subprocess.run(
        [sys.executable, RUN, "--workload", "sbnet_onion18.train", "--seed",
         "5000000000", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=catalog.ROOT)
    if got.returncode == 0:  # a card is there: a result is due
        json.loads(got.stdout.strip().splitlines()[-1])
        return
    assert got.stdout.strip() == ""


def test_the_benchmark_alone_prints_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files has no
    program to run."""
    shutil.copy(catalog.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(catalog.BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    got = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "dmf_onion18.train", "--seed", "5000000001", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path, env=env)
    assert got.returncode != 0
    assert not any(line.startswith("{") for line in
                   got.stdout.splitlines())
