"""Cells, configurations, mixes, entries, references, limits and metric
readers are found by name, and a new one is added with files and entries
alone."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from harness import catalog

BENCH = catalog.benchmark()


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_each_cell_finds_its_parts(cell):
    c = catalog.cell(cell)
    conf = catalog.config(c["config"])
    mix = catalog.mix(c["traffic"])
    assert conf["name"] == c["config"]
    assert catalog.entry(mix["entry"]).UNIT
    assert callable(catalog.reference(conf["algorithm"]).parameter_spec)
    assert catalog.limits(cell)
    e2e = {m["name"] for m in catalog.metrics_of(cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert e2e - {"setup_s"} <= {mix.get("rate_metric"),
                                 mix.get("device_metric")}
    for m in catalog.metrics_of(cell, True):
        assert callable(catalog.metric_reader(m["name"]))


def test_every_file_named_in_the_benchmark_exists():
    root = catalog.ROOT
    for conf in BENCH["configs"]:
        assert os.path.exists(root / conf["file"])
        assert json.load(open(root / conf["file"]))["reduced"] == conf[
            "reduced"]
    for m in BENCH["per_layer"]:
        assert (catalog.BENCH / "metrics" / f"{m['name']}.py").exists()


NEW_METRIC = '''
def read(record):
    return 42.0 if record["slice"] else None
'''

RUNNER = '''
import json, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from harness import catalog, run_cell
res, out, err = run_cell.run("sbnet_small.train", 4000000123, 0.3, False,
                             "cpu", time.perf_counter())
assert [m["name"] for m in catalog.metrics_of("sbnet_small.train", True)
        ][-1] == "answer.train"
reader = catalog.metric_reader("answer.train")
print(json.dumps({"result": res, "read": reader({"slice": {"units": 1}}),
                  "none": reader({"slice": None})}))
'''


def test_a_cell_config_mix_and_metric_added_as_files(tmp_path):
    """Copy the benchmark, add a configuration, a mix, a metric reader,
    limits and their entries (no file edited but BENCHMARK.json's lists),
    and run the new cell from the copy."""
    bench_dir = tmp_path / "port_bench"
    shutil.copytree(catalog.BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    conf = catalog.config("sbnet_onion18")
    conf.update(name="sbnet_small")
    conf["data"].update(n_users=300, n_items=1024, n_interactions=6000)
    (bench_dir / "configs" / "sbnet_small.json").write_text(json.dumps(conf))
    mix = catalog.mix("train")
    mix.update(check_steps=2, warmup_steps=1)
    (bench_dir / "mixes" / "train_short.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "answer.train.py").write_text(NEW_METRIC)
    shutil.copy(catalog.BENCH / "limits" / "sbnet_onion18.train.json",
                bench_dir / "limits" / "sbnet_small.train.json")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "sbnet_small", "source": "test",
                             "file": "port_bench/configs/sbnet_small.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "sbnet_small.train",
                               "config": "sbnet_small",
                               "traffic": "train_short", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({
        "name": "train_pairs_per_s", "unit": "pairs/s", "better": "higher",
        "bound": 0.01, "source": "host_clock",
        "workloads": ["sbnet_small.train"]})
    bench["per_layer"].append({
        "name": "answer.train", "unit": "1", "better": "higher",
        "source": "device_trace", "layer": "device",
        "moves": "train_pairs_per_s", "workloads": ["sbnet_small.train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    got = subprocess.run(
        [sys.executable, "-c", RUNNER, str(bench_dir),
         str(catalog.ROOT)], capture_output=True, text=True, timeout=600,
        cwd=tmp_path)
    assert got.returncode == 0, got.stderr[-3000:]
    out = json.loads(got.stdout.strip().splitlines()[-1])
    assert out["result"]["correct"] is True
    assert set(out["result"]["metrics"]) == {"train_pairs_per_s",
                                             "setup_s"}
    assert out["read"] == 42.0 and out["none"] is None
