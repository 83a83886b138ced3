"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

``run`` returns the result and the lines to print; ``run.py`` prints them.
The window runs whole units (a train step, a validation pass) until
``seconds`` have passed; a rate is the work of every unit over the time from
the window's start to the end of the last unit, after a synchronize. A
mix's ``device_metric``, where the cell reports it, is the device's busy
time a unit over the whole window, from a profiler trace of the window
(``WindowTrace``) in the untraced run. With ``trace`` the window also
records host spans around each unit, and one profiler slice of
``slice_units`` units from unit ``slice_start`` (with the layer hooks on),
from which the per-layer metrics are read.
"""
from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time

import torch

from harness import catalog, check, traffic
from harness.program import sync
from harness.trace import Tracer, WindowTrace


def seeds_of(seed: int) -> dict:
    """The data, the weights and the trainer's generator each take their
    own seed, derived from ``--seed``."""
    return {"data": seed, "weights": seed + 1, "trainer": seed + 2}


def card(device) -> dict:
    """The device block of the result line (``count`` cards of the kind
    of card 0), with the card's power limit."""
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def launch_counts() -> dict:
    """Every launch counter the program's kernel wrappers keep
    (``fn.launches`` of the loaded ``sibrar_tpu_torch.ops`` modules)."""
    out = {}
    for name, module in list(sys.modules.items()):
        if not name.startswith("sibrar_tpu_torch.ops.") or module is None:
            continue
        for attr, fn in vars(module).items():
            n = getattr(fn, "launches", None)
            if callable(fn) and isinstance(n, int):
                out[f"{name.rsplit('.', 1)[1]}.{attr}"] = n
    return out


def window(run, unit: str, seconds: float, tracer: Tracer, device,
           whole: WindowTrace | None = None) -> dict:
    """Units until ``seconds`` have passed (and the slice is read); with
    ``whole``, the device's activity over all of them ("device")."""
    if whole is not None:
        whole.open()
    sync(device)
    t0 = time.perf_counter()
    units = 0
    while True:
        tracer.before_unit(units)
        with tracer.span(unit):
            run.unit()
        tracer.after_unit()
        units += 1
        if (time.perf_counter() - t0 >= seconds
                and not tracer.pending(units)):
            break
    tracer.close()
    sync(device)
    out = {"t0": t0, "t1": time.perf_counter(), "units": units}
    if whole is not None:
        out["device"] = whole.close(units)
    return out


def device_ms_per_unit(win: dict):
    """Device busy milliseconds a unit over the whole window (None without
    a window trace); a trace that lost kernels gives no number."""
    dev = win.get("device")
    if dev is None:
        return None
    if not dev["complete"]:
        raise RuntimeError(
            f"the window's trace lost kernels: {dev['kernels']} kernels and "
            f"{dev['markers']} markers for {dev['launched']} launches")
    return 1e3 * dev["busy_s"] / win["units"]


def finite(x):
    """A number for the JSON line: non-finite values as strings."""
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def run(cell_name: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, data_overrides: dict | None = None,
        times: dict | None = None) -> tuple[dict, list, list]:
    """``(result, stdout lines, stderr lines)`` of one run;
    ``data_overrides`` replaces data parameters (for tests at small
    sizes); ``times`` holds the parts of set-up before the call (else the
    whole of it is ``imports_s``)."""
    bench = catalog.benchmark()
    cell = catalog.cell(cell_name, bench)
    conf = catalog.config(cell["config"])
    mix = catalog.mix(cell["traffic"])
    entry = catalog.entry(mix["entry"])
    family = catalog.reference(conf["algorithm"])
    limits = catalog.limits(cell_name)
    out, err = [], []
    seeds = seeds_of(seed)
    times = dict(times or {"imports_s": time.perf_counter() - t_start})

    t = time.perf_counter()
    params = traffic.parameters(conf.get("data"), {**mix.get("data", {}),
                                                   **(data_overrides or {})})
    data = traffic.make(params, seeds["data"], device)
    times["data_s"] = time.perf_counter() - t
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    prog = entry.Run(conf, mix, data, family, seeds, device, times, trace)
    sync(device)
    setup_s = time.perf_counter() - t_start
    out.append("setup " + json.dumps({k: round(v, 4) for k, v in
                                      times.items()}))

    tracer = Tracer(trace, prog.model, mix.get("slice_start", 0),
                    mix.get("slice_units", 0))
    e2e = [m["name"] for m in catalog.metrics_of(cell_name, False, bench)]
    whole = (WindowTrace() if not trace and torch.device(device).type
             == "cuda" and mix.get("device_metric") in e2e else None)
    before = launch_counts()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    win = window(prog, entry.UNIT, seconds, tracer, device, whole)
    window_peak = (torch.cuda.max_memory_allocated()
                   if torch.device(device).type == "cuda" else 0)
    dev = card(device)
    after = launch_counts()
    out.append("launches " + json.dumps(
        {k: after[k] - before.get(k, 0) for k in after
         if after[k] - before.get(k, 0)}))
    rate = win["units"] * prog.work_per_unit / (win["t1"] - win["t0"])
    record = {"entry": mix["entry"], "window": win,
              "work_per_unit": prog.work_per_unit,
              "spans": tracer.spans, "slice": tracer.record(),
              "slices_tried": len(tracer.slices),
              "memory_window_peak_bytes": window_peak, **prog.record()}
    readings = prog.readings()
    failed = prog.failed(readings)
    if mix["entry"] == "validate":
        out.append(f"redo rows in the window's passes and set-up: "
                   f"{record['redo_rows']}")
    prog.close()
    del prog
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    tf32 = (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    ref = entry.reference_readings(family, conf, mix, data, seeds, device)
    numbers = entry.numbers(readings, ref)
    details = entry.details(readings, ref)
    if details:
        out.append("check details " + json.dumps(details))
    del ref
    out.append(f"reference and comparison {time.perf_counter() - t:.3f} s")
    correct, checks = check.judge(numbers, limits)
    if tf32:
        correct = False
        err.append("TF32 was on in the window: the configuration states f32")

    metrics = {}
    if trace:
        for m in catalog.metrics_of(cell_name, True, bench):
            value = catalog.metric_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        sl = record["slice"]
        if sl is not None:
            dev["busy_s"] = sl["busy_s"]
            dev["window_s"] = sl["window_s"]
    else:
        for m in catalog.metrics_of(cell_name, False, bench):
            if m["name"] == "setup_s":
                value = setup_s
            elif m["name"] == mix.get("rate_metric"):
                value = rate
            elif m["name"] == mix.get("device_metric"):
                value = device_ms_per_unit(win)
                if value is None:  # no card: nothing to read
                    continue
            else:
                raise ValueError(f"{cell_name} cannot report {m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": win["units"],
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and record["slice"] is not None:
        sl = record["slice"]
        result["breakdown"] = {
            "device_ops": [[k[:120], v] for k, v in sorted(
                sl["by_name"].items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": sl["gaps"][:10]}
    result["checks"] = {k: {"value": finite(v["value"]),
                            "limit": v["limit"]} for k, v in checks.items()}
    keys = ("units", "launched", "kernels", "markers", "read_s")
    out.append(f"card {power_limit()}; window {win['units']} units in "
               f"{win['t1'] - win['t0']:.4f} s; slices "
               + json.dumps([{k: sl[k] for k in keys}
                             for sl in tracer.slices]))
    if "device" in win:
        out.append("window trace " + json.dumps(
            {k: win["device"][k] for k in keys + ("busy_s", "window_s",
                                                  "stop_s")}))
    if trace and record["slice"] is None:
        err.append("the profiler slice lost kernels on every attempt")
    spans = [t1 - t0 for _, t0, t1, inside in tracer.spans if not inside]
    if spans:
        out.append(f"host ms per unit outside the slice: median "
                   f"{1e3 * statistics.median(spans):.4f}")
    err += [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in checks.items()]
    return result, out, err
