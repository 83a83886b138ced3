"""The port's span and counter recorder (`sibrar_tpu_torch.utils.trace`)
and the spans and counters the program records with it, on the CPU; two
card tests (marked ``card``, skipped without a card) hold the recorder's
clock to ``torch.profiler``'s and its ``host_wait`` spans (the
``host_reads`` counter) to the synchronizing calls CUDA's sync debug mode
reports. On a card, from the
repository's root:

    python -m pytest --noconftest -m card tests/test_torch_trace.py

This file imports no JAX."""
import copy
import importlib.util
import json
import os
import time
import traceback
import warnings

import numpy as np
import pytest
import torch

from sibrar_tpu_torch.data.dataset import make_splits
from sibrar_tpu_torch.data.synthetic import (
    make_onion_scale_splits,
    make_synthetic_splits,
)
from sibrar_tpu_torch.eval.evaluator import FullEvaluator, evaluate_model
from sibrar_tpu_torch.models.sbnet import SingleBranchNet
from sibrar_tpu_torch.train.trainer import (
    DatasetConfig,
    EvalConfig,
    LearningConfig,
    Trainer,
)
from sibrar_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEATURES = {"ivec256": 16, "bert": 24, "musicnn": 8}
PHASES = ("trainer.draw_batch", "trainer.forward", "trainer.backward",
          "trainer.optimizer_step")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _since(t0: int, names=None) -> list:
    """The global recorder's events stamped from ``t0`` on (of ``names``)."""
    return [e for e in trace.snapshot()["events"]
            if e[1] >= t0 and (names is None or e[0] in names)]


# ------------------------------------------------------------ the recorder
def test_spans_nest_and_add_to_their_totals():
    rec = trace.Recorder(capacity=16)
    with trace.Span(rec, "outer") as outer:
        with trace.Span(rec, "inner") as inner:
            time.sleep(0.001)
        with trace.Span(rec, "inner"):
            pass
    snap = rec.snapshot()
    names = [e[0] for e in snap["events"]]
    assert names == ["inner", "inner", "outer"]  # stored as each ends
    (_, i0, i1), (_, j0, j1), (_, o0, o1) = snap["events"]
    assert o0 <= i0 <= i1 <= j0 <= j1 <= o1
    assert inner.ns == i1 - i0 >= 1_000_000 and outer.ns == o1 - o0
    assert snap["dropped"] == 0 and snap["counters"] == {}


def test_the_ring_keeps_the_newest_events_and_counts_the_dropped():
    rec = trace.Recorder(capacity=4)
    for i in range(6):
        with trace.Span(rec, f"s{i}"):
            pass
    rec.count("c", 5)
    snap = rec.snapshot()
    assert [e[0] for e in snap["events"]] == ["s3", "s4", "s5", "c"]
    assert snap["dropped"] == 3
    assert snap["counters"] == {"c": 5}
    stamps = [e[1] for e in snap["events"]]
    assert stamps == sorted(stamps)


def test_counters_add_and_land_in_the_ring():
    rec = trace.Recorder()
    t0 = time.time_ns()
    rec.count("rows", 3)
    rec.count("rows")
    rec.count("other", 0)
    snap = rec.snapshot()
    assert snap["counters"] == {"rows": 4, "other": 0}
    assert [(e[0], e[2]) for e in snap["events"]] == [
        ("rows", 3), ("rows", 1), ("other", 0)]
    assert all(t0 <= e[1] <= time.time_ns() for e in snap["events"])


def test_host_read_counts_the_total_and_the_site():
    """A host wait is one span in the ring, ``host_wait.<site>``, and adds
    to the counters ``host_reads`` and ``host_reads.<site>``, which stay
    out of the ring."""
    rec = trace.Recorder()
    for site in ("test.site", "test.site", "test.other"):
        with trace.HostWait(rec, site) as wait:
            time.sleep(0.001)
    snap = rec.snapshot()
    assert [e[0] for e in snap["events"]] == [
        "host_wait.test.site", "host_wait.test.site", "host_wait.test.other"]
    assert snap["counters"] == {"host_reads": 3, "host_reads.test.site": 2,
                                "host_reads.test.other": 1}
    _, a, b = snap["events"][-1]
    assert wait.ns == b - a >= 1_000_000
    before = trace.counter("host_reads")
    with trace.host_wait("test.global"):
        pass
    assert trace.counter("host_reads") - before == 1
    assert trace.counter("never.counted") == 0


def test_the_anchor_pairs_the_two_clocks():
    rec = trace.Recorder()
    ns0, perf0 = time.time_ns(), time.perf_counter()
    with trace.Span(rec, "s"):
        time.sleep(0.002)
    snap = rec.snapshot()
    ns1, perf1 = time.time_ns(), time.perf_counter()
    ns, perf = snap["anchor"]
    assert ns0 <= ns <= ns1 and perf0 <= perf <= perf1
    # a span placed by the anchor falls where perf_counter saw it
    _, a, b = snap["events"][0]
    start = perf + (a - ns) / 1e9
    assert perf0 - 1e-3 <= start <= perf1 and b - a >= 2_000_000


def test_mirrored_spans_reach_a_host_profile():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("test.unmirrored"):
            pass
        with trace.mirrored():
            with trace.span("test.mirrored"):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert "test.mirrored" in names and "test.unmirrored" not in names
    assert not trace.RECORDER.mirror


# ---------------------------------------------------------- the train step
def _model_conf():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    conf = copy.deepcopy(mod.MODEL_CONF)
    conf["shared_common_dim"] = 8
    conf["user"]["embedding_dim"] = 8
    conf["item"]["common_modality_dim"] = 16
    conf["item"]["single_branch_hidden_layers"] = [16, 16, 8, 8]
    return conf


def _sbnet_trainer(device="cpu", n_users=120, n_items=300,
                   n_interactions=3000, **kw):
    splits = make_splits(make_onion_scale_splits(
        n_users=n_users, n_items=n_items, n_interactions=n_interactions,
        n_clusters=8, seed=7, feature_dims=FEATURES))
    train, val = splits["train"], splits["val"]
    data = train.to_device(device)
    model = SingleBranchNet.build_from_conf(_model_conf(), train, data,
                                            seed=1)
    ev = FullEvaluator(EvalConfig(top_k=[10, 100]), val, val.to_device(
        device), evaluator_name="val")
    learn = LearningConfig(optimizer="adamw", lr=3e-3, rec_loss="bpr",
                           **kw)
    return Trainer(model, train, learn, DatasetConfig(n_negative_samples=4),
                   batch_size=128, seed=0, device_data=data,
                   val_evaluator=ev, eval_batch_size=64)


def test_a_train_step_records_its_four_phases_in_order():
    trainer = _sbnet_trainer()
    idx = torch.arange(128)
    trainer.train_step(idx)  # first calls build what they cache
    t0 = time.time_ns()
    trainer.train_step(idx)
    events = _since(t0, {"trainer.train_step", *PHASES})
    assert [e[0] for e in events] == [*PHASES, "trainer.train_step"]
    _, step0, step1 = events[-1]
    starts = [e[1] for e in events[:-1]]
    assert starts == sorted(starts)
    for (_, a, b), (_, c, _) in zip(events[:-2], events[1:-1]):
        assert b <= c  # one phase ends before the next begins
    assert all(step0 <= a <= b <= step1 for _, a, b in events[:-1])


def test_fit_logs_its_walls_from_the_epoch_and_validate_spans():
    logs = []
    trainer = _sbnet_trainer(n_epochs=1, max_batches_per_epoch=2)
    trainer.log_fn = logs.append
    t0 = time.time_ns()
    trainer.fit()
    spans = {e[0]: e for e in _since(t0, {"trainer.train_epoch",
                                          "trainer.validate"})}
    _, a, b = spans["trainer.train_epoch"]
    _, c, d = spans["trainer.validate"]
    assert logs[-1]["train/epoch_wall_s"] == round((b - a) / 1e9, 2)
    assert logs[-1]["val/wall_s"] == round((d - c) / 1e9, 2)
    assert b <= c  # the epoch's validation follows it
    assert len(_since(t0, {"trainer.validate"})) == 2  # before and after


def test_val_wall_holds_the_train_evaluation_and_the_hook():
    """``val/wall_s`` covers the epoch's whole validation: the val split,
    the train split's evaluation and the post-validation hook."""
    logs = []
    trainer = _sbnet_trainer(n_epochs=1, max_batches_per_epoch=2)
    val = trainer.val_evaluator
    trainer.train_evaluator = FullEvaluator(
        EvalConfig(top_k=[10]), val.dataset, val.data,
        evaluator_name="train")
    hooked = []

    def hook(model, epoch):
        time.sleep(0.02)
        hooked.append(time.time_ns())
        return {"hook/epoch": epoch}

    trainer.post_val_fn = hook
    trainer.log_fn = logs.append
    t0 = time.time_ns()
    trainer.fit()
    _, c, d = _since(t0, {"trainer.validate"})[-1]
    passes = _since(c, {"evaluator.get_results"})
    assert len(passes) == 2  # the val split, then the train split's
    assert all(c <= a <= b <= d for _, a, b in passes)
    assert c <= hooked[-1] <= d and d - c >= 20_000_000
    assert logs[-1]["val/wall_s"] == round((d - c) / 1e9, 2)
    assert logs[-1]["hook/epoch"] == 0 and "train/ndcg@10" in logs[-1]


def test_the_profiled_epoch_holds_the_program_spans(tmp_path):
    trainer = _sbnet_trainer(max_batches_per_epoch=2)
    trainer.profile_dir = str(tmp_path)
    trainer._profiled_epoch()
    with open(tmp_path / "train_epoch0.json") as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"trainer.train_step", *PHASES} <= names
    assert not trace.RECORDER.mirror


# ------------------------------------------------------------ validation
def _forced_trip():
    """tests/test_torch_evaluator.py's forced exactness trip: every winner
    in one window, k = 100, so the peel flags rows on the dot path and on
    the scores path."""
    val = make_synthetic_splits(n_users=32, n_items=32768,
                                n_interactions=2000, seed=11,
                                with_features=False)["val"]
    rng = np.random.default_rng(4)
    u_mat = torch.as_tensor(np.abs(rng.standard_normal((32, 8))).astype(
        np.float32))
    items = np.zeros((val.n_items_in_split, 8), np.float32)
    items[256:384] = np.abs(rng.standard_normal((128, 8))) + 5.0
    items = torch.as_tensor(items)

    def score_fn(u):
        return u_mat[u.long()] @ items.T

    def dot_fn(u):
        return score_fn(u)

    dot_fn.dot_parts = (lambda u: u_mat[u.long()], items)
    return val, dot_fn, score_fn


def test_a_dot_pass_records_each_batch_and_its_results():
    val, dot_fn, _ = _forced_trip()
    ev = FullEvaluator(EvalConfig(top_k=[10, 100]), val, val.to_device(
        "cpu"), evaluator_name="val")
    names = {"evaluator.rank", "host_wait.peel.flag", "evaluator.metrics",
             "evaluator.get_results"}
    t0 = time.time_ns()
    flags = trace.counter("host_reads.peel.flag")
    evaluate_model(dot_fn, ev, batch_size=16)
    events = _since(t0, names)
    # per batch: the flag read inside the rank, then the metrics
    assert [e[0] for e in events] == [
        "host_wait.peel.flag", "evaluator.rank", "evaluator.metrics"] * 2 + [
        "evaluator.get_results"]
    for i in (0, 3):
        (_, f0, f1), (_, r0, r1), (_, m0, _) = events[i:i + 3]
        assert r0 <= f0 <= f1 <= r1 <= m0
    assert trace.counter("host_reads.peel.flag") - flags == 2


@pytest.mark.parametrize("path", ["dot", "scores"])
def test_redone_rows_counted_from_the_peel_read(path):
    """Each batch reads its flags once, and ``redo_rows`` comes from that
    read: on the dot path the count the peel's redo returns (and adds to
    ``peel.redo_rows``), on the scores path the evaluator's own redo."""
    val, dot_fn, score_fn = _forced_trip()
    ev = FullEvaluator(EvalConfig(top_k=[10, 100]), val, val.to_device(
        "cpu"), evaluator_name="val")
    before = trace.counter("peel.redo_rows")
    t0 = time.time_ns()
    evaluate_model(dot_fn if path == "dot" else score_fn, ev, batch_size=16)
    assert len(ev.redo_rows) == 2 and sum(ev.redo_rows) > 0
    flag = "host_wait.peel.flag" if path == "dot" else \
        "host_wait.evaluator.redo"
    assert len(_since(t0, {flag})) == 2
    assert trace.counter("peel.redo_rows") - before == (
        sum(ev.redo_rows) if path == "dot" else 0)


def test_preprocessing_stage_timings_come_from_their_spans():
    from sibrar_tpu_torch.preprocessing.pipeline import timed

    timings = {}
    t0 = time.time_ns()
    for _ in range(2):
        with timed(timings, "test_stage", torch.device("cpu")):
            time.sleep(0.001)
    spans = _since(t0, {"preprocess.test_stage"})
    assert len(spans) == 2
    assert timings == {"test_stage": sum((b - a) / 1e9
                                         for _, a, b in spans)}


# --------------------------------------------------------------- the card
@pytest.mark.card
def test_card_spans_share_the_profiler_clock(cuda):
    """Under a CUDA-only profiler session (as the benchmark opens one), a
    span around a kernel's launch encloses the runtime's launch record."""
    torch.cuda.synchronize()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.__enter__()
    time.sleep(2.0)
    spans = []
    for _ in range(5):
        with trace.span("test.launch") as s:
            torch.cuda._sleep(1000)
        spans.append((s.start, s.start + s.ns))
        time.sleep(0.005)
    torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    launches = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                      for e in prof.profiler.kineto_results.events()
                      if "LaunchKernel" in e.name())
    assert len(launches) == len(spans)
    for (a, b), (c, d) in zip(spans, launches):
        assert a - 50_000 <= c <= d <= b + 50_000, (a, b, c, d)


@pytest.mark.card
def test_card_host_reads_are_the_synchronizing_calls(cuda):
    """Over one SBNet step and one validation pass, ``host_reads`` counts
    every call that CUDA's sync debug mode reports as synchronizing."""
    trainer = _sbnet_trainer("cuda", n_users=2048, n_items=65536,
                             n_interactions=40000)
    idx = torch.arange(128, device="cuda")
    trainer.train_step(idx)
    trainer.validate()  # first calls build kernels and caches
    torch.cuda.synchronize()
    t0 = time.time_ns()
    got = []
    for run in (lambda: trainer.train_step(idx), trainer.validate):
        sites, running = [], []

        def show(message, *args, **kwargs):
            # while run() runs (entering the debug mode reports itself
            # once); the site is the innermost frames of the Python stack
            if running and "synchroniz" in str(message):
                sites.append(" < ".join(
                    f"{os.path.basename(f.filename)}:{f.lineno}"
                    for f in traceback.extract_stack()[-2:-6:-1]))

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            reads = trace.counter("host_reads")
            running.append(True)
            try:
                run()
            finally:
                running.clear()
                torch.cuda.set_sync_debug_mode(0)
        got.append((trace.counter("host_reads") - reads, len(sites),
                    sorted(set(sites))))
    assert all(reads == syncs for reads, syncs, _ in got), got
    assert _since(t0, {"host_wait.peel.flag"})  # the pass took the dot path
