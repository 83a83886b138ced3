"""The readers of the program's spans and counters on hand-built records:
which units count (outside the slice), events placed by the snapshot's
anchor, and None where the program has no recorder or its ring dropped
events inside the window."""
import sys

import pytest

from harness import catalog, program_trace

NS0, PERF0 = 1_800_000_000_000_000_000, 100.0  # the anchor pair


def ns(perf: float) -> int:
    """A ``time.time_ns()`` stamp at ``perf`` on the benchmark's clock."""
    return NS0 + round((perf - PERF0) * 1e9)


def span(name, a, b):
    return (name, ns(a), ns(b))


def snap(events, counters=(), dropped=0):
    return {"events": events, "counters": {c: 0 for c in counters},
            "dropped": dropped, "anchor": (NS0, PERF0)}


# three train steps of 10 ms from perf 50.0; the second in the slice
UNITS = [("train_step", 50.00, 50.01, False),
         ("train_step", 50.02, 50.03, True),
         ("train_step", 50.04, 50.05, False)]
STEPS = [span("trainer.draw_batch", 50.001, 50.002),
         span("trainer.train_step", 50.0005, 50.0095),
         span("host_wait.sbnet.routing", 50.003, 50.0031),
         ("peel.redo_rows", ns(50.003), 2),
         # inside the slice: left out
         span("trainer.draw_batch", 50.021, 50.025),
         ("peel.redo_rows", ns(50.022), 7),
         # between units: left out
         span("trainer.draw_batch", 50.0301, 50.0399),
         span("trainer.draw_batch", 50.041, 50.044),
         span("trainer.train_step", 50.0405, 50.0495)]


def test_only_the_units_outside_the_slice_count():
    got = program_trace.in_units({"spans": UNITS}, "train_step",
                                 snap(STEPS, ["peel.redo_rows"]))
    assert got["units"] == 2
    assert got["spans"] == {"trainer.draw_batch": 2, "trainer.train_step": 2,
                            "host_wait.sbnet.routing": 1}
    assert got["seconds"]["trainer.draw_batch"] == pytest.approx(0.004)
    assert got["counts"] == {"peel.redo_rows": 2}


def test_a_span_belongs_to_the_unit_of_its_midpoint():
    # starts 1 us before the unit (a clock's slack), ends inside it
    events = [span("trainer.forward", 49.999999, 50.005)]
    got = program_trace.span_ms({"spans": UNITS}, "train_step",
                                "trainer.forward", snap=snap(events))
    assert got == pytest.approx(1e3 * 0.005001 / 2)


def test_the_anchor_places_the_events():
    # the same events under another anchor pair: shifted by 5 ms
    moved = snap(STEPS, ["peel.redo_rows"])
    moved["anchor"] = (NS0 + 5_000_000, PERF0)
    got = program_trace.in_units({"spans": UNITS}, "train_step", moved)
    # draw 1 (50.001-50.002) now sits at 49.996-49.997: outside unit 1;
    # draw 5 (50.041-50.044) at 50.036-50.039: outside unit 3
    assert "trainer.draw_batch" not in got["spans"]


def test_a_ring_that_dropped_events_inside_the_window_reads_none():
    record = {"spans": UNITS}
    inside = snap(STEPS, dropped=10)
    assert program_trace.in_units(record, "train_step", inside) is None
    assert program_trace.spans_per(record, "train_step", "host_wait",
                                   "trainer.train_step", snap=inside) is None
    # dropped before the window: its events are whole
    early = snap([span("x", 40.0, 40.1)] + STEPS, dropped=10)
    assert program_trace.in_units(record, "train_step", early)["units"] == 2


def test_counts_read_zero_where_the_program_spans_are_there():
    record = {"spans": UNITS}
    steps = [e for e in STEPS if not e[0].startswith("host_wait")]
    assert program_trace.spans_per(record, "train_step", "host_wait",
                                   "trainer.train_step",
                                   snap=snap(steps)) == 0
    # no program span in the units: nothing found
    assert program_trace.spans_per(record, "train_step", "host_wait",
                                   "trainer.train_step",
                                   snap=snap([])) is None
    assert program_trace.in_units({"spans": []}, "train_step",
                                  snap(STEPS)) is None


# two validation passes of 3 batches, both outside the slice
PASSES = [("validate", 60.0, 60.5, False), ("validate", 61.0, 61.5, False)]
# seconds into the batch: the flag read and a copy inside the rank, a copy
# inside the metrics
BATCH = [("host_wait.peel.flag", 0.02, 0.05),
         ("host_wait.peel.flat_mask", 0.06, 0.07),
         ("evaluator.rank", 0.0, 0.1),
         ("host_wait.metrics.coverage", 0.105, 0.11),
         ("evaluator.metrics", 0.1, 0.12)]
NEW = ["draw_ms_per_step.train", "forward_ms_per_step.train",
       "backward_ms_per_step.train", "optimizer_ms_per_step.train",
       "host_reads_per_step.train", "rank_host_ms_per_batch.val",
       "flag_wait_ms_per_batch.val", "metrics_host_ms_per_batch.val",
       "results_ms_per_pass.val", "host_reads_per_batch.val"]


def _passes():
    events = []
    for start in (60.0, 61.0):
        for b in range(3):
            t = start + 0.15 * b
            events += [span(n, t + a, t + z) for n, a, z in BATCH]
        events.append(span("host_wait.evaluator.results", start + 0.47,
                           start + 0.48))
        events.append(span("evaluator.get_results", start + 0.46,
                           start + 0.49))
    return snap(events)


@pytest.mark.parametrize("metric, want", [
    # 100 ms less the 30 ms flag read and the 10 ms copy inside it; the
    # metrics' copy is not the rank's
    ("rank_host_ms_per_batch.val", 60.0),
    ("flag_wait_ms_per_batch.val", 30.0),
    ("metrics_host_ms_per_batch.val", 20.0),
    ("results_ms_per_pass.val", 30.0),
    ("host_reads_per_batch.val", 10 / 3),
])
def test_the_validation_readers(monkeypatch, metric, want):
    monkeypatch.setattr(program_trace, "snapshot", _passes)
    record = {"spans": PASSES, "batches_per_pass": 3}
    assert catalog.metric_reader(metric)(record) == pytest.approx(want)
    # a training record has no batches
    assert catalog.metric_reader(metric)({"spans": PASSES}) is None or (
        metric == "results_ms_per_pass.val")


@pytest.mark.parametrize("metric, want", [
    ("draw_ms_per_step.train", 2.0),
    ("forward_ms_per_step.train", 3.0),
    ("backward_ms_per_step.train", 1.5),
    ("optimizer_ms_per_step.train", 0.5),
    ("host_reads_per_step.train", 2.5),
])
def test_the_training_readers(monkeypatch, metric, want):
    events = []
    for start in (50.00, 50.04):  # the two steps outside the slice
        events += [span("trainer.draw_batch", start + 0.001, start + 0.003),
                   span("trainer.forward", start + 0.003, start + 0.006),
                   span("trainer.backward", start + 0.006, start + 0.0075),
                   span("trainer.optimizer_step", start + 0.0075,
                        start + 0.008),
                   span("trainer.train_step", start + 0.0005,
                        start + 0.0085),
                   ("peel.redo_rows", ns(start + 0.004), 9)]
        events += [span("host_wait.sbnet.routing", start + 0.004 + 1e-4 * j,
                        start + 0.00405 + 1e-4 * j)
                   for j in range(2 if start < 50.01 else 3)]
    monkeypatch.setattr(program_trace, "snapshot",
                        lambda: snap(events, ["peel.redo_rows"]))
    assert catalog.metric_reader(metric)({"spans": UNITS}) == pytest.approx(
        want)


@pytest.mark.parametrize("metric", NEW)
def test_no_recorder_reads_none(monkeypatch, metric):
    """A program without the recorder (an older checkout) gives nothing to
    read, and no reader raises."""
    monkeypatch.setattr(program_trace, "snapshot", lambda: None)
    record = {"spans": UNITS + PASSES, "batches_per_pass": 3}
    assert catalog.metric_reader(metric)(record) is None


def test_the_new_metrics_are_in_the_benchmark():
    names = [m["name"] for m in catalog.benchmark()["per_layer"]]
    assert names[-len(NEW):] == NEW


def test_a_program_without_the_recorder_gives_no_snapshot(monkeypatch):
    import sibrar_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "sibrar_tpu_torch.utils.trace", None)
    assert program_trace.snapshot() is None
