"""The yardstick's operation and byte counts on hand-worked shapes, and the
readers that turn them into shares."""
import pytest
import torch

from harness import catalog, peaks, run_cell
from harness.trace import MARKER, Tracer, read_profile, slice_flops


def test_k5_counts():
    # dw [3, 4] = vec [2, 3].T @ g [2, 4]: 2 * 2 * 3 * 4 operations; bytes
    # 4 * (2 * 3 + 2 * 4 + 3 * 4)
    assert peaks.dw_matmul(2, 3, 4) == (48.0, 104)


def test_k2_counts():
    # scores [2, 256] from u [2, 8] and items [256, 8], maxima [2, 2]
    assert peaks.score_wmax(2, 256, 8) == (
        2.0 * 2 * 256 * 8, 4 * (16 + 2048 + 512 + 4))


def test_bound_takes_the_larger():
    assert peaks.bound_s(67e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(67e12, 6.7e12) == pytest.approx(2.0)


def test_layer_counts():
    assert peaks.linear_flops(10, 3, 5, train=False, input_grad=False) == 300
    assert peaks.linear_flops(10, 3, 5, train=True, input_grad=False) == 600
    assert peaks.linear_flops(10, 3, 5, train=True, input_grad=True) == 900
    assert peaks.sparse_first_layer_flops(7, 4, train=True) == 112
    assert peaks.sparse_first_layer_flops(7, 4, train=False) == 56


class _Tower(torch.nn.Module):
    """An interaction layer as the program's: ``csr`` rows, a ``kernel``."""

    def __init__(self):
        super().__init__()

        class Csr:
            indptr = torch.tensor([0, 2, 5, 5])  # rows of 2, 3 and 0

        self.csr = Csr()
        self.kernel = torch.nn.Parameter(torch.zeros(6, 4))

    def forward(self, idxs):
        return self.kernel[:idxs.numel()].sum() + idxs.float()


def test_traced_shapes_give_the_hand_count():
    """Hooks count a dense layer fed an input without a gradient (forward
    and weight gradient) and a tower's live entries, as worked out by hand:
    Linear(3, 5) on 10 rows in training, 600; rows 0 and 1 of the tower, 5
    live entries of width 4 in training, 80."""
    lin, tower = torch.nn.Linear(3, 5), _Tower()
    model = torch.nn.ModuleDict({"lin": lin, "tower": tower}).train()
    tr = Tracer(True, model)
    tr._hook()
    try:
        lin(torch.zeros(10, 3))
        tower(torch.tensor([0, 1]))
    finally:
        tr._unhook()
    assert slice_flops(tr._calls) == 600 + 80


def _record(flops=0.0, window=1.0, busy=0.5, by_name=None, count=None,
            dw_calls=(), units=2):
    return {"slice": {"flops": flops, "window_s": window, "busy_s": busy,
                      "by_name": by_name or {}, "count": count or {},
                      "dw_calls": list(dw_calls), "units": units},
            "memory_window_peak_bytes": 2 ** 31, "spans": [],
            "score_shape": (1024, 100352, 256), "users_per_pass": 50000,
            "batches_per_pass": 49}


def _read(name, record):
    return catalog.metric_reader(name)(record)


def test_mfu_readers():
    assert _read("mfu.train", _record(flops=33.5e12)) == pytest.approx(50.0)
    # 2 U C D a pass, 2 passes, over 10 s: 2 * 50000 * 100352 * 256 * 2 /
    # 10 / 67e12
    want = 100 * 2 * 50000 * 100352 * 256 * 2 / 10 / 67e12
    assert _read("mfu.val", _record(window=10.0)) == pytest.approx(want)


def test_roofline_readers():
    k5 = "void (anonymous namespace)::dw_matmul_kernel<true>(float const*)"
    calls = [(512, 100352, 256), (2253, 50000, 512)]
    bound = sum(peaks.bound_s(*peaks.dw_matmul(*c)) for c in calls)
    rec = _record(by_name={k5: 2 * bound}, count={k5: 2}, dw_calls=calls)
    assert _read("dw_matmul_roofline", rec) == pytest.approx(50.0)
    rec["slice"]["count"][k5] = 3  # a launch without its shape
    assert _read("dw_matmul_roofline", rec) is None
    k2 = "(anonymous namespace)::score_wmax_kernel(float const*, int)"
    k12 = "void fused_score_wmax_kernel<true>(float const*)"
    # 50,000 users a pass: 48 batches of 1,024 and one of 848, two passes
    one = peaks.bound_s(*peaks.score_wmax(1024, 100352, 256))
    last = peaks.bound_s(*peaks.score_wmax(848, 100352, 256))
    rec = _record(by_name={k2: 2 * (48 * one + last) / 0.625, k12: 1.0},
                  count={k2: 98, k12: 5})
    assert _read("score_wmax_roofline", rec) == pytest.approx(62.5)
    rec["slice"]["count"][k2] = 99  # a launch that is not a pass's batch
    assert _read("score_wmax_roofline", rec) is None


def test_device_readers():
    rec = _record(window=2.0, busy=0.5)
    assert _read("device_idle.train", rec) == pytest.approx(75.0)
    assert _read("peak_mem_gib.val", rec) == pytest.approx(2.0)
    names = ["segment_gather_kernel(int const*)", "peel_values_kernel(x)",
             "score_wmax_kernel(y)"]
    rec = _record(by_name=dict(zip(names, [0.098, 0.098, 5.0])),
                  count=dict(zip(names, [1, 1, 1])))
    # 0.196 s over 2 passes of 49 batches
    assert _read("select_ms_per_batch.val", rec) == pytest.approx(2.0)
    assert _read("device_idle.val", {"slice": None}) is None


def test_host_span_reader():
    rec = _record()
    rec["spans"] = [("train_step", 0.0, 0.010, False),
                    ("train_step", 1.0, 1.030, False),
                    ("train_step", 2.0, 2.5, True)]
    assert _read("host_ms_per_step.train", rec) == pytest.approx(20.0)
    assert _read("host_pairs_per_s.train", rec) is None  # no work a unit
    rec["work_per_unit"] = 512
    # two steps of 512 pairs in 10 + 30 ms of host
    assert _read("host_pairs_per_s.train", rec) == pytest.approx(25600.0)


class _Event:
    """A raw profiler record: name, device type, start and duration (ns)."""

    def __init__(self, name, cuda, start_us, dur_us):
        self._v = (name, cuda, int(start_us * 1e3), int(dur_us * 1e3))

    def name(self):
        return self._v[0]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[1]
                else torch.autograd.DeviceType.CPU)

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]


def _profile(events):
    class Results:
        def events(self):
            return events

    class Autograd:
        kineto_results = Results()

    class Prof:
        profiler = Autograd()

    return Prof()


def test_a_trace_read_by_hand():
    """Markers at 0-10 and 100-110 us bound the window; kernels at 20-40,
    30-50 (overlapping) and 70-80 us are 40 us busy of 110; a copy counts
    as busy, not as a kernel; the longest gap runs from the copy's end to
    the end marker's (85-110 us), after the fourth launch's runtime call. Three launches for the kernels and two for
    the markers: complete. One fewer kernel: not."""
    launch = "cudaLaunchKernel"
    events = [_Event(MARKER, True, 0, 10), _Event("k_a", True, 20, 20),
              _Event("k_b", True, 30, 20), _Event("Memcpy HtoD", True, 80, 5),
              _Event("k_a", True, 70, 10), _Event(MARKER, True, 100, 10)]
    host = [_Event(launch, False, t, 2) for t in (0, 15, 25, 60, 90)]
    got = read_profile(_profile(events + host), 3, [], [])
    assert got["complete"] and got["launched"] == 5
    assert got["kernels"] == 3 and got["markers"] == 2
    assert got["window_s"] == pytest.approx(110e-6)
    assert got["busy_s"] == pytest.approx(45e-6)
    assert got["by_name"]["k_a"] == pytest.approx(30e-6)
    assert got["count"] == {"k_a": 2, "k_b": 1, "Memcpy HtoD": 1}
    assert got["gaps"][0] == [f"host code after {launch}",
                              pytest.approx(25e-6)]
    lean = read_profile(_profile(events + host), 3, [], [], detail=False)
    for k in ("complete", "launched", "kernels", "markers", "window_s",
              "busy_s"):
        assert lean[k] == got[k]
    assert lean["by_name"] == {} and lean["gaps"] == []
    lost = read_profile(_profile(events[:2] + events[3:] + host), 3, [], [])
    assert not lost["complete"]


def test_device_time_a_unit():
    win = {"units": 4, "device": {"complete": True, "busy_s": 0.046,
                                  "kernels": 9, "markers": 2,
                                  "launched": 11}}
    assert run_cell.device_ms_per_unit(win) == pytest.approx(11.5)
    assert run_cell.device_ms_per_unit({"units": 4}) is None
    win["device"]["complete"] = False
    with pytest.raises(RuntimeError, match="lost kernels"):
        run_cell.device_ms_per_unit(win)


def test_a_reader_with_nothing_to_read_returns_none():
    empty = {"slice": None, "spans": [], "memory_window_peak_bytes": 0}
    for m in catalog.benchmark()["per_layer"]:
        assert _read(m["name"], empty) is None, m["name"]
