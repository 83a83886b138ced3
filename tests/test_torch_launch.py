"""The port's launch path, on the CPU: `sibrar_tpu_torch.ops._cuda.launch`
against a fake kernel library (the build and the stream getter
monkeypatched), `use_kernel`'s dispatch rule, and the K15 / K16 wrappers,
which hand a CPU tensor to their plain versions and never to a launch."""
import numpy as np
import pytest
import torch

from sibrar_tpu_torch.ops import _cuda, gemm_probe, roll

STREAM = 0x5EED


class FakeLib:
    """Stands in for the ctypes library: each entry records its arguments
    and returns ``code``; lookups of entries are counted."""

    def __init__(self, code: int = 0):
        self.code = code
        self.looked_up: list = []
        self.calls: list = []

    def sibrar_error_string(self, code):
        return f"error text {code}".encode()

    def __getattr__(self, name):  # entries only: the rest are attributes
        self.looked_up.append(name)

        def entry(*args):
            self.calls.append((name, args))
            return self.code
        return entry


@pytest.fixture
def fake(monkeypatch):
    lib = FakeLib()
    monkeypatch.setattr(_cuda, "build", lambda: lib)
    monkeypatch.setattr(_cuda, "current_stream", lambda: STREAM)
    monkeypatch.setattr(_cuda, "_fns", {})
    return lib


def test_launch_passes_the_stream_last_and_resolves_once(fake):
    for i in range(3):
        _cuda.launch("sibrar_roll_lanes", 11, 12, 1, 256, 13 + i)
        _cuda.launch("sibrar_lane_slice", 21, 22, 1, 512, 128, 23)
    assert fake.calls[:2] == [
        ("sibrar_roll_lanes", (11, 12, 1, 256, 13, STREAM)),
        ("sibrar_lane_slice", (21, 22, 1, 512, 128, 23, STREAM))]
    assert len(fake.calls) == 6
    assert all(args[-1] == STREAM for _, args in fake.calls)
    assert sorted(fake.looked_up) == ["sibrar_lane_slice",
                                      "sibrar_roll_lanes"]


def test_launch_error_names_the_entry_and_its_text(fake):
    fake.code = 2
    with pytest.raises(RuntimeError, match=r"^sibrar_score_bf16: CUDA error "
                                           r"2 \(error text 2\)$"):
        _cuda.launch("sibrar_score_bf16", *range(8))
    assert fake.calls == [("sibrar_score_bf16", (*range(8), STREAM))]


def _no_launch(*args, **kwargs):
    raise AssertionError("a CPU tensor reached the kernel path")


def _draws(seed: int, *shape) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


I32 = dict(dtype=torch.int32)
WRAPPERS = {
    "score_bf16": (lambda: gemm_probe.score_bf16(_draws(0, 5, 12),
                                                 _draws(1, 256, 12)),
                   lambda: gemm_probe.score_bf16_plain(_draws(0, 5, 12),
                                                       _draws(1, 256, 12))),
    "roll_lanes": (lambda: roll.roll_lanes(_draws(2, 3, 200),
                                           torch.tensor([237], **I32)),
                   lambda: roll.roll_lanes_plain(_draws(2, 3, 200),
                                                 torch.tensor([237], **I32))),
    "lane_slice": (lambda: roll.lane_slice(_draws(3, 2, 300),
                                           torch.tensor([250], **I32)),
                   lambda: roll.lane_slice_plain(_draws(3, 2, 300),
                                                 torch.tensor([250], **I32))),
    "segment_roll": (lambda: roll.segment_roll(
        torch.arange(1000, **I32), torch.tensor([990, 0, 3], **I32), 300),
        lambda: roll.segment_roll_plain(
            torch.arange(1000, **I32), torch.tensor([990, 0, 3], **I32),
            300)),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_cpu_tensors_never_reach_a_launch(name, monkeypatch):
    for attr in ("launch", "query", "build"):
        monkeypatch.setattr(_cuda, attr, _no_launch)
    fn = gemm_probe.score_bf16 if name == "score_bf16" else getattr(roll,
                                                                    name)
    before = fn.launches
    run, plain = WRAPPERS[name]
    got, want = run(), plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    assert fn.launches == before


@pytest.mark.parametrize("tensors,error", [
    ((torch.zeros(2), torch.zeros(1, dtype=torch.int32)), None),
    ((torch.zeros(2, device="meta"),), "no kernel or plain version for "
                                       "device meta"),
    ((torch.zeros(2), torch.zeros(2, device="meta")), "different devices"),
], ids=["cpu", "meta", "mixed"])
def test_use_kernel_takes_cpu_and_refuses_other_devices(tensors, error):
    if error is None:
        assert _cuda.use_kernel(*tensors) is False
        return
    with pytest.raises(ValueError, match=error):
        _cuda.use_kernel(*tensors)
