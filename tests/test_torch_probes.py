"""Parity of the port's probe kernels with the JAX package's ``tools/``
probes, on the CPU: the plain versions of K14 (the six f32 epilogues of the
score GEMM), K15 (its one-pass bf16 spelling), K16 (lane moves by a device
offset), K17 (the masked fill) and K11 at the probe's shapes, against the
Pallas kernels the probes build.

Each JAX probe is loaded from its file, with the JAX package's persistent
compilation cache switched off, and run as it stands: ``pl.pallas_call``
passes ``interpret=True`` and records its outputs, ``jax.jit`` is the
identity, and the bisect's trace and trace parser are stubbed. Its inputs
are seeded numpy draws, which the port draws again the same way.

Tolerances: f32 scores within the f32 summation bound ``D 2^-24 (|u|
@ |items|^T)`` of JAX's; maxima equal to the maxima of the same side's
scores; bf16 scores (the port rounds, the JAX interpret run here computes
f32) within ``2^-7 (|u| @ |items|^T)``; lane moves, masks and the winner
recovery bit for bit. The ports' CLIs run with ``--device cpu``."""
import contextlib
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import sibrar_tpu.utils.cache as jax_cache
from sibrar_tpu.ops import pallas_peel as jpeel
from sibrar_tpu_torch.ops import gemm_probe, peel, roll
from sibrar_tpu_torch.ops import mask as mask_ops
from sibrar_tpu_torch.tools import (
    _common,
    probe_gemm_bisect,
    probe_gemm_precision,
    probe_gemm_variants,
    probe_pred_input,
    probe_roll,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C_SMALL = 2048  # catalog of the GEMM probes here (theirs: 501,760)
B, D = _common.B, _common.D


def _jax_probe(name: str, monkeypatch):
    """``tools/<name>.py`` as a fresh module, its compilation cache off."""
    monkeypatch.setattr(jax_cache, "enable_compilation_cache",
                        lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def pallas_outputs(monkeypatch):
    """Every ``pl.pallas_call`` runs in interpret mode and appends its
    outputs (as numpy) to the returned list; ``jax.jit`` is the identity."""
    real = pl.pallas_call
    recorded = []

    def interpret_call(*args, **kwargs):
        kernel = real(*args, **{**kwargs, "interpret": True})

        def call(*operands):
            out = kernel(*operands)
            recorded.append(jax.tree.map(np.asarray, out))
            return out
        return call

    monkeypatch.setattr(pl, "pallas_call", interpret_call)
    monkeypatch.setattr(jax, "jit",
                        lambda f=None, **kw: f if f is not None else
                        (lambda g: g))
    return recorded


def _run_jax_gemm_probe(name, mode, monkeypatch, capsys, outputs):
    """Run JAX ``tools/<name>.py MODE 2048 1``; returns its first kernel
    call's outputs as a tuple and its JSON line."""
    module = _jax_probe(name, monkeypatch)
    if name == "probe_gemm_bisect":
        monkeypatch.setattr(module, "device_op_ms", lambda *a: {})
        monkeypatch.setattr(jax.profiler, "trace",
                            lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(sys, "argv", [name, mode, str(C_SMALL), "1"])
    module.main()
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    out = outputs[0]
    return (tuple(out) if isinstance(out, (list, tuple)) else (out,)), record


def _f32_bound(u, items):
    """The f32 summation bound of each score: D 2^-24 (|u| @ |items|^T)."""
    return D * 2.0 ** -24 * (np.abs(u).astype(np.float64)
                             @ np.abs(items).astype(np.float64).T)


def _lanes(variant, wmax):
    """A variant's maxima as [B, C/128]."""
    if variant == "wmax_lanes":
        return wmax
    return wmax.reshape(-1, wmax.shape[-1]).T  # [C/128, B] or [C/1024, 8, B]


def _window_max(scores):
    return scores.reshape(scores.shape[0], -1, 128).max(-1)


def _hold_variant(variant, jax_out, port_out, u, items, bound):
    """Shapes equal; scores within ``bound``; each side's maxima those of
    its own scores (or, without scores, of the port's f32 plain scores)."""
    port_out = tuple(t.numpy() for t in port_out)
    assert [a.shape for a in jax_out] == [a.shape for a in port_out]
    has_scores = variant != "noscores"
    if has_scores:
        assert np.all(np.abs(jax_out[0] - port_out[0]) <= bound)
    if variant == "nowmax":
        return
    j_max, p_max = _lanes(variant, jax_out[-1]), _lanes(variant, port_out[-1])
    if has_scores:
        np.testing.assert_array_equal(j_max, _window_max(jax_out[0]))
        np.testing.assert_array_equal(p_max, _window_max(port_out[0]))
    else:
        own = gemm_probe.score_full(torch.from_numpy(u),
                                    torch.from_numpy(items))[0].numpy()
        np.testing.assert_array_equal(p_max, _window_max(own))
    assert np.all(np.abs(j_max - p_max) <= _window_max(bound))


def _inputs():
    return [t.numpy() for t in _common.inputs(C_SMALL, "cpu")]


def _hold_f32_probe(probe, mode, variant, monkeypatch, capsys, outputs,
                    **run_kw):
    """JAX ``probe`` in ``mode`` against the port's K14 ``variant``
    (plain); the port's record for the mode has the JAX probe's keys."""
    jax_out, record = _run_jax_gemm_probe(probe.__name__.rsplit(".")[-1],
                                          mode, monkeypatch, capsys, outputs)
    u, items = _inputs()
    tu, titems = torch.from_numpy(u), torch.from_numpy(items)
    _hold_variant(variant, jax_out, gemm_probe.VARIANTS[variant](tu, titems),
                  u, items, _f32_bound(u, items))
    port_record = probe.run(mode, tu, titems, **run_kw)
    assert set(record) <= set(port_record)
    assert (port_record["mode"], port_record["C"]) == (mode, C_SMALL)


@pytest.mark.parametrize("mode", [m for m in probe_gemm_bisect.MODES
                                  if m != "xla"])
def test_bisect_variant_matches_jax(mode, monkeypatch, capsys,
                                    pallas_outputs):
    _hold_f32_probe(probe_gemm_bisect, mode, mode, monkeypatch, capsys,
                    pallas_outputs)


@pytest.mark.parametrize("mode", [m for m in probe_gemm_variants.MODES
                                  if m != "xla"])
def test_variants_mode_matches_jax(mode, monkeypatch, capsys,
                                   pallas_outputs):
    _hold_f32_probe(probe_gemm_variants, mode, mode, monkeypatch, capsys,
                    pallas_outputs, iters=1)


@pytest.mark.parametrize("mode", ["highest", "asis"])
def test_precision_f32_mode_matches_jax(mode, monkeypatch, capsys,
                                        pallas_outputs):
    """``highest`` and ``asis`` are K14 ``full`` in the port."""
    _hold_f32_probe(probe_gemm_precision, mode, "full", monkeypatch, capsys,
                    pallas_outputs, iters=1)


def test_bf16_default_precision_rounds(monkeypatch, capsys, pallas_outputs):
    """``default``: JAX's interpret run computes f32 here; the port's bf16
    plain version stays within the bf16 rounding bound of it, differs from
    the f32 product somewhere, and its maxima are its own scores'."""
    (j_scores, j_wmax_t), record = _run_jax_gemm_probe(
        "probe_gemm_precision", "default", monkeypatch, capsys,
        pallas_outputs)
    u, items = _inputs()
    tu, titems = torch.from_numpy(u), torch.from_numpy(items)
    scores, wmax_t = (t.numpy() for t in gemm_probe.score_bf16(tu, titems))
    assert scores.shape == j_scores.shape and wmax_t.shape == j_wmax_t.shape
    mag = np.abs(u).astype(np.float64) @ np.abs(items).astype(np.float64).T
    assert np.all(np.abs(scores - j_scores) <= 2.0 ** -7 * mag)
    assert not np.array_equal(scores, gemm_probe.score_full(tu, titems)[0])
    np.testing.assert_array_equal(wmax_t.T, _window_max(scores))
    port = probe_gemm_precision.run("default", tu, titems, iters=1)
    assert set(record) <= set(port) and port["rel_vs_xla_slice"] > 1e-4


# f32 values whose bf16 rounding is an edge: ties in both directions, just
# off a tie, subnormals that stay, round up to the smallest normal or vanish,
# overflow to -inf, +-inf, NaN and signed zeros
ROUNDING_EDGES = np.array(
    [1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -(1.0 + 2.0 ** -8),
     1.0 + 2.0 ** -8 + 2.0 ** -20, 2.0 ** -130, 3 * 2.0 ** -134,
     2.0 ** -126 - 2.0 ** -149, -(2.0 ** -140), 2.0 ** -149, 2.0 ** -135,
     np.inf, -np.inf, np.nan, 0.0, -0.0, 3.0e38, -3.4e38], np.float32)


def _jax_bf16(x: np.ndarray) -> np.ndarray:
    """JAX's rounding to bf16, back in f32."""
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def test_bf16_plain_rounds_as_jax():
    """``score_bf16_plain`` rounds as JAX's ``astype(jnp.bfloat16)``: on the
    rounding edges as values bit for bit, NaN in the same places (the two
    give NaN different payloads), and through the product with one-hot
    users (every row 1.0 at depth d0, the edges at d0 of the items, finite
    elsewhere), whose scores are the rounded d0 column (zeros by value, NaN
    by place)."""
    want = _jax_bf16(ROUNDING_EDGES)
    got = torch.from_numpy(ROUNDING_EDGES).bfloat16().float().numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))
    b, c, d, d0 = 5, 128, 20, 13
    items = np.random.default_rng(4).normal(size=(c, d)).astype(np.float32)
    n = ROUNDING_EDGES.size
    items[:n, d0] = ROUNDING_EDGES
    items[c - n:, d0] = ROUNDING_EDGES[::-1]
    u = np.zeros((b, d), np.float32)
    u[:, d0] = 1.0
    scores, wmax_t = (t.numpy() for t in gemm_probe.score_bf16_plain(
        torch.from_numpy(u), torch.from_numpy(items)))
    np.testing.assert_array_equal(
        scores, np.broadcast_to(_jax_bf16(items[:, d0]), (b, c)))
    np.testing.assert_array_equal(wmax_t.T, _window_max(scores))


@pytest.mark.parametrize("b,d", [(1, 4), (37, 20), (65, 100), (63, 260)])
def test_bf16_plain_off_the_tiles_within_bound(b, d):
    """At ragged B and D (D % 4 == 0, not a multiple of 16) the plain scores
    lie within ``D 2^-24 (|u~| @ |i~|^T)`` of a float64 product of JAX's
    rounded operands u~, i~; the maxima are those of the scores."""
    rng = np.random.default_rng(b * 1000 + d)
    u = rng.normal(size=(b, d)).astype(np.float32)
    items = rng.normal(size=(384, d)).astype(np.float32)
    ub, ib = (_jax_bf16(x).astype(np.float64) for x in (u, items))
    scores, wmax_t = (t.numpy() for t in gemm_probe.score_bf16_plain(
        torch.from_numpy(u), torch.from_numpy(items)))
    bound = d * 2.0 ** -24 * (np.abs(ub) @ np.abs(ib).T)
    assert scores.shape == (b, 384) and wmax_t.shape == (3, b)
    assert np.all(np.abs(scores - ub @ ib.T) <= bound)
    np.testing.assert_array_equal(wmax_t.T, _window_max(scores))


@pytest.mark.parametrize("b,d", [(1, 4), (37, 20), (63, 260)])
def test_bf16_plain_within_half_an_ulp(b, d):
    """``score_bf16_plain`` is the float64 product of JAX's rounded operands
    rounded to f32 once: within half an ulp of numpy's float64 product,
    plus the float64 sums' own ``D 2^-53 (|u~| @ |i~|^T)``."""
    rng = np.random.default_rng(b + 10 * d)
    u = rng.normal(size=(b, d)).astype(np.float32)
    items = rng.normal(size=(384, d)).astype(np.float32)
    ub, ib = (_jax_bf16(x).astype(np.float64) for x in (u, items))
    scores = gemm_probe.score_bf16_plain(torch.from_numpy(u),
                                         torch.from_numpy(items))[0].numpy()
    exact = ub @ ib.T
    sums = d * 2.0 ** -53 * (np.abs(ub) @ np.abs(ib).T)
    assert np.all(np.abs(scores - exact)
                  <= 0.5 * np.spacing(np.abs(scores)) + sums)


@pytest.mark.parametrize("d", [4, 256])
def test_bf16_plain_is_the_nearest_reference(d):
    """The queue 3 fault of the old plain version (the f32 product of the
    rounded operands): it is not the f32 value nearest the exact product,
    and at D = 256 it lies farther from it than JAX's CPU bf16 dot, in the
    largest and the mean error (at D = 4 the two agree on all but a few
    scores). The new one is the nearest f32 value at every score, so never
    farther than either."""
    rng = np.random.default_rng(d)
    u = rng.normal(size=(64, d)).astype(np.float32)
    items = rng.normal(size=(1024, d)).astype(np.float32)
    tu, ti = torch.from_numpy(u), torch.from_numpy(items)
    exact = tu.bfloat16().double() @ ti.bfloat16().double().T
    old = (tu.bfloat16().float() @ ti.bfloat16().float().T).double()
    jax_dot = torch.from_numpy(np.array(jax.lax.dot_general(
        jnp.asarray(u).astype(jnp.bfloat16),
        jnp.asarray(items).astype(jnp.bfloat16), (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32))).double()
    new = gemm_probe.score_bf16_plain(tu, ti)[0].double()
    err = {name: (x - exact).abs() for name, x in
           (("old", old), ("jax", jax_dot), ("new", new))}
    assert bool((err["new"] <= err["old"]).all())
    assert bool((err["new"] <= err["jax"]).all())
    assert bool((err["new"] < err["old"]).any())
    if d == 256:
        assert err["old"].max() > err["jax"].max()
        assert err["old"].mean() > err["jax"].mean()


@pytest.mark.parametrize("b,d", [(1, 4), (65, 100), (63, 260)])
def test_bf16_bound_check_holds_plain_and_catches_a_step(b, d):
    """``_common.bf16_within``, the card checks' hold on K15 (within ``D
    2^-24 (|u~| @ |i~|^T)`` of the rounded operands' exact product, over
    chunks of users): the plain version's f32 scores and maxima pass at
    ragged B and D; a score, or a window maximum, twice its bound off the
    exact value raises."""
    rng = np.random.default_rng(7 * b + d)
    u = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    items = torch.from_numpy(rng.normal(size=(384, d)).astype(np.float32))
    scores, wmax_t = gemm_probe.score_bf16_plain(u, items)
    err, ratio = _common.bf16_within("plain", scores, wmax_t, u, items,
                                     rows=32)
    assert 0.0 <= ratio <= 1.0 and err >= 0.0
    ub, ib = u.bfloat16().double(), items.bfloat16().double()
    exact = ub @ ib.T
    tol = d * 2.0 ** -24 * (ub.abs() @ ib.abs().T)
    bad = scores.clone()
    bad[b - 1, 200] = float(exact[b - 1, 200] + 2 * tol[b - 1, 200])
    with pytest.raises(AssertionError, match="past D 2"):
        _common.bf16_within("bad score", bad, wmax_t, u, items, rows=32)
    bad_w = wmax_t.clone()
    bad_w[1, b - 1] = float(exact[b - 1, 128:256].max()
                            + 2 * tol[b - 1, 128:256].max())
    with pytest.raises(AssertionError, match="past D 2"):
        _common.bf16_within("bad max", scores, bad_w, u, items, rows=32)


@pytest.mark.parametrize("which", ["roll", "unaligned", "segment"])
def test_roll_probe_matches_jax(which, monkeypatch, pallas_outputs):
    module = _jax_probe("probe_roll", monkeypatch)
    assert getattr(module, f"probe_{which}")()
    want = pallas_outputs[0]
    if which == "roll":
        got = roll.roll_lanes(torch.arange(256.0).reshape(1, 256),
                              torch.tensor([37], dtype=torch.int32))
    elif which == "unaligned":
        got = roll.lane_slice(torch.arange(512.0).reshape(1, 512),
                              torch.tensor([37], dtype=torch.int32))
    else:
        got = roll.segment_roll(
            torch.arange(probe_roll.SEGMENT_N, dtype=torch.int32),
            torch.tensor(probe_roll.SEGMENT_STARTS, dtype=torch.int32),
            probe_roll.SEGMENT_LEN)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert probe_roll.PROBES[which]("cpu")


@pytest.mark.parametrize("width,shift", [(200, 37), (200, 237), (200, -5),
                                         (200, 400), (7, 3)])
def test_roll_lanes_any_width(width, shift):
    """Right at widths the TPU's roll gets wrong and at shifts >= n."""
    x = np.random.default_rng(width).normal(size=(3, width)).astype(np.float32)
    got = roll.roll_lanes(torch.from_numpy(x),
                          torch.tensor([shift], dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), np.roll(x, -shift, axis=1))


def test_slices_past_the_end_read_zero():
    x = np.arange(2 * 300, dtype=np.int32).reshape(2, 300)
    got = roll.lane_slice(torch.from_numpy(x),
                          torch.tensor([250], dtype=torch.int32)).numpy()
    want = np.zeros((2, 128), np.int32)
    want[:, :50] = x[:, 250:]
    np.testing.assert_array_equal(got, want)
    flat = np.arange(1000, dtype=np.int32)
    got = roll.segment_roll(torch.from_numpy(flat),
                            torch.tensor([990, 0, 3], dtype=torch.int32),
                            300).numpy()
    want = np.zeros((3, 300), np.int32)
    want[0, :10] = flat[990:]
    want[1], want[2] = flat[:300], flat[3:303]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype_name", ["bool", "int8"])
def test_mask_probe_matches_jax(dtype_name, monkeypatch, capsys,
                                pallas_outputs):
    module = _jax_probe("probe_pred_input", monkeypatch)
    module.try_mask(dtype_name)
    assert "exact=True" in capsys.readouterr().out
    x, _, d = probe_pred_input.mask_inputs(dtype_name, 16, "cpu")
    assert d.dtype == (torch.bool if dtype_name == "bool" else torch.int8)
    got = mask_ops.mask_where(d, x)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  pallas_outputs[0].view(np.int32))
    if dtype_name == "int8":  # any non-zero byte masks
        assert torch.equal(mask_ops.mask_where(d * -3, x), got)
    assert probe_pred_input.try_mask(dtype_name, device="cpu")


def test_recover_probe_matches_jax():
    """K11's plain version on the probe's draws at b = 1,024, m = 168, kk =
    100 against JAX ``recover_winners`` (interpret)."""
    g, widx, slots, v = probe_pred_input.recover_inputs("cpu")
    want = jpeel.recover_winners(*(jnp.asarray(t.numpy())
                                   for t in (g, widx, slots, v)),
                                 interpret=True)
    got = peel.recover_winners_plain(g, widx, slots, v)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (got[1] >= 1).all()  # every winner was planted from its row


CLI_CASES = [
    (probe_gemm_variants, ["nowmax", str(C_SMALL), "1"], {"mode", "C", "ms"}),
    (probe_gemm_bisect, ["wmax_T", str(C_SMALL)],
     {"mode", "C", "ms", "device_ops_ms_per_it"}),
    (probe_gemm_precision, ["default", str(C_SMALL), "1"],
     {"mode", "C", "ms", "rel_vs_xla_slice"}),
    (probe_roll, ["segment"], {"probe", "ok"}),
    (probe_pred_input, ["all"], None),
]


@pytest.mark.parametrize("module,argv,keys", CLI_CASES,
                         ids=[c[0].__name__.split(".")[-1] for c in CLI_CASES])
def test_probe_cli_on_cpu(module, argv, keys, capsys):
    module.main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    if keys is None:  # the JAX probe's text lines
        assert lines == [
            "mask input dtype=bool: compile+run OK, exact=True",
            "mask input dtype=int8: compile+run OK, exact=True",
            "recover kernel: lane exact= True nhit exact= True wsel exact= "
            "True",
            "recover_winners device time: not measured (cpu)"]
        return
    record = json.loads(lines[-1])
    assert set(record) == keys
    if "ok" in record:
        assert record["ok"] is True
    else:  # no device time off the card
        assert record["C"] == C_SMALL and record["ms"] is None


def test_gemm_probe_cli_has_no_cpu_fallback():
    """Without ``--device cpu`` a GEMM probe runs on the card or raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe would run on it")
    with pytest.raises((AssertionError, RuntimeError)):
        probe_gemm_variants.main(["full", str(C_SMALL), "1"])
