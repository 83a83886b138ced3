"""Parity of the port's windowed-tiling rankers with the JAX package, on the
CPU: the plain versions of kernels K10 (`score_windows`), #10
(`gather_windows_rows`), K11 (`recover_winners`), K12 (`fused_score_wmax`)
and K13 (`exact_topk`) against the Pallas kernels in interpret mode;
`peel_masked_topk`, `pallas_masked_topk` and `fused_masked_topk` against
the JAX functions (values, ids up to ties, ok flags); the `RECOVER_KERNEL`
branch against the default on both sides; the [B, C] peel paths and the
plane path through the shared `_peel_select`; and the JAX dispatch fact
that lets `Recommender` leave out JAX's fused-only serving branch.

Scores come from integer-valued inputs wherever both GEMMs must give the
same bits (every product and sum is exact in f32), and from normal draws
with a 1e-5 tolerance where the point is the arithmetic."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from sibrar_tpu.ops import pallas_peel as jpeel
from sibrar_tpu.ops import pallas_score as jscore
from sibrar_tpu.ops import pallas_topk as jtopk
from sibrar_tpu.ops import pallas_window as jwindow
from sibrar_tpu_torch.ops import exact_topk as ttopk
from sibrar_tpu_torch.ops import peel as tpeel
from sibrar_tpu_torch.ops import score as tscore
from sibrar_tpu_torch.ops import window as twindow

NEG = -1e30
TOL = 1e-5


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _int_dot(rng, b, c, d, lo=-50, hi=50):
    """u [b, d], items [c, d] with integer entries: exact f32 scores in any
    summation order (|score| < 2**24)."""
    u = rng.integers(lo, hi + 1, size=(b, d)).astype(np.float32)
    items = rng.integers(lo, hi + 1, size=(c, d)).astype(np.float32)
    return u, items


def _exclusions(rng, b, c, e, p_live=0.85):
    cols = np.sort(np.stack([rng.choice(c, e, replace=False)
                             for _ in range(b)]), axis=1).astype(np.int32)
    mask = rng.random((b, e)) < p_live
    return np.where(mask, cols, 0).astype(np.int32), mask


def _dense_oracle(s, cols, mask, k):
    s = s.astype(np.float64).copy()
    for r in range(s.shape[0]):
        s[r, cols[r][mask[r]]] = NEG
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, order, 1)


def _assert_lists(v, idx, s, want_v, cols=None, mask=None, tol=TOL):
    """Values equal ``want_v``; each index distinct, not excluded (where the
    value is live), and holding its value: index sets equal up to ties."""
    np.testing.assert_allclose(v, want_v, rtol=tol, atol=tol)
    np.testing.assert_allclose(np.take_along_axis(s, idx, 1), want_v,
                               rtol=tol, atol=tol)
    for r in range(idx.shape[0]):
        assert len(set(idx[r].tolist())) == idx.shape[1]
        if cols is not None:
            live = want_v[r] > NEG / 2
            assert not set(idx[r][live].tolist()) & set(cols[r][mask[r]])


# ------------------------------------------------------ kernels' plain twins
def test_plain_score_windows_matches_pallas():
    """K10: B = 16 users in blocks of 8, C = 2048 in blocks of 1024."""
    rng = np.random.default_rng(0)
    u = rng.normal(size=(16, 128)).astype(np.float32)
    items = rng.normal(size=(2048, 128)).astype(np.float32)
    jsw, jw = jwindow.score_windows(*_j(u, items), tb=8, bc=1024,
                                    interpret=True)
    tsw, tw = twindow.score_windows(*_t(u, items))
    np.testing.assert_allclose(tsw.numpy(), np.asarray(jsw), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=TOL, atol=TOL)
    # the maxima are those of the planes written, bit for bit
    np.testing.assert_array_equal(tw.numpy(), tsw.numpy().max(-1).T)
    # and the planes are the [B, C] scores of K2's plain version, retiled
    scores, wmax = twindow.score_wmax(*_t(u, items))
    np.testing.assert_array_equal(
        tsw.numpy(), scores.numpy().reshape(16, 16, 128).transpose(1, 0, 2))
    np.testing.assert_array_equal(tw.numpy(), wmax.numpy())


@pytest.mark.parametrize("with_dead", [False, True])
def test_plain_gather_windows_rows_matches_pallas(with_dead):
    """#10 (tests/test_pallas_peel.py:75), with the dead mask the port
    applies on copy where JAX applies it after the gather."""
    rng = np.random.default_rng(2)
    sw_t = rng.normal(size=(16, 8, 128)).astype(np.float32)
    widx = rng.integers(0, 16, size=(8, 5)).astype(np.int32)
    dead = rng.random((8, 5, 128)) < 0.1 if with_dead else None
    want = jpeel.gather_windows_rows(*_j(sw_t, widx), interpret=True)
    if with_dead:
        want = jnp.where(jnp.asarray(dead), -jnp.inf, want)
    got = tpeel.gather_windows_rows(
        *_t(sw_t, widx), None if dead is None else torch.as_tensor(dead))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plain_recover_winners_matches_pallas():
    """K11 with tests/test_pallas_peel.py:637's planted ties (a pair and a
    triple of equal values in a winner's window): bit-equal integers."""
    rng = np.random.default_rng(12)
    b, m, w, kk = 16, 24, 128, 10
    g = rng.normal(size=(b, m, w)).astype(np.float32)
    g[0, 3, 7] = g[0, 3, 99]
    g[5, 0, 0] = g[5, 0, 1] = g[5, 0, 2]
    slots = rng.integers(0, m, size=(b, kk)).astype(np.int32)
    lanes = rng.integers(0, w, size=(b, kk)).astype(np.int32)
    slots[0, 0], lanes[0, 0] = 3, 7
    slots[5, 1], lanes[5, 1] = 0, 1
    slots[2, 3], lanes[2, 3] = 4, 0  # lane 0, and one value with no match
    v = np.take_along_axis(g.reshape(b, m * w), slots * w + lanes, 1)
    v[1, 2] = 1e9
    widx = np.sort(rng.integers(0, 999, size=(b, m)).astype(np.int32), 1)
    want = jpeel.recover_winners(*_j(g, widx, slots, v), interpret=True)
    got = tpeel.recover_winners(*_t(g, widx, slots, v))
    for x, y in zip(got, want):
        assert x.dtype == torch.int32
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert int(got[1].max()) == 3 and int(got[0][1, 2]) == w  # ties, no hit


@pytest.mark.parametrize("window", [64, 128])
def test_plain_fused_score_wmax_matches_pallas(window):
    rng = np.random.default_rng(3)
    u = rng.normal(size=(8, 128)).astype(np.float32)
    items = rng.normal(size=(1024, 128)).astype(np.float32)
    js, jw = jscore.fused_score_wmax(*_j(u, items), window=window, tb=8,
                                     bc=512, interpret=True)
    ts, tw = tscore.fused_score_wmax(*_t(u, items), window=window)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(
        tw.numpy(), ts.numpy().reshape(-1, window, 8).max(1))


@pytest.mark.parametrize("kernel", ["score_windows", "fused_64",
                                    "fused_128"])
def test_plain_window_maxima_nan_matches_pallas(kernel):
    """K10's and K12's plain versions give JAX's maxima on a NaN item and a
    NaN user (integer-valued inputs: exact scores): NaN in the NaN item's
    window for every user and in every window of the NaN user, the same
    bits elsewhere."""
    u, items = _int_dot(np.random.default_rng(24), 16, 2048, 128, -5, 5)
    items[300, 5], u[3, 7] = np.nan, np.nan
    if kernel == "score_windows":
        jsw, jw = jwindow.score_windows(*_j(u, items), tb=8, bc=1024,
                                        interpret=True)
        tsw, tw = twindow.score_windows(*_t(u, items))
        _assert_same_bits(tsw.numpy(), jsw)
        window, tw, jw = 128, tw.numpy().T, np.asarray(jw).T  # [C/w, B]
    else:
        window = int(kernel.split("_")[1])
        _, jw = jscore.fused_score_wmax(*_j(u, items), window=window, tb=8,
                                        bc=512, interpret=True)
        tw = tscore.fused_score_wmax(*_t(u, items), window=window)[1].numpy()
    _assert_same_bits(tw, jw)
    want = np.zeros((2048 // window, 16), bool)
    want[300 // window], want[:, 3] = True, True
    np.testing.assert_array_equal(np.isnan(tw), want)


def _assert_same_bits(got, want):
    """NaN in the same places, the same bits elsewhere."""
    got, want = np.asarray(got), np.asarray(want)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32))


@pytest.mark.parametrize("window", [0, 12, 24, 48, 1024])
def test_fused_score_wmax_refuses_windows_jax_refuses(window):
    """JAX admits a multiple of 8 dividing its 512-row block; so does the
    port, and it raises on the rest, as on a catalog that is not a 512
    multiple."""
    u, items = torch.zeros(4, 16), torch.zeros(1024, 16)
    with pytest.raises(ValueError, match="window"):
        tscore.fused_score_wmax(u, items, window=window)
    if window == 48:
        with pytest.raises(ValueError):
            jscore.fused_score_wmax(*_j(u.numpy(), np.zeros((1024, 128),
                                                            np.float32)),
                                    window=window, tb=4, interpret=True)
    with pytest.raises(ValueError, match="512"):
        tscore.fused_score_wmax(u, items[:640], window=64)


def _topk_rows(kind, rng):
    if kind == "normal":
        return rng.normal(size=(9, 1000)).astype(np.float32), 37
    if kind == "ties":  # few distinct values: index order decides
        return rng.integers(-3, 4, size=(9, 1000)).astype(np.float32), 50
    if kind == "all_ones_nan":  # k = n; the NaN whose key is K13's 0
        x = rng.normal(size=(4, 300)).astype(np.float32)
        x.view(np.uint32)[0, 200:] = 0xFFFFFFFF
        x.view(np.uint32)[1, ::3] = 0xFFFFFFFF
        x.view(np.uint32)[2] = 0xFFFFFFFF
        x[3, 7] = -np.inf
        return x, 300
    # the threshold K13 takes (the k-th largest 128-window maximum) passes
    # more elements than its buffer on these: its exact path
    if kind == "copies_of_kth":  # 300 copies of the k-th value, 32 windows
        x = rng.normal(size=(4, 4096)).astype(np.float32) - 10.0
        for r in range(4):
            pos = rng.permutation(4096)
            x[r, pos[:300]], x[r, pos[300:320]] = 2.0, 5.0
        return x, 37
    if kind == "constant":
        return np.full((3, 2048), 1.5, np.float32), 37
    if kind == "all_neg_inf":
        return np.full((3, 2048), -np.inf, np.float32), 37
    if kind == "k_eq_n":
        return rng.normal(size=(3, 700)).astype(np.float32), 700
    # fewer than k values above -inf, signed zeros among the live ones
    x = np.full((8, 256), -np.inf, np.float32)
    x[0, [130, 5, 7]] = [3.0, 2.0, 1.0]
    x[1, [3, 200]] = [-0.0, 0.0]
    x[2, 9] = -1e30
    return x, 5


@pytest.mark.parametrize("kind", ["normal", "ties", "short_rows",
                                  "all_ones_nan", "copies_of_kth",
                                  "constant", "all_neg_inf", "k_eq_n"])
def test_plain_exact_topk_matches_lax_top_k(kind):
    """K13's plain version against ``lax.top_k`` (values bit for bit and
    indices, tie order included) and against the Pallas kernel wherever
    that kernel keeps its own contract; on rows with fewer than k values
    above -inf it repeats an index (pallas_topk.py:41, :62) and the port
    does not. At k = n JAX takes ``lax.top_k`` itself."""
    x, k = _topk_rows(kind, np.random.default_rng(5))
    want_v, want_i = lax.top_k(jnp.asarray(x), k)
    got_v, got_i = ttopk.exact_topk(torch.as_tensor(x), k)
    np.testing.assert_array_equal(got_v.numpy().view(np.uint32),
                                  np.asarray(want_v).view(np.uint32))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert all(len(set(r)) == k for r in got_i.tolist())
    assert int(got_i.max()) < x.shape[1]
    pv, pi = jtopk.exact_topk(jnp.asarray(x), k, min_n=128, interpret=True)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(pv))
    if kind == "all_neg_inf":  # no value above -inf: JAX's kernel repeats
        assert len(set(np.asarray(pi)[0].tolist())) < k
    elif kind != "short_rows":
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(pi))
    else:  # the smallest input of the reference-side finding
        assert np.asarray(pi)[0].tolist() == [130, 5, 7, 0, 0]
        assert got_i[0].tolist() == [130, 5, 7, 0, 1]


def test_exact_topk_dispatch_rule():
    """Where JAX hands the row to ``lax.top_k`` (k >= n, n < min_n) the port
    gives the same ``min(k, n)`` values and indices: K13 on the card, its
    plain version here."""
    x = torch.as_tensor(np.random.default_rng(6).normal(
        size=(3, 200)).astype(np.float32))
    for k, min_n in ((200, 128), (300, 128), (10, 8192)):
        v, i = ttopk.exact_topk(x, k)
        jv, ji = jtopk.exact_topk(jnp.asarray(x.numpy()), k, min_n=min_n)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


# ------------------------------------------------------ peel_masked_topk
# (B, C, D, k, E, integer inputs, negative scores): C = 5120 keeps E = 3 on
# the margin path and E = 12 on the corrected one (E > C / 1024); 4000 pads
PEEL_CASES = {
    "margin": (16, 5120, 48, 10, 3, True, False),
    "corrected": (16, 5120, 48, 10, 12, True, False),
    "padded_tail_negative": (12, 4000, 129, 10, 12, True, True),
    "no_exclusion_normal": (5, 1000, 33, 10, 0, False, False),
}


def _peel_inputs(case):
    b, c, d, k, e, ints, negative = PEEL_CASES[case]
    rng = np.random.default_rng(7)
    if ints:
        u, items = _int_dot(rng, b, c, d)
    else:
        u = rng.normal(size=(b, d)).astype(np.float32)
        items = rng.normal(size=(c, d)).astype(np.float32)
    if negative:  # every score < 0: the pad lanes' zeros would win
        u, items = -np.abs(u) - 1, np.abs(items) + 1
    cols, mask = _exclusions(rng, b, c, e)
    return u, items, cols, mask, k


@pytest.mark.parametrize("case", list(PEEL_CASES))
def test_peel_masked_topk_matches_jax(case):
    u, items, cols, mask, k = _peel_inputs(case)
    b, c = u.shape[0], items.shape[0]
    corrected = tpeel._use_corrected_wmax(c, cols.shape[1])
    assert corrected == (case in ("corrected", "padded_tail_negative"))
    jv, ji, jok = jpeel.peel_masked_topk(*_j(u, items, cols, mask), k,
                                         tb=-(-b // 8) * 8, interpret=True,
                                         with_fallback=False)
    tv, ti, tok = tpeel.peel_masked_topk(*_t(u, items, cols, mask), k,
                                         with_fallback=False)
    s = u.astype(np.float64) @ items.T.astype(np.float64)
    tol = 0.0 if PEEL_CASES[case][5] else TOL
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    ok = tok.numpy()
    assert ok.all()
    _assert_lists(tv.numpy(), ti.numpy(), s, np.asarray(jv), cols, mask, tol)
    np.testing.assert_allclose(np.take_along_axis(s, np.asarray(ji), 1),
                               tv.numpy(), rtol=tol, atol=tol)
    # with the redo (none needed here) the lists are the dense oracle's
    rv, ri, _ = tpeel.peel_masked_topk(*_t(u, items, cols, mask), k)
    _assert_lists(rv.numpy(), ri.numpy(), s, _dense_oracle(s, cols, mask, k),
                  cols, mask, tol)


def test_peel_masked_topk_redoes_flagged_rows_from_the_planes():
    """Tie-heavy 0/1 scores trip the exactness flags in both packages on the
    same rows; the redo from the planes makes every row exact."""
    rng = np.random.default_rng(8)
    u, items = _int_dot(rng, 8, 2048, 6, 0, 1)
    cols, mask = _exclusions(rng, 8, 2048, 3)
    _, _, jok = jpeel.peel_masked_topk(*_j(u, items, cols, mask), 10, tb=8,
                                       interpret=True, with_fallback=False)
    v, i, ok = tpeel.peel_masked_topk(*_t(u, items, cols, mask), 10)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert not ok.numpy().all()
    s = u @ items.T
    _assert_lists(v.numpy(), i.numpy(), s, _dense_oracle(s, cols, mask, 10),
                  cols, mask, 0.0)


@pytest.mark.parametrize("case", ["margin", "corrected"])
def test_recover_kernel_branch_matches_default(case, monkeypatch):
    """The ``SIBRAR_PEEL_RECOVER_KERNEL`` branch gives the default branch's
    bits in the port, and JAX's own flagged branch (tests/test_pallas_peel.py
    :667) gives the same lists."""
    u, items, cols, mask, k = _peel_inputs(case)
    args = (*_t(u, items, cols, mask), k)
    base = tpeel.peel_masked_topk(*args, with_fallback=False)
    calls = []
    real = tpeel.recover_winners
    monkeypatch.setattr(tpeel, "recover_winners",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(tpeel, "RECOVER_KERNEL", True)
    flagged = tpeel.peel_masked_topk(*args, with_fallback=False)
    assert calls
    for x, y in zip(flagged, base):
        assert torch.equal(x, y)
    monkeypatch.setattr(jpeel, "_RECOVER_KERNEL", True)
    jax.clear_caches()  # the flag is read when the entry is traced
    try:
        jv, ji = jpeel.peel_masked_topk(*_j(u, items, cols, mask), k, tb=16,
                                        interpret=True)
    finally:
        monkeypatch.undo()
        jax.clear_caches()
    np.testing.assert_array_equal(flagged[0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(flagged[1].numpy(), np.asarray(ji))


@pytest.mark.parametrize("case", ["margin", "corrected",
                                  "padded_tail_negative"])
def test_bc_paths_and_plane_path_share_the_selection(case, monkeypatch):
    """After the `_peel_select` refactor the [B, C] paths keep their results
    (JAX's ok flags and values for `peel_masked_topk_dot` and
    `peel_masked_topk_scores`) and their K3 / K4 calls per batch (2 / 1 on
    the margin path, 3 / 1 on the corrected one), and the plane path gives
    the dot path's bits."""
    u, items, cols, mask, k = _peel_inputs(case)
    tb = -(-u.shape[0] // 8) * 8
    calls = {"gather_windows": 0, "peel_values": 0,
             "gather_windows_rows": 0}
    for name in calls:
        real = getattr(tpeel, name)
        monkeypatch.setattr(tpeel, name, lambda *a, _f=real, _n=name: (
            calls.__setitem__(_n, calls[_n] + 1), _f(*a))[1])
    dot = tpeel.peel_masked_topk_dot(*_t(u, items, cols, mask), k,
                                     with_fallback=False)
    corrected = case != "margin"
    assert calls == {"gather_windows": 2 + corrected, "peel_values": 1,
                     "gather_windows_rows": 0}
    jv, _, jok = jpeel.peel_masked_topk_dot(*_j(u, items, cols, mask), k,
                                            tb=tb, interpret=True,
                                            with_fallback=False)
    np.testing.assert_array_equal(dot[2].numpy(), np.asarray(jok))
    np.testing.assert_array_equal(dot[0].numpy(), np.asarray(jv))
    planes = tpeel.peel_masked_topk(*_t(u, items, cols, mask), k,
                                    with_fallback=False)
    assert calls["gather_windows_rows"] == 1 + corrected
    for x, y in zip(planes, dot):
        assert torch.equal(x, y)
    s = u @ items.T
    jv, _, jok = jpeel.peel_masked_topk_scores(*_j(s, cols, mask), k, tb=tb,
                                               interpret=True,
                                               with_fallback=False)
    tv, _, tok = tpeel.peel_masked_topk_scores(*_t(s, cols, mask), k,
                                               with_fallback=False)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ------------------------------------------- pallas and fused entry points
# (B, C, D, k, E): aligned; B, C and D all unaligned; a padded catalog of
# negative scores (tests/test_pallas_window.py:147)
RANKER_CASES = {
    "aligned": (8, 2048, 128, 10, 16, False),
    "unaligned": (5, 1000, 48, 10, 7, False),
    "negative_padded": (4, 300, 129, 10, 0, True),
}


def _ranker_inputs(case):
    b, c, d, k, e, negative = RANKER_CASES[case]
    rng = np.random.default_rng(9)
    u, items = _int_dot(rng, b, c, d)
    if negative:
        u, items = -np.abs(u) - 1, np.abs(items) + 1
    cols, mask = _exclusions(rng, b, c, e)
    return u, items, cols, mask, k


@pytest.mark.parametrize("case", list(RANKER_CASES))
def test_pallas_masked_topk_matches_jax(case):
    u, items, cols, mask, k = _ranker_inputs(case)
    jv, ji = jwindow.pallas_masked_topk(*_j(u, items, cols, mask), k, tb=8,
                                        interpret=True)
    tv, ti = twindow.pallas_masked_topk(*_t(u, items, cols, mask), k)
    s = u @ items.T
    _assert_lists(tv.numpy(), ti.numpy(), s, np.asarray(jv), cols, mask, 0.0)
    _assert_lists(tv.numpy(), ti.numpy(), s, _dense_oracle(s, cols, mask, k),
                  cols, mask, 0.0)
    assert ti.numpy().max() < items.shape[0]


@pytest.mark.parametrize("window", [64, 128])
@pytest.mark.parametrize("case", list(RANKER_CASES))
def test_fused_masked_topk_matches_jax(case, window):
    u, items, cols, mask, k = _ranker_inputs(case)
    c = items.shape[0]
    sent = np.where(mask, cols, 2 ** 30).astype(np.int32)  # JAX's sentinel
    jv, ji = jscore.fused_masked_topk(*_j(u, items, sent), k, window=window,
                                      tb=8, bc=512, interpret=True)
    tv, ti = tscore.fused_masked_topk(*_t(u, items, sent), k, window=window)
    s = u @ items.T
    _assert_lists(tv.numpy(), ti.numpy(), s, np.asarray(jv), cols, mask, 0.0)
    _assert_lists(tv.numpy(), ti.numpy(), s, _dense_oracle(s, cols, mask, k),
                  cols, mask, 0.0)
    # both rank candidates in window-selection order: the same ids
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.numpy().max() < c


# ------------------------------------------------------------ dispatch
def test_jax_fused_only_serving_branch_is_unreachable():
    """JAX's `Recommender` takes `peel_masked_topk` only when
    ``peel_viable(c, k, E, fused=True)`` holds and ``peel_viable(c, k, E)``
    does not (sibrar_tpu/serve.py:296, :316). Over the serving and
    evaluation geometries and the gates' edges (m near 768 and 1228, the
    192k row cap, E at the corrected-path limit) that never happens, so the
    port's `Recommender`, which always takes the [B, C] dot path, picks
    JAX's path."""
    cs = (300, 1000, 2048, 4096, 5120, 32768, 100_352, 150_000, 196_608,
          196_609, 250_000, 501_760)
    ks = (1, 10, 20, 50, 100, 200, 500, 700, 760, 768, 800, 1000, 1220, 1228,
          1300)
    es = (0, 1, 3, 12, 41, 55, 64, 97, 98, 99, 100, 250, 511, 512, 513, 600,
          1000)
    viable = 0
    for c in cs:
        for k in ks:
            for e in es:
                fused = jpeel.peel_viable(c, k, e, fused=True)
                assert not (fused and not jpeel.peel_viable(c, k, e)), (c, k,
                                                                         e)
                viable += fused
    assert viable > 100  # the grid reaches the fused gate's viable side


BLOCKED_RANKERS = r"""
import sys
for name in ("jax", "flax", "optax", "yaml", "pandas", "sibrar_tpu"):
    sys.modules[name] = None  # any import of these now fails
import torch
import chip_smoke
from sibrar_tpu_torch.ops import exact_topk, peel, score, window
g = torch.Generator().manual_seed(0)
u, items = torch.randn(6, 20, generator=g), torch.randn(3000, 20, generator=g)
cols = torch.randint(0, 3000, (6, 4), generator=g, dtype=torch.int32)
mask = torch.ones(6, 4, dtype=torch.bool)
want = peel.peel_masked_topk_dot(u, items, cols, mask, 7)[0]
peel.RECOVER_KERNEL = True
for v in (peel.peel_masked_topk(u, items, cols, mask, 7)[0],
          window.pallas_masked_topk(u, items, cols, mask, 7)[0],
          score.fused_masked_topk(u, items, cols, 7)[0]):
    assert torch.allclose(v, want, rtol=1e-5, atol=1e-5)
assert exact_topk.exact_topk(u @ items.T, 7)[1].shape == (6, 7)
loaded = [m for m in ("jax", "flax", "optax", "yaml", "pandas", "sibrar_tpu")
          if sys.modules.get(m) is not None]
assert not loaded, loaded
print("rankers ok")
"""


def test_rankers_and_chip_smoke_import_no_jax():
    """The new modules and `chip_smoke.py` run with jax, flax, optax, yaml,
    pandas and the JAX package unimportable."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", BLOCKED_RANKERS],
                          capture_output=True, text=True, cwd=root,
                          timeout=300, env={**os.environ, "PYTHONPATH": root})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "rankers ok" in proc.stdout
