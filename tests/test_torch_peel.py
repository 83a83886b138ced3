"""Parity of the port's scoring and peel selection (``sibrar_tpu_torch/ops/
window.py``, ``ops/peel.py``) with the JAX package, on the CPU.

The JAX Pallas kernels run in interpret mode; the port's kernels K2-K4 take
their plain versions (CPU tensors). Tolerances: scores within rtol = atol =
1e-5 (the two GEMMs sum in different orders); gathers, peeled values and
window maxima bit-equal; top-k values within 1e-5 and index sets equal up to
ties."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sibrar_tpu.ops import pallas_peel as jpeel
from sibrar_tpu.ops import pallas_window as jwindow
from sibrar_tpu.ops.pallas_window import score_native_wmax
from sibrar_tpu_torch.ops import peel as tpeel
from sibrar_tpu_torch.ops import window as twindow
from sibrar_tpu_torch.ops.window import score_wmax

NEG = -1e30


def test_plain_score_wmax_matches_pallas():
    rng = np.random.default_rng(0)
    u = rng.normal(size=(8, 128)).astype(np.float32)
    items = rng.normal(size=(2048, 128)).astype(np.float32)
    js, jw = score_native_wmax(jnp.asarray(u), jnp.asarray(items),
                               interpret=True)
    ts, tw = score_wmax(torch.as_tensor(u), torch.as_tensor(items))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    own = ts.numpy().reshape(8, 16, 128).max(-1)
    assert (tw.numpy() == own).all()  # wmax is the max of its own scores
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-5)


def nan_dot(seed, b, c, d, nan_item=True, nan_user=True):
    """Integer-valued ``u [b, d]`` and ``items [c, d]`` (exact f32 scores in
    any summation order) with a NaN in item 300 and in user 3."""
    rng = np.random.default_rng(seed)
    u = rng.integers(-5, 6, (b, d)).astype(np.float32)
    items = rng.integers(-5, 6, (c, d)).astype(np.float32)
    if nan_item:
        items[300, 5] = np.nan
    if nan_user:
        u[3, 7] = np.nan
    return u, items


def nan_score_rows(seed, b, c):
    """Integer scores with one NaN score and windows of +0.0 and -0.0 in
    several orders (JAX's max is +0.0 wherever a +0.0 is present)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(-50, 50, (b, c)).astype(np.float32)
    s[2, 130] = np.nan
    s[4] = np.where(np.arange(c) % 2 == 0, 0.0, -0.0)
    s[5, :128], s[5, 127] = 0.0, -0.0
    s[6, 128:256], s[6, 200] = -0.0, 0.0
    s[7, :128] = -0.0
    return s


def assert_same_bits(got, want):
    """NaN in the same places, the same bits elsewhere (+0.0 is not -0.0)."""
    got, want = np.asarray(got), np.asarray(want)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32))


def test_plain_score_wmax_nan_matches_pallas():
    """K2's plain version gives NaN maxima where ``score_native_wmax`` does:
    the NaN item's window for every user, every window of the NaN user."""
    u, items = nan_dot(20, 8, 2048, 128)
    js, jw = score_native_wmax(jnp.asarray(u), jnp.asarray(items),
                               interpret=True)
    ts, tw = score_wmax(torch.as_tensor(u), torch.as_tensor(items))
    assert_same_bits(ts.numpy(), js)
    assert_same_bits(tw.numpy(), jw)
    want = np.zeros((8, 16), bool)
    want[:, 300 // 128], want[3] = True, True
    np.testing.assert_array_equal(np.isnan(tw.numpy()), want)


@pytest.mark.parametrize("kernel", ["window_max", "window_scores_from"])
def test_plain_maxima_nan_and_signed_zeros_match_pallas(kernel):
    """K8's and K9's plain versions on a NaN score and on windows of +0.0
    and -0.0: JAX's bits (NaN where a lane is NaN; +0.0 where a +0.0 is
    among the zeros, in any order, where ``amax`` may keep -0.0)."""
    s = nan_score_rows(21, 16, 2048)
    if kernel == "window_max":
        want = jpeel.window_max(jnp.asarray(s), interpret=True)
        got = tpeel.window_max(torch.as_tensor(s))
    else:
        jsw, want = jwindow.window_scores_from(jnp.asarray(s), tb=8,
                                               bc=1024, interpret=True)
        tsw, got = twindow.window_scores_from(torch.as_tensor(s))
        assert_same_bits(tsw.numpy(), jsw)
    assert_same_bits(got.numpy(), want)
    w = got.numpy()
    assert np.isnan(w[2, 1]) and np.isnan(w).sum() == 1
    assert (w[[4, 5, 6], [0, 0, 1]].view(np.uint32) == 0).all()  # +0.0
    assert w[7, 0].view(np.uint32) == 0x80000000  # -0.0 alone


@pytest.mark.parametrize("ranker", ["dot", "scores"])
@pytest.mark.parametrize("nan", ["item", "user"])
def test_rankers_follow_a_nan_score_like_jax(ranker, nan):
    """A NaN item (NaN scores in one catalog column) or a NaN user (a row of
    NaN scores) through the dot-path and scores-path rankers, against JAX's
    in interpret mode. Without the redo: the same values (NaN in the same
    places), ids and ok flags. With it (every flagged row redone densely):
    the same values, and ids equal up to exact ties (the redo's
    ``torch.topk`` orders ties its own way; the NaN user's list is one
    tie): each id distinct, not excluded, and holding its value."""
    b, c, d, k, e = 16, 4096, 32, 10, 3
    u, items = nan_dot(22, b, c, d, nan_item=nan == "item",
                       nan_user=nan == "user")
    rng = np.random.default_rng(23)
    cols = np.sort(np.stack([rng.choice(c, e, replace=False)
                             for _ in range(b)]), axis=1).astype(np.int32)
    mask = rng.random((b, e)) < 0.9
    cols[~mask] = 0
    scores = u @ items.T
    if ranker == "dot":
        jargs = (jnp.asarray(u), jnp.asarray(items))
        targs = (torch.as_tensor(u), torch.as_tensor(items))
        jfn, tfn = jpeel.peel_masked_topk_dot, tpeel.peel_masked_topk_dot
    else:
        jargs, targs = (jnp.asarray(scores),), (torch.as_tensor(scores),)
        jfn, tfn = jpeel.peel_masked_topk_scores, tpeel.peel_masked_topk_scores
    jex, tex = (jnp.asarray(cols), jnp.asarray(mask)), (
        torch.as_tensor(cols), torch.as_tensor(mask))
    jv, ji, jok = jfn(*jargs, *jex, k, tb=8, interpret=True,
                      with_fallback=False)
    tv, ti, tok = tfn(*targs, *tex, k, with_fallback=False)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert_same_bits(tv.numpy(), jv)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    jv, ji = jfn(*jargs, *jex, k, tb=8, interpret=True)
    tv, ti, _ = tfn(*targs, *tex, k)
    assert_same_bits(tv.numpy(), jv)
    ti = ti.numpy()
    assert_same_bits(np.take_along_axis(scores, ti, 1), tv.numpy())
    for r in range(b):
        assert len(set(ti[r].tolist())) == k
        assert not set(ti[r].tolist()) & set(cols[r][mask[r]].tolist())
    if nan == "user":
        assert np.isnan(tv.numpy()[3]).all()
        assert not np.isnan(np.delete(tv.numpy(), 3, 0)).any()
    else:  # the NaN item heads every list
        assert (ti[:, 0] == 300).all() and (np.asarray(ji)[:, 0] == 300).all()


@pytest.mark.parametrize("with_dead", [False, True])
def test_plain_gather_windows_matches_pallas(with_dead):
    rng = np.random.default_rng(1)
    scores = rng.normal(size=(8, 2048)).astype(np.float32)
    widx = np.sort(np.stack([rng.choice(16, 6, replace=False)
                             for _ in range(8)]), axis=1).astype(np.int32)
    dead = rng.random((8, 6, 128)) < 0.3 if with_dead else None
    jg = jpeel.gather_score_windows(
        jnp.asarray(scores), jnp.asarray(widx),
        dead=None if dead is None else jnp.asarray(dead), interpret=True)
    tg = tpeel.gather_score_windows(
        torch.as_tensor(scores), torch.as_tensor(widx),
        None if dead is None else torch.as_tensor(dead))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    slots = rng.integers(0, 6, (8, 5)).astype(np.int32)
    jsub = jpeel.gather_subwindows(jg, jnp.asarray(slots), interpret=True)
    tsub = tpeel.gather_subwindows(tg, torch.as_tensor(slots))
    np.testing.assert_array_equal(tsub.numpy(), np.asarray(jsub))


def _tied_rows(rng, shape):
    """Rows with many repeated values and a few -inf lanes."""
    x = rng.integers(-6, 6, size=shape).astype(np.float32)
    x[rng.random(shape) < 0.05] = -np.inf
    return x


def test_plain_peel_values_matches_pallas():
    rng = np.random.default_rng(2)
    x = _tied_rows(rng, (37, 128))
    x[3] = 1.0  # one distinct value: the later rounds run dry
    tv, tlast = tpeel.peel_values(torch.as_tensor(x), 8)
    jv = jpeel.peel_values(jnp.asarray(x), 8, rows_per_block=16,
                           interpret=True)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jv)[:, -1])


def test_plain_peel_values_grouped_matches_pallas():
    rng = np.random.default_rng(3)
    g = np.concatenate([_tied_rows(rng, (16, 4, 128)),
                        rng.normal(size=(16, 4, 128)).astype(np.float32)],
                       axis=1)  # [16, 8, 128]
    jv, jlast = jpeel.peel_values_grouped(jnp.asarray(g), 8, interpret=True)
    tv, tlast = tpeel.peel_values_grouped(torch.as_tensor(g), 8)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))



def _edge_rows(case, shape):
    """Tied rows with a NaN row or rows of +0.0 and -0.0 planted."""
    rng = np.random.default_rng(5)
    x = _tied_rows(rng, shape).reshape(-1, 128)
    if case == "nan_row":
        x[3, 17] = np.nan  # one NaN among tied values
        x[6] = -np.inf
        x[6, 100] = np.nan  # a NaN among -inf
    else:  # signed_zero
        x[3] = np.where(np.arange(128) % 2 == 0, 0.0, -0.0)
        x[6, :64] = -0.0  # -0.0 tied with +0.0 below larger values
        x[6, 64:] = np.where(np.arange(64) % 3 == 0, 0.0, 2.0)
    return x.reshape(shape)


@pytest.mark.parametrize("case", ["nan_row", "signed_zero"])
def test_plain_peel_values_edge_rows_match_pallas(case):
    """The rule K4 is held to: a row with a NaN peels NaN in every round
    (and in ``last``); +0.0 and -0.0 clear together."""
    x = _edge_rows(case, (37, 128))
    tv, tlast = tpeel.peel_values(torch.as_tensor(x), 8)
    jv = jpeel.peel_values(jnp.asarray(x), 8, rows_per_block=16,
                           interpret=True)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jv)[:, -1])
    if case == "nan_row":
        assert np.isnan(tv.numpy()[[3, 6]]).all()
        assert not np.isnan(np.delete(tv.numpy(), [3, 6], axis=0)).any()
    else:
        assert (tv.numpy()[3] == [0.0] + [-np.inf] * 7).all()
        assert (tv.numpy()[6][:2] == [2.0, 0.0]).all()


@pytest.mark.parametrize("case", ["nan_row", "signed_zero"])
def test_plain_peel_values_grouped_edge_rows_match_pallas(case):
    g = _edge_rows(case, (16, 8, 128))
    jv, jlast = jpeel.peel_values_grouped(jnp.asarray(g), 8, interpret=True)
    tv, tlast = tpeel.peel_values_grouped(torch.as_tensor(g), 8)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))
    if case == "nan_row":  # rows 3 and 6 are user 0's windows 3 and 6
        assert np.isnan(tlast.numpy()[0, [3, 6]]).all()


def _dense_oracle(scores, cols, mask, k, c_real):
    s = scores.astype(np.float64).copy()
    for b in range(s.shape[0]):
        s[b, cols[b][mask[b]]] = NEG
    s[:, c_real:] = NEG
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, order, 1), order


def _assert_topk(v, idx, scores, ov, cols, mask, tol=1e-5):
    """Values match the oracle; every index is distinct, holds its value
    and is not excluded (index sets may differ only on ties)."""
    np.testing.assert_allclose(v, ov, rtol=tol, atol=tol)
    np.testing.assert_allclose(np.take_along_axis(scores, idx, 1), ov,
                               rtol=tol, atol=tol)
    for b in range(idx.shape[0]):
        assert len(set(idx[b].tolist())) == idx.shape[1]
        live = ov[b] > NEG / 2
        assert not set(idx[b][live].tolist()) & set(cols[b][mask[b]].tolist())


# (B, live catalog rows, D, k, E, JAX tb, integer-valued inputs)
PEEL_CASES = {
    "margin": (16, 4096, 32, 10, 3, 8, False),
    "corrected": (16, 4096, 32, 10, 12, 8, False),
    "padded_tail": (16, 4000, 32, 10, 12, 8, False),
    "batch_not_16": (12, 4096, 32, 10, 3, 4, False),
    "ties_redo": (16, 4096, 8, 10, 3, 8, True),
}


@pytest.mark.parametrize("case", list(PEEL_CASES))
def test_peel_masked_topk_dot_matches_jax_and_oracle(case):
    b, c, d, k, e, tb, ints = PEEL_CASES[case]
    rng = np.random.default_rng(4)
    if ints:  # exact integer scores: heavy ties, bit-equal in both GEMMs
        u = rng.integers(0, 2, size=(b, d)).astype(np.float32)
        items = rng.integers(0, 2, size=(c, d)).astype(np.float32)
    else:
        u = rng.normal(size=(b, d)).astype(np.float32)
        items = rng.normal(size=(c, d)).astype(np.float32)
    cols = np.sort(np.stack([rng.choice(c, e, replace=False)
                             for _ in range(b)]), axis=1).astype(np.int32)
    mask = rng.random((b, e)) < 0.9
    cols[~mask] = 0

    jv, ji, jok = jpeel.peel_masked_topk_dot(
        jnp.asarray(u), jnp.asarray(items), jnp.asarray(cols),
        jnp.asarray(mask), k, tb=tb, interpret=True, with_fallback=False)
    args = (torch.as_tensor(u), torch.as_tensor(items),
            torch.as_tensor(cols), torch.as_tensor(mask), k)
    tv, ti, tok = tpeel.peel_masked_topk_dot(*args, with_fallback=False)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    ok = tok.numpy()
    np.testing.assert_allclose(tv.numpy()[ok], np.asarray(jv)[ok],
                               rtol=1e-5, atol=1e-5)
    # index sets equal up to ties: JAX's winners hold the port's values
    scores = u @ items.T
    np.testing.assert_allclose(
        np.take_along_axis(scores, np.asarray(ji), 1)[ok], tv.numpy()[ok],
        rtol=1e-5, atol=1e-5)

    # with the redo, every row equals the dense oracle up to ties
    ov, _ = _dense_oracle(scores, cols, mask, k, c)
    rv, ri, rok = tpeel.peel_masked_topk_dot(*args)
    np.testing.assert_array_equal(rok.numpy(), ok)
    _assert_topk(rv.numpy(), ri.numpy(), scores, ov, cols, mask)
    if case == "ties_redo":
        assert not ok.all(), "tie-heavy scores must trip the redo"
    else:
        assert ok.all()


@pytest.mark.parametrize("c,k,e", [(100_352, 100, 55), (100_352, 100, 250),
                                   (4096, 10, 3), (400, 10, 40)])
def test_peel_gates_match_jax(c, k, e):
    assert tpeel._use_corrected_wmax(c, e) == jpeel._use_corrected_wmax(c, e)
    assert tpeel.peel_viable(c, k, e) == jpeel.peel_viable(c, k, e)
    nw = -(-c // 128)
    assert tpeel._round_m(k + e + 1, nw) == jpeel._round_m(k + e + 1, nw)
