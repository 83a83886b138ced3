"""Parity of the port's evaluation ops with the JAX package, on the CPU:
kernels K8 (`window_max`), K9 (`window_scores_from`) and K3 on the window
tiling (`gather_windows_tiled`) by their plain versions against the Pallas
kernels in interpret mode (bit-equal); `masked_topk` under all six methods
against JAX's `masked_topk`, `peel_masked_topk_scores` and
`pallas_masked_topk_scores` (interpret mode) and a dense numpy oracle
(values equal, index sets equal up to ties, peel ok flags equal); the
metric functions against JAX (within 1e-6) and hand-computed golden
values."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sibrar_tpu.eval import metrics as jmetrics
from sibrar_tpu.ops import pallas_peel as jpeel
from sibrar_tpu.ops import pallas_window as jwindow
from sibrar_tpu.ops.sparse import DeviceCSR as JaxCSR
from sibrar_tpu.ops.topk import masked_topk as jax_masked_topk
from sibrar_tpu_torch.eval import metrics as tmetrics
from sibrar_tpu_torch.ops import peel as tpeel
from sibrar_tpu_torch.ops import window as twindow
from sibrar_tpu_torch.ops.sparse import DeviceCSR
from sibrar_tpu_torch.ops.topk import METHODS, masked_topk

NEG = -1e30


# ------------------------------------------------------ kernels' plain twins
def test_plain_window_max_matches_pallas():
    """133 windows: the Pallas kernel covers 128, XLA the 5 of its tail."""
    rng = np.random.default_rng(0)
    s = rng.normal(size=(8, 133 * 128)).astype(np.float32)
    want = jpeel.window_max(jnp.asarray(s), interpret=True)
    got = tpeel.window_max(torch.as_tensor(s))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plain_window_scores_from_matches_pallas():
    rng = np.random.default_rng(1)
    s = rng.normal(size=(16, 2048)).astype(np.float32)
    jsw, jw = jwindow.window_scores_from(jnp.asarray(s), tb=8, bc=1024,
                                         interpret=True)
    tsw, tw = twindow.window_scores_from(torch.as_tensor(s))
    np.testing.assert_array_equal(tsw.numpy(), np.asarray(jsw))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_plain_gather_windows_tiled_matches_pallas():
    rng = np.random.default_rng(2)
    sw_t = rng.normal(size=(16, 8, 128)).astype(np.float32)
    widx = np.stack([rng.choice(16, 5, replace=False)
                     for _ in range(8)]).astype(np.int32)
    want = jwindow.gather_windows(jnp.asarray(sw_t), jnp.asarray(widx),
                                  interpret=True)
    got = twindow.gather_windows_tiled(torch.as_tensor(sw_t),
                                       torch.as_tensor(widx))
    assert got.shape == (8, 5, 128)
    np.testing.assert_array_equal(got.reshape(8, -1).numpy(),
                                  np.asarray(want))


# ----------------------------------------------------------- masked_topk
def _random_case():
    rng = np.random.default_rng(3)
    b, c, e = 16, 5000, 12  # padded catalog, corrected-wmax branch
    s = rng.normal(size=(b, c)).astype(np.float32)
    cols = np.stack([rng.choice(c, e, replace=False) for _ in range(b)])
    return s, cols.astype(np.int32), rng.random((b, e)) < 0.9, 10


def _negative_padded():
    """tests/test_pallas_window.py:147: every score negative, catalog 300
    padded to 1024, so pad lanes would beat every live item."""
    rng = np.random.default_rng(5)
    u = -np.abs(rng.normal(size=(4, 129))).astype(np.float32)
    items = np.abs(rng.normal(size=(300, 129))).astype(np.float32)
    none = np.zeros((4, 0), np.int32)
    return u @ items.T, none, none.astype(bool), 10


def _whole_window_excluded():
    """tests/test_pallas_window.py:69: the top window's leading half is all
    excluded."""
    s = np.zeros((4, 2048), np.float32)
    s[:, 256:384] = 100.0
    s[:, 5] = 1.0
    cols = np.tile(np.arange(256, 320, dtype=np.int32), (4, 1))
    return s, cols, np.ones_like(cols, bool), 8


def _duplicate_window_exclusions():
    """tests/test_pallas_window.py:95: three exclusions in one window."""
    s = np.arange(2048, dtype=np.float32)[None, :]
    cols = np.asarray([[2047, 2046, 2040]], np.int32)
    return s, cols, np.ones((1, 3), bool), 5


def _heavy_corrected():
    """tests/test_pallas_peel.py:199: E >> k on a padded catalog, user 0's
    window 0 fully excluded."""
    rng = np.random.default_rng(12)
    b, c, e = 4, 2000, 300
    s = rng.normal(size=(b, c)).astype(np.float32)
    cols = np.stack([np.sort(rng.choice(c, e, replace=False))
                     for _ in range(b)]).astype(np.int32)
    cols[0, :128] = np.arange(128)
    return s, cols, np.ones((b, e), bool), 10


CASES = {"random": _random_case, "negative_padded": _negative_padded,
         "whole_window_excluded": _whole_window_excluded,
         "duplicate_window_exclusions": _duplicate_window_exclusions,
         "heavy_corrected": _heavy_corrected}


def _csr(cols, mask, c):
    b = cols.shape[0]
    rows = np.repeat(np.arange(b), mask.sum(1))
    return sp.csr_matrix((np.ones(len(rows), np.int8), (rows, cols[mask])),
                         shape=(b, c))


def _oracle(s, cols, mask, k):
    s = s.astype(np.float64).copy()
    for b in range(s.shape[0]):
        s[b, cols[b][mask[b]]] = NEG
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, order, 1)


def _jax_reference(method, s, cols, mask, k):
    """JAX's values (and ok flags) for the port's ``method``: the Pallas
    pipelines in interpret mode for ``peel`` / ``pallas`` (its masked_topk
    degrades both to scatter off the TPU), else its own masked_topk."""
    b = s.shape[0]
    tb = -(-b // 8) * 8
    args = (jnp.asarray(s), jnp.asarray(cols), jnp.asarray(mask), k)
    if method == "peel":
        v, _, ok = jpeel.peel_masked_topk_scores(
            *args, tb=tb, interpret=True, with_fallback=False)
        return np.asarray(v), np.asarray(ok)
    if method == "pallas":
        v, _ = jwindow.pallas_masked_topk_scores(*args, tb=tb,
                                                 interpret=True)
        return np.asarray(v), None
    csr = JaxCSR.from_scipy(_csr(cols, mask, s.shape[1]))
    v, _ = jax_masked_topk(jnp.asarray(s), csr,
                           jnp.arange(b, dtype=jnp.int32), k, method=method)
    return np.asarray(v), None


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", list(CASES))
def test_masked_topk_matches_jax_and_oracle(case, method):
    s, cols, mask, k = CASES[case]()
    b, c = s.shape
    cols = np.where(mask, cols, 0).astype(np.int32)
    csr = DeviceCSR.from_scipy(_csr(cols, mask, c), "cpu")
    u = torch.arange(b, dtype=torch.int32)
    v, idx, ok = masked_topk(torch.as_tensor(s), csr, u, k, method=method,
                             return_ok=True)
    if method != "peel":  # only the peel may leave rows to redo
        assert ok.all()
    v, idx = masked_topk(torch.as_tensor(s), csr, u, k, method=method)
    v, idx = v.numpy(), idx.numpy()
    want = _oracle(s, cols, mask, k)
    np.testing.assert_allclose(v, want, rtol=1e-6, atol=1e-6)
    live = want > NEG / 2
    held = np.take_along_axis(s, np.minimum(idx, c - 1), 1)
    np.testing.assert_allclose(held[live], want[live], rtol=1e-6, atol=1e-6)
    for r in range(b):  # distinct, and no excluded item among live winners
        assert len(set(idx[r].tolist())) == k
        assert not set(idx[r][live[r]].tolist()) & set(cols[r][mask[r]])
    jv, jok = _jax_reference(method, s, cols, mask, k)
    if method == "peel":
        # the peel without its redo on the same exclusion lists as JAX's:
        # both flag the same rows, and JAX's exact rows hold our values
        tv, _, tok = tpeel.peel_masked_topk_scores(
            torch.as_tensor(s), torch.as_tensor(cols), torch.as_tensor(mask),
            k, with_fallback=False)
        np.testing.assert_array_equal(tok.numpy(), jok)
        np.testing.assert_allclose(tv.numpy()[jok], jv[jok], rtol=1e-6,
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(v, jv, rtol=1e-6, atol=1e-6)


def test_masked_topk_auto_dispatch(monkeypatch):
    """auto: ``full`` up to C = 4096, the peel where viable, else scatter;
    an explicit peel that is not viable takes scatter."""
    rng = np.random.default_rng(4)
    calls = []
    real = tpeel.peel_masked_topk_scores

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(tpeel, "peel_masked_topk_scores", spy)
    for c, e, method, peel in ((4096, 4, "auto", False),
                               (8192, 4, "auto", True),
                               (8192, 4096, "auto", False),
                               (8192, 4096, "peel", False)):
        s = torch.as_tensor(rng.normal(size=(8, c)).astype(np.float32))
        cols = np.stack([rng.choice(c, e, replace=False)
                         for _ in range(8)]).astype(np.int32)
        mask = np.ones(cols.shape, bool)
        csr = DeviceCSR.from_scipy(_csr(cols, mask, c), "cpu")
        calls.clear()
        v, _ = masked_topk(s, csr, torch.arange(8), 10, method=method)
        assert bool(calls) == peel, (c, e, method)
        np.testing.assert_allclose(v.numpy(), _oracle(s.numpy(), cols, mask,
                                                      10), rtol=1e-6)
    with pytest.raises(ValueError, match="unknown top-k method"):
        masked_topk(s, csr, torch.arange(8), 10, method="approx")


# --------------------------------------------------------------- metrics
def test_user_metrics_and_coverage_match_jax():
    rng = np.random.default_rng(6)
    b, k_max, ks = 64, 20, (1, 3, 5, 10, 20, 50)
    hits = (rng.random((b, k_max)) < 0.2).astype(np.float32)
    n_pos = rng.integers(0, 30, b).astype(np.int32)
    n_pos[:4] = 0
    want = jmetrics.user_metrics_from_hits(jnp.asarray(hits),
                                           jnp.asarray(n_pos), ks)
    got = tmetrics.user_metrics_from_hits(torch.as_tensor(hits),
                                          torch.as_tensor(n_pos), ks)
    assert set(got) == set(want)
    for key, v in want.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(v),
                                   rtol=0, atol=1e-6, err_msg=key)
    sub = tmetrics.user_metrics_from_hits(torch.as_tensor(hits),
                                          torch.as_tensor(n_pos), ks,
                                          metrics=("ndcg", "ap"))
    assert set(sub) == {f"{m}@{k}" for m in ("ndcg", "ap") for k in ks}

    topk = rng.integers(0, 300, (b, k_max)).astype(np.int32)
    jcov = jmetrics.coverage_flags(jnp.asarray(topk), ks, 300)
    tcov = tmetrics.coverage_flags(torch.as_tensor(topk), ks, 300)
    assert set(tcov) == set(jcov)
    for key, flags in jcov.items():
        np.testing.assert_array_equal(tcov[key].numpy(), np.asarray(flags))
    for n in (1, 3, 10):
        np.testing.assert_array_equal(tmetrics.weight_ndcg_at_k(n, 10),
                                      jmetrics.weight_ndcg_at_k(n, 10))


def test_metrics_golden_values_hand_computed():
    """tests/test_metrics.py:101: hits at ranks 1 and 3 of 5, n_pos = 4."""
    m = tmetrics.user_metrics_from_hits(
        torch.tensor([[1.0, 0.0, 1.0, 0.0, 0.0]]), torch.tensor([4]), (3, 5))
    d = [1 / np.log2(r + 2) for r in range(5)]
    np.testing.assert_allclose(float(m["ndcg@3"][0]),
                               (d[0] + d[2]) / (d[0] + d[1] + d[2]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m["ndcg@5"][0]),
                               (d[0] + d[2]) / sum(d[:4]), rtol=1e-6)
    np.testing.assert_allclose(float(m["recall@3"][0]), 2 / 4)
    np.testing.assert_allclose(float(m["precision@3"][0]), 2 / 3)
    p, r = 2 / 3, 2 / 4
    np.testing.assert_allclose(float(m["f_score@3"][0]), 2 * p * r / (p + r),
                               rtol=1e-6)
    assert float(m["hitrate@3"][0]) == 1.0
    np.testing.assert_allclose(float(m["ap@3"][0]), (1 + 2 / 3) / 3,
                               rtol=1e-6)


def test_metrics_no_positives_user_all_zero():
    """tests/test_metrics.py:127: users without positives score 0, never
    NaN."""
    m = tmetrics.user_metrics_from_hits(torch.zeros((1, 4)),
                                        torch.tensor([0]), (4,))
    for key, v in m.items():
        assert float(v[0]) == 0.0, key
