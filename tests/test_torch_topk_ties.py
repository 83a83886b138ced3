"""The port's `masked_topk` ids against the JAX package's on tied scores.

64 rows of one popularity vector (capped Zipf counts over C = 20,000
items, so most values tie with many others), k = 100, 0.2 % of the entries
excluded; and 16 rows at k = 10, where the peel is viable (also rows
that tie whole: constant, four values, sparse, signed zeros). Under every
method the port's ids equal JAX's bit for bit: JAX's ``full``,
``scatter`` and ``noscatter`` are its own `masked_topk`, its ``peel`` and
``pallas`` pipelines run in interpret mode, and ``auto`` is JAX's
accelerator branch. Ties break as ``lax.top_k`` breaks them (the larger
value first, equal values to the lower index), which ``torch.topk`` does
not promise. A last case pins what the windowed methods keep of JAX: the
candidate windows go in order of their maxima, so ties that span windows
of different maxima leave ``lax.top_k``'s order there, in both packages.
Rows longer than K13 takes (`lax_topk`, the ``full`` method's selection)
narrow to the top-k of their chunks in catalog order and keep
``lax.top_k``'s ids, pinned here at a small limit and once beyond K13's
real one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax import lax

from sibrar_tpu.ops import pallas_peel as jpeel
from sibrar_tpu.ops import pallas_window as jwindow
from sibrar_tpu.ops.sparse import DeviceCSR as JaxCSR
from sibrar_tpu.ops.topk import masked_topk as jax_masked_topk
from sibrar_tpu.ops.topk import windowed_topk as jax_windowed_topk
from sibrar_tpu_torch.ops.peel import peel_viable
from sibrar_tpu_torch.ops.sparse import DeviceCSR
from sibrar_tpu_torch.ops.exact_topk import MAX_N
from sibrar_tpu_torch.ops.topk import (
    METHODS,
    lax_topk,
    masked_topk,
    windowed_topk,
)


def _tied_case(b: int, k: int, seed: int = 0, c: int = 20_000,
               rate: float = 0.002):
    rng = np.random.default_rng(seed)
    counts = np.minimum(rng.zipf(1.5, c), 50).astype(np.float64)
    pop = (counts / counts.sum()).astype(np.float32)
    excl = rng.random((b, c)) < rate
    return np.tile(pop, (b, 1)), sp.csr_matrix(excl.astype(np.int8)), k


def _heavy_ties(kind: str):
    """16 rows over C = 8,192, k = 10 (the peel viable), 0.1 % excluded:
    every value tied (``constant``), four values, 1 % of the items at 1 or
    2 and the rest 0 (``sparse``), or a random mix of +0.0 and -0.0."""
    rng = np.random.default_rng(4)
    b, c = 16, 8192
    s = {"constant": np.zeros((b, c)),
         "four_values": rng.integers(0, 4, (b, c)),
         "sparse": (rng.random((b, c)) < 0.01) * rng.integers(1, 3, (b, c)),
         "signed_zeros": np.where(rng.random((b, c)) < 0.5, 0.0, -0.0),
         }[kind].astype(np.float32)
    excl = rng.random((b, c)) < 0.001
    return s, sp.csr_matrix(excl.astype(np.int8)), 10


CASES = {"k100": lambda: _tied_case(64, 100),
         "k10_peel": lambda: _tied_case(16, 10, seed=1)}
HEAVY = ("constant", "four_values", "sparse", "signed_zeros")


def _padded_rows(csr: sp.csr_matrix):
    e = max(int(np.diff(csr.indptr).max()), 1)
    cols = np.zeros((csr.shape[0], e), np.int32)
    mask = np.zeros((csr.shape[0], e), bool)
    for r in range(csr.shape[0]):
        row = csr.indices[csr.indptr[r]:csr.indptr[r + 1]]
        cols[r, :len(row)], mask[r, :len(row)] = row, True
    return cols, mask, int(np.diff(csr.indptr).max())


def _jax_ids(method: str, s, csr, k):
    """JAX's ids for the port's ``method``: its accelerator branch, with
    the Pallas pipelines in interpret mode."""
    b, c = s.shape
    cols, mask, e = _padded_rows(csr)
    if method == "auto":
        method = ("full" if c <= 4096 or k >= c
                  else "peel" if peel_viable(c, k, e) else "scatter")
    if method == "peel" and not peel_viable(c, k, e):
        method = "scatter"
    tb = -(-b // 8) * 8
    args = (jnp.asarray(s), jnp.asarray(cols), jnp.asarray(mask), k)
    if method == "peel":
        return np.asarray(jpeel.peel_masked_topk_scores(
            *args, tb=tb, interpret=True, with_fallback=True)[1])
    if method == "pallas":
        return np.asarray(jwindow.pallas_masked_topk_scores(
            *args, tb=tb, interpret=True)[1])
    return np.asarray(jax_masked_topk(
        jnp.asarray(s), JaxCSR.from_scipy(csr),
        jnp.arange(b, dtype=jnp.int32), k, method=method)[1])


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", list(CASES))
def test_masked_topk_ids_equal_jax_on_ties(case, method):
    s, csr, k = CASES[case]()
    b = s.shape[0]
    ids = masked_topk(torch.as_tensor(s), DeviceCSR.from_scipy(csr, "cpu"),
                      torch.arange(b, dtype=torch.int32), k,
                      method=method)[1].numpy()
    want = _jax_ids(method, s, csr, k)
    np.testing.assert_array_equal(ids, want)
    # and lax.top_k's own order on these rows
    filled = np.where(csr.toarray() > 0, np.float32(-1e30), s)
    np.testing.assert_array_equal(
        ids, np.asarray(lax.top_k(jnp.asarray(filled), k)[1]))


@pytest.mark.parametrize("method", ["peel", "auto"])
@pytest.mark.parametrize("kind", HEAVY)
def test_peel_ids_equal_jax_on_heavy_ties(kind, method):
    """The peel where whole rows tie: its ids (or those of the rows it
    flags and redoes) are JAX's peel's, bit for bit."""
    s, csr, k = _heavy_ties(kind)
    b = s.shape[0]
    assert peel_viable(s.shape[1], k, int(np.diff(csr.indptr).max()))
    ids = masked_topk(torch.as_tensor(s), DeviceCSR.from_scipy(csr, "cpu"),
                      torch.arange(b, dtype=torch.int32), k,
                      method=method)[1].numpy()
    np.testing.assert_array_equal(ids, _jax_ids(method, s, csr, k))


def test_windowed_topk_keeps_jax_window_order_across_maxima():
    """Two 5s in windows whose maxima differ (5 and 9): both packages rank
    the 5 of the window with the larger maximum first, where ``lax.top_k``
    ranks the lower index first."""
    s = np.zeros((1, 512), np.float32)
    s[0, 0], s[0, 128], s[0, 129] = 5.0, 9.0, 5.0
    ids = windowed_topk(torch.as_tensor(s), 3)[1].numpy()
    np.testing.assert_array_equal(
        ids, np.asarray(jax_windowed_topk(jnp.asarray(s), 3)[1]))
    np.testing.assert_array_equal(ids, [[128, 129, 0]])
    np.testing.assert_array_equal(
        np.asarray(lax.top_k(jnp.asarray(s), 3)[1]), [[128, 0, 129]])


def _long_rows(kind: str):
    """Rows for `lax_topk` past its row limit: ``(x, k, max_n)``."""
    if kind == "beyond_MAX_N":  # two popularity rows, K13's own limit
        rng = np.random.default_rng(5)
        counts = np.minimum(rng.zipf(1.5, MAX_N + 1000), 50)
        x = np.tile(counts.astype(np.float32), (2, 1))
        x[1, rng.random(x.shape[1]) < 0.002] = np.float32(-1e30)
        return x, 100, MAX_N
    if kind == "maxima_differ":  # the window-order case at n = 4,096
        x = np.zeros((1, 4096), np.float32)
        x[0, 0], x[0, 128], x[0, 129] = 5.0, 9.0, 5.0
        return x, 3, 1024
    if kind in HEAVY:
        return _heavy_ties(kind)[0], 10, 2048
    s, _, _ = _tied_case(8, 16, seed=2)
    return s, 16, 2048


@pytest.mark.parametrize("kind", ["popularity", "maxima_differ",
                                  "beyond_MAX_N", *HEAVY])
def test_lax_topk_narrows_long_rows_in_lax_order(kind):
    """Beyond ``max_n`` values a row narrows to the top-k of its chunks of
    ``max_n`` values, in catalog order: values and ids equal
    ``lax.top_k``'s bit for bit."""
    x, k, max_n = _long_rows(kind)
    assert x.shape[1] > max_n
    v, i = lax_topk(torch.as_tensor(x), k, max_n)
    wv, wi = lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(v.numpy().view(np.int32),
                                  np.asarray(wv).view(np.int32))


def test_lax_topk_keeps_half_dtypes_and_refuses_what_it_cannot_narrow():
    """bf16 rows rank as f32 (exact) and come back as bf16; past the
    limit, rows with k * 128 or n / 128 above it, which 128-wide windows
    could not narrow and which once raised, give ``lax.top_k``'s values
    and ids (`tests/test_torch_topk_limits.py` holds them on more rows)."""
    x, k, _ = _long_rows("popularity")
    xb = torch.as_tensor(x).to(torch.bfloat16)
    v, i = lax_topk(xb, k, 2048)
    assert v.dtype == torch.bfloat16
    wv, wi = lax.top_k(jnp.asarray(xb.float().numpy()), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(v.float().numpy(), np.asarray(wv))
    for k, max_n in ((17, 2048), (1, 128)):
        v, i = lax_topk(torch.as_tensor(x), k, max_n)
        wv, wi = lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(v.numpy(), np.asarray(wv))
