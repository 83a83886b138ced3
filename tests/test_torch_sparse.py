"""Parity of the port's CSR ops (``sibrar_tpu_torch/ops/sparse.py``) with the
JAX package's, on the CPU: gathers, masks and dense rows bit-equal.

The JAX segment-gather kernels run in Pallas interpret mode; the port's K1
takes its plain version (CPU tensors)."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sibrar_tpu.ops import sparse as jsparse
from sibrar_tpu_torch.ops import sparse as tsparse


def _csr(rng, n_rows, n_cols, lens):
    """Scipy CSR with the given per-row lengths (distinct sorted columns)."""
    rows, cols = [], []
    for r, n in enumerate(lens):
        rows += [r] * n
        cols += sorted(rng.choice(n_cols, size=n, replace=False).tolist())
    return sp.csr_matrix((np.ones(len(rows), np.int8), (rows, cols)),
                         shape=(n_rows, n_cols))


def _lens(rng, kind, n_rows):
    if kind == "empty_rows":  # every third row empty
        return [0 if r % 3 == 0 else int(rng.integers(1, 9))
                for r in range(n_rows)]
    if kind == "skewed":  # one row far longer than the rest
        lens = [int(rng.integers(0, 4)) for _ in range(n_rows)]
        lens[5] = 300
        return lens
    return [0] * n_rows  # nnz == 0


CASES = ["empty_rows", "skewed", "nnz0"]


@pytest.mark.parametrize("kind", CASES)
def test_csr_row_gather_matches_jax(kind):
    rng = np.random.default_rng(0)
    mat = _csr(rng, 40, 3000, _lens(rng, kind, 40))
    rows = rng.integers(0, 40, 23).astype(np.int32)
    jc, jm = jsparse.csr_row_gather(jsparse.DeviceCSR.from_scipy(mat),
                                    jnp.asarray(rows))
    tc, tm = tsparse.csr_row_gather(tsparse.DeviceCSR.from_scipy(mat, "cpu"),
                                    torch.as_tensor(rows))
    assert tc.dtype == torch.int32 and tm.dtype == torch.bool
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("kind", CASES)
@pytest.mark.parametrize("n_cols", [300, 3000])  # JAX compare / one-hot paths
def test_csr_rows_to_dense_matches_jax(kind, n_cols):
    rng = np.random.default_rng(1)
    lens = [min(n, 250) for n in _lens(rng, kind, 30)]
    mat = _csr(rng, 30, n_cols, lens)
    rows = rng.integers(0, 30, (4, 5)).astype(np.int32)  # 2-D row batch
    jd = jsparse.csr_rows_to_dense(jsparse.DeviceCSR.from_scipy(mat),
                                   jnp.asarray(rows))
    td = tsparse.csr_rows_to_dense(tsparse.DeviceCSR.from_scipy(mat, "cpu"),
                                   torch.as_tensor(rows))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(td.numpy(), mat[rows.reshape(-1)]
                                  .toarray().reshape(4, 5, n_cols))


@pytest.mark.parametrize("fill", [-1e30, float("-inf")])
def test_scatter_fill_rows_adds_fill_like_jax(fill):
    rng = np.random.default_rng(2)
    scores = rng.normal(size=(6, 50)).astype(np.float32)
    cols = np.stack([rng.choice(50, 7, replace=False) for _ in range(6)]
                    ).astype(np.int32)
    mask = rng.random((6, 7)) < 0.6
    cols[~mask] = 0  # the gather's padding convention
    js = jsparse.scatter_fill_rows(jnp.asarray(scores), jnp.asarray(cols),
                                   jnp.asarray(mask), n_cols=50, fill=fill)
    ts = tsparse.scatter_fill_rows(torch.as_tensor(scores),
                                   torch.as_tensor(cols),
                                   torch.as_tensor(mask), fill=fill)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("kernel", ["vmem", "dma"])
@pytest.mark.parametrize("kind", ["empty_rows", "skewed"])
def test_plain_segment_gather_matches_pallas_kernels(kernel, kind):
    """The port's K1 plain version against `_segment_gather` /
    `_segment_gather_dma` in interpret mode, inside each row's length (past
    it the JAX kernels read on into the next row and the wrapper masks)."""
    rng = np.random.default_rng(3)
    mat = _csr(rng, 40, 3000, _lens(rng, kind, 40))
    csr = tsparse.DeviceCSR.from_scipy(mat, "cpu")
    rows = rng.integers(0, 40, 16).astype(np.int32)
    length = csr.max_row_len
    fn = (jsparse._segment_gather if kernel == "vmem"
          else jsparse._segment_gather_dma)
    starts = mat.indptr[rows].astype(np.int32)
    jcols = np.asarray(fn(jnp.asarray(mat.indices.astype(np.int32)),
                          jnp.asarray(starts), length,
                          jsparse._next_pow2(length + 127), interpret=True))
    tcols, tmask = tsparse.segment_gather(csr.indptr, csr.indices,
                                          torch.as_tensor(rows), length)
    lens = np.diff(mat.indptr)[rows]
    live = np.arange(length)[None, :] < lens[:, None]
    np.testing.assert_array_equal(tmask.numpy(), live)
    np.testing.assert_array_equal(tcols.numpy()[live], jcols[live])
    assert (tcols.numpy()[~live] == 0).all()


def test_kernel_wrappers_refuse_devices_without_kernel_or_plain_version():
    t = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tsparse.segment_gather(t, t, t, 2)
    cpu = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="different devices"):
        tsparse.segment_gather(cpu, cpu, t, 2)
