"""Device-side CSR utilities (port of ``sibrar_tpu/ops/sparse.py``).

The CSR arrays live on the device as int32 tensors. A batch of rows is
fetched with kernel K1 (`segment_gather`, ``csrc/segment_gather.cu``) and
everything else is plain tensor code around it. The JAX package's
``cols_pad`` materialization and its byte gates are not ported: they exist
only for TPU VMEM and HLO-literal limits.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from sibrar_tpu_torch.ops import _cuda
from sibrar_tpu_torch.utils import trace


@dataclass(frozen=True)
class DeviceCSR:
    """A CSR matrix resident on one device. Rows with no entries have
    start == end; indices are sorted within each row."""

    indptr: torch.Tensor  # [n_rows + 1] int32
    indices: torch.Tensor  # [nnz] int32
    n_rows: int
    n_cols: int
    max_row_len: int

    @staticmethod
    def from_scipy(mat, device="cuda") -> "DeviceCSR":
        csr = mat.tocsr()
        csr.sort_indices()
        row_lens = np.diff(csr.indptr)
        return DeviceCSR(
            indptr=torch.as_tensor(csr.indptr.astype(np.int32), device=device),
            indices=torch.as_tensor(csr.indices.astype(np.int32),
                                    device=device),
            n_rows=csr.shape[0], n_cols=csr.shape[1],
            max_row_len=int(row_lens.max()) if len(row_lens) else 0)

    @staticmethod
    def empty(n_rows: int, n_cols: int, device="cuda") -> "DeviceCSR":
        return DeviceCSR(
            indptr=torch.zeros(n_rows + 1, dtype=torch.int32, device=device),
            indices=torch.zeros(0, dtype=torch.int32, device=device),
            n_rows=n_rows, n_cols=n_cols, max_row_len=0)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])


# ------------------------------------------------------------------ kernel K1
def segment_gather_plain(indptr: torch.Tensor, indices: torch.Tensor,
                         rows: torch.Tensor, length: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: ``(cols [B, L] int32, mask [B, L] bool)`` with
    ``cols[b, j] = indices[indptr[rows[b]] + j]`` inside the row, 0 beyond."""
    rows = rows.long()
    starts = indptr[rows].long()
    ends = indptr[rows + 1].long()
    pos = starts[:, None] + torch.arange(length, device=rows.device)
    mask = pos < ends[:, None]
    pos = pos.clamp(max=max(indices.shape[0] - 1, 0))
    cols = torch.where(mask, indices[pos], 0).to(torch.int32)
    return cols, mask


def segment_gather(indptr: torch.Tensor, indices: torch.Tensor,
                   rows: torch.Tensor, length: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: the padded column ids of a 1-D batch of CSR rows (see
    ``csrc/segment_gather.cu``). ``indices`` must be non-empty."""
    if not _cuda.use_kernel(indptr, indices, rows):
        return segment_gather_plain(indptr, indices, rows, length)
    for name, t in (("indptr", indptr), ("indices", indices), ("rows", rows)):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.ndim != 1:
            raise ValueError(f"segment_gather: {name} must be contiguous 1-D "
                             f"int32, got {t.dtype} {tuple(t.shape)}")
    b = rows.shape[0]
    cols = torch.empty((b, length), dtype=torch.int32, device=rows.device)
    mask = torch.empty((b, length), dtype=torch.bool, device=rows.device)
    _cuda.launch("sibrar_segment_gather", indptr.data_ptr(),
                 indices.data_ptr(), rows.data_ptr(), b, length,
                 cols.data_ptr(), mask.data_ptr())
    segment_gather.launches += 1
    return cols, mask


segment_gather.launches = 0


# ------------------------------------------------------------ CSR row access
def csr_row_gather(csr: DeviceCSR, rows: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Padded column ids of ``rows``: ``(cols [..., L] int32, mask [..., L]
    bool)`` with ``L = max(max_row_len, 1)``; padded positions hold 0 and
    mask False (JAX ``csr_row_gather``)."""
    length = max(csr.max_row_len, 1)
    if csr.nnz == 0:  # e.g. an empty exclusion CSR
        shape = (*rows.shape, length)
        return (torch.zeros(shape, dtype=torch.int32, device=rows.device),
                torch.zeros(shape, dtype=torch.bool, device=rows.device))
    flat = rows.reshape(-1).to(torch.int32).contiguous()
    cols, mask = segment_gather(csr.indptr, csr.indices, flat, length)
    return (cols.reshape(*rows.shape, length),
            mask.reshape(*rows.shape, length))


def csr_rows_to_dense(csr: DeviceCSR, rows: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    """Dense 0/1 rows ``[..., n_cols]`` for a batch of row ids: the row
    gather, then a scatter into zeros (CSR rows hold distinct columns, and
    padded slots add 0 to column 0, so the sum is exactly the 0/1 row)."""
    cols, mask = csr_row_gather(csr, rows)
    cols2 = cols.reshape(-1, cols.shape[-1]).long()
    dense = torch.zeros((cols2.shape[0], csr.n_cols), dtype=dtype,
                        device=rows.device)
    dense.scatter_add_(1, cols2, mask.reshape(cols2.shape).to(dtype))
    return dense.reshape(*rows.shape, csr.n_cols)


# -------------------------------------------------------- membership tests
# Compare path up to this row length: the row fetch is K1 on every device,
# so the JAX package's TPU-only gate (Pallas fetch, else L <= 128) is just
# max_row_len <= 2048 here.
COMPARE_MAX_ROW_LEN = 2048


def csr_contains(csr: DeviceCSR, rows: torch.Tensor,
                 cols: torch.Tensor) -> torch.Tensor:
    """Is ``(rows[i], cols[i])`` a stored entry? Broadcasts; a fixed number
    of bisection steps over each row's sorted segment (JAX
    ``csr_contains``)."""
    rows_b, cols_b = torch.broadcast_tensors(rows, cols)
    if csr.nnz == 0:
        return torch.zeros(rows_b.shape, dtype=torch.bool,
                           device=rows_b.device)
    rflat = rows_b.reshape(-1).long()
    cflat = cols_b.reshape(-1).to(csr.indices.dtype)
    lo = csr.indptr[rflat].long()
    hi = csr.indptr[rflat + 1].long()
    ends = hi
    cap = csr.nnz - 1
    n_iters = max(math.ceil(math.log2(max(csr.max_row_len, 1) + 1)) + 1, 1)
    for _ in range(n_iters):
        mid = (lo + hi) // 2
        go_right = csr.indices[mid.clamp(max=cap)] < cflat
        keep = lo < hi
        lo, hi = (torch.where(keep & go_right, mid + 1, lo),
                  torch.where(keep & ~go_right, mid, hi))
    found = (lo < ends) & (csr.indices[lo.clamp(max=cap)] == cflat)
    return found.reshape(rows_b.shape)


def contains_rows_pregather(csr: DeviceCSR, rows: torch.Tensor):
    """The ``(row_cols, row_mask)`` row fetch of `csr_contains_rows`, or
    None where the bisection applies (empty CSR, or rows longer than
    `COMPARE_MAX_ROW_LEN`). Rejection loops call it once, outside the
    loop."""
    if csr.nnz == 0 or csr.max_row_len > COMPARE_MAX_ROW_LEN:
        return None
    return csr_row_gather(csr, rows)


def contains_pregathered(row_cols: torch.Tensor, row_mask: torch.Tensor,
                         cols: torch.Tensor) -> torch.Tensor:
    """Membership of ``cols[b, k]`` in pre-gathered row columns."""
    hit = cols.unsqueeze(-1) == row_cols.unsqueeze(-2)
    return (hit & row_mask.unsqueeze(-2)).any(-1)


def csr_contains_rows(csr: DeviceCSR, rows: torch.Tensor,
                      cols: torch.Tensor) -> torch.Tensor:
    """Membership of ``cols[b, k]`` in row ``rows[b]``: the compare path
    for short rows, the bisection for long ones."""
    if csr.nnz == 0:
        return torch.zeros((*rows.shape, cols.shape[-1]), dtype=torch.bool,
                           device=rows.device)
    pre = contains_rows_pregather(csr, rows)
    if pre is not None:
        return contains_pregathered(*pre, cols)
    return csr_contains(csr, rows.unsqueeze(-1), cols)


def scatter_fill_rows(scores: torch.Tensor, cols: torch.Tensor,
                      mask: torch.Tensor, fill: float = float("-inf")
                      ) -> torch.Tensor:
    """``scores[b, cols[b, j]] += fill`` where ``mask[b, j]`` (out of place).

    Like the JAX function this ADDS the fill: with ``fill = -1e30`` any
    realistic score becomes exactly -1e30. Padded slots add 0 to column 0."""
    safe = torch.where(mask, cols, 0).long()
    with trace.host_wait("sparse.scatter_fill"):  # the fill is copied
        fill_t = torch.tensor(fill, dtype=scores.dtype, device=scores.device)
    vals = torch.where(mask, fill_t, torch.zeros((), dtype=scores.dtype,
                                                 device=scores.device))
    return scores.scatter_add(1, safe, vals)
