"""Exact top-k with per-user exclusion, dense (port of
``sibrar_tpu/ops/topk.py`` ``masked_topk``, ``method="full"``).

Scatter -1e30 into the excluded columns, then ``torch.topk``. It is the redo
for peel rows whose exactness flag tripped, and the oracle the tests and the
chip smoke compare the peel path with.
"""
from __future__ import annotations

import torch

from sibrar_tpu_torch.ops.sparse import (
    DeviceCSR,
    csr_row_gather,
    scatter_fill_rows,
)

NEG = -1e30


def topk_excluding(scores: torch.Tensor, cols: torch.Tensor,
                   mask: torch.Tensor, k: int, *, c_real: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``min(k, c_real)`` of each row of ``scores`` with ``cols[mask]``
    and the padded columns ``>= c_real`` set to -1e30."""
    c = scores.shape[1]
    c_real = c if c_real is None else c_real
    scores = scatter_fill_rows(scores, cols, mask, fill=NEG)
    if c_real < c:
        live = torch.arange(c, device=scores.device) < c_real
        scores = torch.where(live, scores, NEG)
    return torch.topk(scores, min(k, c_real), dim=1)


def masked_topk(scores: torch.Tensor, exclude_csr: DeviceCSR,
                u_idxs: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``scores[b]`` with user ``u_idxs[b]``'s CSR row excluded."""
    cols, mask = csr_row_gather(exclude_csr, u_idxs)
    return topk_excluding(scores, cols, mask, k)
