"""Row-wise sparse Adam for large id-embedding tables (port of
``sibrar_tpu/train/row_adam.py``).

Dense Adam on an ``[n, d]`` table reads and writes the whole table and both
moment tables every step, for a batch that touches a few thousand rows.
This optimizer has ``torch.optim.SparseAdam``'s semantics:

- moments update only for the rows touched this step;
- bias correction uses the global step;
- duplicate row ids coalesce exactly: their gradients are summed and the
  row updates once.

The sum runs in a fixed order: a stable sort of the ids, then a run sum by
`ops.spmm.spmm_bwd` (kernel K7 on the card: each run summed in slot order,
no atomics; its plain version on the CPU adds in the same order, as JAX's
``segment_sum``), so two equal calls give the same bits. The forward side is
row injection (`models.layers.Embedding.rows`): the trainer gathers
``table[idxs]`` without autograd and differentiates with respect to the
rows, so no dense ``[n, d]`` gradient is built.

The JAX package returns new arrays; here the table and the moments are
updated in place, which saves a copy of each table per step.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from sibrar_tpu_torch.models.layers import Embedding
from sibrar_tpu_torch.ops.spmm import spmm_bwd


def row_adam_init(table: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Zero first and second moments, shaped like the table."""
    return {"mu": torch.zeros_like(table), "nu": torch.zeros_like(table)}


def coalesce_rows(idx: torch.Tensor, g: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sorted_idx [M], coalesced_g [M, d])``: ``idx`` sorted (stable),
    and each row of ``g`` replaced by the total of its id's run, so every
    occurrence of an id carries the same gradient and a scatter of the
    rows writes identical values."""
    order = torch.argsort(idx, stable=True)
    s_idx = idx[order]
    s_g = g[order]
    run_start = torch.ones_like(s_idx, dtype=torch.bool)
    run_start[1:] = s_idx[1:] != s_idx[:-1]
    run_id = (torch.cumsum(run_start, 0) - 1).to(torch.int32)  # [M] ranks
    cols = run_id.unsqueeze(1)
    tot = spmm_bwd(cols, torch.ones_like(cols, dtype=torch.bool),
                   s_g.contiguous(), s_idx.shape[0])
    return s_idx, tot[run_id.long()]


@torch.no_grad()
def row_adam_update(table: torch.Tensor, opt: Dict[str, torch.Tensor],
                    idx: torch.Tensor, g: torch.Tensor, step: int, *,
                    lr: float, b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8, wd: float = 0.0) -> None:
    """One SparseAdam step, in place, on the rows ``idx`` of ``table``
    (``idx`` may repeat ids; their gradients ``g`` coalesce). ``step`` is
    the global step after this update (1 on the first), for the bias
    correction, computed in f32 as JAX computes it. ``wd`` adds
    ``wd * row`` to the touched rows' gradients (torch's L2 decay;
    ``SparseAdam`` itself has none)."""
    d = table.shape[-1]
    idx = idx.reshape(-1).to(torch.int32)
    g = g.reshape(-1, d).to(table.dtype)
    s_idx, g_c = coalesce_rows(idx, g)
    rows = s_idx.long()
    p_rows = table[rows]
    if wd:
        g_c = g_c + wd * p_rows
    mu_rows = b1 * opt["mu"][rows] + (1.0 - b1) * g_c
    nu_rows = b2 * opt["nu"][rows] + (1.0 - b2) * g_c * g_c
    t = torch.tensor(float(step), dtype=torch.float32)
    bc1 = (1.0 - torch.tensor(b1, dtype=torch.float32) ** t).to(table.device)
    bc2 = (1.0 - torch.tensor(b2, dtype=torch.float32) ** t).to(table.device)
    new_rows = p_rows - lr * (mu_rows / bc1) / (
        torch.sqrt(nu_rows / bc2) + eps)
    table[rows] = new_rows
    opt["mu"][rows] = mu_rows
    opt["nu"][rows] = nu_rows


def find_sparse_tables(model: Any, min_rows: int) -> Dict[str, str]:
    """``{module_name: "user" | "item"}`` for every table the model names
    in its ``table_index_map`` that is an `Embedding` of at least
    ``min_rows`` rows and 8 columns (narrower tables, such as biases,
    stay with the dense optimizer).

    A declaring model promises that the named `Embedding` is called
    exactly once per train forward, with the user batch ``[B]`` (``"user"``)
    or the global item batch ``[B, 1 + n]`` (``"item"``); the injected rows'
    shape check catches a violation."""
    spec: Dict[str, str] = {}
    for name, src in (getattr(model, "table_index_map", None) or {}).items():
        if src not in ("user", "item"):
            raise ValueError(f"table_index_map[{name!r}] must be 'user' or "
                             f"'item', got {src!r}")
        table = getattr(model, name, None)
        if (isinstance(table, Embedding)
                and table.weight.shape[0] >= min_rows
                and table.weight.shape[1] >= 8):
            spec[name] = src
    return spec
