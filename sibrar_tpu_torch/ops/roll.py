"""Lane moves by an offset held in device memory (port of the Pallas kernels
of ``tools/probe_roll.py``).

Kernel K16 (``csrc/roll.cu``) reads its shift, start or row starts from
device memory itself, so the op that computes them and this one need no host
sync between them: the probe's "data-computed shift". It moves 4-byte
elements (f32 or int32) as bits.

- `roll_lanes` (``probe_roll``): ``out[r, i] = x[r, (i + s) mod n]``, i.e.
  ``np.roll(x, -s, axis=1)``, right at any width n (the TPU's roll is right
  only at power-of-two widths) and any int32 shift.
- `lane_slice` (``probe_unaligned``): ``out[r, j] = x[r, s + j]`` for ``j <
  width`` at an unaligned ``s``.
- `segment_roll` (``probe_segment``): ``out[b, j] = flat[starts[b] + j]``
  for ``j < length``, read as 128-aligned runs and rotated by ``starts[b] %
  128``.

Positions outside the source read as 0.
"""
from __future__ import annotations

import torch

from sibrar_tpu_torch.ops import _cuda


def _scalar(t: torch.Tensor, name: str) -> int:
    """The device address of the one int32 in ``t`` (any shape of one
    element: its data pointer is the value's)."""
    if t.dtype != torch.int32 or t.numel() != 1:
        raise ValueError(f"{name}: one int32 value, got {t.dtype} "
                         f"{tuple(t.shape)}")
    return t.data_ptr()


def _words(x: torch.Tensor, name: str) -> torch.Tensor:
    if x.element_size() != 4:
        raise ValueError(f"{name}: 4-byte elements only, got {x.dtype}")
    return x.contiguous()


def _take(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``x[..., pos]`` with positions outside ``[0, n)`` read as 0."""
    n = x.shape[-1]
    ok = (pos >= 0) & (pos < n)
    got = x[..., pos.clamp(0, max(n - 1, 0))]
    return torch.where(ok, got, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


# ---------------------------------------------------------------- roll_lanes
def roll_lanes_plain(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Plain version: ``torch.roll`` by ``-shift`` along dim 1."""
    return torch.roll(x, -int(shift.reshape(())), dims=1)


def roll_lanes(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """K16: ``x [R, n]`` rotated left by ``shift`` lanes, ``shift`` one
    int32 on the same device (any value; taken mod n)."""
    if x.ndim != 2 or x.shape[1] == 0:
        raise ValueError(f"roll_lanes: x must be [R, n > 0], got "
                         f"{tuple(x.shape)}")
    if not _cuda.use_kernel(x, shift):
        return roll_lanes_plain(x, shift)
    x, shift_ptr = _words(x, "roll_lanes"), _scalar(shift, "roll_lanes")
    rows, n = x.shape
    out = torch.empty_like(x)
    _cuda.launch("sibrar_roll_lanes", x.data_ptr(), shift_ptr, rows, n,
                 out.data_ptr())
    roll_lanes.launches += 1
    return out


roll_lanes.launches = 0


# ---------------------------------------------------------------- lane_slice
def lane_slice_plain(x: torch.Tensor, start: torch.Tensor,
                     width: int = 128) -> torch.Tensor:
    """Plain version: index arithmetic on ``start + arange(width)``."""
    pos = start.reshape(()).long() + torch.arange(width, device=x.device)
    return _take(x, pos)


def lane_slice(x: torch.Tensor, start: torch.Tensor,
               width: int = 128) -> torch.Tensor:
    """K16: ``x[:, s : s + width]`` of ``x [R, n]`` at the offset ``s`` held
    in the int32 ``start`` on the same device; lanes past either end are
    0."""
    if x.ndim != 2 or width < 0:
        raise ValueError(f"lane_slice: x must be [R, n] and width >= 0, got "
                         f"{tuple(x.shape)}, {width}")
    if not _cuda.use_kernel(x, start):
        return lane_slice_plain(x, start, width)
    x, start_ptr = _words(x, "lane_slice"), _scalar(start, "lane_slice")
    rows, n = x.shape
    out = x.new_empty(rows, width)
    _cuda.launch("sibrar_lane_slice", x.data_ptr(), start_ptr, rows, n, width,
                 out.data_ptr())
    lane_slice.launches += 1
    return out


lane_slice.launches = 0


# -------------------------------------------------------------- segment_roll
def segment_roll_plain(flat: torch.Tensor, starts: torch.Tensor,
                       length: int) -> torch.Tensor:
    """Plain version: index arithmetic on ``starts[:, None] +
    arange(length)``."""
    pos = (starts.long()[:, None]
           + torch.arange(length, device=flat.device))
    return _take(flat.reshape(-1), pos)


def segment_roll(flat: torch.Tensor, starts: torch.Tensor,
                 length: int) -> torch.Tensor:
    """K16: ``out [B, length]`` with ``out[b, j] = flat[starts[b] + j]``
    over the flattened ``flat`` (4-byte elements) and int32 ``starts [B]``;
    positions past either end read as 0."""
    if starts.ndim != 1 or length < 0:
        raise ValueError(f"segment_roll: starts must be [B] and length >= 0, "
                         f"got {tuple(starts.shape)}, {length}")
    if not _cuda.use_kernel(flat, starts):
        return segment_roll_plain(flat, starts, length)
    if starts.dtype != torch.int32:
        raise ValueError(f"segment_roll: int32 starts, got {starts.dtype}")
    flat, starts = _words(flat, "segment_roll"), starts.contiguous()
    n_rows = starts.shape[0]
    out = flat.new_empty(n_rows, length)
    _cuda.launch("sibrar_segment_roll", flat.data_ptr(), flat.numel(),
                 starts.data_ptr(), n_rows, length, out.data_ptr())
    segment_roll.launches += 1
    return out


segment_roll.launches = 0
