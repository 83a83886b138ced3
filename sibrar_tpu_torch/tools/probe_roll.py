"""Lane moves by an offset computed on the device (port of
``tools/probe_roll.py``, a Mosaic capability probe), through kernel K16
(``ops/roll.py``).

Probes: ``roll`` (rotate [1, 256] left by a shift read from device memory),
``unaligned`` (a 128-lane slice of [1, 512] at the unaligned offset 37),
``segment`` (rows of 256 from a flat int32 [8192] at eight starts, read as
128-aligned runs and rotated). Each prints ``{"probe", "ok"}``, ``ok``
whether the result equals numpy's; an exception prints ``ok: false`` with
its text, as the JAX probe does.

    python -m sibrar_tpu_torch.tools.probe_roll {roll|unaligned|segment}

Left out: the JAX probe's ``enable_compilation_cache`` (a JAX-only
compilation cache).
"""
from __future__ import annotations

import json

import numpy as np
import torch

from sibrar_tpu_torch.ops import roll
from sibrar_tpu_torch.tools import _common

SEGMENT_STARTS = (5, 131, 1000, 2047, 300, 0, 7777, 4095)
SEGMENT_LEN, SEGMENT_N = 256, 8192


def probe_roll(device="cuda") -> bool:
    """`roll.roll_lanes` with a shift held in device memory."""
    x = torch.arange(256, dtype=torch.float32, device=device).reshape(1, 256)
    s = torch.tensor([37], dtype=torch.int32, device=device)
    out = roll.roll_lanes(x, s)
    ref = np.roll(np.arange(256, dtype=np.float32), -37)
    return bool(np.array_equal(out.cpu().numpy()[0], ref))


def probe_unaligned(device="cuda") -> bool:
    """`roll.lane_slice` at an offset with no alignment."""
    x = torch.arange(512, dtype=torch.float32, device=device).reshape(1, 512)
    s = torch.tensor([37], dtype=torch.int32, device=device)
    out = roll.lane_slice(x, s, 128)
    return bool(np.array_equal(out.cpu().numpy()[0],
                               np.arange(37, 165, dtype=np.float32)))


def probe_segment(device="cuda") -> bool:
    """`roll.segment_roll`: ``out[b, :L] = flat[start[b] : start[b] + L]``,
    the CSR row gather's pattern."""
    flat = torch.arange(SEGMENT_N, dtype=torch.int32, device=device)
    starts = torch.tensor(SEGMENT_STARTS, dtype=torch.int32, device=device)
    out = roll.segment_roll(flat, starts, SEGMENT_LEN)
    ref = np.stack([np.arange(s, s + SEGMENT_LEN) for s in SEGMENT_STARTS])
    return bool(np.array_equal(out.cpu().numpy(), ref))


PROBES = {"roll": probe_roll, "unaligned": probe_unaligned,
          "segment": probe_segment}


def main(argv=None) -> None:
    p = _common.parser(__doc__)
    p.add_argument("which", choices=tuple(PROBES))
    args = p.parse_args(argv)
    try:
        ok = PROBES[args.which](args.device)
        print(json.dumps({"probe": args.which, "ok": ok}))
    except Exception as e:  # the probe reports a refusal as its result
        print(json.dumps({"probe": args.which, "ok": False,
                          "error": f"{type(e).__name__}: {str(e)[:200]}"}))


if __name__ == "__main__":
    main()
