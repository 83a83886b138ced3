"""Time the score GEMM (K2, K14 ``full``), K5 ``dw_matmul``, K6
``spmm_fwd``, K7 ``spmm_bwd``, K4 ``peel_values``, K13 ``exact_topk``, K15
``score_bf16`` and K16 (``roll_lanes``, ``lane_slice``, ``segment_roll``)
as built from several kernel source trees, in turns on one card.

    python3 -m sibrar_tpu_torch.tools.compare_builds DIR [DIR ...]
        [--only NAME ...] [--sass]

Each DIR holds kernel sources laid out as ``sibrar_tpu_torch/csrc/`` (any
of ``dw_matmul.cu``, ``score_wmax.cu``, ``score_variants.cu``,
``spmm_onehot.cu``, ``peel_values.cu``, ``exact_topk.cu``,
``score_bf16.cu``, ``roll.cu`` with the headers they include, and
``error_string.cu``), for example the port's own ``csrc`` and an unpacked
older commit's. Each tree is built with the port's nvcc flags into its own
library under ``sibrar_tpu_torch/_build/``; its kernels are checked against
the plain versions (K2 and K14 within ``1e-5 (1 + max |s|)``, K5 within
``2 R eps |vec| . |g|`` per element, K6 within ``2 n eps`` times the sum of
the row's n |kernel rows| and the same bits on a second call, K4 equal with
NaN in the same places, K7 bit-equal to its plain version on the CPU and
the same bits on a second call, or, for a tree whose K7 sums with atomics
(no ``sibrar_spmm_bwd_workspace``), within ``2 n eps`` times the sum of the
column's n |g rows|, K13 bit-equal, K15 within ``D eps (|u~| @ |i~|^T)``
of the exact product of the bf16-rounded operands u~, i~ with maxima
bit-equal to those of its own scores, K16 bit-equal), then timed with CUDA
events at the main paths' shapes in the order DIR1, DIR2, ..., DIRn, DIRn,
..., DIR1, so a drift of the card's clock cancels in each tree's mean. One
PyTorch call for the same function is timed beside them where one exists.
Prints one JSON line: the card, then per kernel each tree's times; each build's registers and spills
(``-Xptxas -v``) go to stderr, and with ``--sass`` each kernel function's
static SASS instruction count by opcode (``cuobjdump -sass``) too.

K6's input is the train step's own batch: ``chip_smoke.py``'s SBNet over
``make_onion_scale_splits(seed=7)`` and its ``first_layer_rows`` (2,256 rows
of the item interaction CSR, L = 2,205), so the tool runs from the
repository's root. ``spmm_fwd_cut64`` is that batch with every row cut to
its first 64 live slots. K7 takes that batch with a random output
gradient; an older tree's K7, which adds into a zeroed gradient, is timed
with that zero-fill (``torch.Tensor.zero_``) inside its step, so both sides
write the whole gradient. K4's input is the serving path's: the windows of
the K2-shaped scores (B = 1,024, C = 100,352) with the 160 largest maxima,
163,840 rows, t = 8. K13's is those scores, k = 100. K15 runs at the
precision probe's B = 1,024, C = 501,760, D = 256 (an older tree without
``sibrar_score_bf16_workspace`` is called without the workspace), beside
``torch.mm(u~, i~^T, out_dtype=torch.float32)`` where this torch has that
overload (f32 scores of the rounded operands, no maxima); K16 at the roll
probes' shapes, beside ``torch.roll`` for ``roll_lanes``. Every kernel
launches through ``_cuda.current_stream()`` with its C function looked up
once, as the port's wrappers do.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from sibrar_tpu_torch import full_f32
from sibrar_tpu_torch.ops import _cuda
from sibrar_tpu_torch.tools._common import bf16_within, cuda_ms

F32_EPS = 2.0 ** -24
SOURCES = ("dw_matmul.cu", "score_wmax.cu", "score_variants.cu",
           "spmm_onehot.cu", "peel_values.cu", "exact_topk.cu",
           "score_bf16.cu", "roll.cu", "error_string.cu")
# an older tree's K7 (no workspace, adds into a zeroed gradient)
OLD_SPMM_BWD = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p,
                                                             ctypes.c_void_p]
# the main paths' shapes: K5 on the train step's item rows (R x C users x
# H), K2 at serving and validation width, K14 full at the probes' catalog
DW_SHAPE = (2256, 50_000, 512)
SCORE_SHAPE = (1024, 100_352, 256)
PROBE_C = 501_760
# one SASS instruction: its address, an optional predicate, the opcode
SASS_LINE = re.compile(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_]*)")


def sass_counts(obj: Path) -> dict:
    """Each kernel function of `obj`: its static SASS instructions by opcode
    (predicates and modifiers dropped)."""
    tool = Path(_cuda._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(obj)], capture_output=True,
                          text=True, check=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            fn = out.setdefault(m.group(1), collections.Counter())
            continue
        m = SASS_LINE.match(line)
        if m and fn is not None:
            fn[m.group(1)] += 1
    return out


def build_tree(tree: Path, sass: bool = False) -> ctypes.CDLL:
    """Compile the sources of `tree` (one nvcc each, in parallel) and link
    them into a library keyed by their bytes; returns it loaded. With
    `sass`, prints each kernel's SASS opcode counts to stderr."""
    srcs = [tree / s for s in SOURCES if (tree / s).exists()]
    headers = b"".join(h.read_bytes() for h in sorted(tree.glob("*.cuh")))
    key = hashlib.sha256(b"".join(s.read_bytes() for s in srcs) + headers
                         + " ".join(_cuda.NVCC_FLAGS).encode()).hexdigest()
    out = _cuda.BUILD_DIR / f"compare_{key[:16]}"
    out.mkdir(parents=True, exist_ok=True)
    objs = [out / f"{s.stem}.o" for s in srcs]
    log = _cuda._run([_cuda._start([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-c",
                                    str(s)], o)
                      for s, o in zip(srcs, objs) if not o.exists()])
    for line in log.splitlines():  # registers and spills, to stderr
        if any(w in line for w in ("Compiling entry", "Used", "spill",
                                   "Performance Loss")):
            print(f"{tree}: {line.strip()}", file=sys.stderr)
    for obj in objs if sass else ():
        for fn, ops in sass_counts(obj).items():
            top = ", ".join(f"{op} {n}" for op, n in ops.most_common(10))
            print(f"{tree}: {fn}: {sum(ops.values())} instructions; {top}",
                  file=sys.stderr)
    lib_path = out / "libcompare.so"
    if not lib_path.exists():
        _cuda._run([_cuda._start([_cuda._nvcc(), *_cuda.ARCH, "-shared",
                                  *map(str, objs)], lib_path)])
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _cuda._SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    if hasattr(lib, "sibrar_spmm_fwd_workspace"):
        lib.sibrar_spmm_fwd_workspace.restype = ctypes.c_longlong
    elif hasattr(lib, "sibrar_spmm_fwd"):  # older trees: no workspace
        lib.sibrar_spmm_fwd.argtypes = _cuda._SIGNATURES[
            "sibrar_spmm_fwd"][:-1]
    if hasattr(lib, "sibrar_spmm_bwd_workspace"):
        lib.sibrar_spmm_bwd_workspace.restype = ctypes.c_longlong
    elif hasattr(lib, "sibrar_spmm_bwd"):
        lib.sibrar_spmm_bwd.argtypes = OLD_SPMM_BWD
    if hasattr(lib, "sibrar_score_bf16_workspace"):
        lib.sibrar_score_bf16_workspace.restype = ctypes.c_longlong
    elif hasattr(lib, "sibrar_score_bf16"):  # older trees: no workspace
        lib.sibrar_score_bf16.argtypes = _cuda._SIGNATURES[
            "sibrar_score_bf16"][:-1]
    return lib


_FNS: dict = {}  # (library, entry) -> ctypes function


def call(lib, name: str, *args) -> None:
    fn = _FNS.get((id(lib), name))
    if fn is None:
        fn = _FNS[id(lib), name] = getattr(lib, name)
    err = fn(*args, _cuda.current_stream())
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def train_batch(dev):
    """The train step's item rows as ``chip_smoke.py`` draws them:
    ``(cols, mask, kernel)`` of the SBNet item interaction tower."""
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs
    from sibrar_tpu_torch.data.dataset import make_splits
    from sibrar_tpu_torch.data.synthetic import make_onion_scale_splits
    from sibrar_tpu_torch.models.sbnet import SingleBranchNet
    from sibrar_tpu_torch.ops.sparse import csr_row_gather

    train = make_splits(make_onion_scale_splits(seed=7))["train"]
    tdata = train.to_device(dev)
    model = SingleBranchNet.build_from_conf(cs.MODEL_CONF, train, tdata,
                                            seed=cs.SEED)
    item = model.item_module
    tower = item.modalities[item.modality_names.index("interactions")]
    _, rows = cs.first_layer_rows(tdata, model, torch.Generator(
        device=dev).manual_seed(cs.SEED + 2), train.n_items_in_split)
    cols, mask = csr_row_gather(tower.csr, rows)
    return cols, mask, tower.kernel.detach().contiguous()


def spmm_cases(dev) -> dict:
    """K6 on the train batch, whole and cut to 64 live slots per row; K7 on
    the whole batch."""
    import torch.nn.functional as F

    from sibrar_tpu_torch.ops import spmm

    cols, mask, kernel = train_batch(dev)
    out = spmm_bwd_case(dev, cols, mask, kernel.shape[0], kernel.shape[1])
    b, length = cols.shape
    h = kernel.shape[1]
    for name, m in (("spmm_fwd", mask),
                    ("spmm_fwd_cut64", mask & (mask.cumsum(1) <= 64))):
        res = torch.empty(b, h, device=dev)
        work = {}

        def step(lib, m=m, res=res, work=work):
            if not hasattr(lib, "sibrar_spmm_fwd_workspace"):
                call(lib, "sibrar_spmm_fwd", cols.data_ptr(), m.data_ptr(),
                     kernel.data_ptr(), b, length, h, res.data_ptr())
                return
            if id(lib) not in work:
                work[id(lib)] = torch.empty(
                    lib.sibrar_spmm_fwd_workspace(b, length, h),
                    dtype=torch.uint8, device=dev)
            call(lib, "sibrar_spmm_fwd", cols.data_ptr(), m.data_ptr(),
                 kernel.data_ptr(), b, length, h, res.data_ptr(),
                 work[id(lib)].data_ptr())

        def check(lib, step=step, m=m, res=res, name=name):
            step(lib)
            first = res.clone()
            step(lib)
            want = spmm.spmm_fwd_plain(cols, m, kernel)
            tol = (2 * m.sum(1, keepdim=True) * F32_EPS
                   * spmm.spmm_fwd_plain(cols, m, kernel.abs()))
            if not (torch.equal(first, res)
                    and bool(((res - want).abs() <= tol).all())):
                raise AssertionError(f"{name}: beyond the f32 sum bound or "
                                     "not the same bits on a second call")
        weights, cols64 = m.float(), cols.long()
        out[name] = ("sibrar_spmm_fwd", step, check, 20,
                     lambda cols64=cols64, weights=weights: F.embedding_bag(
                         cols64, kernel, mode="sum",
                         per_sample_weights=weights))
    return out


def spmm_bwd_case(dev, cols, mask, n_cols: int, h: int) -> dict:
    """K7 on the train batch with a random output gradient; an older tree's
    K7 is timed with its zero-fill."""
    from sibrar_tpu_torch.ops import spmm

    b, length = cols.shape
    g = torch.randn(b, h, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    dk = torch.empty(n_cols, h, device=dev)
    work = {}
    want = spmm.spmm_bwd_plain(cols.cpu(), mask.cpu(), g.cpu(), n_cols)

    def step(lib):
        if not hasattr(lib, "sibrar_spmm_bwd_workspace"):
            dk.zero_()
            call(lib, "sibrar_spmm_bwd", cols.data_ptr(), mask.data_ptr(),
                 g.data_ptr(), b, length, h, dk.data_ptr())
            return
        if id(lib) not in work:
            work[id(lib)] = torch.empty(
                lib.sibrar_spmm_bwd_workspace(b, length, n_cols),
                dtype=torch.uint8, device=dev)
        call(lib, "sibrar_spmm_bwd", cols.data_ptr(), mask.data_ptr(),
             g.data_ptr(), b, length, h, n_cols, dk.data_ptr(),
             work[id(lib)].data_ptr())

    def check(lib):
        step(lib)
        first = dk.clone()
        step(lib)
        got = dk.cpu()
        if hasattr(lib, "sibrar_spmm_bwd_workspace"):
            if not (torch.equal(first, dk) and torch.equal(
                    got.view(torch.int32), want.view(torch.int32))):
                raise AssertionError("spmm_bwd: not the plain version's "
                                     "bits, or not the same on a second call")
            return
        n = torch.bincount(cols[mask].long(), minlength=n_cols)[:, None]
        tol = 2 * n.cpu() * F32_EPS * spmm.spmm_bwd_plain(
            cols.cpu(), mask.cpu(), g.abs().cpu(), n_cols)
        if not bool(((got - want).abs() <= tol).all()):
            raise AssertionError("spmm_bwd: beyond the f32 sum bound")
    rows, _ = torch.nonzero(mask, as_tuple=True)
    dst = cols[mask].long()
    return {"spmm_bwd": ("sibrar_spmm_bwd", step, check, 20,
                         lambda: torch.zeros(n_cols, h, device=dev)
                         .index_add_(0, dst, g.index_select(0, rows)))}


def topk_case(dev, u, items) -> dict:
    """K13 on the K2-shaped scores, k = 100."""
    from sibrar_tpu_torch.ops import exact_topk

    x = (u @ items.T).contiguous()
    r, n, k = x.shape[0], x.shape[1], 100
    vals = torch.empty(r, k, device=dev)
    idx = torch.empty(r, k, dtype=torch.int64, device=dev)
    want_v, want_i = exact_topk.exact_topk_plain(x, k)

    def step(lib):
        call(lib, "sibrar_exact_topk", x.data_ptr(), r, n, k, vals.data_ptr(),
             idx.data_ptr())

    def check(lib):
        step(lib)
        if not (torch.equal(vals.view(torch.int32), want_v.view(torch.int32))
                and torch.equal(idx, want_i)):
            raise AssertionError("exact_topk differs from plain")
    return {"exact_topk": ("sibrar_exact_topk", step, check, 20,
                           lambda: torch.topk(x, k, dim=1))}


def peel_case(dev, u, items) -> dict:
    """K4 on the serving path's gathered windows."""
    from sibrar_tpu_torch.ops import peel

    b, t, m = u.shape[0], 8, 160
    scores = u @ items.T
    wmax = scores.view(b, -1, 128).amax(-1)
    widx = wmax.topk(m, dim=1).indices.sort(dim=1).values
    x = scores.view(b, -1, 128).gather(
        1, widx[:, :, None].expand(-1, -1, 128)).reshape(b * m, 128)
    del scores
    r = x.shape[0]
    vals = torch.empty(r, t, device=dev)
    last = torch.empty(r, device=dev)

    def step(lib):
        call(lib, "sibrar_peel_values", x.data_ptr(), r, t, vals.data_ptr(),
             last.data_ptr())

    def check(lib):
        step(lib)
        want, wlast = peel.peel_values_plain(x, t)
        if not (torch.equal(vals, want) and torch.equal(last, wlast)):
            raise AssertionError("peel_values differs from plain")
    return {"peel_values": ("sibrar_peel_values", step, check, 50, None)}


def bf16_case(dev, gen) -> dict:
    """K15 at the precision probe's shape, beside the library's bf16
    product with f32 output where this torch has it."""
    b, c, d = SCORE_SHAPE[0], PROBE_C, SCORE_SHAPE[2]
    u = torch.randn(b, d, device=dev, generator=gen)
    items = torch.randn(c, d, device=dev, generator=gen) / d ** 0.5
    s = torch.empty(b, c, device=dev)
    wmax_t = torch.empty(c // 128, b, device=dev)
    work = {}

    def step(lib):
        if not hasattr(lib, "sibrar_score_bf16_workspace"):
            call(lib, "sibrar_score_bf16", u.data_ptr(), items.data_ptr(), b,
                 c, d, s.data_ptr(), wmax_t.data_ptr())
            return
        if id(lib) not in work:
            work[id(lib)] = torch.empty(
                lib.sibrar_score_bf16_workspace(b, d), dtype=torch.uint8,
                device=dev)
        call(lib, "sibrar_score_bf16", u.data_ptr(), items.data_ptr(), b, c,
             d, s.data_ptr(), wmax_t.data_ptr(), work[id(lib)].data_ptr())

    def check(lib):
        step(lib)
        if not torch.equal(wmax_t, s.view(b, -1, 128).amax(-1).T):
            raise AssertionError("score_bf16: maxima not those of its "
                                 "scores")
        bf16_within("score_bf16", s, wmax_t, u, items)

    u16, i16 = u.bfloat16(), items.bfloat16()
    try:
        torch.mm(u16[:1], i16[:128].T, out_dtype=torch.float32)
        lib_call = (lambda: torch.mm(u16, i16.T, out_dtype=torch.float32))
    except (TypeError, RuntimeError, NotImplementedError) as e:
        print(f"torch.mm(..., out_dtype=torch.float32) not offered by torch "
              f"{torch.__version__}: {e}", file=sys.stderr)
        lib_call = None
    return {"score_bf16": ("sibrar_score_bf16", step, check, 10, lib_call)}


def roll_cases(dev) -> dict:
    """K16's three entries at the roll probes' shapes, bit-equal to their
    plain versions; ``torch.roll`` beside ``roll_lanes``."""
    from sibrar_tpu_torch.ops import roll
    from sibrar_tpu_torch.tools import probe_roll

    i32 = dict(dtype=torch.int32, device=dev)
    shift = torch.tensor([37], **i32)
    x = torch.arange(256, dtype=torch.float32, device=dev)[None]
    x512 = torch.arange(512, dtype=torch.float32, device=dev)[None]
    flat = torch.arange(probe_roll.SEGMENT_N, **i32)
    starts = torch.tensor(probe_roll.SEGMENT_STARTS, **i32)
    n = probe_roll.SEGMENT_LEN
    outs = {"roll_lanes": torch.empty_like(x),
            "lane_slice": torch.empty(1, 128, device=dev),
            "segment_roll": torch.empty(starts.numel(), n, **i32)}
    args = {"roll_lanes": (x, shift, 1, 256),  # tensors pass as pointers
            "lane_slice": (x512, shift, 1, 512, 128),
            "segment_roll": (flat, flat.numel(), starts, starts.numel(), n)}
    want = {"roll_lanes": roll.roll_lanes_plain(x, shift),
            "lane_slice": roll.lane_slice_plain(x512, shift),
            "segment_roll": roll.segment_roll_plain(flat, starts, n)}
    out = {}
    for name in outs:
        entry = f"sibrar_{name}"

        def step(lib, entry=entry, name=name):
            call(lib, entry, *(a.data_ptr() if torch.is_tensor(a) else a
                               for a in args[name]), outs[name].data_ptr())

        def check(lib, step=step, name=name):
            outs[name].fill_(-1)
            step(lib)
            if not torch.equal(outs[name].view(torch.int32),
                               want[name].view(torch.int32)):
                raise AssertionError(f"{name} differs from plain")
        out[name] = (entry, step, check, 100,
                     (lambda: torch.roll(x, -37, dims=1))
                     if name == "roll_lanes" else None)
    return out


def cases(dev, only=None) -> dict:
    """name -> (C entry, step(lib), check(lib), iters, library call): one
    input set per kernel, shared by every tree. ``check`` raises where the
    tree's kernel disagrees with the plain version. ``only`` names the
    kernels to build inputs for (all by default)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    want = set(only or ("dw_matmul", "score_wmax", "score_full", "spmm_fwd",
                        "spmm_fwd_cut64", "spmm_bwd", "peel_values",
                        "exact_topk", "score_bf16", "roll_lanes",
                        "lane_slice", "segment_roll"))
    if want & {"spmm_fwd", "spmm_fwd_cut64", "spmm_bwd"}:
        out.update(spmm_cases(dev))
    if "dw_matmul" in want:
        out.update(dw_case(dev, gen))
    b, _, d = SCORE_SHAPE
    u = torch.randn(b, d, device=dev, generator=gen)
    if want & {"score_wmax", "score_full"}:
        out.update(score_cases(dev, gen, u))
    if want & {"peel_values", "exact_topk"}:
        items = torch.randn(SCORE_SHAPE[1], d, device=dev,
                            generator=gen) / d ** 0.5
        out.update(peel_case(dev, u, items))
        out.update(topk_case(dev, u, items))
        del items
    if "score_bf16" in want:
        out.update(bf16_case(dev, gen))
    if want & {"roll_lanes", "lane_slice", "segment_roll"}:
        out.update(roll_cases(dev))
    return {k: v for k, v in out.items() if k in want}


def dw_case(dev, gen) -> dict:
    """K5 at the train step's shape."""
    out = {}
    r, n_cols, h = DW_SHAPE
    vec = (torch.rand(r, n_cols, device=dev, generator=gen) < 2.5e-4).float()
    g = torch.randn(r, h, device=dev, generator=gen)
    dw = torch.empty(n_cols, h, device=dev)

    def dw_step(lib):
        call(lib, "sibrar_dw_matmul", vec.data_ptr(), g.data_ptr(), r, n_cols,
             h, dw.data_ptr())

    def dw_check(lib):
        dw_step(lib)
        tol = 2 * r * F32_EPS * (vec.T @ g.abs())
        if not bool(((dw - vec.T @ g).abs() <= tol).all()):
            raise AssertionError("dw_matmul beyond the f32 GEMM bound")
    out["dw_matmul"] = ("sibrar_dw_matmul", dw_step, dw_check, 10,
                        lambda: torch.matmul(vec.T, g))
    return out


def score_cases(dev, gen, u) -> dict:
    """K2 at serving width and K14 ``full`` at the probes' catalog."""
    out = {}
    b, _, d = SCORE_SHAPE
    for name, entry, c in (("score_wmax", "sibrar_score_wmax",
                            SCORE_SHAPE[1]),
                           ("score_full", "sibrar_score_variant", PROBE_C)):
        items = torch.randn(c, d, device=dev, generator=gen) / d ** 0.5
        s = torch.empty(b, c, device=dev)
        wmax = torch.empty(c // 128 * b, device=dev)
        extra = () if entry == "sibrar_score_wmax" else (0,)  # 0: full

        def step(lib, items=items, s=s, wmax=wmax, c=c, entry=entry,
                 extra=extra):
            call(lib, entry, u.data_ptr(), items.data_ptr(), b, c, d, *extra,
                 s.data_ptr(), wmax.data_ptr())

        def check(lib, step=step, items=items, s=s, wmax=wmax, name=name):
            step(lib)
            ref = u @ items.T
            tol = 1e-5 * (1.0 + ref.abs().max().item())
            own = s.view(b, -1, 128).amax(-1)
            if name == "score_full":
                own = own.T
            if not ((s - ref).abs().max().item() <= tol
                    and torch.equal(wmax.view(own.shape), own)):
                raise AssertionError(f"{name}: scores beyond {tol} or "
                                     "maxima not those of its scores")
        out[name] = (entry, step, check, 20 if c < PROBE_C else 10,
                     lambda items=items: torch.matmul(u, items.T))
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trees", nargs="+", type=Path)
    p.add_argument("--only", nargs="+", default=None,
                   help="kernels to compare (default: all)")
    p.add_argument("--sass", action="store_true",
                   help="print each kernel's SASS opcode counts to stderr")
    args = p.parse_args(argv)
    full_f32()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    libs = [build_tree(t, args.sass) for t in args.trees]
    order = list(range(len(libs))) + list(reversed(range(len(libs))))
    result = {"card": card, "trees": [str(t) for t in args.trees],
              "order": order, "kernels": {}}
    for name, (entry, step, check, iters, lib_call) in cases(
            dev, args.only).items():
        have = [hasattr(lib, entry) for lib in libs]
        for tree, lib, ok in zip(args.trees, libs, have):
            if ok:
                check(lib)
        times = [[] for _ in libs]
        for i in order:
            if have[i]:
                times[i].append(cuda_ms(lambda: step(libs[i]), iters, dev))
        result["kernels"][name] = {
            "ms": times, "library_ms": None if lib_call is None
            else cuda_ms(lib_call, iters, dev)}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
