#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sibrar_tpu_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a Hopper card (sm_90a), the
CUDA toolkit and PyTorch built for CUDA:

    python3 chip_smoke.py

It builds the hand-written kernels from ``sibrar_tpu_torch/csrc/`` (one
nvcc per source, in parallel) and, over onion-scale synthetic data (50,000
users x 100,352 items x 2M interactions) with SBNet at the widths of
``conf/single/sbnet_onion18_huge_no-user.yml`` (random weights from a seed):

1. checks each kernel against its plain PyTorch version on the card: K1-K4
   at the serving path's shapes, K5-K7 at the train step's (one real batch:
   512 pairs, 10 uniform negatives each, the 2,256 item rows that balanced
   routing sends to the interaction tower), K8, K9 and K3 on the window
   tiling at the validation paths' (B = 1,024, C = 100,352), and the
   windowed rankers' kernels at serving width (K10 ``score_windows`` and K12
   ``fused_score_wmax`` at B = 1,024, C = 100,352, D = 256, each bit-equal to
   K2's scores; K3 as ``gather_windows_rows`` and K11 ``recover_winners`` at
   the test split's m = 160 windows and k = 100 winners; the plane peel's
   corrected-wmax branch and its redo from the planes, bit-equal to the dot
   path's; K13 ``exact_topk`` over the [1,024, 100,352] scores, on short
   rows, at k = n, on all-ones NaN rows, on rows not 16-byte aligned, on
   NaN scores and on the rows of its exact path: constant, -inf, +-0.0,
   3,000 copies of the k-th value, k = n = 5,000), the score kernels off
   their tiles (K2, K10, K12 and every K14 variant at B = 1, 37 and 1,000
   and at D = 254, K2's bits), JAX's NaN rule in every maximum (a NaN item
   and a NaN user through K2, K10, K12, K14 and K15: NaN maxima where the
   plain versions have them; K8 and K9 on NaN lanes and signed zeros:
   their plain versions' bits), K15's bf16 rounding bit for bit (one-hot
   users over a depth of rounding ties, subnormals, +-inf and NaN), K5 off
   its tiles (R = 2,255, H = 500, C =
   50,000 and 49,999, within its f32 bound), K4 on edge rows (ties across
   lanes, +0.0 with -0.0, rows of only -inf, NaN rows, which peel NaN;
   t = 1, 8 and 128; R off its 32 rows per block) and K6 off the train
   batch (masks with holes and not packed left, empty rows, a row longer
   than any run, B = 1; H = 500, 511 and 512), and K6 twice on the train
   batch, bit for bit; K7 bit-equal to its plain version run on the CPU
   (JAX's order of the sums) on the train batch and on edge batches (B =
   1 and 2,255, no live slot, a column in every row once and three times,
   H = 500, 511 and 512, unhit rows +0.0), twice bit for bit; with times,
   bounds and library yardsticks;
2. trains with ``Trainer.train_epoch`` (the config's learn / dataset /
   loader settings): a warm-up, then a few hundred timed steps on the
   default first layer (densify + matmul, K5 backward), whose losses must be
   finite and fall; a profiled window; then a few dozen steps with
   ``INTERACTION_SPMM`` on (K6 / K7) and a profiled window of them;
3. times the item tower's first layer and the catalog encode both ways;
4. from the default training's weights, runs ``Trainer.fit`` (the YAML's
   learn / eval settings, 2 epochs of 60 steps, each validation over the
   50,000 users of the val split through the dot path) and checks that
   ``validate()`` afterwards returns fit's best metrics exactly; then, on
   fit's weights, validates once per ranking path (dot; scores with K8 and
   the peel; ``pallas`` with K9 and K3 on the tiling; ``full``), checks the
   key set and ranges of every metric dict, and holds sample batches' lists
   to the plain ``full`` path;
5. serves from the weights the default training left: catalog encode, then
   request batches at B = 256 and B = 1024 with k = 100. The lists are
   checked against the users' train + val history (scipy, on the host) and
   against the plain path on the same card (``torch.matmul`` + scatter +
   ``torch.topk``);
6. on the same weights, serves batches of 1,024 test users through the
   windowed rankers: ``peel.peel_masked_topk`` (K10, K3 on the planes, K4,
   K3), the same with ``peel.RECOVER_KERNEL`` (K11 instead of the last K3),
   ``window.pallas_masked_topk`` (K10, K3 on the tiling),
   ``score.fused_masked_topk`` (K12) and ``exact_topk`` over K2's scores
   after the exclusion fill (K13), and holds each list to the
   ``Recommender``'s for the same users: values bit-equal, ids equal up to
   exact ties, no excluded item; then profiles the plane peel's device time
   per batch with each winner recovery;
7. runs the ported ``tools/`` probes (``sibrar_tpu_torch/tools/``) at
   their full width: B = 1,024, C = 501,760, D = 256 on the probes'
   ``default_rng(1)`` draws. Each K14 epilogue variant
   (``ops/gemm_probe.py``) must hold K2's scores and maxima bit for bit in
   its layout, K15 (the bf16 pass) must stay within the f32 summation bound
   of the exact product of the bf16-rounded operands with the maxima of its
   own scores, there and off its tiles (B in 1, 63, 65, 1,000; D in 4, 12,
   100, 260; C in 128, 384, 100,352), K16 (lane moves by a device offset)
   and K17 (the masked fill) must equal their plain versions bit for bit
   (width 200, shifts past n, reads past the end, bool and int8 masks at
   [16, 168, 128] and [1024, 168, 128]); the launch path must use PyTorch's
   current stream inside and outside ``torch.cuda.stream(side)``; K16's
   device time per launch (profiler) and its events-loop time (also in
   turns with ``torch.roll``) are logged apart; then every mode of the
   three GEMM probes is timed through their ``run`` entry points (CUDA
   events; the bisect's kernels under ``torch.profiler``), the roll probes
   and ``try_mask`` must report ok, and ``try_recover`` must find K11
   bit-equal to plain at m = 168.

Each path (default training, spmm training, fit, the four validation
paths, serving, the five windowed rankers, the probes) runs with every
launch count set to 0 just before it and read just after; each of its
kernels must have launched, and kernels of other paths must not.

Output: progress lines, then one JSON line with a row per kernel, the card's
name and power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", ...}}``. Any failed check
raises, so the exit code is non-zero and no result line is printed. There is
no CPU mode: without a CUDA device it exits with code 1.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import time

# The resolved ``model:`` block of conf/single/sbnet_onion18_huge_no-user.yml
# (its base_configs chain folded in); a test holds it equal to the YAML.
MODEL_CONF = {
    "shared_common_dim": 256,
    "user": {
        "features": [],
        "embedding_dim": 256,
        "feature_name": "interactions",
        "single_branch_hidden_layers": [512, 256],
        "common_modality_dim": 512,
        "embedding_regularization_type": "pairwise_single",
        "regularization_weight": 0.5,
        "regularization_temperature": 0.2,
    },
    "item": {
        "features": [{"feature_name": "interactions"},
                     {"feature_name": "ivec256"},
                     {"feature_name": "bert"},
                     {"feature_name": "musicnn"},
                     {"feature_name": "genres"}],
        "single_branch_hidden_layers": [512, 512, 256, 256],
        "common_modality_dim": 512,
        "single_branch_input_dropout": 0.2,
        "embedding_regularization_type": "pairwise_single",
        "regularization_weight": 0.5,
        "regularization_temperature": 0.2,
        "normalize_single_branch_input": True,
        "apply_output_activation": True,
        "apply_batch_normalization": True,
        "apply_batch_norm_every": 2,
    },
}

# The resolved ``learn:`` and ``loader:`` blocks of the same file, and the
# sampling fields of its ``dataset:`` block; a test holds them to the YAML.
LEARN_CONF = {
    "n_epochs": 50, "lr": 5e-05, "wd": 0.001, "optimizer": "adamw",
    "rec_loss": "bpr", "loss_aggregator": "mean", "max_patience": 5,
    "optimizing_metric": "ndcg@10", "max_batches_per_epoch": None,
    "moment_dtype": None, "sparse_tables": False,
    "sparse_table_min_rows": 16384, "epoch_scan_chunk": 512,
}
DATASET_CONF = {"n_negative_samples": 10,
                "negative_sampling_strategy": "uniform",
                "popularity_squashing_factor": 1.0}
LOADER_CONF = {"batch_size": 512, "eval_batch_size": 1024, "num_workers": 0,
               "shuffle": True, "prefetch_factor": 2}
# The resolved ``eval:`` block of the same file; a test holds it to the YAML.
# Its group metrics need a ``gender`` user feature, which the onion-scale
# synthetic data lacks: the run drops them, as the CLI's onion-scale e2e
# test does (``eval.group_metrics=[]``).
EVAL_CONF = {"top_k": [1, 3, 5, 10, 20, 50, 100],
             "metrics": ["ndcg", "recall", "precision", "f_score", "hitrate",
                         "ap", "coverage"],
             "group_metrics": ["gender"], "compute_std": True,
             "topk_method": "auto", "score_dtype": None}

DEVICE = "cuda"
SEED = 0
K = 100
BATCHES = {256: 8, 1024: 4}  # batch size -> timed request batches
TRAIN_WARMUP = 20  # steps before the timed window
TRAIN_STEPS = 400  # timed steps on the default first layer
LOSS_WINDOW = 50  # steps in the first and last loss windows
PROFILE_STEPS = 10  # train steps under torch.profiler
PROFILE_BATCHES = 5  # request batches of each size under torch.profiler
SPMM_WARMUP, SPMM_STEPS = 5, 40  # steps with INTERACTION_SPMM on
FIT_EPOCHS, FIT_BATCHES = 2, 60  # Trainer.fit: epochs, steps per epoch
LIST_BATCHES = (0, 20, 48)  # validation batches whose lists are checked
RANKER_BATCHES = 3  # batches of 1,024 test users per windowed ranker
TURNS, TURN_ITERS = 7, 200  # rounds x calls of a host-bound events loop
F32_EPS = 2.0 ** -24
# H100 SXM peaks (NVIDIA data sheet; at 700 W): HBM bytes/s, f32 FLOP/s
# outside the tensor cores, dense bf16 FLOP/s on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` launches (CUDA
    events, after one warm-up call)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_turns(fns: dict, iters: int = TURN_ITERS,
                  rounds: int = TURNS) -> dict:
    """Per function of ``fns``: the median over ``rounds`` of its mean
    device milliseconds per call over ``iters`` calls (`cuda_ms`), the
    functions taking turns within each round."""
    import statistics

    got = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            got[name].append(cuda_ms(fn, iters))
    return {name: statistics.median(ms) for name, ms in got.items()}


def bound(n_bytes: float, n_ops: float = 0.0,
          flops: float = F32_FLOPS) -> dict:
    """The least time the card could take: the larger of the bytes moved
    over the HBM rate and the operations over their type's peak (f32 unless
    ``flops`` says otherwise)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / flops * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def exact(name: str, got, want) -> float:
    """0.0 when every tensor of ``got`` equals its twin in ``want``; raises
    otherwise."""
    import torch

    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    if not (err == 0 and all(torch.equal(g, w) for g, w in zip(got, want))):
        raise AssertionError(f"{name} differs from plain: max abs err {err}")
    return err


def max_abs_err(a, b) -> float:
    """Largest |a - b| over two same-shape tensors; equal entries (equal
    infinities included) count 0, a NaN anywhere reads as NaN."""
    import torch

    a, b = a.double(), b.double()
    if not a.numel():
        return 0.0
    return float(torch.where(a == b, 0.0, (a - b).abs()).max())


def check_kernels(data, dev, e_val: int) -> dict:
    """Each kernel against its plain version on the card, at the serving
    path's shapes (K1-K4) and the validation paths' (K8, K9, K3 on the
    tiling, K3 as the peel's winner-row gather; ``e_val`` is the val
    split's longest exclusion row); returns name -> {max_abs_err, ms,
    plain_ms, library_ms, bound_ms, bound_by}."""
    import torch

    from sibrar_tpu_torch.ops import peel, sparse, window

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows_out = {}

    # K1 on the item interaction CSR (one encode chunk) and the exclusion CSR
    errs, times = [], []
    for csr, b in ((data.item_inter_csr, 8192), (data.exclude_csr, 1024)):
        rows = torch.arange(b, dtype=torch.int32, device=dev)
        length = csr.max_row_len
        cols, mask = sparse.segment_gather(csr.indptr, csr.indices, rows,
                                           length)
        pcols, pmask = sparse.segment_gather_plain(csr.indptr, csr.indices,
                                                   rows, length)
        err = max(max_abs_err(cols, pcols), max_abs_err(mask, pmask))
        if not (err == 0 and torch.equal(cols, pcols)
                and torch.equal(mask, pmask)):
            raise AssertionError(f"K1 segment_gather differs at B={b}, "
                                 f"L={length}: max abs err {err}")
        errs.append(err)
        ms = cuda_ms(lambda: sparse.segment_gather(
            csr.indptr, csr.indices, rows, length), 50)
        pms = cuda_ms(lambda: sparse.segment_gather_plain(
            csr.indptr, csr.indices, rows, length), 50)
        times.append((ms, pms))
        log(f"K1 segment_gather B={b} L={length}: bit-equal; "
            f"kernel {ms:.4f} ms, plain {pms:.4f} ms")
    csr = data.item_inter_csr  # the timed shape: 8192 rows of the item CSR
    rows = torch.arange(8192, device=dev)
    live = int((csr.indptr[rows + 1] - csr.indptr[rows]).sum())
    n_bytes = 8192 * 4 * 3 + live * 4 + 8192 * csr.max_row_len * 5
    rows_out["segment_gather"] = dict(max_abs_err=max(errs),
                                      ms=times[0][0], plain_ms=times[0][1],
                                      library_ms=None, **bound(n_bytes))

    # K2 at B = 1024, C = 100,352, D = 256; scores of unit scale
    b, c, d = 1024, data.catalog.shape[0], 256
    u = torch.randn(b, d, device=dev, generator=gen)
    items = torch.randn(c, d, device=dev, generator=gen) / d ** 0.5
    scores, wmax = window.score_wmax(u, items)
    pscores, pwmax = window.score_wmax_plain(u, items)
    err = (scores - pscores).abs().max().item()
    tol = 1e-5 * (1.0 + pscores.abs().max().item())
    own = scores.view(b, -1, 128).amax(-1)
    if err > tol or not torch.equal(wmax, own):
        raise AssertionError(f"K2 score_wmax: max err {err} > {tol}, or "
                             "wmax is not the max of its own scores")
    ms = cuda_ms(lambda: window.score_wmax(u, items), 20)
    pms = cuda_ms(lambda: window.score_wmax_plain(u, items), 20)
    log(f"K2 score_wmax B={b} C={c} D={d}: max abs err {err:.3e} "
        f"(tol {tol:.3e}), wmax bit-equal to its scores; kernel {ms:.4f} ms, "
        f"plain {pms:.4f} ms ({2 * b * c * d / ms / 1e9:.2f} TFLOP/s)")
    rows_out["score_wmax"] = dict(
        max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None,
        **bound(4 * (b * d + c * d + b * c + b * c // 128), 2 * b * c * d))

    # K3 at B = 1024 and the path's window count (margin path: m = 160 at
    # E = 55), on the K2 scores with dead lanes masked, and its second use,
    # the winner rows of the gathered windows
    m, t = peel._round_m(K + data.exclude_csr.max_row_len, c // 128), 8
    widx = (peel._topk_stable(wmax, m)[1].sort(dim=1).values
            .to(torch.int32).contiguous())
    dead = torch.rand(b, m, 128, device=dev, generator=gen) < 0.02
    g = peel.gather_windows(scores, widx, dead)
    pg = peel.gather_windows_plain(scores, widx, dead)
    slots = torch.randint(0, m, (b, K), device=dev, generator=gen,
                          dtype=torch.int32)
    sub = peel.gather_subwindows(g, slots)
    psub = peel.gather_windows_plain(pg.reshape(b, -1), slots)
    err = max(max_abs_err(g, pg), max_abs_err(sub, psub))
    if not (err == 0 and torch.equal(g, pg) and torch.equal(sub, psub)):
        raise AssertionError(f"K3 gather_windows differs from plain: max abs "
                             f"err {err}")
    ms = cuda_ms(lambda: peel.gather_windows(scores, widx, dead), 50)
    pms = cuda_ms(lambda: peel.gather_windows_plain(scores, widx, dead), 50)
    # the library call for the TPU kernel's function (its dead mask is
    # applied apart): torch.gather on the [B, NW, 128] view
    view, lib_idx = scores.view(b, -1, 128), widx.long()[:, :, None].expand(
        -1, -1, 128)
    lms = cuda_ms(lambda: view.gather(1, lib_idx), 50)
    log(f"K3 gather_windows B={b} m={m}: bit-equal (also the k={K} winner "
        f"rows); kernel {ms:.4f} ms, plain {pms:.4f} ms, torch.gather on "
        f"the [B, NW, 128] view {lms:.4f} ms")
    rows_out["gather_windows"] = dict(
        max_abs_err=err, ms=ms, plain_ms=pms, library_ms=lms,
        **bound(b * m * (128 * 4 + 4 + 128 + 128 * 4)))

    # K4 at B = 1024, m = 160, t = 8
    x = g.reshape(b * m, 128)
    vals, last = peel.peel_values(x, t)
    pvals, plast = peel.peel_values_plain(x, t)
    err = max(max_abs_err(vals, pvals), max_abs_err(last, plast))
    if not (err == 0 and torch.equal(vals, pvals)
            and torch.equal(last, plast)):
        raise AssertionError(f"K4 peel_values differs from plain: max abs "
                             f"err {err}")
    ms = cuda_ms(lambda: peel.peel_values(x, t), 50)
    pms = cuda_ms(lambda: peel.peel_values_plain(x, t), 50)
    log(f"K4 peel_values B={b} m={m} t={t}: bit-equal; kernel {ms:.4f} ms, "
        f"plain {pms:.4f} ms")
    rows_out["peel_values"] = dict(
        max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None,
        **bound(b * m * (128 + t + 1) * 4))
    check_peel_edges(dev)
    rows_out.update(check_eval_kernels(scores, e_val))
    rows_out.update(check_ranker_kernels(u, items, scores, wmax, m))
    return rows_out


def same_values(a, b) -> bool:
    """Equal tensors, NaN in the same places (``torch.equal`` with NaN)."""
    import torch

    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb) and torch.equal(a[~na], b[~nb]))


def same_bits(a, b) -> bool:
    """f32 tensors with NaN in the same places and the same bits elsewhere
    (so +0.0 is not -0.0)."""
    import torch

    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb) and torch.equal(
        a[~na].view(torch.int32), b[~nb].view(torch.int32)))


def check_peel_edges(dev) -> None:
    """K4 against its plain version on edge rows: ties across lanes, a row
    of +0.0 and -0.0, rows of only -inf, rows with a NaN (NaN in every
    round, as JAX's max gives), t = 1, 8 and 128, and row counts that are
    no multiple of the 32 rows a block takes. Equal values with NaN in the
    same places; a tie of +0.0 with -0.0 may come out as either zero, as
    it does from ``torch.amax``."""
    import torch

    from sibrar_tpu_torch.ops import peel

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    for r in (1, 37, 1_005, 163_843):
        x = torch.randint(-6, 6, (r, 128), device=dev, generator=gen).float()
        x[torch.rand(r, 128, device=dev, generator=gen) < 0.05] = -math.inf
        x[r // 2] = torch.where(torch.arange(128, device=dev) % 2 == 0,
                                0.0, -0.0)
        if r > 1:
            x[r // 3] = -math.inf
            x[r - 1, 77] = math.nan
            x[r // 4, :64] = torch.randn(64, device=dev, generator=gen)
            x[r // 4, 5] = math.nan
        for t in (1, 8, 128):
            vals, last = peel.peel_values(x, t)
            pvals, plast = peel.peel_values_plain(x, t)
            if not (same_values(vals, pvals) and same_values(last, plast)):
                raise AssertionError(f"K4 peel_values differs from plain on "
                                     f"edge rows, R={r}, t={t}")
            if r > 1 and not bool(torch.isnan(vals[r - 1]).all()):
                raise AssertionError("K4: a NaN row must peel NaN")
    log("K4 peel_values edges (ties, +-0, -inf rows, NaN rows; t = 1, 8, "
        "128; R = 1, 37, 1,005, 163,843): equal to plain, NaN rows NaN")


def check_spmm_edges(kernel, dev) -> None:
    """K6 against its plain version off the train batch's shape: masks with
    holes and not packed left, rows with no live slot, a row longer than
    any run, B = 1, and H = 500, 511 (4-byte loads) and 512; each within
    the f32 sum bound ``2 n eps sum |kernel rows|`` per row."""
    import torch

    from sibrar_tpu_torch.ops import spmm

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    n_cols = kernel.shape[0]
    cases = []
    for b, length, p in ((64, 300, 0.3), (257, 2_205, 0.01), (1, 3_000, 0.5),
                         (1, 7, 0.0)):
        cols = torch.randint(0, n_cols, (b, length), device=dev,
                             generator=gen, dtype=torch.int32)
        mask = torch.rand(b, length, device=dev, generator=gen) < p
        if b > 1:
            mask[1] = False  # an empty row
            mask[b // 2] = True  # longer than any run of the batch
            mask[b // 2, ::7] = False  # with holes
        cases.append((f"B={b} L={length}", cols, mask))
    for label, cols, mask in cases:
        for h in (500, 511, 512):
            kh = kernel[:, :h].contiguous()
            got = spmm.spmm_fwd(cols, mask, kh)
            want = spmm.spmm_fwd_plain(cols, mask, kh)
            tol = (2 * mask.sum(1, keepdim=True) * F32_EPS
                   * spmm.spmm_fwd_plain(cols, mask, kh.abs()))
            if not bool(((got - want).abs() <= tol).all()):
                raise AssertionError(f"K6 spmm_fwd beyond the f32 sum bound "
                                     f"at {label} H={h}: max abs err "
                                     f"{max_abs_err(got, want)}")
    log("K6 spmm_fwd edges (holes, empty rows, a row longer than any run, "
        "B = 1; H = 500, 511 and 512): within the f32 sum bound")


def check_eval_kernels(scores, e_val: int) -> dict:
    """K8, K9 and K3 on the window tiling over the [1024, 100,352] scores
    (bit-equal to their plain versions), with the validation paths'
    window counts: the pallas path's m = k + E, the peel's winner rows at
    its rounded m."""
    import torch

    from sibrar_tpu_torch.ops import peel, window

    out = {}
    b, c = scores.shape
    nw = c // 128
    view = scores.view(b, nw, 128)

    # K8 window_max
    err = exact("K8 window_max", [peel.window_max(scores)],
                [peel.window_max_plain(scores)])
    out["window_max"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: peel.window_max(scores), 50),
        plain_ms=cuda_ms(lambda: peel.window_max_plain(scores), 50),
        library_ms=cuda_ms(lambda: view.amax(-1), 50),
        **bound(4 * (b * c + b * nw)))
    log(f"K8 window_max B={b} C={c}: bit-equal; {out['window_max']}")

    # K9 window_scores_from; the library yardstick is two calls
    sw_t, wmax = window.window_scores_from(scores)
    err = exact("K9 window_scores_from", [sw_t, wmax],
                window.window_scores_from_plain(scores))
    out["window_scores_from"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: window.window_scores_from(scores), 50),
        plain_ms=cuda_ms(lambda: window.window_scores_from_plain(scores),
                         50),
        library_ms=cuda_ms(lambda: (view.transpose(0, 1).contiguous(),
                                    view.amax(-1)), 50),
        **bound(4 * (2 * b * c + b * nw)))
    log(f"K9 window_scores_from B={b} C={c}: bit-equal (planes and maxima); "
        f"{out['window_scores_from']}")

    # K3 on the tiling at the pallas path's m = k + E
    m = min(K + e_val, nw)
    widx = peel._topk_stable(wmax, m)[1].to(torch.int32).contiguous()
    err = exact("K3 gather_windows_tiled",
                [window.gather_windows_tiled(sw_t, widx)],
                [window.gather_windows_tiled_plain(sw_t, widx)])
    perm = sw_t.permute(1, 0, 2)
    idx = widx.long()[:, :, None].expand(-1, -1, 128)
    out["gather_windows_tiled"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: window.gather_windows_tiled(sw_t, widx), 50),
        plain_ms=cuda_ms(lambda: window.gather_windows_tiled_plain(sw_t,
                                                                   widx), 50),
        library_ms=cuda_ms(lambda: perm.gather(1, idx), 50),
        **bound(b * m * (2 * 128 * 4 + 4)))
    log(f"K3 gather_windows_tiled B={b} m={m}: bit-equal; "
        f"{out['gather_windows_tiled']}")

    # K3 as gather_subwindows: the peel's k winner rows out of its m
    # gathered windows (m rounded up from k + E, no dead lanes)
    m = peel._round_m(K + e_val, nw)
    g = peel.gather_windows(scores, peel._topk_stable(wmax, m)[1].sort(
        dim=1).values.to(torch.int32).contiguous())
    slots = torch.randint(0, m, (b, K), device=scores.device,
                          dtype=torch.int32,
                          generator=torch.Generator(
                              device=scores.device).manual_seed(SEED))
    flat = g.reshape(b, -1)
    exact("K3 gather_subwindows", [peel.gather_subwindows(g, slots)],
          [peel.gather_windows_plain(flat, slots)])
    sub_idx = slots.long()[:, :, None].expand(-1, -1, 128)
    sub = dict(ms=cuda_ms(lambda: peel.gather_subwindows(g, slots), 50),
               plain_ms=cuda_ms(lambda: peel.gather_windows_plain(flat,
                                                                  slots), 50),
               library_ms=cuda_ms(lambda: g.gather(1, sub_idx), 50),
               **bound(b * K * (2 * 128 * 4 + 4)))
    log(f"K3 as gather_subwindows, g [{b}, {m} x 128], kk={K}: bit-equal; "
        f"{sub}")
    return out


def check_ranker_kernels(u, items, scores, wmax, m: int) -> dict:
    """K10, K3 as ``gather_windows_rows``, K11, K12 and K13 against their
    plain versions at serving width (``scores, wmax`` are K2's of ``u @
    items.T``, B = 1,024, C = 100,352, D = 256; ``m`` the test split's
    window count): K10's planes and K12's transposed scores bit-equal to
    K2's, both within K2's tolerance of their plain versions; the rest
    bit-equal to theirs."""
    import torch

    from sibrar_tpu_torch.ops import exact_topk as xtopk
    from sibrar_tpu_torch.ops import peel, score, window
    from sibrar_tpu_torch.tools import _common

    out = {}
    dev = scores.device
    b, c = scores.shape
    d = u.shape[1]
    nw = c // 128
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    flops = 2 * b * c * d

    def near(name, got, want):
        err = max_abs_err(got, want)
        tol = 1e-5 * (1.0 + want.abs().max().item())
        if not err <= tol:
            raise AssertionError(f"{name}: max err {err} > {tol}")
        return err

    # K10: K2's scores as window planes, bit for bit
    sw_t, wmax10 = window.score_windows(u, items)
    if not (torch.equal(sw_t, scores.view(b, nw, 128).transpose(0, 1))
            and torch.equal(wmax10, wmax)):
        raise AssertionError("K10 score_windows is not K2's scores and "
                             "maxima bit for bit")
    psw, pwmax = window.score_windows_plain(u, items)
    out["score_windows"] = dict(
        max_abs_err=max(near("K10 score_windows", sw_t, psw),
                        near("K10 maxima", wmax10, pwmax)),
        ms=cuda_ms(lambda: window.score_windows(u, items), 20),
        plain_ms=cuda_ms(lambda: window.score_windows_plain(u, items), 20),
        library_ms=None,
        **bound(4 * (b * d + c * d + b * c + b * nw), flops))
    log(f"K10 score_windows B={b} C={c} D={d}: planes and maxima bit-equal "
        f"to K2's; {out['score_windows']}")
    del psw, pwmax

    # K3 as gather_windows_rows: the margin path's m windows off the planes,
    # 2 % of the lanes dead
    widx = (peel._topk_stable(wmax, m)[1].sort(dim=1).values
            .to(torch.int32).contiguous())
    dead = torch.rand(b, m, 128, device=dev, generator=gen) < 0.02
    g = peel.gather_windows_rows(sw_t, widx, dead)
    perm = sw_t.permute(1, 0, 2)
    lib_idx = widx.long()[:, :, None].expand(-1, -1, 128)
    out["gather_windows_rows"] = dict(
        max_abs_err=exact("K3 gather_windows_rows", [g],
                          [window.gather_windows_tiled_plain(sw_t, widx,
                                                             dead)]),
        ms=cuda_ms(lambda: peel.gather_windows_rows(sw_t, widx, dead), 50),
        plain_ms=cuda_ms(lambda: window.gather_windows_tiled_plain(
            sw_t, widx, dead), 50),
        library_ms=cuda_ms(lambda: perm.gather(1, lib_idx), 50),
        **bound(b * m * (2 * 128 * 4 + 128 + 4)))
    log(f"K3 as gather_windows_rows B={b} m={m}, dead lanes on copy: "
        f"bit-equal; {out['gather_windows_rows']}")

    # K11: K winners per user, their values planted from random lanes of
    # random slots (so every one hits), one row of values that miss
    slots = torch.randint(0, m, (b, K), device=dev, generator=gen,
                          dtype=torch.int32)
    lanes = torch.randint(0, 128, (b, K), device=dev, generator=gen)
    v = g.reshape(b, -1).gather(1, slots.long() * 128 + lanes)
    v[0] = float("nan")
    got = peel.recover_winners(g, widx, slots, v)
    out["recover_winners"] = dict(
        max_abs_err=exact("K11 recover_winners", got,
                          peel.recover_winners_plain(g, widx, slots, v)),
        ms=cuda_ms(lambda: peel.recover_winners(g, widx, slots, v), 50),
        plain_ms=cuda_ms(lambda: peel.recover_winners_plain(g, widx, slots,
                                                            v), 50),
        library_ms=None,
        **bound(b * K * (128 * 4 + 4 + 4 + 4 + 3 * 4)))
    device = _common.device_ops_ms(
        lambda: peel.recover_winners(g, widx, slots, v), dev, 50,
        "recover_winners")
    log(f"K11 recover_winners B={b} m={m} kk={K}: bit-equal (lanes, counts "
        f"up to {int(got[1].max())}, windows); device time per launch "
        f"(profiler) {device}; {out['recover_winners']}")
    del g, dead, sw_t
    check_plane_peel(u, items, gen)
    check_score_edges(items, gen)
    check_nan_maxima(items, gen)

    # K12 at window 64 (the JAX default); every other window it admits
    # checked for the maxima of its own scores
    st, wt = score.fused_score_wmax(u, items, window=64)
    if not torch.equal(st, scores.T):
        raise AssertionError("K12 fused_score_wmax is not K2's scores "
                             "transposed bit for bit")
    for win in (8, 16, 32, 64, 128, 256, 512):
        s_w, w_w = score.fused_score_wmax(u, items, window=win)
        if not (torch.equal(s_w, st)
                and torch.equal(w_w, st.view(c // win, win, b).amax(1))):
            raise AssertionError(f"K12 window {win}: maxima differ from "
                                 "those of its scores")
    del s_w, w_w
    pst, pwt = score.fused_score_wmax_plain(u, items, 64)
    out["fused_score_wmax"] = dict(
        max_abs_err=max(near("K12 fused_score_wmax", st, pst),
                        near("K12 maxima", wt, pwt)),
        ms=cuda_ms(lambda: score.fused_score_wmax(u, items, window=64), 20),
        plain_ms=cuda_ms(lambda: score.fused_score_wmax_plain(u, items, 64),
                         20),
        library_ms=None,
        **bound(4 * (b * d + c * d + c * b + c // 64 * b), flops))
    log(f"K12 fused_score_wmax B={b} C={c} D={d} window 64: scores bit-equal "
        f"to K2's transposed, maxima of windows 8-512 bit-equal to their "
        f"scores'; {out['fused_score_wmax']}")
    del st, wt, pst, pwt

    # K13 over the K2 scores; on rows with fewer than k values above -inf
    # (+0.0 and -0.0 among them); where JAX hands the row to lax.top_k (n
    # below its min_n = 8,192, k = n); at k = n on rows where the NaN of
    # all ones (key 0) outlasts the other lanes; on rows of n = 100,001 and
    # 1,001 (rows not 16-byte aligned); on rows with a NaN score; and on rows
    # whose threshold passes more than the kernel's 2,048 buffered elements,
    # its exact path: constant rows, rows of -inf, 3,000 copies of the k-th
    # value over many windows, k = n = 5,000 (batches of 2,048). Values are
    # compared as bits (NaN != NaN).
    short = torch.full((8, c), float("-inf"), device=dev)
    short[:, [130, 5, 7]] = torch.tensor([3.0, 0.0, -0.0], device=dev)
    narrow = torch.randn(8, 1000, device=dev, generator=gen)
    nan_rows = torch.randn(4, 300, device=dev, generator=gen)
    bits = nan_rows.view(torch.int32)
    bits[0, 200:], bits[1, ::3], bits[2] = -1, -1, -1  # 0xFFFFFFFF
    odd = torch.randn(9, 1001, device=dev, generator=gen)
    odd_wide = torch.randn(4, 100_001, device=dev, generator=gen)
    nan_scores = scores[:8].clone()
    nan_scores[0, 777], nan_scores[1, ::5000] = math.nan, math.nan
    nan_scores[2] = math.nan
    flat = torch.full((4, c), 1.5, device=dev)
    flat[1] = float("-inf")
    flat[2] = -0.0
    flat[3, ::2] = 0.0
    copies = torch.randn(4, c, device=dev, generator=gen) - 10.0
    for r in range(4):
        pos = torch.randperm(c, device=dev, generator=gen)
        copies[r, pos[:3_000]] = 2.0
        copies[r, pos[3_000:3_000 + K // 2]] = 5.0
    wide_k = torch.randn(3, 5_000, device=dev, generator=gen)
    for rows, k, exact_path in (
            (scores, K, False), (short, K, True), (narrow, K, False),
            (narrow, 1000, False), (nan_rows, 300, False),
            (odd_wide, K, False), (odd, 1001, False), (nan_scores, K, False),
            (flat, K, True),
            (copies, K, True), (wide_k, 5_000, True)):
        gv, gi = xtopk.exact_topk(rows, k)
        pv, pi = xtopk.exact_topk_plain(rows, k)
        exact(f"K13 exact_topk [{rows.shape[0]}, {rows.shape[1]}] k={k}",
              [gv.view(torch.int32), gi], [pv.view(torch.int32), pi])
        if not all(len(set(r)) == k for r in gi.tolist()):
            raise AssertionError("K13 exact_topk repeated an index")
        if exact_path and not bool((topk_passing(rows, k) > 2_048).all()):
            raise AssertionError("K13 edge rows meant for the exact path "
                                 "pass too few elements")
    out["exact_topk"] = dict(
        max_abs_err=max_abs_err(xtopk.exact_topk(scores, K)[0],
                                xtopk.exact_topk_plain(scores, K)[0]),
        ms=cuda_ms(lambda: xtopk.exact_topk(scores, K), 20),
        plain_ms=cuda_ms(lambda: xtopk.exact_topk_plain(scores, K), 5),
        library_ms=cuda_ms(lambda: torch.topk(scores, K, dim=1), 20),
        **bound(4 * b * c + 12 * b * K))
    log(f"K13 exact_topk [{b}, {c}] k={K}: bit-equal values and indices "
        f"(also on rows with 3 live values, on [8, 1000] at k = {K} and k = "
        f"n, on [4, 300] rows of all-ones NaN at k = n, on [4, 100,001] "
        f"and [9, 1,001] rows, "
        f"on rows with NaN scores, and on the exact path's rows: constant, "
        f"-inf, +-0.0, 3,000 copies of the k-th value, k = n = 5,000); "
        f"{out['exact_topk']}")
    return out


def topk_passing(rows, k: int):
    """Per row, the elements K13's threshold passes: those whose total-order
    key is at least the k-th largest 128-window maximum key (windows from
    a 16-byte aligned row start; every element when k exceeds the
    windows). More than 2,048 sends the row to the kernel's exact path."""
    import torch
    import torch.nn.functional as F

    b, n = rows.shape
    bits = rows.contiguous().view(torch.int32)
    keys = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    low = torch.iinfo(torch.int64).min
    wkey = F.pad(keys, (0, -n % 128), value=low).view(b, -1, 128).amax(-1)
    if k > wkey.shape[1]:
        return torch.full((b,), n, device=rows.device)
    t = wkey.topk(k, dim=1).values[:, -1:]
    return (keys >= t).sum(1)


def check_nan_maxima(items, gen) -> None:
    """JAX's NaN rule in every maximum-producing kernel: a NaN item (one
    catalog row) and a NaN user (one ``u`` row) at B = 37, C = 8,192. K2,
    K12 (window 64) and K15 give NaN maxima exactly where their plain
    versions do (the item's window for every user, every window of the
    user), each the maxima of its own scores; K10, K12 and the six K14
    variants hold K2's bits, NaN included. K8 and K9 over a score matrix
    with NaN lanes, windows of +0.0 and -0.0 in several orders and windows
    of -inf: their plain versions' bits (JAX's max: +0.0 where a +0.0 is
    among the zeros) with NaN in the same places."""
    import torch

    from sibrar_tpu_torch.ops import gemm_probe, peel, score, window

    def bits(x):
        return x.contiguous().view(torch.int32)

    def nan_like_plain(name, got, want, own):
        if not (torch.equal(torch.isnan(got), torch.isnan(want))
                and same_values(got, own)):
            raise AssertionError(f"{name}: NaN maxima not where its plain "
                                 "version's are, or maxima not its scores'")

    dev = items.device
    b, c = 37, 8_192
    nw = c // 128
    it = items[:c].clone()
    it[300, 5] = math.nan  # window 2 of every user
    u = torch.randn(b, it.shape[1], device=dev, generator=gen)
    u[3, 7] = math.nan  # every window of user 3
    s, wm = window.score_wmax(u, it)
    want = torch.zeros(b, nw, dtype=torch.bool, device=dev)
    want[:, 2], want[3] = True, True
    if not torch.equal(torch.isnan(wm), want):
        raise AssertionError("K2: NaN maxima not at the NaN item's window "
                             "and the NaN user's row")
    nan_like_plain("K2", wm, window.score_wmax_plain(u, it)[1],
                   s.view(b, nw, 128).amax(-1))
    sw, wm10 = window.score_windows(u, it)
    if not (torch.equal(bits(sw), bits(s.view(b, nw, 128).transpose(0, 1)))
            and torch.equal(bits(wm10), bits(wm))):
        raise AssertionError("K10 with NaN: not K2's bits")
    st, wt = score.fused_score_wmax(u, it, window=64)
    if not torch.equal(bits(st), bits(s.T)):
        raise AssertionError("K12 with NaN: scores not K2's bits")
    nan_like_plain("K12", wt, score.fused_score_wmax_plain(u, it, 64)[1],
                   st.view(c // 64, 64, b).amax(1))
    for variant, fn in gemm_probe.VARIANTS.items():
        got = fn(u, it)
        ref = gemm_probe.variant_outputs(variant, s, wm)
        if not all(g.shape == w.shape and torch.equal(bits(g), bits(w))
                   for g, w in zip(got, ref)):
            raise AssertionError(f"K14 {variant} with NaN: not K2's bits")
    s15, w15 = gemm_probe.score_bf16(u, it)
    nan_like_plain("K15", w15, gemm_probe.score_bf16_plain(u, it)[1],
                   s15.view(b, nw, 128).amax(-1).T)

    x = torch.randn(64, c, device=dev, generator=gen)
    x[5, 130] = math.nan
    x[9, ::1000] = math.nan
    x[11, :128] = torch.where(torch.arange(128, device=dev) % 2 == 0, 0.0,
                              -0.0)
    x[12, 128:256] = -0.0
    x[13, 256:384] = float("-inf")
    x[14, 384:512] = -torch.rand(128, device=dev, generator=gen)
    x[14, 400], x[14, 401] = -0.0, 0.0
    for r, p in ((15, 0), (16, 77), (17, 127)):  # one +0.0 among -0.0
        x[r, :128] = -0.0
        x[r, p] = 0.0
        x[r + 3, :128] = 0.0  # one -0.0 among +0.0
        x[r + 3, p] = -0.0
    w8 = peel.window_max(x)
    sw9, w9 = window.window_scores_from(x)
    psw9, pw9 = window.window_scores_from_plain(x)
    if not (same_bits(w8, peel.window_max_plain(x)) and same_bits(w9, pw9)
            and torch.equal(bits(sw9), bits(psw9))):
        raise AssertionError("K8 / K9 with NaN lanes and signed zeros: not "
                             "their plain versions' bits with NaN in the "
                             "same places")
    if not (bool(torch.isnan(w8[5, 1])) and int(torch.isnan(w8[9]).sum())
            == len(range(0, c, 1000))
            and bits(w8[[11, 15, 16, 17, 18, 19, 20], 0]).eq(0).all()
            and int(bits(w8[12:13, 1])[0]) == -2**31  # -0.0 alone
            and int(bits(w8[14:15, 3])[0]) == 0):
        raise AssertionError("K8: NaN or signed-zero windows wrong")
    log(f"NaN maxima (B = {b}, C = {c}; a NaN item and a NaN user): K2, K12 "
        f"and K15 NaN where their plain versions are, K10, K12 and the six "
        f"K14 variants K2's bits; K8 / K9 with NaN lanes, +-0.0 and -inf "
        f"windows: their plain versions' bits, +0.0 where +0.0 is present")
    check_bf16_rounding(dev, gen)


def check_bf16_rounding(dev, gen) -> None:
    """K15's rounding bit for bit: every row of ``u`` is 1.0 at depth d0 and
    0 elsewhere, so its scores are ``items.bfloat16().float()[:, d0]``.
    Depth d0 of the items holds rounding ties (both directions), values just
    off a tie, subnormals (f32 ones that round to bf16 subnormals, to the
    smallest normal and to zero), +-inf and NaN; every other depth stays
    finite, so no 0 * inf arises. Zeros compare by value, NaN by place."""
    import torch

    from sibrar_tpu_torch.ops import gemm_probe

    b, c, d, d0 = 65, 384, 100, 37
    special = torch.tensor(
        [1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -(1.0 + 2.0 ** -8),
         1.0 + 2.0 ** -8 + 2.0 ** -20, 2.0 ** -130, 3 * 2.0 ** -134,
         2.0 ** -126 - 2.0 ** -149, -(2.0 ** -140), 2.0 ** -149, 2.0 ** -135,
         math.inf, -math.inf, math.nan, 0.0, -0.0, 3.0e38, -3.4e38],
        device=dev)
    items = torch.randn(c, d, device=dev, generator=gen)
    col = torch.randn(c, device=dev, generator=gen)
    col[:special.numel()] = special
    col[c - special.numel():] = special.flip(0)
    items[:, d0] = col
    u = torch.zeros(b, d, device=dev)
    u[:, d0] = 1.0
    s, wmax_t = gemm_probe.score_bf16(u, items)
    want = items.bfloat16().float()[:, d0].expand(b, c)
    if not same_values(s, want):
        raise AssertionError("K15 one-hot rows: scores are not the items' "
                             "bf16 rounding at d0")
    own = s.view(b, c // 128, 128).amax(-1).T
    if not same_values(wmax_t, own):
        raise AssertionError("K15 one-hot rows: maxima not those of its "
                             "scores")
    log(f"K15 rounding (B = {b}, C = {c}, D = {d}, one-hot u at d{d0}): "
        f"ties, subnormals, +-inf and NaN as torch's bf16 rounding, NaN in "
        f"the same places")


def check_score_edges(items, gen) -> None:
    """The score kernels off their tiles: K2, K10, K12 (windows 64 and 512)
    and the six K14 variants at ragged B (1, 37 and 1,000 users, D = 256;
    and 37 users at D = 254, where the main loop loads 4-byte words) over
    ``items``' C rows. K2 within ``1e-5 (1 + max |s|)`` of the plain
    product, its maxima those of its scores; every other kernel K2's bits in
    its layout."""
    import torch

    from sibrar_tpu_torch.ops import gemm_probe, score, window

    dev = items.device
    c = items.shape[0]
    nw = c // 128
    for b, d in ((1, 256), (37, 256), (1000, 256), (37, 254)):
        u = torch.randn(b, d, device=dev, generator=gen)
        it = items[:, :d].contiguous()
        s, wm = window.score_wmax(u, it)
        ps = u @ it.T
        err = max_abs_err(s, ps)
        tol = 1e-5 * (1.0 + ps.abs().max().item())
        if not (err <= tol and torch.equal(wm, s.view(b, nw, 128).amax(-1))):
            raise AssertionError(f"K2 at B={b} D={d}: max err {err} > {tol}, "
                                 "or maxima not those of its scores")
        sw, wm10 = window.score_windows(u, it)
        if not (torch.equal(sw, s.view(b, nw, 128).transpose(0, 1))
                and torch.equal(wm10, wm)):
            raise AssertionError(f"K10 at B={b} D={d}: not K2's bits")
        for win in (64, 512):
            st, wt = score.fused_score_wmax(u, it, window=win)
            if not (torch.equal(st, s.T) and torch.equal(
                    wt, st.view(c // win, win, b).amax(1))):
                raise AssertionError(f"K12 window {win} at B={b} D={d}: not "
                                     "K2's bits, or maxima not its scores'")
        for variant, fn in gemm_probe.VARIANTS.items():
            got = fn(u, it)
            want = gemm_probe.variant_outputs(variant, s, wm)
            if not all(g.shape == w.shape and torch.equal(g, w)
                       for g, w in zip(got, want)):
                raise AssertionError(f"K14 {variant} at B={b} D={d}: not "
                                     "K2's bits in its layout")
        log(f"score kernels at B={b} D={d} C={c}: K2 max abs err {err:.3e} "
            f"(tol {tol:.3e}); K10, K12 (windows 64, 512) and the six K14 "
            f"variants K2's bits")


def check_plane_peel(u, items, gen) -> None:
    """`peel.peel_masked_topk` (K10 planes, `gather_windows_rows`) on its
    corrected-wmax branch (E = 200 > C / 1,024, rows of 100-200 live
    exclusions) with one forced redo row (a zero user: every score ties, so
    its exactness flag trips), held bit for bit to `peel_masked_topk_dot`
    (K2 rows) on the same inputs: values, ids and ok flags."""
    import torch

    from sibrar_tpu_torch.ops import peel

    b, c = u.shape[0], items.shape[0]
    e = 200
    dev = u.device
    cols = torch.rand(b, c, device=dev, generator=gen).topk(e, dim=1)[1]
    live = torch.randint(100, e + 1, (b, 1), device=dev, generator=gen)
    mask = torch.arange(e, device=dev) < live
    cols = torch.where(mask, cols, 0).to(torch.int32)
    if not peel._use_corrected_wmax(c, e):
        raise AssertionError("E = 200 should take the corrected branch")
    u = u.clone()
    u[0] = 0.0
    before = peel.gather_windows_rows.launches
    got = peel.peel_masked_topk(u, items, cols, mask, K)
    per_call = peel.gather_windows_rows.launches - before
    want = peel.peel_masked_topk_dot(u, items, cols, mask, K)
    if per_call != 2:
        raise AssertionError(f"corrected branch: {per_call} plane gathers, "
                             "expected 2")
    for name, x, y in zip(("values", "ids", "ok flags"), got, want):
        if not torch.equal(x, y):
            raise AssertionError(f"peel_masked_topk corrected branch: {name} "
                                 "differ from peel_masked_topk_dot")
    redone = int((~got[2]).sum())
    if bool(got[2][0]) or redone < 1:
        raise AssertionError("the zero user's row was not redone")
    log(f"peel_masked_topk B={b} E={e} (corrected wmax, 2 plane gathers per "
        f"call), {redone} row(s) redone from the planes: values, ids and ok "
        f"flags bit-equal to peel_masked_topk_dot")


def check_lists(split, data, score_fn, users, ids, vals) -> int:
    """No returned item from the user's train + val history, lists sorted
    descending, and equal to the plain path (matmul + scatter + topk) on the
    card up to ties. Returns the number of rows whose id set differs from
    the plain path's (only on near-ties)."""
    import numpy as np
    import torch

    from sibrar_tpu_torch.ops.sparse import segment_gather_plain
    from sibrar_tpu_torch.ops.topk import topk_excluding

    if not np.isfinite(vals).all() or ids.shape != (len(users), K):
        raise AssertionError(f"bad output: shape {ids.shape}, finite "
                             f"{np.isfinite(vals).all()}")
    check_excluded(split, users, ids)
    if (np.diff(vals, axis=1) > 0).any():
        raise AssertionError("lists are not sorted descending")

    dev = data.catalog.device
    u_t = torch.as_tensor(users, device=dev)
    user_fn, items = score_fn.dot_parts
    u_repr = user_fn(u_t)
    csr = data.exclude_csr
    cols, mask = segment_gather_plain(csr.indptr, csr.indices, u_t,
                                      csr.max_row_len)
    scores = torch.matmul(u_repr, items.T)
    pv, pi = topk_excluding(scores, cols, mask, K)
    # per-row f32 GEMM error bound: 2 * D * eps * max_c |u| . |x_c|
    bound = (2 * u_repr.shape[1] * F32_EPS
             * (u_repr.abs() @ items.abs().T).amax(dim=1)).cpu().numpy()
    pv, pi = pv.cpu().numpy(), pi.cpu().numpy()
    if (np.abs(vals - pv) > bound[:, None]).any():
        raise AssertionError("values differ from the plain path beyond the "
                             "f32 GEMM bound")
    plain_all = scores.cpu().numpy()
    differ = 0
    for r in range(len(users)):
        extra = set(ids[r].tolist()) ^ set(pi[r].tolist())
        if extra:
            differ += 1
            tie = np.abs(plain_all[r, sorted(extra)] - pv[r, -1])
            if (tie > 2 * bound[r]).any():
                raise AssertionError(f"row {r}: id sets differ beyond ties")
    return differ


def windowed_rankers(rec, score_fn, split, data, kernels, count_path,
                     batches) -> None:
    """Serve ``batches`` (arrays of 1,024 test users) through each windowed
    ranker on the served weights, gated by its launches, and hold every list
    to ``rec.recommend``'s for the same users: values bit-equal (every path
    ranks K2's, K10's or K12's scores, which are the same bits), ids equal
    up to exact ties, no excluded item (`check_excluded`)."""
    import numpy as np
    import torch

    from sibrar_tpu_torch.ops import exact_topk as xtopk
    from sibrar_tpu_torch.ops import peel, score, window
    from sibrar_tpu_torch.ops.sparse import csr_row_gather, scatter_fill_rows

    user_fn, items = score_fn.dot_parts
    c = items.shape[0]
    items_p = window.pad_catalog(items)  # as the Recommender holds them
    csr = data.exclude_csr

    def peel_planes(ur, cols, mask):
        return peel.peel_masked_topk(ur, items, cols, mask, K)[:2]

    def peel_recover(ur, cols, mask):
        flag = peel.RECOVER_KERNEL
        try:
            peel.RECOVER_KERNEL = True
            return peel_planes(ur, cols, mask)
        finally:
            peel.RECOVER_KERNEL = flag

    def tiled(ur, cols, mask):
        return window.pallas_masked_topk(ur, items, cols, mask, K)

    def fused(ur, cols, mask):
        return score.fused_masked_topk(
            ur, items, torch.where(mask, cols, 1 << 30), K)

    def exact_fill(ur, cols, mask):
        scores = window.score_wmax(ur, items_p)[0][:, :c].contiguous()
        return xtopk.exact_topk(scatter_fill_rows(scores, cols, mask,
                                                  fill=-1e30), K)

    peel_k = ["segment_gather", "score_windows", "gather_windows_rows",
              "peel_values"]
    others = ("score_wmax", "fused_score_wmax", "exact_topk",
              "window_scores_from", "window_max")
    paths = (
        ("peel_masked_topk", peel_planes, peel_k + ["gather_windows"],
         others + ("recover_winners", "gather_windows_tiled")),
        ("peel_masked_topk, RECOVER_KERNEL", peel_recover,
         peel_k + ["recover_winners"],
         others + ("gather_windows", "gather_windows_tiled")),
        ("pallas_masked_topk", tiled,
         ["segment_gather", "score_windows", "gather_windows_tiled"],
         others + ("gather_windows_rows", "peel_values", "recover_winners")),
        ("fused_masked_topk", fused, ["segment_gather", "fused_score_wmax"],
         ("score_wmax", "score_windows", "exact_topk", "peel_values")),
        ("exact_topk after the exclusion fill", exact_fill,
         ["segment_gather", "score_wmax", "exact_topk"],
         ("score_windows", "fused_score_wmax", "peel_values",
          "gather_windows")))
    wants = [rec.recommend(users, return_scores=True) for users in batches]
    catalog_items = rec._catalog_items
    position = np.zeros(int(catalog_items.max()) + 1, dtype=np.int64)
    position[catalog_items] = np.arange(len(catalog_items))
    for name, fn, needed, absent in paths:
        reset_counts(kernels)
        got, walls = [], []
        with torch.no_grad():
            for users in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                u_t = torch.as_tensor(users, device=data.catalog.device)
                cols, mask = csr_row_gather(csr, u_t)
                v, i = fn(user_fn(u_t), cols, mask)
                got.append((v.cpu().numpy(), i.cpu().numpy()))
                walls.append(time.perf_counter() - t0)
        count_path(f"windowed ranker {name}", needed, absent)
        differ = 0
        with torch.no_grad():
            for users, (wids, wvals), (v, i) in zip(batches, wants, got):
                if not np.array_equal(v, wvals):
                    raise AssertionError(f"{name}: values differ from the "
                                         "Recommender's")
                ids = catalog_items[i]
                check_excluded(split, users, ids)
                u_t = torch.as_tensor(users, device=data.catalog.device)
                s = window.score_wmax(user_fn(u_t), items_p)[0][:, :c]
                for r in np.nonzero((np.sort(ids, 1)
                                     != np.sort(wids, 1)).any(1))[0]:
                    extra = sorted(set(i[r].tolist())
                                   ^ set(position[wids[r]].tolist()))
                    if not bool((s[r, extra] == float(wvals[r, -1])).all()):
                        raise AssertionError(f"{name}: row {r} differs from "
                                             "the Recommender's beyond ties")
                    differ += 1
        log(f"windowed ranker {name}: {len(batches)} batches of "
            f"{len(batches[0])}, host {1e3 * np.median(walls):.3f} ms per "
            f"batch (median, synchronized); values bit-equal to the "
            f"Recommender's, no excluded item, {differ} rows differ on "
            f"exact ties")
    recovery_device_time(batches, user_fn, csr, data.catalog.device,
                         peel_planes, peel_recover)


def recovery_device_time(batches, user_fn, csr, dev, default, recover
                         ) -> None:
    """Device busy ms per batch of the plane peel with each winner recovery
    (K3 + four compares, or K11 under ``RECOVER_KERNEL``), under the
    profiler over the same batches' user vectors and exclusions, in the
    order default, K11, K11, default."""
    import torch

    from sibrar_tpu_torch.ops.sparse import csr_row_gather

    with torch.no_grad():
        inputs = []
        for users in batches:
            u_t = torch.as_tensor(users, device=dev)
            inputs.append((user_fn(u_t), *csr_row_gather(csr, u_t)))
        busy = {"default": [], "K11": []}
        for name in ("default", "K11", "K11", "default"):
            fn = default if name == "default" else recover
            busy[name].append(profile_window(
                lambda f=fn: [f(*args) for args in inputs], len(inputs),
                f"batches of 1,024, plane peel, {name} recovery"))
    log(f"plane peel device ms per batch of 1,024: default recovery "
        f"{busy['default']}, K11 {busy['K11']}")


def check_excluded(split, users, ids) -> None:
    """No returned (global) item id is in the user's exclusion row."""
    import numpy as np

    excl = split.exclude_matrix().tocsr()
    seen = np.asarray(excl[np.repeat(users, ids.shape[1]),
                           ids.reshape(-1)]).reshape(-1)
    if seen.any():
        raise AssertionError(f"{int(seen.sum())} returned items were seen")


def eval_conf(**changes):
    """The YAML's eval block without its group metrics (module note)."""
    from sibrar_tpu_torch import config_from_dict
    from sibrar_tpu_torch.train.trainer import EvalConfig

    return config_from_dict(EvalConfig, {**EVAL_CONF, "group_metrics": [],
                                         **changes})


def expected_keys(conf, name: str = "val") -> set:
    """The JAX evaluator's keys for an eval block without group metrics:
    mean and std of every user metric at every cutoff, coverage."""
    out = set()
    for m in conf.metrics:
        for k in conf.top_k:
            out.add(f"{name}/{m}@{k}")
            if m != "coverage" and conf.compute_std:
                out.add(f"{name}/{m}@{k}_std")
    return out


def check_metrics(label: str, metrics: dict, conf) -> None:
    keys = set(metrics)
    if keys != expected_keys(conf):
        raise AssertionError(f"{label}: keys differ from the JAX key set: "
                             f"{sorted(keys ^ expected_keys(conf))}")
    bad = {k: v for k, v in metrics.items() if not 0.0 <= v <= 1.0}
    if bad:  # NaN fails the comparison too
        raise AssertionError(f"{label}: metrics outside [0, 1]: {bad}")


def fit_phase(model, train, tdata, val, vdata, kernels, count_path):
    """``Trainer.fit`` at the YAML's learn / eval settings, cut to
    FIT_EPOCHS epochs of FIT_BATCHES steps, validating the whole val split
    through the dot path; after it, ``validate()`` must return fit's best
    metrics exactly (the best state was restored). Returns the trainer."""
    import torch

    from sibrar_tpu_torch import config_from_dict
    from sibrar_tpu_torch.eval.evaluator import FullEvaluator
    from sibrar_tpu_torch.train.trainer import (
        DatasetConfig,
        LearningConfig,
        Trainer,
    )

    conf = eval_conf()
    learn = config_from_dict(LearningConfig, {
        **LEARN_CONF, "n_epochs": FIT_EPOCHS,
        "max_batches_per_epoch": FIT_BATCHES})
    records = []
    fitter = Trainer(model, train, learn,
                     config_from_dict(DatasetConfig, DATASET_CONF),
                     batch_size=LOADER_CONF["batch_size"], seed=SEED,
                     device_data=tdata,
                     val_evaluator=FullEvaluator(conf, val, vdata,
                                                 evaluator_name="val"),
                     eval_batch_size=LOADER_CONF["eval_batch_size"],
                     log_fn=records.append)
    walls, validate = [], fitter.validate

    def timed_validate():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = validate()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return out

    fitter.validate = timed_validate
    reset_counts(kernels)
    t0 = time.perf_counter()
    best = fitter.fit()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    count_path("fit (train steps, dot-path validations)",
               ["segment_gather", "score_wmax", "gather_windows",
                "peel_values", "dw_matmul"],
               ("window_max", "window_scores_from", "gather_windows_tiled"))
    n_users = int(vdata.users_in_split.shape[0])
    for rec, wall in zip(records, walls):
        check_metrics(f"fit epoch {rec['epoch']}",
                      {k: v for k, v in rec.items()
                       if k.startswith("val/") and k != "val/wall_s"},
                      conf)
        log(f"fit epoch {rec['epoch']}: val ndcg@10 "
            f"{rec['val/ndcg@10']:.6f}, recall@10 {rec['val/recall@10']:.6f}"
            f"; validation {wall:.3f} s (catalog encode + {n_users} users "
            f"in batches of {LOADER_CONF['eval_batch_size']})"
            + (f"; train loss {rec['train/loss']:.5f}" if rec["epoch"] >= 0
               else ""))
    log(f"fit: {total:.2f} s for {FIT_EPOCHS} epochs of {FIT_BATCHES} steps "
        f"and {len(walls)} validations; best epoch {fitter.best_epoch}, "
        f"val ndcg@10 {best['val/ndcg@10']:.6f}; redone rows "
        f"{sum(fitter.val_evaluator.redo_rows)} in "
        f"{len(fitter.val_evaluator.redo_rows)} batches")
    again = validate()
    if again != best:
        diff = {k: (again[k], best[k]) for k in best if again[k] != best[k]}
        raise AssertionError(f"validate() after fit differs from fit's best "
                             f"metrics: {diff}")
    log("validate() after fit returns fit's best metrics exactly")
    return fitter


def eval_paths(fitter, val, vdata, kernels, count_path) -> dict:
    """One validation of the val split per ranking path on fit's weights:
    the dot path, the scores path (the scorer without ``dot_parts``,
    ``auto``: K8 + the peel), ``pallas`` (K9 + K3 on the tiling) and
    ``full`` (scatter + ``torch.topk``, the plain yardstick). Returns
    path -> (metrics, seconds)."""
    import torch

    from sibrar_tpu_torch.eval.evaluator import FullEvaluator, evaluate_model

    score_fn = fitter.make_score_fn()

    def scores_fn(u):  # the same scorer without dot parts
        return score_fn(u)

    peel_k = ["segment_gather", "gather_windows", "peel_values"]
    tiled = ("window_scores_from", "gather_windows_tiled")
    paths = (("dot", "auto", score_fn, peel_k + ["score_wmax"],
              ("window_max",) + tiled),
             ("scores", "auto", scores_fn, peel_k + ["window_max"],
              ("score_wmax",) + tiled),
             ("pallas", "pallas", scores_fn, ["segment_gather", *tiled],
              ("window_max", "peel_values", "score_wmax")),
             ("full", "full", scores_fn, ["segment_gather"],
              ("window_max", "peel_values", "score_wmax", "gather_windows")
              + tiled))
    out = {}
    for path, method, fn, needed, absent in paths:
        conf = eval_conf(topk_method=method)
        ev = FullEvaluator(conf, val, vdata, evaluator_name="val")
        reset_counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = evaluate_model(fn, ev, LOADER_CONF["eval_batch_size"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        count_path(f"{path} validation", needed, absent)
        check_metrics(f"{path} validation", metrics, conf)
        out[path] = (metrics, wall)
        n_batches = len(range(0, int(vdata.users_in_split.shape[0]),
                              LOADER_CONF["eval_batch_size"]))
        log(f"validation, {path} path (topk_method {method}): "
            f"{int(vdata.users_in_split.shape[0])} users in {wall:.3f} s "
            f"(encoded catalog, {n_batches} batches); ndcg@10 "
            f"{metrics['val/ndcg@10']:.6f}, recall@10 "
            f"{metrics['val/recall@10']:.6f}; redone rows "
            f"{sum(ev.redo_rows)}")
        profile_window(lambda: evaluate_model(
            fn, ev, LOADER_CONF["eval_batch_size"]), n_batches,
            f"validation batches, {path} path")
    full = out["full"][0]
    for path, (metrics, _) in list(out.items())[:-1]:
        worst = max(full, key=lambda k: abs(metrics[k] - full[k]))
        log(f"{path} vs full: largest metric difference "
            f"{abs(metrics[worst] - full[worst]):.3e} ({worst})")
    check_path_lists(score_fn, val, vdata)
    return out


def check_path_lists(score_fn, val, vdata) -> None:
    """On sample batches of the val split: the scores path's and the pallas
    path's lists equal the full path's on the same score matrix (values
    bit-equal, ids up to exact ties); the dot path's lists equal the plain
    path's within the f32 GEMM bound (`check_lists`)."""
    import torch

    from sibrar_tpu_torch.ops.peel import peel_masked_topk_dot
    from sibrar_tpu_torch.ops.sparse import csr_row_gather
    from sibrar_tpu_torch.ops.topk import masked_topk

    bs, csr = LOADER_CONF["eval_batch_size"], vdata.exclude_csr
    users_all = vdata.users_in_split
    differ = {"scores": 0, "pallas": 0, "dot": 0}
    for bi in LIST_BATCHES:
        u = users_all[bi * bs:(bi + 1) * bs]
        scores = score_fn(u)
        fv, fi = masked_topk(scores, csr, u, K, method="full")
        for path, method in (("scores", "auto"), ("pallas", "pallas")):
            v, i = masked_topk(scores, csr, u, K, method=method)
            if not torch.equal(v, fv):
                raise AssertionError(f"{path} path values differ from the "
                                     f"full path's (batch {bi})")
            rows = (i.sort(1).values != fi.sort(1).values).any(1)
            for r in rows.nonzero().squeeze(1).tolist():
                extra = sorted(set(i[r].tolist()) ^ set(fi[r].tolist()))
                if not bool((scores[r, extra] == fv[r, -1]).all()):
                    raise AssertionError(f"{path} path: row {r} of batch "
                                         f"{bi} differs beyond exact ties")
            differ[path] += int(rows.sum())
        user_fn, items = score_fn.dot_parts
        cols, mask = csr_row_gather(csr, u)
        v, i, _ = peel_masked_topk_dot(user_fn(u), items, cols, mask, K)
        differ["dot"] += check_lists(val, vdata, score_fn, u.cpu().numpy(),
                                     i.cpu().numpy(), v.cpu().numpy())
    log(f"lists of {len(LIST_BATCHES)} val batches: scores and pallas paths "
        f"equal the full path (values bit-equal), dot path within the f32 "
        f"GEMM bound; rows differing on ties only: {differ}")


def first_layer_rows(data, model, gen, n_catalog: int):
    """One train batch: its users, and the item ids it sends to the item
    interaction tower: 512 train pairs, 10 uniform negatives each (the
    trainer's sampler), then balanced routing with a random shift, as
    ``SingleBranchNetEntity._routed_projections`` cuts it."""
    import torch

    from sibrar_tpu_torch.data.sampling import (
        balanced_routing,
        sample_negatives,
    )

    bs, n_neg = LOADER_CONF["batch_size"], DATASET_CONF["n_negative_samples"]
    pick = torch.randperm(data.train_users.shape[0], generator=gen,
                          device=gen.device)[:bs]
    users = data.train_users[pick]
    negs = sample_negatives(gen, users, data.pos_csr, data.popularity,
                            strategy="uniform", n_catalog=n_catalog,
                            n_neg=n_neg)
    cat = torch.cat([data.train_items_cat[pick].unsqueeze(1), negs], 1)
    flat = data.catalog[cat.long()].reshape(-1)
    item = model.item_module
    slots = balanced_routing(len(item.modalities), item.k, item.central)
    inter = item.modality_names.index("interactions")
    residues = [rho for rho, row in enumerate(slots) if inter in row]
    p = len(slots)
    g = -(-flat.shape[0] // p)
    flat = torch.cat([flat, flat.new_zeros(g * p - flat.shape[0])])
    delta = int(torch.randint(0, p, (), generator=gen, device=gen.device))
    rows = torch.roll(flat, -delta).reshape(g, p)[:, residues].reshape(-1)
    return users, rows


def check_train_kernels(tower, rows, users, data, dev) -> dict:
    """K1 and K5-K7 against their plain versions at the train step's shapes
    (one batch: its users' rows of the user CSR and of the sampler's
    ``pos_csr``; the item interaction tower's rows, its kernel, a random
    output gradient); returns name -> {max_abs_err, ms, plain_ms,
    library_ms, bound_ms, bound_by} for K5-K7."""
    import torch
    import torch.nn.functional as F

    from sibrar_tpu_torch.ops import dw, sparse, spmm
    from sibrar_tpu_torch.ops.sparse import csr_row_gather, csr_rows_to_dense

    # K1: the user tower's bag rows, the sampler's row fetch, the item
    # tower's densify rows
    for label, c, idx in (("user CSR, batch users", data.user_inter_csr,
                           users),
                          ("pos_csr, batch users", data.pos_csr, users),
                          ("item CSR, routed rows", tower.csr, rows)):
        idx = idx.to(torch.int32).contiguous()
        length = c.max_row_len
        got = sparse.segment_gather(c.indptr, c.indices, idx, length)
        want = sparse.segment_gather_plain(c.indptr, c.indices, idx, length)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"K1 segment_gather differs on the {label} "
                                 f"(B={idx.shape[0]}, L={length})")
        ms = cuda_ms(lambda: sparse.segment_gather(
            c.indptr, c.indices, idx, length), 50)
        log(f"K1 segment_gather, {label}, B={idx.shape[0]} L={length}: "
            f"bit-equal; kernel {ms:.4f} ms")

    out = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    csr = tower.csr
    kernel = tower.kernel.detach()
    n_cols, h = kernel.shape
    r = rows.shape[0]
    cols, mask = csr_row_gather(csr, rows)
    vec = csr_rows_to_dense(csr, rows)
    g = torch.randn(r, h, device=dev, generator=gen)
    live = int(mask.sum())
    distinct = int(torch.unique(cols[mask]).numel())
    log(f"train batch: {r} item rows x {cols.shape[1]} slots, {live} live "
        f"({distinct} distinct columns), dense {r} x {n_cols}, h = {h}")

    # K5: per element, two f32 sums of R products differ by at most
    # 2 R eps sum_r |vec| |g|
    got = dw.dw_matmul(vec, g)
    want = dw.dw_matmul_plain(vec, g)
    tol = 2 * r * F32_EPS * (vec.abs().T @ g.abs())
    err = max_abs_err(got, want)
    if not bool(((got - want).abs() <= tol).all()):
        raise AssertionError(f"K5 dw_matmul beyond the f32 GEMM bound: max "
                             f"abs err {err}")
    out["dw_matmul"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: dw.dw_matmul(vec, g), 10),
        plain_ms=cuda_ms(lambda: dw.dw_matmul_plain(vec, g), 10),
        library_ms=cuda_ms(lambda: torch.matmul(vec.T, g), 10),
        **bound(4 * (r * n_cols + r * h + n_cols * h), 2 * r * n_cols * h))
    log(f"K5 dw_matmul R={r} C={n_cols} H={h}: max abs err {err:.3e} (within "
        f"2 R eps |vec|.|g| per element); {out['dw_matmul']}")
    # K5's ragged edges: R and H off its tiles (16-byte copies), and C off
    # a multiple of 4 too (4-byte copies)
    for rr, cc, hh in ((r - 1, n_cols, 500), (r - 1, n_cols - 1, 500)):
        v2, g2 = vec[:rr, :cc].contiguous(), g[:rr, :hh].contiguous()
        got, want = dw.dw_matmul(v2, g2), dw.dw_matmul_plain(v2, g2)
        tol = 2 * rr * F32_EPS * (v2.abs().T @ g2.abs())
        if not bool(((got - want).abs() <= tol).all()):
            raise AssertionError(f"K5 dw_matmul R={rr} C={cc} H={hh} beyond "
                                 f"the f32 GEMM bound: max abs err "
                                 f"{max_abs_err(got, want)}")
        log(f"K5 dw_matmul R={rr} C={cc} H={hh}: max abs err "
            f"{max_abs_err(got, want):.3e}, within the bound")
    del v2, g2, got, want, tol

    # K6 / K7 bounds: the function reads the mask everywhere and the column
    # ids at the live slots only
    index_bytes = mask.numel() + 4 * live

    # K6: slot-order sums against index_add_; per row, two sums of its n
    # live rows differ by at most 2 n eps sum |kernel rows|
    got = spmm.spmm_fwd(cols, mask, kernel)
    want = spmm.spmm_fwd_plain(cols, mask, kernel)
    n_live = mask.sum(1, keepdim=True)
    tol = 2 * n_live * F32_EPS * spmm.spmm_fwd_plain(cols, mask, kernel.abs())
    err = max_abs_err(got, want)
    if not bool(((got - want).abs() <= tol).all()):
        raise AssertionError(f"K6 spmm_fwd beyond the f32 sum bound: max abs "
                             f"err {err}")
    weights, cols64 = mask.float(), cols.long()
    out["spmm_fwd"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: spmm.spmm_fwd(cols, mask, kernel), 20),
        plain_ms=cuda_ms(lambda: spmm.spmm_fwd_plain(cols, mask, kernel), 20),
        library_ms=cuda_ms(lambda: F.embedding_bag(
            cols64, kernel, mode="sum", per_sample_weights=weights), 20),
        **bound(index_bytes + distinct * h * 4 + r * h * 4, live * h))
    if not torch.equal(got, spmm.spmm_fwd(cols, mask, kernel)):
        raise AssertionError("K6 spmm_fwd: two calls on the train batch "
                             "differ")
    counts = mask.sum(1).float()
    q50, q90, q99 = counts.quantile(torch.tensor(
        [0.5, 0.9, 0.99], device=dev)).tolist()
    long_rows = counts > 32  # the rows K6 spreads over runs
    log(f"K6 spmm_fwd: max abs err {err:.3e}, the same bits on a second "
        f"call; rows' live slots: median {q50:.0f}, p90 {q90:.0f}, p99 "
        f"{q99:.1f}, longest {counts.max().item():.0f}, "
        f"{int((counts == 0).sum())} empty, {int(long_rows.sum())} above 32 "
        f"holding {int(counts[long_rows].sum())}; {out['spmm_fwd']}")
    profile_window(lambda: [spmm.spmm_fwd(cols, mask, kernel)
                            for _ in range(10)], 10, "K6 calls, train batch")
    check_spmm_edges(kernel, dev)

    # K7: JAX's order of the sums, so the plain version's bits on the CPU
    err = check_spmm_bwd(cols, mask, g, n_cols, dev)
    src_rows, _ = torch.nonzero(mask, as_tuple=True)
    dst = cols[mask].long()
    out["spmm_bwd"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: spmm.spmm_bwd(cols, mask, g, n_cols), 20),
        plain_ms=cuda_ms(lambda: spmm.spmm_bwd_plain(cols, mask, g, n_cols),
                         20),
        library_ms=cuda_ms(lambda: torch.zeros_like(kernel).index_add_(
            0, dst, g.index_select(0, src_rows)), 20),
        **bound(index_bytes + r * h * 4 + n_cols * h * 4, live * h))
    log(f"K7 spmm_bwd: {out['spmm_bwd']}")
    profile_window(lambda: [spmm.spmm_bwd(cols, mask, g, n_cols)
                            for _ in range(10)], 10, "K7 calls, train batch")
    return out


def check_spmm_bwd(cols, mask, g, n_cols: int, dev) -> float:
    """K7 bit for bit against its plain version run on the CPU copies of the
    inputs (``index_add_`` there adds in index order, JAX's order), on the
    train batch and on edge batches: B = 1 and B = 2,255 (no multiple of
    the row group of 8), a mask with no live slot, a column in every row
    (once: a block's shared-memory sort; three times: 6,765 entries, the
    sort in device memory), H = 500, 511 (4-byte loads) and 512, and
    columns no slot hits, which must be +0.0. Two calls on the train batch
    give the same bits. Returns the max abs error (0.0)."""
    import torch

    from sibrar_tpu_torch.ops import spmm

    def bits(x):
        return x.contiguous().view(torch.int32)

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    b, length = cols.shape
    hot = 12_345
    every_once = cols[:257].clone()
    every_once_mask = mask[:257].clone()
    slot = torch.randint(0, length, (257,), device=dev, generator=gen)
    every_once[torch.arange(257, device=dev), slot] = hot
    every_once_mask[torch.arange(257, device=dev), slot] = True
    thrice = cols[:b - 1].clone()
    thrice_mask = mask[:b - 1].clone()
    for j in range(3):
        thrice[:, j * 700] = hot
        thrice_mask[:, j * 700] = True
    tail = n_cols - 1_000  # columns [tail, n_cols) are never hit
    cases = [("train batch", cols, mask),
             ("B=1", torch.randint(0, tail, (1, 3_000), device=dev,
                                   generator=gen, dtype=torch.int32),
              torch.rand(1, 3_000, device=dev, generator=gen) < 0.5),
             ("B=2,255", cols[:b - 1], mask[:b - 1]),
             ("no live slot", cols[:64], torch.zeros_like(mask[:64])),
             ("a column in every row, once", every_once, every_once_mask),
             ("a column in every row, three times", thrice, thrice_mask)]
    cases.append(("untouched tail columns",
                  torch.randint(0, tail, (300, 700), device=dev,
                                generator=gen, dtype=torch.int32),
                  torch.rand(300, 700, device=dev, generator=gen) < 0.2))
    for label, c, m in cases:
        hit = torch.zeros(n_cols, dtype=torch.bool, device=dev)
        hit[c[m].long()] = True
        for h in (500, 511, 512):
            gh = g[:c.shape[0], :h].contiguous()
            got = spmm.spmm_bwd(c, m, gh, n_cols)
            want = spmm.spmm_bwd_plain(c.cpu(), m.cpu(), gh.cpu(), n_cols)
            if not torch.equal(bits(got).cpu(), bits(want)):
                raise AssertionError(f"K7 spmm_bwd differs from its plain "
                                     f"version on the CPU ({label}, H={h}): "
                                     f"max abs err "
                                     f"{max_abs_err(got.cpu(), want)}")
            if bool((bits(got)[~hit] != 0).any()):
                raise AssertionError(f"K7 spmm_bwd: a row no slot hits is not "
                                     f"+0.0 ({label}, H={h})")
    first = spmm.spmm_bwd(cols, mask, g, n_cols)
    if not torch.equal(bits(first), bits(spmm.spmm_bwd(cols, mask, g,
                                                       n_cols))):
        raise AssertionError("K7 spmm_bwd: two calls on the train batch "
                             "differ")
    log(f"K7 spmm_bwd: bit-equal to its plain version on the CPU on the "
        f"train batch and on {len(cases) - 1} edge batches (H = 500, 511, "
        f"512; B = 1, 2,255; no live slot; column {hot} in every row once "
        f"and three times; untouched tail columns), unhit rows +0.0, two "
        f"calls on the train batch bit-equal")
    return 0.0


def check_bf16_edges(items, gen) -> None:
    """K15 off its tiles: B in {1, 63, 65, 1,000} (chunks of 64 users), D in
    {4, 12, 100, 260} (16-deep steps, 64-deep K-blocks, a second 256-deep
    segment) and C in {128, 384, 100,352} (tiles of 256 items, a last tile
    of one window) over ``items``' first rows and depths. Each within
    ``D 2^-24 (|u~| @ |i~|^T)`` of the rounded operands' exact product
    (`_common.bf16_within`), its maxima those of its own scores."""
    import torch

    from sibrar_tpu_torch.ops import gemm_probe
    from sibrar_tpu_torch.tools import _common

    dev = items.device
    worst = 0.0
    for c in (128, 384, 100_352):
        for d in (4, 12, 100, 260):
            it = (items[:c, :d].contiguous() if d <= items.shape[1]
                  else torch.cat([items[:c], items[:c, :d - items.shape[1]]],
                                 dim=1))
            for b in (1, 63, 65, 1000):
                u = torch.randn(b, d, device=dev, generator=gen)
                s, wmax_t = gemm_probe.score_bf16(u, it)
                if not torch.equal(wmax_t,
                                   s.view(b, c // 128, 128).amax(-1).T):
                    raise AssertionError(f"K15 at B={b} C={c} D={d}: maxima "
                                         "not those of its scores")
                worst = max(worst, _common.bf16_within(
                    f"K15 at B={b} C={c} D={d}", s, wmax_t, u, it)[1])
    log(f"K15 off its tiles (B in 1, 63, 65, 1,000; D in 4, 12, 100, 260; "
        f"C in 128, 384, 100,352): within the f32 summation bound of the "
        f"rounded operands' exact product (largest |err| / bound "
        f"{worst:.3f}), maxima of its own scores")


def check_launch_stream(dev) -> None:
    """Every wrapper launches on PyTorch's current stream: inside and
    outside ``with torch.cuda.stream(side)``, ``_cuda.current_stream()`` is
    ``torch.cuda.current_stream().cuda_stream``, and a K16 launch queued
    behind a ~50 ms sleep and a fill on the current stream reads the
    filled values."""
    import torch

    from sibrar_tpu_torch.ops import _cuda, roll

    side = torch.cuda.Stream(device=dev)
    shift = torch.tensor([5], dtype=torch.int32, device=dev)
    x = torch.zeros(4, 300, device=dev)
    torch.cuda.synchronize()
    for where, ctx in (("outside", None), ("inside", side)):
        stream = torch.cuda.current_stream() if ctx is None else ctx
        with torch.cuda.stream(stream):
            if _cuda.current_stream() != torch.cuda.current_stream() \
                    .cuda_stream:
                raise AssertionError(f"_cuda.current_stream() {where} "
                                     "torch.cuda.stream is not PyTorch's "
                                     "current stream")
            torch.cuda._sleep(100_000_000)  # ~50 ms of this stream
            x.fill_(7.0 if ctx is None else 9.0)
            got = roll.roll_lanes(x, shift)
        torch.cuda.synchronize()
        if not torch.equal(got, roll.roll_lanes_plain(x, shift)):
            raise AssertionError(f"K16 {where} torch.cuda.stream(side): not "
                                 "ordered after the stream's earlier work")
    log("launch stream: _cuda.current_stream() is PyTorch's current stream "
        "inside and outside torch.cuda.stream(side); K16 queued behind a "
        "sleep and a fill on it reads the fill")


def check_probe_kernels(u, items) -> dict:
    """K14-K17 against K2 and their plain versions: K14 and K15 at the GEMM
    probes' width (``u [1024, 256]``, ``items [501,760, 256]``; K15 also
    off its tiles, `check_bf16_edges`), K16 and K17 at the roll and mask
    probes' shapes (K17 also at [1024, 168, 128]) and on a width-200 row,
    shifts past n and reads past the end, the launch stream
    (`check_launch_stream`) and K16's device and events-loop times apart;
    returns name -> row."""
    import torch

    from sibrar_tpu_torch.ops import gemm_probe, roll, window
    from sibrar_tpu_torch.ops import mask as mask_ops
    from sibrar_tpu_torch.tools import _common, probe_pred_input, probe_roll

    out = {}
    b, d = u.shape
    c = items.shape[0]
    nw = c // 128
    flops = 2 * b * c * d
    operands = 4 * (b * d + c * d)

    def within(name, got, want, tol) -> float:
        diff = (got - want).abs()
        if not bool((diff <= tol).all()):
            raise AssertionError(f"{name}: past the f32 summation bound by "
                                 f"up to {float((diff - tol).max())}")
        return float(diff.max())

    def window_max(x):
        return x.view(b, nw, 128).amax(-1)

    # K2's scores and maxima: the bits every K14 variant must hold; their
    # distance from the plain f32 product, within D 2^-24 (|u| @ |items|^T)
    scores, wmax = window.score_wmax(u, items)
    plain = u @ items.T
    tol = d * F32_EPS * (u.abs() @ items.abs().T)
    errs = {"scores": within("K2 scores", scores, plain, tol),
            "maxima": within("K2 maxima", wmax, window_max(plain),
                             window_max(tol))}
    del plain, tol
    matmul_ms = cuda_ms(lambda: torch.matmul(u, items.T), 10)
    for variant, fn in gemm_probe.VARIANTS.items():
        got = fn(u, items)
        want = gemm_probe.variant_outputs(variant, scores, wmax)
        if not all(g.shape == w.shape and torch.equal(g, w)
                   for g, w in zip(got, want)):
            raise AssertionError(f"K14 {variant}: not K2's scores and "
                                 "maxima bit for bit in its layout")
        del got, want
        stores = ((0 if variant == "noscores" else b * c)
                  + (0 if variant == "nowmax" else b * nw))
        out[f"score_{variant}"] = dict(
            max_abs_err=max(errs["scores"] if variant != "noscores" else 0.0,
                            errs["maxima"] if variant != "nowmax" else 0.0),
            ms=cuda_ms(lambda: fn(u, items), 10),
            plain_ms=cuda_ms(lambda: gemm_probe.score_variant_plain(
                u, items, variant), 5),
            library_ms=matmul_ms if variant == "nowmax" else None,
            **bound(operands + 4 * stores, flops))
        log(f"K14 score_{variant} B={b} C={c} D={d}: K2's bits in its "
            f"layout; {out[f'score_{variant}']}")
    log(f"torch.matmul f32 (the xla mode) {matmul_ms:.4f} ms")

    # K15: within D 2^-24 (|u~| @ |i~|^T) of the exact product of the
    # rounded operands u~, i~; its maxima those of its own scores
    s15, w15 = gemm_probe.score_bf16(u, items)
    if not torch.equal(w15, window_max(s15).T):
        raise AssertionError("K15 score_bf16: maxima are not those of its "
                             "scores")
    rel_f32 = float((s15 - scores).abs().max() / scores.abs().max())
    del scores, wmax
    err, ratio = _common.bf16_within("K15 score_bf16", s15, w15, u, items)
    del s15, w15
    check_bf16_edges(items, torch.Generator(device=u.device)
                     .manual_seed(SEED + 6))
    u16, i16 = u.bfloat16(), items.bfloat16()
    lib16 = cuda_ms(lambda: torch.matmul(u16, i16.T), 10)
    try:  # f32 scores of the rounded operands, without the maxima
        torch.mm(u16[:1], i16[:128].T, out_dtype=torch.float32)
        lib_f32out = cuda_ms(lambda: torch.mm(u16, i16.T,
                                              out_dtype=torch.float32), 10)
    except (TypeError, RuntimeError, NotImplementedError) as e:
        log(f"torch.mm(..., out_dtype=torch.float32) not offered by torch "
            f"{torch.__version__}: {e}")
        lib_f32out = None
    del u16, i16
    out["score_bf16"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: gemm_probe.score_bf16(u, items),
                                    10),
        plain_ms=cuda_ms(lambda: gemm_probe.score_bf16_plain(u, items), 5),
        library_ms=lib_f32out,
        **bound(operands + 4 * (b * c + b * nw), flops, BF16_FLOPS))
    log(f"K15 score_bf16 B={b} C={c} D={d}: within the f32 summation bound "
        f"of the rounded operands' exact product (largest |err| / bound "
        f"{ratio:.3f}), maxima of its own scores; "
        f"against K2's f32 scores max |diff| / max |s| = {rel_f32:.3e}; "
        f"library: torch.mm(u~, i~^T, out_dtype=f32) (no maxima); bf16-out "
        f"torch.matmul of the rounded operands {lib16:.4f} ms (a yardstick, "
        f"not the same function); {out['score_bf16']}")
    torch.cuda.empty_cache()

    # K16 on the probes' inputs, at width 200 with shifts past n and below
    # 0, and reading past the end
    dev = u.device
    i32 = dict(dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    probe_x = torch.arange(256, dtype=torch.float32, device=dev)[None]
    probe_s = torch.tensor([37], **i32)
    row200 = torch.randn(4, 200, device=dev, generator=gen)
    errs = {"roll_lanes": max(
        exact(f"K16 roll_lanes {tuple(x.shape)} shift {int(s)}",
              [roll.roll_lanes(x, s)], [roll.roll_lanes_plain(x, s)])
        for x, s in ((probe_x, probe_s), (row200, torch.tensor([237], **i32)),
                     (row200, torch.tensor([-5], **i32)),
                     (row200.view(torch.int32), torch.tensor([400], **i32))))}
    slice_x = torch.arange(512, dtype=torch.float32, device=dev)[None]
    errs["lane_slice"] = max(
        exact(f"K16 lane_slice {tuple(x.shape)} start {int(s)}",
              [roll.lane_slice(x, s)], [roll.lane_slice_plain(x, s)])
        for x, s in ((slice_x, probe_s), (row200, torch.tensor([150], **i32))))
    flat = torch.arange(probe_roll.SEGMENT_N, **i32)
    starts = torch.tensor(probe_roll.SEGMENT_STARTS, **i32)
    errs["segment_roll"] = max(
        exact(f"K16 segment_roll starts {st.tolist()}",
              [roll.segment_roll(flat, st, probe_roll.SEGMENT_LEN)],
              [roll.segment_roll_plain(flat, st, probe_roll.SEGMENT_LEN)])
        for st in (starts, torch.tensor([8100, 0, 127, 128, 8191], **i32)))
    n_seg = starts.numel() * probe_roll.SEGMENT_LEN
    check_launch_stream(dev)
    k16 = {"roll_lanes": (lambda: roll.roll_lanes(probe_x, probe_s),
                          lambda: roll.roll_lanes_plain(probe_x, probe_s),
                          2 * 4 * 256 + 4),
           "lane_slice": (lambda: roll.lane_slice(slice_x, probe_s),
                          lambda: roll.lane_slice_plain(slice_x, probe_s),
                          2 * 4 * 128 + 4),
           "segment_roll": (lambda: roll.segment_roll(
               flat, starts, probe_roll.SEGMENT_LEN),
               lambda: roll.segment_roll_plain(flat, starts,
                                               probe_roll.SEGMENT_LEN),
               4 * (2 * n_seg + starts.numel()))}
    for name, (fn, plain_fn, n_bytes) in k16.items():
        out[name] = dict(
            max_abs_err=errs[name], ms=cuda_ms(fn, 100),
            plain_ms=cuda_ms(plain_fn, 100),
            library_ms=(cuda_ms(lambda: torch.roll(probe_x, -37, dims=1), 100)
                        if name == "roll_lanes" else None),
            **bound(n_bytes))
    # a diagnostic beside the row's events loop: a call is its host work,
    # so the three and torch.roll take turns and each keeps its median round
    loop = cuda_ms_turns({**{k: v[0] for k, v in k16.items()},
                          "torch.roll": lambda: torch.roll(probe_x, -37,
                                                           dims=1)})
    for name, (fn, _, _) in k16.items():
        device = _common.device_ops_ms(fn, dev, 100, f"{name}_kernel")
        log(f"K16 {name} at the probe's shape: bit-equal (also width 200, "
            f"shifts 237, -5, 400, reads past the end); device time per "
            f"launch (profiler) {device}; events loop in turns (median of "
            f"{TURNS} rounds of {TURN_ITERS} calls, with the other two and "
            f"torch.roll {loop['torch.roll']:.4f} ms) {loop[name]:.4f} ms; "
            f"{out[name]}")

    # K17: both mask dtypes at the probe's [16, 168, 128] and at
    # [1024, 168, 128]; timed there with the bool mask
    err = 0.0
    for rows in (16, 1024):
        for dtype_name in ("bool", "int8"):
            x, _, m = probe_pred_input.mask_inputs(dtype_name, rows, dev)
            err = max(err, exact(f"K17 mask_where {dtype_name} [{rows}, 168, "
                                 f"128]", [mask_ops.mask_where(m, x)],
                                 [mask_ops.mask_where_plain(m, x)]))
    int8_ms = cuda_ms(lambda: mask_ops.mask_where(m, x), 50)
    x, m, _ = probe_pred_input.mask_inputs("bool", 1024, dev)
    out["mask_where"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: mask_ops.mask_where(m, x), 50),
        plain_ms=cuda_ms(lambda: mask_ops.mask_where_plain(m, x), 50),
        library_ms=cuda_ms(lambda: torch.where(m, mask_ops.NEG, x), 50),
        **bound(x.numel() * (4 + 1 + 4)))
    log(f"K17 mask_where [1024, 168, 128]: bit-equal with bool and int8 "
        f"masks (also [16, 168, 128]); int8 mask {int8_ms:.4f} ms; bool "
        f"mask {out['mask_where']}")
    return out


def probes_phase(kernels, count_path) -> dict:
    """The ported ``tools/`` probes at their full width: the kernel checks
    (`check_probe_kernels`), then, counted, every mode of the three GEMM
    probes through their ``run`` entry points (their JSON records logged),
    the three roll probes, ``try_mask`` with both dtypes at b = 16 and
    1,024, and ``try_recover`` (K11 at m = 168, bit-equal to plain). The
    [1024, 501,760] score tensors are freed at the end."""
    import torch

    from sibrar_tpu_torch.ops import gemm_probe
    from sibrar_tpu_torch.tools import (
        _common,
        probe_gemm_bisect,
        probe_gemm_precision,
        probe_gemm_variants,
        probe_pred_input,
        probe_roll,
    )

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    u, items = _common.inputs(_common.C, torch.device(DEVICE))
    log(f"probe inputs u [{_common.B}, {_common.D}], items [{_common.C}, "
        f"{_common.D}] (default_rng(1)): {time.perf_counter() - t0:.2f} s")
    measured = check_probe_kernels(u, items)
    torch.cuda.empty_cache()

    reset_counts(kernels)
    for module in (probe_gemm_variants, probe_gemm_bisect,
                   probe_gemm_precision):
        name = module.__name__.rsplit(".", 1)[-1]
        for mode in module.MODES:
            log(f"{name}: {json.dumps(module.run(mode, u, items))}")
    for which, probe in probe_roll.PROBES.items():
        if probe(DEVICE) is not True:
            raise AssertionError(f"probe_roll {which}: not ok")
    for rows in (16, 1024):
        for dtype_name in ("bool", "int8"):
            if not probe_pred_input.try_mask(dtype_name, rows, DEVICE):
                raise AssertionError(f"try_mask {dtype_name} b={rows}: "
                                     "differs from torch.where")
    got = probe_pred_input.try_recover(DEVICE)
    if not (got["lane"] and got["nhit"] and got["wsel"]):
        raise AssertionError(f"try_recover: K11 differs from plain: {got}")
    count_path("probes path",
               [*(f"score_{v}" for v in gemm_probe.VARIANTS),
                "score_bf16", "roll_lanes", "lane_slice", "segment_roll",
                "mask_where", "recover_winners"],
               ("score_wmax",))
    del u, items
    torch.cuda.empty_cache()
    return measured


def reset_counts(kernels) -> None:
    for _, fn, _, _ in kernels:
        fn.launches = 0


def read_counts(kernels) -> dict:
    return {name: fn.launches for name, fn, _, _ in kernels}


def train_window(trainer, n_steps: int) -> dict:
    """``n_steps`` steps through ``Trainer.train_epoch``: host ms per step
    (synchronized), stream ms per step (CUDA events around the epoch),
    steps/s and the step losses."""
    import torch

    trainer.learn.max_batches_per_epoch = n_steps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    summary = trainer.train_epoch()
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = trainer.epoch_losses[:, 0].cpu().numpy()
    return dict(host_ms=wall * 1e3 / n_steps,
                event_ms=start.elapsed_time(end) / n_steps,
                steps_per_s=n_steps / wall, losses=losses, summary=summary)


def profile_window(fn, n: int, unit: str) -> float | None:
    """torch.profiler over ``fn()``, which runs ``n`` units (train steps,
    request batches): device busy time per unit, idle share of the wall
    time, and the kernels by device time. Returns the busy ms per unit
    (None when the profiler saw no device time). The session is held to
    one device record per kernel launch (`tools._common.profiled`)."""
    from sibrar_tpu_torch.tools._common import profiled

    by_name, wall_us, idle_s = profiled(fn)
    busy = sum(by_name.values())
    if busy == 0:
        log(f"profile, {n} {unit}: no device time recorded")
        return None
    log(f"profile, {n} {unit}: wall {wall_us / 1e3 / n:.3f} ms per unit, "
        f"device busy {busy / 1e3 / n:.3f} ms per unit, idle share "
        f"{1 - busy / wall_us:.3f} (wall under the profiler; the session "
        f"idled {idle_s} s first)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        log(f"  {us / 1e3 / n:8.4f} ms/unit {100 * us / busy:5.1f} %  "
            f"{name[:110]}")
    return busy / 1e3 / n


def first_layer_chains(tower, rows, catalog, model, dev) -> None:
    """The item tower's first layer at the train shape, forward + backward,
    densify + matmul (K5) against the spmm path (K6 / K7), each with its
    K1 row gather; then the catalog encode both ways."""
    import torch

    from sibrar_tpu_torch.models import layers
    from sibrar_tpu_torch.ops.dw import dense_first_matmul
    from sibrar_tpu_torch.ops.sparse import csr_row_gather, csr_rows_to_dense
    from sibrar_tpu_torch.ops.spmm import spmm_onehot
    from sibrar_tpu_torch.train.scoring import make_score_fn

    csr = tower.csr
    kernel = tower.kernel.detach().clone().requires_grad_()
    g = torch.randn(rows.shape[0], kernel.shape[1], device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED))

    def dense(backward: bool):
        out = dense_first_matmul(csr_rows_to_dense(csr, rows), kernel)
        if backward:
            out.backward(g)

    def sparse(backward: bool):
        cols, mask = csr_row_gather(csr, rows)
        out = spmm_onehot(cols, mask, kernel)
        if backward:
            out.backward(g)

    for name, fn in (("dense (K1, densify, matmul; K5)", dense),
                     ("spmm (K1, K6; K7)", sparse)):
        fwd = cuda_ms(lambda: fn(False), 10)
        both = cuda_ms(lambda: fn(True), 10)
        log(f"first layer {name}, {rows.shape[0]} rows: forward {fwd:.4f} "
            f"ms, forward + backward {both:.4f} ms")
    flag = layers.INTERACTION_SPMM
    try:
        for spmm_on in (False, True, False, True):
            layers.INTERACTION_SPMM = spmm_on
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            make_score_fn(model, catalog)
            torch.cuda.synchronize()
            log(f"catalog encode, {'spmm' if spmm_on else 'dense'} first "
                f"layer: {time.perf_counter() - t0:.4f} s")
    finally:
        layers.INTERACTION_SPMM = flag


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script has no CPU mode",
              file=sys.stderr)
        return 1
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    found = {name: importlib.util.find_spec(name) is not None
             for name in ("jax", "yaml", "pandas", "ninja")}
    found["ninja (executable)"] = shutil.which("ninja") is not None
    log("importable: " + ", ".join(f"{k}={v}" for k, v in found.items()))

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sibrar_tpu_torch import config_from_dict, full_f32
    from sibrar_tpu_torch.data.dataset import make_splits
    from sibrar_tpu_torch.data.synthetic import make_onion_scale_splits
    from sibrar_tpu_torch.models import layers
    from sibrar_tpu_torch.models.sbnet import SingleBranchNet
    from sibrar_tpu_torch.ops import _cuda, dw, gemm_probe, peel, roll, score
    from sibrar_tpu_torch.ops import exact_topk as xtopk
    from sibrar_tpu_torch.ops import mask as mask_ops
    from sibrar_tpu_torch.ops import sparse, spmm, window
    from sibrar_tpu_torch.serve import Recommender
    from sibrar_tpu_torch.train.scoring import make_score_fn
    from sibrar_tpu_torch.train.trainer import (
        DatasetConfig,
        LearningConfig,
        Trainer,
    )

    dev = torch.device(DEVICE)
    full_f32()
    kernels = [("segment_gather", sparse.segment_gather,
                "sibrar_tpu_torch/csrc/segment_gather.cu",
                "sibrar_tpu/ops/sparse.py:131"),
               ("score_wmax", window.score_wmax,
                "sibrar_tpu_torch/csrc/score_wmax.cu",
                "sibrar_tpu/ops/pallas_window.py:182"),
               ("gather_windows", peel.gather_windows,
                "sibrar_tpu_torch/csrc/gather_windows.cu",
                "sibrar_tpu/ops/pallas_peel.py:490"),
               ("peel_values", peel.peel_values,
                "sibrar_tpu_torch/csrc/peel_values.cu",
                "sibrar_tpu/ops/pallas_peel.py:240"),
               ("dw_matmul", dw.dw_matmul,
                "sibrar_tpu_torch/csrc/dw_matmul.cu",
                "sibrar_tpu/ops/pallas_dw.py:90"),
               ("spmm_fwd", spmm.spmm_fwd,
                "sibrar_tpu_torch/csrc/spmm_onehot.cu",
                "sibrar_tpu/ops/pallas_spmm.py:67"),
               ("spmm_bwd", spmm.spmm_bwd,
                "sibrar_tpu_torch/csrc/spmm_onehot.cu",
                "sibrar_tpu/ops/pallas_spmm.py:127"),
               ("window_max", peel.window_max,
                "sibrar_tpu_torch/csrc/window_max.cu",
                "sibrar_tpu/ops/pallas_peel.py:302"),
               ("window_scores_from", window.window_scores_from,
                "sibrar_tpu_torch/csrc/window_retile.cu",
                "sibrar_tpu/ops/pallas_window.py:147"),
               ("gather_windows_tiled", window.gather_windows_tiled,
                "sibrar_tpu_torch/csrc/gather_windows.cu",
                "sibrar_tpu/ops/pallas_window.py:243"),
               ("score_windows", window.score_windows,
                "sibrar_tpu_torch/csrc/score_wmax.cu",
                "sibrar_tpu/ops/pallas_window.py:104"),
               ("gather_windows_rows", peel.gather_windows_rows,
                "sibrar_tpu_torch/csrc/gather_windows.cu",
                "sibrar_tpu/ops/pallas_peel.py:361"),
               ("recover_winners", peel.recover_winners,
                "sibrar_tpu_torch/csrc/recover_winners.cu",
                "sibrar_tpu/ops/pallas_peel.py:654"),
               ("fused_score_wmax", score.fused_score_wmax,
                "sibrar_tpu_torch/csrc/fused_score_wmax.cu",
                "sibrar_tpu/ops/pallas_score.py:47"),
               ("exact_topk", xtopk.exact_topk,
                "sibrar_tpu_torch/csrc/exact_topk.cu",
                "sibrar_tpu/ops/pallas_topk.py:102")]
    # K14's six epilogues (the bisect probe's kernel bodies), K15-K17
    kernels += [(f"score_{variant}", gemm_probe.VARIANTS[variant],
                 "sibrar_tpu_torch/csrc/score_variants.cu",
                 f"tools/probe_gemm_bisect.py:{line}")
                for variant, line in (("full", 66), ("noscores", 72),
                                      ("nowmax", 77), ("wmax_contig", 80),
                                      ("wmax_T", 86), ("wmax_lanes", 96))]
    kernels += [("score_bf16", gemm_probe.score_bf16,
                 "sibrar_tpu_torch/csrc/score_bf16.cu",
                 "tools/probe_gemm_precision.py:43"),
                ("roll_lanes", roll.roll_lanes, "sibrar_tpu_torch/csrc/roll.cu",
                 "tools/probe_roll.py:26"),
                ("lane_slice", roll.lane_slice, "sibrar_tpu_torch/csrc/roll.cu",
                 "tools/probe_roll.py:45"),
                ("segment_roll", roll.segment_roll,
                 "sibrar_tpu_torch/csrc/roll.cu", "tools/probe_roll.py:64"),
                ("mask_where", mask_ops.mask_where,
                 "sibrar_tpu_torch/csrc/mask_where.cu",
                 "tools/probe_pred_input.py:31")]
    t_start = time.perf_counter()

    # ---------------------------------------------------------------- build
    _cuda.build()
    log(f"build: {_cuda.build_info['seconds']:.2f} s "
        f"({_cuda.build_info['library']})")
    for line in _cuda.build_info["ptxas"].splitlines():  # -Xptxas -v
        if any(w in line for w in ("Compiling entry", "Used", "spill")):
            log(f"  {line.strip()}")

    # ----------------------------------------------------------------- data
    t0 = time.perf_counter()
    arrays = make_onion_scale_splits(seed=7)
    splits = make_splits(arrays)
    train, val, test = splits["train"], splits["val"], splits["test"]
    tdata = train.to_device(dev)
    vdata = val.to_device(dev)
    data = test.to_device(dev)
    log(f"data: {time.perf_counter() - t0:.2f} s; {arrays['n_users']} users "
        f"x {arrays['n_items']} items; train {len(arrays['train'])}, val "
        f"{len(arrays['val'])}, test {len(arrays['test'])}; exclusion nnz "
        f"{data.exclude_csr.nnz}, E = {data.exclude_csr.max_row_len} (val E "
        f"= {vdata.exclude_csr.max_row_len}); item "
        f"CSR nnz {data.item_inter_csr.nnz}, longest row "
        f"{data.item_inter_csr.max_row_len}; user CSR longest row "
        f"{data.user_inter_csr.max_row_len}")

    # ------------------------------------------------------------ the model
    model = SingleBranchNet.build_from_conf(MODEL_CONF, train, tdata,
                                            seed=SEED)
    learn = config_from_dict(LearningConfig, LEARN_CONF)
    trainer = Trainer(model, train, learn,
                      config_from_dict(DatasetConfig, DATASET_CONF),
                      batch_size=LOADER_CONF["batch_size"], seed=SEED,
                      device_data=tdata)
    item = model.item_module
    tower = item.modalities[item.modality_names.index("interactions")]
    if tower.use_bag(1) or not model.user_module.net.use_bag(1):
        raise AssertionError("expected the item tower's dense first layer "
                             "and the user tower's bag path")

    # -------------------------------------------- kernels vs plain versions
    measured = check_kernels(data, dev, vdata.exclude_csr.max_row_len)
    users, rows = first_layer_rows(tdata, model, torch.Generator(
        device=dev).manual_seed(SEED + 2), train.n_items_in_split)
    measured.update(check_train_kernels(tower, rows, users, tdata, dev))
    launches = {name: 0 for name, _, _, _ in kernels}

    def count_path(path: str, needed: list, absent: tuple = ()) -> dict:
        counts = read_counts(kernels)
        log(f"launches, {path}: {counts}")
        missing = [n for n in needed if counts[n] == 0]
        if missing:
            raise AssertionError(f"kernels not launched by the {path}: "
                                 f"{missing}")
        stray = [n for n in absent if counts[n]]
        if stray:
            raise AssertionError(f"{path} launched {stray}")
        for name, n in counts.items():
            launches[name] += n
        return counts

    # -------------------------------------- training, default first layer
    warm = train_window(trainer, TRAIN_WARMUP)
    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    run = train_window(trainer, TRAIN_STEPS)
    count_path("default train path", ["segment_gather", "dw_matmul"],
               ("spmm_fwd", "spmm_bwd"))
    losses = np.concatenate([warm["losses"], run["losses"]])
    first = float(run["losses"][:LOSS_WINDOW].mean())
    last = float(run["losses"][-LOSS_WINDOW:].mean())
    log(f"train (dense first layer), {TRAIN_STEPS} steps after "
        f"{TRAIN_WARMUP} warm-up: host {run['host_ms']:.3f} ms/step "
        f"(synchronized), CUDA events {run['event_ms']:.3f} ms/step, "
        f"{run['steps_per_s']:.2f} steps/s; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; loss (BPR + "
        f"InfoNCE) first {LOSS_WINDOW} steps {first:.5f}, last "
        f"{LOSS_WINDOW} {last:.5f}; epoch means {run['summary']}")
    if not np.isfinite(losses).all() or not last < first:
        raise AssertionError(f"training losses not finite or not falling: "
                             f"first window {first}, last {last}")
    snapshot = {k: v.detach().clone() for k, v in model.state_dict().items()}
    trainer.learn.max_batches_per_epoch = PROFILE_STEPS
    profile_window(trainer.train_epoch, PROFILE_STEPS, "train steps")

    # ------------------------------------- training, INTERACTION_SPMM on
    flag = layers.INTERACTION_SPMM
    try:
        layers.INTERACTION_SPMM = True
        train_window(trainer, SPMM_WARMUP)
        reset_counts(kernels)
        run = train_window(trainer, SPMM_STEPS)
        count_path("spmm train path",
                   ["segment_gather", "spmm_fwd", "spmm_bwd"],
                   ("dw_matmul",))
        trainer.learn.max_batches_per_epoch = PROFILE_STEPS
        profile_window(trainer.train_epoch, PROFILE_STEPS,
                       "train steps, INTERACTION_SPMM on")
    finally:
        layers.INTERACTION_SPMM = flag
    if not np.isfinite(run["losses"]).all():
        raise AssertionError("spmm training losses not finite")
    log(f"train (spmm first layer), {SPMM_STEPS} steps after {SPMM_WARMUP} "
        f"warm-up: host {run['host_ms']:.3f} ms/step, CUDA events "
        f"{run['event_ms']:.3f} ms/step, {run['steps_per_s']:.2f} steps/s; "
        f"loss {run['summary']}")

    # --------------------------------------- the first layer, both ways
    first_layer_chains(tower, rows, data.catalog, model, dev)

    # ------------- Trainer.fit from the default training's weights, then
    # one validation per ranking path on fit's weights
    model.load_state_dict(snapshot)
    fitter = fit_phase(model, train, tdata, val, vdata, kernels, count_path)
    eval_paths(fitter, val, vdata, kernels, count_path)

    # -------------------- serving, from the default training's weights
    model.load_state_dict(snapshot)
    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    score_fn = make_score_fn(model, data.catalog)
    torch.cuda.synchronize()
    log(f"catalog encode: {time.perf_counter() - t0:.3f} s for "
        f"{data.catalog.shape[0]} items (chunks of 8192, trained weights)")
    users_all = np.random.default_rng(SEED).permutation(arrays["n_users"])
    served, start, redone, recs = [], 0, [], {}
    for bs, n_batches in BATCHES.items():
        rec = recs[bs] = Recommender(score_fn, test, data, k=K,
                                     batch_size=bs)
        if not rec.use_dot:
            raise AssertionError("the fused dot path was not taken")
        lat = []
        for _ in range(n_batches + 1):  # the first batch is a warm-up
            users = users_all[start:start + bs]
            start += bs
            t1 = time.perf_counter()
            ids, vals = rec.recommend(users, return_scores=True)
            lat.append(time.perf_counter() - t1)
            served.append((users, ids, vals))
        p50 = float(np.median(lat[1:])) * 1e3
        redone += rec.redo_rows
        log(f"B={bs}: p50 {p50:.3f} ms per request batch over {n_batches} "
            f"batches (host clock, after one warm-up) on {card}; redone rows "
            f"per batch {rec.redo_rows}")
    count_path("serving path", ["segment_gather", "score_wmax",
                                "gather_windows", "peel_values"],
               ("score_windows", "gather_windows_rows", "recover_winners",
                "fused_score_wmax", "exact_topk"))
    for bs, rec in recs.items():
        users = users_all[start:start + PROFILE_BATCHES * bs]
        start += len(users)
        profile_window(lambda: rec.recommend(users), PROFILE_BATCHES,
                       f"request batches of {bs}")
    log(f"max_memory_allocated (serving): "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    differ = sum(check_lists(test, data, score_fn, *batch)
                 for batch in served)
    n_lists = sum(len(b[0]) for b in served)
    log(f"{n_lists} lists checked: no seen item, sorted, equal to the plain "
        f"path ({differ} differ only on ties); redo on trained weights: "
        f"{sum(redone)} of {n_lists} rows in {len(redone)} batches")

    # --------------- the windowed rankers, on the same weights and split
    windowed_rankers(recs[1024], score_fn, test, data, kernels, count_path,
                     [users_all[start + r * 1024:start + (r + 1) * 1024]
                      for r in range(RANKER_BATCHES)])

    # ------------------ the ported tools/ probes, at their full width
    measured.update(probes_phase(kernels, count_path))

    rows_json = [dict(name=name, route="cuda", source=src, replaces=rep,
                      launches=launches[name], **measured[name])
                 for name, _, src, rep in kernels]
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows_json}))
    log(card)  # name, power limit: as nvidia-smi prints them
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
