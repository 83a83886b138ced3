#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sibrar_tpu_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a Hopper card (sm_90a), the
CUDA toolkit and PyTorch built for CUDA:

    python3 chip_smoke.py

It builds the hand-written kernels from ``sibrar_tpu_torch/csrc/``, checks
each kernel against its plain PyTorch version at the serving path's shapes,
then serves SBNet (``conf/single/sbnet_onion18_huge_no-user.yml`` widths,
random weights from a seed) over onion-scale synthetic data (50,000 users x
100,352 items x 2M interactions): catalog encode, then request batches at
B = 256 and B = 1024 with k = 100. The lists are checked against the users'
train + val history (scipy, on the host) and against the plain path on the
same card (``torch.matmul`` + scatter + ``torch.topk``), and the kernels'
launch counts during that run must all be positive.

Output: progress lines, then one JSON line with a row per kernel, the card's
name and power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", ...}}``. Any failed check
raises, so the exit code is non-zero and no result line is printed. There is
no CPU mode: without a CUDA device it exits with code 1.
"""
from __future__ import annotations

import importlib.util
import json
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

DEVICE = "cuda"
SEED = 0
K = 100
BATCHES = {256: 8, 1024: 4}  # batch size -> timed request batches
F32_EPS = 2.0 ** -24


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


def max_abs_err(a, b) -> float:
    """Largest |a - b| over two same-shape tensors; equal entries (equal
    infinities included) count 0, a NaN anywhere reads as NaN."""
    import torch

    a, b = a.double(), b.double()
    if not a.numel():
        return 0.0
    return float(torch.where(a == b, 0.0, (a - b).abs()).max())


def check_kernels(data, dev) -> dict:
    """Each kernel against its plain version on the card, at the serving
    path's shapes; returns name -> {max_abs_err, ms, plain_ms}."""
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
    rows_out["segment_gather"] = dict(max_abs_err=max(errs),
                                      ms=times[0][0], plain_ms=times[0][1])

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
    rows_out["score_wmax"] = dict(max_abs_err=err, ms=ms, plain_ms=pms)

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
    log(f"K3 gather_windows B={b} m={m}: bit-equal (also the k={K} winner "
        f"rows); kernel {ms:.4f} ms, plain {pms:.4f} ms")
    rows_out["gather_windows"] = dict(max_abs_err=err, ms=ms, plain_ms=pms)

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
    rows_out["peel_values"] = dict(max_abs_err=err, ms=ms, plain_ms=pms)
    return rows_out


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
    excl = split.exclude_matrix().tocsr()
    seen = np.asarray(excl[np.repeat(users, K), ids.reshape(-1)]).reshape(-1)
    if seen.any():
        raise AssertionError(f"{int(seen.sum())} returned items were seen")
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
    from sibrar_tpu_torch import full_f32
    from sibrar_tpu_torch.data.dataset import make_splits
    from sibrar_tpu_torch.data.synthetic import make_onion_scale_splits
    from sibrar_tpu_torch.models.sbnet import SingleBranchNet
    from sibrar_tpu_torch.ops import _cuda, peel, sparse, window
    from sibrar_tpu_torch.serve import Recommender
    from sibrar_tpu_torch.train.scoring import make_score_fn

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
                "sibrar_tpu/ops/pallas_peel.py:240")]

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
    test = splits["test"]
    data = test.to_device(dev)
    log(f"data: {time.perf_counter() - t0:.2f} s; {arrays['n_users']} users "
        f"x {arrays['n_items']} items; train {len(arrays['train'])}, val "
        f"{len(arrays['val'])}, test {len(arrays['test'])}; exclusion nnz "
        f"{data.exclude_csr.nnz}, E = {data.exclude_csr.max_row_len}; item "
        f"CSR nnz {data.item_inter_csr.nnz}, longest row "
        f"{data.item_inter_csr.max_row_len}; user CSR longest row "
        f"{data.user_inter_csr.max_row_len}")

    # -------------------------------------------- kernels vs plain versions
    measured = check_kernels(data, dev)

    # ------------------------------------------------ the serving slice
    model = SingleBranchNet.build_from_conf(MODEL_CONF, test, data,
                                            seed=SEED)
    for _, fn, _, _ in kernels:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    score_fn = make_score_fn(model, data.catalog)
    torch.cuda.synchronize()
    log(f"catalog encode: {time.perf_counter() - t0:.3f} s for "
        f"{data.catalog.shape[0]} items (chunks of 8192)")
    users_all = np.random.default_rng(SEED).permutation(arrays["n_users"])
    served, start = [], 0
    for bs, n_batches in BATCHES.items():
        rec = Recommender(score_fn, test, data, k=K, batch_size=bs)
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
        log(f"B={bs}: p50 {p50:.3f} ms per request batch over {n_batches} "
            f"batches (host clock, after one warm-up) on {card}; redone rows "
            f"per batch {rec.redo_rows}")
    launches = {name: fn.launches for name, fn, _, _ in kernels}
    log(f"launches in the serving run: {launches}")
    log(f"max_memory_allocated: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the serving path: "
                             f"{missing}")
    differ = sum(check_lists(test, data, score_fn, *batch)
                 for batch in served)
    log(f"{sum(len(b[0]) for b in served)} lists checked: no seen item, "
        f"sorted, equal to the plain path ({differ} differ only on ties)")

    rows = [dict(name=name, route="cuda", source=src, replaces=rep,
                 launches=launches[name], **measured[name])
            for name, _, src, rep in kernels]
    log(json.dumps({"kernels": rows}))
    log(card)  # name, power limit: as nvidia-smi prints them
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
