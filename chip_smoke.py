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
   K2's scores; K3 as ``gather_windows_rows`` at the test split's m = 160
   windows; K11 ``recover_winners`` at the end of the dot path's selection,
   m = 168 windows and k = 100 winners, with planted rows (NaN winners, an
   in-window tie, a -inf winner, an incomplete row) and at B = kk = m = 1,
   kk = 37 and 601, ids and row flags bit-equal; the plane peel's
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
2. logs the user tower's bag rows on the train batch, holds K6 and K7 to
   their plain versions on them (within the f32 sum bound; bit-equal to
   the CPU's), and times their first layer as it ran before K6 / K7 took
   it (gather and masked sum) and as it runs now (K6 / K7); holds K6 / K7
   to their plain versions on one-slot rows (an `Embedding` lookup of a
   train batch's 5,632 items, H = 1, 256, 512) and ``coalesce_rows`` on
   the card bit-equal to the CPU's; records the inputs K6 and K7 get in
   one default train step (the user bag rows, the genres tag rows, with
   the output gradients autograd hands K7) and holds each to its plain
   version; trains with ``Trainer.train_epoch`` (the config's learn /
   dataset / loader settings): a warm-up, then a few hundred timed steps
   on the default first layer (the item tower's densify + matmul with K5
   backward, the user tower's bag path and the embeddings on K6 / K7),
   whose losses must be finite and fall; a profiled window; then a few
   dozen steps with ``INTERACTION_SPMM`` on (K6 / K7 for the item tower
   too) and a profiled window of them; then, on fresh trainers:
   ``determinism`` (two trainings of one seed must end bit-equal in
   parameters, batch-norm statistics and optimizer state, on each
   first-layer path; K6 / K7 launches logged), ``resume`` (train,
   ``save_checkpoint``, train on; a fresh trainer that loads the
   checkpoint and trains the same steps must end bit-equal) and
   ``bf16_moments`` (bf16 first moments, finite);
3. times the item tower's first layer and the catalog encode both ways;
4. from the default training's weights, runs ``Trainer.fit`` (the YAML's
   learn / eval settings, 2 epochs of 60 steps, each validation over the
   50,000 users of the val split through the dot path) and checks that
   ``validate()`` afterwards returns fit's best metrics exactly; then, on
   fit's weights, validates once per ranking path (dot; scores with K8 and
   the peel; ``pallas`` with K9 and K3 on the tiling; ``full``), checks the
   key set and ranges of every metric dict, and holds sample batches' lists
   to the plain oracle (`plain_oracle`: the exclusion fill and K13's plain
   version, no kernel), the ``full`` path's bit for bit;
5. serves from the weights the default training left: catalog encode, then
   request batches at B = 256 and B = 1024 with k = 100. The lists are
   checked against the users' train + val history (scipy, on the host) and
   against the plain path on the same card (``torch.matmul`` + scatter +
   K13's plain version);
6. on the same weights, serves batches of 1,024 test users through the
   windowed rankers: ``peel.peel_masked_topk`` (K10, K3 on the planes, K4,
   K11), ``window.pallas_masked_topk`` (K10, K3 on the tiling),
   ``score.fused_masked_topk`` (K12) and ``exact_topk`` over K2's scores
   after the exclusion fill (K13), and holds each list to the
   ``Recommender``'s for the same users: values bit-equal, ids equal up to
   exact ties, no excluded item; then profiles the plane peel's device time
   per batch; then the ``Recommender``'s other
   modes at B = 256 and 1,024 (`serving_modes`): ``dtype="bfloat16"`` (K15
   and the peel; K15 within ``D 2^-24 (|u~| @ |i~|^T)`` of the rounded
   operands' exact product at the serving shapes, lists the exact top-k of
   its own masked scores), ``dtype="int8"`` (``torch._int_mm``, K8 and the
   peel; ``q``, ``s`` and the int32 products bit-equal to the CPU's, lists
   exact for the dequantized scores) and ``selection="approx"`` in f32 and
   int8 (K13; the exact recommender's lists), with latency, recall against
   the f32 lists, redo rows and the item table's bytes;
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
   and ``try_mask`` must report ok, and ``try_recover`` must find K11's ids
   and row flags bit-equal to plain at m = 168;
8. runs the port's CLI end to end from artifacts (`cli_phase`): the
   onion-scale splits written by the port's ``write_reference_artifacts``
   (~0.9 GB, deleted at the end), each split loaded by ``RecDataset.load``
   and held bit for bit to the in-memory one, then ``python -m
   sibrar_tpu_torch.run_experiment -a sbnet -c
   conf/single/sbnet_onion18_huge_no-user.yml -t train_val_test`` in this
   process with the onion-scale overrides of ``tests/test_cli_e2e.py`` and
   2 epochs of 100 steps (``run_settings.device: tpu`` from the YAML: the
   card): the four run files, JAX's metric keys, finite values,
   ``metrics_val.yml`` equal to fit's best validation; its times (write,
   load per split, host ms per train step, validation and test wall,
   peak memory) are logged beside the card's name and power limit; then
   serving from that run directory (`reload_phase`):
   ``Recommender.from_run_dir`` serves 1,024 test users, equal to a
   ``Recommender`` built here from the same ``model.pt``;
   ``sibrar_tpu_torch.serve_recs`` writes their bf16 lists as JSONL, equal
   to the in-process bf16 lists; one test evaluation with ``score_dtype:
   bfloat16`` gives JAX's keys, finite, beside the f32 test metrics; then
   ``mf_sparse``: ``-a mf -c conf/single/mf_onion18.yml -t train_val`` on
   the same artifacts with ``learn.sparse_tables=true
   learn.optimizer=adam``, both id tables row-sparse, every row no step
   touched holding its initial bits and zero moments, its ms per step and
   peak memory logged, and K7 at ``coalesce_rows``' [M, 1] calls of both
   tables (K6 at the run's one-slot lookups) held to the plain versions on
   the inputs the run gave them; then ``-a dmf -c
   conf/single/dmf_onion18.yml -t train_val`` on the same artifacts, one
   epoch of 100 steps: the run files and JAX's keys, its wall time; then
   (`zoo_cli_phase`, 100 steps each) ``-a uprotomfs`` and ``-a iprotomfs
   -c conf/base.yml -t train_val`` with the prototype diagnostics among
   the metrics, ``-a uiprotomfs_combine --split_set test`` on the two run
   directories, ``-a ecf -c conf/ecf.yml -t train_val``, ``-t gather`` on
   that run (the pickle's keys, shapes and exclusions) whose metrics must
   equal ``-t test``'s, a gather of the UProtoMFs run and
   ``stat_tests.compare_gathers`` over the two; then the sweeps
   (`sweep_phase`): ``sweep_agent.main`` in this process on a copy of
   ``conf/sweeps/sbnet/sbnet_onion18_random_huge_no-user.yml`` (bayes, its
   seed and parameters) whose two trials train SBNet at the YAML's width
   on the same artifacts for 100 steps each, validate and test: the trials
   are a fresh ``TPESampler``'s startup draws, each run's files carry
   JAX's keys, the best run alone keeps ``model.pt``, and
   ``torch.cuda.memory_allocated()`` is back within SWEEP_MEMORY_MARGIN of
   its start after every trial, each trial's time, steps/s, val ndcg@10
   and peak memory logged; then ``python -m sibrar_tpu_torch.run_agent -p
   2 --trials-per-worker 2 --devices 0,0``, a bayes sweep with
   ``shared_history`` over ``mf`` on the mid-scale artifacts, two workers
   on the one card: both exit 0, both state files, four shared
   observations, the best two runs keep ``model.pt``; then the mesh
   (`mesh_phase`): four ranks launched by torchrun on the one card as a
   (data 2, item 2) mesh over gloo (the collectives gloo takes on CUDA
   tensors probed and logged) on the same artifacts and run directory:
   the CLI run's ``model.pt`` validated on the mesh, both towers' kernels
   row-sliced (metrics equal to one device's on the same
   representations within 1e-5, and within MESH_TP_ATOL of the CLI's
   single-process validation; for 1,024 users the sharded dot chain's
   values bit-equal and ids equal to the unsharded chain's), MESH_STEPS
   train steps against the same steps in this process (the first step's
   loss within MESH_FIRST_RTOL, every step's within MESH_LOSS_RTOL), 1,024
   test users served on the mesh against
   one device (the same lists up to ties of the tensor-parallel
   representations), K1-K7 and K13 launched on every rank; then ``python
   -m sibrar_tpu_torch.run_experiment -t train_val_test`` under torchrun
   with ``parallel.enabled`` (MESH_CLI_BATCHES steps): exit 0, the four
   run files once;
9. ``zoo``: DMF, ifeatmf, ufeatmf and DropoutNet, each at the full width
   of its ``conf/single/<name>_onion18.yml`` (the YAML chain's learn /
   dataset / loader blocks too), random weights from a seed, on the same
   splits with the user features those configs read added in memory
   (``gender``, ``country``, a 768-wide ``acg_with_unknown_mpnet``):
   each interaction tower's first-layer path logged (the user towers' bag
   path, the item towers' dense path); K5 held to its plain version on the
   rows one train step gives it (and on L2-normalized rows, DMF with
   ``normalize_interactions``), K6 / K7 at every spmm call site of one
   step; then 20 + 100 train steps (finite, falling losses), one
   validation (JAX's keys, the dot path) and one serving batch of 1,024
   test users (`check_lists`), each family gated by its kernels'
   launches, with host ms per step, a profiled window and peak memory;
   then the six ProtoMF variants at the JAX builds' widths (100-d, 20
   prototypes; ``conf/base.yml``'s other blocks) and ECF at
   ``conf/ecf.yml``'s (128-d, 64 clusters, the ``genres`` tags) the same
   way, K6 / K7 at their lookups, K13 on ECF's recorded mask and tag-loss
   rows with an all-zero row added, bit-equal to its plain version, one
   train step of UProtoMF and of ECF twice from one state, bit-equal, and
   the ProtoMF post-validation keys (UIProtoMFs has no dot parts, as in
   JAX: its validation and serving rank on the scores path, K8);
10. ``quality``: seed 0 of ``sbnet``, ``dmf``, ``dropoutnet``, ``ifeatmf``,
   ``ufeatmf`` and ``uprotomf`` of the trained-quality run at mid scale
   (``sibrar_tpu_torch/tools/trained_parity.py``) must each score above
   0.03 and within 0.015 of JAX's seed 0 (``trained_parity_jax.json``);
11. ``matrix``: iknn at ``conf/single/knn.yml``'s width (k = 100,
   shrinkage 10, cosine) on the onion-scale splits: the item-item
   similarity from full-f32 GEMMs of the dense [100,352 x 50,000] train
   matrix with K13 per block of 4,096 rows (K13 on the recorded blocks and
   an all-zero row bit-equal to its plain version; sampled rows bit-equal
   to the host's f32 chain on exact counts and within 4 ulps of float64;
   K13's time at the block shape beside ``torch.topk``'s), the host's
   sparse product, one validation of the 50,000 val users through the
   peel (K1, K8, K3, K4) and a serving batch of 1,024 whose ids and values
   equal the plain oracle's bit for bit; pop and rand the same way;
   uknn, ifknn (over ``ivec256``), EASE, SLIM, P3alpha, ALS, SVD and RBMF
   at ML-1M's shape (6,040 x 3,706, 1,000,209 draws), each fitted,
   validated and serving one batch (K1, K13); all eleven names through
   ``run_experiment -t train_val_test`` on the mid-scale artifacts, ``-t
   gather`` (its metrics equal ``-t test``'s) and ``serve_recs``; the
   matrix quality run at mid scale against JAX's committed values (the
   exact fits within 1e-3, als at seed 0 within 0.01, rand by the
   paired-seed delta). Fit,
   validation and serving times, peak device memory, host peak RSS and
   K13 launches are logged beside the card's name and power limit;
12. ``preprocess`` (run after the probes, before the CLI): a raw dataset in
   the layout ``parse_onion`` writes, made from a seed (~12M listening
   events of 50,000 users over 200,000 tracks with a Zipf popularity tail,
   each pair 1-6 times across 2018; onion18.yml's user features; item
   vectors ivec256 / bert / musicnn at 256 / 384 / 128 and genre tags),
   through ``python -m sibrar_tpu_torch.preprocess_dataset`` (its ``main``)
   with onion18.yml's split, interaction filters and user-feature steps,
   for the random and the cold-start item split, on the card and with
   ``--device cpu``: the two artifact trees byte-equal file by file, each
   stage's seconds logged (read, filters, k-core, reindex, split,
   normalize, store); then SBNet at onion18's width loaded from the
   card-made random split, PREP_STEPS train steps, one validation on the
   dot path and one on the full path, each gated by its launches.

Before the first path, ``lax_topk`` runs on rows past K13's row limit at
a k where 128-wide windows could not narrow them (LONG_ROWS: K13 over
chunks, and the sort at k >= MAX_N), values and ids bit-equal to the
plain version.

Each path (default training, spmm training, the determinism run, fit, the
four validation paths, serving, the five windowed rankers, the four serving
modes at each batch size, the probes, the CLI, the reload, ``serve_recs``,
the bf16 test evaluation, row-sparse MF, the DMF, ProtoMF and ECF CLI
runs, the gathers, the combine, the SBNet sweep, each zoo family, each
matrix run) runs with
every launch count set to 0 just before it and read just after; each of
its kernels must have launched, and kernels of other paths must not. On
every path that peels, each selection ends in one K11 launch (as many as
K4's) and none gathers the winners' rows through K3
(``peel.gather_subwindows``).

Output: progress lines, then one JSON line with a row per kernel, the card's
name and power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", ...}}``. Any failed check
raises, so the exit code is non-zero and no result line is printed. There is
no CPU mode: without a CUDA device it exits with code 1.
"""
from __future__ import annotations

import contextlib
import copy
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
TRAIN_STEPS = 200  # timed steps on the default first layer
LOSS_WINDOW = 50  # steps in the first and last loss windows
PROFILE_STEPS = 10  # train steps under torch.profiler
PROFILE_BATCHES = 5  # request batches of each size under torch.profiler
SPMM_WARMUP, SPMM_STEPS = 5, 40  # steps with INTERACTION_SPMM on
FIT_EPOCHS, FIT_BATCHES = 2, 60  # Trainer.fit: epochs, steps per epoch
LIST_BATCHES = (0, 20, 48)  # validation batches whose lists are checked
RANKER_BATCHES = 3  # batches of 1,024 test users per windowed ranker
MODE_BATCHES = 4  # timed request batches per serving mode and batch size
INT8_CPU_USERS = 64  # users whose int8 product is checked against the CPU's
RELOAD_USERS = 1024  # test users served from the CLI's run directory
# K11's windows a row: the margin path's m at E = 61-68 exclusions (the
# onion splits' longest rows give 144-160), as its probe and JAX's
# measurements of its Pallas kernel take it
RECOVER_M = 168
TURNS, TURN_ITERS = 7, 200  # rounds x calls of a host-bound events loop
F32_EPS = 2.0 ** -24
# H100 SXM peaks (NVIDIA data sheet; at 700 W): HBM bytes/s, f32 FLOP/s
# outside the tensor cores, dense bf16 FLOP/s and int8 OP/s on the tensor
# cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12  # dense int8 on the tensor cores


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


def winner_rows(p, t: int) -> int:
    """The distinct (row, window) pairs among K11's winners at positions
    ``p [B, kk]`` of ``t`` peeled values a window: the window rows that it
    must read from HBM (a row shared by several winners is read once)."""
    s = (p // t).sort(dim=1).values
    return s.shape[0] + int((s[:, 1:] != s[:, :-1]).sum())


def recover_bytes(rows: int, b: int, m: int, kk: int) -> int:
    """K11's bytes, each once: 512 of ``g`` and 4 of ``widx`` a distinct
    winner row; ``p`` (8), ``v`` (4) and ``idx`` (8) a winner; ``last``
    (4 a window) and ``ok`` (1) a user row."""
    return rows * (128 * 4 + 4) + b * kk * (8 + 4 + 8) + b * (m * 4 + 1)


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
    rows_out.update(check_recover(scores, wmax))
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
            check_spmm_case(f"K6 edge {label}", cols, mask, n_cols,
                            kernel[:, :h].contiguous())


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


def check_recover(scores, wmax) -> dict:
    """K11 at the end of a dot-path selection (B = 1,024, kk = K, m =
    RECOVER_M): its inputs from the peel's own stages on K2's scores (K3
    with 2 % dead lanes, K4, the stable merge, whose ``v`` and ``p`` are
    row slices), with rows planted: a NaN winner, a NaN k-th value, an
    in-window tie, a -inf winner on dead lanes, a window whose deepest
    value beats the k-th winner; then B = kk = m = 1, and kk = 37 and 601
    (not multiples of its 4 warps; 601 past its 128 winners a pass). Ids
    and row flags bit-equal to the plain version everywhere; the planted
    rows flagged."""
    import torch

    from sibrar_tpu_torch.ops import peel
    from sibrar_tpu_torch.tools import _common

    dev = scores.device
    b = scores.shape[0]
    m, t = RECOVER_M, peel.PEEL_T
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    widx = (peel._topk_stable(wmax, m)[1].sort(dim=1).values
            .to(torch.int32).contiguous())
    dead = torch.rand(b, m, 128, device=dev, generator=gen) < 0.02
    g = peel.gather_windows(scores, widx, dead)
    vals_flat, last = peel.peel_values_grouped(g, t)
    v, p = peel._topk_stable(vals_flat, K)
    slot = (p[:, [0, K - 1]] // t).tolist()
    v[0, 5], v[1, K - 1] = math.nan, math.nan
    lane = int((g[2, slot[2][0]] == v[2, 0]).nonzero()[0])
    g[2, slot[2][0], (lane + 1) % 128] = v[2, 0]  # a tie in its window
    g[3, slot[3][1], :3] = float("-inf")
    v[3, K - 1] = float("-inf")
    last[4, 7] = v[4, K - 1] + 1.0  # incomplete
    planted = 5

    errs = []

    def held(label, *args):
        got = peel.recover_winners(*args)
        errs.append(exact(f"K11 recover_winners {label}", got,
                          peel.recover_plain(*args)))
        return got

    idx, ok = held(f"B={b} m={m} kk={K}", g, widx, p, t, v, last)
    if ok[:planted].any():
        raise AssertionError(f"K11: a planted row passed: {ok[:planted]}")
    n_ok = int(ok[planted:].sum())
    g1 = g[:1, :1].contiguous()
    held("B=kk=m=1", g1, widx[:1, :1].contiguous(),
         torch.zeros(1, 1, dtype=torch.int64, device=dev), t,
         g1[:, 0, :1].clone(), last[:1, :1].contiguous())
    for kk in (37, 601):
        vk, pk = peel._topk_stable(vals_flat, kk)
        held(f"kk={kk}", g, widx, pk, t, vk, last)
    args = (g, widx, p, t, v, last)
    rows = winner_rows(p, t)
    out = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: peel.recover_winners(*args), 50),
        plain_ms=cuda_ms(lambda: peel.recover_plain(*args), 50),
        library_ms=None,
        **bound(recover_bytes(rows, b, m, K)))
    device = _common.device_ops_ms(lambda: peel.recover_winners(*args), dev,
                                   50, "recover_winners")
    torch.cuda.synchronize()  # host time of an enqueue, the wrapper's
    t0 = time.perf_counter()
    for _ in range(200):
        peel.recover_winners(*args)
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    log(f"K11 recover_winners B={b} m={m} kk={K} t={t}: ids and row flags "
        f"bit-equal to plain (planted rows 0-{planted - 1} flagged, "
        f"{n_ok} of {b - planted} others ok), also at B = kk = m = 1 and "
        f"kk = 37, 601; {rows} distinct winner rows of {b * K} winners; "
        f"device time per launch (profiler) {device}; host "
        f"{host_us:.1f} us per call (200 enqueued, no sync); {out}")
    return {"recover_winners": out}


def check_ranker_kernels(u, items, scores, wmax, m: int) -> dict:
    """K10, K3 as ``gather_windows_rows``, K12 and K13 against their
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


def plain_oracle(scores, csr, users, k: int):
    """The exact top-k the lists are held to, built with no kernel of the
    port: the user's CSR row gathered and filled with -1e30 in plain
    torch, then K13's plain version (a stable sort of the f32 total-order
    keys), which gives ``lax.top_k``'s order. ``(values, ids)`` on the
    host."""
    import torch

    from sibrar_tpu_torch.ops.exact_topk import exact_topk_plain
    from sibrar_tpu_torch.ops.sparse import (
        scatter_fill_rows,
        segment_gather_plain,
    )
    from sibrar_tpu_torch.ops.topk import NEG

    u = torch.as_tensor(users, device=scores.device)
    cols, mask = segment_gather_plain(csr.indptr, csr.indices, u,
                                      csr.max_row_len)
    v, i = exact_topk_plain(scatter_fill_rows(scores, cols, mask, fill=NEG),
                            k)
    return v.cpu().numpy(), i.cpu().numpy()


def check_lists(split, data, score_fn, users, ids, vals) -> int:
    """No returned item from the user's train + val history, lists sorted
    descending, and equal to the plain path (matmul of the dot parts, or
    the scorer itself where it has none, then `plain_oracle`) on the card
    up to ties. Returns the number of rows whose id set differs from
    the plain path's (only on near-ties)."""
    import numpy as np
    import torch

    if not np.isfinite(vals).all() or ids.shape != (len(users), K):
        raise AssertionError(f"bad output: shape {ids.shape}, finite "
                             f"{np.isfinite(vals).all()}")
    check_excluded(split, users, ids)
    if (np.diff(vals, axis=1) > 0).any():
        raise AssertionError("lists are not sorted descending")

    u_t = torch.as_tensor(users, device=data.catalog.device)
    if score_fn.dot_parts is None:  # the scores path ranks score_fn's own
        scores = score_fn(u_t)
        bound = (F32_EPS * scores.abs().amax(dim=1)).cpu().numpy()
    else:
        user_fn, items = score_fn.dot_parts
        u_repr = user_fn(u_t)
        scores = torch.matmul(u_repr, items.T)
        # per-row f32 GEMM error bound: 2 * D * eps * max_c |u| . |x_c|
        bound = (2 * u_repr.shape[1] * F32_EPS
                 * (u_repr.abs() @ items.abs().T).amax(dim=1)).cpu().numpy()
    pv, pi = plain_oracle(scores, data.exclude_csr, users, K)
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


def same_as_oracle(label: str, split, users, ids, vals, scores, csr,
                   catalog_items) -> None:
    """Served lists against the exact top-k of the masked ``scores`` the
    mode ranks ([B, C], catalog positions; `plain_oracle`): sorted, no
    seen item, values bit-equal, ids equal up to exact ties."""
    import numpy as np

    if (np.diff(vals, axis=1) > 0).any():
        raise AssertionError(f"{label}: lists are not sorted descending")
    check_excluded(split, users, ids)
    ov, oi = plain_oracle(scores, csr, users, K)
    if not np.array_equal(vals, ov):
        raise AssertionError(f"{label}: values are not the exact top-k of "
                             f"its own masked scores")
    position = np.zeros(int(catalog_items.max()) + 1, dtype=np.int64)
    position[catalog_items] = np.arange(len(catalog_items))
    pos = position[ids]
    for r in np.nonzero((np.sort(pos, 1) != np.sort(oi, 1)).any(1))[0]:
        extra = sorted(set(pos[r].tolist()) ^ set(oi[r].tolist()))
        if not bool((scores[r, extra] == float(ov[r, -1])).all()):
            raise AssertionError(f"{label}: row {r} differs from the exact "
                                 f"top-k beyond ties")


def serving_modes(f32_recs, score_fn, split, data, kernels, count_path,
                  users_all, card: str) -> None:
    """The ``Recommender``'s other modes on the served weights, at B = 256
    and 1,024 (one warm-up batch, then MODE_BATCHES timed ones, the same
    users for every mode), each run gated by its launches:

    - ``bf16`` (K15 + the peel): K15's scores within ``D 2^-24 (|u~| @
      |i~|^T)`` of the rounded operands' float64 product at these shapes
      (`_common.bf16_within`), `score_bf16_wmax` K15's maxima in K2's
      layout, the lists the exact top-k of K15's own masked scores;
    - ``int8`` (``torch._int_mm``, K8 + the peel): ``q`` and ``s`` of the
      table and of a batch bit-equal to the CPU's on copies, the int32
      products of INT8_CPU_USERS users bit-equal to the CPU's, the lists
      the exact top-k of the dequantized scores;
    - ``approx`` in f32 and int8 (exclusion fill + K13): the lists equal
      the exact recommender's of the same dtype (values bit-equal, ids up
      to exact ties).

    Logs per mode and batch size the p50 request latency (host clock),
    CUDA-event time per batch, the share of the f32 lists' items each
    list holds (recall@100 against f32), redo rows and the item table's
    bytes; and K15 / K2 / ``torch._int_mm`` at B = 1,024 on the catalog."""
    import numpy as np
    import torch

    from sibrar_tpu_torch.ops import gemm_probe, window
    from sibrar_tpu_torch.serve import (
        Recommender,
        _pad_int8,
        int8_scores,
        quantize_rows_int8,
    )
    from sibrar_tpu_torch.tools import _common

    user_fn, items = score_fn.dot_parts
    c = items.shape[0]
    csr = data.exclude_csr
    catalog_items = np.asarray(split.items_in_split)
    peel_k = ["segment_gather", "gather_windows", "peel_values",
              "recover_winners", "spmm_fwd"]
    # K13 may launch on the peel's paths: it selects the rows they redo
    modes = (
        ("bf16", dict(dtype="bfloat16"), peel_k + ["score_bf16"],
         ("score_wmax", "window_max")),
        ("int8", dict(dtype="int8"), peel_k + ["window_max"],
         ("score_wmax", "score_bf16")),
        ("approx", dict(selection="approx"),
         ["segment_gather", "score_wmax", "exact_topk", "spmm_fwd"],
         ("score_bf16", "window_max", "gather_windows", "peel_values",
          "recover_winners")),
        ("approx int8", dict(dtype="int8", selection="approx"),
         ["segment_gather", "exact_topk", "spmm_fwd"],
         ("score_wmax", "score_bf16", "window_max", "gather_windows",
          "peel_values", "recover_winners")))
    exact_recs = {("f32", bs): rec for bs, rec in f32_recs.items()}
    t_phase = time.perf_counter()
    for bs in BATCHES:
        users = users_all[:(MODE_BATCHES + 1) * bs]
        batches = [users[i:i + bs] for i in range(0, len(users), bs)]
        f32_ids = [f32_recs[bs].recommend(u) for u in batches]
        for name, kw, needed, absent in modes:
            rec = Recommender(score_fn, split, data, k=K, batch_size=bs,
                              **kw)
            if rec.use_dot != (name == "bf16"):
                raise AssertionError(f"serving mode {name}: use_dot "
                                     f"{rec.use_dot}")
            reset_counts(kernels)
            lat, event_ms, served = [], [], []
            for u in batches:
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                ev0.record()
                ids, vals = rec.recommend(u, return_scores=True)
                ev1.record()
                torch.cuda.synchronize()
                lat.append(time.perf_counter() - t1)
                event_ms.append(ev0.elapsed_time(ev1))
                served.append((u, ids, vals))
            count_path(f"serving mode {name}, B={bs}", needed, absent)

            dtype = "int8" if "int8" in name else (
                "bf16" if name == "bf16" else "f32")
            exact_recs.setdefault((dtype, bs), rec)
            with torch.no_grad():
                for bi, (u, ids, vals) in enumerate(served):
                    u_t = torch.as_tensor(u, device=data.catalog.device)
                    ur = user_fn(u_t)
                    if dtype == "bf16":
                        scores, wmax_t = gemm_probe.score_bf16(ur, rec.items)
                        _common.bf16_within(f"K15 serving B={bs}", scores,
                                            wmax_t, ur, rec.items)
                        if bi == 0 and not torch.equal(
                                gemm_probe.score_bf16_wmax(ur, rec.items)[1],
                                wmax_t.T):
                            raise AssertionError("score_bf16_wmax: not "
                                                 "K15's maxima in K2's "
                                                 "layout")
                        scores = scores[:, :c]
                    elif dtype == "int8":
                        scores = int8_scores(ur, rec.q_items, rec.s_items)
                    else:
                        scores = window.score_wmax(ur, rec.items)[0][:, :c]
                    label = f"serving mode {name}, B={bs}, batch {bi}"
                    same_as_oracle(label, split, u, ids, vals, scores, csr,
                                   catalog_items)
                    if name.startswith("approx"):
                        wids, wvals = exact_recs[(dtype, bs)].recommend(
                            u, return_scores=True)
                        if not np.array_equal(vals, wvals):
                            raise AssertionError(f"{label}: values differ "
                                                 f"from the exact "
                                                 f"recommender's")
                        same_as_oracle(label + " (exact)", split, u, wids,
                                       wvals, scores, csr, catalog_items)
                    if dtype == "int8" and bi == 0:
                        check_int8_on_cpu(items, ur, rec)
            table = (rec.q_items.numel() + 4 * rec.s_items.numel()
                     if dtype == "int8" else 4 * items.numel())
            recall = np.mean([len(set(a) & set(b)) / K
                              for (_, ids, _), f in zip(served, f32_ids)
                              for a, b in zip(ids.tolist(), f.tolist())])
            log(f"serving mode {name}, B={bs}: p50 "
                f"{1e3 * np.median(lat[1:]):.3f} ms per request batch "
                f"(host clock, {MODE_BATCHES} batches after one warm-up), "
                f"CUDA events {np.median(event_ms[1:]):.3f} ms per batch; "
                f"recall@{K} against the f32 lists {recall:.6f}; redo rows "
                f"{rec.redo_rows}; item table {table / 1e6:.3f} MB; on "
                f"{card}; checks passed")
            if bs == max(BATCHES):
                profile_window(lambda: [rec.recommend(u) for u in batches[1:]],
                               MODE_BATCHES,
                               f"request batches of {bs}, serving mode {name}")

    bs = max(BATCHES)
    with torch.no_grad():  # the score GEMMs at B = 1,024 on the catalog
        u_t = torch.as_tensor(users_all[:bs], device=data.catalog.device)
        ur = user_fn(u_t)
        rec = exact_recs[("int8", bs)]
        q_u = _pad_int8(quantize_rows_int8(ur)[0], 0)
        items_p = window.pad_catalog(items)
        times = dict(
            score_bf16=cuda_ms(lambda: gemm_probe.score_bf16(ur, items_p),
                               20),
            score_wmax=cuda_ms(lambda: window.score_wmax(ur, items_p), 20),
            int_mm=cuda_ms(lambda: torch._int_mm(q_u, rec.q_items.T), 20),
            int8_scores=cuda_ms(lambda: int8_scores(ur, rec.q_items,
                                                    rec.s_items), 20))
        # K15's plain version and its library yardstick at this shape: the
        # rounded operands' product with f32 output, no maxima
        u16, i16 = ur.bfloat16(), items_p.bfloat16()
        times["score_bf16_plain"] = cuda_ms(
            lambda: gemm_probe.score_bf16_plain(ur, items_p), 5)
        times["mm_bf16_f32_out"] = cuda_ms(
            lambda: torch.mm(u16, i16.T, out_dtype=torch.float32), 20)
        del u16, i16
    cp, d = items_p.shape
    ops = 2 * bs * cp * d
    stores = 4 * bs * cp + 4 * bs * (cp // 128)  # scores, window maxima
    bounds = dict(
        score_bf16=bound(4 * (bs * d + cp * d) + stores, ops, BF16_FLOPS),
        score_wmax=bound(4 * (bs * d + cp * d) + stores, ops),
        int_mm=bound(q_u.numel() + rec.q_items.numel() + 4 * bs * cp, ops,
                     INT8_OPS),
        int8_scores=bound(4 * bs * d + rec.q_items.numel()
                          + 4 * rec.s_items.numel() + 4 * bs * c, ops,
                          INT8_OPS),
        mm_bf16_f32_out=bound(2 * (bs * d + cp * d) + 4 * bs * cp, ops,
                              BF16_FLOPS))
    log(f"score GEMMs at B={bs}, C={c}, D={d} (CUDA events, ms per call) "
        f"on {card}: {times}; bounds {bounds}")
    log(f"serving modes: {time.perf_counter() - t_phase:.2f} s")


def check_int8_on_cpu(items, ur, rec) -> None:
    """The int8 mode on the card against the CPU on copies: the table's and
    a batch's ``q`` and ``s`` bit for bit (the Recommender's table too),
    and the int32 products of the first INT8_CPU_USERS users."""
    import torch

    from sibrar_tpu_torch.serve import _pad_int8, quantize_rows_int8

    c, d = items.shape
    for label, x in (("table", items), ("users", ur)):
        q, s = quantize_rows_int8(x)
        qc, sc = quantize_rows_int8(x.cpu())
        if not (torch.equal(q.cpu(), qc) and torch.equal(
                s.cpu().view(torch.int32), sc.view(torch.int32))):
            raise AssertionError(f"int8 {label}: q or s differ from the "
                                 f"CPU's")
        if label == "table" and not torch.equal(rec.q_items[:c, :d].cpu(),
                                                qc):
            raise AssertionError("int8: the Recommender's table is not the "
                                 "CPU's quantization")
    q_u = _pad_int8(quantize_rows_int8(ur[:INT8_CPU_USERS])[0], 0)
    got = torch._int_mm(q_u, rec.q_items.T)
    if not torch.equal(got.cpu(), torch._int_mm(q_u.cpu(),
                                                rec.q_items.cpu().T)):
        raise AssertionError("int8: the card's int32 products differ from "
                             "the CPU's")


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

    def tiled(ur, cols, mask):
        return window.pallas_masked_topk(ur, items, cols, mask, K)

    def fused(ur, cols, mask):
        return score.fused_masked_topk(
            ur, items, torch.where(mask, cols, 1 << 30), K)

    def exact_fill(ur, cols, mask):
        scores = window.score_wmax(ur, items_p)[0][:, :c].contiguous()
        return xtopk.exact_topk(scatter_fill_rows(scores, cols, mask,
                                                  fill=-1e30), K)

    # K13 may launch on the plane peel: it selects the rows the peel redoes
    others = ("score_wmax", "fused_score_wmax", "window_scores_from",
              "window_max")
    paths = (
        ("peel_masked_topk", peel_planes,
         ["segment_gather", "score_windows", "gather_windows_rows",
          "peel_values", "recover_winners"],
         others + ("gather_windows", "gather_windows_tiled")),
        ("pallas_masked_topk", tiled,
         ["segment_gather", "score_windows", "gather_windows_tiled"],
         others + ("gather_windows_rows", "peel_values", "recover_winners",
                   "exact_topk")),
        ("fused_masked_topk", fused, ["segment_gather", "fused_score_wmax"],
         ("score_wmax", "score_windows", "exact_topk", "peel_values",
          "recover_winners")),
        ("exact_topk after the exclusion fill", exact_fill,
         ["segment_gather", "score_wmax", "exact_topk"],
         ("score_windows", "fused_score_wmax", "peel_values",
          "recover_winners", "gather_windows")))
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
                         peel_planes)


def recovery_device_time(batches, user_fn, csr, dev, peel_fn) -> None:
    """Device busy ms per batch of the plane peel, whose selections end in
    K11, under the profiler over the same batches' user vectors and
    exclusions (device time repeats within 0.001 ms: one session). A pass
    before it counts K11's distinct winner rows on these trained scores,
    and its bound with each row read once against one read a winner."""
    import torch

    from sibrar_tpu_torch.ops import peel
    from sibrar_tpu_torch.ops.sparse import csr_row_gather

    with torch.no_grad():
        inputs = []
        for users in batches:
            u_t = torch.as_tensor(users, device=dev)
            inputs.append((user_fn(u_t), *csr_row_gather(csr, u_t)))
        seen = []  # (distinct rows, B, m, kk) of each K11 call
        real = peel.recover_winners

        def counted(g, widx, p, t, v, last):
            seen.append((winner_rows(p, t), *g.shape[:2], p.shape[1]))
            peel.recover_winners = real  # its count is read by that name
            try:
                return real(g, widx, p, t, v, last)
            finally:
                peel.recover_winners = counted

        peel.recover_winners = counted
        try:
            for args in inputs:
                peel_fn(*args)
        finally:
            peel.recover_winners = real
        busy = profile_window(lambda: [peel_fn(*args) for args in inputs],
                              len(inputs),
                              "batches of 1,024, plane peel, K11 recovery")
    if not seen:
        raise AssertionError("the plane peel made no K11 call")
    rows = sum(r for r, *_ in seen)
    winners = sum(b * kk for _, b, _, kk in seen)
    once = sum(bound(recover_bytes(*x))["bound_ms"] for x in seen)
    each = sum(bound(recover_bytes(b * kk, b, m, kk))["bound_ms"]
               for _, b, m, kk in seen)
    log(f"plane peel device ms per batch of 1,024 (K11 recovery): {busy}; "
        f"K11 on these trained scores: {len(seen)} calls, {rows} distinct "
        f"winner rows of {winners} winners ({100 * rows / winners:.2f} %), "
        f"bound {once / len(seen):.5f} ms a call (a row read once; "
        f"{each / len(seen):.5f} ms with one row read a winner)")


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
                "peel_values", "recover_winners", "dw_matmul", "spmm_fwd",
                "spmm_bwd"],
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
    ``full`` (scatter + K13, the yardstick). Returns path -> (metrics,
    seconds)."""
    import torch

    from sibrar_tpu_torch.eval.evaluator import FullEvaluator, evaluate_model

    score_fn = fitter.make_score_fn()

    def scores_fn(u):  # the same scorer without dot parts
        return score_fn(u)

    peel_k = ["segment_gather", "gather_windows", "peel_values",
              "recover_winners"]
    tiled = ("window_scores_from", "gather_windows_tiled")
    paths = (("dot", "auto", score_fn, peel_k + ["score_wmax"],
              ("window_max",) + tiled),
             ("scores", "auto", scores_fn, peel_k + ["window_max"],
              ("score_wmax",) + tiled),
             ("pallas", "pallas", scores_fn, ["segment_gather", *tiled],
              ("window_max", "peel_values", "recover_winners", "score_wmax")),
             ("full", "full", scores_fn, ["segment_gather", "exact_topk"],
              ("window_max", "peel_values", "recover_winners", "score_wmax",
               "gather_windows") + tiled))
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
    """On sample batches of the val split, each against `plain_oracle` on
    the same score matrix: the full path's lists bit for bit, the scores
    path's and the pallas path's with values bit-equal and ids up to exact
    ties; the dot path's lists within the f32 GEMM bound
    (`check_lists`)."""
    import numpy as np

    from sibrar_tpu_torch.ops.peel import peel_masked_topk_dot
    from sibrar_tpu_torch.ops.sparse import csr_row_gather
    from sibrar_tpu_torch.ops.topk import masked_topk

    bs, csr = LOADER_CONF["eval_batch_size"], vdata.exclude_csr
    users_all = vdata.users_in_split
    differ = {"scores": 0, "pallas": 0, "dot": 0}
    for bi in LIST_BATCHES:
        u = users_all[bi * bs:(bi + 1) * bs]
        scores = score_fn(u)
        ov, oi = plain_oracle(scores, csr, u, K)
        for path, method in (("full", "full"), ("scores", "auto"),
                             ("pallas", "pallas")):
            v, i = (t.cpu().numpy()
                    for t in masked_topk(scores, csr, u, K, method=method))
            if not np.array_equal(v, ov):
                raise AssertionError(f"{path} path values differ from the "
                                     f"plain oracle's (batch {bi})")
            if path == "full" and not np.array_equal(i, oi):
                raise AssertionError(f"full path ids differ from the plain "
                                     f"oracle's (batch {bi})")
            rows = np.nonzero((np.sort(i, 1) != np.sort(oi, 1)).any(1))[0]
            for r in rows.tolist():
                extra = sorted(set(i[r].tolist()) ^ set(oi[r].tolist()))
                if not bool((scores[r, extra] == float(ov[r, -1])).all()):
                    raise AssertionError(f"{path} path: row {r} of batch "
                                         f"{bi} differs beyond exact ties")
            if path != "full":
                differ[path] += len(rows)
        user_fn, items = score_fn.dot_parts
        cols, mask = csr_row_gather(csr, u)
        v, i, _ = peel_masked_topk_dot(user_fn(u), items, cols, mask, K)
        differ["dot"] += check_lists(val, vdata, score_fn, u.cpu().numpy(),
                                     i.cpu().numpy(), v.cpu().numpy())
    log(f"lists of {len(LIST_BATCHES)} val batches against the plain "
        f"oracle: full path bit for bit, scores and pallas paths values "
        f"bit-equal, dot path within the f32 GEMM bound; rows differing on "
        f"ties only: {differ}")


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
    if not (got["idx"] and got["ok"]):
        raise AssertionError(f"try_recover: K11 differs from plain: {got}")
    count_path("probes path",
               [*(f"score_{v}" for v in gemm_probe.VARIANTS),
                "score_bf16", "roll_lanes", "lane_slice", "segment_roll",
                "mask_where", "recover_winners"],
               ("score_wmax",))
    del u, items
    torch.cuda.empty_cache()
    return measured


CONF_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "conf",
                         "single", "sbnet_onion18_huge_no-user.yml")
# the CLI run's item features (those of the synthetic data) and budget
CLI_FEATURES = (("ivec256", "vector"), ("bert", "vector"),
                ("musicnn", "vector"), ("genres", "tag"))
CLI_EPOCHS, CLI_BATCHES = 2, 100
DETERMINISM_STEPS = 30  # steps of each of the two same-seed trainings
RESUME_STEPS = 10  # steps before the checkpoint, and after it
BF16_STEPS = 20  # steps with bf16 first moments
QUALITY_FLOOR, QUALITY_SEED_NOISE = 0.03, 0.015  # ndcg@10
MF_CONF_PATH = os.path.join(os.path.dirname(CONF_PATH), "mf_onion18.yml")
MF_STEPS = 60  # the mf_sparse run's steps: some rows of each table stay cold


def same_split(split: str, got, want) -> None:
    """A loaded split against the in-memory one, bit for bit: the pairs,
    the split's users and items, every feature table (dtype too), its
    category count and labels."""
    import numpy as np

    for field in ("interactions", "train_interactions", "val_interactions",
                  "users_in_split", "items_in_split"):
        g, w = getattr(got, field), getattr(want, field)
        if not ((g is None and w is None) or (
                g.dtype == w.dtype and np.array_equal(g, w))):
            raise AssertionError(f"loaded {split}: {field} differs from "
                                 "the in-memory split")
    if list(got.item_features) != list(want.item_features):
        raise AssertionError(f"loaded {split}: features "
                             f"{list(got.item_features)}")
    for name, w in want.item_features.items():
        g = got.item_features[name]
        if not (g.table.dtype == w.table.dtype
                and np.array_equal(g.table, w.table) and g.kind == w.kind
                and g.n_categories == w.n_categories
                and g.value_map == w.value_map):
            raise AssertionError(f"loaded {split}: feature {name} differs "
                                 "from the in-memory table")


def cli_phase(splits, kernels, count_path, card: str) -> None:
    """The port's CLI on the card at full width: the onion-scale splits
    written as artifacts (the port's ``write_reference_artifacts``) into a
    temporary directory, each split loaded by ``RecDataset.load`` and held
    bit for bit to the in-memory one, then ``python -m
    sibrar_tpu_torch.run_experiment -a sbnet -c <the YAML> -t
    train_val_test`` run in this process (``main``), with the overrides of
    ``tests/test_cli_e2e.py``'s onion-scale run and a budget of
    CLI_EPOCHS epochs of CLI_BATCHES steps; everything else comes from the
    YAML chain, ``run_settings.device: tpu`` included, which lands on the
    card. The four run files must exist with JAX's metric keys and finite
    values, ``metrics_val.yml`` must hold fit's best validation, and K1-K7
    must launch. The artifacts are deleted at the end."""
    import tempfile

    import numpy as np
    import torch

    from sibrar_tpu_torch import config_from_dict
    from sibrar_tpu_torch.config.loader import (
        get_config,
        load_split_type,
        parse_conf_file,
    )
    from sibrar_tpu_torch.config.schema import FeatureDefinition
    from sibrar_tpu_torch.data.dataset import RecDataset
    from sibrar_tpu_torch.data.synthetic import write_reference_artifacts
    from sibrar_tpu_torch.run_experiment import main as run_experiment
    from sibrar_tpu_torch.train.trainer import Trainer

    root = tempfile.mkdtemp(prefix="sibrar_cli_")
    data_dir, run_dir = os.path.join(root, "onion18"), os.path.join(root,
                                                                   "run")
    try:
        t0 = time.perf_counter()
        write_reference_artifacts(data_dir, splits, seed=7)
        size = sum(os.path.getsize(os.path.join(data_dir, f))
                   for f in os.listdir(data_dir))
        log(f"CLI artifacts: {time.perf_counter() - t0:.2f} s to write "
            f"{size / 2**30:.3f} GiB ({len(os.listdir(data_dir))} files) on "
            f"{card}")
        defs = [config_from_dict(FeatureDefinition, {"name": n, "type": t})
                for n, t in CLI_FEATURES]
        split_type = load_split_type(data_dir)
        for split, want in splits.items():
            t0 = time.perf_counter()
            got = RecDataset.load(data_dir, split,
                                  item_feature_definitions=defs,
                                  split_type=split_type)
            wall = time.perf_counter() - t0
            same_split(split, got, want)
            log(f"CLI load {split}: {wall:.2f} s, bit-equal to the "
                f"in-memory split ({len(got.interactions)} pairs) on {card}")
            del got

        walls = {"train": [], "val": [], "test": []}
        validations = []
        train_epoch, validate = Trainer.train_epoch, Trainer.validate

        def timed_epoch(self):
            torch.cuda.synchronize()
            t1, steps = time.perf_counter(), self.step
            out = train_epoch(self)
            torch.cuda.synchronize()
            walls["train"].append((time.perf_counter() - t1,
                                   self.step - steps))
            return out

        def timed_validate(self):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = validate(self)
            torch.cuda.synchronize()
            walls[self.val_evaluator.name].append(time.perf_counter() - t1)
            if self.val_evaluator.name == "val":
                validations.append(out)
            return out

        reset_counts(kernels)
        torch.cuda.reset_peak_memory_stats()
        Trainer.train_epoch, Trainer.validate = timed_epoch, timed_validate
        t0 = time.perf_counter()
        try:
            val_metrics, test_metrics = run_experiment([
                "-a", "sbnet", "-c", CONF_PATH, "-d", data_dir,
                "-n", "onion18", "-t", "train_val_test",
                "-o", f"results_path={run_dir}",
                "-o", "dataset.user_features=[]",
                "-o", "dataset.item_features=[" + ", ".join(
                    f"{{name: {n}, type: {t}}}" for n, t in CLI_FEATURES)
                + "]",
                "-o", "eval.group_metrics=[]",
                "-o", f"learn.n_epochs={CLI_EPOCHS}",
                "-o", f"learn.max_batches_per_epoch={CLI_BATCHES}"])
        finally:
            Trainer.train_epoch, Trainer.validate = train_epoch, validate
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        count_path("CLI train_val_test", ["segment_gather", "score_wmax",
                                          "gather_windows", "peel_values",
                                          "recover_winners", "dw_matmul",
                                          "spmm_fwd", "spmm_bwd"])

        files = sorted(os.listdir(run_dir))
        if files != ["conf.yml", "metrics_test.yml", "metrics_val.yml",
                     "model.pt"]:
            raise AssertionError(f"CLI run files: {files}")
        conf = get_config(os.path.join(run_dir, "conf.yml"))
        if conf.run_settings.device != "tpu":
            raise AssertionError(f"the CLI run's device is "
                                 f"{conf.run_settings.device!r}, not the "
                                 f"YAML's 'tpu'")
        for name, returned in (("val", val_metrics), ("test", test_metrics)):
            metrics = parse_conf_file(os.path.join(run_dir,
                                                   f"metrics_{name}.yml"))
            if set(metrics) != expected_keys(conf.eval, name):
                raise AssertionError(
                    f"metrics_{name}.yml: keys differ from JAX's: "
                    f"{sorted(set(metrics) ^ expected_keys(conf.eval, name))}")
            if metrics != returned or not all(
                    np.isfinite(v) for v in metrics.values()):
                raise AssertionError(f"metrics_{name}.yml: not finite or not "
                                     f"what the run returned")
        best = validations[0]
        for m in validations[1:]:  # fit keeps the first strictly better
            if m["val/ndcg@10"] > best["val/ndcg@10"]:
                best = m
        if val_metrics != best:
            raise AssertionError("metrics_val.yml does not hold fit's best "
                                 "validation")
        steps = sum(n for _, n in walls["train"])
        train_s = sum(w for w, _ in walls["train"])
        log(f"CLI train_val_test: {total:.2f} s on {card}; train "
            f"{1e3 * train_s / steps:.3f} ms/step (host, synchronized; "
            f"{steps} steps in {len(walls['train'])} epochs); validations "
            f"{', '.join(f'{w:.3f}' for w in walls['val'])} s; test "
            f"{', '.join(f'{w:.3f}' for w in walls['test'])} s; "
            f"max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; val "
            f"ndcg@10 {val_metrics['val/ndcg@10']:.6f} (best of "
            f"{len(validations)}), test ndcg@10 "
            f"{test_metrics['test/ndcg@10']:.6f}")
        reload_phase(run_dir, root, splits, kernels, count_path, card,
                     test_metrics)
        mf_sparse_phase(data_dir, os.path.join(root, "mf_run"), kernels,
                        count_path, card)
        dmf_cli_phase(data_dir, os.path.join(root, "dmf_run"), kernels,
                      count_path, card)
        zoo_cli_phase(data_dir, root, kernels, count_path, card)
        sweep_phase(data_dir, root, kernels, count_path, card)
        mesh_phase(data_dir, run_dir, root, splits, val_metrics, kernels,
                   count_path, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def reload_phase(run_dir: str, root: str, splits, kernels, count_path,
                 card: str, test_metrics: dict) -> None:
    """Serving from the CLI's run directory (``conf.yml``, ``model.pt``):
    ``Recommender.from_run_dir(run_dir)`` (the test split, the card from
    the YAML's device) serves RELOAD_USERS test users, whose lists must
    equal those of a ``Recommender`` built here from the same ``model.pt``
    over the in-memory splits (held bit-equal to the loaded ones); then
    ``sibrar_tpu_torch.serve_recs.main`` writes a JSONL of the same users
    with ``--dtype bfloat16 --scores``, read back against the in-process
    bf16 lists (ids equal, ``round(score, 6)``); then one test evaluation
    with ``score_dtype: bfloat16`` on the reloaded weights: JAX's keys,
    finite values, NDCG@10 logged beside the f32 test metrics'."""
    import dataclasses
    import json

    import numpy as np
    import torch

    from sibrar_tpu_torch.config.loader import get_config
    from sibrar_tpu_torch.eval.evaluator import FullEvaluator, evaluate_model
    from sibrar_tpu_torch.models.registry import get_algorithm
    from sibrar_tpu_torch.serve import Recommender
    from sibrar_tpu_torch.serve_recs import main as serve_recs
    from sibrar_tpu_torch.train.scoring import make_score_fn

    conf = get_config(os.path.join(run_dir, "conf.yml"))
    test, train = splits["test"], splits["train"]
    users = np.asarray(test.users_in_split)[:RELOAD_USERS]
    peel_k = ["segment_gather", "gather_windows", "peel_values",
              "recover_winners", "spmm_fwd"]
    reset_counts(kernels)
    t0 = time.perf_counter()
    rec = Recommender.from_run_dir(run_dir)
    t_load = time.perf_counter() - t0
    ids, vals = rec.recommend(users, return_scores=True)
    t_serve = time.perf_counter() - t0 - t_load
    count_path("from_run_dir serving", peel_k + ["score_wmax"],
               ("score_bf16",))
    if rec.device.type != DEVICE or rec.k != max(conf.eval.top_k):
        raise AssertionError(f"from_run_dir: device {rec.device}, k {rec.k}")

    dev = rec.device
    tdata, data = train.to_device(dev), test.to_device(dev)
    model = get_algorithm(conf.algorithm).build(conf.model, train, tdata,
                                                conf.run_settings.seed)
    model.load_state_dict(torch.load(os.path.join(run_dir, "model.pt"),
                                     map_location=dev, weights_only=True))
    score_fn = make_score_fn(model, data.catalog)
    here = Recommender(score_fn, test, data, k=rec.k)
    wids, wvals = here.recommend(users, return_scores=True)
    if not (np.array_equal(ids, wids) and np.array_equal(vals, wvals)):
        raise AssertionError("from_run_dir: lists differ from the "
                             "in-process Recommender's on the same "
                             "model.pt")

    users_file = os.path.join(root, "users.txt")
    out = os.path.join(root, "recs.jsonl")
    with open(users_file, "w") as fh:
        fh.write("\n".join(str(u) for u in users) + "\n")
    reset_counts(kernels)
    t0 = time.perf_counter()
    serve_recs(["-r", run_dir, "-u", users_file, "-k", str(K),
                "--dtype", "bfloat16", "--scores", "-o", out])
    t_cli = time.perf_counter() - t0
    count_path("serve_recs --dtype bfloat16", peel_k + ["score_bf16"],
               ("score_wmax",))
    with open(out) as fh:
        rows = [json.loads(line) for line in fh]
    bids, bvals = Recommender(score_fn, test, data, k=K,
                              dtype="bfloat16").recommend(
        users, return_scores=True)
    if not ([r["user"] for r in rows] == users.tolist()
            and [r["items"] for r in rows] == bids.tolist()
            and [r["scores"] for r in rows]
            == [[round(float(v), 6) for v in row] for row in bvals]):
        raise AssertionError("serve_recs JSONL: not the in-process bf16 "
                             "lists")

    eval_conf = dataclasses.replace(conf.eval, score_dtype="bfloat16")
    ev = FullEvaluator(eval_conf, test, data, evaluator_name="test")
    reset_counts(kernels)
    t0 = time.perf_counter()
    bf16 = evaluate_model(score_fn, ev, conf.loader.eval_batch_size)
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    count_path("test evaluation, score_dtype bfloat16",
               ["segment_gather", "gather_windows", "peel_values",
                "recover_winners", "score_bf16"], ("score_wmax",))
    if set(bf16) != expected_keys(conf.eval, "test") or not all(
            np.isfinite(v) for v in bf16.values()):
        raise AssertionError("bf16 test metrics: keys differ from JAX's or "
                             "values not finite")
    key = "test/ndcg@10"
    log(f"reload: from_run_dir {t_load:.2f} s (two splits loaded, catalog "
        f"encoded), {len(users)} test users served in {t_serve:.3f} s, "
        f"lists equal to the in-process Recommender's on the same model.pt; "
        f"serve_recs --dtype bfloat16 {t_cli:.2f} s, its JSONL the "
        f"in-process bf16 lists; test evaluation in bf16 {t_eval:.3f} s: "
        f"ndcg@10 {bf16[key]:.6f} against f32 {test_metrics[key]:.6f} "
        f"(delta {bf16[key] - test_metrics[key]:+.6f}), recall@10 "
        f"{bf16['test/recall@10']:.6f} against "
        f"{test_metrics['test/recall@10']:.6f}; redone rows "
        f"{sum(ev.redo_rows)}; on {card}")


def mf_sparse_phase(data_dir: str, run_dir: str, kernels, count_path,
                    card: str) -> None:
    """``python -m sibrar_tpu_torch.run_experiment -a mf -c
    conf/single/mf_onion18.yml -t train_val`` on the CLI phase's onion-scale
    artifacts, with ``learn.sparse_tables=true learn.optimizer=adam`` and
    one epoch of MF_STEPS steps: both id tables (50,000 and 100,352 rows x
    256) must be sparse, every row no step touched must keep its initial
    bits with zero moments, the touched rows' moments must not all be zero,
    and the metric files must hold JAX's keys with finite values. Logs the
    host ms per step and ``max_memory_allocated``."""
    import numpy as np
    import torch

    from sibrar_tpu_torch.config.loader import get_config
    from sibrar_tpu_torch.models.registry import get_algorithm
    from sibrar_tpu_torch.run_experiment import main as run_experiment
    from sibrar_tpu_torch.train import trainer as trainer_mod

    made, walls, touched = [], [], {}
    train_epoch, update = trainer_mod.Trainer.train_epoch, \
        trainer_mod.row_adam_update

    def timed_epoch(self):
        made.append(self)
        torch.cuda.synchronize()
        t1, steps = time.perf_counter(), self.step
        out = train_epoch(self)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1, self.step - steps))
        return out

    def recorded_update(table, opt, idx, g, step, **kw):
        mask = touched.setdefault(table.data_ptr(), torch.zeros(
            table.shape[0], dtype=torch.bool, device=table.device))
        mask[idx.reshape(-1).long()] = True
        return update(table, opt, idx, g, step, **kw)

    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    trainer_mod.Trainer.train_epoch = timed_epoch
    trainer_mod.row_adam_update = recorded_update
    t0 = time.perf_counter()
    try:
        with recorded_spmm({}) as calls:
            metrics = run_experiment([
                "-a", "mf", "-c", MF_CONF_PATH, "-d", data_dir,
                "-n", "onion18", "-t", "train_val",
                "-o", f"results_path={run_dir}",
                "-o", "dataset.user_features=[]",
                "-o", "dataset.item_features=[]",
                "-o", "eval.group_metrics=[]",
                "-o", "learn.sparse_tables=true",
                "-o", "learn.optimizer=adam", "-o", "learn.n_epochs=1",
                "-o", f"learn.max_batches_per_epoch={MF_STEPS}"])
    finally:
        trainer_mod.Trainer.train_epoch = train_epoch
        trainer_mod.row_adam_update = update
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    count_path("mf_sparse CLI train_val",
               ["segment_gather", "score_wmax", "spmm_fwd", "spmm_bwd"])
    # K7 at coalesce_rows' [M, 1] calls of both tables (and K6 at the
    # run's one-slot lookups) against their plain versions, outside the
    # counted run
    if sum(k.startswith("coalesce_rows") for k in calls) < 2:
        raise AssertionError(f"mf_sparse: coalesce_rows of both tables not "
                             f"recorded ({sorted(calls)})")
    check_recorded("mf_sparse", calls, ("coalesce_rows",))
    del calls
    trainer = made[0]
    if sorted(trainer.sparse) != ["item_embeddings", "user_embeddings"]:
        raise AssertionError(f"mf_sparse: sparse tables {trainer.sparse}")
    conf = get_config(os.path.join(run_dir, "conf.yml"))
    if set(metrics) != expected_keys(conf.eval, "val") or not all(
            np.isfinite(v) for v in metrics.values()):
        raise AssertionError("mf_sparse: val metrics not JAX's keys or not "
                             "finite")
    initial = get_algorithm("mf").build(conf.model, trainer.train_dataset,
                                        trainer.data, conf.run_settings.seed)
    for name, table in trainer.tables.items():
        hit = touched[table.weight.data_ptr()]
        cold = ~hit
        rows = trainer.row_state[name]
        n_cold = int(cold.sum())
        if n_cold == 0 or not torch.equal(
                table.weight.detach()[cold],
                getattr(initial, name).weight.detach()[cold]):
            raise AssertionError(f"mf_sparse {name}: {n_cold} untouched "
                                 f"rows, or they changed")
        if bool(rows["mu"][cold].any()) or bool(rows["nu"][cold].any()):
            raise AssertionError(f"mf_sparse {name}: moments of untouched "
                                 f"rows not zero")
        if not bool(rows["nu"][hit].any()):
            raise AssertionError(f"mf_sparse {name}: no touched row moved "
                                 f"its moments")
        log(f"mf_sparse {name} {tuple(table.weight.shape)}: {n_cold} rows "
            f"untouched, their bits and zero moments kept; "
            f"{int(hit.sum())} rows stepped")
    steps = sum(n for _, n in walls)
    log(f"mf_sparse CLI train_val: {total:.2f} s on {card}; train "
        f"{1e3 * sum(w for w, _ in walls) / steps:.3f} ms/step (host, "
        f"synchronized; {steps} steps, batch {trainer.batch_size}); "
        f"max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; val ndcg@10 "
        f"{metrics['val/ndcg@10']:.6f}")


def reset_counts(kernels) -> None:
    from sibrar_tpu_torch.ops import peel

    for _, fn, _, _ in kernels:
        fn.launches = 0
    peel.gather_subwindows.launches = 0  # K3's, off every peel path


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


def bits_differ(a: dict, b: dict) -> dict:
    """``{name: (n_differing, max_abs_err)}`` over the tensors of two
    snapshots whose bits differ (floats through their integer view)."""
    import torch

    out = {}
    for name, x in a.items():
        y = b[name]
        if x.is_floating_point():
            ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
            xi = x.contiguous().view(ints[x.element_size()])
            yi = y.contiguous().view(ints[y.element_size()])
        else:
            xi, yi = x, y
        n = int((xi != yi).sum())
        if n:
            out[name] = (n, max_abs_err(x.float(), y.float()))
    return out


def parent_bag(kernel, cols, mask):
    """The user tower's bag branch before it ran on K6 / K7: a gather of
    kernel rows and a masked sum, with autograd's backward."""
    return (kernel[cols.long()] * mask.unsqueeze(-1)).sum(-2)


def check_spmm_case(label: str, cols, mask, n_cols: int, kernel=None,
                    g=None) -> None:
    """On one call's inputs: K6 (when ``kernel`` is given) within the f32
    sum bound ``2 n eps sum |kernel rows|`` per row of its plain version,
    and K7 (when ``g`` is given) bit-equal to its plain version run on the
    CPU copies (JAX's order of the sums). Raises when either fails."""
    import torch

    from sibrar_tpu_torch.ops import spmm

    done = []
    if kernel is not None:
        got = spmm.spmm_fwd(cols, mask, kernel)
        want = spmm.spmm_fwd_plain(cols, mask, kernel)
        tol = (2 * mask.sum(1, keepdim=True) * F32_EPS
               * spmm.spmm_fwd_plain(cols, mask, kernel.abs()))
        err = max_abs_err(got, want)
        if not bool(((got - want).abs() <= tol).all()):
            raise AssertionError(f"K6 spmm_fwd beyond the f32 sum bound on "
                                 f"{label}: max abs err {err}")
        done.append(f"K6 max abs err {err:.3e}, within the f32 sum bound")
    if g is not None:
        got = spmm.spmm_bwd(cols, mask, g, n_cols).cpu()
        want = spmm.spmm_bwd_plain(cols.cpu(), mask.cpu(), g.cpu(), n_cols)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"K7 spmm_bwd differs from its plain "
                                 f"version on the CPU on {label}: max abs "
                                 f"err {max_abs_err(got, want)}")
        done.append("K7 bit-equal to its plain version on the CPU")
    h = (kernel if kernel is not None else g).shape[1]
    log(f"{label}, [{cols.shape[0]} x {cols.shape[1]}] rows, "
        f"{int(mask.sum())} live, {n_cols} columns, H = {h}: "
        f"{'; '.join(done)}")


@contextlib.contextmanager
def recorded_spmm(calls: dict):
    """While open, keeps the inputs of the first K6 / K7 call of each call
    site and shape class (``calls[label]``, the site the first method on
    the stack): every `spmm_onehot` of ``models/layers.py`` (`Embedding`
    lookups, `TagEmbeddingBag` sums, the interaction towers' bag rows,
    ECF's `layers.lookup` of its raw tables) with its table and, once
    autograd hands
    it back, its output gradient (K7's input); and every `spmm_bwd` of
    ``train/row_adam.coalesce_rows`` with its gradient rows."""
    from sibrar_tpu_torch.models import layers
    from sibrar_tpu_torch.train import row_adam

    onehot, bwd = layers.spmm_onehot, row_adam.spmm_bwd

    def spmm_onehot(cols, mask, kernel):
        out = onehot(cols, mask, kernel)
        frame = sys._getframe(1)  # the first caller that is a method
        while frame is not None and "self" not in frame.f_locals:
            frame = frame.f_back
        owner = type(frame.f_locals["self"]).__name__ if frame else "?"
        n, h = kernel.shape
        label = f"{owner} L={cols.shape[1]} table [{n} x {h}]"
        if label not in calls:
            case = calls[label] = dict(cols=cols, mask=mask, n_cols=n,
                                       kernel=kernel.detach())
            if out.requires_grad:
                out.register_hook(lambda g: case.__setitem__(
                    "g", g.detach().contiguous().clone()))
        return out

    def spmm_bwd(cols, mask, g, n_cols):
        calls.setdefault(f"coalesce_rows M={n_cols} d={g.shape[1]}",
                         dict(cols=cols, mask=mask, n_cols=n_cols, g=g))
        return bwd(cols, mask, g, n_cols)

    layers.spmm_onehot, row_adam.spmm_bwd = spmm_onehot, spmm_bwd
    try:
        yield calls
    finally:
        layers.spmm_onehot, row_adam.spmm_bwd = onehot, bwd


def check_recorded(path: str, calls: dict, needed: tuple) -> None:
    """`check_spmm_case` on every call `recorded_spmm` kept on ``path``;
    each label prefix in ``needed`` must have been recorded with its
    gradient (its K7 input)."""
    for prefix in needed:
        if not any(k.startswith(prefix) and "g" in c
                   for k, c in calls.items()):
            raise AssertionError(f"{path}: no K7 call of {prefix} recorded "
                                 f"({sorted(calls)})")
    for label, case in calls.items():
        check_spmm_case(f"{path}, {label}", case["cols"], case["mask"],
                        case["n_cols"], case.get("kernel"), case.get("g"))


def check_one_slot(n_cols: int, dev) -> None:
    """K6 / K7 on rows of one live slot, as `layers.Embedding` looks up a
    train batch's items (B (1 + n) = 5,632 ids, an eighth of them one hot
    id) in a random table of ``n_cols`` rows, at H = 1, 256 and 512; and
    `row_adam.coalesce_rows` (K7 on its [M, 1] run ids) on the card
    bit-equal to itself on the CPU copies, at the same ids, d = 256."""
    import torch

    from sibrar_tpu_torch.train.row_adam import coalesce_rows

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    m = LOADER_CONF["batch_size"] * (1 + DATASET_CONF["n_negative_samples"])
    kernel = torch.randn(n_cols, 512, device=dev, generator=gen)
    ids = torch.randint(0, n_cols, (m, 1), device=dev, generator=gen,
                        dtype=torch.int32)
    ids[::8] = n_cols // 3
    mask = torch.ones_like(ids, dtype=torch.bool)
    for h in (1, 256, 512):
        g = torch.randn(m, h, device=dev, generator=gen)
        check_spmm_case("one-slot Embedding lookup", ids, mask, n_cols,
                        kernel[:, :h].contiguous(), g)
    g = torch.randn(m, 256, device=dev, generator=gen)
    got = coalesce_rows(ids.reshape(-1), g)
    want = coalesce_rows(ids.reshape(-1).cpu(), g.cpu())
    if not (torch.equal(got[0].cpu(), want[0]) and torch.equal(
            got[1].cpu().view(torch.int32), want[1].view(torch.int32))):
        raise AssertionError("coalesce_rows on the card differs from the "
                             "CPU")
    log(f"coalesce_rows, M={m} d=256: ids and rows bit-equal to the CPU's")


def user_bag_profile(tower, users) -> None:
    """The user tower's bag rows on the train batch (live slots per row,
    rows past K6's 32-slot limit); K6 and K7 held to their plain versions
    on them (`check_spmm_case`); and the first layer's forward + backward
    time on them by `parent_bag` (gather and masked sum, autograd's
    backward) and as it runs now (K6 / K7)."""
    import torch

    from sibrar_tpu_torch.ops.sparse import csr_row_gather
    from sibrar_tpu_torch.ops.spmm import spmm_onehot

    cols, mask = csr_row_gather(tower.csr, users)
    lens = mask.sum(1)
    log(f"user bag rows, train batch: {users.shape[0]} rows of width "
        f"{cols.shape[1]}, live slots min {int(lens.min())} mean "
        f"{float(lens.float().mean()):.1f} max {int(lens.max())}, "
        f"{int((lens > 32).sum())} rows over 32 (summed by runs), "
        f"{int(lens.sum())} live in all")
    g = torch.randn(users.shape[0], tower.kernel.shape[1],
                    device=users.device, generator=torch.Generator(
                        device=users.device).manual_seed(SEED))
    check_spmm_case("user bag rows, train batch", cols, mask,
                    tower.kernel.shape[0], tower.kernel.detach(), g)
    kernel = tower.kernel.detach().clone().requires_grad_()

    def parent():
        parent_bag(kernel, cols, mask).backward(g)

    def spmm():
        spmm_onehot(cols, mask, kernel).backward(g)

    times = cuda_ms_turns({"gather + sum, autograd": parent,
                           "K6 / K7": spmm}, iters=20, rounds=3)
    log("user bag first layer, forward + backward: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in times.items()))


def sbnet_trainer(train, tdata, seed: int = SEED, **learn):
    """SBNet at the YAML's widths, random weights from ``seed``, and its
    `Trainer` with the YAML's learn / dataset / loader settings (``learn``
    overrides), the trainer's generator seeded with ``seed``."""
    from sibrar_tpu_torch import config_from_dict
    from sibrar_tpu_torch.models.sbnet import SingleBranchNet
    from sibrar_tpu_torch.train.trainer import (
        DatasetConfig,
        LearningConfig,
        Trainer,
    )

    model = SingleBranchNet.build_from_conf(MODEL_CONF, train, tdata,
                                            seed=seed)
    return Trainer(model, train,
                   config_from_dict(LearningConfig, {**LEARN_CONF, **learn}),
                   config_from_dict(DatasetConfig, DATASET_CONF),
                   batch_size=LOADER_CONF["batch_size"], seed=seed,
                   device_data=tdata)


def trainer_state(trainer) -> dict:
    """The trainer's state (`Trainer.state_dict`: parameters, batch-norm
    statistics, optimizer and row moments, its generator, the step, the
    best state) flattened to cloned tensors."""
    import torch

    flat = {}

    def walk(prefix, x):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}.{k}" if prefix else str(k), v)
        elif isinstance(x, torch.Tensor):
            flat[prefix] = x.detach().clone()
        elif x is not None:
            flat[prefix] = torch.tensor(x)

    walk("", trainer.state_dict())
    return flat


def determinism_phase(train, tdata, kernels, count_path) -> None:
    """Two SBNet trainings of DETERMINISM_STEPS steps from one seed, at the
    YAML's widths, must end in bit-equal parameters, batch-norm statistics
    and optimizer state: once with the default first layer (the user
    tower's bag path on K6 / K7, the item tower's dense path on K5), once
    with ``INTERACTION_SPMM`` on. Logs K6 and K7 launches on the default
    path."""
    from sibrar_tpu_torch.models import layers

    flag = layers.INTERACTION_SPMM
    try:
        for spmm_on in (False, True):
            layers.INTERACTION_SPMM = spmm_on
            runs = []
            for run in range(2):
                trainer = sbnet_trainer(train, tdata)
                if run == 0 and not spmm_on:
                    reset_counts(kernels)
                train_window(trainer, DETERMINISM_STEPS)
                if run == 0 and not spmm_on:
                    counts = count_path(
                        "determinism, default first layer",
                        ["segment_gather", "dw_matmul", "spmm_fwd",
                         "spmm_bwd"])
                    log(f"determinism: K6 spmm_fwd {counts['spmm_fwd']}, "
                        f"K7 spmm_bwd {counts['spmm_bwd']} launches in "
                        f"{DETERMINISM_STEPS} default-path steps")
                runs.append(trainer_state(trainer))
                del trainer
            diff = bits_differ(*runs)
            if diff:
                raise AssertionError(
                    f"determinism, INTERACTION_SPMM {spmm_on}: {len(diff)} "
                    f"tensors differ between two runs of one seed: "
                    f"{sorted(diff.items())[:8]}")
            log(f"determinism, INTERACTION_SPMM {spmm_on}: two trainings "
                f"of {DETERMINISM_STEPS} steps from seed {SEED} end "
                f"bit-equal ({len(runs[0])} tensors: parameters, batch-norm "
                f"statistics, optimizer moments, generator, step)")
    finally:
        layers.INTERACTION_SPMM = flag


def resume_phase(train, tdata) -> None:
    """At the YAML's widths: train RESUME_STEPS steps, ``save_checkpoint``,
    train RESUME_STEPS more; a fresh trainer (another seed) runs
    ``load_checkpoint`` and the same RESUME_STEPS steps, and must end
    bit-equal to the first."""
    import tempfile

    a = sbnet_trainer(train, tdata)
    train_window(a, RESUME_STEPS)
    path = tempfile.mkdtemp(prefix="sibrar_ckpt_")
    try:
        t0 = time.perf_counter()
        a.save_checkpoint(path)
        save_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        train_window(a, RESUME_STEPS)
        want = trainer_state(a)
        del a
        b = sbnet_trainer(train, tdata, seed=SEED + 1)
        t0 = time.perf_counter()
        b.load_checkpoint(path)
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(path, ignore_errors=True)
    if b.step != RESUME_STEPS:
        raise AssertionError(f"resume: step {b.step} after load")
    train_window(b, RESUME_STEPS)
    diff = bits_differ(want, trainer_state(b))
    if diff:
        raise AssertionError(f"resume: {len(diff)} tensors differ from the "
                             f"run that went on: {sorted(diff.items())[:8]}")
    log(f"resume: save {save_s:.2f} s ({size / 2**30:.3f} GiB), load "
        f"{load_s:.2f} s; after {RESUME_STEPS} more steps the resumed "
        f"trainer is bit-equal to the one that went on ({len(want)} "
        f"tensors)")


def bf16_moments_phase(train, tdata) -> None:
    """A short SBNet run with ``moment_dtype: bfloat16``: finite losses,
    every first moment stored in bf16 and finite, second moments f32."""
    import numpy as np
    import torch

    trainer = sbnet_trainer(train, tdata, moment_dtype="bfloat16")
    run = train_window(trainer, BF16_STEPS)
    states = list(trainer.optimizer.state.values())
    if not np.isfinite(run["losses"]).all():
        raise AssertionError("bf16 moments: losses not finite")
    if not all(st["mu"].dtype == torch.bfloat16
               and st["nu"].dtype == torch.float32
               and bool(torch.isfinite(st["mu"]).all()) for st in states):
        raise AssertionError("bf16 moments: a first moment is not bf16 or "
                             "not finite")
    log(f"bf16 moments: {BF16_STEPS} steps, losses finite (last "
        f"{float(run['losses'][-1]):.5f}), {len(states)} first moments "
        f"stored in bf16; host {run['host_ms']:.3f} ms/step")


ZOO_CONF_DIR = os.path.dirname(CONF_PATH)
# The resolved ``model:`` blocks of conf/single/<name>_onion18.yml (their
# base_configs folded in); a test holds them equal to the YAMLs.
ZOO_MODELS = {
    "dmf": {"u_mid_layers": [512], "i_mid_layers": [512],
            "final_dimension": 256},
    "ifeatmf": {"feature_name": "bert", "embedding_dim": 256,
                "temperature": 0.2, "lambda_content": 0.5},
    "ufeatmf": {"feature_name": "acg_with_unknown_mpnet",
                "embedding_dim": 256, "temperature": 0.2,
                "lambda_content": 0.5},
    "dropoutnet": {
        "shared_common_dim": 256,
        "user": {"features": [{"feature_name": "gender", "embedding_dim": 32},
                              {"feature_name": "country",
                               "embedding_dim": 32}],
                 "preference_layers": [512],
                 "common_hidden_layers": [512, 256]},
        "item": {"features": [{"feature_name": "ivec256", "embedding_dim": 256},
                              {"feature_name": "bert", "embedding_dim": 256},
                              {"feature_name": "musicnn",
                               "embedding_dim": 256}],
                 "preference_layers": [512],
                 "common_hidden_layers": [512, 256]},
    },
}
# The ProtoMF variants at the widths of the JAX builds' defaults (no YAML
# sets them: conf/base.yml gives their learn / dataset / loader blocks and
# an empty model block) and ECF at conf/ecf.yml's model block.
PROTOMF = ("uprotomf", "iprotomf", "uiprotomf", "uprotomfs", "iprotomfs",
           "uiprotomfs")
ZOO_MODELS.update({name: {} for name in PROTOMF})
ZOO_MODELS["ecf"] = {"embedding_dim": 128, "n_clusters": 64, "top_n": 20,
                     "top_m": 20, "top_p": 4, "temp_masking": 2.0,
                     "temp_tags": 2.0, "lam_cf": 0.6, "lam_ind": 1.0,
                     "lam_ts": 1.0, "tag_feature": "genres"}
PROTOMF_WIDTH, PROTOMF_PROTOTYPES = 100, 20


def zoo_conf_path(name: str) -> str:
    conf_root = os.path.dirname(ZOO_CONF_DIR)
    if name in PROTOMF:
        return os.path.join(conf_root, "base.yml")
    if name == "ecf":
        return os.path.join(conf_root, "ecf.yml")
    return os.path.join(ZOO_CONF_DIR, f"{name}_onion18.yml")


# kernels each family's zoo run must launch (train, one validation, one
# serving batch); K8 must not, except where the scores path ranks
# (UIProtoMFs has no dot parts, as in JAX), which must not launch K2
ZOO_KERNELS = {
    "dmf": ["segment_gather", "dw_matmul", "spmm_fwd", "spmm_bwd",
            "score_wmax", "gather_windows", "peel_values",
            "recover_winners"],
    "ifeatmf": ["spmm_fwd", "spmm_bwd", "score_wmax"],
    "ufeatmf": ["spmm_fwd", "spmm_bwd", "score_wmax"],
    "dropoutnet": ["segment_gather", "dw_matmul", "spmm_fwd", "spmm_bwd",
                   "score_wmax"],
    **{name: ["segment_gather", "spmm_fwd", "spmm_bwd", "score_wmax"]
       for name in PROTOMF},
    "uiprotomfs": ["segment_gather", "spmm_fwd", "spmm_bwd", "window_max"],
    "ecf": ["segment_gather", "spmm_fwd", "spmm_bwd", "score_wmax",
            "exact_topk"],
}
ZOO_ABSENT = {name: ("window_max",) for name in ZOO_KERNELS}
ZOO_ABSENT["uiprotomfs"] = ("score_wmax",)
# the families whose train step runs twice from one state, bit for bit
ZOO_REPEAT = ("uprotomf", "ecf")
ZOO_WARMUP, ZOO_STEPS, ZOO_LOSS_WINDOW = 20, 100, 25
# UProtoMFs starts on a plateau at ln 2: its relu'd item weights are all
# 0.5 +- 0.01, so every item scores alike until they spread; at the zoo's
# width its 50-step loss means stay within 3e-4 of 0.6932 for ~700 steps,
# then fall (0.6738 by step 1,500 on an H100), so it takes more steps
ZOO_STEPS_FOR = {"uprotomfs": 1000}
ZOO_MPNET_DIM, ZOO_COUNTRIES = 768, 50
DMF_CLI_STEPS = 100
ZOO_CLI_STEPS = 100  # steps of each ProtoMF and ECF CLI run
QUALITY_FAMILIES = ("sbnet", "dmf", "dropoutnet", "ifeatmf", "ufeatmf",
                    "uprotomf")


def zoo_user_features(n_users: int, n_items: int, seed: int = 7,
                      n_clusters: int = 64) -> dict:
    """The user features the zoo's configs read, which the onion-scale
    splits lack, drawn from ``seed``: ``gender`` (3 values) and
    ``country`` (50), categorical, and ``acg_with_unknown_mpnet``, a
    768-wide vector around its user's cluster centre (the cluster
    ``make_onion_scale_splits`` gives the user: its second draw, after the
    items')."""
    import numpy as np

    from sibrar_tpu_torch.config.schema import FeatureDefinition, FeatureType
    from sibrar_tpu_torch.data.feature import build_feature

    rng = np.random.default_rng(seed)
    rng.integers(0, n_clusters, n_items)  # the items' clusters
    cluster = rng.integers(0, n_clusters, n_users)
    draw = np.random.default_rng(seed + 1)
    centres = draw.normal(size=(n_clusters, ZOO_MPNET_DIM))
    mpnet = (centres[cluster] + 0.6 * draw.normal(
        size=(n_users, ZOO_MPNET_DIM))).astype(np.float32)
    gender = list(draw.choice(["f", "m", "x"], n_users))
    country = [f"c{c:02d}" for c in draw.integers(0, ZOO_COUNTRIES,
                                                  n_users)]

    def feature(name, kind, values):
        return build_feature(FeatureDefinition(name, kind), values, n_users)

    return {"gender": feature("gender", FeatureType.CATEGORICAL, gender),
            "country": feature("country", FeatureType.CATEGORICAL, country),
            "acg_with_unknown_mpnet": feature(
                "acg_with_unknown_mpnet", FeatureType.VECTOR, mpnet)}


@contextlib.contextmanager
def recorded_dw(calls: list):
    """While open, keeps the inputs ``(vec, g)`` K5 gets in every backward
    of the dense first layers (``ops/dw.DenseFirstMatmul``)."""
    from sibrar_tpu_torch.ops import dw

    real = dw.DenseFirstMatmul.backward

    def backward(ctx, g):
        calls.append((ctx.saved_tensors[0], g.contiguous()))
        return real(ctx, g)

    dw.DenseFirstMatmul.backward = staticmethod(backward)
    try:
        yield calls
    finally:
        dw.DenseFirstMatmul.backward = staticmethod(real)


def check_dw_case(label: str, vec, g, timed: bool = False) -> bool:
    """K5 on one call's inputs within ``2 R eps |vec|^T |g|`` of its plain
    version (`check_train_kernels`' bound), with ``timed`` its time beside
    its plain version's (``vec.T @ g``, cuBLAS) and its bound; returns
    whether the rows were 0/1."""
    from sibrar_tpu_torch.ops import dw

    got, want = dw.dw_matmul(vec, g), dw.dw_matmul_plain(vec, g)
    tol = 2 * vec.shape[0] * F32_EPS * (vec.abs().T @ g.abs())
    err = max_abs_err(got, want)
    if not bool(((got - want).abs() <= tol).all()):
        raise AssertionError(f"K5 dw_matmul beyond the f32 GEMM bound on "
                             f"{label}: max abs err {err}")
    del got, want, tol
    binary = bool(((vec == 0) | (vec == 1)).all())
    (r, c), h = vec.shape, g.shape[1]
    times = ""
    if timed:
        times = (f"; K5 {cuda_ms(lambda: dw.dw_matmul(vec, g), 10):.4f} ms, "
                 f"plain (vec.T @ g) "
                 f"{cuda_ms(lambda: dw.dw_matmul_plain(vec, g), 10):.4f} ms, "
                 f"{bound(4 * (r * c + r * h + c * h), 2 * r * c * h)}")
    log(f"{label}: K5 [{r} x {c}] x H = {h}, rows "
        f"{'0/1' if binary else 'L2-normalized (not 0/1)'}: max abs err "
        f"{err:.3e}, within the bound{times}")
    return binary


@contextlib.contextmanager
def recorded_topk(calls: list, module=None):
    """While open, keeps the rows and k of the first `exact_topk` call of
    each shape and k made by ``module`` (default ``models/ecf.py``: its
    hard masks, the tag loss's top-p; ``models/matrix_algs.py``: the
    similarity blocks)."""
    if module is None:
        from sibrar_tpu_torch.models import ecf as module

    real = module.exact_topk
    seen = set()

    def exact_topk(x, k):
        if (tuple(x.shape), k) not in seen:
            seen.add((tuple(x.shape), k))
            calls.append((x.clone(), k))
        return real(x, k)

    module.exact_topk = exact_topk
    try:
        yield calls
    finally:
        module.exact_topk = real


def check_topk_calls(label: str, calls: list) -> None:
    """K13 on the rows of each recorded shape, with an all-zero row added
    (a user with no train interaction: every cluster ties, and the mask
    must be the first k clusters), bit-equal to its plain version."""
    import torch

    from sibrar_tpu_torch.ops.exact_topk import exact_topk, exact_topk_plain

    done = set()
    for x, k in calls:
        if (tuple(x.shape), k) in done:
            continue
        done.add((tuple(x.shape), k))
        rows = torch.cat([x, torch.zeros_like(x[:1])])
        gv, gi = exact_topk(rows, k)
        wv, wi = exact_topk_plain(rows, k)
        first = torch.arange(gi.shape[1], device=gi.device)
        if not (torch.equal(gi, wi) and same_bits(gv, wv)
                and torch.equal(gi[-1], first)):
            raise AssertionError(f"{label}: K13 differs from its plain "
                                 f"version on [{x.shape[0]} x {x.shape[1]}]"
                                 f" rows, k = {k}")
        log(f"{label}: K13 on [{x.shape[0]} x {x.shape[1]}] rows and an "
            f"all-zero row, k = {k}: values and ids bit-equal to its plain "
            f"version (the zero row's the first {k})")
    if not done:
        raise AssertionError(f"{label}: no exact_topk call recorded")


def repeat_step(label: str, trainer) -> None:
    """One train step, then the same step again from the state before it
    (`Trainer.load_state_dict`): the two states must be bit-equal."""
    import copy

    before = copy.deepcopy(trainer.state_dict())
    train_window(trainer, 1)
    first = trainer_state(trainer)
    trainer.load_state_dict(before)
    train_window(trainer, 1)
    diff = bits_differ(first, trainer_state(trainer))
    if diff:
        raise AssertionError(f"{label}: one step twice from one state: "
                             f"{len(diff)} tensors differ: "
                             f"{sorted(diff.items())[:8]}")
    log(f"{label}: one train step twice from one state, bit-equal "
        f"({len(first)} tensors)")


def post_val_keys(name: str, with_report: bool) -> set:
    """`protomf_post_val`'s keys for ProtoMF ``name`` (no t-SNE plot: the
    card's machine has no sklearn)."""
    entities = (("user", "item") if name.startswith("ui")
                else ("item",) if name[0] == "i" else ("user",))
    keys = {f"{e}_proto_{s}" for e in entities
            for s in ("sim_mean", "sim_max_mean", "sim_min_mean",
                      "utilization_entropy", "dead_fraction")}
    if with_report and "item" in entities:
        keys.add("item_proto_top_items")
    return keys


def check_post_val(name: str, model) -> None:
    """The run's post-validation hook (`experiment._post_val_fn`) on the
    trained model: JAX's keys, finite statistics, the item report."""
    import tempfile

    import numpy as np

    from sibrar_tpu_torch.config.loader import get_config
    from sibrar_tpu_torch.experiment import _post_val_fn

    conf = get_config(zoo_conf_path(name), algorithm=name)
    with tempfile.TemporaryDirectory() as d:
        out = _post_val_fn(conf, d)(model, 0)
        report = out.get("item_proto_top_items")
        if report and not os.path.getsize(report):
            raise AssertionError(f"zoo {name}: empty prototype report")
    stats = {k: v for k, v in out.items() if not isinstance(v, str)}
    if (set(out) - {"user_tsne_plot", "item_tsne_plot"}
            != post_val_keys(name, True)
            or not all(np.isfinite(v) for v in stats.values())):
        raise AssertionError(f"zoo {name}: post-validation keys "
                             f"{sorted(out)}")
    log(f"zoo {name} post-validation: " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(stats.items())))


def zoo_towers(model) -> dict:
    """The interaction towers of a zoo model by label."""
    from sibrar_tpu_torch.models.dmf import DeepMatrixFactorization
    from sibrar_tpu_torch.models.dropoutnet import DropoutNet

    if isinstance(model, DeepMatrixFactorization):
        return {"user_nn": model.user_nn, "item_nn": model.item_nn}
    if isinstance(model, DropoutNet):
        return {"user pref_net": model.user_net.pref_net,
                "item pref_net": model.item_net.pref_net}
    return {}


def zoo_phase(splits, device_data: dict, kernels, count_path,
              card: str) -> None:
    """DMF, ifeatmf, ufeatmf and DropoutNet at the full widths of their
    ``conf/single/<name>_onion18.yml``, the six ProtoMF variants at the
    JAX builds' default widths (``conf/base.yml``) and ECF at
    ``conf/ecf.yml``'s (the learn / dataset / loader blocks from the YAML
    chain too; `zoo_conf_path`), random weights from SEED, on the
    onion-scale splits with `zoo_user_features` added in memory."""
    import copy

    import torch

    feats = zoo_user_features(splits["train"].n_users,
                              splits["train"].n_items)
    dev = device_data["train"].catalog.device
    tables = {k: torch.as_tensor(f.table, device=dev)
              for k, f in feats.items()}
    zoo = {}
    for name, split in splits.items():
        host = copy.copy(split)
        host.user_features = {**split.user_features, **feats}
        dd = device_data[name]
        zoo[name] = (host, dd._replace(
            user_features={**dd.user_features, **tables}))
    for name in ZOO_MODELS:
        t0 = time.perf_counter()
        zoo_family(name, zoo, kernels, count_path, card)
        torch.cuda.empty_cache()
        log(f"zoo {name}: {time.perf_counter() - t0:.1f} s")


def zoo_family(name: str, zoo: dict, kernels, count_path, card: str) -> None:
    """One zoo family: build through the registry; the kernels on the
    inputs one recorded train step gives them (K5 on the dense item
    towers, also on L2-normalized rows for DMF; K6 / K7 at every spmm call
    site; K13 on ECF's rows); for ZOO_REPEAT, one step twice from one
    state, bit for bit; then, counted, ZOO_WARMUP + ZOO_STEPS (or
    ZOO_STEPS_FOR's) train steps
    (finite, falling losses), one validation (JAX's keys, the dot path but
    for UIProtoMFs; ProtoMF's post-validation keys), one serving batch of
    1,024 test users (`check_lists`); a profiled window of train steps."""
    import dataclasses

    import numpy as np
    import torch

    from sibrar_tpu_torch.config.loader import get_config
    from sibrar_tpu_torch.eval.evaluator import FullEvaluator
    from sibrar_tpu_torch.models.registry import get_algorithm
    from sibrar_tpu_torch.serve import Recommender
    from sibrar_tpu_torch.train.scoring import make_score_fn
    from sibrar_tpu_torch.train.trainer import Trainer

    conf = get_config(zoo_conf_path(name), algorithm=name)
    if conf.model != ZOO_MODELS[name]:
        raise AssertionError(f"zoo {name}: resolved model {conf.model}")
    (train, tdata), (val, vdata), (test, data) = (
        zoo["train"], zoo["val"], zoo["test"])
    bs = conf.loader.batch_size
    rows = {"user": bs, "item": bs * (1 + conf.dataset.n_negative_samples)}

    def trainer_for(model_conf):
        model = get_algorithm(name).build(model_conf, train, tdata, SEED)
        return Trainer(model, train, dataclasses.replace(conf.learn),
                       conf.dataset, batch_size=bs, seed=SEED,
                       device_data=tdata, val_evaluator=FullEvaluator(
                           eval_conf(), val, vdata, evaluator_name="val"),
                       eval_batch_size=conf.loader.eval_batch_size)

    trainer = trainer_for(conf.model)
    model = trainer.model
    n_params = sum(p.numel() for p in model.parameters())
    if name in PROTOMF:  # the JAX builds' default widths
        protos = [p for n, p in model.named_parameters()
                  if n.endswith("prototypes")]
        if not protos or any(tuple(p.shape) != (PROTOMF_PROTOTYPES,
                                                PROTOMF_WIDTH)
                             for p in protos):
            raise AssertionError(f"zoo {name}: prototypes "
                                 f"{[tuple(p.shape) for p in protos]}")
    for label, tower in zoo_towers(model).items():
        r = rows[label.split()[0].split("_")[0]]
        bag = tower.use_bag(r)
        if bag != label.startswith("user"):
            raise AssertionError(f"zoo {name} {label}: expected the user "
                                 f"tower's bag path and the item tower's "
                                 f"dense path")
        path = ("bag (K1, K6; K7)" if bag
                else "dense (K1, densify, matmul; K5)")
        log(f"zoo {name} {label} [{tower.csr.n_cols} -> "
            f"{tower.kernel.shape[1]}], longest row {tower.csr.max_row_len}:"
            f" {path} at {r} train rows; "
            f"{'bag' if tower.use_bag(8192) else 'dense'} at the catalog "
            f"encode's 8,192")

    # the kernels on the inputs one train step gives them, outside the
    # counted run: K5 on the dense towers' rows, K6 / K7 at every call
    # site, K13 on ECF's mask and tag-loss rows
    with recorded_spmm({}) as calls, recorded_dw([]) as dws, \
            recorded_topk([]) as topks:
        train_window(trainer, 1)
    for vec, g in dws[:1]:
        check_dw_case(f"zoo {name}, item tower", vec, g, timed=True)
    check_recorded(f"zoo {name} step", calls,
                   ("InteractionTower",) if name == "dmf" else
                   ("ECF",) if name == "ecf" else
                   ("Embedding",) + (("InteractionTower",)
                                     if name == "dropoutnet" else ()))
    if name == "ecf":
        check_topk_calls(f"zoo {name} step", topks)
    del calls, dws, topks
    if name in ZOO_REPEAT:
        repeat_step(f"zoo {name}", trainer)
    if name == "dmf":  # normalize_interactions: K5 on non-0/1 rows
        normed = trainer_for({**conf.model, "normalize_interactions": True})
        with recorded_dw([]) as dws:
            train_window(normed, 1)
        if check_dw_case("zoo dmf, normalize_interactions, item tower",
                         *dws[0]):
            raise AssertionError("normalize_interactions gave K5 0/1 rows")
        del normed, dws
    torch.cuda.empty_cache()

    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    warm = train_window(trainer, ZOO_WARMUP)
    steps = ZOO_STEPS_FOR.get(name, ZOO_STEPS)
    run = train_window(trainer, steps)
    losses = np.concatenate([warm["losses"], run["losses"]])
    first = float(losses[:ZOO_LOSS_WINDOW].mean())
    last = float(losses[-ZOO_LOSS_WINDOW:].mean())
    if not np.isfinite(losses).all() or not last < first:
        raise AssertionError(f"zoo {name}: losses not finite or not "
                             f"falling: first {first}, last {last}")
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = trainer.validate()
    torch.cuda.synchronize()
    val_wall = time.perf_counter() - t0
    check_metrics(f"zoo {name} validation", metrics, eval_conf())
    score_fn = make_score_fn(model, data.catalog)
    rec = Recommender(score_fn, test, data, k=K, batch_size=1024)
    if rec.use_dot != (name != "uiprotomfs"):  # JAX's dot parts, or none
        raise AssertionError(f"zoo {name}: serving took the "
                             f"{'dot' if rec.use_dot else 'scores'} path")
    users = np.random.default_rng(SEED).permutation(test.n_users)[:1024]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, vals = rec.recommend(users, return_scores=True)
    serve_ms = (time.perf_counter() - t0) * 1e3
    count_path(f"zoo {name} (train, validation, serving)", ZOO_KERNELS[name],
               ZOO_ABSENT[name])
    differ = check_lists(test, data, score_fn, users, ids, vals)
    if name in PROTOMF:
        check_post_val(name, model)
    log(f"zoo {name} ({n_params} parameters) on {card}: "
        f"{steps} steps after {ZOO_WARMUP}: host {run['host_ms']:.3f} "
        f"ms/step (synchronized), CUDA events {run['event_ms']:.3f} ms/step; "
        f"loss first {ZOO_LOSS_WINDOW} {first:.6f}, last {ZOO_LOSS_WINDOW} "
        f"{last:.6f}; max_memory_allocated {train_peak:.3f} GiB (training); "
        f"validation {val_wall:.3f} s, ndcg@10 {metrics['val/ndcg@10']:.6f}, "
        f"redone rows {sum(trainer.val_evaluator.redo_rows)}; one serving "
        f"batch of 1,024 {serve_ms:.3f} ms (first call), lists checked "
        f"({differ} differ from the plain path only on ties); "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f}"
        f" GiB (all)")
    trainer.learn.max_batches_per_epoch = PROFILE_STEPS
    profile_window(trainer.train_epoch, PROFILE_STEPS,
                   f"zoo {name} train steps")


def dmf_cli_phase(data_dir: str, run_dir: str, kernels, count_path,
                  card: str) -> None:
    """``python -m sibrar_tpu_torch.run_experiment -a dmf -c
    conf/single/dmf_onion18.yml -t train_val`` on the CLI phase's
    onion-scale artifacts (DMF reads no feature: none is loaded), one epoch
    of DMF_CLI_STEPS steps: the run files, JAX's keys, finite values; its
    wall time, ms per step and peak memory logged."""
    import numpy as np
    import torch

    from sibrar_tpu_torch.config.loader import get_config, parse_conf_file
    from sibrar_tpu_torch.run_experiment import main as run_experiment

    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = run_experiment([
        "-a", "dmf", "-c", os.path.join(ZOO_CONF_DIR, "dmf_onion18.yml"),
        "-d", data_dir, "-n", "onion18", "-t", "train_val",
        "-o", f"results_path={run_dir}", "-o", "dataset.user_features=[]",
        "-o", "dataset.item_features=[]", "-o", "eval.group_metrics=[]",
        "-o", "learn.n_epochs=1",
        "-o", f"learn.max_batches_per_epoch={DMF_CLI_STEPS}"])
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    count_path("dmf CLI train_val", ZOO_KERNELS["dmf"], ("window_max",))
    files = sorted(os.listdir(run_dir))
    if files != ["conf.yml", "metrics_val.yml", "model.pt"]:
        raise AssertionError(f"dmf CLI run files: {files}")
    conf = get_config(os.path.join(run_dir, "conf.yml"))
    saved = parse_conf_file(os.path.join(run_dir, "metrics_val.yml"))
    if (conf.algorithm != "dmf" or saved != metrics
            or set(metrics) != expected_keys(conf.eval, "val")
            or not all(np.isfinite(v) for v in metrics.values())):
        raise AssertionError("dmf CLI: metrics_val.yml not JAX's keys, not "
                             "finite or not what the run returned")
    log(f"dmf CLI train_val: {total:.2f} s on {card} ({DMF_CLI_STEPS} steps, "
        f"two validations, train and val loaded); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; val ndcg@10 "
        f"{metrics['val/ndcg@10']:.6f}")


def zoo_cli(args: list, label: str, kernels) -> tuple:
    """``run_experiment.main(args)`` from zero counts: its result, wall s
    and peak GiB."""
    import torch

    from sibrar_tpu_torch.run_experiment import main as run_experiment

    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run_experiment(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"{label}: {wall:.2f} s, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return out, wall


def check_gather(label: str, payload: dict, run_dir: str, split) -> None:
    """A gather payload against its pickle and the test split: JAX's keys,
    one row of k catalog positions and finite sorted values per user of
    the split, no seen item, the positives as (row, position) pairs."""
    import pickle

    import numpy as np

    keys = {"metrics", "raw_metrics", "user_indices", "topk_item_indices",
            "topk_logits", "targets", "n_users", "n_items", "k",
            "items_in_split"}
    with open(os.path.join(run_dir, "gather_test.pkl"), "rb") as fh:
        saved = pickle.load(fh)
    users, ids = payload["user_indices"], payload["topk_item_indices"]
    vals, k = payload["topk_logits"], payload["k"]
    n = len(split.users_in_split)
    if (set(payload) != keys or set(saved) != keys
            or not np.array_equal(saved["topk_item_indices"], ids)
            or not np.array_equal(users, split.users_in_split)
            or ids.shape != (n, k) or vals.shape != (n, k)
            or ids.dtype != np.int32 or payload["n_users"] != n
            or payload["n_items"] != split.n_items_in_split
            or not np.isfinite(vals).all()
            or (np.diff(vals, axis=1) > 0).any()
            or any(len(v) != n for v in payload["raw_metrics"].values())):
        raise AssertionError(f"{label}: payload keys, shapes or values")
    check_excluded(split, users, payload["items_in_split"][ids])
    t = payload["targets"]
    if not 0 < len(t) <= len(split.interactions) or t.dtype != np.int64:
        raise AssertionError(f"{label}: targets {t.shape} {t.dtype}")


def zoo_cli_phase(data_dir: str, root: str, kernels, count_path,
                  card: str) -> None:
    """On the CLI phase's artifacts, one epoch of ZOO_CLI_STEPS steps
    each: ``-a uprotomfs`` and ``-a iprotomfs -c conf/base.yml -t
    train_val`` (the post-validation keys among the metrics), then ``-a
    uiprotomfs_combine --split_set test`` on the two run directories;
    ``-a ecf -c conf/ecf.yml -t train_val``, then ``-t gather`` on that
    run (`check_gather`) and ``-t test``, whose metrics must equal the
    gather's; a gather of the UProtoMFs run, and
    ``stat_tests.compare_gathers`` over the two."""
    import numpy as np

    from sibrar_tpu_torch.config.loader import get_config, load_split_type
    from sibrar_tpu_torch.data.dataset import RecDataset
    from sibrar_tpu_torch.eval.stat_tests import compare_gathers

    common = ["-d", data_dir, "-n", "onion18",
              "-o", "dataset.user_features=[]", "-o", "eval.group_metrics=[]",
              "-o", "learn.n_epochs=1",
              "-o", f"learn.max_batches_per_epoch={ZOO_CLI_STEPS}"]
    runs = {}
    for name in ("uprotomfs", "iprotomfs", "ecf"):
        run_dir = runs[name] = os.path.join(root, f"{name}_run")
        args = ["-a", name, "-c", zoo_conf_path(name), *common,
                "-o", f"results_path={run_dir}"]
        if name != "ecf":
            args += ["-o", "dataset.item_features=[]"]
        metrics, _ = zoo_cli(args + ["-t", "train_val"],
                             f"{name} CLI train_val ({ZOO_CLI_STEPS} steps, "
                             f"two validations) on {card}", kernels)
        count_path(f"{name} CLI train_val", ZOO_KERNELS[name],
                   ZOO_ABSENT[name])
        conf = get_config(os.path.join(run_dir, "conf.yml"))
        extra = (post_val_keys(name, True) | {"user_tsne_plot",
                                              "item_tsne_plot"}
                 if name != "ecf" else set())
        keys = expected_keys(conf.eval, "val")
        if (not keys <= set(metrics) <= keys | extra
                or not all(np.isfinite(metrics[k]) for k in keys)):
            raise AssertionError(f"{name} CLI: metric keys {sorted(metrics)}")
        log(f"{name} CLI train_val: val ndcg@10 {metrics['val/ndcg@10']:.6f}"
            f"; files {sorted(os.listdir(run_dir))}")
        if name == "iprotomfs":
            combined, _ = zoo_cli(
                ["-a", "uiprotomfs_combine", "--split_set", "test",
                 "--u_run_dir", runs["uprotomfs"], "--i_run_dir", run_dir],
                f"uiprotomfs_combine CLI (two runs reloaded, the test split "
                f"evaluated) on {card}", kernels)
            count_path("uiprotomfs_combine CLI",
                       ["segment_gather", "spmm_fwd", "window_max"],
                       ("score_wmax",))
            if set(combined) != expected_keys(conf.eval, "test") or not all(
                    np.isfinite(v) for v in combined.values()):
                raise AssertionError("uiprotomfs_combine: metric keys or "
                                     "values")
            log(f"uiprotomfs_combine: test ndcg@10 "
                f"{combined['test/ndcg@10']:.6f}")

    ecf = ["-a", "ecf", "-c", zoo_conf_path("ecf"), *common,
           "-o", f"results_path={runs['ecf']}"]
    payload, _ = zoo_cli(ecf + ["-t", "gather", "--split_set", "test"],
                         f"ecf CLI gather (test split) on {card}",
                         kernels)
    count_path("ecf CLI gather", ["segment_gather", "spmm_fwd", "exact_topk",
                                  "window_max"], ("score_wmax",))
    test = RecDataset.load(data_dir, "test",
                           split_type=load_split_type(data_dir))
    check_gather("ecf gather", payload, runs["ecf"], test)
    tested, _ = zoo_cli(ecf + ["-t", "test"], f"ecf CLI test on {card}",
                        kernels)
    if payload["metrics"] != tested:
        diff = {k: tested[k] - v for k, v in payload["metrics"].items()
                if tested.get(k) != v}
        raise AssertionError(f"ecf gather: metrics differ from run_test's: "
                             f"{sorted(diff.items())[:6]}")
    u_payload, _ = zoo_cli(
        ["-a", "uprotomfs", "-c", zoo_conf_path("uprotomfs"), *common,
         "-o", f"results_path={runs['uprotomfs']}",
         "-o", "dataset.item_features=[]", "-t", "gather"],
        f"uprotomfs CLI gather on {card}", kernels)
    check_gather("uprotomfs gather", u_payload, runs["uprotomfs"], test)
    key = "test/ndcg@10"
    (cmp,) = compare_gathers({name: os.path.join(runs[name],
                                                 "gather_test.pkl")
                              for name in ("ecf", "uprotomfs")}, key)
    if not 0.0 <= cmp.p_value <= 1.0:
        raise AssertionError(f"compare_gathers: p-value {cmp.p_value}")
    log(f"ecf gather: {len(payload['user_indices'])} users x k "
        f"{payload['k']}, metrics equal to run_test's (test ndcg@10 "
        f"{tested[key]:.6f}); stat_tests.compare_gathers on {key}: best "
        f"{cmp.best_model} against {cmp.other_model}, p {cmp.p_value:.3e}, "
        f"Bonferroni threshold {cmp.threshold}, significant "
        f"{cmp.significant}")


SWEEP_CONF_PATH = os.path.join(os.path.dirname(os.path.dirname(CONF_PATH)),
                               "sweeps", "sbnet",
                               "sbnet_onion18_random_huge_no-user.yml")
# the SBNet sweep's trials (two, so that the mesh phase fits the script's
# time limit) and their steps
SWEEP_TRIALS, SWEEP_BATCHES = 2, 100
# torch.cuda.memory_allocated() after a trial may stay this far above its
# value before the first trial: room for the workspaces cuBLAS keeps once
# made (32 MiB per thread on Hopper: the caller's and autograd's backward
# thread) and cuBLASLt's (1 MiB), which a process makes on its first GEMMs.
# The script's earlier phases made them already; a process whose first GEMMs
# are the first trial's grows by 65 MiB there and by 0 B after the second
# and third (an H100 at 700 W). A trial whose tensors stayed would hold more
# than a GiB: its model and AdamW moments, the device data and the encoded
# catalog.
SWEEP_MEMORY_MARGIN = 96 * 2**20
LAUNCH_WORKERS, LAUNCH_TRIALS, LAUNCH_KEEP = 2, 2, 2  # trials per worker


def sweep_phase(data_dir: str, root: str, kernels, count_path,
                card: str) -> None:
    """The port's sweeps on the card: the paper's SBNet sweep in this
    process on the CLI phase's onion-scale artifacts (`sbnet_sweep`), then
    the launcher with two workers on the one card (`launcher_sweep`)."""
    t0 = time.perf_counter()
    sbnet_sweep(data_dir, root, kernels, count_path, card)
    launcher_sweep(root, card)
    log(f"sweep: {time.perf_counter() - t0:.1f} s on {card}")


def sbnet_sweep(data_dir: str, root: str, kernels, count_path,
                card: str) -> None:
    """``sweep_agent.main(-c <copy> -o <dir>)`` in this process. The copy of
    ``conf/sweeps/sbnet/sbnet_onion18_random_huge_no-user.yml`` keeps its
    method (bayes), seed, metric and parameters; its base config is
    ``conf/single/sbnet_onion18_huge_no-user.yml`` (full width) on the
    onion-scale artifacts with the CLI phase's overrides, one epoch of
    SWEEP_BATCHES steps, SWEEP_TRIALS trials, the best run's model kept.
    Checks: K1-K7 launched; the trials' parameters are the first
    suggestions of a fresh ``TPESampler(parameters, seed)`` (its startup
    draws) and reach each run's ``conf.yml``; each run's files with JAX's
    keys and finite values, ``model.pt`` in the best run only;
    ``sweep_state.yml``; the best-trial line; and after every trial
    ``torch.cuda.memory_allocated()`` within SWEEP_MEMORY_MARGIN of its
    value before the first."""
    import contextlib
    import io

    import numpy as np
    import torch
    import yaml

    from sibrar_tpu_torch import experiment
    from sibrar_tpu_torch.config.loader import nested_dict_get, parse_conf_file
    from sibrar_tpu_torch.sweep import load_sweep_config
    from sibrar_tpu_torch.sweep_agent import main as sweep_agent
    from sibrar_tpu_torch.tpe import TPESampler
    from sibrar_tpu_torch.train.trainer import Trainer

    raw = parse_conf_file(SWEEP_CONF_PATH)
    base_config = raw["base_config"]
    base_config["base_configs"] = CONF_PATH
    base_config.setdefault("dataset", {}).update(
        dataset_path=data_dir, user_features=[],
        item_features=[{"name": n, "type": t} for n, t in CLI_FEATURES])
    base_config["eval"] = {"group_metrics": []}
    base_config["learn"] = {"n_epochs": 1,
                            "max_batches_per_epoch": SWEEP_BATCHES}
    raw.update(n_trials=SWEEP_TRIALS, keep_top_runs=1)
    path = os.path.join(root, "sbnet_sweep.yml")
    with open(path, "w") as fh:  # the file's key order: the TPE's draw order
        yaml.safe_dump(raw, fh, sort_keys=False)
    sweep, paper = load_sweep_config(path), load_sweep_config(SWEEP_CONF_PATH)
    for key in ("method", "seed", "metric", "goal", "parameters"):
        if getattr(sweep, key) != getattr(paper, key):
            raise AssertionError(f"SBNet sweep: {key} differs from the paper "
                                 f"sweep's")
    if list(sweep.parameters) != list(paper.parameters):
        raise AssertionError("SBNet sweep: parameters out of the paper "
                             "sweep's order")
    sampler = TPESampler(paper.parameters, seed=paper.seed)
    want = [sampler.suggest() for _ in range(SWEEP_TRIALS)]

    trials = []
    run_train_val_test, train_epoch = (experiment.run_train_val_test,
                                       Trainer.train_epoch)

    def timed_epoch(self):
        torch.cuda.synchronize()
        t1, steps = time.perf_counter(), self.step
        out = train_epoch(self)
        torch.cuda.synchronize()
        trials[-1]["train_s"] += time.perf_counter() - t1
        trials[-1]["steps"] += self.step - steps
        return out

    def trial(conf):
        torch.cuda.synchronize()
        trials.append(dict(entry=torch.cuda.memory_allocated(), train_s=0.0,
                           steps=0))
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        val, test = run_train_val_test(conf)
        torch.cuda.synchronize()
        trials[-1].update(wall=time.perf_counter() - t1,
                          peak=torch.cuda.max_memory_allocated(),
                          ndcg=val["val/ndcg@10"])
        return val, test

    results = os.path.join(root, "sbnet_sweep")
    printed = io.StringIO()
    reset_counts(kernels)
    experiment.run_train_val_test, Trainer.train_epoch = trial, timed_epoch
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            sweep_agent(["-c", path, "-o", results])
    finally:
        experiment.run_train_val_test = run_train_val_test
        Trainer.train_epoch = train_epoch
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    final = torch.cuda.memory_allocated()
    count_path("SBNet sweep", ["segment_gather", "score_wmax",
                               "gather_windows", "peel_values",
                               "recover_winners", "dw_matmul", "spmm_fwd",
                               "spmm_bwd"])
    line = printed.getvalue().strip().splitlines()[-1]
    log(f"SBNet sweep, sweep_agent's last line: {line}")
    best = json.loads(line)

    records = parse_conf_file(os.path.join(results,
                                           "sweep_state.yml"))["records"]
    if ([r["trial"] for r in records] != list(range(SWEEP_TRIALS))
            or [r["params"] for r in records] != want):
        raise AssertionError(f"SBNet sweep: trials {records} are not the "
                             f"TPE's startup draws {want}")
    runs = sorted(os.path.join(results, d) for d in os.listdir(results)
                  if os.path.isdir(os.path.join(results, d)))
    if runs != sorted(r["results_path"] for r in records):
        raise AssertionError(f"SBNet sweep: run directories {runs}")
    ev = eval_conf()
    ranked = sorted(records, key=lambda r: r["metrics"]["val/ndcg@10"],
                    reverse=True)
    for rank, rec in enumerate(ranked):
        run = rec["results_path"]
        files = sorted(os.listdir(run))
        model = ["model.pt"] if rank == 0 else []
        if files != sorted(["conf.yml", "metrics_test.yml",
                            "metrics_val.yml", *model]):
            raise AssertionError(f"SBNet sweep trial {rec['trial']}: files "
                                 f"{files}")
        conf = parse_conf_file(os.path.join(run, "conf.yml"))
        for key, value in rec["params"].items():
            if nested_dict_get(conf, key) != value:
                raise AssertionError(f"SBNet sweep trial {rec['trial']}: "
                                     f"conf.yml's {key} is not {value}")
        for name in ("val", "test"):
            metrics = parse_conf_file(os.path.join(run,
                                                   f"metrics_{name}.yml"))
            if set(metrics) != expected_keys(ev, name) or not all(
                    np.isfinite(v) for v in metrics.values()):
                raise AssertionError(f"SBNet sweep trial {rec['trial']}: "
                                     f"metrics_{name}.yml keys or values")
    top = ranked[0]
    if (best["best_trial"], best["params"], best["metric"], best["value"]) \
            != (top["trial"], top["params"], "val/ndcg@10",
                top["metrics"]["val/ndcg@10"]):
        raise AssertionError(f"SBNet sweep: best line {best}, best record "
                             f"{top}")

    left = [t["entry"] for t in trials[1:]] + [final]
    for t, (rec, info) in enumerate(zip(records, trials)):
        log(f"SBNet sweep trial {t} ({rec['params']}): {info['wall']:.2f} s, "
            f"{info['steps']} steps in {info['train_s']:.2f} s "
            f"({info['steps'] / info['train_s']:.2f} steps/s, host, "
            f"synchronized), val ndcg@10 {info['ndcg']:.6f}, "
            f"max_memory_allocated {info['peak'] / 2**30:.3f} GiB, "
            f"memory_allocated before {info['entry']} B, after "
            f"{left[t]} B ({left[t] - trials[0]['entry']:+d} B against the "
            f"first trial's start) on {card}")
    grown = [b - trials[0]["entry"] for b in left]
    if max(grown) > SWEEP_MEMORY_MARGIN:
        raise AssertionError(f"SBNet sweep: memory_allocated grew by {grown} "
                             f"B over the trials (margin "
                             f"{SWEEP_MEMORY_MARGIN} B)")
    log(f"SBNet sweep: {SWEEP_TRIALS} trials in {total:.2f} s on {card}; "
        f"best trial {best['best_trial']}, val ndcg@10 {best['value']:.6f}")


def launcher_sweep(root: str, card: str) -> None:
    """``python -m sibrar_tpu_torch.run_agent -p 2 --trials-per-worker 2
    --devices 0,0`` from the temporary directory: a bayes sweep with
    ``shared_history`` over ``mf`` on the mid-scale artifacts of
    ``tools/trained_parity.py``, both workers on the card. Launch counts
    do not cross processes, so the check is the files and exit codes: both
    workers exit 0, each writes its state file, the shared log holds every
    trial, and global retention leaves LAUNCH_KEEP ``model.pt`` files, the
    best trials'."""
    import glob

    import numpy as np

    from sibrar_tpu_torch.config.loader import parse_conf_file, yaml_save
    from sibrar_tpu_torch.sweep import SharedObservationLog
    from sibrar_tpu_torch.tools import trained_parity

    data_dir = trained_parity.make_midscale_artifacts(
        os.path.join(root, "sweep_mid"))
    results = os.path.join(root, "mf_sweep")
    path = os.path.join(root, "mf_sweep.yml")
    n_trials = LAUNCH_WORKERS * LAUNCH_TRIALS
    yaml_save(path, {
        "method": "bayes", "shared_history": True, "metric": "val/ndcg@10",
        "n_trials": n_trials, "keep_top_runs": LAUNCH_KEEP, "seed": SEED,
        "parameters": {
            "learn.lr": {"min": 1e-4, "max": 1e-2,
                         "distribution": "log_uniform"},
            "model.embedding_dim": {"values": [16, 32, 64]}},
        "base_config": {
            "algorithm": "mf",
            "dataset": {"dataset_path": data_dir, "n_negative_samples": 10},
            "learn": {"n_epochs": 2, "optimizing_metric": "ndcg@10"},
            "eval": {"top_k": [10], "metrics": ["ndcg", "recall"],
                     "group_metrics": []},
            "loader": {"batch_size": 512, "eval_batch_size": 256},
            "run_settings": {"device": DEVICE, "seed": SEED}}})
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sibrar_tpu_torch.run_agent", "-c", path,
         "-o", results, "-p", str(LAUNCH_WORKERS), "--trials-per-worker",
         str(LAUNCH_TRIALS), "--devices", ",".join(["0"] * LAUNCH_WORKERS)],
        capture_output=True, text=True, cwd=root, timeout=600,
        env={**os.environ,
             "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))})
    wall = time.perf_counter() - t0
    log(f"run_agent ({wall:.2f} s, exit {proc.returncode}): "
        + " | ".join(proc.stdout.strip().splitlines()))
    if proc.returncode != 0 or any(
            f"worker {i} finished with code 0" not in proc.stdout
            for i in range(LAUNCH_WORKERS)):
        raise AssertionError(f"run_agent: {proc.stdout[-2000:]} "
                             f"{proc.stderr[-2000:]}")
    for i in range(LAUNCH_WORKERS):
        offset = i * LAUNCH_TRIALS
        state = os.path.join(results, f"sweep_state_t{offset}.yml"
                             if offset else "sweep_state.yml")
        trials = [r["trial"] for r in parse_conf_file(state)["records"]]
        if trials != list(range(offset, offset + LAUNCH_TRIALS)):
            raise AssertionError(f"run_agent: {state} holds trials {trials}")
    obs = SharedObservationLog(results).read()
    if sorted(r["trial"] for r in obs) != list(range(n_trials)) or not all(
            np.isfinite(r["value"]) for r in obs):
        raise AssertionError(f"run_agent: observations {obs}")
    kept = {os.path.dirname(p)
            for p in glob.glob(os.path.join(results, "*", "model.pt"))}
    best = {r["results_path"] for r in sorted(
        obs, key=lambda r: r["value"], reverse=True)[:LAUNCH_KEEP]}
    if kept != best:
        raise AssertionError(f"run_agent: model.pt kept in {kept}, the best "
                             f"runs are {best}")
    values = ", ".join(f"{r['value']:.6f}" for r in obs)
    log(f"run_agent: {LAUNCH_WORKERS} workers x {LAUNCH_TRIALS} mf trials "
        f"on one card in {wall:.2f} s on {card}; {len(obs)} shared "
        f"observations, val ndcg@10 {values}; model.pt kept in the best "
        f"{len(kept)}")


KNN_CONF_PATH = os.path.join(os.path.dirname(CONF_PATH), "knn.yml")
# the validation / serving path of a matrix scorer (no dot parts, so no K2):
# the exclusion rows (K1), then the peel over the scores (K8, K3, K4) at
# C = 100,352; at C <= 4,096 `masked_topk` takes ``full`` (K1, K13)
MATRIX_PEEL_KERNELS = ["segment_gather", "window_max", "gather_windows",
                       "peel_values", "recover_winners"]
MATRIX_FULL_KERNELS = ["segment_gather", "exact_topk"]
MATRIX_ABSENT = ("score_wmax", "score_bf16")
MATRIX_SAMPLE_ROWS = 8  # similarity rows held to the host recomputation
MATRIX_ULPS = 4  # f32 roundings of the shrunk cosine: both norms, their
#                  product, the ratio, co + s, co / (co + s), the product
ML1M_SHAPE = dict(n_users=6040, n_items=3706, n_interactions=1000209)
# the ML-1M-shape runs, at the quality run's hyperparameters
# (trained_parity.MATRIX_HPARAMS: knn.yml's KNN, EASE at Steck (2019)'s
# lambda, SLIM's and P3alpha's defaults, the `implicit` library's ALS
# defaults, 100 factors / representatives); ifknn over ivec256
ML1M_NAMES = ("uknn", "ifknn", "ease", "slim", "p3alpha", "als", "svd",
              "rbmf")
MATRIX_NAMES = ("uknn", "iknn", "ifknn", "svd", "als", "rbmf", "slim",
                "ease", "p3alpha", "rand", "pop")


def get_knn_conf() -> dict:
    """conf/single/knn.yml's model block (k = 100, shrinkage 10, cosine),
    read through the port's loader; the quality run's KNN settings must
    be the same."""
    from sibrar_tpu_torch.config.loader import get_config
    from sibrar_tpu_torch.tools import trained_parity

    conf = get_config(KNN_CONF_PATH).model
    if conf != trained_parity.MATRIX_HPARAMS["iknn"]:
        raise AssertionError(f"knn.yml's model block {conf} is not the "
                             f"quality run's KNN")
    return conf


def host_peak_gib() -> float:
    """The process's peak resident set so far (GiB)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def same_ids_as_plain(label: str, split, users, ids, vals, scores,
                     csr) -> None:
    """Served lists against `plain_oracle` (the exclusion fill and K13's
    plain version, in ``lax.top_k``'s order) on the scores the scorer
    gives: values and ids bit for bit, no seen item."""
    import numpy as np

    check_excluded(split, users, ids)
    ov, oi = plain_oracle(scores, csr, users, ids.shape[1])
    pos = np.searchsorted(np.asarray(split.items_in_split), ids)
    if not (np.array_equal(vals, ov) and np.array_equal(pos, oi)):
        rows = np.nonzero((pos != oi).any(1) | (vals != ov).any(1))[0]
        raise AssertionError(f"{label}: {len(rows)} rows differ from the "
                             f"plain oracle's lists (first {rows[:5]})")


def check_similarity_rows(label: str, sim, matrix, shrinkage: float,
                          k: int, rng) -> None:
    """Sampled rows of a cosine similarity CSR (rows of ``matrix``, 0/1)
    against the host: co-occurrence counts from an exact sparse product,
    the port's f32 chain on them (norms, ratio, shrink) and the top-k in
    ``lax.top_k``'s order give the row's ids and values bit for bit; each
    value within MATRIX_ULPS f32 ulps of the float64 formula."""
    import numpy as np
    import scipy.sparse as sp

    m = sp.csr_matrix(matrix, dtype=np.float64)
    n = m.shape[0]
    rows = np.concatenate([rng.choice(n, MATRIX_SAMPLE_ROWS - 1,
                                      replace=False),
                           [int(np.diff(m.indptr).argmax())]])
    ss = np.asarray(m.multiply(m).sum(axis=1)).ravel()
    norm32 = np.sqrt(ss.astype(np.float32))
    worst = 0.0
    for r in rows:
        co = (m[r] @ m.T).toarray().ravel()
        co32 = co.astype(np.float32)
        denom = norm32[r] * norm32
        with np.errstate(divide="ignore", invalid="ignore"):
            s32 = np.where(denom > 0, co32 / denom, np.float32(0.0))
            s32 = s32 * (co32 / (co32 + np.float32(shrinkage)))
            s64 = np.where(ss[r] * ss > 0, co / np.sqrt(ss[r] * ss), 0.0)
            s64 = s64 * (co / (co + shrinkage))
        s32 = s32.astype(np.float32)
        s32[r] = 0.0
        order = np.argsort(-s32, kind="stable")[:k]
        order = order[s32[order] != 0]
        got = slice(sim.indptr[r], sim.indptr[r + 1])
        if not (np.array_equal(sim.indices[got], order)
                and np.array_equal(sim.data[got], s32[order])):
            raise AssertionError(f"{label}: similarity row {r} differs "
                                 f"from the host's f32 chain")
        ulp = np.spacing(np.abs(s32[order]).astype(np.float32))
        worst = max(worst, float((np.abs(s32[order] - s64[order])
                                  / ulp).max(initial=0.0)))
    if worst > MATRIX_ULPS:
        raise AssertionError(f"{label}: {worst:.2f} ulps from float64")
    log(f"{label}: {len(rows)} similarity rows (the longest included) "
        f"bit-equal to the host's f32 chain on exact counts, ids in "
        f"lax.top_k's order; at most {worst:.2f} f32 ulps from the float64 "
        f"formula (bound {MATRIX_ULPS})")


def matrix_serve(label: str, score_fn, split, data, kernels, count_path,
                 users, needed: list) -> tuple[float, float]:
    """One warm-up batch of 1,024 users, then one timed batch, through the
    ``Recommender`` (k = K), gated by ``needed``; the timed batch's lists
    against `plain_oracle` bit for bit. Returns its ms and the peak device
    GiB so far, read before the oracle's sort."""
    import torch

    from sibrar_tpu_torch.serve import Recommender

    rec = Recommender(score_fn, split, data, k=K, batch_size=1024)
    rec.recommend(users[:1024])
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, vals = rec.recommend(users[1024:2048], return_scores=True)
    ms = (time.perf_counter() - t0) * 1e3
    count_path(f"{label} serving", needed, MATRIX_ABSENT)
    peak = torch.cuda.max_memory_allocated() / 2**30
    u = torch.as_tensor(users[1024:2048], device=data.catalog.device)
    same_ids_as_plain(f"{label} serving", split, users[1024:2048], ids,
                      vals, score_fn(u), data.exclude_csr)
    return ms, peak


def matrix_run(name: str, conf: dict, train, val, test, vdata, data,
               kernels, count_path, card: str, users, needed: list,
               fit_kwargs=None) -> dict:
    """One matrix algorithm through the registry: fit (K13 launches
    counted), one validation of the val split's users (gated by
    ``needed``, JAX's keys, finite), one serving batch of 1,024; times,
    peak device and host memory logged."""
    import numpy as np
    import torch

    from sibrar_tpu_torch.eval.evaluator import FullEvaluator, evaluate_model
    from sibrar_tpu_torch.models.registry import get_algorithm

    alg = get_algorithm(name).build(conf, train, DEVICE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    alg.fit(matrix=train.user_sampling_matrix, **(fit_kwargs or {}))
    score_fn = alg.score_fn(val.items_in_split)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    k13 = read_counts(kernels)["exact_topk"]
    if hasattr(alg, "pred_mtx"):
        alg.pred_mtx = None  # the card holds the scores now
    ev_conf = eval_conf()
    ev = FullEvaluator(ev_conf, val, vdata, evaluator_name="val")
    reset_counts(kernels)
    t0 = time.perf_counter()
    metrics = evaluate_model(score_fn, ev, LOADER_CONF["eval_batch_size"])
    val_s = time.perf_counter() - t0
    count_path(f"{name} validation", needed, MATRIX_ABSENT)
    check_metrics(f"{name} validation", metrics, ev_conf)
    serve_ms, peak = matrix_serve(name, score_fn, test, data, kernels,
                                  count_path, users, needed)
    log(f"matrix {name} ({train.n_users} users x {train.n_items} items, "
        f"{train.user_sampling_matrix.nnz} train pairs): fit {fit_s:.2f} s "
        f"(K13 launches {k13}), validation of {len(val.users_in_split)} "
        f"users {val_s:.2f} s, serving {serve_ms:.2f} ms per 1,024 users, "
        f"max_memory_allocated {peak:.3f} GiB, host peak RSS "
        f"{host_peak_gib():.2f} GiB; val ndcg@10 "
        f"{metrics['val/ndcg@10']:.6f}, recall@10 "
        f"{metrics['val/recall@10']:.6f} on {card}")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{name}: non-finite metrics")
    return {"fit_s": fit_s, "val_s": val_s, "serve_ms": serve_ms,
            "peak_gib": peak, "k13": k13}


def iknn_onion(splits, vdata, data, kernels, count_path, card: str,
               users) -> None:
    """iknn at conf/single/knn.yml's width on the onion-scale splits: the
    similarity over the 100,352 items' rows of the 50,000-user train
    matrix (full-f32 GEMMs, K13 per block of 4,096), K13's recorded calls
    against its plain version, sampled rows against the host, K13's time
    at the block shape beside ``torch.topk``'s, then the validation and a
    serving batch (`matrix_run`)."""
    import numpy as np
    import torch

    from sibrar_tpu_torch.models import matrix_algs
    from sibrar_tpu_torch.ops.exact_topk import exact_topk

    conf = get_knn_conf()
    train, val, test = splits["train"], splits["val"], splits["test"]
    real = matrix_algs.compute_similarity_top_k
    sims = {}

    def timed_similarity(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sims["csr"] = real(*args, **kwargs)
        torch.cuda.synchronize()
        sims["s"] = time.perf_counter() - t0
        sims["peak"] = torch.cuda.max_memory_allocated() / 2**30
        return sims["csr"]

    calls = []
    matrix_algs.compute_similarity_top_k = timed_similarity
    try:
        with recorded_topk(calls, matrix_algs):
            res = matrix_run("iknn", conf, train, val, test, vdata, data,
                             kernels, count_path, card, users,
                             MATRIX_PEEL_KERNELS)
    finally:
        matrix_algs.compute_similarity_top_k = real
    n, m = train.n_items, train.n_users
    log(f"iknn similarity: {sims['s']:.2f} s of the fit's {res['fit_s']:.2f}"
        f" s ({2 * n * n * m:.3e} FLOP of f32 GEMM, "
        f"{2 * n * n * m / sims['s'] / 1e12:.1f} TFLOP/s over the whole "
        f"similarity; peak {sims['peak']:.3f} GiB with the dense "
        f"[{n} x {m}] f32 matrix, {4 * n * m / 2**30:.2f} GiB) on {card}")
    check_topk_calls("iknn similarity", calls)
    x, k = calls[0]
    ms = cuda_ms(lambda: exact_topk(x, k), 5)
    lib = cuda_ms(lambda: torch.topk(x, k, dim=1), 5)
    b = bound(4 * x.numel() + 12 * x.shape[0] * k)
    passing = topk_passing(x, k)
    log(f"K13 at the similarity block [{x.shape[0]} x {x.shape[1]}], k = "
        f"{k}: {ms:.4f} ms, torch.topk {lib:.4f} ms, bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}) on {card}; "
        f"{int((passing > 2048).sum())} rows take its exact path (more "
        f"than 2,048 elements pass the threshold; median "
        f"{int(passing.median())})")
    del calls, x
    check_similarity_rows("iknn similarity", sims["csr"],
                          train.user_sampling_matrix.T, 10.0, 100,
                          np.random.default_rng(SEED))
    torch.cuda.empty_cache()


def matrix_phase(splits, device_data: dict, kernels, count_path,
                 card: str) -> None:
    """The matrix algorithms on the card: iknn (`iknn_onion`), pop and
    rand at onion scale (validation of the 50,000 val users through the
    peel, a serving batch of 1,024 held to the plain oracle bit for
    bit); then uknn, ifknn (over ivec256, whose cosines go negative),
    ease, slim, p3alpha, als, svd and rbmf at ML-1M's shape, each fitted,
    validated and serving one batch; then the CLI for all eleven names
    (`matrix_cli_phase`) and their quality against JAX's values."""
    import numpy as np
    import torch

    from sibrar_tpu_torch.data.dataset import make_splits
    from sibrar_tpu_torch.data.synthetic import make_onion_scale_splits
    from sibrar_tpu_torch.tools import trained_parity

    users = np.random.default_rng(SEED + 5).permutation(
        splits["test"].n_users)
    vdata, data = device_data["val"], device_data["test"]
    iknn_onion(splits, vdata, data, kernels, count_path, card, users)
    for name in ("pop", "rand"):
        matrix_run(name, {}, splits["train"], splits["val"], splits["test"],
                   vdata, data, kernels, count_path, card, users,
                   MATRIX_PEEL_KERNELS)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ml = make_splits(make_onion_scale_splits(**ML1M_SHAPE))
    ml_val, ml_test = ml["val"].to_device(DEVICE), ml["test"].to_device(DEVICE)
    log(f"ML-1M-shape splits: {time.perf_counter() - t0:.2f} s; "
        f"{ml['train'].n_users} users x {ml['train'].n_items} items, train "
        f"{len(ml['train'].interactions)}, val {len(ml['val'].interactions)}"
        f", test {len(ml['test'].interactions)}")
    ml_users = np.random.default_rng(SEED + 6).permutation(
        ml["test"].n_users)
    for name in ML1M_NAMES:
        conf, kwargs = dict(trained_parity.MATRIX_HPARAMS[name]), {}
        if name == "ifknn":
            conf["feature_name"] = "ivec256"
            kwargs["feature_matrix"] = ml["train"].item_features[
                "ivec256"].dense_table()
        matrix_run(name, conf, ml["train"], ml["val"], ml["test"], ml_val,
                   ml_test, kernels, count_path, card, ml_users,
                   MATRIX_FULL_KERNELS, kwargs)
    del ml, ml_val, ml_test
    torch.cuda.empty_cache()

    import tempfile

    with tempfile.TemporaryDirectory() as root:
        matrix_cli_phase(root, kernels, count_path, card)
    matrix_quality(card)


def matrix_cli_phase(root: str, kernels, count_path, card: str) -> None:
    """``python -m sibrar_tpu_torch.run_experiment -a <name> -t
    train_val_test`` in this process for each of the eleven matrix names
    on the mid-scale artifacts of ``tools/trained_parity.py`` (1,000 users
    x 1,500 items x 50k interactions), at the quality run's
    hyperparameters (``trained_parity.MATRIX_HPARAMS``; the YAML written
    to ``root``): run files, JAX's keys, each run gated by its kernels;
    then ``-t gather`` of the iknn run (`check_gather`), whose metrics
    must equal ``-t test``'s, and ``serve_recs`` from the pop run
    directory, equal to ``Recommender.from_run_dir``'s lists."""
    import numpy as np

    from sibrar_tpu_torch.config.loader import load_split_type, yaml_save
    from sibrar_tpu_torch.data.dataset import RecDataset
    from sibrar_tpu_torch.serve import Recommender
    from sibrar_tpu_torch.serve_recs import main as serve_recs
    from sibrar_tpu_torch.tools import trained_parity

    data_dir = trained_parity.make_midscale_artifacts(
        os.path.join(root, "matrix_mid"))
    runs = {}
    for name in MATRIX_NAMES:
        run_dir = runs[name] = os.path.join(root, f"{name}_matrix_run")
        conf = {"model": trained_parity.MATRIX_HPARAMS[name],
                "eval": {**EVAL_CONF, "group_metrics": []},
                "loader": {"eval_batch_size": 256},
                "run_settings": {"device": "cuda", "seed": SEED},
                "results_path": run_dir}
        if name == "ifknn":
            conf["dataset"] = {"item_features": [
                {"name": conf["model"]["feature_name"], "type": "vector"}]}
        path = os.path.join(root, f"{name}_matrix.yml")
        yaml_save(path, conf)
        (val, test), _ = zoo_cli(
            ["-a", name, "-c", path, "-d", data_dir, "-t", "train_val_test"],
            f"{name} CLI train_val_test on {card}", kernels)
        count_path(f"{name} CLI train_val_test", MATRIX_FULL_KERNELS,
                   MATRIX_ABSENT)
        ev = eval_conf()
        check_metrics(f"{name} CLI validation", val, ev)
        if set(test) != expected_keys(ev, "test"):
            raise AssertionError(f"{name} CLI: test keys {sorted(test)}")
        if sorted(os.listdir(run_dir)) != ["conf.yml", "metrics_test.yml",
                                           "metrics_val.yml", "model.npz"]:
            raise AssertionError(f"{name} CLI: files "
                                 f"{sorted(os.listdir(run_dir))}")
        log(f"{name} CLI: val ndcg@10 {val['val/ndcg@10']:.6f}, test "
            f"ndcg@10 {test['test/ndcg@10']:.6f}")
    iknn = ["-a", "iknn", "-c", os.path.join(root, "iknn_matrix.yml"),
            "-d", data_dir]
    payload, _ = zoo_cli(iknn + ["-t", "gather", "--split_set", "test"],
                         f"iknn CLI gather (test split) on {card}", kernels)
    count_path("iknn CLI gather", MATRIX_FULL_KERNELS, MATRIX_ABSENT)
    test = RecDataset.load(data_dir, "test",
                           split_type=load_split_type(data_dir))
    check_gather("iknn gather", payload, runs["iknn"], test)
    tested, _ = zoo_cli(iknn + ["-t", "test"], f"iknn CLI test on {card}",
                        kernels)
    if payload["metrics"] != tested:
        raise AssertionError("iknn gather: metrics differ from run_test's")
    users = np.arange(0, test.n_users, 7)
    out = os.path.join(root, "pop_recs.jsonl")
    reset_counts(kernels)
    serve_recs(["-r", runs["pop"], "-s", "test", "-k", "10", "--scores",
                "-u", ",".join(map(str, users)), "-o", out])
    count_path("pop serve_recs", MATRIX_FULL_KERNELS, MATRIX_ABSENT)
    with open(out) as fh:
        lines = [json.loads(line) for line in fh]
    want = Recommender.from_run_dir(runs["pop"], "test", k=10).recommend(
        users)
    if not np.array_equal([ln["items"] for ln in lines], want):
        raise AssertionError("pop serve_recs: lists differ from "
                             "Recommender.from_run_dir's")
    log(f"matrix CLI: iknn gather of {len(payload['user_indices'])} users "
        f"x k {payload['k']}, metrics equal to run_test's; pop serve_recs "
        f"of {len(users)} users equal to from_run_dir's lists")


def matrix_quality(card: str) -> None:
    """The matrix algorithms' quality run at mid scale on the card
    (`trained_parity.run`): the exact fits' val ndcg@10 and recall@10
    within MATRIX_TOLERANCE of JAX's seed 0 (``trained_parity_jax.json``);
    als at seed 0 within 0.01 of JAX's and above the 0.03 floor (each
    side starts from one fixed draw whatever the seed, JAX's PRNGKey(0)
    and the port's generator seeded 0, so its seeds cannot differ; the
    two draws differ, so the fits land apart by more than the exact
    fits'); rand over seeds 0-4 against JAX's by the paired-seed delta
    (|delta_mean| <= max(0.01, delta_sem); random ranking sits under the
    floor on both sides)."""
    import numpy as np

    from sibrar_tpu_torch.tools import trained_parity as tp

    t0 = time.perf_counter()
    with open(tp.JAX_RUNS) as fh:
        jax_runs = json.load(fh)["families"]
    got = tp.run(tp.EXACT_MATRIX + ("als",), [0], "mid", DEVICE,
                 log=log)["families"]
    for name in tp.EXACT_MATRIX + ("als",):
        diffs = [abs(got[name][key]["0"] - jax_runs[name][key]["0"])
                 for key in ("runs", "recall")]
        tol = 0.01 if name == "als" else tp.MATRIX_TOLERANCE
        if max(diffs) > tol or (name == "als" and min(
                got[name]["runs"]["0"],
                jax_runs[name]["runs"]["0"]) <= QUALITY_FLOOR):
            raise AssertionError(f"quality: {name} ndcg@10 / recall@10 "
                                 f"{diffs} from JAX's")
        log(f"quality: {name} at mid scale, val ndcg@10 "
            f"{got[name]['runs']['0']:.6f} (JAX "
            f"{jax_runs[name]['runs']['0']:.6f}), recall@10 "
            f"{got[name]['recall']['0']:.6f} (JAX "
            f"{jax_runs[name]['recall']['0']:.6f}) on {card}")
    seeds = [0, 1, 2, 3, 4]
    got = tp.run(("rand",), seeds, "mid", DEVICE, log=log)["families"]
    d = np.asarray([got["rand"]["runs"][str(s)]
                    - jax_runs["rand"]["runs"][str(s)] for s in seeds])
    mean, sem = float(d.mean()), float(d.std(ddof=1) / np.sqrt(len(d)))
    if abs(mean) > max(0.01, sem):
        raise AssertionError(f"quality: rand delta {mean:+.6f} "
                             f"(sem {sem:.6f})")
    log(f"quality: rand seeds 0-4, port mean "
        f"{np.mean([got['rand']['runs'][str(s)] for s in seeds]):.6f}, JAX "
        f"{np.mean([jax_runs['rand']['runs'][str(s)] for s in seeds]):.6f}, "
        f"delta {mean:+.6f} (sem {sem:.6f}) on {card}")
    log(f"matrix quality: {time.perf_counter() - t0:.1f} s")


def quality_phase(card: str) -> None:
    """Seed 0 of each of QUALITY_FAMILIES of the trained-quality run at mid
    scale on the card (`tools.trained_parity`): each best validation
    ndcg@10 must exceed QUALITY_FLOOR and lie within QUALITY_SEED_NOISE of
    JAX's seed 0 (``tools/trained_parity_jax.json``)."""
    from sibrar_tpu_torch.tools import trained_parity

    t0 = time.perf_counter()
    got = trained_parity.run(QUALITY_FAMILIES, [0], "mid", DEVICE, log=log)
    with open(trained_parity.JAX_RUNS) as fh:
        jax_runs = json.load(fh)["families"]
    for family in QUALITY_FAMILIES:
        port = got["families"][family]["runs"]["0"]
        want = jax_runs[family]["runs"]["0"]
        if not (port > QUALITY_FLOOR
                and abs(port - want) <= QUALITY_SEED_NOISE):
            raise AssertionError(f"quality: {family} seed 0 ndcg@10 "
                                 f"{port:.6f}, JAX {want:.6f}")
        log(f"quality: {family} seed 0 at mid scale, best val ndcg@10 "
            f"{port:.6f} (JAX {want:.6f}, apart {port - want:+.6f}) in "
            f"{got['families'][family]['seconds']['0']} s on {card}")
    log(f"quality: {time.perf_counter() - t0:.1f} s")


# ----------------------------------------------------------------- the mesh
MESH_RANKS, MESH_ITEM = 4, 2  # data 2 x item 2 on the one card
MESH_STEPS = 20  # mesh train steps held to the same steps in one process
MESH_USERS = 1024  # users of the bit-equal dot check and the served lists
MESH_CLI_BATCHES = 20  # steps of the torchrun train_val_test
# per-step loss, mesh against one process: the first step starts from the
# same weights (the forward's sums in another order), then AdamW's
# sign-like first steps carry the gradients' rounding into the weights and
# the two runs drift apart (1.3e-3 to 1.8e-3 relative by step 20 on an
# H100). AdamW hardly sees a gradient's scale, so the loss cannot tell a
# sound step from a faulty one: the first step's gradients can
MESH_FIRST_RTOL, MESH_LOSS_RTOL = 1e-5, 5e-3
# the first step's averaged gradients against one process's,
# ||mesh - one|| / ||one|| over this rank's leaves (its rows of the sliced
# kernels), and over the sliced kernels alone. Batch norm's mean removal
# amplifies any rounding most in the item tower's first-layer kernel:
# one process's two sound first-layer paths (dense, INTERACTION_SPMM) are
# that far apart too, and the phase logs it as the floor. Each fault
# planted on the same step must read above its limit
MESH_GRAD_RTOL, MESH_SLICE_GRAD_RTOL = 1e-3, 5e-2
# validation of one model.pt on the mesh against one process: the towers'
# row-parallel sums round their representations otherwise, and JAX holds
# tensor-parallel runs to 2e-4
MESH_TP_ATOL = 2e-4
# the kernels each mesh call must launch on every rank, counted from 0
# just before the call and read just after it
MESH_WINDOWS = {
    "validate": ("segment_gather", "score_wmax", "gather_windows",
                 "peel_values", "recover_winners", "spmm_fwd", "exact_topk"),
    "dot": ("score_wmax", "gather_windows", "peel_values", "recover_winners",
            "exact_topk"),
    "train": ("segment_gather", "dw_matmul", "spmm_fwd", "spmm_bwd"),
    "serve": ("segment_gather", "score_wmax", "gather_windows",
              "peel_values", "recover_winners", "exact_topk"),
}


def torchrun(args: list, timeout: float, log_path: str) -> int:
    """``python -m torch.distributed.run --standalone --nproc-per-node
    MESH_RANKS`` with ``args``, its output in ``log_path`` (echoed after
    it ends); returns its exit code. torchrun stops its ranks itself."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(MESH_RANKS), *args]
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (here, os.environ.get("PYTHONPATH")) if p)}
    with open(log_path, "w") as fh:
        try:
            rc = subprocess.run(cmd, stdout=fh, stderr=subprocess.STDOUT,
                                timeout=timeout, cwd=here, env=env).returncode
        except subprocess.TimeoutExpired:
            rc = 124
    with open(log_path) as fh:
        for line in fh:
            log(f"  | {line.rstrip()}")
    return rc


def mesh_phase(data_dir: str, run_dir: str, root: str, splits,
               val_metrics: dict, kernels, count_path, card: str) -> None:
    """SBNet onion18 on a (data 2, item 2) mesh of four ranks sharing the
    card (gloo: NCCL refuses two ranks on one device), launched by torchrun
    on the CLI phase's artifacts and run directory (`mesh_rank`): the
    run's model.pt validated on the mesh (metrics within 1e-5 of one
    device's on the same representations and within MESH_TP_ATOL of the
    CLI's single-process validation; for MESH_USERS users the sharded dot
    chain's values, its flagged rows redone as the evaluator redoes them,
    bit-equal and ids equal to the unsharded one on the same
    representations), MESH_STEPS train steps on the mesh against the same
    steps in this process (the first step's gradients within
    MESH_GRAD_RTOL, the sliced kernels' within MESH_SLICE_GRAD_RTOL, and
    planted faults beyond them; its loss within MESH_FIRST_RTOL, every
    step's within MESH_LOSS_RTOL), and the test split served on the mesh
    against one device. Each of the four mesh calls counts its own launches, before
    any single-device reference runs, and must launch its kernels of
    MESH_WINDOWS on every rank. Then ``python -m
    sibrar_tpu_torch.run_experiment -t train_val_test`` under torchrun with
    ``parallel.enabled``: exit 0, and the four run files once."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    train = splits["train"]
    tdata = train.to_device(DEVICE)
    ref = sbnet_trainer(train, tdata, max_batches_per_epoch=MESH_STEPS)
    first, step = {}, ref.optimizer.step

    def keep_first_grads():  # the gradients the first step applies
        if not first:
            first.update({n: p.grad.detach().cpu()
                          for n, p in ref.model.named_parameters()
                          if p.grad is not None})
        step()

    ref.optimizer.step = keep_first_grads
    ref.train_epoch()
    ref_losses = ref.epoch_losses[:, 0].cpu().tolist()
    grads = os.path.join(root, "mesh_grads.pt")
    torch.save(first, grads)
    # the floor: the same first step in one process through the other
    # sound first-layer path, against the one above, leaf by leaf
    from sibrar_tpu_torch.models import layers

    alt = sbnet_trainer(train, tdata, max_batches_per_epoch=1)
    flag, layers.INTERACTION_SPMM = layers.INTERACTION_SPMM, True
    try:
        alt.optimizer.zero_grad()
        alt.forward_backward(torch.randperm(
            int(tdata.train_users.shape[0]), generator=alt.gen,
            device=alt.device)[:alt.batch_size])
    finally:
        layers.INTERACTION_SPMM = flag
    floor = {n: [float((p.grad.cpu() - first[n]).square().sum()),
                 float(first[n].square().sum())]
             for n, p in alt.model.named_parameters() if n in first}
    del ref, alt, tdata, first
    torch.cuda.empty_cache()
    args = os.path.join(root, "mesh_args.json")
    out_dir = os.path.join(root, "mesh_out")
    os.makedirs(out_dir)
    with open(args, "w") as fh:
        json.dump({"data_dir": data_dir, "run_dir": run_dir,
                   "out_dir": out_dir, "val_metrics": val_metrics,
                   "ref_losses": ref_losses, "grads": grads,
                   "grad_floor": floor,
                   "device": DEVICE,
                   "steps": MESH_STEPS, "users": MESH_USERS}, fh)
    t1 = time.perf_counter()
    rc = torchrun([os.path.abspath(__file__), "mesh-rank", args], 600,
                  os.path.join(root, "mesh_ranks.log"))
    wall = time.perf_counter() - t1
    if rc != 0:
        raise AssertionError(f"mesh ranks exited {rc}")
    results = []
    for r in range(MESH_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
            results.append(json.load(fh))
    for window, needed in MESH_WINDOWS.items():
        total = {name: 0 for name in read_counts(kernels)}
        for res in results:
            counts = res["launches"][window]
            missing = [n for n in needed if counts[n] == 0]
            if missing:
                raise AssertionError(f"rank {res['rank']}'s mesh {window} "
                                     f"did not launch {missing}")
            for n, c in counts.items():
                total[n] += c
        count_path(f"mesh {window} ({MESH_RANKS} ranks)", list(needed),
                   counts=total)
    r0 = results[0]
    log(f"mesh: {MESH_RANKS} ranks (data {MESH_RANKS // MESH_ITEM} x item "
        f"{MESH_ITEM}), backend {r0['backend']}, on {card}; torchrun "
        f"{wall:.1f} s; gloo on CUDA tensors: {r0['gloo_cuda']}")
    for res in results:
        log(f"mesh rank {res['rank']}: " + json.dumps(
            {k: res[k] for k in ("times", "peak_gib", "val_max_diff",
                                 "dot_rows", "train", "grad_gap",
                                 "serve")}))

    t1 = time.perf_counter()
    cli_dir = os.path.join(root, "mesh_run")
    rc = torchrun([
        "-m", "sibrar_tpu_torch.run_experiment", "-a", "sbnet", "-c",
        CONF_PATH, "-d", data_dir, "-n", "onion18", "-t", "train_val_test",
        "-o", f"results_path={cli_dir}", "-o", "dataset.user_features=[]",
        "-o", "dataset.item_features=[" + ", ".join(
            f"{{name: {n}, type: {t}}}" for n, t in CLI_FEATURES) + "]",
        "-o", "eval.group_metrics=[]", "-o", "learn.n_epochs=1",
        "-o", f"learn.max_batches_per_epoch={MESH_CLI_BATCHES}",
        "-o", "parallel.enabled=true",
        "-o", f"parallel.item_parallelism={MESH_ITEM}",
        "-o", f"run_settings.device={'tpu' if DEVICE == 'cuda' else 'cpu'}"],
        600,
        os.path.join(root, "mesh_cli.log"))
    files = sorted(os.listdir(cli_dir)) if os.path.isdir(cli_dir) else []
    if rc != 0 or files != ["conf.yml", "metrics_test.yml",
                            "metrics_val.yml", "model.pt"]:
        raise AssertionError(f"torchrun train_val_test: exit {rc}, files "
                             f"{files}")
    from sibrar_tpu_torch.config.loader import parse_conf_file

    test = parse_conf_file(os.path.join(cli_dir, "metrics_test.yml"))
    if not all(np.isfinite(v) for v in test.values()):
        raise AssertionError("torchrun train_val_test: metrics not finite")
    log(f"mesh CLI (torchrun, {MESH_RANKS} ranks, {MESH_CLI_BATCHES} steps, "
        f"validation and test on the mesh): {time.perf_counter() - t1:.1f} s "
        f"on {card}; test ndcg@10 {test['test/ndcg@10']:.6f}")
    log(f"mesh phase: {time.perf_counter() - t0:.1f} s")


def mesh_rank(args_path: str) -> int:
    """One rank of `mesh_phase` (``chip_smoke.py mesh-rank ARGS``, under
    torchrun): writes ``rank{r}.json`` with its checks, times and launch
    counts, and raises on a failed check."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sibrar_tpu_torch import full_f32
    from sibrar_tpu_torch.data.dataset import RecDataset
    from sibrar_tpu_torch.eval.evaluator import FullEvaluator, evaluate_model
    from sibrar_tpu_torch.experiment import _load_split, _run_conf
    from sibrar_tpu_torch.config.loader import load_split_type
    from sibrar_tpu_torch.models.sbnet import SingleBranchNet
    from sibrar_tpu_torch.ops import _cuda, dw, exact_topk, peel, sparse, spmm
    from sibrar_tpu_torch.ops import window
    from sibrar_tpu_torch.ops.window import pad_catalog
    from sibrar_tpu_torch.parallel import distributed as pdist
    from sibrar_tpu_torch.parallel.mesh import (
        batch_group,
        catalog_slice,
        make_mesh,
        shard_rows,
        sharded_masked_topk,
        sharded_masked_topk_dot,
    )
    from sibrar_tpu_torch.serve import Recommender
    from sibrar_tpu_torch.train.scoring import make_score_fn
    from sibrar_tpu_torch.train.trainer import Trainer

    with open(args_path) as fh:
        args = json.load(fh)
    if not pdist.initialize_distributed():
        raise RuntimeError("mesh-rank runs under torchrun")
    rank = dist.get_rank()
    dev = torch.device(args["device"])
    on_card = dev.type == "cuda"
    full_f32()
    if on_card:
        _cuda.build()  # loads what the parent built
    times = {}
    out = {"rank": rank, "backend": dist.get_backend(), "launches": {}}
    counted = {"segment_gather": sparse.segment_gather,
               "score_wmax": window.score_wmax,
               "gather_windows": peel.gather_windows,
               "peel_values": peel.peel_values,
               "recover_winners": peel.recover_winners,
               "dw_matmul": dw.dw_matmul,
               "spmm_fwd": spmm.spmm_fwd, "spmm_bwd": spmm.spmm_bwd,
               "exact_topk": exact_topk.exact_topk,
               "window_max": peel.window_max}

    # the port's collectives call gloo on CUDA tensors as they are: check
    # that it takes each of them here (every rank tries the same ones, so
    # a refusal is symmetric) and name the one it refuses
    gloo_cuda = {}
    if on_card and dist.get_backend() == "gloo":
        x = torch.ones(4, device=dev)
        for op, call in (
                ("all_reduce", lambda: dist.all_reduce(x.clone())),
                ("broadcast", lambda: dist.broadcast(x.clone(), 0)),
                ("all_gather", lambda: dist.all_gather(
                    [torch.empty_like(x) for _ in range(dist.get_world_size())],
                    x))):
            try:
                call()
                torch.cuda.synchronize()
                gloo_cuda[op] = "yes"
            except RuntimeError as e:
                gloo_cuda[op] = f"no ({str(e).splitlines()[0][:80]})"
    out["gloo_cuda"] = gloo_cuda
    if any(v != "yes" for v in gloo_cuda.values()):
        raise AssertionError(f"gloo refuses CUDA tensors: {gloo_cuda}")
    mesh = make_mesh(MESH_RANKS, item_parallelism=MESH_ITEM)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def phase(name, fn):
        sync()
        dist.barrier()
        t = time.perf_counter()
        res = fn()
        sync()
        times[name] = round(time.perf_counter() - t, 3)
        return res

    t = time.perf_counter()
    conf = _run_conf(args["run_dir"])
    split_type = load_split_type(conf.dataset.dataset_path)
    ds = {s: _load_split(conf, s, split_type) for s in ("train", "val",
                                                        "test")}
    dd = {s: d.to_device(dev) for s, d in ds.items()}
    times["load"] = round(time.perf_counter() - t, 3)

    def trainer(split: str, seed: int, **learn):
        model = SingleBranchNet.build_from_conf(conf.model, ds["train"],
                                                dd["train"], seed=seed)
        ev = FullEvaluator(conf.eval, ds[split], dd[split],
                           evaluator_name=split, mesh=mesh)
        learn_conf = copy.deepcopy(conf.learn)
        for k, v in learn.items():
            setattr(learn_conf, k, v)
        return Trainer(model, ds["train"], learn_conf, conf.dataset,
                       batch_size=conf.loader.batch_size, seed=seed,
                       device_data=dd["train"], val_evaluator=ev,
                       eval_batch_size=conf.loader.eval_batch_size,
                       mesh=mesh,
                       tower_min_rows=conf.parallel.tower_min_rows)

    def counted_call(name, fn):
        """``fn()`` with the launch counts set to 0 just before it and read
        into ``out["launches"][name]`` just after it."""
        for kernel in counted.values():
            kernel.launches = 0
        peel.gather_subwindows.launches = 0
        res = fn()
        out["launches"][name] = {n: kernel.launches
                                   for n, kernel in counted.items()}
        if peel.gather_subwindows.launches:
            raise AssertionError(f"mesh {name}: winner rows gathered "
                                 "through K3 (gather_subwindows)")
        return res

    if on_card:
        torch.cuda.reset_peak_memory_stats()

    # 1. validation of the CLI run's model.pt on the mesh
    val = trainer("val", conf.run_settings.seed)
    val.load(args["run_dir"])
    if not val._tp:
        raise AssertionError("no tower kernel was row-sliced")
    metrics = phase("validate", lambda: counted_call("validate",
                                                     val.validate))
    # the same representations (the mesh's) ranked on one device: every
    # rank runs all users through the single-device evaluator, its item
    # group computing the tensor-parallel user rows together
    score_fn = val.make_score_fn()
    items = score_fn.items  # this rank's catalog slice
    c = ds["val"].n_items_in_split
    lo, local_c = catalog_slice(c, mesh)
    whole = torch.cat(pdist.all_gather(items.contiguous(),
                                       mesh.item_group))[:c]

    def unsharded(u):
        return score_fn.dot_parts[0](u) @ whole.T

    unsharded.dot_parts = (score_fn.dot_parts[0], whole)
    same_reprs = phase("validate_unsharded", lambda: evaluate_model(
        unsharded, FullEvaluator(conf.eval, ds["val"], dd["val"],
                                 evaluator_name="val"),
        conf.loader.eval_batch_size))
    want = args["val_metrics"]
    for other in (same_reprs, want):
        if set(metrics) != set(other):
            raise AssertionError(f"mesh validation keys differ: "
                                 f"{sorted(set(metrics) ^ set(other))}")
    out["val_max_diff"] = {
        "same_representations": max(abs(metrics[k] - same_reprs[k])
                                    for k in want),
        "single_process": max(abs(metrics[k] - want[k]) for k in want)}
    if out["val_max_diff"]["same_representations"] > 1e-5:
        raise AssertionError(f"mesh validation differs from one device's "
                             f"on the same representations: "
                             f"{out['val_max_diff']}")
    if out["val_max_diff"]["single_process"] > MESH_TP_ATOL:
        raise AssertionError(f"mesh validation differs from the single-"
                             f"process one: {out['val_max_diff']}")
    # the sharded dot chain against the unsharded one on the same user and
    # item representations, every row: the rows the peel flags redone as
    # the evaluator redoes them (the per-shard scatter over K2's scores),
    # the unsharded chain redoing its own; values bit-equal, ids equal
    users = shard_rows(dd["val"].users_in_split[:args["users"]], mesh)
    u = score_fn.dot_parts[0](users)
    cols, mask = sparse.csr_row_gather(dd["val"].exclude_csr, users)
    k = max(conf.eval.top_k)
    items_p = pad_catalog(items)

    def sharded_dot():
        v, i, ok = sharded_masked_topk_dot(u, items_p, cols, mask, k, mesh,
                                           n_catalog=c, local_c=local_c)
        bad = (~ok).nonzero().squeeze(1)  # shared by the item group
        if bad.numel():
            s = window.score_wmax(u[bad], items_p)[0][:, :local_c]
            v[bad], i[bad] = sharded_masked_topk(s, cols[bad], mask[bad], k,
                                                 mesh, use_peel=False)
        return v, i, ok

    v, i, ok = counted_call("dot", sharded_dot)
    wv, wi, _ = peel.peel_masked_topk_dot(u, whole, cols, mask, k)
    if not (torch.equal(v, wv) and torch.equal(i, wi)):
        apart = ((v != wv) | (i != wi)).any(1)
        raise AssertionError(
            f"sharded dot chain differs from the unsharded one on the same "
            f"representations: {int((apart & ok).sum())} of "
            f"{int(ok.sum())} peel-exact rows and {int((apart & ~ok).sum())} "
            f"of {int((~ok).sum())} redone rows; values up to "
            f"{float((v - wv).abs().max())} apart")
    out["dot_rows"] = {"compared": int(users.shape[0]),
                       "peel_exact": int(ok.sum())}
    del score_fn, items, items_p, whole, val

    # 2. MESH_STEPS train steps against the same steps in one process; the
    # first step's averaged gradients against the ones one process applied,
    # and what four faults of the averaging would have given
    tr = trainer("val", 0, max_batches_per_epoch=args["steps"])
    ref_grads = torch.load(args["grads"], map_location=dev, weights_only=True)
    names = {id(p): n for n, p in tr.model.named_parameters()}
    sliced = tr._tp
    for n, (lo, hi, _) in sliced.items():
        ref_grads[n] = ref_grads[n][lo:hi]
    gaps, average = {}, tr._average_grads

    def floor(only) -> float:  # one process's two first-layer paths
        num, den = (sum(args["grad_floor"][n][j] for n in only)
                    for j in (0, 1))
        return (num / max(den, 1e-30)) ** 0.5

    def gap(grads: dict, only=None) -> float:
        """||grads - ref_grads|| / ||ref_grads|| over the leaves
        (``only`` of them)."""
        num = den = 0.0
        for n, g in grads.items():
            if only is None or n in only:
                w = ref_grads.get(n, torch.zeros_like(g))
                num += float((g - w).square().sum())
                den += float(w.square().sum())
        return (num / max(den, 1e-30)) ** 0.5

    def checked_average():
        if gaps:
            return average()
        params = tr.optimizer.params
        raw = {names[id(p)]: p.grad.clone() if p.grad is not None
               else torch.zeros_like(p) for p in params}
        average()
        got = {names[id(p)]: p.grad for p in params}
        n_batch = batch_group(mesh, tr._flat)[2]
        over_world = {n: pdist.all_reduce(raw[n].clone(),
                                          group=mesh.world_group)
                      / MESH_RANKS for n in sliced}
        worst = max(got, key=lambda n: float(
            (got[n] - ref_grads.get(n, torch.zeros_like(got[n]))).norm()))
        gaps.update({
            "whole": gap(got), "sliced": gap(got, sliced),
            "floor_whole": floor(args["grad_floor"]),
            "floor_sliced": floor(sliced),
            **{f"sliced {n}": gap(got, (n,)) for n in sliced},
            "worst_leaf": worst, "worst_leaf_gap": gap(got, (worst,)),
            "faults": {
                "not_averaged": gap(raw),
                "summed": gap({n: g * n_batch for n, g in got.items()}),
                "slices_not_averaged": gap(raw, sliced),
                "slices_over_world": gap(over_world)}})

    tr._average_grads = checked_average
    phase("train", lambda: counted_call("train", tr.train_epoch))
    out["grad_gap"] = gaps
    if not (gaps["whole"] <= MESH_GRAD_RTOL
            and gaps["sliced"] <= MESH_SLICE_GRAD_RTOL):
        raise AssertionError(f"mesh gradients differ from one process's: "
                             f"{gaps}")
    blind = [f for f, g in gaps["faults"].items() if not g > (
        MESH_SLICE_GRAD_RTOL if f.startswith("slices") else MESH_GRAD_RTOL)]
    if blind:
        raise AssertionError(f"the gradient gate does not see {blind}: "
                             f"{gaps}")
    del ref_grads
    got = tr.epoch_losses[:, 0].cpu().numpy()
    ref = np.asarray(args["ref_losses"])
    rel = float(np.max(np.abs(got - ref) / np.abs(ref)))
    out["train"] = {"steps": len(got), "max_rel_loss_diff": rel,
                    "ms_per_step": round(1e3 * times["train"] / len(got), 3),
                    "first": float(got[0]), "last": float(got[-1])}
    first = abs(got[0] - ref[0]) / abs(ref[0])
    out["train"]["first_rel_loss_diff"] = float(first)
    if (not np.isfinite(got).all() or rel > MESH_LOSS_RTOL
            or first > MESH_FIRST_RTOL):
        raise AssertionError(f"mesh train losses {got} against one "
                             f"process's {ref}")
    del tr

    # 4. the test split served on the mesh against one device
    model = SingleBranchNet.build_from_conf(conf.model, ds["train"],
                                            dd["train"], seed=0)
    model.load_state_dict(torch.load(os.path.join(args["run_dir"],
                                                  "model.pt"),
                                     map_location=dev, weights_only=True))
    one_fn = make_score_fn(model, dd["test"].catalog)
    serving = trainer("test", 0)
    serving.load(args["run_dir"])
    mesh_fn = serving.make_score_fn()
    rec_users = np.asarray(ds["test"].users_in_split)[:args["users"]]
    rec = Recommender(mesh_fn, ds["test"], dd["test"], k=k, batch_size=1024,
                      mesh=mesh)
    if on_card and not rec.use_dot:  # C = 100,352: the dot chain's
        raise AssertionError("the mesh Recommender took the scores path")
    ids, vals = phase("serve", lambda: counted_call(
        "serve", lambda: rec.recommend(rec_users, return_scores=True)))
    one = Recommender(one_fn, ds["test"], dd["test"], k=k, batch_size=1024)
    wids, wvals = one.recommend(rec_users, return_scores=True)
    catalog = np.asarray(ds["test"].items_in_split)
    inv = np.full(ds["test"].n_items, -1, np.int64)
    inv[catalog] = np.arange(len(catalog))
    pos = inv[ids]
    scores = one_fn(torch.as_tensor(rec_users, device=dev)).gather(
        1, torch.as_tensor(pos, device=dev)).cpu().numpy()
    # the mesh ranks with its own (tensor-parallel) representations: each
    # list must hold the single device's top-k up to the rounding of those
    # representations (ties within 1e-5 relative)
    tol = 1e-5 * np.abs(wvals).max()
    same = np.array_equal(ids, wids)
    if not same and not (np.abs(vals - wvals).max() <= tol
                         and np.abs(scores - wvals).max() <= tol):
        raise AssertionError("mesh lists differ from one device's beyond "
                             "ties")
    out["serve"] = {"users": len(rec_users), "ids_equal": bool(same),
                    "rows_differing": int((ids != wids).any(1).sum()),
                    "max_abs_value_diff": float(np.abs(vals - wvals).max())}
    out["peak_gib"] = (round(torch.cuda.max_memory_allocated() / 2**30, 3)
                       if on_card else None)
    out["times"] = times
    with open(os.path.join(args["out_dir"], f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    log(f"rank {rank}: launches {json.dumps(out['launches'])}")
    dist.barrier()
    dist.destroy_process_group()
    return 0


# ------------------------------------------------------- preprocessing
# The preprocess phase's raw data, in the layout `parse_onion` writes:
# listening events of PREP_USERS users over PREP_TRACKS tracks (a Zipf
# popularity tail), each drawn (user, track) pair repeated 1-6 times at
# timestamps across 2018, and onion18.yml's user features; item vectors at
# make_onion_scale_splits' widths and genre tags (onion18's jukebox and
# resnet are cut: two more vectors of the same kind)
PREP_USERS, PREP_TRACKS, PREP_PAIRS = 50_000, 200_000, 3_430_000
PREP_ITEM_VECTORS = (("ivec256", 256), ("bert", 384), ("musicnn", 128))
PREP_USER_VECTOR = ("acg_with_unknown_mpnet", 768)
PREP_SPLITS = (("random_split", ()),
               ("cold_start_item", ("-s", "coldstart",
                                    "--cold_start_type", "item")))
PREP_STEPS = 40  # SBNet steps on the card-made random split
PREP_CONF_PATH = os.path.join(os.path.dirname(os.path.dirname(CONF_PATH)),
                              "preprocessing", "onion18.yml")
# 2018-01-01 00:00:00 UTC and the seconds of the year
YEAR_2018, YEAR_SECONDS = 1_514_764_800, 365 * 86_400
# lax_topk past K13's row limit on the card: (rows, n, k) of the chunked
# path (k x 128 above MAX_N, where narrowing to windows once raised) and of
# the sort (k at or above MAX_N)
LONG_ROWS = ((4, 2_000_000, 12_000), (1, 2_000_000, 1_500_000))


def write_fixed_csv(path: str, header: str, columns) -> None:
    """Columns of non-negative integers below 2^32 whose values all have
    one digit count each, as CSV text: the bytes are cut from the digits in
    numpy (``to_csv`` takes ~20 s for the events), and pandas reads them
    back as these ints."""
    import numpy as np

    widths = [len(str(int(c[0]))) for c in columns]
    buf = np.empty((len(columns[0]), sum(widths) + len(widths)), np.uint8)
    pos = 0
    for j, (col, width) in enumerate(zip(columns, widths)):
        v = np.asarray(col, dtype=np.uint32)
        if (v < 10 ** (width - 1)).any() or (v >= 10 ** width).any():
            raise ValueError(f"column {j}: not all {width}-digit values")
        scale = 10 ** np.arange(width - 1, -1, -1, dtype=np.uint32)
        buf[:, pos:pos + width] = 48 + (v[:, None] // scale) % 10
        pos += width
        buf[:, pos] = ord("," if j < len(columns) - 1 else "\n")
        pos += 1
    with open(path, "wb") as fh:
        fh.write(header.encode() + b"\n")
        fh.write(buf.tobytes())


def write_onion_raw(path: str, seed: int = SEED) -> dict:
    """The raw dataset of the preprocess phase (see PREP_USERS): user ids
    100000 + u, track ids 1000000 + t, the events in time order. User
    activity is lognormal with sigma 0.5, so no user's history passes the
    512 exclusions where the peel stops being viable. Returns its
    counts."""
    import numpy as np
    import pandas as pd

    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    pop = (np.arange(PREP_TRACKS) + 50.0) ** -0.9
    activity = rng.lognormal(0.0, 0.5, PREP_USERS)
    users = rng.choice(PREP_USERS, PREP_PAIRS, p=activity / activity.sum())
    tracks = rng.choice(PREP_TRACKS, PREP_PAIRS, p=pop / pop.sum())
    reps = rng.integers(1, 7, PREP_PAIRS)
    order = rng.permutation(int(reps.sum()))
    users, tracks = np.repeat(users, reps)[order], np.repeat(tracks,
                                                              reps)[order]
    stamps = np.sort(YEAR_2018 + rng.integers(0, YEAR_SECONDS, len(users)))
    write_fixed_csv(os.path.join(path, "listening_history.csv"),
                    "user,item,timestamp",
                    [users + 100_000, tracks + 1_000_000, stamps])
    countries = np.array(["US", "DE", "BR", "GB", "PL", "RU", "FI", "NL",
                          "SE", "FR", "JP", "IT"])
    cw = 1.0 / np.arange(1, len(countries) + 1) ** 1.5
    age = rng.integers(15, 70, PREP_USERS).astype(float)
    age[rng.random(PREP_USERS) < 0.03] = 5.0
    age[rng.random(PREP_USERS) < 0.02] = np.nan
    gender = rng.choice(["m", "f", "n"], PREP_USERS, p=[0.55, 0.42, 0.03])
    pd.DataFrame({"user": np.arange(PREP_USERS) + 100_000,
                  "gender": gender, "age": age,
                  "country": rng.choice(countries, PREP_USERS,
                                        p=cw / cw.sum())}).to_csv(
        os.path.join(path, "user_features.csv"), index=False)
    tags = ["rock", "pop", "electronic", "hip-hop", "jazz", "metal", "folk",
            "classical", "indie", "punk"]
    combos = np.array(["|".join(rng.choice(tags, rng.integers(1, 4),
                                           replace=False))
                       for _ in range(400)], dtype=object)
    genres = combos[rng.integers(0, len(combos), PREP_TRACKS)]
    genres[rng.random(PREP_TRACKS) < 0.01] = None
    pd.DataFrame({"item": np.arange(PREP_TRACKS) + 1_000_000,
                  "genres": genres}).to_csv(
        os.path.join(path, "item_features.csv"), index=False)
    for name, width in PREP_ITEM_VECTORS:
        np.savez(os.path.join(path, f"item_{name}.npz"),
                 indices=np.arange(PREP_TRACKS) + 1_000_000,
                 values=rng.random((PREP_TRACKS, width), dtype=np.float32))
    name, width = PREP_USER_VECTOR
    np.savez(os.path.join(path, f"user_{name}.npz"),
             indices=np.arange(PREP_USERS) + 100_000,
             values=rng.random((PREP_USERS, width), dtype=np.float32))
    return {"events": len(users), "pairs drawn": PREP_PAIRS}


def prep_conf(path: str) -> str:
    """onion18.yml's split, interaction filters and user-feature steps,
    with the item features the raw data has."""
    import yaml

    with open(PREP_CONF_PATH) as fh:
        conf = yaml.safe_load(fh)
    conf["item_features"] = [
        *({"name": n, "type": "vector"} for n, _ in PREP_ITEM_VECTORS),
        next(f for f in conf["item_features"] if f["name"] == "genres")]
    with open(path, "w") as fh:
        yaml.safe_dump(conf, fh)
    return path


def same_artifacts(a: str, b: str) -> tuple:
    """Two artifact trees byte-equal file by file (the CLI's log aside):
    CSV and YAML files whole, each ``.npz`` member by member (the ``.npy``
    bytes; the zip headers carry the write time). Returns (files, bytes)."""
    import zipfile

    def names(root):
        return sorted(f for f in os.listdir(root) if not f.endswith(".log"))

    files = names(a)
    if files != names(b):
        raise AssertionError(f"artifact trees differ in their files: "
                             f"{sorted(set(files) ^ set(names(b)))}")
    n_bytes = 0
    for f in files:
        x, y = os.path.join(a, f), os.path.join(b, f)
        if f.endswith(".npz"):
            with zipfile.ZipFile(x) as zx, zipfile.ZipFile(y) as zy:
                members = zx.namelist()
                if members != zy.namelist():
                    raise AssertionError(f"{f}: members differ")
                for m in members:
                    bx, by = zx.read(m), zy.read(m)
                    if bx != by:
                        raise AssertionError(f"{f}/{m}: bytes differ")
                    n_bytes += len(bx)
        else:
            with open(x, "rb") as fx, open(y, "rb") as fy:
                bx = fx.read()
                if bx != fy.read():
                    raise AssertionError(f"{f}: bytes differ")
                n_bytes += len(bx)
    return files, n_bytes


def count_lines(path: str) -> int:
    with open(path, "rb") as fh:
        return sum(1 for _ in fh)


def preprocess_cli(raw: str, out: str, conf: str, split_args,
                   device: str) -> tuple:
    """``python -m sibrar_tpu_torch.preprocess_dataset`` run in this
    process (its ``main``); (wall seconds, the stage seconds it
    returns)."""
    import torch

    from sibrar_tpu_torch.preprocess_dataset import main as preprocess

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stages = preprocess(["-d", raw, "-o", out, "-c", conf, *split_args,
                         "--device", device])
    torch.cuda.synchronize()
    return time.perf_counter() - t0, stages


def preprocess_phase(kernels, count_path, card: str) -> None:
    """The port's preprocessing CLI (``python -m
    sibrar_tpu_torch.preprocess_dataset``, its ``main`` in this process)
    on the card and on the CPU path over ~12M listening events
    (`write_onion_raw`), for the random and the cold-start item split of
    onion18.yml (`prep_conf`): the two artifact trees byte-equal file by
    file, each stage's seconds logged; then SBNet
    at onion18's width trained PREP_STEPS steps on the card-made random
    split and validated on the dot path (K1-K4, K11) and the full path
    (K13), each path gated by its launches."""
    import tempfile

    import numpy as np
    import torch

    from sibrar_tpu_torch import config_from_dict
    from sibrar_tpu_torch.config.loader import load_split_type
    from sibrar_tpu_torch.config.schema import FeatureDefinition
    from sibrar_tpu_torch.data.dataset import RecDataset
    from sibrar_tpu_torch.eval.evaluator import FullEvaluator, evaluate_model
    from sibrar_tpu_torch.models.sbnet import SingleBranchNet
    from sibrar_tpu_torch.train.scoring import make_score_fn
    from sibrar_tpu_torch.train.trainer import (
        DatasetConfig,
        LearningConfig,
        Trainer,
    )

    root = tempfile.mkdtemp(prefix="sibrar_prep_")
    try:
        t0 = time.perf_counter()
        raw = os.path.join(root, "raw")
        counts = write_onion_raw(raw)
        size = sum(os.path.getsize(os.path.join(raw, f))
                   for f in os.listdir(raw))
        log(f"preprocess raw data: {counts['events']} events of "
            f"{counts['pairs drawn']} drawn pairs, {PREP_USERS} users x "
            f"{PREP_TRACKS} tracks, {size / 2**30:.3f} GiB written in "
            f"{time.perf_counter() - t0:.2f} s; item vectors "
            f"{dict(PREP_ITEM_VECTORS)} and genres (onion18.yml's jukebox "
            f"and resnet cut), user {PREP_USER_VECTOR}")
        conf = prep_conf(os.path.join(root, "onion18_prep.yml"))
        art = None
        for split_dir, split_args in PREP_SPLITS:
            trees = {}
            for side, device in (("card", DEVICE), ("cpu", "cpu")):
                out = os.path.join(root, f"{side}_{split_dir}")
                wall, stages = preprocess_cli(raw, out, conf, split_args,
                                              device)
                trees[side] = os.path.join(out, split_dir)
                log(f"preprocess {split_dir} on the {side} (--device "
                    f"{device}): {wall:.2f} s in all; stage seconds "
                    + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
                    + f"; {card}")
            files, n_bytes = same_artifacts(trees["card"], trees["cpu"])
            n_train, n_items, n_users = (
                count_lines(os.path.join(trees["card"], f)) - 1
                for f in ("listening_history_train.csv", "item_idxs.csv",
                          "user_idxs.csv"))
            log(f"preprocess {split_dir}: card and CPU trees byte-equal, "
                f"{len(files)} files, {n_bytes / 2**30:.3f} GiB; {n_users} "
                f"users x {n_items} items, {n_train} train pairs")
            shutil.rmtree(os.path.dirname(trees["cpu"]))
            if split_dir == "random_split":
                art = trees["card"]
            else:
                shutil.rmtree(os.path.dirname(trees["card"]))

        # SBNet on the card-made random split
        dev = torch.device(DEVICE)
        defs = [config_from_dict(FeatureDefinition, {"name": n, "type": t})
                for n, t in CLI_FEATURES]
        split_type = load_split_type(art)
        t0 = time.perf_counter()
        train, val = (RecDataset.load(art, s, item_feature_definitions=defs,
                                      split_type=split_type)
                      for s in ("train", "val"))
        tdata, vdata = train.to_device(dev), val.to_device(dev)
        log(f"preprocess: the card-made random split loaded in "
            f"{time.perf_counter() - t0:.2f} s: train {len(train.interactions)}"
            f" pairs, val {len(val.interactions)}, {train.n_users} users x "
            f"{train.n_items} items, val E = "
            f"{vdata.exclude_csr.max_row_len}")
        model = SingleBranchNet.build_from_conf(MODEL_CONF, train, tdata,
                                                seed=SEED)
        trainer = Trainer(model, train,
                          config_from_dict(LearningConfig, LEARN_CONF),
                          config_from_dict(DatasetConfig, DATASET_CONF),
                          batch_size=LOADER_CONF["batch_size"], seed=SEED,
                          device_data=tdata)
        reset_counts(kernels)
        run = train_window(trainer, PREP_STEPS)
        count_path("preprocessed train path", ["segment_gather",
                                               "dw_matmul", "spmm_fwd",
                                               "spmm_bwd"])
        if not np.isfinite(run["losses"]).all():
            raise AssertionError("SBNet losses on the preprocessed split "
                                 "are not finite")
        log(f"preprocess: SBNet {PREP_STEPS} steps on the card-made split, "
            f"host {run['host_ms']:.3f} ms/step, loss first "
            f"{run['losses'][0]:.5f} last {run['losses'][-1]:.5f}")
        score_fn = make_score_fn(model, vdata.catalog)
        for path, method, needed in (
                ("dot", "auto", ["segment_gather", "score_wmax",
                                 "gather_windows", "peel_values",
                                 "recover_winners"]),
                ("full", "full", ["segment_gather", "exact_topk"])):
            econf = eval_conf(topk_method=method)
            ev = FullEvaluator(econf, val, vdata, evaluator_name="val")
            fn = score_fn if path == "dot" else (lambda u: score_fn(u))
            reset_counts(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = evaluate_model(fn, ev, LOADER_CONF["eval_batch_size"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            count_path(f"preprocessed {path} validation", needed)
            check_metrics(f"preprocessed {path} validation", metrics, econf)
            log(f"preprocess: {path} validation of "
                f"{int(vdata.users_in_split.shape[0])} users in {wall:.3f} s,"
                f" ndcg@10 {metrics['val/ndcg@10']:.6f}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def check_long_rows(dev) -> None:
    """`ops.topk.lax_topk` on rows past K13's row limit, at a k where
    narrowing to 128-wide windows could not fit, where it once raised
    (LONG_ROWS: K13 over chunks, and the sort at k >= MAX_N): values and
    ids bit-equal to the plain version (the stable sort of the
    total-order keys over the whole row). Integer popularity
    values tie across the chunks; +-0.0, NaN of both signs and -inf are
    planted."""
    import numpy as np
    import torch

    from sibrar_tpu_torch.ops import exact_topk as xtopk
    from sibrar_tpu_torch.ops.topk import lax_topk

    rng = np.random.default_rng(SEED + 5)
    for r, n, k in LONG_ROWS:
        x = np.minimum(rng.zipf(1.5, (r, n)), 50).astype(np.float32)
        u = rng.random((r, n))
        x[u < 0.01] = 0.0
        x[(u >= 0.01) & (u < 0.02)] = -0.0
        x[(u >= 0.02) & (u < 0.0201)] = np.nan
        x[(u >= 0.0201) & (u < 0.0202)] = -np.inf
        x.view(np.int32)[(u >= 0.0202) & (u < 0.0203)] = -1  # NaN, sign set
        xd = torch.from_numpy(x).to(dev)
        before = xtopk.exact_topk.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, i = lax_topk(xd, k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = xtopk.exact_topk.launches - before
        pv, pi = xtopk.exact_topk_plain(xd, k)
        if not (torch.equal(i, pi) and torch.equal(v.view(torch.int32),
                                                   pv.view(torch.int32))):
            raise AssertionError(f"lax_topk past the row limit (R = {r}, "
                                 f"n = {n}, k = {k}) differs from plain")
        if dev.type == "cuda" and (launched == 0) != (k >= xtopk.MAX_N):
            # the chunks launch K13, the sort does not
            raise AssertionError(f"lax_topk at k = {k}: {launched} K13 "
                                 "launches")
        log(f"lax_topk past K13's limit: R = {r}, n = {n}, k = {k}: values "
            f"and ids bit-equal to plain; {launched} K13 launches, "
            f"{wall * 1e3:.1f} ms")


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
    check_long_rows(dev)
    users, rows = first_layer_rows(tdata, model, torch.Generator(
        device=dev).manual_seed(SEED + 2), train.n_items_in_split)
    measured.update(check_train_kernels(tower, rows, users, tdata, dev))
    user_bag_profile(model.user_module.net, users)
    check_one_slot(train.n_items, dev)
    launches = {name: 0 for name, _, _, _ in kernels}

    def count_path(path: str, needed: list, absent: tuple = (),
                   counts: dict | None = None) -> dict:
        """Gate and add the launches of a path: this process's counters,
        or ``counts`` other processes reported."""
        if counts is None:
            counts = read_counts(kernels)
            if peel.gather_subwindows.launches:
                raise AssertionError(f"the {path} gathered winner rows "
                                     "through K3 (gather_subwindows)")
        log(f"launches, {path}: {counts}")
        missing = [n for n in needed if counts[n] == 0]
        if missing:
            raise AssertionError(f"kernels not launched by the {path}: "
                                 f"{missing}")
        if ("peel_values" in needed
                and counts["recover_winners"] != counts["peel_values"]):
            raise AssertionError(f"the {path}'s selections did not each end "
                                 f"in one K11 launch: {counts}")
        stray = [n for n in absent if counts[n]]
        if stray:
            raise AssertionError(f"{path} launched {stray}")
        for name, n in counts.items():
            launches[name] += n
        return counts

    # -------------------------------------- training, default first layer
    # K6 / K7 against their plain versions on the inputs one default train
    # step gives them (the user tower's bag rows, the genres tag rows),
    # before the counted run
    with recorded_spmm({}) as calls:
        train_window(trainer, 1)
    check_recorded("default train step", calls,
                   ("InteractionTower", "TagEmbeddingBag"))
    del calls
    warm = train_window(trainer, TRAIN_WARMUP)
    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    run = train_window(trainer, TRAIN_STEPS)
    count_path("default train path", ["segment_gather", "dw_matmul",
                                      "spmm_fwd", "spmm_bwd"])
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

    # ----- repeatability, resume and bf16 moments, on fresh trainers
    determinism_phase(train, tdata, kernels, count_path)
    resume_phase(train, tdata)
    bf16_moments_phase(train, tdata)

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
                                "gather_windows", "peel_values",
                                "recover_winners"],
               ("score_windows", "gather_windows_rows", "fused_score_wmax"))  # K13 selects any row the peel redoes
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

    # ------------- the serving modes (bf16, int8, approx), same weights
    serving_modes(recs, score_fn, test, data, kernels, count_path,
                  users_all[start:], card)

    # ------------------ the ported tools/ probes, at their full width
    measured.update(probes_phase(kernels, count_path))

    # ---- preprocessing on the card and the CPU, SBNet on what it made
    t0 = time.perf_counter()
    preprocess_phase(kernels, count_path, card)
    log(f"preprocess phase: {time.perf_counter() - t0:.1f} s")

    # --------- the CLI, train_val_test from artifacts, at full width,
    # then MF with row-sparse tables on the same artifacts
    cli_phase(splits, kernels, count_path, card)

    # ------- DMF, ifeatmf, ufeatmf and DropoutNet at their onion18 widths
    zoo_phase(splits, {"train": tdata, "val": vdata, "test": data}, kernels,
              count_path, card)

    # ------------------ trained quality against JAX's committed seed 0
    quality_phase(card)

    # --- the matrix algorithms: iknn, pop, rand at onion scale, eight more
    # at ML-1M's shape, all eleven through the CLI, their quality
    t0 = time.perf_counter()
    matrix_phase(splits, {"val": vdata, "test": data}, kernels, count_path,
                 card)
    log(f"matrix: {time.perf_counter() - t0:.1f} s")

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
    if sys.argv[1:2] == ["mesh-rank"]:  # one rank of mesh_phase
        sys.exit(mesh_rank(sys.argv[2]))
    sys.exit(main())
