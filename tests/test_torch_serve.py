"""The port's serving modes against the JAX package's, on the CPU.

Each `Recommender` case runs both packages on one `make_synthetic_splits`
(40 users, 70 items, seed 13, as ``tests/test_serve.py``) and one numpy
dot scorer, at k = 10 and B = 16: int8 (``q`` and ``s`` bit-equal to JAX's
``quantize_rows_int8``, scores within rtol 1e-6, equal ids), bf16 (each
score within ``2 D 2^-24 (|u~| @ |i~|^T)`` of JAX's bf16 dot, ids equal up
to values that close to the k-th; the scores path at 70 items, the fused
dot path at 8,192), ``selection="approx"`` in f32 and int8 (JAX's ids, no
seen item), the no-``dot_parts`` warning, JAX's validation messages, the
mesh refusal and an empty request. Then `evaluate_model` under
``score_dtype: bfloat16`` on a transplanted toy SBNet against JAX's, and
run directories: the port's CLI fits MF, `Recommender.from_run_dir` and
``python -m sibrar_tpu_torch.serve_recs`` (CSV in process, JSONL in a
subprocess with jax, flax, optax, pandas and ``sibrar_tpu`` blocked) serve
it, and runs the port cannot serve raise naming their queue item."""
import json
import logging
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sibrar_tpu.data.synthetic import make_synthetic_splits as jax_splits
from sibrar_tpu.serve import Recommender as JaxRecommender
from sibrar_tpu.serve import _int8_scores as jax_int8_scores
from sibrar_tpu.serve import quantize_rows_int8 as jax_quantize
from sibrar_tpu_torch.data.synthetic import (
    make_synthetic_splits,
    write_reference_artifacts,
)
from sibrar_tpu_torch.eval.evaluator import FullEvaluator, evaluate_model
from sibrar_tpu_torch.parallel.mesh import make_mesh
from sibrar_tpu_torch.run_experiment import main as run_experiment
from sibrar_tpu_torch.serve import (
    Recommender,
    int8_scores,
    quantize_items_int8,
    quantize_rows_int8,
)
from sibrar_tpu_torch.serve_recs import main as serve_recs
from sibrar_tpu_torch.train.trainer import EvalConfig
from test_torch_evaluator import _assert_same, _jax_eval, slice_  # noqa: F401
from test_torch_sbnet_serve import ROOT

K, BS, D = 10, 16, 8
SPLIT = dict(n_users=40, n_items=70, n_interactions=900, seed=13)


def _splits(**kw):
    kw = {**SPLIT, **kw}
    return jax_splits(**kw)["val"], make_synthetic_splits(**kw)["val"]


def _scorers(n_users, n_items, seed=0):
    """The same numpy dot scorer in both packages (``tests/test_serve.py``'s
    draws)."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n_users, D)).astype(np.float32)
    items = rng.standard_normal((n_items, D)).astype(np.float32)
    ju, ji = jnp.asarray(u), jnp.asarray(items)
    tu, ti = torch.from_numpy(u), torch.from_numpy(items)

    def jax_score(idx):
        return ju[idx] @ ji.T

    def port_score(idx):
        return tu[idx.long()] @ ti.T

    jax_score.dot_parts = (lambda idx: ju[idx], ji)
    port_score.dot_parts = (lambda idx: tu[idx.long()], ti)
    return jax_score, port_score, u, items


def _both(jval, tval, users, **kw):
    """``(ids, scores)`` of JAX's and the port's Recommender on ``users``."""
    js, ts, _, _ = _scorers(tval.n_users, tval.n_items_in_split)
    jrec = JaxRecommender(js, jval, k=K, batch_size=BS, **kw)
    trec = Recommender(ts, tval, k=K, batch_size=BS, device="cpu", **kw)
    return (jrec.recommend(users, return_scores=True),
            trec.recommend(users, return_scores=True), trec)


def _no_seen(split, users, ids):
    excl = split.exclude_matrix().tocsr()
    assert not np.asarray(excl[np.repeat(users, ids.shape[1]),
                               ids.reshape(-1)]).any()


def test_int8_matches_jax():
    """``q`` and ``s`` bit-equal to JAX's (an all-zero row, a row with a
    rounding tie), and `int8_scores` to JAX's at a depth and catalog off
    the multiples of 8; the served scores within rtol 1e-6 of JAX's, equal
    ids."""
    x = np.random.default_rng(3).standard_normal((9, 33)).astype(
        np.float32) * 5.0
    x[4] = 0.0
    x[6, :2] = [127.0, 0.5]  # s = 1: 0.5 is a tie, to even (0)
    jq, js = (np.asarray(a) for a in jax_quantize(jnp.asarray(x)))
    tq, ts = (t.numpy() for t in quantize_rows_int8(torch.from_numpy(x)))
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(ts.view(np.int32), js.view(np.int32))
    assert tq[4].tolist() == [0] * 33 and tq[6, 1] == 0
    # the scores of JAX's int8 GEMM bit for bit, depth and catalog padded
    # to multiples of 8 here (x as 9 users, D = 33, C = 333)
    items = np.random.default_rng(4).standard_normal((333, 33)).astype(
        np.float32)
    want = np.asarray(jax_int8_scores(jnp.asarray(x),
                                      *jax_quantize(jnp.asarray(items))))
    got = int8_scores(torch.from_numpy(x), *quantize_items_int8(
        torch.from_numpy(items))).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))

    jval, tval = _splits()
    users = np.asarray(tval.users_in_split)[:25]  # pads 25 -> 32
    (jids, jv), (tids, tv), _ = _both(jval, tval, users, dtype="int8")
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tids, jids)
    _no_seen(tval, users, tids)


@pytest.mark.parametrize("n_items,dot", [(70, False), (8192, True)])
def test_bf16_matches_jax_within_bound(n_items, dot):
    """Each served score within ``2 D 2^-24 (|u~| @ |i~|^T)`` of JAX's bf16
    dot of the same pair (both within ``D 2^-24 (...)`` of the exact
    product); ids equal except where two values lie within that bound of
    the k-th. 70 items take the scores path (K15's scores), 8,192 the
    fused dot path (K15 + the peel)."""
    jval, tval = _splits(n_items=n_items)
    users = np.asarray(tval.users_in_split)[:25]
    (jids, jv), (tids, tv), trec = _both(jval, tval, users,
                                         dtype="bfloat16")
    assert trec.use_dot == dot
    _, _, u, items = _scorers(tval.n_users, n_items)
    ub = np.asarray(jnp.asarray(u[users]).astype(jnp.bfloat16), np.float64)
    ib = np.asarray(jnp.asarray(items).astype(jnp.bfloat16), np.float64)
    jscores = np.asarray(jax.lax.dot_general(
        jnp.asarray(u[users]).astype(jnp.bfloat16),
        jnp.asarray(items).astype(jnp.bfloat16), (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32))
    bound = 2 * D * 2.0 ** -24 * (np.abs(ub) @ np.abs(ib).T)
    position = {int(g): p for p, g in enumerate(tval.items_in_split)}
    pos = np.vectorize(position.get)(tids)
    got = np.take_along_axis(jscores, pos, 1)
    assert np.all(np.abs(tv - got) <= np.take_along_axis(bound, pos, 1))
    for r in range(len(users)):
        extra = sorted(set(tids[r].tolist()) ^ set(jids[r].tolist()))
        for item in extra:
            p = position[item]
            assert abs(jscores[r, p] - jv[r, -1]) <= 2 * bound[r, p]
    _no_seen(tval, users, tids)


@pytest.mark.parametrize("dtype", [None, "int8"])
def test_approx_selection_matches_jax(dtype):
    """``selection="approx"`` at recall_target 0.9: JAX's ids (its CPU
    ``approx_max_k`` is exact; the port's K13 is), no seen item."""
    jval, tval = _splits()
    users = np.asarray(tval.users_in_split)
    (jids, jv), (tids, tv), trec = _both(jval, tval, users, dtype=dtype,
                                         selection="approx",
                                         recall_target=0.9)
    assert not trec.use_dot and trec.redo_rows == []
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=0)
    _no_seen(tval, users, tids)


def test_dtype_without_dot_parts_warns_and_serves_its_precision(caplog):
    jval, tval = _splits()
    _, port_score, _, _ = _scorers(tval.n_users, tval.n_items_in_split)

    def score_fn(idx):  # no dot_parts attribute
        return port_score(idx)

    users = np.asarray(tval.users_in_split)[:20]
    with caplog.at_level(logging.WARNING, logger="sibrar_tpu_torch.serve"):
        rec = Recommender(score_fn, tval, k=K, batch_size=BS, device="cpu",
                          dtype="bfloat16")
    assert [m for m in caplog.messages if "dot_parts" in m] == [
        "dtype=bfloat16 requested but the score_fn exposes no dot_parts; "
        "serving stays in the score_fn's own precision"]
    plain = Recommender(score_fn, tval, k=K, batch_size=BS, device="cpu")
    ids, vals = rec.recommend(users, return_scores=True)
    want_ids, want_vals = plain.recommend(users, return_scores=True)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(vals, want_vals)


@pytest.mark.parametrize("kw", [dict(selection="fast"),
                                dict(recall_target=0.0),
                                dict(recall_target=1.5)],
                         ids=["selection", "recall_0", "recall_1.5"])
def test_validation_messages_match_jax(kw):
    jval, tval = _splits()
    js, ts, _, _ = _scorers(tval.n_users, tval.n_items_in_split)
    with pytest.raises(ValueError) as want:
        JaxRecommender(js, jval, **kw)
    with pytest.raises(ValueError) as got:
        Recommender(ts, tval, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_mesh_and_unknown_dtype_raise():
    _, tval = _splits()
    _, ts, _, _ = _scorers(tval.n_users, tval.n_items_in_split)
    # a one-rank mesh (one process) serves the lists of no mesh
    users = np.asarray(tval.users_in_split)
    np.testing.assert_array_equal(
        Recommender(ts, tval, device="cpu", mesh=make_mesh(1)).recommend(
            users),
        Recommender(ts, tval, device="cpu").recommend(users))
    with pytest.raises(ValueError, match="serving dtype 'float16'"):
        Recommender(ts, tval, device="cpu", dtype="float16")


@pytest.mark.parametrize("kw", [{}, dict(dtype="bfloat16"),
                                dict(dtype="int8"),
                                dict(selection="approx")],
                         ids=["f32", "bf16", "int8", "approx"])
def test_empty_request(kw):
    jval, tval = _splits()
    (jids, jv), (tids, tv), _ = _both(jval, tval, [], **kw)
    assert tids.shape == jids.shape == (0, K) and tids.dtype == jids.dtype
    assert tv.shape == jv.shape == (0, K) and tv.dtype == np.float32


def test_evaluate_model_bf16_matches_jax(slice_):  # noqa: F811
    """``score_dtype: bfloat16`` on the transplanted toy SBNet: JAX's metric
    dict (its Pallas dot path in interpret mode with bf16 operands), the
    same keys, every value within 1e-6; the port's dot path ranked K15's
    scores (its redo counts recorded), and the f32 metrics differ."""
    conf = dict(top_k=[1, 5, 10], score_dtype="bfloat16")
    want = _jax_eval(slice_, conf)
    ev = FullEvaluator(EvalConfig(**conf), slice_["tval"], slice_["tdata"],
                       evaluator_name="val")
    got = evaluate_model(slice_["score_fn"], ev, batch_size=64)
    assert ev.redo_rows  # the dot path ran
    _assert_same(got, want, atol=1e-6)
    f32 = evaluate_model(slice_["score_fn"], FullEvaluator(
        EvalConfig(top_k=[1, 5, 10]), slice_["tval"], slice_["tdata"],
        evaluator_name="val"), batch_size=64)
    assert f32 != got


# ------------------------------------------------------------ run dirs
MF_CONF = {
    "learn": {"n_epochs": 2, "lr": 0.005, "rec_loss": "bpr",
              "optimizing_metric": "ndcg@5"},
    "eval": {"top_k": [5], "metrics": ["ndcg"]},
    "loader": {"batch_size": 32, "eval_batch_size": 32},
    "dataset": {"n_negative_samples": 2},
    "model": {"embedding_dim": 8},
    "run_settings": {"device": "cpu"},
}


@pytest.fixture(scope="module")
def mf_run(tmp_path_factory):
    """An MF run fitted by the port's CLI (``-t train_val``) on the CPU."""
    root = tmp_path_factory.mktemp("mf_run")
    art, res = str(root / "data"), str(root / "run")
    write_reference_artifacts(art, make_synthetic_splits(
        n_users=30, n_items=40, n_interactions=600, seed=5))
    conf_path = str(root / "conf.yml")
    with open(conf_path, "w") as fh:
        yaml.safe_dump({**MF_CONF, "results_path": res}, fh)
    run_experiment(["-a", "mf", "-d", art, "-t", "train_val",
                    "-c", conf_path])
    return res


def test_from_run_dir_roundtrip(mf_run):
    """The reloaded run's lists are its own masked scores' top-5
    (``tests/test_serve.py``'s check)."""
    rec = Recommender.from_run_dir(mf_run, split="val", batch_size=16,
                                   device="cpu")
    assert rec.k == 5 and rec.device.type == "cpu"
    users = np.arange(10)
    ids = rec.recommend(users, k=5)
    assert ids.shape == (10, 5)
    scores = rec.score_fn(torch.as_tensor(users, dtype=torch.int32)).numpy()
    indptr = rec.data.exclude_csr.indptr.numpy()
    indices = rec.data.exclude_csr.indices.numpy()
    catalog = np.asarray(rec.dataset.items_in_split)
    for r, u in enumerate(users):
        row = scores[r].copy()
        row[indices[indptr[u]:indptr[u + 1]]] = -np.inf
        assert set(ids[r]) == set(catalog[np.argsort(-row,
                                                     kind="stable")[:5]])


@pytest.mark.parametrize("change,error,match", [
    ({"algorithm": "ease", "model": {"lam": 5.0}}, FileNotFoundError,
     "model.npz"),
    ({"parallel": {"enabled": True, "n_devices": 2}}, None, None)],
    ids=["matrix_algorithm", "parallel"])
def test_from_run_dir_refuses_unported_runs(mf_run, tmp_path, change, error,
                                            match):
    """A matrix algorithm is ported: its run directory is read for JAX's
    ``model.npz``, so one that holds only an MF run's ``model.pt`` is
    refused for the missing file. A ``parallel`` block now loads: in one
    process it asks for one device (no mesh, as in JAX), and the run
    serves its own lists."""
    with open(os.path.join(mf_run, "conf.yml")) as fh:
        conf = yaml.safe_load(fh)
    with open(tmp_path / "conf.yml", "w") as fh:
        yaml.safe_dump({**conf, **change}, fh)
    if error is None:
        shutil.copy(os.path.join(mf_run, "model.pt"), tmp_path)
        rec = Recommender.from_run_dir(str(tmp_path), split="val",
                                       device="cpu")
        assert rec.mesh is None
        want = Recommender.from_run_dir(mf_run, split="val", device="cpu")
        users = np.asarray(rec.dataset.users_in_split)
        np.testing.assert_array_equal(rec.recommend(users),
                                      want.recommend(users))
        return
    with pytest.raises(error, match=match):
        Recommender.from_run_dir(str(tmp_path), split="val", device="cpu")


BLOCKED_SERVE = r"""
import runpy, sys
for name in ("jax", "flax", "optax", "pandas", "sibrar_tpu"):
    sys.modules[name] = None  # any import of these now fails
sys.argv = ["serve_recs"] + ARGS
try:
    runpy.run_module("sibrar_tpu_torch.serve_recs", run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
loaded = [m for m in ("jax", "flax", "optax", "pandas", "sibrar_tpu")
          if sys.modules.get(m) is not None]
assert not loaded, loaded
print("serve ok")
"""


def test_serve_recs_csv_and_jsonl(mf_run, tmp_path):
    """CSV in process (``tests/test_serve.py``'s columns), then JSONL with
    scores from ``python -m sibrar_tpu_torch.serve_recs`` in a subprocess
    without jax: the lists and ``round(score, 6)`` of the in-process
    Recommender."""
    csv_out = str(tmp_path / "recs.csv")
    assert serve_recs(["-r", mf_run, "-s", "val", "-k", "5", "-u", "0,3,7",
                       "--scores", "-o", csv_out, "--device", "cpu"]) == 0
    lines = open(csv_out).read().strip().splitlines()
    assert lines[0].split(",") == (["user"] + [f"item_{j}" for j in range(5)]
                                   + [f"score_{j}" for j in range(5)])
    assert len(lines) == 4 and [r.split(",")[0] for r in lines[1:]] == [
        "0", "3", "7"]

    jsonl_out = str(tmp_path / "recs.jsonl")
    users_file = str(tmp_path / "users.txt")
    open(users_file, "w").write("1\n2\n")
    args = ["-r", mf_run, "-s", "val", "-k", "5", "-u", users_file,
            "--scores", "-o", jsonl_out, "--device", "cpu"]
    proc = subprocess.run(
        [sys.executable, "-c", f"ARGS = {args!r}\n" + BLOCKED_SERVE],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "serve ok" in proc.stdout
    rows = [json.loads(line) for line in open(jsonl_out)]
    rec = Recommender.from_run_dir(mf_run, split="val", k=5, device="cpu")
    ids, scores = rec.recommend([1, 2], return_scores=True)
    assert [r["user"] for r in rows] == [1, 2]
    assert [r["items"] for r in rows] == ids.tolist()
    assert [r["scores"] for r in rows] == [
        [round(float(s), 6) for s in row] for row in scores]
    for line, row_i, row_s in zip(lines[1:], *rec.recommend(
            [0, 3, 7], return_scores=True)):
        cells = line.split(",")
        assert cells[1:6] == [str(int(i)) for i in row_i]
        assert cells[6:] == [f"{float(s):.6g}" for s in row_s]
