"""Spawned ``torch.distributed`` worlds for the port's mesh tests.

`run_world` starts ``n`` ranks with ``torch.multiprocessing.spawn``; they
join one gloo group through a ``FileStore`` under the test's temporary
directory (no TCP port), run one job of this module, and rank 0's result
comes back pickled. The ranks import neither ``jax`` nor ``sibrar_tpu``:
this module imports torch and numpy only, and the inputs every job uses
are made here from numpy seeds (`selection_inputs`), so the JAX side of a
test builds the same arrays in the pytest process.
"""
from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch
import torch.multiprocessing as mp

NEG = -1e30
TIMEOUT_S = 240.0  # a deadlocked world fails the test instead of hanging


def run_world(n: int, job: str, payload, tmp: str, *,
              local_world: int | None = None) -> dict:
    """Rank 0's result of ``job(payload)`` on ``n`` spawned ranks
    (``LOCAL_WORLD_SIZE`` = ``local_world``, default ``n``: one node)."""
    os.makedirs(tmp, exist_ok=True)
    mp.spawn(_rank_main, args=(n, job, payload, tmp, local_world or n),
             nprocs=n)
    with open(os.path.join(tmp, "rank0.pkl"), "rb") as fh:
        return pickle.load(fh)


def _rank_main(r: int, n: int, job: str, payload, tmp: str,
               local_world: int) -> None:
    os.environ["LOCAL_WORLD_SIZE"] = str(local_world)
    os.environ["LOCAL_RANK"] = str(r % local_world)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    torch.set_num_threads(1)
    import torch.distributed as dist

    from sibrar_tpu_torch.parallel.distributed import initialize_distributed

    initialize_distributed(f"file://{os.path.join(tmp, 'store')}", n, r,
                           timeout_s=TIMEOUT_S)
    out = getattr(sys.modules[__name__], job)(payload)
    loaded = [m for m in ("jax", "sibrar_tpu") if m in sys.modules]
    if loaded:
        raise AssertionError(f"rank {r} imported {loaded}")
    if r == 0:
        with open(os.path.join(tmp, "rank0.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------------------ inputs
def selection_inputs() -> dict:
    """The numpy inputs of every selection case (JAX's test_parallel.py
    draws)."""
    out = {}
    rng = np.random.default_rng(0)
    out["topk"] = rng.normal(size=(6, 64)).astype(np.float32)
    rng = np.random.default_rng(1)
    out["topk_k_gt_shard"] = rng.normal(size=(4, 32)).astype(np.float32)
    rng = np.random.default_rng(7)
    b, c, e = 6, 512, 9
    scores = rng.normal(size=(b, c)).astype(np.float32)
    cols = np.stack([rng.choice(c, size=e, replace=False)
                     for _ in range(b)]).astype(np.int32)
    out["masked"] = (scores, cols, rng.random((b, e)) < 0.8)
    rng = np.random.default_rng(8)
    out["masked_k_gt_shard"] = rng.normal(size=(4, 128)).astype(np.float32)
    rng = np.random.default_rng(7)
    b, c, e = 21, 64, 5
    out["odd_batch"] = (rng.standard_normal((b, c)).astype(np.float32),
                        rng.integers(0, c, size=(b, e)).astype(np.int32),
                        rng.random((b, e)) < 0.8)
    rng = np.random.default_rng(11)
    b, c, d, e = 10, 5201, 16, 7
    out["dot"] = (rng.standard_normal((b, d)).astype(np.float32),
                  rng.standard_normal((c, d)).astype(np.float32),
                  np.sort(rng.integers(0, c, size=(b, e)), axis=1).astype(
                      np.int32),
                  rng.random((b, e)) < 0.8)
    rng = np.random.default_rng(123)
    fuzz = []
    for trial in range(6):
        b = int(rng.integers(2, 14))
        c = int(rng.integers(700, 3000))
        k = int(rng.integers(1, 30))
        e = int(rng.integers(1, 40))
        if c % 2:
            c += 1
        dist = trial % 3
        if dist == 0:
            s = rng.standard_normal((b, c))
        elif dist == 1:
            s = rng.integers(-4, 4, size=(b, c)).astype(float)
        else:
            s = rng.standard_normal((b, c))
            s[:, : c // 3] += 8.0
        s = s.astype(np.float32)
        cols = np.stack([np.sort(rng.choice(c, size=e, replace=False))
                         for _ in range(b)]).astype(np.int32)
        fuzz.append((s, cols, rng.random((b, e)) < 0.9, k))
    out["fuzz"] = fuzz
    rng = np.random.default_rng(11)
    b, c, e = 16, 1024, 7
    out["hier"] = (rng.normal(size=(b, c)).astype(np.float32),
                   rng.integers(0, c, (b, e)).astype(np.int32),
                   rng.random((b, e)) < 0.8)
    rng = np.random.default_rng(23)
    hf = []
    for groups, k, c in HIER_FUZZ:
        b, e = 8, 5
        hf.append((rng.normal(size=(b, c)).astype(np.float32),
                   rng.integers(0, c, (b, e)).astype(np.int32),
                   rng.random((b, e)) < 0.8))
    out["hier_fuzz"] = hf
    return out


HIER_GROUPS = ((0, 1, 2, 3), (4, 5, 6, 7))
HIER_FUZZ = [(((0, 1, 2, 3), (4, 5, 6, 7)), 20, 512),
             (((0, 1), (2, 3), (4, 5), (6, 7)), 9, 768),
             (((0, 1, 2, 3), (4, 5, 6, 7)), 130, 1024)]


# -------------------------------------------------------------- helpers
def _tile(x: np.ndarray, mesh, fill) -> torch.Tensor:
    """This rank's tile of a global [B, C] array."""
    from sibrar_tpu_torch.parallel.mesh import shard_catalog, shard_rows

    t = shard_rows(torch.from_numpy(np.ascontiguousarray(x)), mesh,
                   fill=fill)
    return shard_catalog(t, mesh, dim=1, fill=fill)


def _rows(x: np.ndarray, mesh, fill) -> torch.Tensor:
    from sibrar_tpu_torch.parallel.mesh import shard_rows

    return shard_rows(torch.from_numpy(np.ascontiguousarray(x)), mesh,
                      fill=fill)


def _global(outs, mesh, b: int) -> list:
    """Rank rows of each output back in batch order, as numpy."""
    from sibrar_tpu_torch.parallel.mesh import gather_rows

    return [gather_rows(o, mesh, b).numpy() for o in outs]


def _masked(mesh, s, cols, mask, k, **kw):
    from sibrar_tpu_torch.parallel.mesh import sharded_masked_topk

    out = sharded_masked_topk(_tile(s, mesh, NEG), _rows(cols, mesh, 0),
                              _rows(mask, mesh, False), k, mesh, **kw)
    return _global(out, mesh, s.shape[0])


# ------------------------------------------------------------------- jobs
def selections(_payload) -> dict:
    """Every sharded selection of JAX's test_parallel.py on this world's
    (4, 2) and (1, 8) meshes, with the same inputs."""
    from sibrar_tpu_torch.parallel.mesh import (
        make_mesh,
        shard_catalog,
        sharded_dot_viable,
        sharded_masked_topk_dot,
        sharded_topk,
    )

    x = selection_inputs()
    m8 = make_mesh(8)
    m1 = make_mesh(1)
    mi8 = make_mesh(8, item_parallelism=8)
    out = {"axes": (m8.shape, m1.shape, mi8.shape)}
    out["topk"] = _global(sharded_topk(_tile(x["topk"], m8, -np.inf), 5, m8),
                          m8, 6)
    out["topk_k_gt_shard"] = _global(sharded_topk(
        _tile(x["topk_k_gt_shard"], mi8, -np.inf), 6, mi8), mi8, 4)
    s, cols, mask = x["masked"]
    out["masked"] = {p: _masked(m8, s, cols, mask, 10, use_peel=p,
                                return_ok=True) for p in (False, True)}
    s = x["masked_k_gt_shard"]
    out["masked_k_gt_shard"] = _masked(mi8, s, np.zeros((4, 0), np.int32),
                                       np.zeros((4, 0), bool), 20)
    s, cols, mask = x["odd_batch"]
    out["odd_batch"] = _masked(m8, s, cols, mask, 6)
    u, items, cols, mask = x["dot"]
    c = items.shape[0]
    out["dot_viable"] = sharded_dot_viable(c, 9, 7, m8)
    it = shard_catalog(torch.from_numpy(items), m8)
    out["dot"] = _global(sharded_masked_topk_dot(
        _rows(u, m8, 0.0), it, _rows(cols, m8, 0), _rows(mask, m8, False),
        9, m8, n_catalog=c), m8, u.shape[0])
    out["fuzz"] = [{p: _masked(m8, s, cols, mask, k, use_peel=p,
                               return_ok=True) for p in (False, True)}
                   for s, cols, mask, k in x["fuzz"]]
    s, cols, mask = x["hier"]
    st = _tile(s, mi8, -np.inf)
    out["hier_topk"] = [_global(sharded_topk(st, 12, mi8, item_groups=g),
                                mi8, 16) for g in (None, HIER_GROUPS)]
    out["hier_masked"] = {p: [_masked(mi8, s, cols, mask, 12, use_peel=p,
                                      return_ok=True, item_groups=g)
                              for g in (None, HIER_GROUPS)]
                          for p in (False, True)}
    out["hier_fuzz"] = [
        [_masked(mi8, s, cols, mask, k, use_peel=False, return_ok=True,
                 item_groups=g) for g in (None, groups)]
        for (s, cols, mask), (groups, k, c) in zip(x["hier_fuzz"],
                                                   HIER_FUZZ)]
    return out


def two_nodes(_payload) -> dict:
    """A 4-rank world of 2 nodes x 2 ranks (LOCAL_WORLD_SIZE=2), the item
    axis across the node boundary: the automatic grouping is one group a
    node, and the two-stage merge equals the flat one bit for bit."""
    from sibrar_tpu_torch.parallel.mesh import (
        hierarchical_item_groups,
        make_mesh,
        sharded_topk,
    )

    x = selection_inputs()
    mesh = make_mesh(4, item_parallelism=4)
    s, cols, mask = x["hier"]
    out = {"groups": hierarchical_item_groups(mesh)}
    st = _tile(s, mesh, -np.inf)
    out["topk"] = [_global(sharded_topk(st, 12, mesh, item_groups=g), mesh,
                           16) for g in ("auto", None)]
    out["masked"] = [_masked(mesh, s, cols, mask, 12, use_peel=p,
                             return_ok=True, item_groups=g)
                     for p in (False, True) for g in ("auto", None)]
    return out


# ------------------------------------------------- training, eval, serving
def _np_state(state: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in state.items()}


def _full_state(trainer) -> dict:
    """The trainer's parameters and statistics, the sliced kernels whole
    (a collective)."""
    return _np_state(trainer._full(trainer.model.state_dict()))


def _evaluator(split, mesh, **conf):
    from sibrar_tpu_torch.eval.evaluator import FullEvaluator
    from sibrar_tpu_torch.train.trainer import EvalConfig

    return FullEvaluator(EvalConfig(**conf), split, device="cpu",
                         evaluator_name="val", mesh=mesh)


def _mf_trainer(splits, mesh, batch, learn, top_k=(5, 10)):
    from sibrar_tpu_torch.models.mf import SGDMatrixFactorization
    from sibrar_tpu_torch.train.trainer import DatasetConfig, Trainer

    train = splits["train"]
    model = SGDMatrixFactorization(train.n_users, train.n_items,
                                   torch.Generator().manual_seed(0),
                                   embedding_dim=8)
    return Trainer(model, train, learn, DatasetConfig(), batch_size=batch,
                   seed=0, device_data=train.to_device("cpu"), device="cpu",
                   val_evaluator=_evaluator(splits["val"], mesh,
                                            top_k=list(top_k)), mesh=mesh)


def _dmf_trainer(splits, mesh, batch, bag=False, **learn):
    from sibrar_tpu_torch.models.dmf import DeepMatrixFactorization
    from sibrar_tpu_torch.train.trainer import (
        DatasetConfig,
        LearningConfig,
        Trainer,
    )

    train = splits["train"]
    data = train.to_device("cpu")
    model = DeepMatrixFactorization.build_from_conf(
        {"u_mid_layers": [16], "i_mid_layers": [16], "final_dimension": 8},
        train, data, torch.Generator().manual_seed(0))
    if bag:  # JAX's test sets BAG_BREAK_EVEN_FACTOR = 0
        model.user_nn.bag_break_even_factor = 0
        model.item_nn.bag_break_even_factor = 0
    return Trainer(model, train, LearningConfig(
        n_epochs=1, rec_loss="bpr", optimizing_metric="ndcg@5", **learn),
        DatasetConfig(), batch_size=batch, seed=0, device_data=data,
        device="cpu", val_evaluator=_evaluator(splits["val"], mesh,
                                               top_k=[5]),
        mesh=mesh, tower_min_rows=48)


def _whole_tail_batch(n_inter: int, ranks: int) -> int:
    """A batch size dividing the mesh (8) whose epoch tail is a whole
    number of rows for each of ``ranks`` ranks, so the mesh epoch trains
    the pairs the single-device epoch trains."""
    for bs in (16, 24, 32, 40, 48, 56, 64):
        tail = n_inter % bs
        if tail and tail % ranks == 0:
            return bs
    raise AssertionError(f"no batch size fits {n_inter} pairs")


def _epoch_pair(make, splits, mesh):
    """The same epoch on the mesh and on one device: per-step losses,
    the state after it and the validation metrics after it."""
    out = {}
    for name, m in (("mesh", mesh), ("single", None)):
        t = make(splits, m)
        t.train_epoch()
        out[name] = {"losses": t.epoch_losses.numpy().copy(),
                     "state": _full_state(t),
                     "val": t.validate()}
        if m is not None:
            out["trainer"] = t
    return out


def train_eval(payload) -> dict:
    """Training, checkpoints, evaluation and serving of JAX's
    test_parallel.py on an (4, 2) mesh of 8 ranks, each beside the same
    run on one device (every rank runs both; rank 0 reports)."""
    import torch.distributed as dist

    from sibrar_tpu_torch.data.synthetic import make_synthetic_splits
    from sibrar_tpu_torch.eval import evaluator as evm
    from sibrar_tpu_torch.eval.evaluator import evaluate_model
    from sibrar_tpu_torch.parallel import distributed as pdist
    from sibrar_tpu_torch.parallel.mesh import make_mesh, shard_catalog, \
        shard_rows
    from sibrar_tpu_torch.serve import Recommender
    from sibrar_tpu_torch.train.scoring import make_score_fn
    from sibrar_tpu_torch.train.trainer import LearningConfig

    tmp = payload["tmp"]
    m8 = make_mesh(8)
    out = {}

    # batches that do not divide over the mesh
    small = make_synthetic_splits(n_users=30, n_items=40, n_interactions=400,
                                  seed=2)
    try:
        _mf_trainer(small, m8, 17, LearningConfig())
        out["divide"] = None
    except ValueError as e:
        out["divide"] = str(e)

    # MF, pure data parallelism over every rank (JAX's test_dp_training)
    mf = make_synthetic_splits(n_users=48, n_items=64, n_interactions=900,
                               seed=1)
    capped = LearningConfig(n_epochs=1, lr=1e-2, rec_loss="bpr",
                            max_batches_per_epoch=2)
    pair = _epoch_pair(lambda s, m: _mf_trainer(s, m, 64, capped), mf, m8)
    pair.pop("trainer")
    out["mf_dp"] = pair
    # a whole epoch with its tail batch (data whose tail splits evenly)
    bs, n = None, 900
    while bs is None:
        mf = make_synthetic_splits(n_users=48, n_items=64, n_interactions=n,
                                   seed=1)
        try:
            bs = _whole_tail_batch(int(mf["train"].interactions.shape[0]), 8)
        except AssertionError:
            n += 1
    pair = _epoch_pair(lambda s, m: _mf_trainer(
        s, m, bs, LearningConfig(n_epochs=1, lr=1e-2, rec_loss="bpr")),
        mf, m8)
    pair["batch"] = bs
    t = pair.pop("trainer")
    out["mf_epoch"] = pair

    # the mesh evaluator against one device, the same weights
    single = make_score_fn(t.model, t.val_evaluator.data.catalog)
    sharded = make_score_fn(t.model, t.val_evaluator.data.catalog, mesh=m8)
    chunked = make_score_fn(t.model, t.val_evaluator.data.catalog,
                            item_chunk=16, mesh=m8)
    out["mesh_eval"] = {
        "single": evaluate_model(single, _evaluator(mf["val"], None,
                                                    top_k=[5, 10]), 16),
        "mesh": evaluate_model(sharded, _evaluator(mf["val"], m8,
                                                   top_k=[5, 10]), 16),
        "chunked": evaluate_model(chunked, _evaluator(mf["val"], m8,
                                                      top_k=[5, 10]), 16)}

    # DMF, towers row-sliced over the item axis: dense and bag paths
    for bag in (False, True):
        bs, n = None, 900
        while bs is None:  # JAX's seeds: 3 dense, 5 bag
            data = make_synthetic_splits(
                n_users=48, n_items=64, n_interactions=n,
                seed=5 if bag else 3, with_features=False)
            try:
                bs = _whole_tail_batch(
                    int(data["train"].interactions.shape[0]), 4)
            except AssertionError:
                n += 1
        pair = _epoch_pair(lambda s, m: _dmf_trainer(s, m, bs, bag=bag),
                           data, m8)
        pair["batch"] = bs
        t = pair.pop("trainer")
        model = t.model
        pair["shapes"] = {
            "user_kernel": tuple(model.user_nn.kernel.shape),
            "item_kernel": tuple(model.item_nn.kernel.shape),
            "moments": sorted(tuple(st["mu"].shape) for st in
                              t.optimizer.state.values()),
            "tp": dict(t._tp), "flat": t._flat}
        pair["val_again"] = evaluate_model(t.make_score_fn(),
                                           t.val_evaluator, 16)
        out["dmf_bag" if bag else "dmf_dense"] = pair
        if not bag:
            dense_trainer, dmf, dmf_bs = t, data, bs

    # checkpoint and model.pt written on the mesh, read on one device
    t = dense_trainer
    ckpt = os.path.join(tmp, "ckpt")
    t.save_checkpoint(ckpt)
    t.save(ckpt)
    full = t.state_dict()
    one = _dmf_trainer(dmf, None, dmf_bs)
    one.load_checkpoint(ckpt)
    same = {k: torch.equal(v, full["model"][k])
            for k, v in one.model.state_dict().items()}
    moments = {}
    names = {p: n for n, p in one.model.named_parameters()}
    for p, st in one.optimizer.state.items():
        for key, v in st.items():
            moments[f"{names[p]}.{key}"] = torch.equal(
                v, full["optimizer"]["state"][names[p]][key])
    again = _dmf_trainer(dmf, m8, dmf_bs)
    again.load_checkpoint(ckpt)
    resumed = all(torch.equal(a, b) for a, b in zip(
        again.model.state_dict().values(), t.model.state_dict().values()))
    loss = again.train_epoch()["train/loss"]
    one.load(ckpt)
    out["checkpoint"] = {"model": same, "moments": moments,
                         "resumed_slices": resumed, "loss": loss,
                         "item_kernel": tuple(again.model.item_nn.kernel.shape),
                         "step": (one.step, t.step),
                         "model_pt": all(torch.equal(
                             v, full["model"][k]) for k, v in
                             one.model.state_dict().items())}

    # an explicit non-peel method forces the per-shard scatter
    seen = {}
    real = evm.sharded_masked_topk

    def spy(*a, **kw):
        seen["use_peel"] = kw.get("use_peel", "missing")
        return real(*a, **kw)

    evm.sharded_masked_topk = spy
    try:
        ev = _evaluator(dmf["val"], m8, top_k=[5], topk_method="full")
        rng = np.random.default_rng(0)
        scores = rng.normal(size=(16, ev.dataset.n_items_in_split)).astype(
            np.float32)
        ev.eval_batch(shard_rows(torch.arange(16, dtype=torch.int32), m8),
                      _tile(scores, m8, NEG))
    finally:
        evm.sharded_masked_topk = real
    out["explicit"] = (ev._peel_possible, seen.get("use_peel"))

    # the dot path on the mesh (C odd over 2 shards): one batch against
    # the scores path, then the whole evaluation against one device
    big = make_synthetic_splits(n_users=32, n_items=6001, n_interactions=700,
                                seed=9, with_features=False)
    val = big["val"]
    c = val.n_items_in_split
    rng = np.random.default_rng(3)
    u_mat = torch.from_numpy(rng.standard_normal((val.n_users, 8)).astype(
        np.float32))
    items = torch.from_numpy(rng.standard_normal((c, 8)).astype(np.float32))
    ev = _evaluator(val, m8, top_k=[5, 10])
    eb = ev.make_dot_eval_batch(lambda u: u_mat[u.long()], items)
    users = shard_rows(val.to_device("cpu").users_in_split[:16], m8)
    got = None if eb is None else eb(users)
    ref = ev._eval_batch(shard_catalog(u_mat[users.long()] @ items.T, m8,
                                       dim=1, fill=NEG), users)
    diff = torch.zeros(())
    if got is not None:
        for k in ref[0]:
            diff = torch.maximum(diff, (got[0][k] - ref[0][k]).abs().max())
        for k in ref[1]:
            diff = torch.maximum(diff, (got[1][k] != ref[1][k]).float().max())
    pdist.all_reduce(diff, "max")
    out["dot_batch"] = {"engaged": eb is not None, "max_diff": float(diff)}

    rng = np.random.default_rng(5)
    u_mat = torch.from_numpy(rng.standard_normal((val.n_users, 8)).astype(
        np.float32))
    items = torch.from_numpy(rng.standard_normal((c, 8)).astype(np.float32))

    def score_fn(u):
        return u_mat[u.long()] @ items.T

    score_fn.dot_parts = (lambda u: u_mat[u.long()], items)
    ev = _evaluator(val, m8, top_k=[5, 10])
    out["dot_eval"] = {
        "mesh": evaluate_model(score_fn, ev, 16),
        "single": evaluate_model(score_fn, _evaluator(val, None,
                                                      top_k=[5, 10]), 16),
        "redo": sum(ev.redo_rows)}

    # every top-100 winner inside one 128-wide window of shard 0: that
    # shard's peel cannot cover them, the rows are flagged and redone
    adv = make_synthetic_splits(n_users=32, n_items=65536,
                                n_interactions=2000, seed=11,
                                with_features=False)["val"]
    rng = np.random.default_rng(4)
    a_users = torch.from_numpy(np.abs(rng.standard_normal(
        (adv.n_users, 8))).astype(np.float32))
    a_items = np.zeros((adv.n_items_in_split, 8), np.float32)
    a_items[256:384] = np.abs(rng.standard_normal((128, 8))) + 5.0
    a_items = torch.from_numpy(a_items)

    def adv_fn(u):
        return a_users[u.long()] @ a_items.T

    adv_fn.dot_parts = (lambda u: a_users[u.long()], a_items)
    ev = _evaluator(adv, m8, top_k=[100])
    got = evaluate_model(adv_fn, ev, 16)
    flagged = pdist.all_reduce(torch.tensor(sum(ev.redo_rows)))
    out["redo"] = {"mesh": got, "flagged": int(flagged),
                   "single": evaluate_model(
                       lambda u: adv_fn(u), _evaluator(adv, None,
                                                       top_k=[100]), 16)}

    # serving on the mesh: dot (f32, bf16), int8, a scorer without dot
    # parts, approx (served exact); every rank gets every list
    rec_users = np.asarray(val.users_in_split)
    plain = lambda u: score_fn(u)  # noqa: E731
    serve = {}
    for label, fn, kw in (("f32", score_fn, {}),
                          ("bf16", score_fn, dict(dtype="bfloat16")),
                          ("int8", score_fn, dict(dtype="int8")),
                          ("scores", plain, {}),
                          ("approx", score_fn, dict(selection="approx"))):
        got = Recommender(fn, val, device="cpu", k=10, batch_size=16,
                          mesh=m8, **kw)
        want = Recommender(fn, val, device="cpu", k=10, batch_size=16, **kw)
        serve[label] = {"mesh": got.recommend(rec_users, return_scores=True),
                        "single": want.recommend(rec_users,
                                                 return_scores=True),
                        "use_dot": got.use_dot}
        lists = [torch.from_numpy(serve[label]["mesh"][0].astype(np.int64))]
        every = pdist.all_gather(lists[0])
        serve[label]["same_on_ranks"] = all(torch.equal(e, every[0])
                                            for e in every)
    out["serve"] = serve

    # SBNet at narrow widths: data parallel over the data axis, both
    # interaction towers row-sliced over the item axis
    splits = _sbnet_splits(payload)
    step = {}
    for name, mesh in (("mesh", m8), ("single", None)):
        t = _sbnet_trainer(payload)(splits, mesh)
        step[name] = _one_step(t)
        if mesh is not None:
            step["tp"] = dict(t._tp)
    out["sbnet"] = step
    dist.barrier()
    return out


def _one_step(t) -> dict:
    """One train step of the epoch's first batch: its losses, the
    (averaged) gradients before the optimizer and the state after it, the
    sliced kernels whole."""
    from sibrar_tpu_torch.parallel.mesh import full_rows

    n_inter = int(t.data.train_users.shape[0])
    idxs = torch.randperm(n_inter, generator=t.gen)[:t.batch_size]
    t.optimizer.zero_grad()
    loss = t.forward_backward(idxs)
    if t.mesh is not None:  # the regularizers' rank means, averaged
        from sibrar_tpu_torch.parallel import distributed as pdist
        from sibrar_tpu_torch.parallel.mesh import batch_group

        t._average_grads()
        group, _, n = batch_group(t.mesh, t._flat)
        loss = pdist.all_reduce(loss, group=group) / n
    grads = {}
    for n, p in t.model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        grads[n] = (full_rows(g, t.mesh) if n in t._tp else g).numpy().copy()
    t.optimizer.step()
    return {"loss": loss.numpy().copy(), "grads": grads,
            "state": _full_state(t)}


def _sbnet_splits(payload):
    from sibrar_tpu_torch.data.dataset import make_splits
    from sibrar_tpu_torch.data.synthetic import make_onion_scale_splits

    return make_splits(make_onion_scale_splits(
        n_users=120, n_items=300, n_interactions=3000, n_clusters=8, seed=7,
        feature_dims=payload["features"]))


def _sbnet_trainer(payload):
    def make(splits, mesh):
        from sibrar_tpu_torch.models.sbnet import SingleBranchNet
        from sibrar_tpu_torch.train.trainer import (
            DatasetConfig,
            LearningConfig,
            Trainer,
        )

        train = splits["train"]
        data = train.to_device("cpu")
        model = SingleBranchNet.build_from_conf(payload["sbnet_conf"], train,
                                                data, seed=1)
        learn = LearningConfig(optimizer="adamw", lr=1e-3, wd=1e-3,
                               rec_loss="bpr", optimizing_metric="ndcg@10")
        return Trainer(model, train, learn,
                       DatasetConfig(n_negative_samples=4), batch_size=32,
                       seed=0, device_data=data, device="cpu",
                       val_evaluator=_evaluator(splits["val"], mesh,
                                                top_k=[10]),
                       mesh=mesh, tower_min_rows=64)
    return make


def cli(payload) -> dict:
    """``run_experiment.main`` (``-t train_val_test``) on every rank, each
    in a working directory of its own."""
    import torch.distributed as dist

    from sibrar_tpu_torch.run_experiment import main

    r = dist.get_rank()
    cwd = os.path.join(payload["tmp"], f"cwd{r}")
    os.makedirs(cwd)
    os.chdir(cwd)
    val, test = main(payload["argv"])
    return {"val": val, "test": test}
