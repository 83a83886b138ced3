"""The port's ECF against the JAX package, on the CPU: the log-IDF tag
matrix bit-equal; the hard top-k masks bit-equal to ``lax.top_k``'s,
on tied rows too; the model with the same (numpy-drawn) weights in both
packages (train forward, the three losses by name, every gradient,
catalog scores and dot parts; rtol 1e-5, atol 1e-6), also with a user of
no train interaction (every cluster ties) and an anchor whose
self-cosine is exactly 1.0 (``jnp.clip``'s half gradient); the registry,
and the CLI with serving from its run directory."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sibrar_tpu.models import ecf as jecf
from sibrar_tpu_torch.models import ecf as tecf
from sibrar_tpu_torch.ops.sparse import DeviceCSR
from test_torch_dmf import (
    _both_splits,
    check_catalog,
    check_registry,
    check_served,
    check_train_forward,
    inputs,
    models,
    one_torch_thread,  # noqa: F401 (autouse fixture)
)
from test_torch_protomf import check_losses, cli_train_val

CONFS = {
    "default": {"embedding_dim": 6, "n_clusters": 5, "top_n": 2, "top_m": 3,
                "top_p": 2, "tag_feature": "genres"},
    "weighted": {"embedding_dim": 6, "n_clusters": 7, "top_n": 3,
                 "top_m": 2, "top_p": 3, "temp_masking": 0.7,
                 "temp_tags": 1.5, "lam_cf": 0.3, "lam_ind": 2.0,
                 "lam_ts": 0.5, "tag_feature": "genres"},
}


def ecf_models(variant):
    """`models` for ECF with JAX's real tag matrix in its ``tables``
    (the structure-only init leaves it zero)."""
    jm, variables, tm = models("ecf", CONFS[variant])
    js, _ = _both_splits()
    tags = jecf.ecf_tag_matrix_from_feature(
        js["train"].item_features["genres"], js["train"].n_items)
    variables["tables"] = {**variables["tables"],
                           "tag_matrix": jnp.asarray(tags)}
    return jm, variables, tm


def test_tag_matrix_is_jax_bit_for_bit():
    js, ts = _both_splits()
    want = jecf.ecf_tag_matrix_from_feature(
        js["train"].item_features["genres"], js["train"].n_items)
    got = tecf.ecf_tag_matrix_from_feature(
        ts["train"].item_features["genres"], ts["train"].n_items)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (got > 0).any() and (got == 0).any()


@pytest.mark.parametrize("k", [1, 3, 8])
def test_hard_masks_are_lax_top_k_bit_for_bit(k):
    """Random rows, an all-zero row (an empty train row's affiliations),
    copies of the k-th value across the cut, -0.0 beside +0.0 and a
    constant row: the 0/1 masks equal JAX's."""
    rng = np.random.default_rng(k)
    x = rng.normal(size=(7, 8)).astype(np.float32)
    x[1] = 0.0
    x[2] = [5, 1, 3, 3, 3, 3, 0, 3]  # the k-th value repeats
    x[3, :4] = [0.0, -0.0, 0.0, -0.0]
    x[4] = 0.25
    x[5] = np.round(x[5])
    want = np.asarray(jecf._straight_through_topk_mask(jnp.asarray(x), k))
    got = tecf.hard_topk_mask(torch.as_tensor(x), k).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got.sum(1) == k).all()
    got3 = tecf.hard_topk_mask(torch.as_tensor(x).reshape(7, 2, 4), 2)
    want3 = jecf._straight_through_topk_mask(
        jnp.asarray(x).reshape(7, 2, 4), 2)
    np.testing.assert_array_equal(got3.numpy(), np.asarray(want3))


def _empty_row(variables, tm, user):
    """Drop ``user``'s train row from both packages' interaction CSR."""
    inter = variables["tables"]["interactions"]
    indptr = np.asarray(inter["user__inter_indptr"])
    indices = np.asarray(inter["user__inter_indices"])
    lo, hi = indptr[user], indptr[user + 1]
    new_indices = np.concatenate([indices[:lo], indices[hi:]])
    new_indptr = indptr.copy()
    new_indptr[user + 1:] -= hi - lo
    variables["tables"]["interactions"] = {
        "user__inter_indptr": jnp.asarray(new_indptr),
        "user__inter_indices": jnp.asarray(new_indices)}
    csr = tm.interactions.csr
    tm.interactions.csr = DeviceCSR(
        torch.as_tensor(new_indptr), torch.as_tensor(new_indices),
        csr.n_rows, csr.n_cols, int(np.diff(new_indptr).max()))


@pytest.mark.parametrize("case", ["default", "weighted", "ties"])
def test_ecf_train_forward_losses_and_grads_match_flax(case):
    """``ties``: the first input user has no train interaction (its 64
    affiliation logits are all 0: the mask is the first ``top_n``
    clusters in both) and anchor 0 is a unit vector and anchor 2 twice
    it, so their self-cosines and their cosine are exactly 1.0, at the
    clip's bound. A cosine's gradient vanishes at +-1, so the clip's half
    gradient there (`test_torch_protomf.py` holds it) leaves the model's
    gradients within rounding of either rule; the case holds the path."""
    jm, variables, tm = ecf_models("default" if case == "ties" else case)
    users, items = inputs()
    if case == "ties":
        _empty_row(variables, tm, int(users[0]))
        clusters = np.array(variables["params"]["clusters"])
        clusters[0] = 0.0
        clusters[0, 1] = 1.0
        clusters[2] = 2.0 * clusters[0]  # parallel: cosine exactly 1.0 too
        variables["params"] = {**variables["params"],
                               "clusters": jnp.asarray(clusters)}
        with torch.no_grad():
            tm.clusters.copy_(torch.as_tensor(clusters))
        a_tilde = tm.interactions(torch.as_tensor(users[:1])) @ \
            tm._x_tildes()
        assert not a_tilde.any()
        sim = tecf.cosine_sim(tm.clusters, tm.clusters)
        assert sim[0, 0].item() == sim[0, 2].item() == 1.0
    reg, grads = check_train_forward(jm, variables, tm)
    losses = check_losses(jm, variables, tm, users, items)
    assert set(losses) == {"ts_loss", "ind_loss", "cf_loss"}
    assert reg > 0 and all(g.any() for g in grads)


@pytest.mark.parametrize("variant", sorted(CONFS))
def test_ecf_catalog_scores_and_dot_parts_match_flax(variant):
    jm, variables, tm = ecf_models(variant)
    scores, dots = check_catalog(jm, variables, tm)
    np.testing.assert_allclose(scores.numpy(), dots.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert (scores == 0).any() and (scores > 0).any()  # masked clusters


def test_registry_builds_ecf_on_the_data_device():
    conf = {**CONFS["weighted"], "embedding_dim": 8}
    model = check_registry("ecf", conf, tecf.ECF)
    assert (model.top_n, model.top_m, model.top_p) == (3, 2, 3)
    assert model.lam_ind == 2.0 and model.temp_masking == 0.7
    assert model.clusters.shape == (7, 8)
    assert model.user_embedding.shape[1] == 8
    assert model.tag_matrix.device.type == "cpu"
    assert "tag_matrix" not in model.state_dict()  # rebuilt from the data
    assert model.interactions.csr.n_cols == model.item_embedding.shape[0]


def test_cli_train_val_and_serving_run_ecf(tmp_path):
    run, extra = cli_train_val(
        tmp_path, "ecf", CONFS["default"],
        item_features=[{"name": "genres", "type": "tag"}])
    assert extra == {}
    check_served(run)


def test_chip_smoke_zoo_confs_match_yaml_and_quality_files():
    """The zoo's ECF block is conf/ecf.yml's by both loaders, the ProtoMF
    variants take conf/base.yml's empty block (the builds' defaults); the
    port's quality hyperparameters are those of JAX's runs on file (mid
    scale, and ECF's toy-scale file)."""
    import json
    import os

    from sibrar_tpu.config.loader import get_config as jax_get_config
    from sibrar_tpu_torch.config.loader import get_config
    from sibrar_tpu_torch.tools import trained_parity
    from test_torch_sbnet_serve import _chip_smoke

    cs = _chip_smoke()
    for name in (*cs.PROTOMF, "ecf"):
        path = cs.zoo_conf_path(name)
        resolved = get_config(path, algorithm=name).model
        assert cs.ZOO_MODELS[name] == resolved
        assert jax_get_config(path, algorithm=name).model == resolved
    assert os.path.basename(cs.zoo_conf_path("ecf")) == "ecf.yml"
    assert cs.ZOO_REPEAT == ("uprotomf", "ecf")
    # the toy gate's paired seeds are 0-19, the mid file's 0-4
    for path, scale, families, n_seeds in (
            (trained_parity.JAX_RUNS, "mid", ("uprotomf", "ecf"), 5),
            (trained_parity.JAX_TOY_RUNS, "toy", ("ecf",), 20)):
        with open(path) as fh:
            runs = json.load(fh)
        assert runs["scale"] == scale
        for family in families:
            assert (runs["families"][family]["hparams"]
                    == trained_parity.hparams_for(family, scale))
            assert (sorted(runs["families"][family]["runs"], key=int)
                    == [str(seed) for seed in range(n_seeds)])


def test_replay_of_the_trainers_own_draws_repeats_its_training(tmp_path):
    """`trained_parity.replay_port_ecf` fed a record of the port's own ECF
    training (initial weights, every step's users and items, the first
    steps' and each epoch's weights, the validation) repeats it bit for
    bit: what a replay of JAX's
    record leaves between the packages is their arithmetic."""
    from sibrar_tpu_torch.tools import trained_parity as tp
    from sibrar_tpu_torch.train.trainer import Trainer

    d = tp.make_artifacts(str(tmp_path), n_users=30, n_items=40,
                          n_interactions=400)
    h = dict(tp.hparams_for("ecf", "toy"), epochs=2, embedding_dim=4,
             n_clusters=5, top_n=3, top_m=2, top_p=2, batch_size=32)
    model, tr, va, dd = tp._port_ecf(d, 3, h, "cpu")
    rec = {f"init/{n}": p.detach().numpy().copy()
           for n, p in model.named_parameters()}
    drawn, val = [], []

    class Recording(Trainer):
        def draw_batch(self, idxs):
            u, i_global = super().draw_batch(idxs)
            drawn.append((u, i_global))
            return u, i_global

        def train_step(self, idxs):
            out = super().train_step(idxs)
            if self.step <= 3:  # the steps the replay holds one by one
                rec.update({f"step{self.step - 1}/{n}":
                            p.detach().numpy().copy()
                            for n, p in model.named_parameters()})
            return out

    def log(record):
        val.append(record["val/ndcg@10"])
        if record["epoch"] >= 0:
            rec.update({f"epoch{record['epoch']}/{n}": p.detach().numpy().copy()
                        for n, p in model.named_parameters()})

    best = tp._fit(model, tr, va, dd, h, 3, "cpu", trainer_cls=Recording,
                   log_fn=log)
    rec.update(users=torch.cat([u for u, _ in drawn]).numpy(),
               items=torch.cat([i for _, i in drawn]).numpy(),
               sizes=np.asarray([len(u) for u, _ in drawn]),
               val=np.asarray(val))
    assert len(drawn) == 2 * -(-len(tr.interactions) // 32)
    r = tp.replay_port_ecf(d, rec, h, "cpu")
    assert r["best"] == best == r["jax_best"]
    assert r["val"] == val
    assert r["max_abs_param_diff"] == [0.0, 0.0]
    assert r["first_epoch_step_diffs"] == [0.0, 0.0, 0.0]
    assert r["parting"] is None
