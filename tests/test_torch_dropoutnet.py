"""The port's DropoutNet against the JAX package, on the CPU: the same
(numpy-drawn) weights in both packages, the train forward's logits and
every parameter's gradient with JAX's keep masks (recorded from
``jax.random.bernoulli`` during an unjitted ``apply``) passed to the port's
``keep=``, on the dense first layer (JAX's Pallas ``dw_matmul`` in
interpret mode) and on the bag path; catalog scores (full information) and
the dot-ranking parts. Tolerances rtol 1e-5, atol 1e-6. Then the port's own
draw (one per batch row, user tower first), the registry, the CLI with
serving from its run directory, and a toy trained floor."""
import jax
import numpy as np
import pytest
import torch

from sibrar_tpu.models import layers as jlayers
from sibrar_tpu_torch.models.dropoutnet import DropoutNet
from sibrar_tpu_torch.models.layers import InteractionTower
from test_torch_dmf import (
    B,
    check_catalog,
    check_floor,
    check_registry,
    check_served,
    check_train_forward,
    cli_run,
    floor_splits,
    inputs,
    models,
    one_torch_thread,  # noqa: F401 (autouse fixture)
)

CONF = {
    "shared_common_dim": 4,
    "user": {"features": [{"feature_name": "gender", "embedding_dim": 3},
                          {"feature_name": "profile_vec",
                           "embedding_dim": 5}],
             "preference_layers": [8, 6], "common_hidden_layers": [7]},
    "item": {"features": [{"feature_name": "audio", "embedding_dim": 5,
                           "post_embedding_layers": [3]},
                          {"feature_name": "genres", "embedding_dim": 4}],
             "preference_layers": [8], "common_hidden_layers": [7, 5],
             "activation_fn": "tanh"},
}


@pytest.mark.parametrize("path", ["dense", "bag"])
def test_dropoutnet_train_forward_and_grads_match_flax(path, monkeypatch):
    jm, variables, tm = models("dropoutnet", CONF)
    towers = (tm.user_net.pref_net, tm.item_net.pref_net)
    if path == "bag":
        monkeypatch.setattr(jlayers, "BAG_BREAK_EVEN_FACTOR", 0)
        for tower in towers:
            tower.bag_break_even_factor = 0
    else:
        monkeypatch.setattr(jlayers, "DW_KERNEL", "interpret")
    assert all(t.use_bag(B) == (path == "bag") for t in towers)
    draws = []
    bernoulli = jax.random.bernoulli

    def recorded(key, p=0.5, shape=None):
        out = bernoulli(key, p, shape)
        draws.append(np.array(out))
        return out

    monkeypatch.setattr(jax.random, "bernoulli", recorded)

    def keep():
        assert [d.shape for d in draws] == [(B,), (B,)]
        assert all(d.any() and not d.all() for d in draws)  # both kinds
        return tuple(torch.as_tensor(d) for d in draws)

    reg, grads = check_train_forward(jm, variables, tm, keep=keep)
    assert reg == 0.0 and all(np.isfinite(g).all() for g in grads)


def test_dropoutnet_catalog_scores_and_dot_parts_match_flax():
    jm, variables, tm = models("dropoutnet", CONF)
    scores, dots = check_catalog(jm, variables, tm)
    np.testing.assert_allclose(dots.numpy(), scores.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_dropoutnet_draws_one_keep_per_batch_row():
    """Train mode draws the user tower's [B] mask from ``gen``, then the
    item tower's; a row's candidates share its draw, a dropped row's
    preference sum is multiplied by 0, and eval mode keeps every row."""
    _, _, tm = models("dropoutnet", CONF)
    users, items = (torch.as_tensor(x) for x in inputs())
    tm.train()
    drawn = tm(users, items, gen=torch.Generator().manual_seed(9))[0]
    gen = torch.Generator().manual_seed(9)
    half = torch.full((B,), 0.5)
    keep = (torch.bernoulli(half, generator=gen),
            torch.bernoulli(half, generator=gen))
    assert torch.equal(drawn, tm(users, items, keep=keep)[0])
    pref = tm.item_net.pref_net
    scale = keep[1][:, None, None].expand(*items.shape, 1)
    seen = []
    hook = pref.register_forward_hook(
        lambda m, a, k, out: seen.append(k), with_kwargs=True)
    try:
        tm(users, items, keep=keep)
    finally:
        hook.remove()
    assert torch.equal(seen[0]["scale"], scale)
    with torch.no_grad():
        ones = tm(users, items, keep=(torch.ones(B), torch.ones(B)))[0]
        tm.eval()
        full = tm(users, items)[0]
    np.testing.assert_allclose(ones, full, rtol=1e-6, atol=1e-7)


def test_registry_builds_dropoutnet_on_the_data_device():
    model = check_registry("dropoutnet", CONF, DropoutNet)
    user, item = model.user_net, model.item_net
    assert list(user.content) == ["cont_user__gender",
                                  "cont_user__profile_vec"]
    assert list(item.content) == ["cont_item__audio", "cont_item__genres"]
    assert isinstance(user.pref_net, InteractionTower)
    assert user.pref_net.kernel.shape == (40, 8)  # a user's row: the items
    assert item.pref_net.kernel.shape == (30, 8)
    assert user.net.linears[0].in_features == 3 + 5 + 6
    assert item.net.linears[0].in_features == 3 + 4 + 8
    assert item.net.linears[-1].out_features == 4
    bias = user.pref_net.bias.detach().abs()  # torch-default init:
    assert 0 < float(bias.max()) <= 1 / np.sqrt(40)  # U(+-1/sqrt(fan_in))


def test_cli_train_val_and_serving_run_dropoutnet(tmp_path):
    conf = {**CONF, "item": {**CONF["item"], "features": [
        {"feature_name": "audio", "embedding_dim": 5}]}}
    check_served(cli_run(tmp_path, "dropoutnet", conf))


def test_dropoutnet_trains_past_its_untrained_floor():
    splits, data = floor_splits()
    conf = {
        "shared_common_dim": 16,
        "user": {"features": [{"feature_name": "profile_vec",
                               "embedding_dim": 16}],
                 "preference_layers": [16], "common_hidden_layers": [16]},
        "item": {"features": [{"feature_name": "audio",
                               "embedding_dim": 16}],
                 "preference_layers": [16], "common_hidden_layers": [16]},
    }
    model = DropoutNet.build_from_conf(conf, splits["train"], data,
                                       torch.Generator().manual_seed(0))
    check_floor(model, splits, data)
