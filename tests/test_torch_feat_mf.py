"""The port's feature MF (``ifeatmf``, ``ufeatmf``) against the JAX package,
on the CPU: the same (numpy-drawn) weights in both packages, the train
forward's logits, the InfoNCE regularization loss and every parameter's
gradient, catalog scores and the dot-ranking parts, over the bias variants
and ``aggregate_for_rec``; the user side's InfoNCE is exactly 0 in both
(a contrast set of one). Tolerances rtol 1e-5, atol 1e-6. Then the
registry, the CLI with serving from its run directory, and toy trained
floors."""
import numpy as np
import pytest
import torch

from sibrar_tpu_torch.models.feat_mf import FeatureMF
from test_torch_dmf import (
    check_catalog,
    check_floor,
    check_registry,
    check_served,
    check_train_forward,
    cli_run,
    floor_splits,
    models,
    one_torch_thread,  # noqa: F401 (autouse fixture)
)

CONFS = {
    "ifeatmf": {"feature_name": "audio", "embedding_dim": 4,
                "lambda_content": 0.5, "temperature": 0.2},
    "ifeatmf_biases": {"feature_name": "audio", "embedding_dim": 4,
                       "lambda_content": 0.5, "use_user_bias": True,
                       "use_item_bias": True, "use_global_bias": True},
    "ifeatmf_aggregate": {"feature_name": "text", "embedding_dim": 4,
                          "intermediate_layers": [6],
                          "aggregate_for_rec": True, "use_item_bias": True,
                          "embedding_loss_aggregator": "sum"},
    "ufeatmf": {"feature_name": "profile_vec", "embedding_dim": 4,
                "lambda_content": 0.5},
    "ufeatmf_aggregate": {"feature_name": "profile_vec", "embedding_dim": 4,
                          "aggregate_for_rec": True, "use_user_bias": True,
                          "use_global_bias": True},
}


def _name(variant):
    return variant.split("_")[0]


@pytest.mark.parametrize("variant", sorted(CONFS))
def test_feat_mf_train_forward_and_grads_match_flax(variant):
    jm, variables, tm = models(_name(variant), CONFS[variant])
    reg, grads = check_train_forward(jm, variables, tm)
    content = [g for (name, _), g in zip(tm.named_parameters(), grads)
               if name.startswith("content_net")]
    if variant.startswith("ufeatmf"):
        # [B, 1, d] against [B, 1, d]: the log-softmax of one logit is 0
        assert reg == 0.0
        if not CONFS[variant].get("aggregate_for_rec"):
            assert not any(g.any() for g in content)  # nothing trains it
    else:
        assert reg > 0 and all(g.any() for g in content)


@pytest.mark.parametrize("variant", sorted(CONFS))
def test_feat_mf_catalog_scores_and_dot_parts_match_flax(variant):
    jm, variables, tm = models(_name(variant), CONFS[variant])
    scores, dots = check_catalog(jm, variables, tm)
    shift = (scores - dots).numpy()  # user and global biases only
    np.testing.assert_allclose(shift, shift[:, :1].repeat(shift.shape[1], 1),
                               atol=1e-5)


@pytest.mark.parametrize("name,entity", [("ifeatmf", "item"),
                                         ("ufeatmf", "user")])
def test_registry_builds_feat_mf_on_the_data_device(name, entity):
    conf = {**CONFS[f"{name}_aggregate"], "temperature": 0.3}
    model = check_registry(name, conf, FeatureMF)
    assert model.entity == entity and model.aggregate_for_rec
    assert model.temperature == 0.3 and model.lambda_content == 1e-4
    assert model.user_embeddings.weight.shape == (30, 4)
    assert model.content_net.output_dim == 4
    table = model.content_net.table
    assert table.device.type == "cpu" and table.shape[0] == (
        30 if entity == "user" else 40)


@pytest.mark.parametrize("variant", ["ifeatmf_biases", "ufeatmf"])
def test_cli_train_val_and_serving_run_feat_mf(variant, tmp_path):
    conf = dict(CONFS[variant])
    conf["feature_name"] = {"ifeatmf": "audio",
                            "ufeatmf": "profile_vec"}[_name(variant)]
    check_served(cli_run(tmp_path, _name(variant), conf))


@pytest.mark.parametrize("entity,feature", [("item", "audio"),
                                            ("user", "profile_vec")])
def test_feat_mf_trains_past_its_untrained_floor(entity, feature):
    splits, data = floor_splits()
    model = FeatureMF.build_from_conf(
        entity, {"feature_name": feature, "embedding_dim": 16,
                 "lambda_content": 0.05}, splits["train"], data,
        torch.Generator().manual_seed(0))
    trainer = check_floor(model, splits, data)
    reg = trainer.train_epoch()["train/reg_loss"]
    assert (reg > 0) == (entity == "item")
