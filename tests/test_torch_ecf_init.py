"""The distribution of ECF's initial parameters in the port against the JAX
package's, on the CPU.

The ECF replay (``torch_trained_parity.py replay-jax``) trains the port
from JAX's initial weights, so it cannot see an initializer whose
distribution differs. Here both packages initialize ECF as their trainers
do (JAX: ``init_model`` under ``PRNGKey(seed)``; the port: the registry
build with ``seed``) at the toy quality run's width (embedding 16, 8
clusters; ``tools/trained_parity.py``'s ECF hyperparameters), for seeds
0-19. For each table (``user_embedding``, ``item_embedding``,
``clusters``) and each statistic (mean, std, min, max of the table), the
20 seeds' average of the port's may differ from JAX's by at most four
standard errors of the difference (the two packages' seed-to-seed spreads
combined): sampling error, at a false-alarm rate of about 6e-5 per
comparison."""
import jax
import numpy as np
import pytest

from sibrar_tpu.models.base import init_model
from sibrar_tpu.models.registry import get_algorithm as jax_get_algorithm
from sibrar_tpu_torch.models.registry import get_algorithm
from test_torch_dmf import _both_splits, one_torch_thread  # noqa: F401

CONF = {"embedding_dim": 16, "n_clusters": 8, "top_n": 4, "top_m": 4,
        "top_p": 2, "tag_feature": "genres"}
TABLES = ("user_embedding", "item_embedding", "clusters")
SEEDS = range(20)
STATS = {"mean": np.mean, "std": np.std, "min": np.min, "max": np.max}


@pytest.fixture(scope="module")
def inits():
    js, ts = _both_splits()
    jdd = js["train"].to_device()
    jmodel = jax_get_algorithm("ecf").build(CONF, js["train"], jdd)
    init = jax.jit(lambda key: init_model(jmodel, key, jdd)["params"])
    tdd = ts["train"].to_device("cpu")
    out = {"jax": [], "port": []}
    for seed in SEEDS:
        params = init(jax.random.PRNGKey(seed))
        out["jax"].append({t: np.asarray(params[t]) for t in TABLES})
        model = get_algorithm("ecf").build(CONF, ts["train"], tdd, seed)
        out["port"].append({t: getattr(model, t).detach().numpy()
                            for t in TABLES})
    return out


@pytest.mark.parametrize("stat", list(STATS))
@pytest.mark.parametrize("table", TABLES)
def test_initial_parameter_statistics_match_jax(inits, table, stat):
    fn = STATS[stat]
    j = np.asarray([fn(p[table].astype(np.float64)) for p in inits["jax"]])
    t = np.asarray([fn(p[table].astype(np.float64)) for p in inits["port"]])
    assert inits["jax"][0][table].shape == inits["port"][0][table].shape
    se = np.sqrt(j.var(ddof=1) / len(j) + t.var(ddof=1) / len(t))
    assert abs(t.mean() - j.mean()) <= 4 * se, (t.mean(), j.mean(), se)
