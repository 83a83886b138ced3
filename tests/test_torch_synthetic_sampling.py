"""The port's ``make_synthetic_splits``, ``sample_user_positives`` and the
port side of the trained-quality run, on the CPU.

The splits must equal JAX's bit for bit (pairs, feature tables, labels);
the positive sampler with JAX's draws injected must give JAX's samples bit
for bit, an empty-history user included; the quality run's artifacts must
be JAX's files byte for byte; and the port must train ``sbnet`` and ``mf``
above a floor on the toy artifacts (100 users x 120 items x 3,000 pairs,
seeds 0 and 1; toy seed noise is +-0.015, so floors only: the paired gate
runs at mid scale, ``torch_trained_parity.py``)."""
import filecmp
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sibrar_tpu.config.schema import DatasetSplitType as JaxSplitType
from sibrar_tpu.data import sampling as jsampling
from sibrar_tpu.data.synthetic import make_synthetic_splits as jax_splits
from sibrar_tpu.data.synthetic import (
    write_reference_artifacts as jax_write_artifacts,
)
from sibrar_tpu.ops import sparse as jsparse
from sibrar_tpu_torch.data.sampling import sample_user_positives
from sibrar_tpu_torch.data.synthetic import make_synthetic_splits
from sibrar_tpu_torch.ops.sparse import DeviceCSR
from sibrar_tpu_torch.tools import trained_parity

TOY_FLOOR = 0.1  # ndcg@10; the JAX toy-scale SBNet runs are held to 0.1
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: beside the suite's other workers the
    toy trainings took 649 s and 329 s with torch's own thread count, 6 s
    and 3 s on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _joiner():
    """The root script ``torch_trained_parity.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "torch_trained_parity", os.path.join(ROOT, "torch_trained_parity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_feature(name, got, want):
    """A port `FeatureTable` against a JAX `Feature`: the table bit for
    bit, the kind, the category count and the labels with their types."""
    np.testing.assert_array_equal(got.table, want.table, err_msg=name)
    assert got.table.dtype == want.table.dtype, name
    if want.value_map is None:
        assert got.kind == "numeric" and got.value_map is None, name
        return
    assert got.kind == want.type.value, name
    assert got.n_categories == len(want.unique_values), name
    assert list(got.value_map.items()) == list(want.value_map.items()), name


@pytest.mark.parametrize("split_type", ["random", "temporal",
                                        "cold_start_user", "cold_start_item",
                                        "cold_start_both"])
@pytest.mark.parametrize("alpha", [0.0, 0.8])
def test_make_synthetic_splits_bit_equal_to_jax(split_type, alpha):
    kw = dict(n_users=40, n_items=50, n_interactions=600, seed=3,
              popularity_alpha=alpha)
    want = jax_splits(split_type=JaxSplitType(split_type), **kw)
    got = make_synthetic_splits(split_type=split_type, **kw)
    for split in ("train", "val", "test"):
        g, w = got[split], want[split]
        assert (g.n_users, g.n_items, g.split_type) == (
            w.n_users, w.n_items, w.split_type.value)
        for field in ("interactions", "train_interactions",
                      "val_interactions"):
            a, b = getattr(g, field), getattr(w, field)
            assert (a is None) == (b is None), field
            if a is not None:
                assert a.dtype == b.dtype, field
                np.testing.assert_array_equal(a, b, err_msg=field)
        for entity in ("user_features", "item_features"):
            gf, wf = getattr(g, entity), getattr(w, entity)
            assert list(gf) == list(wf)
            for name in gf:
                _same_feature(name, gf[name], wf[name])
    assert not make_synthetic_splits(with_features=False, **kw)[
        "train"].item_features


def test_sample_user_positives_with_injected_draws_matches_jax():
    """Rows of several lengths, an empty row, n_pos above a row's length
    (offsets wrap), and the last user at the end of ``indices`` (the clamp
    to nnz - 1)."""
    rng = np.random.default_rng(9)
    dense = rng.random((7, 30)) < 0.2
    dense[2] = False  # a user with no positives
    dense[6, :] = False
    dense[6, 29] = True  # the last entry of indices
    mat = sp.csr_matrix(dense.astype(np.int8))
    users = np.array([0, 2, 5, 6, 1, 2, 3], np.int32)
    n_pos = 6
    jcsr = jsparse.DeviceCSR.from_scipy(mat)
    key = jax.random.PRNGKey(3)
    want = jsampling.sample_user_positives(key, jnp.asarray(users), jcsr,
                                           n_pos)
    draws = jax.random.randint(key, (len(users), n_pos), 0, 1 << 30)
    tcsr = DeviceCSR.from_scipy(mat, "cpu")
    got = sample_user_positives(None, torch.as_tensor(users), tcsr, n_pos,
                                draws=torch.tensor(np.asarray(draws)))
    assert got.dtype == torch.int32 and got.shape == (len(users), n_pos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[users == 2] == -1).all()
    # the port's own draws: every sample a positive of its user
    own = sample_user_positives(torch.Generator().manual_seed(0),
                                torch.as_tensor(users), tcsr, n_pos)
    for u, row in zip(users, own.numpy()):
        if dense[u].any():
            assert dense[u, row].all()
        else:
            assert (row == -1).all()
    empty = DeviceCSR.from_scipy(sp.csr_matrix((3, 4), dtype=np.int8), "cpu")
    assert (sample_user_positives(torch.Generator(), torch.arange(3), empty,
                                  2) == -1).all()


def test_quality_run_artifacts_are_jax_files(tmp_path):
    """The port's ``make_artifacts`` writes the directory JAX's
    ``tools/trained_parity.make_artifacts`` writes (its two calls), byte
    for byte, at the quality run's toy arguments."""
    want_dir, got_dir = tmp_path / "jax", tmp_path / "port"
    jax_write_artifacts(str(want_dir), jax_splits(
        n_users=100, n_items=120, n_interactions=3000, seed=3,
        popularity_alpha=0.0))
    trained_parity.make_artifacts(str(got_dir))
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    match, mismatch, errors = filecmp.cmpfiles(want_dir, got_dir, names,
                                               shallow=False)
    assert not mismatch and not errors, mismatch


@pytest.mark.parametrize("family", ["sbnet", "mf"])
def test_toy_trained_quality_floor(family):
    res = trained_parity.run([family], [0, 1], scale="toy", device="cpu",
                             log=lambda line: None)
    runs = res["families"][family]["runs"]
    assert sorted(runs) == ["0", "1"]
    assert all(v > TOY_FLOOR for v in runs.values()), runs
    assert res["device"] == "cpu"


def _quality_runs(values, scale="mid", family="sbnet"):
    return {"scale": scale, "device": "cpu", "families": {family: {
        "hparams": trained_parity.hparams_for(family, "mid"),
        "runs": {str(seed): v for seed, v in enumerate(values)}}}}


JAX_VALUES = [0.170, 0.165, 0.172, 0.168, 0.166]


@pytest.mark.parametrize("case", ["passes", "fails", "below the floor",
                                  "scale differs", "hparams differ"])
def test_quality_join_gate(case):
    """``torch_trained_parity.join`` on hand-made runs: five paired seeds
    0.002 apart pass |delta_mean| <= max(0.01, delta_sem); 0.03 apart they
    fail; both sides under the 0.03 floor fail; a port run at another
    scale, or with other hyperparameters, than the JAX runs raises."""
    join = _joiner().join
    ref = _quality_runs(JAX_VALUES)
    if case in ("passes", "fails"):
        shift = 0.002 if case == "passes" else -0.03
        port = _quality_runs([v + shift for v in JAX_VALUES])
        res = join(ref, port)["sbnet"]
        assert res["passes"] is (case == "passes")
        assert res["n_seeds"] == 5 and res["ref_runs"] == JAX_VALUES
        assert res["delta_mean"] == pytest.approx(shift, abs=1e-12)
        assert res["delta_sem"] == pytest.approx(0.0, abs=1e-9)
    elif case == "below the floor":
        low = [v / 10 for v in JAX_VALUES]
        assert not join(_quality_runs(low), _quality_runs(low))["sbnet"][
            "passes"]
    elif case == "scale differs":
        with pytest.raises(ValueError, match="scale"):
            join(ref, _quality_runs(JAX_VALUES, scale="toy"))
    else:
        port = _quality_runs(JAX_VALUES)
        port["families"]["sbnet"]["hparams"]["lr"] *= 2
        with pytest.raises(ValueError, match="hparams"):
            join(ref, port)
