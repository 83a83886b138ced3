"""The port's sharded selections (``sibrar_tpu_torch/parallel/mesh.py``)
against the JAX package's, on the same numpy inputs.

The JAX side runs here, on conftest's 8 virtual CPU devices
(``make_mesh(8)`` = (data 4, item 2), ``item_parallelism=8`` = (1, 8)), its
peel in interpret mode. The port side runs in spawned 8-rank gloo worlds
of the same shapes (``torch_parallel_world.py``; one world for every
case, whose ranks import neither jax nor sibrar_tpu), and a 4-rank world
set up as 2 nodes x 2 ranks for the automatic two-stage merge. The
comparison is JAX's own: values within rtol 1e-6, ids equal, ``ok``
flags equal (rows the peel flags are compared by their flag only, as
JAX's fuzz test skips them). Training, evaluation, serving and the CLI on
a mesh are in ``test_torch_parallel_train.py``."""
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sibrar_tpu.parallel import mesh as jmesh
from torch_parallel_world import HIER_FUZZ, run_world, selection_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_world(8, "selections", None,
                     str(tmp_path_factory.mktemp("world8")))


@pytest.fixture(scope="module")
def two_nodes(tmp_path_factory):
    return run_world(4, "two_nodes", None,
                     str(tmp_path_factory.mktemp("world4")), local_world=2)


@pytest.fixture(scope="module")
def x():
    return selection_inputs()


def _same(got, want, ok=None):
    """Values within rtol 1e-6 and ids equal, on the rows ``ok`` keeps."""
    rows = slice(None) if ok is None else np.asarray(ok)
    np.testing.assert_allclose(got[0][rows], np.asarray(want[0])[rows],
                               rtol=1e-6)
    np.testing.assert_array_equal(got[1][rows], np.asarray(want[1])[rows])


def _jax_masked(mesh, s, cols, mask, k, **kw):
    return jmesh.sharded_masked_topk(jnp.asarray(s), jnp.asarray(cols),
                                     jnp.asarray(mask), k, mesh, **kw)


def _check_ok_run(got, want):
    """Same ok flags; same selections on the rows both call exact."""
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    _same(got, want, np.asarray(want[2]))


def test_mesh_axes(port):
    """make_mesh(8) = (4, 2) and make_mesh(1) = (1, 1), as JAX's."""
    m8, m1, mi8 = port["axes"]
    for got, want in ((m8, jmesh.make_mesh(8)), (m1, jmesh.make_mesh(1)),
                      (mi8, jmesh.make_mesh(8, item_parallelism=8))):
        assert got == dict(want.shape)


def test_sharded_topk_matches_jax(port, x):
    _same(port["topk"], jmesh.sharded_topk(jnp.asarray(x["topk"]), 5,
                                           jmesh.make_mesh(8)))


def test_sharded_topk_k_larger_than_shard(port, x):
    mesh = jmesh.make_mesh(8, item_parallelism=8)  # 4 columns a shard < 6
    _same(port["topk_k_gt_shard"], jmesh.sharded_topk(
        jnp.asarray(x["topk_k_gt_shard"]), 6, mesh))


@pytest.mark.parametrize("peel", [False, True], ids=["scatter", "peel"])
def test_sharded_masked_topk_matches_jax(port, x, peel):
    s, cols, mask = x["masked"]
    kw = dict(use_peel=True, interpret=True) if peel else dict(use_peel=False)
    want = _jax_masked(jmesh.make_mesh(8), s, cols, mask, 10,
                       return_ok=True, **kw)
    _check_ok_run(port["masked"][peel], want)
    assert np.asarray(want[2]).all()


def test_sharded_masked_topk_k_larger_than_shard(port, x):
    s = x["masked_k_gt_shard"]
    want = _jax_masked(jmesh.make_mesh(8, item_parallelism=8), s,
                       np.zeros((4, 0), np.int32), np.zeros((4, 0), bool),
                       20)
    _same(port["masked_k_gt_shard"], want)


def test_sharded_masked_topk_full_mesh_odd_batch(port, x):
    """21 rows over a data axis of 4: padded rows, sliced back."""
    s, cols, mask = x["odd_batch"]
    _same(port["odd_batch"], _jax_masked(jmesh.make_mesh(8), s, cols, mask,
                                         6))


def test_sharded_masked_topk_dot_matches_jax(port, x):
    """An odd catalog (one pad column over 2 shards) through the per-shard
    K2 + peel chain: JAX's values (rtol 1e-6; both rank the same f32
    products), ids and flags; the gate agrees."""
    u, items, cols, mask = x["dot"]
    mesh = jmesh.make_mesh(8)
    assert port["dot_viable"] == jmesh.sharded_dot_viable(
        items.shape[0], 9, 7, mesh, interpret=True)
    want = jmesh.sharded_masked_topk_dot(
        jnp.asarray(u), jnp.asarray(items), jnp.asarray(cols),
        jnp.asarray(mask), 9, mesh, interpret=True)
    _check_ok_run(port["dot"], want)
    assert np.asarray(want[2]).all() and port["dot"][1].max() < len(items)


@pytest.mark.parametrize("trial", range(6))
def test_sharded_masked_topk_fuzz_panel(port, x, trial):
    """JAX's seeded fuzz panel (odd batches, ties, clustered winners), both
    per-shard paths."""
    s, cols, mask, k = x["fuzz"][trial]
    mesh = jmesh.make_mesh(8)
    for peel in (False, True):
        kw = (dict(use_peel=True, interpret=True) if peel
              else dict(use_peel=False))
        want = _jax_masked(mesh, s, cols, mask, k, return_ok=True, **kw)
        _check_ok_run(port["fuzz"][trial][peel], want)


def test_hierarchical_merge_matches_flat(port, x):
    """Explicit node groups on the (1, 8) mesh: the two-stage merge is the
    flat one bit for bit (plain top-k, scatter, peel), and the flat one is
    JAX's."""
    s, cols, mask = x["hier"]
    mesh = jmesh.make_mesh(8, item_parallelism=8)
    flat, hier = port["hier_topk"]
    for a, b in zip(flat, hier):
        np.testing.assert_array_equal(a, b)
    _same(flat, jmesh.sharded_topk(jnp.asarray(s), 12, mesh,
                                   item_groups=None))
    for peel in (False, True):
        flat, hier = port["hier_masked"][peel]
        for a, b in zip(flat, hier):
            np.testing.assert_array_equal(a, b)
        kw = (dict(use_peel=True, interpret=True) if peel
              else dict(use_peel=False))
        _check_ok_run(flat, _jax_masked(mesh, s, cols, mask, 12,
                                        return_ok=True, item_groups=None,
                                        **kw))
    assert jmesh.hierarchical_item_groups(mesh) is None  # one host


@pytest.mark.parametrize("case", range(len(HIER_FUZZ)))
def test_hierarchical_merge_fuzz_group_shapes(port, x, case):
    """2 x 4 and 4 x 2 groups, k across shard boundaries (130 > 128 a
    shard): bit-equal to the flat merge, which is JAX's."""
    s, cols, mask = x["hier_fuzz"][case]
    groups, k, _ = HIER_FUZZ[case]
    flat, hier = port["hier_fuzz"][case]
    for a, b in zip(flat, hier):
        np.testing.assert_array_equal(a, b)
    want = _jax_masked(jmesh.make_mesh(8, item_parallelism=8), s, cols,
                       mask, k, return_ok=True, use_peel=False,
                       item_groups=groups)
    _check_ok_run(flat, want)


def test_hierarchical_groups_reject_mismatched_rows():
    """The grouping comes from the first data row; a row that maps item
    positions to nodes otherwise falls back to the flat merge (None), as
    in JAX."""
    from sibrar_tpu_torch.parallel.mesh import hierarchical_item_groups

    def fake(node_rows):
        nodes = np.asarray(node_rows)
        return SimpleNamespace(shape={"data": nodes.shape[0],
                                      "item": nodes.shape[1]}, nodes=nodes)

    assert hierarchical_item_groups(fake([[0, 0, 1, 1], [0, 0, 1, 1]])) \
        == ((0, 1), (2, 3))
    assert hierarchical_item_groups(fake([[0, 0, 1, 1], [0, 1, 0, 1]])) is None
    assert hierarchical_item_groups(fake([[0, 0, 0, 0]])) is None  # one node
    assert hierarchical_item_groups(fake([[0, 1, 2, 3]])) is None  # 1 a node


def test_two_node_world_merges_in_two_stages(two_nodes, x):
    """JAX's test_multihost_distributed_2proc: 4 ranks as 2 nodes x 2, the
    item axis across the node boundary. The automatic grouping is a group
    a node; the two-stage merge equals the flat one bit for bit and JAX's
    8-device flat merge over the same catalog."""
    s, cols, mask = x["hier"]
    assert two_nodes["groups"] == ((0, 1), (2, 3))
    auto, flat = two_nodes["topk"]
    for a, b in zip(auto, flat):
        np.testing.assert_array_equal(a, b)
    _same(flat, jax.lax.top_k(jnp.asarray(s), 12))
    masked = two_nodes["masked"]
    for a, b in ((masked[0], masked[1]), (masked[2], masked[3])):
        for ga, gb in zip(a, b):
            np.testing.assert_array_equal(ga, gb)
    want = _jax_masked(jmesh.make_mesh(8, item_parallelism=8), s, cols,
                       mask, 12, return_ok=True, use_peel=False,
                       item_groups=None)
    _check_ok_run(masked[0], want)


def test_make_mesh_matches_jax_rule():
    """The automatic item axis and the divisibility error, in one process
    (a world of one rank: JAX's make_mesh over one device)."""
    from sibrar_tpu_torch.parallel import mesh as tmesh

    assert tmesh.make_mesh(8).shape == {"data": 1, "item": 1}
    with pytest.raises(ValueError, match="not divisible by item_parallelism"):
        tmesh.make_mesh(1, item_parallelism=2)
    with pytest.raises(ValueError, match="not divisible by item_parallelism"):
        jmesh.make_mesh(1, item_parallelism=2)


def test_mesh_from_config_is_none_in_one_process():
    """One device never gets a mesh, ``enabled: true`` or not, as JAX's
    make_mesh_from_config; no process group is joined."""
    from sibrar_tpu_torch.config.schema import ParallelConfig
    from sibrar_tpu_torch.parallel import distributed as pdist
    from sibrar_tpu_torch.parallel.mesh import make_mesh_from_config

    assert not pdist.initialize_distributed()  # nothing asks for a world
    for enabled in (None, True, False):
        assert make_mesh_from_config(ParallelConfig(
            enabled=enabled, n_devices=2)) is None
    assert make_mesh_from_config(None) is None
    assert not pdist.is_initialized()


FAILED_WORLD = r"""
import os, sys
os.environ.update(RANK="1", WORLD_SIZE="2", MASTER_ADDR="localhost",
                  MASTER_PORT="1", LOCAL_RANK="1")
from sibrar_tpu_torch.parallel.distributed import initialize_distributed
try:
    initialize_distributed(timeout_s=3)
except Exception as e:
    print("raised", type(e).__name__)
    sys.exit(0)
print("joined")
sys.exit(1)
"""


def test_torchrun_world_that_cannot_join_raises():
    """torchrun's environment asks for a world; when its store cannot be
    reached the call raises instead of running as one process."""
    r = subprocess.run([sys.executable, "-c", FAILED_WORLD], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0 and "raised" in r.stdout, r.stdout + r.stderr


def test_backend_rule():
    """NCCL only where every local rank has a card of its own."""
    import torch

    from sibrar_tpu_torch.parallel.distributed import choose_backend

    if not torch.cuda.is_available():
        assert choose_backend(1) == choose_backend(4) == "gloo"
    else:
        n = torch.cuda.device_count()
        assert choose_backend(n) == "nccl"
        assert choose_backend(n + 1) == "gloo"

