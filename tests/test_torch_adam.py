"""K18 (`ops.adam.adam_step`) and the optimizer's choice of path, on the
CPU; card tests (marked ``card``, skipped without a card) hold K18 to its
plain version at the shapes of SBNet onion18's parameters, read from the
optimizer of a `Trainer` built at ``chip_smoke.py``'s widths over the
onion-scale synthetic data. On a card, from the repository's root:

    python -m pytest --noconftest -m card tests/test_torch_adam.py

The card tests' tolerance is round-off only: K18 rounds each operation as
the plain version's PyTorch operation on the card does, and ``mu`` comes
out bit-equal, but PyTorch's ``addcmul_`` rounds ``nu`` differently (up to
~4e-7 relative, measured on an H100), which the update carries on; so rtol
1e-6 on ``p``, ``mu`` and ``nu``, with an atol of 1e-6 of each tensor's
largest value for elements near 0.

This file imports no JAX (the optimizers against optax:
`tests/test_torch_train_ops.py`)."""
import copy
import ctypes
import importlib.util
import math
import os

import pytest
import torch

from sibrar_tpu_torch import config_from_dict
from sibrar_tpu_torch.data.dataset import make_splits
from sibrar_tpu_torch.data.synthetic import make_onion_scale_splits
from sibrar_tpu_torch.models.sbnet import SingleBranchNet
from sibrar_tpu_torch.ops import _cuda, adam
from sibrar_tpu_torch.train import trainer as trainer_mod
from sibrar_tpu_torch.train.trainer import (
    DatasetConfig,
    LearningConfig,
    Trainer,
    build_optimizer,
)
from sibrar_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(7, 3), (5,), (9, 4)]
HYPER = dict(lr=5e-5, wd=1e-3, b1=0.9, b2=0.999, eps=1e-8)  # the YAML's


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sbnet_trainer(device, model_conf, **sizes) -> Trainer:
    """SBNet at ``model_conf``'s widths over the onion-scale synthetic data
    (``sizes``: its users, items and interactions), with chip_smoke's learn
    / dataset / loader settings."""
    smoke = _smoke()
    splits = make_splits(make_onion_scale_splits(seed=7, **sizes))
    train = splits["train"]
    data = train.to_device(device)
    model = SingleBranchNet.build_from_conf(model_conf, train, data, seed=0)
    return Trainer(model, train,
                   config_from_dict(LearningConfig, smoke.LEARN_CONF),
                   config_from_dict(DatasetConfig, smoke.DATASET_CONF),
                   batch_size=smoke.LOADER_CONF["batch_size"], seed=0,
                   device_data=data)


def make_set(shapes, device, seed: int = 0, views: bool = False) -> dict:
    """Parameters, gradients and moments (``nu`` positive) drawn from
    ``seed``; with ``views`` the gradients are views into one flat buffer,
    each at a 4-byte offset, as the mesh hands them out."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(shape, scale):
        return scale * torch.randn(shape, generator=gen, device=device)

    params = [draw(s, 0.05) for s in shapes]
    mus = [draw(s, 1e-3) for s in shapes]
    nus = [draw(s, 1e-3).square() for s in shapes]
    if views:
        flat = draw((1 + sum(p.numel() for p in params),), 1e-2)
        grads, start = [], 1
        for p in params:
            grads.append(flat[start:start + p.numel()].view_as(p))
            start += p.numel()
    else:
        grads = [draw(s, 1e-2) for s in shapes]
    return {"params": params, "grads": grads, "mus": mus, "nus": nus}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def sbnet_shapes():
    """The shapes of SBNet onion18's parameters, in the optimizer's order:
    its trainer at chip_smoke's widths over the 50,000 x 100,352 synthetic
    data, built on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    trainer = _sbnet_trainer("cuda", _smoke().MODEL_CONF)
    shapes = [tuple(p.shape) for p in trainer.optimizer.params]
    del trainer
    torch.cuda.empty_cache()
    return shapes


def _params(seed: int = 0) -> list:
    gen = torch.Generator().manual_seed(seed)
    return [torch.nn.Parameter(torch.randn(s, generator=gen))
            for s in SHAPES]


def _grads(params, seed: int) -> list:
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(p.shape, generator=gen) for p in params]


def _close(got: torch.Tensor, want: torch.Tensor) -> None:
    torch.testing.assert_close(
        got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))


# ------------------------------------------------------------------ dispatch
@pytest.mark.parametrize("kind,moments,path", [
    ("adam", None, "fused"), ("adamw", None, "fused"),
    ("adagrad", None, "loop"), ("adam", "bfloat16", "loop"),
    ("adamw", "bfloat16", "loop")])
def test_the_optimizer_sends_f32_adam_to_adam_step(monkeypatch, kind,
                                                   moments, path):
    """adam / adamw with f32 moments step through `adam_step`, all
    parameters in one call; adagrad and bf16 first moments keep the loop;
    the counters say which."""
    calls = []
    real = trainer_mod.adam_step

    def recorded(params, *args, **kwargs):
        calls.append(len(params))
        return real(params, *args, **kwargs)

    monkeypatch.setattr(trainer_mod, "adam_step", recorded)
    params = _params()
    opt = build_optimizer(LearningConfig(optimizer=kind, lr=1e-2, wd=1e-2,
                                         moment_dtype=moments), params)
    fused0 = trace.counter("optimizer.fused_params")
    loop0 = trace.counter("optimizer.loop_params")
    for step in range(2):
        for p, g in zip(params, _grads(params, step)):
            p.grad = g
        opt.step()
    fused = trace.counter("optimizer.fused_params") - fused0
    loop = trace.counter("optimizer.loop_params") - loop0
    n = len(params)
    if path == "fused":
        assert calls == [n, n] and (fused, loop) == (2 * n, 0)
    else:
        assert calls == [] and (fused, loop) == (0, 2 * n)


def test_an_sbnet_step_sends_every_parameter_to_adam_step():
    """A real SBNet train step (chip_smoke's settings at small widths and
    sizes): each of the optimizer's parameters through `adam_step` once,
    none through the loop."""
    conf = copy.deepcopy(_smoke().MODEL_CONF)
    conf["shared_common_dim"] = conf["user"]["embedding_dim"] = 8
    conf["item"]["common_modality_dim"] = 16
    conf["item"]["single_branch_hidden_layers"] = [16, 16, 8, 8]
    trainer = _sbnet_trainer("cpu", conf, n_users=120, n_items=300,
                             n_interactions=3000, n_clusters=8,
                             feature_dims={"ivec256": 16, "bert": 24,
                                           "musicnn": 8})
    n = len(trainer.optimizer.params)
    fused0 = trace.counter("optimizer.fused_params")
    loop0 = trace.counter("optimizer.loop_params")
    before = [p.detach().clone() for p in trainer.optimizer.params]
    trainer.train_step(torch.arange(512))
    assert trace.counter("optimizer.fused_params") - fused0 == n
    assert trace.counter("optimizer.loop_params") == loop0
    assert trainer.optimizer.count == 1
    moved = [not torch.equal(p, q)
             for p, q in zip(trainer.optimizer.params, before)]
    assert sum(moved) > n // 2


def _pre_k18_loop(opt, params) -> None:
    """The optimizer's loop as it was before K18 took Adam / AdamW with
    f32 moments, every kind in it: the bits adagrad and bf16 first moments
    must still give."""
    opt.count += 1
    for p in params:
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        st = opt.state[p]
        if opt.kind != "adamw" and opt.wd:
            g = g + opt.wd * p
        if opt.kind == "adagrad":
            ss = st["sum_of_squares"].addcmul_(g, g)
            upd = torch.where(ss > 0, torch.rsqrt(ss + opt.RSS_EPS),
                              0.0) * g
        else:
            if st["mu"].dtype == p.dtype:
                mu = st["mu"].mul_(opt.B1).add_(g, alpha=1 - opt.B1)
            else:
                b1 = torch.tensor(opt.B1, dtype=st["mu"].dtype)
                mu = (1 - opt.B1) * g + (b1 * st["mu"]).to(p.dtype)
                st["mu"] = mu.to(st["mu"].dtype)
            nu = st["nu"].mul_(opt.B2).addcmul_(g, g, value=1 - opt.B2)
            mu_hat = mu / (1 - opt.B1 ** opt.count)
            nu_hat = nu / (1 - opt.B2 ** opt.count)
            upd = mu_hat / (nu_hat.sqrt() + opt.EPS)
            if opt.kind == "adamw" and opt.wd:
                upd = upd + opt.wd * p
        p.sub_(opt.lr * upd)


@pytest.mark.parametrize("kind,moments,wd", [
    ("adagrad", None, 1e-2), ("adagrad", None, 0.0),
    ("adam", "bfloat16", 1e-2), ("adamw", "bfloat16", 1e-2),
    ("adamw", "bfloat16", 0.0), ("adam", None, 1e-2),
    ("adamw", None, 1e-2)])
def test_the_optimizer_gives_the_bits_of_its_loop_before_k18(kind, moments,
                                                             wd):
    """Over three steps: adagrad and bf16 first moments bit for bit as the
    loop before K18; Adam / AdamW with f32 moments too, on the CPU (where
    `adam_step` takes its plain version)."""
    a, b = _params(2), _params(2)
    opts = [build_optimizer(LearningConfig(optimizer=kind, lr=1e-2, wd=wd,
                                           moment_dtype=moments), ps)
            for ps in (a, b)]
    for step in range(3):
        for ps in (a, b):
            for p, g in zip(ps, _grads(ps, 20 + step)):
                p.grad = g
        a[2].grad = b[2].grad = None
        opts[0].step()
        with torch.no_grad():
            _pre_k18_loop(opts[1], b)
    for p, q in zip(a, b):
        assert torch.equal(p, q)
        for key, t in opts[0].state[p].items():
            assert t.dtype == opts[1].state[q][key].dtype
            assert torch.equal(t, opts[1].state[q][key])


@pytest.mark.parametrize("kind,wd", [("adam", 1e-2), ("adamw", 1e-2),
                                     ("adam", 0.0), ("adamw", 0.0),
                                     ("adagrad", 1e-2)])
def test_a_parameter_without_a_gradient_steps_as_with_zeros(kind, wd):
    a, b = _params(1), _params(1)
    opts = [build_optimizer(LearningConfig(optimizer=kind, lr=1e-2, wd=wd),
                            ps) for ps in (a, b)]
    for step in range(3):
        grads = _grads(a, 10 + step)
        for ps in (a, b):
            for p, g in zip(ps, grads):
                p.grad = g.clone()
        a[1].grad = None
        b[1].grad = torch.zeros_like(b[1])
        for opt in opts:
            opt.step()
    for p, q in zip(a, b):
        assert torch.equal(p, q)
    for p, q in zip(a, b):
        for key, t in opts[0].state[p].items():
            assert torch.equal(t, opts[1].state[q][key])


# ------------------------------------------------------------------ wrapper
def test_adam_step_on_the_cpu_is_its_plain_version(monkeypatch):
    """CPU tensors take the plain version, bit for bit, and never reach
    the library."""
    def refuse(*args, **kwargs):
        raise AssertionError("reached the kernel library")

    for name in ("launch", "query", "build"):
        monkeypatch.setattr(_cuda, name, refuse)
    sets = [make_set(SHAPES, "cpu", seed=3) for _ in range(2)]
    sets[0]["grads"][2] = sets[1]["grads"][2] = None
    launches = adam.adam_step.launches
    for count in (1, 2):
        for fn, tensors in zip((adam.adam_step, adam.adam_step_plain), sets):
            fn(tensors["params"], tensors["grads"], tensors["mus"],
               tensors["nus"], count=count, decoupled=False, **HYPER)
    assert adam.adam_step.launches == launches
    for key in ("params", "mus", "nus"):
        for got, want in zip(sets[0][key], sets[1][key]):
            assert torch.equal(got, want)


def _fake_library(monkeypatch, per_launch: int) -> list:
    """`_cuda` as if on a card, recording each launch's table and
    scalars."""
    launched = []

    def launch(name, table, count, *scalars):  # table: a host address
        rows = (ctypes.c_longlong * (5 * count)).from_address(table)
        launched.append((name, list(rows), count, scalars))

    monkeypatch.setattr(_cuda, "use_kernel", lambda *t: True)
    monkeypatch.setattr(_cuda, "query", lambda name: per_launch)
    monkeypatch.setattr(_cuda, "launch", launch)
    return launched


@pytest.mark.parametrize("decoupled,wd", [(False, 1e-2), (True, 1e-2),
                                          (True, 0.0)])
def test_adam_step_tables_its_tensors_by_launch(monkeypatch, decoupled, wd):
    """Each launch gets up to the library's count of rows ``(p, g, mu, nu,
    n)`` (0 for a missing gradient; an empty tensor left out) and the
    scalars in the C entry's order, with the bias corrections of
    ``count``."""
    launched = _fake_library(monkeypatch, per_launch=2)
    tensors = make_set([(4, 3), (5,), (0, 2), (6,), (2, 2)], "cpu")
    tensors["grads"][1] = None
    launches = adam.adam_step.launches
    adam.adam_step(tensors["params"], tensors["grads"], tensors["mus"],
                   tensors["nus"], lr=1e-3, wd=wd, b1=0.9, b2=0.999,
                   eps=1e-8, count=3, decoupled=decoupled)
    rows = [(p.data_ptr(), 0 if g is None else g.data_ptr(), m.data_ptr(),
             v.data_ptr(), p.numel())
            for p, g, m, v in zip(*(tensors[k] for k in
                                    ("params", "grads", "mus", "nus")))
            if p.numel()]
    assert adam.adam_step.launches - launches == 2 == len(launched)
    assert [c for _, _, c, _ in launched] == [2, 2]
    assert [name for name, *_ in launched] == ["sibrar_adam_step"] * 2
    assert sum((t for _, t, _, _ in launched), []) == [
        x for row in rows for x in row]
    want = (0.9, 1 - 0.9, 0.999, 1 - 0.999, 1 - 0.9 ** 3, 1 - 0.999 ** 3,
            1e-8, wd, 1e-3, int(not decoupled and wd != 0),
            int(decoupled and wd != 0))
    assert all(scalars == want for _, _, _, scalars in launched)


@pytest.mark.parametrize("fault", ["dtype", "layout", "shape"])
def test_adam_step_raises_on_what_the_kernel_does_not_take(monkeypatch,
                                                           fault):
    launched = _fake_library(monkeypatch, per_launch=64)
    tensors = make_set([(4, 3), (5,)], "cpu")
    if fault == "dtype":
        tensors["nus"][1] = tensors["nus"][1].double()
    elif fault == "layout":
        tensors["grads"][0] = torch.zeros(3, 4).T
    else:
        tensors["mus"][0] = tensors["mus"][0][:3]
    with pytest.raises(ValueError, match="adam_step"):
        adam.adam_step(tensors["params"], tensors["grads"], tensors["mus"],
                       tensors["nus"], count=1, decoupled=True, **HYPER)
    assert launched == []


# ------------------------------------------------------------------ the card
def _k18_against_plain(shapes, device, decoupled: bool = True,
                       wd: float = HYPER["wd"], views: bool = False,
                       missing=(), steps: int = 3) -> None:
    """K18 and the plain version from the same draws over ``steps`` steps
    (``missing``: indices whose gradient is None)."""
    k18 = make_set(shapes, device, seed=5, views=views)
    ref = {k: [t.clone() for t in v] for k, v in k18.items()}
    for i in missing:
        k18["grads"][i] = ref["grads"][i] = None
    hyper = {**HYPER, "wd": wd}
    for count in range(1, steps + 1):
        for fn, tensors in ((adam.adam_step, k18),
                            (adam.adam_step_plain, ref)):
            fn(tensors["params"], tensors["grads"], tensors["mus"],
               tensors["nus"], count=count, decoupled=decoupled, **hyper)
    torch.cuda.synchronize()
    for key in ("params", "mus", "nus"):
        for got, want in zip(k18[key], ref[key]):
            _close(got, want)


@pytest.mark.card
@pytest.mark.parametrize("decoupled,wd", [(True, 1e-3), (False, 1e-3),
                                          (True, 0.0)])
def test_card_k18_matches_its_plain_version_at_sbnet_shapes(
        cuda, sbnet_shapes, decoupled, wd):
    """Each of K18's three instances: AdamW's decay on the update, Adam's
    on the gradient, no decay."""
    _k18_against_plain(sbnet_shapes, cuda, decoupled=decoupled, wd=wd)


@pytest.mark.card
def test_card_k18_takes_gradients_as_views_at_4_byte_offsets(cuda,
                                                             sbnet_shapes):
    """The mesh's gradients: views into one flat buffer, none 16-byte
    aligned (the scalar path)."""
    _k18_against_plain(sbnet_shapes, cuda, views=True)


@pytest.mark.card
def test_card_k18_steps_a_missing_gradient_as_zeros(cuda, sbnet_shapes):
    _k18_against_plain(sbnet_shapes, cuda, missing=(0, 1, 21))


@pytest.mark.card
def test_card_k18_launches_once_a_step(cuda, sbnet_shapes):
    """SBNet's parameters take one launch a step, through the optimizer
    too."""
    launches = adam.adam_step.launches
    _k18_against_plain(sbnet_shapes, cuda, steps=3)
    assert adam.adam_step.launches - launches == 3
    params = [torch.nn.Parameter(t) for t in
              make_set(sbnet_shapes, cuda, seed=6)["params"]]
    opt = build_optimizer(LearningConfig(optimizer="adamw", lr=5e-5,
                                         wd=1e-3), params)
    launches = adam.adam_step.launches
    for _ in range(2):
        for p in params:
            p.grad = torch.full_like(p, 1e-3)
        opt.step()
    torch.cuda.synchronize()
    assert adam.adam_step.launches - launches == 2
    assert all(math.isfinite(float(p.detach().sum())) for p in params)
