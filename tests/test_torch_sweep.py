"""The port's sweeps (``sibrar_tpu_torch/sweep.py``, ``tpe.py``, the
``sweep_agent`` and ``run_agent`` CLIs, ``utils/process.py``) against the
JAX package's on the CPU: every sweep YAML of ``conf/sweeps/`` gives the
same config, trials and first TPE suggestion; the TPE past its startup
draws gives JAX's suggestions bit for bit; `run_sweep` on stub trials
leaves JAX's records, state files, observation log and model files; the
W&B agent with a fake ``wandb``; no trial of any registry family leaves a
tensor in a reference cycle; the CLIs end to end on a tiny MF sweep."""
import copy
import dataclasses
import gc
import glob
import importlib
import json
import os
import re
import signal
import subprocess
import sys
import textwrap
import time
import types

import numpy as np
import pytest
import torch
import yaml

from sibrar_tpu import sweep as jax_sweep
from sibrar_tpu import tpe as jax_tpe
from sibrar_tpu.config.loader import extend_by_base_configs as jax_extend
from sibrar_tpu.config.schema import ExperimentConfig as JaxExperimentConfig
from sibrar_tpu.config.schema import as_dict as jax_as_dict
from sibrar_tpu.config.schema import from_dict as jax_from_dict
from sibrar_tpu_torch import config_from_dict, experiment, sweep, tpe
from sibrar_tpu_torch.config.loader import extend_by_base_configs
from sibrar_tpu_torch.config.schema import ExperimentConfig, as_dict
from sibrar_tpu_torch.data.synthetic import (
    make_synthetic_splits,
    write_reference_artifacts,
)
from sibrar_tpu_torch.models.registry import ALGORITHMS
from sibrar_tpu_torch.utils.process import (
    on_parent_exit,
    terminate_process_group,
)
from test_torch_sbnet_serve import ROOT

SWEEP_FILES = sorted(
    p for p in glob.glob(os.path.join(ROOT, "conf", "sweeps", "**", "*.yml"),
                         recursive=True)
    if os.path.basename(p) != "MANIFEST.yml")
PACKAGES = {"jax": jax_sweep, "port": sweep}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the tiny real trials run beside other test
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bits(obj) -> str:
    """A value's repr: floats to the bit (-0.0, 1 against 1.0), dict key
    order too."""
    return repr(obj)


# ------------------------------------------------------------ paper grid
def test_paper_grid_is_the_repo_sweeps():
    assert len(SWEEP_FILES) == 162
    assert sum(sweep.load_sweep_config(p).method == "bayes"
               for p in SWEEP_FILES) == 130


@pytest.mark.parametrize("path", SWEEP_FILES,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_paper_grid_sweep_matches_jax(path):
    """The loaded sweep (its base chain folded in), its trials (grid and
    random: all of them; bayes: a fresh TPE's first suggestion) and trial
    0 merged into the base config, against JAX's."""
    want = jax_sweep.load_sweep_config(path)
    got = sweep.load_sweep_config(path)
    assert bits(dataclasses.asdict(got)) == bits(dataclasses.asdict(want))
    if got.method == "bayes":
        trials = [tpe.TPESampler(got.parameters, seed=0).suggest()]
        jax_trials = [jax_tpe.TPESampler(want.parameters, seed=0).suggest()]
    else:
        trials, jax_trials = (sweep.sample_trials(got),
                              jax_sweep.sample_trials(want))
    assert trials and bits(trials) == bits(jax_trials)
    conf = extend_by_base_configs(copy.deepcopy(got.base_config))
    jax_conf = jax_extend(copy.deepcopy(want.base_config))
    for key, value in trials[0].items():
        sweep._apply_param(conf, key, value)
        jax_sweep._apply_param(jax_conf, key, value)
    conf["run_id"] = jax_conf["run_id"] = "r"
    assert as_dict(config_from_dict(ExperimentConfig, conf)) == jax_as_dict(
        jax_from_dict(JaxExperimentConfig, jax_conf))


# ------------------------------------------------------------------- TPE
SPACES = {
    "log_int_uniform": {
        "learn.lr": {"min": 1e-5, "max": 1e-1,
                     "distribution": "log_uniform"},
        "model.embedding_dim": {"min": 4, "max": 64},
        "model.dropout": {"min": 0.0, "max": 0.5},
        "learn.n_epochs": 3},
    "list_categorical": {
        "dataset.train_modalities": {"values": [
            ["interactions"], ["interactions", "ivec256"], ["bert"],
            ["ivec256", "bert", "musicnn"]]},
        "model.item.aggregation_fn": {"values": ["mean", "max"]},
        "learn.lr": {"min": 1e-4, "max": 1e-2,
                     "distribution": "log_uniform"}},
}


def objective(params: dict) -> float:
    """A deterministic score of a trial's parameters."""
    v = 0.0
    for key, value in params.items():
        if isinstance(value, list):
            v -= abs(len(value) - 2) + 0.1 * len(value[0])
        elif isinstance(value, str):
            v += 0.3 if value == "max" else 0.0
        elif isinstance(value, float) and key.endswith("lr"):
            v -= abs(np.log10(value) + 3.0)
        elif isinstance(value, (int, float)):
            v -= abs(value - 24) / 24.0
    return v


@pytest.mark.parametrize("fail_every", [0, 3])
@pytest.mark.parametrize("space", sorted(SPACES))
def test_tpe_past_its_startup_is_jax_bit_for_bit(space, fail_every):
    """40 suggestions (8 startup draws, then 32 from the Parzen split) on
    the same observations, every third trial failed (None) where asked:
    the port's suggestions equal JAX's bit for bit."""
    params = SPACES[space]
    got, want = tpe.TPESampler(params, seed=5), jax_tpe.TPESampler(params,
                                                                   seed=5)
    for t in range(40):
        p, q = got.suggest(), want.suggest()
        assert bits(p) == bits(q), t
        value = (None if fail_every and t % fail_every == 0
                 else objective(p))
        got.observe(p, value)
        want.observe(q, value)


def test_sample_value_is_jax():
    rng, jax_rng = np.random.default_rng(9), np.random.default_rng(9)
    specs = [7, {"values": [[1], {"a": 2}, "x"]}, {"min": 2, "max": 9},
             {"min": 2, "max": 9, "distribution": "uniform"},
             {"min": 0.5, "max": 4.0, "distribution": "log_uniform"},
             {"min": 1e-3, "max": 1.0}]
    for spec in specs * 5:
        assert bits(tpe._sample_value(rng, spec)) == bits(
            jax_sweep._sample_value(jax_rng, spec))
    for bad in ({"max": 1}, {"mode": "x"}):
        for fn in (tpe._sample_value, jax_sweep._sample_value):
            with pytest.raises(ValueError, match="cannot sample"):
                fn(rng, bad)


# JAX's four TPE cases (tests/test_sweep_analysis.py), on the port
def test_tpe_converges_on_quadratic():
    spec = {"x": {"min": 0.0, "max": 1.0}}

    def run(sampler, n):
        xs = []
        for _ in range(n):
            p = sampler.suggest()
            sampler.observe(p, -(p["x"] - 0.7) ** 2)
            xs.append(p["x"])
        return xs

    xs = run(tpe.TPESampler(spec, seed=0), 40)
    assert abs(0.7 - xs[np.argmax([-(x - 0.7) ** 2 for x in xs])]) < 0.05
    late = np.asarray(xs[20:])
    assert np.mean(np.abs(late - 0.7) < 0.2) > 0.5
    xs_rand = run(tpe.TPESampler(spec, seed=0, n_startup=10 ** 9), 40)
    assert (np.mean(np.abs(np.asarray(xs_rand[20:]) - 0.7) < 0.2)
            < np.mean(np.abs(late - 0.7) < 0.2))


def test_tpe_categorical_concentrates():
    gains = {"a": 0.1, "b": 1.0, "c": 0.2, "d": 0.0}
    sampler = tpe.TPESampler({"c": {"values": ["a", "b", "c", "d"]}},
                             seed=1, n_startup=8)
    picks = []
    for _ in range(40):
        p = sampler.suggest()
        sampler.observe(p, gains[p["c"]])
        picks.append(p["c"])
    assert picks[20:].count("b") > 10


def test_tpe_log_uniform_and_int():
    spec = {"lr": {"min": 1e-5, "max": 1e-1, "distribution": "log_uniform"},
            "dim": {"min": 4, "max": 64}}
    sampler = tpe.TPESampler(spec, seed=2)
    best = (-np.inf, None)
    for _ in range(50):
        p = sampler.suggest()
        assert 1e-5 <= p["lr"] <= 1e-1
        assert isinstance(p["dim"], int) and 4 <= p["dim"] <= 64
        o = -abs(np.log10(p["lr"]) + 3.0) - abs(p["dim"] - 32) / 32.0
        sampler.observe(p, o)
        if o > best[0]:
            best = (o, p)
    assert abs(np.log10(best[1]["lr"]) + 3.0) < 1.0
    assert abs(best[1]["dim"] - 32) <= 16


def test_tpe_handles_failed_trials():
    sampler = tpe.TPESampler({"x": {"min": 0.0, "max": 1.0}}, seed=3,
                             n_startup=4)
    for i in range(12):
        p = sampler.suggest()
        sampler.observe(p, None if i % 3 == 0 else -(p["x"] - 0.3) ** 2)
    assert 0.0 <= sampler.suggest()["x"] <= 1.0


# ------------------------------------------------- run_sweep on stub trials
def stub_trial(metric="val/ndcg@10", missing=()):
    """A trial that writes ``conf.yml`` and both model files the port can
    leave (``model.pt``, ``model.npz``) and scores its parameters; trials
    whose index is in ``missing`` return no metric."""
    calls = []

    def run(conf):
        os.makedirs(conf.results_path, exist_ok=True)
        for name in ("conf.yml", "model.pt", "model.npz"):
            with open(os.path.join(conf.results_path, name), "w") as fh:
                fh.write("x")
        calls.append((conf.split_type.value, conf.dataset.dataset_path))
        if len(calls) - 1 in missing:
            return {}, {}
        v = float(-abs(np.log10(conf.learn.lr) + 2.0)
                  - abs(conf.model.get("embedding_dim", 16) - 16) / 16.0)
        return {metric: v}, {metric.replace("val/", "test/"): 2 * v}

    run.calls = calls
    return run


def trial_of(path: str) -> str:
    """A run directory's ``t{trial}`` (run ids are ``{time}_t{trial}``)."""
    run_id = os.path.basename(path)
    assert re.fullmatch(r"\d{6}-\d{6}_t\d+", run_id), run_id
    return run_id.rsplit("_", 1)[1]


def normalized(obj, base: str):
    """Records, state files and log lines with each results path replaced
    by its trial (paths carry a timestamp)."""
    if isinstance(obj, dict):
        return {k: (trial_of(v) if k == "results_path" else
                    normalized(v, base)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [normalized(v, base) for v in obj]
    return obj


def leftovers(base: str) -> dict:
    """What a sweep left in ``results_base``: the state files and the
    observation log (normalized), and each run's files."""
    out = {}
    for name in sorted(os.listdir(base)):
        path = os.path.join(base, name)
        if name.startswith("sweep_state"):
            with open(path) as fh:
                out[name] = normalized(yaml.safe_load(fh), base)
        elif name == "observations.jsonl":
            with open(path) as fh:
                out[name] = [normalized(json.loads(ln), base) for ln in fh]
        elif os.path.isdir(path):
            out[trial_of(path)] = sorted(os.listdir(path))
    return dict(sorted(out.items()))  # run ids sort by their time first


def both(tmp_path, config: dict, calls=({},), missing=(), metric=None):
    """The same sweep in each package (one ``run_sweep`` per entry of
    ``calls``, its keyword arguments, all on one results base): the
    records of each call, normalized, and what the base holds after."""
    out = {}
    for name, mod in PACKAGES.items():
        base = str(tmp_path / name)
        run = stub_trial(**({"metric": metric} if metric else {}),
                         missing=missing)
        records = [normalized(mod.run_sweep(
            mod.SweepConfig(**copy.deepcopy(config)), base, run_fn=run,
            **kw), base) for kw in calls]
        out[name] = (records, leftovers(base), run.calls)
    assert bits(out["port"]) == bits(out["jax"])
    return out["port"]


def test_run_sweep_grid_order_and_retention_match_jax(tmp_path):
    records, left, _ = both(tmp_path, dict(
        method="grid", keep_top_runs=2, parameters={
            "learn.lr": {"values": [0.1, 0.003, 0.01]},
            "model.embedding_dim": {"values": [8, 16]}},
        base_config={"algorithm": "mf"}))
    (records,) = records
    assert [r["trial"] for r in records] == [5, 4, 3, 1, 2, 0]
    kept = [t for t, files in left.items() if "model.pt" in files]
    assert sorted(kept) == ["t4", "t5"]
    assert all(files in (["conf.yml"],
                         ["conf.yml", "model.npz", "model.pt"])
               for t, files in left.items() if t.startswith("t"))
    assert len(left["sweep_state.yml"]["records"]) == 6


def test_run_sweep_random_matches_jax(tmp_path):
    records, left, _ = both(tmp_path, dict(
        method="random", n_trials=5, seed=3, keep_top_runs=1, parameters={
            "learn.lr": {"min": 1e-4, "max": 1e-1,
                         "distribution": "log_uniform"},
            "model.embedding_dim": {"min": 4, "max": 32},
            "learn.rec_loss": {"values": ["bpr", "sampled_softmax"]}},
        base_config={"algorithm": "mf"}), calls=(
            {"max_trials": 2}, {"trial_offset": 2}))
    assert [len(r) for r in records] == [2, 3]
    # each worker keeps its own best
    assert sum("model.pt" in f for f in left.values()) == 2
    assert set(left) == {"sweep_state.yml", "sweep_state_t2.yml", "t0", "t1",
                         "t2", "t3", "t4"}


def test_run_sweep_paired_parameters_match_jax(tmp_path):
    _, _, calls = both(tmp_path, dict(
        method="grid", parameters={"_paired_split": {"values": [
            {"split_type": "random",
             "dataset.dataset_path": "/data/x/random_split"},
            {"split_type": "cold_start_item",
             "dataset.dataset_path": "/data/x/cold_start_item"}]}},
        base_config={"algorithm": "pop"}))
    assert calls == [("random", "/data/x/random_split"),
                     ("cold_start_item", "/data/x/cold_start_item")]


def test_minimize_ranks_a_missing_metric_last_as_jax(tmp_path):
    (records,), _, _ = both(tmp_path, dict(
        method="grid", metric="val/loss", goal="minimize", keep_top_runs=1,
        parameters={"learn.lr": {"values": [0.1, 0.2, 0.01]}},
        base_config={"algorithm": "mf"}), missing=(0,), metric="val/loss")
    assert records[-1]["metrics"] == {} and records[-1]["trial"] == 0
    assert records[0]["trial"] == 1


def test_unknown_sweep_method_raises_as_jax(tmp_path):
    for mod in PACKAGES.values():
        config = mod.SweepConfig(method="hyperband",
                                 parameters={"x": {"values": [1]}})
        with pytest.raises(ValueError, match="unknown sweep method"):
            mod.run_sweep(config, str(tmp_path), run_fn=lambda c: ({}, {}))
        with pytest.raises(ValueError, match="cannot pre-sample"):
            mod.sample_trials(config)
        with pytest.raises(ValueError, match="explicit 'values'"):
            mod.sample_trials(mod.SweepConfig(
                method="grid", parameters={"x": {"min": 0, "max": 1}}))


BAYES = dict(method="bayes", n_trials=20, keep_top_runs=3, seed=4,
             parameters={"learn.lr": {"min": 1e-4, "max": 1e-1,
                                      "distribution": "log_uniform"},
                         "model.embedding_dim": {"values": [8, 16, 32]}},
             base_config={"algorithm": "mf"})


def test_bayes_shards_match_jax(tmp_path):
    """Two independent workers (offsets 0 and 10, seeds offset-
    decorrelated), each past the 8 startup draws."""
    records, left, _ = both(tmp_path, BAYES, calls=(
        {"max_trials": 10}, {"trial_offset": 10, "max_trials": 25}))
    assert [sorted(r["trial"] for r in rs) for rs in records] == [
        list(range(10)), list(range(10, 20))]
    assert "observations.jsonl" not in left
    assert sum("model.pt" in f for f in left.values()) == 6


def test_shared_history_matches_jax(tmp_path):
    """Two workers in turn on one base with a shared, file-locked log: the
    second conditions on the first's trials and retention ranks all
    twenty together."""
    records, left, _ = both(tmp_path, {**BAYES, "shared_history": True},
                            calls=({"max_trials": 10},
                                   {"trial_offset": 10}))
    log = left["observations.jsonl"]
    assert [r["trial"] for r in log] == list(range(20))
    assert set(log[0]) == {"trial", "params", "value", "metric",
                           "results_path"}
    best = {r["results_path"] for r in sorted(
        log, key=lambda r: r["value"], reverse=True)[:3]}
    assert {t for t, f in left.items() if "model.pt" in f} == best
    # the second worker's first trial: a TPE of its (worker, trial) seed
    # over the first worker's ten observations, past its startup draws
    replay = tpe.TPESampler(BAYES["parameters"], seed=4 + 7919 * 10)
    for rec in log[:10]:
        replay.observe(rec["params"], rec["value"])
    assert bits(replay.suggest()) == bits(log[10]["params"])


def test_shared_log_concurrent_workers(tmp_path):
    """Two processes append to one log at once: every line whole, no
    record lost or doubled."""
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        from sibrar_tpu_torch.sweep import SharedObservationLog
        log = SharedObservationLog(sys.argv[2])
        for t in range(200):
            log.append({{"trial": int(sys.argv[1]) * 1000 + t,
                         "pad": "x" * 3000}})
    """))
    procs = [subprocess.Popen([sys.executable, str(script), str(w),
                               str(tmp_path)]) for w in (0, 1)]
    for p in procs:
        assert p.wait(timeout=120) == 0
    got = sorted(r["trial"] for r in sweep.SharedObservationLog(
        str(tmp_path)).read())
    assert got == sorted(w * 1000 + t for w in (0, 1) for t in range(200))


# ----------------------------------------------------------- the W&B agent
class _FakeConfig(dict):
    def update(self, d, allow_val_change=False):
        dict.update(self, d)


def fake_wandb(config: dict, top_ids=None):
    """A ``wandb`` module whose run is ``r123`` of sweep ``s1``; its API
    ranks ``top_ids`` on top, or raises (offline) when None."""
    run = types.SimpleNamespace(id="r123", project="proj", entity="ent",
                                sweep_id="s1", tags=(), log=lambda d: None,
                                finish=lambda: None)
    mod = types.ModuleType("wandb")
    mod.config = _FakeConfig(config)
    mod.init = lambda **kw: run
    mod.finish = lambda: None

    class Api:
        def __init__(self):
            if top_ids is None:
                raise RuntimeError("offline: no W&B API")

        def sweep(self, path):
            return types.SimpleNamespace(order="-summary_metrics.val")

        def runs(self, path, per_page, order, filters):
            return [types.SimpleNamespace(id=i) for i in top_ids]

    mod.Api = Api
    return mod


def wandb_config(art: str, results: str) -> dict:
    return {"_wandb": {"internal": True}, "algorithm_type": "mf",
            "dataset_path": art, "split_type": "random",
            "results_path": results, "learn.lr": 0.01, "learn.n_epochs": 1,
            "model.embedding_dim": 8, "loader.batch_size": 32,
            "eval.top_k": [10], "eval.metrics": ["ndcg", "recall"],
            "run_settings.device": "cpu"}


@pytest.mark.parametrize("top_ids", [None, ["r123"], ["other"]],
                         ids=["offline", "in_top", "outside_top"])
def test_wandb_agent_matches_jax(tmp_path, monkeypatch, top_ids):
    """The resolved config pushed back to W&B equals JAX's (dotted keys
    expanded; ``algorithm_type``, ``dataset_path``, ``split_type`` popped
    and set); the model files stay unless the API ranks the run outside
    the top."""
    pushed = {}
    for name, module in (("jax", "sibrar_tpu"), ("port", "sibrar_tpu_torch")):
        results = str(tmp_path / "run")
        fake = fake_wandb(wandb_config("/data/x", results), top_ids)
        monkeypatch.setitem(sys.modules, "wandb", fake)

        def stub(conf):
            os.makedirs(conf.results_path, exist_ok=True)
            for f in ("model.pt", "model.npz", "metrics_test.yml"):
                open(os.path.join(conf.results_path, f), "w").close()
            return {"val/ndcg@10": 0.5}, {"test/ndcg@10": 0.4}

        monkeypatch.setattr(f"{module}.experiment.run_train_val_test", stub)
        agent = importlib.import_module(f"{module}.sweep")
        assert agent.wandb_train_val_agent(keep_top_runs=3) == (
            {"val/ndcg@10": 0.5}, {"test/ndcg@10": 0.4})
        pushed[name] = dict(fake.config)
        assert sorted(os.listdir(results)) == (
            ["metrics_test.yml"] if top_ids == ["other"]
            else ["metrics_test.yml", "model.npz", "model.pt"])
        for f in os.listdir(results):
            os.remove(os.path.join(results, f))
    assert pushed["port"] == pushed["jax"]
    conf = pushed["port"]
    assert (conf["algorithm"], conf["split_type"], conf["run_id"]) == (
        "mf", "random", "r123")
    assert conf["dataset"]["dataset_path"] == "/data/x"
    assert conf["wandb"]["sweep_id"] == "s1" and conf["wandb"]["use_wandb"]
    assert conf["model"] == {"embedding_dim": 8}
    assert (conf["learn"]["lr"], conf["eval"]["top_k"]) == (0.01, [10])


@pytest.fixture(scope="module")
def mf_artifacts(tmp_path_factory):
    art = str(tmp_path_factory.mktemp("sweep_data"))
    write_reference_artifacts(art, make_synthetic_splits(
        n_users=40, n_items=50, n_interactions=800, seed=2))
    return art


def test_wandb_agent_trains_for_real(tmp_path, monkeypatch, mf_artifacts):
    """A real MF trial on the CPU under the fake agent, the API offline:
    finite metrics, the model file kept."""
    fake = fake_wandb(wandb_config(mf_artifacts, str(tmp_path / "run")))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    val, test = sweep.wandb_train_val_agent(keep_top_runs=3)
    assert np.isfinite(val["val/ndcg@10"]) and np.isfinite(
        test["test/ndcg@10"])
    assert sorted(os.listdir(tmp_path / "run")) == [
        "conf.yml", "metrics_test.yml", "metrics_val.yml", "model.pt"]


def test_wandb_agent_without_wandb_points_to_the_local_mode(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(RuntimeError, match="sibrar_tpu_torch.sweep_agent"):
        sweep.wandb_train_val_agent()


# --------------------------------------------------- memory between trials
FAMILY_MODELS = {
    "sbnet": {"shared_common_dim": 4,
              "user": {"feature_name": "user_embedding", "embedding_dim": 4},
              "item": {"features": [{"feature_name": "audio",
                                     "feature_hidden_layers": [8]}],
                       "single_branch_hidden_layers": [8],
                       "common_modality_dim": 4}},
    "mf": {"embedding_dim": 4}, "acf": {"embedding_dim": 4},
    "dmf": {"u_mid_layers": [8], "final_dimension": 4},
    "ifeatmf": {"feature_name": "audio", "embedding_dim": 4},
    "ufeatmf": {"feature_name": "profile_vec", "embedding_dim": 4},
    "dropoutnet": {"shared_common_dim": 4, **{side: {
        "features": [{"feature_name": f, "embedding_dim": 2}],
        "preference_layers": [8], "common_hidden_layers": [4]}
        for side, f in (("item", "audio"), ("user", "gender"))}},
    "ecf": {"embedding_dim": 4, "n_clusters": 5, "top_n": 2, "top_m": 2,
            "top_p": 2, "tag_feature": "genres"},
    "uknn": {"k": 3}, "iknn": {"k": 3},
    "ifknn": {"k": 3, "feature_name": "genres"}, "ease": {"lam": 1.0},
    "als": {"factors": 3, "alpha": 1.0, "regularization": 0.1,
            "n_iterations": 1},
    "rbmf": {"n_representatives": 3}, "svd": {"factors": 3},
    "slim": {"alpha": 1.0, "l1_ratio": 0.1, "max_iter": 5},
    "p3alpha": {"alpha": 1.0, "beta": 0.5},
    **{name: {"embedding_dim": 4, "n_prototypes": 3, "u_n_prototypes": 3,
              "i_n_prototypes": 2}
       for name in ("uprotomf", "iprotomf", "uiprotomf", "uprotomfs",
                    "iprotomfs", "uiprotomfs")}}


def live_tensors() -> int:
    """Tensors the garbage collector tracks, reachable or in cycles."""
    return sum(issubclass(type(o), torch.Tensor) for o in gc.get_objects())


def family_conf(name: str, art: str, results: str) -> ExperimentConfig:
    return config_from_dict(ExperimentConfig, {
        "algorithm": name, "model": FAMILY_MODELS.get(name, {}),
        "dataset": {"dataset_path": art, "n_negative_samples": 2,
                    "item_features": [{"name": "audio", "type": "vector"},
                                      {"name": "genres", "type": "tag"}],
                    "user_features": [{"name": "profile_vec",
                                       "type": "vector"},
                                      {"name": "gender",
                                       "type": "categorical"}]},
        "learn": {"n_epochs": 1, "max_batches_per_epoch": 2},
        "eval": {"top_k": [10], "group_metrics": []},
        "loader": {"batch_size": 16, "eval_batch_size": 16},
        "run_settings": {"device": "cpu"}, "results_path": results})


@pytest.fixture(scope="module")
def zoo_artifacts(tmp_path_factory):
    art = str(tmp_path_factory.mktemp("zoo_data"))
    write_reference_artifacts(art, make_synthetic_splits(
        n_users=30, n_items=40, n_interactions=300))
    # the ProtoMF diagnostics import these on first use; a first import's
    # cycles would hold the frames of the trial that made it
    for module in ("matplotlib.pyplot", "sklearn.manifold"):
        try:
            importlib.import_module(module)
        except ImportError:
            pass
    return art


def test_registry_is_the_families_checked():
    assert set(FAMILY_MODELS) | {"sgdbias", "pop", "rand"} == set(ALGORITHMS)


@pytest.mark.parametrize("name", sorted(ALGORITHMS))
def test_a_trial_frees_its_tensors_without_the_collector(name, tmp_path,
                                                         zoo_artifacts):
    """``run_train_val_test`` of every registry family with the garbage
    collector off leaves no tensor behind: reference counting alone frees
    the trial's model, optimizer state, device data and encoded catalog,
    so a sweep's next trial never finds the last one's tensors on the
    card (``ScoreFn`` once kept a bound method of itself, a cycle that
    held all of them)."""
    conf = family_conf(name, zoo_artifacts, str(tmp_path / "run"))
    gc.collect()
    before = live_tensors()
    gc.disable()
    try:
        val, test = experiment.run_train_val_test(conf)
        del val, test
        left = live_tensors()
    finally:
        gc.enable()
    assert left == before


def test_run_sweep_leaves_no_tensor_between_trials(tmp_path, zoo_artifacts):
    """A real three-trial SBNet grid sweep: every trial starts with the
    tensors the first started with, and the sweep leaves none."""
    seen = []

    def run(conf):
        seen.append(live_tensors())
        return experiment.run_train_val_test(conf)

    base = family_conf("sbnet", zoo_artifacts, "")
    config = sweep.SweepConfig(
        method="grid", keep_top_runs=1,
        parameters={"learn.lr": {"values": [1e-3, 1e-2, 1e-1]}},
        base_config={k: v for k, v in as_dict(base).items()
                     if k != "results_path"})
    gc.collect()
    start = live_tensors()
    records = sweep.run_sweep(config, str(tmp_path), run_fn=run)
    assert seen == [start] * 3 and live_tensors() == start
    assert sum(os.path.exists(os.path.join(r["results_path"], "model.pt"))
               for r in records) == 1


# ------------------------------------------------------------------ CLIs
def mf_sweep_file(tmp_path, art: str, **changes) -> str:
    conf = {"method": "grid", "metric": "val/ndcg@10", "keep_top_runs": 1,
            "parameters": {"model.embedding_dim": {"values": [4, 8]}},
            "base_config": {
                "algorithm": "mf",
                "dataset": {"dataset_path": art, "n_negative_samples": 2},
                "learn": {"n_epochs": 1, "rec_loss": "bpr",
                          "optimizing_metric": "ndcg@10"},
                "eval": {"top_k": [10], "metrics": ["ndcg"],
                         "group_metrics": []},
                "loader": {"batch_size": 32, "eval_batch_size": 64},
                "run_settings": {"device": "cpu"}}, **changes}
    path = tmp_path / "sweep.yml"
    path.write_text(yaml.safe_dump(conf))
    return str(path)


BLOCKED_AGENT = r"""
import runpy, sys
for name in ("jax", "flax", "optax", "pandas", "sibrar_tpu"):
    sys.modules[name] = None  # any import of these now fails
sys.argv = ["sweep_agent"] + ARGS
runpy.run_module("sibrar_tpu_torch.sweep_agent", run_name="__main__")
"""

CPU_ENV = {"PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}


def test_sweep_agent_cli_runs_a_tiny_mf_sweep(tmp_path, mf_artifacts):
    """``python -m sibrar_tpu_torch.sweep_agent -c -o`` with jax, flax,
    optax, pandas and ``sibrar_tpu`` blocked: two grid trials, the best
    trial's JSON line last, its run the one that keeps ``model.pt``."""
    runs = tmp_path / "runs"
    args = ["-c", mf_sweep_file(tmp_path, mf_artifacts), "-o", str(runs)]
    proc = subprocess.run(
        [sys.executable, "-c", f"ARGS = {args!r}\n" + BLOCKED_AGENT],
        capture_output=True, text=True, cwd=tmp_path, timeout=300,
        env={**os.environ, **CPU_ENV})
    assert proc.returncode == 0, proc.stderr[-3000:]
    best = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(best) == {"best_trial", "params", "metric", "value"}
    assert best["metric"] == "val/ndcg@10" and np.isfinite(best["value"])
    dirs = sorted(d for d in os.listdir(runs) if (runs / d).is_dir())
    assert [trial_of(d) for d in dirs] == ["t0", "t1"]
    for d in dirs:
        files = sorted(os.listdir(runs / d))
        keep = d.endswith(f"_t{best['best_trial']}")
        assert files == ["conf.yml", "metrics_test.yml", "metrics_val.yml",
                         *(["model.pt"] if keep else [])]
        if keep:
            with open(runs / d / "metrics_val.yml") as fh:
                assert yaml.safe_load(fh)["val/ndcg@10"] == best["value"]
    with open(runs / "sweep_state.yml") as fh:
        assert len(yaml.safe_load(fh)["records"]) == 2


def test_sweep_agent_arguments(monkeypatch):
    from sibrar_tpu_torch import sweep_agent

    called = {}
    monkeypatch.setattr(sweep, "wandb_train_val_agent",
                        lambda keep_top_runs=10: called.update(
                            keep=keep_top_runs))
    sweep_agent.main(["--wandb-agent", "--keep-top-runs", "5"])
    assert called == {"keep": 5}
    with pytest.raises(SystemExit):
        sweep_agent.main([])


def test_run_agent_launches_two_workers(tmp_path, mf_artifacts):
    """``python -m sibrar_tpu_torch.run_agent -p 2 --trials-per-worker 1``
    from another directory: both workers exit 0 and each writes its own
    state file."""
    runs = tmp_path / "runs"
    proc = subprocess.run(
        [sys.executable, "-m", "sibrar_tpu_torch.run_agent", "-c",
         mf_sweep_file(tmp_path, mf_artifacts), "-o", str(runs), "-p", "2",
         "--trials-per-worker", "1", "--devices", "0,0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300,
        env={**os.environ, **CPU_ENV})
    assert proc.returncode == 0, proc.stderr[-3000:]
    for i in (0, 1):
        assert f"worker {i} finished with code 0" in proc.stdout
    for name, trial in (("sweep_state.yml", 0), ("sweep_state_t1.yml", 1)):
        with open(runs / name) as fh:
            assert [r["trial"] for r in yaml.safe_load(fh)["records"]] == [
                trial]
    with pytest.raises(SystemExit):
        from sibrar_tpu_torch import run_agent

        run_agent.main(["-c", "x.yml", "-o", "out"])  # no shard size


# ------------------------------------------------------- utils/process.py
def test_terminate_process_group_kills_the_session():
    child = subprocess.Popen(["sleep", "60"], start_new_session=True)
    terminate_process_group(child)
    assert child.wait(timeout=30) == -signal.SIGTERM
    terminate_process_group(child)  # a group that is gone is ignored


def dead(pid: int) -> bool:
    """Gone, or a zombie waiting for its new parent to reap it."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def test_on_parent_exit_takes_the_grandchild_down(tmp_path):
    script = tmp_path / "parent.py"
    script.write_text(textwrap.dedent(f"""
        import subprocess, sys, time
        sys.path.insert(0, {ROOT!r})
        from sibrar_tpu_torch.utils.process import on_parent_exit
        child = subprocess.Popen(["sleep", "60"],
                                 preexec_fn=on_parent_exit())
        print(child.pid, flush=True)
        time.sleep(0.5)
    """))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    pid = int(proc.stdout.split()[0])
    deadline = time.monotonic() + 30
    while not dead(pid) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert dead(pid)
    assert callable(on_parent_exit(signal.SIGKILL))
