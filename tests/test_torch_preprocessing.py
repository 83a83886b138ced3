"""The port's preprocessing against the JAX package's, on the CPU.

Each case of ``tests/test_preprocessing.py`` and
``tests/test_preprocess_e2e.py`` feeds the same seeded numpy raw data to
``sibrar_tpu.preprocessing`` and ``sibrar_tpu_torch.preprocessing``
(``device="cpu"``): the stages' frames equal with their index labels, and
the artifact trees of the two CLIs equal file by file (CSV text and
``used_config.yaml`` byte for byte, ``.npz`` arrays with their dtypes:
the zip headers carry the write time). On top: a matrix of pipelines over
random, temporal and the three cold-start splits, dedup on and off,
k-core 0 and 5, min-count 1 and 2, string ids and input with no
``timestamp`` column; the ML-1M, Onion and Amazon parsers; the shipped
``conf/preprocessing/*.yml``; the downloaders behind their gates (the
fetch monkeypatched); the port's CLI run with jax, flax, optax and
``sibrar_tpu`` blocked; and no fallback to the CPU without a card.
"""
import bz2
import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

import preprocess_dataset as jax_cli
from sibrar_tpu.config.schema import FeatureDefinition as JaxFeatureDefinition
from sibrar_tpu.config.schema import FeatureType as JaxFeatureType
from sibrar_tpu.config.schema import from_dict as jax_from_dict
from sibrar_tpu.data.feature import Feature as JaxFeature
from sibrar_tpu.preprocessing import downloaders as jdl
from sibrar_tpu.preprocessing import filtering as jf
from sibrar_tpu.preprocessing import normalization as jn
from sibrar_tpu.preprocessing import ppconfig as jpp
from sibrar_tpu.preprocessing import records as jr
from sibrar_tpu.preprocessing import splitting as js
from sibrar_tpu.preprocessing import text_features as jtext
from sibrar_tpu.utils import misc as jmisc
from sibrar_tpu_torch import config_from_dict
from sibrar_tpu_torch import preprocess_dataset as port_cli
from sibrar_tpu_torch.config.schema import FeatureDefinition, FeatureType
from sibrar_tpu_torch.config.schema import as_dict
from sibrar_tpu_torch.data.feature import build_feature
from sibrar_tpu_torch.preprocessing import downloaders as pdl
from sibrar_tpu_torch.preprocessing import filtering as pf
from sibrar_tpu_torch.preprocessing import normalization as pn
from sibrar_tpu_torch.preprocessing import pipeline as ppipe
from sibrar_tpu_torch.preprocessing import ppconfig as ppp
from sibrar_tpu_torch.preprocessing import records as pr
from sibrar_tpu_torch.preprocessing import splitting as ps
from sibrar_tpu_torch.preprocessing import text_features as ptext
from sibrar_tpu_torch.utils import misc as pmisc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PP_CONF = os.path.join(ROOT, "conf", "preprocessing")


# ------------------------------------------------------------------ helpers
def assert_same_tree(a, b) -> list:
    """Every file under ``a`` and ``b`` but the CLI logs equal: CSV / YAML
    text byte for byte, ``.npz`` arrays with their dtypes; the files
    compared."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs
                      if not (f.startswith("preprocess_")
                              and f.endswith(".log")))

    names = files(a)
    assert names == files(b)
    assert names
    for name in names:
        x, y = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".npz"):
            with np.load(x, allow_pickle=True) as p, \
                    np.load(y, allow_pickle=True) as q:
                assert p.files == q.files, name
                for key in p.files:
                    assert p[key].dtype == q[key].dtype, (name, key)
                    assert p[key].shape == q[key].shape, (name, key)
                    if p[key].dtype == object:  # string ids
                        assert p[key].tolist() == q[key].tolist(), name
                    else:
                        assert p[key].tobytes() == q[key].tobytes(), name
        else:
            with open(x, "rb") as fx, open(y, "rb") as fy:
                assert fx.read() == fy.read(), name
    return names


def run_both_clis(raw, out, args):
    """The root CLI into ``out/jax``, the port's (``--device cpu``) into
    ``out/port``; both trees compared."""
    jax_cli.main(["-d", str(raw), "-o", str(out / "jax"), *args])
    port_cli.main(["-d", str(raw), "-o", str(out / "port"), *args,
                   "--device", "cpu"])
    return assert_same_tree(out / "jax", out / "port")


def write_conf(path, conf: dict) -> str:
    with open(path, "w") as fh:
        yaml.safe_dump(conf, fh)
    return str(path)


def coded(lhs):
    return pf.encode_interactions(lhs, "cpu")


def _lhs(rows):
    return pd.DataFrame(rows, columns=["user", "item", "timestamp"])


def assert_same_features(a, b):
    if a.tabular is None:
        assert b.tabular is None
    else:
        pd.testing.assert_frame_equal(a.tabular, b.tabular)
    assert list(a.multidimensional) == list(b.multidimensional)
    for name, f in a.multidimensional.items():
        g = b.multidimensional[name]
        for x, y in ((f.indices, g.indices), (f.values, g.values)):
            assert np.asarray(x).dtype == np.asarray(y).dtype
            np.testing.assert_array_equal(x, y)


def assert_same_splits(a, b):
    for (name, x), (_, y) in zip(a.items(), b.items()):
        pd.testing.assert_frame_equal(x.interactions, y.interactions,
                                      obj=name)
        np.testing.assert_array_equal(x.user_indices, y.user_indices)
        np.testing.assert_array_equal(x.item_indices, y.item_indices)
        assert_same_features(x.user_features, y.user_features)
        assert_same_features(x.item_features, y.item_features)


# ------------------------------------------- stages (test_preprocessing.py)
def _random_lhs(seed=0, n=600, n_users=30, n_items=40, ties=True):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, n // 4, n) if ties else rng.permutation(n)
    return _lhs(list(zip(rng.integers(0, n_users, n).tolist(),
                         rng.integers(0, n_items, n).tolist(), t.tolist())))


STAGE_CASES = {
    "unique_keeps_earliest": ("unique", _lhs([(1, 1, 5), (1, 1, 2),
                                              (2, 1, 3)])),
    "unique_random": ("unique", _random_lhs(1, ties=False)),
    "min_interactions": ("min2", _lhs([(1, 1, 0), (1, 1, 1), (1, 2, 2),
                                        (2, 1, 3)])),
    "min_interactions_random": ("min2", _random_lhs(2)),
    "k_core": ("kcore5", _random_lhs(0, n=500)),
    # a 5 x 5 grid (every count exactly k), a user and an item with 4 rows
    # each, and a user whose rows go with that item's
    "k_core_boundary": ("kcore5", _lhs(
        [(u, i, 5 * u + i) for u in range(5) for i in range(5)]
        + [(9, i, 40 + i) for i in range(4)]
        + [(u, 9, 50 + u) for u in range(4)]
        + [(8, i, 60 + i) for i in (0, 1, 2, 3, 9)])),
    "create_index_small": ("index", _lhs([(9, 7, 1), (3, 7, 0), (9, 5, 2)])),
    "create_index_random": ("index", _random_lhs(3)),
}


@pytest.mark.parametrize("case", sorted(STAGE_CASES))
def test_interaction_stages_equal_jax(case):
    """`filter_unique`, `filter_min_interactions`, `filter_k_core` and
    `create_index` on codes: JAX's frames, rows in JAX's order with their
    labels (create_index's id maps too)."""
    stage, lhs = STAGE_CASES[case]
    if stage == "unique":
        pd.testing.assert_frame_equal(
            pf.filter_unique(coded(lhs)).to_frame(), jf.filter_unique(lhs))
    elif stage == "min2":
        pd.testing.assert_frame_equal(
            pf.filter_min_interactions(coded(lhs), 2).to_frame(),
            jf.filter_min_interactions(lhs, 2))
    elif stage == "kcore5":
        pd.testing.assert_frame_equal(
            pf.filter_k_core(coded(lhs), 5).to_frame(),
            jf.filter_k_core(lhs, 5))
    else:
        for got, want in zip(pf.create_index(coded(lhs)),
                             jf.create_index(lhs)):
            pd.testing.assert_frame_equal(got, want)


def test_dedup_on_timestamp_ties_indexes_as_jax():
    """Rows of one timestamp: pandas' one-column sort is unstable and this
    one stable, so dedup may order ties apart; the indexed frame and the
    id maps after `create_index` are JAX's all the same."""
    lhs = _random_lhs(4, n=2000, n_users=20, n_items=25)
    lhs = pd.concat([lhs, lhs.iloc[::3]], ignore_index=True)  # repeats
    got = pf.create_index(pf.filter_unique(coded(lhs)))
    want = jf.create_index(jf.filter_unique(lhs))
    for g, w in zip(got, want):
        pd.testing.assert_frame_equal(g, w)


def _raw_indexed(pkg, n_users=30, n_items=40, n=600, seed=0,
                 with_features=True):
    """`tests/test_preprocessing.py`'s indexed raw data, made by ``pkg``
    (``jf`` or ``pf``)."""
    rng = np.random.default_rng(seed)
    pairs = sorted({(int(u), int(i)) for u, i in zip(
        rng.integers(0, n_users, n), rng.integers(0, n_items, n))})
    lhs = _lhs([(u, i, t) for t, (u, i) in enumerate(pairs)])
    if pkg is jf:
        indexed, user_idxs, item_idxs = jf.create_index(lhs)
        rec = jr
    else:
        indexed, user_idxs, item_idxs = pf.create_index(coded(lhs))
        rec = pr
    uf, itf = rec.EntityFeatures(), rec.EntityFeatures()
    if with_features:
        uf = rec.EntityFeatures(multidimensional={"vec": rec.MultiDFeature(
            user_idxs.user.to_numpy(),
            rng.normal(size=(len(user_idxs), 4)).astype(np.float32))})
        itf = rec.EntityFeatures(multidimensional={"vec": rec.MultiDFeature(
            item_idxs.item.to_numpy(),
            rng.normal(size=(len(item_idxs), 4)).astype(np.float32) * 10
            + 5)})
        uf = pkg.reindex_features("user", uf, user_idxs)
        itf = pkg.reindex_features("item", itf, item_idxs)
    return rec.RawData(interactions=indexed, user_features=uf,
                       item_features=itf)


SPLITS = {
    "temporal": dict(split_type="temporal"),
    "random": dict(split_type="random"),
    "cold_user": dict(ratios=[0.7, 0.15, 0.15], split_type="coldstart",
                      cold_start_type="user"),
    "cold_item": dict(ratios=[0.7, 0.15, 0.15], split_type="coldstart",
                      cold_start_type="item"),
    "cold_both": dict(ratios=[0.7, 0.15, 0.15], split_type="coldstart",
                      cold_start_type="both"),
}


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_splits_equal_jax(split):
    """`split_ratio_based` (the per-user ratio sizing, the shuffle, the
    cold-start bands and their features): every split's frame with its
    labels, indices and features equal JAX's."""
    with_features = split.startswith("cold")
    got = ps.split_ratio_based(
        _raw_indexed(pf, with_features=with_features),
        config_from_dict(ppp.SplitConfig, SPLITS[split]), device="cpu")
    want = js.split_ratio_based(
        _raw_indexed(jf, with_features=with_features),
        jax_from_dict(jpp.SplitConfig, SPLITS[split]))
    assert_same_splits(got, want)
    assert sum(len(s.interactions) for _, s in got.items()) > 0


def test_random_split_draws_pandas_sample():
    """The shuffle is ``DataFrame.sample(frac=1.0, random_state=seed)``'s."""
    frame = pd.DataFrame({"a": np.arange(1000)})
    for seed in (0, 13, 42):
        np.testing.assert_array_equal(
            frame.sample(frac=1.0, random_state=seed).index.to_numpy(),
            np.random.RandomState(seed).choice(1000, size=1000,
                                               replace=False))


def test_normalizers_equal_jax():
    x = np.array([[1.0], [2.0], [3.0], [10.0]])
    v = np.random.default_rng(0).normal(size=(50, 6)).astype(np.float32)
    for kind, params in (("standard", None), ("minmax", None),
                         ("minmax", {"feature_range": (-1.0, 2.0)}),
                         ("robust", None), ("normal", None),
                         ("identity", None), (None, None)):
        for data in (x, v):
            got = pn.get_normalizer(kind, params).fit(data).transform(data)
            want = jn.get_normalizer(kind, params).fit(data).transform(data)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    for mod in (pn, jn):
        with pytest.raises(ValueError, match="not supported"):
            mod.get_normalizer("zscore")


@pytest.mark.parametrize("split", ["coldstart", "random"])
def test_normalization_leakage_rule_equals_jax(split):
    """Cold-start fits on train only, warm splits on all: the port's
    normalized features are JAX's."""
    conf = {"split": {"ratios": [0.7, 0.15, 0.15], "split_type": split,
                      "cold_start_type": "item"},
            "item_features": [{"name": "vec",
                               "normalization": [{"kind": "standard"}]}]}
    out = []
    for pkg, sp, nm, cfg in (
            (pf, ps, pn, config_from_dict(ppp.PreprocessingConfig, conf)),
            (jf, js, jn, jax_from_dict(jpp.PreprocessingConfig, conf))):
        kw = {"device": "cpu"} if pkg is pf else {}
        splits = sp.split_ratio_based(_raw_indexed(pkg, seed=3), cfg.split,
                                      **kw)
        out.append(nm.normalize_features(splits, cfg))
    assert_same_splits(*out)


def test_config_and_its_errors_equal_jax():
    """Every shipped preprocessing YAML loads to JAX's config (as dicts),
    and a bad split raises in both."""
    for name in sorted(os.listdir(PP_CONF)):
        with open(os.path.join(PP_CONF, name)) as fh:
            raw = yaml.safe_load(fh)
        got = config_from_dict(ppp.PreprocessingConfig, raw)
        want = jax_from_dict(jpp.PreprocessingConfig, raw)
        assert as_dict(got) == jpp_as_dict(want)
    for bad in ({"ratios": [0.5, 0.5]}, {"ratios": [0.5, 0.4, 0.4]}):
        with pytest.raises(ValueError):
            config_from_dict(ppp.SplitConfig, bad)
        with pytest.raises(ValueError):
            jax_from_dict(jpp.SplitConfig, bad)


def jpp_as_dict(conf):
    from sibrar_tpu.config.schema import as_dict as jax_as_dict

    return jax_as_dict(conf)


# --------------------------------------------------------- whole pipelines
def make_raw(path, seed, *, string_ids=False, timestamp="int",
             n_users=60, n_items=90, n=3000):
    """A raw directory: repeated (user, item) events with timestamp ties
    (``timestamp`` "int", "float", "text" as datetimes, or None for no
    column), user features (categorical, a discrete column with gaps, a
    vector), item features (tags with gaps, a vector)."""
    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    pop = 1.0 / np.arange(1, n_items + 1) ** 0.8
    users = rng.integers(0, n_users, n)
    items = rng.choice(n_items, n, p=pop / pop.sum())
    reps = rng.integers(1, 4, n)
    users, items = np.repeat(users, reps), np.repeat(items, reps)
    uid = [f"u{u}" for u in users] if string_ids else users + 100
    iid = [f"t{i}" for i in items] if string_ids else items * 7 + 3
    lhs = {"user": uid, "item": iid}
    if timestamp:
        stamps = rng.integers(1_500_000_000, 1_500_000_000 + len(users) // 3,
                              len(users))
        lhs["timestamp"] = {
            "int": stamps, "float": stamps / 4.0,
            "text": pd.to_datetime(stamps, unit="s").astype(str)}[timestamp]
    pd.DataFrame(lhs).to_csv(os.path.join(path, "listening_history.csv"),
                             index=False)
    all_u = ([f"u{u}" for u in range(n_users)] if string_ids
             else np.arange(n_users) + 100)
    all_i = ([f"t{i}" for i in range(n_items)] if string_ids
             else np.arange(n_items) * 7 + 3)
    age = rng.integers(5, 90, n_users).astype(float)
    age[rng.random(n_users) < 0.1] = np.nan
    pd.DataFrame({"user": all_u,
                  "gender": rng.choice(["m", "f", "n"], n_users),
                  "age": age,
                  "country": rng.choice(["AT", "DE", "US", "BR", "FR"],
                                        n_users)}).to_csv(
        os.path.join(path, "user_features.csv"), index=False)
    genres = [",".join(rng.choice(["rock", "pop", "jazz"],
                                  rng.integers(1, 3), replace=False))
              for _ in range(n_items)]
    genres = [g if rng.random() > 0.05 else None for g in genres]
    pd.DataFrame({"item": all_i, "genres": genres}).to_csv(
        os.path.join(path, "item_features.csv"), index=False)
    np.savez(os.path.join(path, "user_uvec.npz"), indices=np.asarray(all_u),
             values=rng.normal(size=(n_users, 3)).astype(np.float32))
    keep = rng.random(n_items) > 0.03  # a few items without the vector
    np.savez(os.path.join(path, "item_ivec.npz"),
             indices=np.asarray(all_i)[keep],
             values=rng.normal(size=(int(keep.sum()), 5)).astype(np.float32))
    return path


def pipeline_conf(split_type="random", cold="item", dedup=True, k_core=5,
                  min_count=2, seed=42, features=True):
    conf = {"split": {"ratios": [0.8, 0.1, 0.1], "split_type": split_type,
                      "cold_start_type": cold, "seed": seed},
            "interactions": {"min_interactions": min_count,
                             "deduplicate": dedup, "k_core": k_core}}
    if features:
        conf["user_features"] = [
            {"name": "gender", "type": "categorical", "preprocessing": [
                {"kind": "filter_values", "parameters": {"values": ["m",
                                                                    "f"]}}]},
            {"name": "age", "type": "discrete",
             "preprocessing": [{"kind": "filter_missing"},
                               {"kind": "filter_range",
                                "parameters": {"low": 10, "high": 80}}],
             "normalization": [{"kind": "minmax"}]},
            {"name": "country", "type": "categorical", "preprocessing": [
                {"kind": "filter_top", "parameters": {"n": 3}}]},
            {"name": "uvec", "type": "vector",
             "normalization": [{"kind": "robust"}]}]
        conf["item_features"] = [
            {"name": "ivec", "type": "vector",
             "normalization": [{"kind": "standard"}, {"kind": "normal"}]},
            {"name": "genres", "type": "tag",
             "preprocessing": [{"kind": "filter_missing"}]}]
    return conf


# (raw options, conf options): every split type, dedup on and off, k-core 0
# and 5, min-count 1 and 2, string ids, float and datetime-text timestamps,
# no timestamp column, no features
PIPELINES = {
    "random": ({}, {}),
    "temporal": ({}, dict(split_type="temporal")),
    "cold_user": ({}, dict(split_type="coldstart", cold="user")),
    "cold_item": ({}, dict(split_type="coldstart", cold="item")),
    "cold_both": ({}, dict(split_type="coldstart", cold="both")),
    "no_dedup": ({}, dict(dedup=False, split_type="temporal")),
    "k_core_0_min_1": ({}, dict(k_core=0, min_count=1)),
    "string_ids": (dict(string_ids=True), dict(split_type="temporal")),
    "string_ids_cold": (dict(string_ids=True),
                        dict(split_type="coldstart", cold="both")),
    "no_timestamp": (dict(timestamp=None), dict(split_type="temporal",
                                                 dedup=False)),
    "float_timestamps": (dict(timestamp="float"),
                         dict(split_type="temporal")),
    "datetime_text": (dict(timestamp="text"), dict(split_type="temporal",
                                                   dedup=False)),
    "no_features": ({}, dict(features=False, k_core=0, min_count=1,
                             dedup=False)),
}


@pytest.mark.parametrize("case", sorted(PIPELINES))
def test_pipeline_trees_equal_jax(tmp_path, case):
    raw_opts, conf_opts = PIPELINES[case]
    raw = make_raw(tmp_path / "raw", 11, **raw_opts)
    conf = write_conf(tmp_path / "pp.yml", pipeline_conf(**conf_opts))
    names = run_both_clis(raw, tmp_path, ["-c", conf])
    assert any(n.endswith("listening_history_test.csv") for n in names)


def test_cli_roundtrip_case_equals_jax(tmp_path):
    """`test_pipeline_cli_roundtrip`'s raw files and config (cold-start
    item, k-core 2, a categorical user and a normalized vector item
    feature); the port's artifacts load in the port's reader."""
    from sibrar_tpu_torch.config.loader import load_split_type
    from sibrar_tpu_torch.data.dataset import RecDataset

    rng = np.random.default_rng(7)
    raw = tmp_path / "raw"
    os.makedirs(raw)
    pairs = {(int(u), int(i)) for u, i in zip(
        rng.integers(0, 40, 900), rng.integers(0, 50, 900))}
    pd.DataFrame([(u, i, t) for t, (u, i) in enumerate(sorted(pairs))],
                 columns=["user", "item", "timestamp"]).to_csv(
        raw / "listening_history.csv", index=False)
    pd.DataFrame({"user": np.arange(40),
                  "gender": rng.choice(["m", "f"], 40)}).to_csv(
        raw / "user_features.csv", index=False)
    np.savez(raw / "item_audio.npz", indices=np.arange(50),
             values=rng.normal(size=(50, 6)).astype(np.float32))
    conf = write_conf(tmp_path / "pp.yml", {
        "split": {"ratios": [0.7, 0.15, 0.15], "split_type": "coldstart",
                  "cold_start_type": "item"},
        "interactions": {"k_core": 2},
        "user_features": [{"name": "gender", "type": "categorical"}],
        "item_features": [{"name": "audio", "type": "vector",
                           "normalization": [{"kind": "standard"}]}]})
    run_both_clis(raw, tmp_path, ["-c", conf])
    art = str(tmp_path / "port" / "cold_start_item")
    split_type = load_split_type(art)
    assert split_type.value == "cold_start_item"
    ds = RecDataset.load(
        art, "train",
        user_feature_definitions=[FeatureDefinition(
            "gender", FeatureType.CATEGORICAL)],
        item_feature_definitions=[FeatureDefinition(
            "audio", FeatureType.VECTOR)], split_type=split_type)
    assert ds.split_type == "cold_start_item"
    assert len(ds.interactions) > 0


def test_default_config_and_split_flags_equal_jax(tmp_path):
    """No ``-c``: the default config, with ``-s`` / ``--cold_start_type``
    on top."""
    raw = make_raw(tmp_path / "raw", 5, n=800)
    run_both_clis(raw, tmp_path, [])
    run_both_clis(raw, tmp_path / "cold", ["-s", "coldstart",
                                           "--cold_start_type", "user"])


# ----------------------------------------------------------------- parsers
def test_ml1m_parser_and_conf_equal_jax(tmp_path):
    """`parse_ml1m` (rating >= 3, occupation labels, genres, the plot
    embeddings copied through), then ``conf/preprocessing/ml1m.yml``."""
    rng = np.random.default_rng(2)
    vendor = tmp_path / "ml1m"
    os.makedirs(vendor / "features")
    n_users, n_items = 40, 30
    with open(vendor / "ratings.dat", "w") as fh:
        for t in range(1500):
            fh.write(f"{rng.integers(1, n_users + 1)}::"
                     f"{rng.integers(1, n_items + 1)}::"
                     f"{rng.integers(1, 6)}::{978300000 + t}\n")
    with open(vendor / "users.dat", "w") as fh:
        for u in range(1, n_users + 1):
            fh.write(f"{u}::{rng.choice(['F', 'M'])}::"
                     f"{rng.choice([1, 18, 25, 35, 56])}::"
                     f"{rng.integers(0, 21)}::{rng.integers(10000, 99999)}"
                     "\n")
    with open(vendor / "movies.dat", "w", encoding="latin-1") as fh:
        for i in range(1, n_items + 1):
            fh.write(f"{i}::Movie {i} (19{rng.integers(50, 99)})::"
                     f"{'|'.join(rng.choice(['Action', 'Crime', 'Comedy'], 2, replace=False))}\n")  # noqa: E501
    pd.DataFrame(np.column_stack([
        np.arange(1, n_items + 1),
        rng.normal(size=(n_items, 6)).astype(np.float32)])).to_csv(
        vendor / "features" / "id_plot_mpnet.tsv", sep="\t", index=False,
        header=False)
    jdl.parse_ml1m(str(vendor), str(tmp_path / "parsed" / "jax"))
    pdl.parse_ml1m(str(vendor), str(tmp_path / "parsed" / "port"))
    assert_same_tree(tmp_path / "parsed" / "jax", tmp_path / "parsed" / "port")
    run_both_clis(tmp_path / "parsed" / "port", tmp_path / "out",
                  ["-c", os.path.join(PP_CONF, "ml1m.yml")])


def test_amazon_csv_verified_filter_equals_jax(tmp_path):
    csv = tmp_path / "ratings.csv"
    csv.write_text("i1,u1,5.0,100,true\ni2,u1,4.0,200,false\n"
                   "i1,u2,2.0,300,true\ni3,u2,5.0,400,True\n")
    for year_min, verified in ((None, True), (None, False), (1970, True)):
        out = tmp_path / f"{year_min}_{verified}"
        jdl.parse_amazon_csv(str(csv), str(out / "jax"),
                             verified_only=verified, year_min=year_min)
        pdl.parse_amazon_csv(str(csv), str(out / "port"),
                             verified_only=verified, year_min=year_min)
        assert_same_tree(out / "jax", out / "port")
    csv4 = tmp_path / "r4.csv"
    csv4.write_text("i1,u1,5.0,100\n")
    for mod in (jdl, pdl):
        with pytest.raises(ValueError):
            mod.parse_amazon_csv(str(csv4), str(tmp_path / "o4"),
                                 verified_only=True)


def _amazon_meta(path, asins, incomplete_from=None):
    with open(path, "w") as fh:
        for i, asin in enumerate(asins):
            rec = {"parent_asin": asin, "title": f"Item {i}",
                   "description": [f"desc {i}", "extra words"],
                   "images": [{"large": f"http://img/{i}.jpg"}]}
            if incomplete_from is not None and i >= incomplete_from:
                which = i % 3
                if which == 0:
                    rec["description"] = []
                elif which == 1:
                    rec["title"] = ""
                else:
                    rec["images"] = []
            fh.write(json.dumps(rec) + "\n")


def _embed_stub(texts):
    return np.stack([np.asarray([len(t), t.count(" "), t.count("e") / 7.0,
                                 1.0], dtype=np.float32) for t in texts])


def test_amazon2024_meta_pipeline_equals_jax(tmp_path):
    """The meta JSONL filter, the ratings join and first-interaction dedup,
    the text feature (a stub embedder), then a random split, k-core 2."""
    rng = np.random.default_rng(11)
    n_items, n_users = 30, 40
    items = [f"B{i:04d}" for i in range(n_items)]
    meta = tmp_path / "meta.jsonl"
    _amazon_meta(meta, items, incomplete_from=24)
    assert jdl.parse_amazon_meta_jsonl(str(meta)) \
        == pdl.parse_amazon_meta_jsonl(str(meta))
    rows, t = [], 0
    for u in range(n_users):
        for i in rng.choice(n_items, size=8, replace=False):
            rows.append(f"{items[i]},u{u},5.0,{1000 + t}")
            t += 1
    rows.append("B0001,u0,5.0,99999")
    csv = tmp_path / "ratings.csv"
    csv.write_text("\n".join(rows) + "\n")
    for mod, side in ((jdl, "jax"), (pdl, "port")):
        out = str(tmp_path / "raw" / side)
        mod.parse_amazon_csv(str(csv), out, min_rating=3.0,
                             meta_jsonl=str(meta))
        mod.amazon_meta_text_features(out, embed_fn=_embed_stub)
    assert_same_tree(tmp_path / "raw" / "jax", tmp_path / "raw" / "port")
    conf = write_conf(tmp_path / "pp.yml", {
        "split": {"ratios": [0.7, 0.15, 0.15], "split_type": "random",
                  "seed": 3},
        "interactions": {"k_core": 2},
        "item_features": [{"name": "text_mpnet", "type": "vector"}]})
    run_both_clis(tmp_path / "raw" / "port", tmp_path / "out", ["-c", conf])


def test_download_paths_equal_jax(tmp_path, monkeypatch):
    """The URL tables, the files each download writes and the URLs it asks
    for (the fetch monkeypatched); no re-download of a file that is there;
    without a network the fetch raises saying what to do."""
    for name in ("DATASET_URLS", "LFM2B_2020_FILES", "ONION_ZENODO_RECORD",
                 "ONION_ZENODO_BUCKET", "GDRIVE_FILE_IDS",
                 "ML1M_OCCUPATIONS"):
        assert getattr(pdl, name) == getattr(jdl, name), name
    fetched = {}
    for mod, side in ((jdl, "jax"), (pdl, "port")):
        urls = fetched[side] = []
        monkeypatch.setattr(mod, "_fetch", lambda url, timeout=120, u=urls:
                            u.append(url) or bz2.compress(b"col\t1\n"))
        base = tmp_path / side
        mod.download_lfm2b_2020(str(base / "lfm"))
        mod.download_lfm2b_2020(str(base / "lfm"))  # soft: no re-download
        mod.download_onion(str(base / "onion"),
                           feature_names=("ivec256", "bert"),
                           access_token="tok")
    assert fetched["port"] == fetched["jax"]
    assert len(fetched["port"]) == 7
    assert_same_tree(tmp_path / "jax", tmp_path / "port")
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="manually"):
        pdl._fetch("http://127.0.0.1:1/none", timeout=1)
    with pytest.raises(ValueError, match="unknown dataset"):
        pdl.download_dataset("nope", str(tmp_path / "x"))


def test_export_ecf_tag_files_equals_jax(tmp_path):
    values = ["action|comedy", "drama", "action", "comedy|drama|action"]
    port = build_feature(FeatureDefinition("genres", FeatureType.TAG),
                         values, n_entities=4)
    jax = JaxFeature.build(JaxFeatureDefinition("genres", JaxFeatureType.TAG),
                           values, n_entities=4)
    jdl.export_ecf_tag_files(jax, 4, str(tmp_path / "jax"))
    pdl.export_ecf_tag_files(port, 4, str(tmp_path / "port"))
    assert assert_same_tree(tmp_path / "jax", tmp_path / "port") == [
        "item_tag_idxs.csv", "tag_idxs.csv"]


def test_text_helpers_equal_jax(tmp_path, monkeypatch):
    """`generate_sentences`, `extract_title_and_year`, `store_text_feature`
    and `embed_dataframe_texts` (the model stubbed); `embed_texts` asks
    for the card by default and raises without one."""
    df = pd.DataFrame({"age": [25, np.nan, 40], "gender": ["f", "m", None],
                       "text": ["a b", None, "c d e"], "id": [3, 4, 5]})
    templates = {"age": "The user is {} years old.",
                 "gender": "Their gender is {}."}
    assert ptext.generate_sentences(df, templates) \
        == jtext.generate_sentences(df, templates)
    for title in ("Heat (1995)", "No year", "A (B) (2001)"):
        assert ptext.extract_title_and_year(title) \
            == jtext.extract_title_and_year(title)
    for mod, side in ((jtext, "jax"), (ptext, "port")):
        monkeypatch.setattr(mod, "embed_texts",
                            lambda texts, **kw: _embed_stub(texts))
        out = tmp_path / side
        os.makedirs(out)
        mod.embed_dataframe_texts(df, "text", "id",
                                  out_path=str(out / "f.npz"))
        mod.store_text_feature(str(out / "g.npz"), np.arange(2),
                               np.ones((2, 3)))
    assert_same_tree(tmp_path / "jax", tmp_path / "port")
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            ptext.embed_texts(["a"])


# ---------------------------------------------- shipped confs, e2e layouts
def _onion_vendor(path, rng, n_users=40, n_items=50):
    """Onion's vendor layout (`test_preprocess_e2e.py`'s sizes): repeated
    listening events with datetime stamps, users.tsv, five feature TSVs."""
    os.makedirs(path / "features")
    base = sorted({(int(u), int(i)) for u, i in zip(
        rng.integers(0, n_users, 1500), rng.integers(0, n_items, 1500))})
    pairs = [p for p in base for _ in range(int(rng.integers(2, 5)))]
    ts = pd.to_datetime("2018-01-01") + pd.to_timedelta(
        rng.integers(0, 300 * 24 * 3600, len(pairs)), unit="s")
    pd.DataFrame({"user_id": [u for u, _ in pairs],
                  "track_id": [i for _, i in pairs],
                  "timestamp": ts.astype(str)}).to_csv(
        path / "userid_trackid_timestamp.tsv", sep="\t", index=False)
    pd.DataFrame({
        "user_id": np.arange(n_users),
        "gender": rng.choice(["m", "f", "n"], n_users, p=[0.45, 0.45, 0.1]),
        "age": rng.integers(5, 90, n_users),
        "country": rng.choice(["AT", "DE", "US", "BR"], n_users),
    }).to_csv(path / "users.tsv", sep="\t", index=False)
    for feat, d in (("ivec256", 8), ("bert", 6), ("musicnn", 5),
                    ("jukebox", 4), ("resnet", 4)):
        pd.DataFrame(np.column_stack([
            np.arange(n_items),
            rng.normal(size=(n_items, d)).astype(np.float32)])).to_csv(
            path / "features" / f"id_{feat}.tsv", sep="\t", index=False,
            header=False)


@pytest.mark.parametrize("split_args", [
    [], ["-s", "coldstart", "--cold_start_type", "item"],
    ["-s", "coldstart", "--cold_start_type", "user"]])
def test_onion18_conf_equals_jax(tmp_path, split_args):
    """`test_onion18_raw_to_metrics`: the vendor files through both
    `parse_onion`s (a year / month subset too), genres and the user MPNet
    vector added, then the shipped ``onion18.yml``."""
    rng = np.random.default_rng(3)
    vendor = tmp_path / "vendor"
    _onion_vendor(vendor, rng)
    feats = ["ivec256", "bert", "musicnn", "jukebox", "resnet"]
    for mod, side in ((jdl, "jax"), (pdl, "port")):
        mod.parse_onion(str(vendor), str(tmp_path / "parsed" / side),
                        item_feature_names=feats)
        mod.parse_onion(str(vendor), str(tmp_path / "month" / side),
                        item_feature_names=feats[:1], year=2018, month=3)
    assert_same_tree(tmp_path / "parsed" / "jax", tmp_path / "parsed" / "port")
    assert_same_tree(tmp_path / "month" / "jax", tmp_path / "month" / "port")
    parsed = tmp_path / "parsed" / "port"
    pd.DataFrame({
        "item": np.arange(50),
        "genres": [",".join(rng.choice(["rock", "pop", "jazz", "folk"],
                                       rng.integers(1, 3), replace=False))
                   for _ in range(50)],
    }).to_csv(parsed / "item_features.csv", index=False)
    np.savez(parsed / "user_acg_with_unknown_mpnet.npz",
             indices=np.arange(40),
             values=rng.normal(size=(40, 6)).astype(np.float32))
    names = run_both_clis(parsed, tmp_path / "out",
                          ["-c", os.path.join(PP_CONF, "onion18.yml"),
                           *split_args])
    for feat in feats:
        assert any(n.endswith(f"item_{feat}_train.npz") for n in names)


@pytest.mark.parametrize("split_args", [
    [], ["-s", "coldstart", "--cold_start_type", "item"]])
def test_amazon2024_conf_equals_jax(tmp_path, split_args):
    """`test_amazon2024_raw_to_metrics`: string ids, the meta join, the
    text vector, the shipped ``amazon2024.yml``."""
    rng = np.random.default_rng(5)
    n_users, n_items = 45, 40
    asins = [f"B{i:07d}" for i in range(n_items)]
    meta = tmp_path / "meta.jsonl"
    _amazon_meta(meta, asins)
    pairs = sorted({(int(u), int(i)) for u, i in zip(
        rng.integers(0, n_users, 2200), rng.integers(0, n_items, 2200))})
    csv = tmp_path / "ratings.csv"
    pd.DataFrame({
        "item": [asins[i] for _, i in pairs],
        "user": [f"U{u}" for u, _ in pairs],
        "rating": rng.choice([2.0, 4.0, 5.0], len(pairs), p=[0.1, 0.5, 0.4]),
        "timestamp": rng.integers(1.6e9, 1.7e9, len(pairs)),
    }).to_csv(csv, index=False, header=False)
    parsed = tmp_path / "parsed"
    pdl.parse_amazon_csv(str(csv), str(parsed), min_rating=3.0,
                         meta_jsonl=str(meta))
    pdl.amazon_meta_text_features(str(parsed), embed_fn=_embed_stub)
    run_both_clis(parsed, tmp_path / "out",
                  ["-c", os.path.join(PP_CONF, "amazon2024.yml"),
                   *split_args])


# ------------------------------------------------- imports, device, utils
BLOCKED_CLI = r"""
import runpy, sys
for name in ("jax", "flax", "optax", "sibrar_tpu"):
    sys.modules[name] = None  # any import of these now fails
sys.argv = ["preprocess_dataset"] + ARGS
runpy.run_module("sibrar_tpu_torch.preprocess_dataset", run_name="__main__")
assert not any(m == "sibrar_tpu" or m.startswith("sibrar_tpu.")
               for m in sys.modules if sys.modules[m] is not None)
"""


def test_port_cli_runs_without_jax(tmp_path):
    """``python -m sibrar_tpu_torch.preprocess_dataset`` with jax, flax,
    optax and ``sibrar_tpu`` blocked writes the JAX CLI's tree."""
    raw = make_raw(tmp_path / "raw", 9, string_ids=True)
    conf = write_conf(tmp_path / "pp.yml",
                      pipeline_conf(split_type="coldstart", cold="item"))
    args = ["-d", str(raw), "-o", str(tmp_path / "port"), "-c", conf,
            "--device", "cpu"]
    done = subprocess.run(
        [sys.executable, "-c", f"ARGS = {args!r}\n" + BLOCKED_CLI],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"})
    assert done.returncode == 0, done.stderr[-3000:]
    assert "preprocess stage seconds on cpu" in done.stdout
    jax_cli.main(["-d", str(raw), "-o", str(tmp_path / "jax"), "-c", conf])
    assert_same_tree(tmp_path / "jax", tmp_path / "port")


def test_no_fallback_without_a_card(tmp_path):
    """The card is the default: without one the pipeline, its stages and
    the CLI raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without a card")
    raw = make_raw(tmp_path / "raw", 1, n=300)
    config = config_from_dict(ppp.PreprocessingConfig, {})
    data = ppipe.load_raw(str(raw), config)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ppipe.preprocess(data, config)
    with pytest.raises(RuntimeError, match="is_available"):
        pf.encode_interactions(data.interactions)
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_cli.main(["-d", str(raw), "-o", str(tmp_path / "o")])
    assert ppipe.preprocess(data, config, device="cpu").train \
        .interactions.shape[0] > 0


def test_misc_stdout_helpers_equal_jax(tmp_path, capsys):
    """`Tee` (stdout and the file, an exception written to the file),
    `silence_stdout` and `FunctionWrapper` behave as JAX's."""
    for mod in (jmisc, pmisc):
        path = tmp_path / f"{mod.__name__}.log"
        with pytest.raises(KeyError):
            with mod.Tee(str(path)):
                print("to both")
                raise KeyError("boom")
        text = path.read_text()
        assert text.startswith("to both\n") and "KeyError: 'boom'" in text
        assert capsys.readouterr().out == "to both\n"
        with mod.silence_stdout() as sink:
            print("hidden")
        assert sink.getvalue() == "hidden\n"
        assert capsys.readouterr().out == ""
        wrapped = mod.FunctionWrapper(max)
        assert wrapped(2, 5) == 5 and repr(wrapped) == f"FunctionWrapper({max!r})"


def test_chip_smoke_preprocess_helpers(tmp_path):
    """The card phase's helpers at a small size: `write_fixed_csv` reads
    back as its ints, `write_onion_raw` writes `parse_onion`'s layout and
    the JAX pipeline takes it under `prep_conf` (onion18.yml's split,
    filters and user steps with the raw data's item features), and
    `same_artifacts` holds two port trees equal and finds a changed byte."""
    from test_torch_sbnet_serve import _chip_smoke

    cs = _chip_smoke()
    cols = [np.array([100001, 149999]), np.array([1000000, 1199999]),
            np.array([1514764800, 1546300799])]
    cs.write_fixed_csv(str(tmp_path / "x.csv"), "user,item,timestamp", cols)
    back = pd.read_csv(tmp_path / "x.csv")
    for got, want in zip(back.to_numpy().T, cols):
        assert back.dtypes.iloc[0] == np.int64
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="digit"):
        cs.write_fixed_csv(str(tmp_path / "y.csv"), "a", [np.array([5, 10])])
    cs.PREP_USERS, cs.PREP_TRACKS, cs.PREP_PAIRS = 300, 900, 6000
    cs.PREP_ITEM_VECTORS = (("ivec256", 4), ("bert", 3), ("musicnn", 2))
    cs.PREP_USER_VECTOR = ("acg_with_unknown_mpnet", 5)
    raw = tmp_path / "raw"
    counts = cs.write_onion_raw(str(raw))
    assert sorted(os.listdir(raw)) == [
        "item_bert.npz", "item_features.csv", "item_ivec256.npz",
        "item_musicnn.npz", "listening_history.csv",
        "user_acg_with_unknown_mpnet.npz", "user_features.csv"]
    assert len(pd.read_csv(raw / "listening_history.csv")) \
        == counts["events"]
    conf = cs.prep_conf(str(tmp_path / "pp.yml"))
    with open(os.path.join(PP_CONF, "onion18.yml")) as fh:
        onion18 = yaml.safe_load(fh)
    with open(conf) as fh:
        got = yaml.safe_load(fh)
    assert {k: v for k, v in got.items() if k != "item_features"} \
        == {k: v for k, v in onion18.items() if k != "item_features"}
    assert [f["name"] for f in got["item_features"]] == [
        "ivec256", "bert", "musicnn", "genres"]
    names = run_both_clis(raw, tmp_path / "out", ["-c", conf])
    assert "random_split/listening_history_train.csv" in names
    port_cli.main(["-d", str(raw), "-o", str(tmp_path / "again"), "-c",
                   conf, "--device", "cpu"])
    a, b = (str(p / "random_split") for p in (tmp_path / "out" / "port",
                                               tmp_path / "again"))
    files, n_bytes = cs.same_artifacts(a, b)
    assert len(files) == 24 and n_bytes > 0
    with open(os.path.join(b, "user_idxs.csv"), "a") as fh:
        fh.write("0,0\n")
    with pytest.raises(AssertionError, match="user_idxs.csv"):
        cs.same_artifacts(a, b)
