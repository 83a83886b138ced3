"""The port's artifact reader and writer against the JAX package's, on the
CPU: artifacts written by JAX's `write_reference_artifacts` (synthetic
splits with categorical, vector and tag features; a cold-start split; small
onion-scale splits) and a hand-written directory (an integer-label
categorical column, a discrete column with an empty cell, history columns
out of order), each split loaded by both `RecDataset.load`s: every array
bit-equal, the same labels (`value_map`, key types included), and the same
errors where JAX raises. Then the port's writer: its files equal JAX's
writer's, and JAX's loader reads them into the same arrays."""
import os

import numpy as np
import pytest

from sibrar_tpu.config.schema import DatasetSplitType, FeatureDefinition
from sibrar_tpu.config.schema import FeatureType as JaxFeatureType
from sibrar_tpu.data.dataset import RecDataset as JaxRecDataset
from sibrar_tpu.data.dataset import _load_preproc_split_type
from sibrar_tpu.data.synthetic import make_onion_scale_splits as jax_onion
from sibrar_tpu.data.synthetic import make_synthetic_splits
from sibrar_tpu.data.synthetic import \
    write_reference_artifacts as jax_write
from sibrar_tpu_torch import config_from_dict
from sibrar_tpu_torch.config import schema
from sibrar_tpu_torch.config.loader import load_split_type
from sibrar_tpu_torch.data.dataset import RecDataset, make_splits
from sibrar_tpu_torch.data.feature import FeatureTable
from sibrar_tpu_torch.data.synthetic import make_onion_scale_splits
from sibrar_tpu_torch.data.synthetic import write_reference_artifacts

SYN_USER = [("gender", "categorical"), ("profile_vec", "vector")]
SYN_ITEM = [("audio", "vector"), ("text", "vector"), ("genres", "tag")]
ONION_ITEM = [("ivec256", "vector"), ("bert", "vector"),
              ("musicnn", "vector"), ("genres", "tag")]
ONION = dict(n_users=300, n_items=400, n_interactions=8000, n_clusters=8,
             seed=7, feature_dims={"ivec256": 16, "bert": 24, "musicnn": 8})


def _defs(pairs):
    """The same definitions for both packages."""
    return ([FeatureDefinition(n, JaxFeatureType(t)) for n, t in pairs],
            [config_from_dict(schema.FeatureDefinition,
                              {"name": n, "type": t}) for n, t in pairs])


def _load_both(path, split, user=(), item=()):
    (ju, tu), (ji, ti) = _defs(user), _defs(item)
    want = JaxRecDataset.load(path, split, user_feature_definitions=ju or None,
                              item_feature_definitions=ji or None)
    got = RecDataset.load(path, split, user_feature_definitions=tu or None,
                          item_feature_definitions=ti or None,
                          split_type=load_split_type(path))
    return want, got


def _jax_view(feat):
    """A JAX `Feature` as the port's `FeatureTable` fields."""
    if feat.value_map is None:
        return FeatureTable(feat.table, "numeric")
    assert feat.type != JaxFeatureType.TAG or (
        feat.padding_idx == len(feat.unique_values))
    return FeatureTable(feat.table, feat.type.value, len(feat.unique_values),
                        feat.value_map)


def _same_feature(name, got: FeatureTable, want: FeatureTable):
    """Bit-equal tables of one dtype, one kind, the same labels in the same
    order with keys of the same types."""
    assert got.table.dtype == want.table.dtype, name
    np.testing.assert_array_equal(got.table, want.table, err_msg=name)
    assert (got.kind, got.n_categories) == (want.kind, want.n_categories), \
        name
    if want.value_map is None:
        assert got.value_map is None, name
        return
    assert list(got.value_map.items()) == list(want.value_map.items()), name
    assert [type(k) for k in got.value_map] == [
        type(k) for k in want.value_map], name


def _assert_same_split(got: RecDataset, want):
    assert (got.n_users, got.n_items) == (want.n_users, want.n_items)
    assert got.split_type == want.split_type.value
    assert got.is_cold_start == want.is_cold_start
    for field in ("interactions", "train_interactions", "users_in_split",
                  "items_in_split"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    if want.val_interactions is None:
        assert got.val_interactions is None
    else:
        np.testing.assert_array_equal(got.val_interactions,
                                      want.val_interactions)
    for entity in ("user_features", "item_features"):
        g, w = getattr(got, entity), getattr(want, entity)
        assert list(g) == list(w), entity
        for name in w:
            _same_feature(name, g[name], _jax_view(w[name]))


def _check_all_splits(path, user=(), item=()):
    for split in ("train", "val", "test"):
        want, got = _load_both(path, split, user, item)
        _assert_same_split(got, want)


@pytest.mark.parametrize("split_type", ["random", "cold_start_item"])
def test_synthetic_artifacts_load_like_jax(tmp_path, split_type):
    st = DatasetSplitType(split_type)
    jax_write(str(tmp_path), make_synthetic_splits(
        n_users=50, n_items=70, n_interactions=900, split_type=st, seed=3))
    assert load_split_type(str(tmp_path)) == _load_preproc_split_type(
        str(tmp_path))
    _check_all_splits(str(tmp_path), SYN_USER, SYN_ITEM)
    if st.is_cold_start:  # the catalog is the split's own items
        want, got = _load_both(str(tmp_path), "test", SYN_USER, SYN_ITEM)
        assert len(got.items_in_split) < got.n_items


def test_onion_artifacts_load_like_jax_and_like_memory(tmp_path):
    """JAX's writer on small onion-scale splits: both loaders agree, and the
    port's load equals the port's in-memory splits of the same seed (what
    the card's CLI phase checks at full size)."""
    jax_write(str(tmp_path), jax_onion(**ONION))
    _check_all_splits(str(tmp_path), (), ONION_ITEM)
    mem = make_splits(make_onion_scale_splits(**ONION))
    _, ti = _defs(ONION_ITEM)
    for split in ("train", "val", "test"):
        got = RecDataset.load(str(tmp_path), split,
                              item_feature_definitions=ti)
        np.testing.assert_array_equal(got.interactions,
                                      mem[split].interactions)
        for name, feat in mem[split].item_features.items():
            _same_feature(name, got.item_features[name], feat)


def _write_hand_csvs(path, tag_cell="rock|pop", gender_cell="f"):
    """A directory as a preprocessing run might leave it: no
    used_config.yaml (random), history columns out of order with an extra
    column, user features where a user repeats across train and val (the
    first row wins), users without a row, an integer-label categorical
    whose test split holds a float label, a discrete column with an empty
    cell, a quoted label holding a comma, a column of booleans."""
    os.makedirs(path, exist_ok=True)

    def put(name, text):
        with open(os.path.join(path, name), "w") as fh:
            fh.write(text)

    put("user_idxs.csv", "user,user_idx\n" + "".join(
        f"u{i},{i}\n" for i in range(6)))
    put("item_idxs.csv", "item,item_idx\n" + "".join(
        f"i{i},{i}\n" for i in range(5)))
    put("listening_history_train.csv",
        "item_idx,timestamp,user_idx\n0,10,0\n1,11,0\n2,12,1\n3,13,2\n"
        "4,14,3\n0,15,4\n1,16,5\n")
    put("listening_history_val.csv",
        "item_idx,timestamp,user_idx\n2,20,0\n0,21,1\n\n4,22,2\n")
    put("listening_history_test.csv",
        "item_idx,timestamp,user_idx\n3,30,0\n1,31,3\n")
    put("user_features_train.csv",
        "user_idx,age_group,age,gender,tags,premium\n"
        f"0,10,23.5,{gender_cell},{tag_cell},True\n1,2,,m,jazz,false\n"
        "2,1,41.25,f,pop|rock|jazz,TRUE\n")
    put("user_features_val.csv",
        "user_idx,age_group,age,gender,tags,premium\n"
        '1,10,30.0,f,pop,False\n4,2,19.0,"x, other",rock,True\n')
    put("user_features_test.csv",
        "user_idx,age_group,age,gender,tags,premium\n"
        "3,3.0,55.5,m,blues,True\n")


HAND_USER = [("age_group", "categorical"), ("age", "discrete"),
             ("gender", "categorical"), ("tags", "tag"),
             ("premium", "categorical")]


def test_hand_written_csvs_load_like_jax(tmp_path):
    _write_hand_csvs(str(tmp_path))
    _check_all_splits(str(tmp_path), HAND_USER)
    _, got = _load_both(str(tmp_path), "train", HAND_USER)
    # integer labels sort as numbers (2 < 10), the test split's 3.0 among
    # them; val's repeat of user 1 lost to train's row
    assert list(got.user_features["age_group"].value_map) == [1, 2, 3.0, 10]
    assert got.user_features["age_group"].table.tolist() == [3, 1, 0, 0, 1,
                                                             0]
    assert np.isnan(got.user_features["age"].table[1])
    assert "x, other" in got.user_features["gender"].value_map
    assert list(got.user_features["premium"].value_map) == [False, True]


@pytest.mark.parametrize("cells", [{"tag_cell": ""}, {"gender_cell": ""}])
def test_missing_label_raises_like_jax(tmp_path, cells):
    """An empty tag cell (NaN) cannot be split, and an empty string label
    cannot be sorted among strings: both packages raise TypeError."""
    _write_hand_csvs(str(tmp_path), **cells)
    ju, tu = _defs(HAND_USER)
    for split in ("train", "val"):  # val: the bad cell is a reference value
        with pytest.raises(TypeError):
            JaxRecDataset.load(str(tmp_path), split,
                               user_feature_definitions=ju)
        with pytest.raises(TypeError):
            RecDataset.load(str(tmp_path), split,
                            user_feature_definitions=tu)


def _port_splits(jsplits):
    """The port's splits holding the same arrays and labels as JAX's."""
    def table(f):
        kind = ("numeric" if f.value_map is None else f.type.value)
        return FeatureTable(f.table, kind, len(f.unique_values or ()),
                            f.value_map and dict(f.value_map))
    return {s: RecDataset(
        split_set=s, n_users=d.n_users, n_items=d.n_items,
        interactions=d.interactions, train_interactions=d.train_interactions,
        val_interactions=d.val_interactions, split_type=d.split_type,
        user_features={k: table(f) for k, f in d.user_features.items()},
        item_features={k: table(f) for k, f in d.item_features.items()})
        for s, d in jsplits.items()}


@pytest.mark.parametrize("split_type", ["random", "cold_start_item"])
def test_port_writer_matches_jax_writer(tmp_path, split_type):
    """The port's writer gives JAX's writer's files (CSV and YAML bytes
    equal, npz arrays equal), so JAX's loader reads the same arrays."""
    jsplits = make_synthetic_splits(n_users=50, n_items=70,
                                    n_interactions=900, seed=4,
                                    split_type=DatasetSplitType(split_type))
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jax_write(str(jdir), jsplits, seed=5)
    write_reference_artifacts(str(tdir), _port_splits(jsplits), seed=5)
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    for name in os.listdir(jdir):
        if name.endswith(".npz"):
            with np.load(jdir / name) as a, np.load(tdir / name) as b:
                for key in ("indices", "values"):
                    np.testing.assert_array_equal(b[key], a[key])
                    assert b[key].dtype == a[key].dtype
        else:
            assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), \
                name
    ju, _ = _defs(SYN_USER)
    ji, _ = _defs(SYN_ITEM)
    for split in ("train", "val", "test"):
        a = JaxRecDataset.load(str(jdir), split, ju, ji)
        b = JaxRecDataset.load(str(tdir), split, ju, ji)
        for field in ("interactions", "users_in_split", "items_in_split"):
            np.testing.assert_array_equal(getattr(b, field),
                                          getattr(a, field))
        for name in a.item_features:
            np.testing.assert_array_equal(b.item_features[name].table,
                                          a.item_features[name].table)
        for name in a.user_features:
            np.testing.assert_array_equal(b.user_features[name].table,
                                          a.user_features[name].table)


def test_port_writer_onion_reads_back_in_jax(tmp_path):
    """The port's in-memory onion splits, written by the port's writer and
    read by JAX's loader: the pairs and every feature table."""
    mem = make_splits(make_onion_scale_splits(**ONION))
    write_reference_artifacts(str(tmp_path), mem)
    ji, _ = _defs(ONION_ITEM)
    for split in ("train", "val", "test"):
        want = JaxRecDataset.load(str(tmp_path), split,
                                  item_feature_definitions=ji)
        np.testing.assert_array_equal(want.interactions,
                                      mem[split].interactions)
        for name, feat in mem[split].item_features.items():
            _same_feature(name, feat, _jax_view(want.item_features[name]))
