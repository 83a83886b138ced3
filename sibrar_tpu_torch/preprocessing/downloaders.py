"""Dataset acquisition and raw-format parsers (port of
``sibrar_tpu/preprocessing/downloaders.py``).

The parsers (`parse_ml1m`, `parse_onion`, `parse_amazon_csv`,
`parse_amazon_meta_jsonl`, `amazon_meta_text_features`) turn downloaded
vendor files into the pipeline's raw layout (``listening_history.csv``,
``{entity}_features.csv``, ``{entity}_{feature}.npz``), and
`export_ecf_tag_files` writes ECF's tag tables. The downloads (MovieLens,
LFM-2b, Onion, Amazon, KuaiRec, DeliveryHero) need a network: without one
each raises a clear error that says to fetch the file by hand.
"""
from __future__ import annotations

import logging
import os
import zipfile

import numpy as np
import pandas as pd

log = logging.getLogger(__name__)

DATASET_URLS = {
    "ml100k": "https://files.grouplens.org/datasets/movielens/ml-100k.zip",
    "ml1m": "https://files.grouplens.org/datasets/movielens/ml-1m.zip",
    "ml10m": "https://files.grouplens.org/datasets/movielens/ml-10m.zip",
    "amazonvid2018": ("https://jmcauley.ucsd.edu/data/amazon_v2/categoryFilesSmall/"
                      "Video_Games.csv"),
    "amazonvid2024": ("https://mcauleylab.ucsd.edu/public_datasets/data/amazon_2023/"
                      "raw/review_categories/Video_Games.jsonl.gz"),
    "kuairec": "https://kuairec.com/dataset",  # gdrive id below
    "deliveryhero": ("https://huggingface.co/datasets/deliveryhero/"
                     "dh-recommendation-dataset"),  # gdrive id below
    "lfm2b": "http://www.cp.jku.at/datasets/LFM-2b/recsys22/listening_events.tsv.bz2",
    "onion": "https://zenodo.org/records/6609677",
}

# LFM2b 2020 subset: three bz2 TSVs.
LFM2B_2020_FILES = {
    "inter_dataset.tsv": ("http://www.cp.jku.at/datasets/LFM-2b/recsys22/"
                          "listening_events.tsv.bz2"),
    "users.tsv": "http://www.cp.jku.at/datasets/LFM-2b/recsys22/users.tsv.bz2",
    "tracks.tsv": "http://www.cp.jku.at/datasets/LFM-2b/recsys22/tracks.tsv.bz2",
}

# Onion Zenodo record. Files are fetched straight off the record's file
# bucket; a personal access token is only needed while the record is
# restricted.
ONION_ZENODO_RECORD = "6609677"
ONION_ZENODO_BUCKET = f"https://zenodo.org/records/{ONION_ZENODO_RECORD}/files"

# Google-Drive-hosted archives.
GDRIVE_FILE_IDS = {
    "deliveryhero": "1v-FfCbLtv02EpNpopDx25EQnHZeT1nL2",
    "kuairec": "1qe5hOSBxzIuxBb1G_Ih5X-O65QElollE",
}

ML1M_OCCUPATIONS = [
    "other", "academic/educator", "artist", "clerical/admin", "college/grad student",
    "customer service", "doctor/health care", "executive/managerial", "farmer",
    "homemaker", "K-12 student", "lawyer", "programmer", "retired",
    "sales/marketing", "scientist", "self-employed", "technician/engineer",
    "tradesman/craftsman", "unemployed", "writer",
]


def download_dataset(name: str, out_dir: str, timeout: int = 60) -> str:
    """Fetch and extract a dataset archive. Raises RuntimeError without a
    network."""
    if name not in DATASET_URLS:
        raise ValueError(f"unknown dataset {name!r}; choose from "
                         f"{sorted(DATASET_URLS)}")
    url = DATASET_URLS[name]
    os.makedirs(out_dir, exist_ok=True)
    target = os.path.join(out_dir, os.path.basename(url))
    if not os.path.exists(target):
        try:
            import urllib.request

            urllib.request.urlretrieve(url, target)  # noqa: S310
        except Exception as e:  # no network lands here
            raise RuntimeError(
                f"could not download {url!r} ({e}); fetch it manually into "
                f"{out_dir!r} and re-run") from e
    if target.endswith(".zip"):
        with zipfile.ZipFile(target) as zf:
            zf.extractall(out_dir)
    return out_dir


def _fetch(url: str, timeout: int = 120) -> bytes:
    """One HTTP GET; without a network, an error that says what to do."""
    try:
        import urllib.request

        with urllib.request.urlopen(url, timeout=timeout) as r:  # noqa: S310
            return r.read()
    except Exception as e:
        raise RuntimeError(
            f"could not download {url!r} ({e}); fetch it manually and re-run"
        ) from e


def _soft_write_bz2(url: str, target: str, force: bool = False) -> None:
    """Download a .bz2 file and store it decompressed, unless it is
    there."""
    import bz2

    if os.path.exists(target) and not force:
        return
    with open(target, "wb") as fw:
        fw.write(bz2.decompress(_fetch(url)))


def download_lfm2b_2020(save_path: str = "./", force: bool = False) -> str:
    """LFM2b 2020 subset: listening events, users and tracks TSVs,
    decompressed into `<save_path>/raw_dataset/`."""
    raw = os.path.join(save_path, "raw_dataset")
    os.makedirs(raw, exist_ok=True)
    for fname, url in LFM2B_2020_FILES.items():
        _soft_write_bz2(url, os.path.join(raw, fname), force)
    return raw


def download_onion(save_path: str = "./",
                   feature_names: tuple[str, ...] = ("ivec256",),
                   access_token: str | None = None,
                   force: bool = False,
                   skip_listening_history: bool = False) -> str:
    """Onion dataset off Zenodo record 6609677: the interaction TSV and
    per-feature `features/id_<feat>.tsv` files (bz2-decompressed on the
    fly), plus LFM2b `users.tsv` demographics, from the record's public
    file bucket; `access_token` is appended while the record is
    restricted."""
    raw = os.path.join(save_path, "raw_dataset")
    feat_dir = os.path.join(raw, "features")
    os.makedirs(feat_dir, exist_ok=True)

    def zenodo_url(fname: str) -> str:
        url = f"{ONION_ZENODO_BUCKET}/{fname}?download=1"
        return url + f"&token={access_token}" if access_token else url

    if not skip_listening_history:
        _soft_write_bz2(zenodo_url("userid_trackid_timestamp.tsv.bz2"),
                        os.path.join(raw, "userid_trackid_timestamp.tsv"), force)
    _soft_write_bz2(LFM2B_2020_FILES["users.tsv"],
                    os.path.join(raw, "users.tsv"), force)
    names = [feature_names] if isinstance(feature_names, str) else feature_names
    for feat in names:
        _soft_write_bz2(zenodo_url(f"id_{feat}.tsv.bz2"),
                        os.path.join(feat_dir, f"id_{feat}.tsv"), force)
    return raw


def download_gdrive_dataset(name: str, save_path: str = "./") -> str:
    """KuaiRec / DeliveryHero-SG zip archives hosted on Google Drive.
    Uses `gdown` when available, else the uc?export=download endpoint
    (which fails for large gated files; the error says to fetch them by
    hand)."""
    if name not in GDRIVE_FILE_IDS:
        raise ValueError(f"no gdrive id for {name!r}; choose from "
                         f"{sorted(GDRIVE_FILE_IDS)}")
    file_id = GDRIVE_FILE_IDS[name]
    os.makedirs(save_path, exist_ok=True)
    target = os.path.join(save_path, "dataset.zip")
    if not os.path.exists(target):
        try:
            import gdown  # optional

            gdown.download(id=file_id, output=target)
        except ImportError:
            data = _fetch("https://drive.google.com/uc?export=download"
                          f"&id={file_id}")
            if data.lstrip()[:1] == b"<":
                raise RuntimeError(
                    f"gdrive file {file_id} needs the gdown confirm flow; "
                    f"install gdown or download it manually to {target!r}")
            with open(target, "wb") as fw:
                fw.write(data)
    with zipfile.ZipFile(target) as zf:
        zf.extractall(save_path)
    return save_path


def parse_ml1m(raw_dir: str, out_dir: str, min_rating: int = 3) -> str:
    """MovieLens-1M `.dat` files -> pipeline raw layout: ratings >= 3 as
    interactions, occupation id -> label, genres as '|'-joined tags."""
    os.makedirs(out_dir, exist_ok=True)
    read = dict(sep="::", engine="python", encoding="latin-1", header=None)
    ratings = pd.read_csv(os.path.join(raw_dir, "ratings.dat"),
                          names=["user", "item", "rating", "timestamp"], **read)
    users = pd.read_csv(os.path.join(raw_dir, "users.dat"),
                        names=["user", "gender", "age", "occupation", "zip"],
                        **read)
    movies = pd.read_csv(os.path.join(raw_dir, "movies.dat"),
                         names=["item", "title", "genres"], **read)

    lhs = ratings[ratings.rating >= min_rating][["user", "item", "timestamp"]]
    lhs.to_csv(os.path.join(out_dir, "listening_history.csv"), index=False)

    users = users.assign(
        occupation=users.occupation.map(lambda i: ML1M_OCCUPATIONS[int(i)]))
    users[["user", "gender", "age", "occupation"]].to_csv(
        os.path.join(out_dir, "user_features.csv"), index=False)
    movies[["item", "genres"]].to_csv(
        os.path.join(out_dir, "item_features.csv"), index=False)

    # optional MPNet plot embeddings produced by the plot crawler, copied
    # through if present
    plots = os.path.join(raw_dir, "features", "id_plot_mpnet.tsv")
    if os.path.exists(plots):
        df = pd.read_csv(plots, sep="\t", header=None)
        np.savez(os.path.join(out_dir, "item_plot_mpnet.npz"),
                 indices=df.iloc[:, 0].to_numpy(),
                 values=df.iloc[:, 1:].to_numpy(dtype=np.float32))
    return out_dir


def parse_onion(raw_dir: str, out_dir: str,
                item_feature_names: list[str] = ("ivec256", "bert", "musicnn"),
                user_feature_names: list[str] = ("gender", "age", "country"),
                year: int | None = None, month: int | None = None) -> str:
    """Onion / LFM raw files -> pipeline raw layout:
    `userid_trackid_timestamp.tsv` listening events (optionally a year /
    month of them), `users.tsv` demographics, and per-feature item files
    `features/id_<feat>.tsv[.bz2]` (first column the item id, the rest the
    vector)."""
    os.makedirs(out_dir, exist_ok=True)
    events = os.path.join(raw_dir, "userid_trackid_timestamp.tsv")
    lhs = pd.read_csv(events, sep="\t", names=["user", "item", "timestamp"],
                      header=0)
    if year is not None or month is not None:
        ts = pd.to_datetime(lhs.timestamp)
        if year is not None:
            lhs = lhs[ts.dt.year == int(year)]
        if month is not None:
            lhs = lhs[ts.dt.month == int(month)]
    lhs = lhs.assign(
        timestamp=pd.to_datetime(lhs.timestamp).astype("int64") // 10**9)
    lhs.to_csv(os.path.join(out_dir, "listening_history.csv"), index=False)

    users_path = os.path.join(raw_dir, "users.tsv")
    if os.path.exists(users_path):
        users = pd.read_csv(users_path, sep="\t").rename(
            columns={"user_id": "user"})
        keep = ["user"] + [c for c in user_feature_names if c in users.columns]
        users[keep].to_csv(os.path.join(out_dir, "user_features.csv"),
                           index=False)

    for feat in item_feature_names:
        base = os.path.join(raw_dir, "features", f"id_{feat}.tsv")
        path = base if os.path.exists(base) else base + ".bz2"
        if not os.path.exists(path):
            continue
        df = pd.read_csv(path, sep="\t", header=None)
        np.savez(os.path.join(out_dir, f"item_{feat}.npz"),
                 indices=df.iloc[:, 0].to_numpy(),
                 values=df.iloc[:, 1:].to_numpy(dtype=np.float32))
    return out_dir


def parse_amazon_meta_jsonl(meta_path: str, out_dir: str | None = None,
                            crawl_images: bool = False,
                            image_dir: str | None = None) -> dict:
    """Amazon-2024 item-metadata JSONL -> kept-item feature map: keep items
    whose record has a large image URL, a title and a description; returns
    ``{parent_asin: {image_url, title, description}}`` and writes it to
    ``ids_all_features.json`` when ``out_dir`` is given. The optional image
    crawl needs a network."""
    import json

    kept: dict[str, dict] = {}
    with open(meta_path) as fp:
        for line in fp:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            images = rec.get("images") or []
            large = images[0].get("large") if images else None
            desc = rec.get("description")
            if isinstance(desc, list):
                desc = " ".join(str(d) for d in desc)
            if large and rec.get("title") and desc:
                kept[rec["parent_asin"]] = {
                    "image_url": large,
                    "title": rec["title"],
                    "description": desc,
                }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "ids_all_features.json"), "w") as fp:
            json.dump(kept, fp)
    if crawl_images:
        _crawl_amazon_images(kept, image_dir or os.path.join(
            out_dir or ".", "images"))
    return kept


def _crawl_amazon_images(kept: dict, image_dir: str) -> list[str]:
    """Fetch the kept items' images (needs a network); the ids it could
    not fetch."""
    os.makedirs(image_dir, exist_ok=True)
    missing = []
    try:
        import requests
    except ImportError:
        log.warning("requests unavailable; skipping image crawl")
        return list(kept)
    have = {f.split(".")[0] for f in os.listdir(image_dir)}
    for item_id, feats in kept.items():
        if item_id in have:
            continue
        try:
            data = requests.get(feats["image_url"], timeout=30).content
            with open(os.path.join(image_dir, f"{item_id}.jpg"), "wb") as fh:
                fh.write(data)
        except Exception:
            missing.append(item_id)
    return missing


def parse_amazon_csv(csv_path: str, out_dir: str, min_rating: float = 3.0,
                     year_min: int | None = None,
                     verified_only: bool = False,
                     meta_jsonl: str | None = None) -> str:
    """Amazon ratings CSV (item,user,rating,timestamp[,verified]) -> raw
    layout: a rating threshold, an optional year window, optionally
    verified purchases only.

    With ``meta_jsonl`` the Amazon-2024 meta join runs too: ratings are
    filtered to items that `parse_amazon_meta_jsonl` keeps (large image,
    title and description), duplicates keep the first interaction, and
    ``item_features.csv`` gains the items' title / description text
    columns for feature extraction (`amazon_meta_text_features`)."""
    os.makedirs(out_dir, exist_ok=True)
    head = pd.read_csv(csv_path, nrows=1, header=None)
    names = ["item", "user", "rating", "timestamp"]
    if head.shape[1] >= 5:
        names.append("verified")
    df = pd.read_csv(csv_path, names=names)
    df = df[df.rating >= min_rating]
    if verified_only:
        if "verified" not in df.columns:
            raise ValueError("verified_only requires a 5th 'verified' column")
        df = df[df.verified.astype(str).str.lower().isin(("true", "1"))]
    if year_min is not None:
        df = df[pd.to_datetime(df.timestamp, unit="s").dt.year >= year_min]
    if meta_jsonl is not None:
        kept = parse_amazon_meta_jsonl(meta_jsonl, out_dir)
        df = df[df.item.isin(kept)]
        # first interaction only
        df = df.sort_values("timestamp").drop_duplicates(
            subset=["item", "user"])
        items = sorted(df.item.unique())
        pd.DataFrame({
            "item": items,
            "title": [kept[i]["title"] for i in items],
            "description": [kept[i]["description"] for i in items],
        }).to_csv(os.path.join(out_dir, "item_features.csv"), index=False)
    df[["user", "item", "timestamp"]].to_csv(
        os.path.join(out_dir, "listening_history.csv"), index=False)
    return out_dir


def amazon_meta_text_features(raw_dir: str, feature_name: str = "text_mpnet",
                              text_columns: tuple[str, ...] = ("title",
                                                               "description"),
                              embed_fn=None) -> str:
    """Item text -> VECTOR feature npz in the pipeline raw layout
    (``item_{feature_name}.npz``): MPNet embeddings of the Amazon item
    texts on the card. ``embed_fn(texts) -> [n, d]`` replaces the model
    (offline: no model download)."""
    from sibrar_tpu_torch.preprocessing.text_features import embed_texts

    feats = pd.read_csv(os.path.join(raw_dir, "item_features.csv"))
    texts = feats[list(text_columns)].astype(str).agg(". ".join, axis=1)
    emb = (embed_fn(texts.tolist()) if embed_fn is not None
           else embed_texts(texts.tolist()))
    out = os.path.join(raw_dir, f"item_{feature_name}.npz")
    np.savez(out, indices=feats["item"].to_numpy(),
             values=np.asarray(emb, dtype=np.float32))
    return out


def export_ecf_tag_files(tag_feature, n_items: int, out_dir: str) -> str:
    """Write `tag_idxs.csv` and `item_tag_idxs.csv` in ECF's layout from a
    tag `FeatureTable` (its codes padded with ``n_categories``)."""
    os.makedirs(out_dir, exist_ok=True)
    inv = {v: k for k, v in tag_feature.value_map.items()}
    pd.DataFrame({"tag_idx": sorted(inv), "tag": [inv[i] for i in sorted(inv)]}
                 ).to_csv(os.path.join(out_dir, "tag_idxs.csv"), index=False)
    table = np.asarray(tag_feature.table)
    rows, cols = [], []
    for item in range(n_items):
        for t in table[item]:
            if t != tag_feature.n_categories:
                rows.append(item)
                cols.append(int(t))
    pd.DataFrame({"item_idx": rows, "tag_idx": cols}).to_csv(
        os.path.join(out_dir, "item_tag_idxs.csv"), index=False)
    return out_dir
