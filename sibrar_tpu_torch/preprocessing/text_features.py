"""Text features: sentence embeddings for items and users (port of
``sibrar_tpu/preprocessing/text_features.py``).

- `embed_texts`: MPNet sentence embeddings (``all-mpnet-base-v2``) on the
  card by default, through ``sentence-transformers`` when present, else
  ``transformers`` mean pooling, else a clear error;
- `generate_sentences`: tabular user metadata verbalized ("The user is a
  25 year old female ...") before embedding;
- `store_text_feature`, `embed_dataframe_texts`: float32 [n, d] rows as a
  ``.npz`` vector feature;
- `extract_title_and_year`, `crawl_wikipedia_plots`: movie titles and
  their plots (the crawl needs the ``wikipedia`` package and a network,
  or a cached CSV).
"""
from __future__ import annotations

import os
import re
from typing import Optional, Sequence

import numpy as np
import pandas as pd
import torch

from sibrar_tpu_torch.preprocessing.filtering import as_device

DEFAULT_MODEL = "sentence-transformers/all-mpnet-base-v2"


def embed_texts(texts: Sequence[str], model_name: str = DEFAULT_MODEL,
                batch_size: int = 32, device: str = "cuda") -> np.ndarray:
    """Sentence embeddings [n, d] via SBERT or transformers mean-pooling,
    on ``device`` (the card unless ``"cpu"``; raises without a card)."""
    as_device(device)
    try:
        from sentence_transformers import SentenceTransformer

        model = SentenceTransformer(model_name, device=device)
        return np.asarray(model.encode(list(texts), batch_size=batch_size,
                                       show_progress_bar=False),
                          dtype=np.float32)
    except ImportError:
        pass
    try:
        from transformers import AutoModel, AutoTokenizer
    except ImportError as e:
        raise RuntimeError(
            "text embedding needs sentence-transformers or transformers"
        ) from e

    tokenizer = AutoTokenizer.from_pretrained(model_name)
    model = AutoModel.from_pretrained(model_name).to(device).eval()
    out = []
    with torch.no_grad():
        for start in range(0, len(texts), batch_size):
            batch = list(texts[start:start + batch_size])
            enc = tokenizer(batch, padding=True, truncation=True,
                            max_length=384, return_tensors="pt").to(device)
            hidden = model(**enc).last_hidden_state  # [b, t, d]
            mask = enc["attention_mask"][..., None].float()
            pooled = (hidden * mask).sum(1) / mask.sum(1).clamp(min=1e-9)
            out.append(pooled.cpu().numpy())
    return np.concatenate(out).astype(np.float32)


def generate_sentences(df, column_templates: dict[str, str],
                       joiner: str = " ") -> list[str]:
    """Verbalize tabular metadata rows into sentences: for each row, apply
    each column's template (e.g. ``{"age": "The user is {} years old.",
    "gender": "Their gender is {}."}``), skipping missing values."""
    sentences = []
    for _, row in df.iterrows():
        parts = []
        for column, template in column_templates.items():
            value = row.get(column)
            if value is None or (isinstance(value, float) and np.isnan(value)):
                continue
            parts.append(template.format(value))
        sentences.append(joiner.join(parts))
    return sentences


def store_text_feature(out_path: str, indices: np.ndarray,
                       embeddings: np.ndarray) -> str:
    """Persist as a `.npz` vector feature of the raw layout."""
    np.savez(out_path, indices=np.asarray(indices),
             values=np.asarray(embeddings, dtype=np.float32))
    return out_path


def embed_dataframe_texts(df, text_column: str, index_column: str,
                          out_path: Optional[str] = None,
                          model_name: str = DEFAULT_MODEL,
                          device: str = "cuda") -> np.ndarray:
    """End to end: texts in a dataframe column -> embeddings (optionally
    stored)."""
    mask = df[text_column].notna()
    emb = embed_texts(df.loc[mask, text_column].tolist(),
                      model_name=model_name, device=device)
    if out_path:
        store_text_feature(out_path, df.loc[mask, index_column].to_numpy(),
                           emb)
    return emb


def extract_title_and_year(title: str) -> tuple[str, Optional[int]]:
    """Split "Heat (1995)" -> ("Heat", 1995)."""
    m = re.search(r"(.*)[(](\d+)[)]", title)
    if not m:
        return title.strip(), None
    return m[1].strip(), int(m[2])


def crawl_wikipedia_plots(titles: Sequence[str],
                          cache_csv: Optional[str] = None) -> list[str]:
    """Wikipedia plot crawl for movie titles: search the page name, fetch
    the page (preferring 'film' disambiguations), and cut out the Plot
    section. Network-gated: raises a clear error when the `wikipedia`
    package or the network is unavailable; pass `cache_csv` to reuse a
    previous crawl (its ``title, plot`` CSV).
    """
    if cache_csv and os.path.isfile(cache_csv):
        return pd.read_csv(cache_csv)["plot"].fillna("").tolist()
    try:
        import wikipedia
    except ImportError as e:
        raise RuntimeError(
            "crawl_wikipedia_plots needs the `wikipedia` package and network "
            "access; provide `cache_csv` from a previous crawl instead") from e

    def plot_of(title: str) -> str:
        names = wikipedia.search(title)
        if not names:
            return ""
        try:
            try:
                content = str(wikipedia.page(names[0], auto_suggest=False)
                              .content)
            except wikipedia.DisambiguationError as exc:
                content = ""
                for option in exc.options:
                    if "film" in option:
                        content = str(wikipedia.page(option,
                                                     auto_suggest=False)
                                      .content)
                        break
        except Exception:  # noqa: BLE001 (PageError, KeyError)
            return ""
        m = re.search("Plot ==(.*?)=+ [A-Z]", content.replace("\n", ""))
        return m.group(1) if m else ""

    plots = [plot_of(t) for t in titles]
    if cache_csv:
        pd.DataFrame({"title": list(titles), "plot": plots}).to_csv(
            cache_csv, index=False)
    return plots
