"""Entity feature tables (port of ``sibrar_tpu/data/feature.py``:
``Feature.build``, ``Feature.dense_table``, ``create_padded_array``).

`build_feature` turns one feature's raw values, as the artifact reader
gives them, into a `FeatureTable` row-aligned to the entity index, with the
JAX package's tables and labels:

- categorical: codes into the sorted labels of the raw values united with
  ``reference_values``; rows without a value hold code 0;
- tag: each value split on ``|`` (or any iterable of tags), codes into the
  sorted tag vocabulary, each row's distinct codes ascending, padded with
  the vocabulary size, as wide as the longest row;
- discrete and continuous: f32, zeros elsewhere; vector and matrix: f32
  rows at ``indices``, zeros elsewhere; sequence: the literal lists, in
  their own dtype. These three are kind ``"numeric"``.

``value_map`` (label -> code) keeps the labels' Python types (an integer
column gives integer labels, which sort 2 < 10): group-metric keys are made
from them. numpy only.
"""
from __future__ import annotations

from ast import literal_eval
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np

from sibrar_tpu_torch.config.schema import FeatureDefinition, FeatureType

# host budget of `FeatureTable.dense_table`'s multi-hot / one-hot tables (the
# JAX package's): a 100k x 50k multi-hot would ask for 20 GB otherwise
DENSE_TABLE_MAX_BYTES = 2 * 2**30


@dataclass
class FeatureTable:
    """One feature over all entities, row-aligned to the entity index:
    ``kind`` "numeric" (float rows), "tag" (padded tag codes, pad id ==
    ``n_categories``) or "categorical" (codes). ``value_map`` (label ->
    code) names the codes; group metrics need it for their labels.
    ``present`` marks the entities the raw data had a row for (None: all)."""

    table: np.ndarray
    kind: str
    n_categories: int = 0
    value_map: Optional[dict] = None
    name: str = ""
    present: Optional[np.ndarray] = None

    def dense_table(self) -> np.ndarray:
        """Float32 ``[n_entities, d]`` rows for similarity math (JAX
        ``Feature.dense_table``, which ItemFeatureKNN reads): tag codes
        become multi-hot 0/1 rows, categorical codes one-hot rows (absent
        entities all zero), numeric tables pass through as float32, a 1-D
        one as a column, wider ones flattened per entity. A multi-hot or
        one-hot table above `DENSE_TABLE_MAX_BYTES` raises ValueError."""
        n = self.table.shape[0]
        if self.kind in ("tag", "categorical"):
            dense_bytes = 4 * n * self.n_categories
            if dense_bytes > DENSE_TABLE_MAX_BYTES:
                raise ValueError(
                    f"dense_table of {self.name!r} would materialize "
                    f"{n}x{self.n_categories} float32 "
                    f"({dense_bytes / 2**30:.1f} GiB > "
                    f"{DENSE_TABLE_MAX_BYTES / 2**30:.1f} GiB budget); "
                    "use value_indices_groups / a sparse representation "
                    "for this feature instead")
            out = np.zeros((n, self.n_categories), dtype=np.float32)
            if self.kind == "tag":
                valid = self.table != self.n_categories
                rows = np.repeat(np.arange(n), valid.sum(axis=1))
                out[rows, self.table[valid]] = 1.0
            else:
                present = (np.ones(n, bool) if self.present is None
                           else self.present)
                out[present, self.table[present]] = 1.0
            return out
        table = np.asarray(self.table, dtype=np.float32)
        if table.ndim == 1:
            return table[:, None]
        return table.reshape(n, -1) if table.ndim > 2 else table


def create_padded_array(lists: Sequence[Sequence[int]],
                        padding_idx: int) -> np.ndarray:
    """Pad ragged int lists into a [len(lists), max(longest, 1)] array."""
    width = max(max((len(li) for li in lists), default=0), 1)
    out = np.full((len(lists), width), padding_idx, dtype=np.int32)
    for i, li in enumerate(lists):
        out[i, :len(li)] = list(li)
    return out


def build_feature(definition: FeatureDefinition, raw_values: Any,
                  n_entities: int, indices: Optional[np.ndarray] = None,
                  reference_values: Any = None,
                  tag_split_sep: str = "|") -> FeatureTable:
    """The `FeatureTable` of ``raw_values`` (one per entity of ``indices``,
    default 0..n-1) over ``n_entities`` entities, as ``Feature.build``
    builds its table."""
    n_raw = (raw_values.shape[0] if hasattr(raw_values, "shape")
             else len(raw_values))
    indices = np.asarray(np.arange(n_raw) if indices is None else indices)
    if n_raw != len(indices):
        raise ValueError(f"Provided indices must match size of supplied "
                         f"values ({n_raw} != {len(indices)})")
    present = np.zeros(n_entities, dtype=bool)
    present[indices] = True
    ft = definition.type
    named = {"name": definition.name, "present": present}
    if ft == FeatureType.CATEGORICAL:
        unique = set(raw_values)
        if reference_values is not None:
            unique |= set(reference_values)
        labels = sorted(unique)
        value_map = {lbl: i for i, lbl in enumerate(labels)}
        table = np.zeros(n_entities, dtype=np.int32)
        table[indices] = np.array([value_map[v] for v in raw_values],
                                  dtype=np.int32)
        return FeatureTable(table, "categorical", len(labels), value_map,
                            **named)
    if ft == FeatureType.TAG:
        def to_tags(v):  # a missing value (NaN) raises, as in JAX
            return set(v.split(tag_split_sep)) if isinstance(v, str) \
                else set(v)

        raw_tags = [to_tags(v) for v in raw_values]
        unique = set().union(*raw_tags)
        if reference_values is not None:
            unique |= set().union(*(to_tags(v) for v in reference_values))
        labels = sorted(unique)
        value_map = {lbl: i for i, lbl in enumerate(labels)}
        pad = len(labels)
        rows = create_padded_array(
            [sorted(value_map[t] for t in tags) for tags in raw_tags], pad)
        table = np.full((n_entities, rows.shape[1]), pad, dtype=np.int32)
        table[indices] = rows
        return FeatureTable(table, "tag", pad, value_map, **named)
    if ft == FeatureType.SEQUENCE:
        rows = np.stack([np.asarray(literal_eval(v) if isinstance(v, str)
                                    else v) for v in raw_values])
        table = np.zeros((n_entities, rows.shape[1]), dtype=rows.dtype)
    elif ft in (FeatureType.DISCRETE, FeatureType.CONTINUOUS):
        rows = np.asarray(raw_values, dtype=np.float32)
        table = np.zeros(n_entities, dtype=np.float32)
    elif ft in (FeatureType.VECTOR, FeatureType.MATRIX):
        if isinstance(raw_values, list):
            rows = np.stack([np.asarray(v) for v in raw_values])
        elif hasattr(raw_values, "toarray"):  # scipy sparse
            rows = raw_values.toarray()
        else:
            rows = np.asarray(raw_values)
        rows = rows.astype(np.float32)
        table = np.zeros((n_entities,) + rows.shape[1:], dtype=np.float32)
    else:
        raise ValueError(f"FeatureType {ft!r} is not supported")
    table[indices] = rows
    return FeatureTable(table, "numeric", **named)
