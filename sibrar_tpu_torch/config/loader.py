"""Layered YAML / JSON config loading with ``base_configs`` inheritance
(port of ``sibrar_tpu/config/loader.py``).

- A config file may list ``base_configs`` (a path or a list of paths);
  relative paths resolve against the directory of the including file.
- Bases merge recursively; later bases beat earlier ones, and the leaf
  always wins. The merge is deep: dicts merge key by key, any other value
  (lists too) is replaced whole by the side that wins.

Of the port, only this module and the CLI layer above it (``experiment.py``,
``sweep.py`` and the ``python -m`` entry points) import ``yaml``;
``config/paths.py`` and ``utils/analysis.py`` import it inside their
functions.
"""
from __future__ import annotations

import copy
import json
import os
from typing import Any

import yaml

from sibrar_tpu_torch import config_from_dict
from sibrar_tpu_torch.config.schema import DatasetSplitType, ExperimentConfig
from sibrar_tpu_torch.utils.misc import generate_id


def merge_dicts(first: dict, second: dict) -> dict:
    """Deep-merge two dicts; on conflicts of non-dict values ``second``
    wins."""
    out: dict = {}
    for k in first.keys() | second.keys():
        if k in first and k in second:
            if isinstance(first[k], dict) and isinstance(second[k], dict):
                out[k] = merge_dicts(first[k], second[k])
            else:
                out[k] = copy.deepcopy(second[k])
        else:
            out[k] = copy.deepcopy(first[k] if k in first else second[k])
    return out


def parse_conf_file(config_path: str) -> dict:
    if not os.path.isfile(config_path):
        raise FileNotFoundError(
            f'Configuration file "{config_path}" not found!')
    ext = os.path.splitext(config_path)[1]
    with open(config_path) as fh:
        if ext in (".yml", ".yaml"):
            return yaml.safe_load(fh) or {}
        if ext == ".json":
            return json.load(fh)
    raise ValueError(f'Config files of type "{ext}" are not supported '
                     f'(.yml/.yaml/.json).')


def extend_by_base_configs(config: dict,
                           config_path: str | None = None) -> dict:
    """Fold the ``base_configs`` chain of ``config`` in."""
    all_base: dict = {}
    base_paths = config.get("base_configs") or []
    if isinstance(base_paths, str):
        base_paths = [base_paths]
    for base_path in base_paths:
        if not os.path.isabs(base_path) and config_path is not None:
            base_path = os.path.join(os.path.dirname(config_path), base_path)
        all_base = merge_dicts(all_base, load_config_dict(base_path))
    merged = merge_dicts(all_base, config)
    merged.pop("base_configs", None)
    return merged


def load_config_dict(config_path: str) -> dict:
    return extend_by_base_configs(parse_conf_file(config_path), config_path)


def update_nested_dict(d: dict, key: str, value: Any) -> None:
    """Set ``d['a']['b']['c'] = value`` for the key ``'a.b.c'``, creating
    levels; an empty YAML section (None) counts as an empty dict, and a
    scalar on the way raises."""
    keys = key.split(".")
    cur = d
    for i, k in enumerate(keys[:-1]):
        nxt = cur.setdefault(k, {})
        if nxt is None:
            nxt = cur[k] = {}
        elif not isinstance(nxt, dict):
            raise ValueError(
                f"config key {'.'.join(keys[:i + 1])!r} holds a scalar "
                f"({nxt!r}); cannot set nested key {key!r}")
        cur = nxt
    cur[keys[-1]] = value


def nested_dict_get(d: dict, key: str, default: Any = None) -> Any:
    """``d['a']['b']['c']`` for the key ``'a.b.c'``, or ``default`` where
    a level is missing or not a dict."""
    keys = key.split(".")
    cur: Any = d
    for k in keys[:-1]:
        nxt = cur.get(k) if isinstance(cur, dict) else None
        if not isinstance(nxt, dict):
            return default
        cur = nxt
    return cur.get(keys[-1], default) if isinstance(cur, dict) else default


def get_config(config_path: str, algorithm: str | None = None,
               dataset_name: str | None = None,
               split_type: str | None = None,
               overrides: dict | None = None) -> ExperimentConfig:
    """A config file, its ``base_configs`` folded in, as an
    `ExperimentConfig`. The command line's algorithm, dataset name and split
    type are authoritative: a conflicting value in the file raises. Then
    ``overrides`` (dotted keys) are set, and ``run_id`` defaults to a
    timestamped id."""
    conf = load_config_dict(config_path)
    for key, value in (("algorithm", algorithm),
                       ("dataset_name", dataset_name),
                       ("split_type", split_type)):
        if value is None:
            continue
        if key in conf and conf[key] != value:
            raise ValueError(
                f"config file sets {key}={conf[key]!r} but the command line "
                f"says {value!r}; the command line is authoritative — remove "
                f"the key from the file or change the flag")
        conf[key] = value
    for key, value in (overrides or {}).items():
        update_nested_dict(conf, key, value)
    conf.setdefault("run_id", generate_id(conf.get("algorithm")))
    return config_from_dict(ExperimentConfig, conf)


def yaml_save(file_path: str, data: Any) -> None:
    with open(file_path, "w") as fh:
        yaml.safe_dump(data, fh)


def load_split_type(data_path: str) -> DatasetSplitType:
    """The split type of an artifact directory, from the preprocessing's
    ``used_config.yaml``; random when the file is missing."""
    cfg_file = os.path.join(data_path, "used_config.yaml")
    if not os.path.exists(cfg_file):
        return DatasetSplitType.RANDOM
    with open(cfg_file) as fh:
        split = (yaml.safe_load(fh) or {}).get("split") or {}
    split_type = split.get("split_type", "random")
    if split_type == "coldstart":
        return DatasetSplitType(
            f"cold_start_{split.get('cold_start_type', 'user')}")
    return DatasetSplitType(split_type)
