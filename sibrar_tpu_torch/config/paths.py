"""Machine-specific data and results roots (port of
``sibrar_tpu/config/paths.py``; the same file and variables, so one
machine's settings serve both packages).

The roots come from ``$SIBRAR_DATA_ROOT`` / ``$SIBRAR_RESULTS_ROOT``, else
from the entry of this host's name (or ``default``) in
``~/.sibrar_tpu/paths.yml`` (``$SIBRAR_PATHS_FILE`` names another file):

    machines:
      my-h100-box: {data: /data/recsys, results: /results/recsys}
      default:     {data: ./data,       results: ./results}

``yaml`` is imported only when the file is read.
"""
from __future__ import annotations

import os
import socket
from typing import Optional

from sibrar_tpu_torch.config.schema import DatasetSplitType

_PATHS_FILE = os.environ.get(
    "SIBRAR_PATHS_FILE", os.path.expanduser("~/.sibrar_tpu/paths.yml"))


def _machine_entry() -> dict:
    if not os.path.exists(_PATHS_FILE):
        return {}
    import yaml

    with open(_PATHS_FILE) as fh:
        machines = (yaml.safe_load(fh) or {}).get("machines", {})
    host = socket.gethostname()
    return machines.get(host, machines.get("default", {}))


def get_data_root(default: str = "./data") -> str:
    return os.environ.get("SIBRAR_DATA_ROOT") or \
        _machine_entry().get("data", default)


def get_results_root(default: str = "./results") -> str:
    return os.environ.get("SIBRAR_RESULTS_ROOT") or \
        _machine_entry().get("results", default)


def get_dataset_path(dataset_name: str,
                     split_type: DatasetSplitType | str,
                     data_root: Optional[str] = None) -> str:
    """``{data_root}/{dataset}/{split_dir}`` (``random_split``,
    ``temporal_split``, ``cold_start_{user,item,both}``)."""
    st = DatasetSplitType(split_type) if isinstance(split_type, str) else split_type
    return os.path.join(data_root or get_data_root(), dataset_name, st.dir_name)
