"""Run ids, seeding and result logging (port of
``sibrar_tpu/utils/misc.py``: ``generate_id``, ``reproducible``,
``log_info_results``)."""
from __future__ import annotations

import logging
import random
from datetime import datetime

import numpy as np
import torch


def generate_id(prefix: str | None = None, postfix: str | None = None) -> str:
    """Timestamped run id: ``{prefix}_{yymmdd-HHMMSS}_{postfix}``."""
    dtstr = datetime.now().strftime("%y%m%d-%H%M%S")
    return "_".join(p for p in (prefix, dtstr, postfix) if p)


def reproducible(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators (the CPU's and
    every CUDA device's). The trainer's draws come from its own seeded
    ``torch.Generator``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)  # seeds the CUDA generators too


def log_info_results(metrics: dict) -> None:
    """Log each metric at INFO level."""
    for key, value in metrics.items():
        logging.info(f"{key}: {value}")
