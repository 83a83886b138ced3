"""Run ids, seeding, result logging and stdout helpers (port of
``sibrar_tpu/utils/misc.py``: ``generate_id``, ``reproducible``,
``log_info_results``, ``FunctionWrapper``, ``Tee``, ``silence_stdout``)."""
from __future__ import annotations

import contextlib
import io
import logging
import random
import sys
import traceback
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


class FunctionWrapper:
    """A picklable callable that wraps ``function``."""

    def __init__(self, function):
        self.function = function

    def __call__(self, *args, **kwargs):
        return self.function(*args, **kwargs)

    def __repr__(self):
        return f"FunctionWrapper({self.function!r})"


class Tee:
    """Duplicate stdout to a log file (appending); an exception that ends
    the block is written to the file too."""

    def __init__(self, file_path: str):
        self.file_path = file_path
        self._file = None
        self._stdout = None

    def __enter__(self):
        self._file = open(self.file_path, "a")
        self._stdout = sys.stdout
        sys.stdout = self
        return self

    def __exit__(self, exc_type, exc_value, tb):
        if exc_type is not None:
            self._file.write(traceback.format_exc())
        sys.stdout = self._stdout
        self._file.close()
        return False

    def write(self, data):
        self._file.write(data)
        self._stdout.write(data)

    def flush(self):
        self._file.flush()
        self._stdout.flush()


@contextlib.contextmanager
def silence_stdout():
    """Suppress stdout inside the block (around chatty third-party
    loaders); yields the buffer that took it."""
    sink = io.StringIO()
    with contextlib.redirect_stdout(sink):
        yield sink
