"""Seeding, retried IO and the training-meta snapshot (the port's copy of
``alpro_tpu/core/misc.py``; its ``parse_compiler_options`` is XLA's and has
no counterpart, and its ``maybe_profile`` is ``core/trace.py``'s)."""

from __future__ import annotations

import json
import os
import random
import time
import zipfile
from typing import Callable

import numpy as np
import torch

from alpro_tpu_torch.core.logging import LOGGER

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def set_random_seed(seed: int) -> np.random.Generator:
    """Seed numpy's, Python's and torch's global generators and return a
    numpy Generator. The train steps' own randomness comes from explicit
    generators (``train/step.py::step_generator``)."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    return np.random.default_rng(seed)


def retry_io(fn: Callable, n_retries: int = 10, sleep_s: float = 1.0, what: str = "io"):
    """``fn()``, retried ``n_retries`` times on ``OSError`` (a flaky
    filesystem); the last attempt's error propagates."""
    for attempt in range(n_retries):
        try:
            return fn()
        except OSError as e:
            LOGGER.warning("%s failed (attempt %d/%d): %s", what, attempt + 1, n_retries, e)
            time.sleep(sleep_s)
    return fn()


def _jsonable(v) -> bool:
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False


def save_training_meta(output_dir: str, cfg: dict) -> None:
    """Snapshot the run's config (its JSON-serialisable keys) to
    ``output_dir/log/args.json`` — the file an inference run over
    ``output_dir`` merges back (``cli/common.py::merge_stored_args``) — and
    the port's sources to ``output_dir/log/code.zip``, so that a run can be
    reproduced from its output."""
    log_dir = os.path.join(output_dir, "log")
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "args.json"), "w") as f:
        json.dump({k: v for k, v in cfg.items() if _jsonable(v)}, f, indent=2)
    root = os.path.dirname(_PACKAGE)
    with zipfile.ZipFile(os.path.join(log_dir, "code.zip"), "w", zipfile.ZIP_DEFLATED) as zf:
        for base, dirs, files in os.walk(_PACKAGE):
            dirs[:] = [d for d in dirs if d not in ("__pycache__", "_build")]
            for name in files:
                if name.endswith((".py", ".cu", ".cuh", ".json")):
                    full = os.path.join(base, name)
                    zf.write(full, os.path.relpath(full, root))
    LOGGER.info("saved training meta to %s", log_dir)
