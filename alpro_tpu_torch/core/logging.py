"""The port's logger (the ``LOGGER`` and ``add_log_to_file`` of
``alpro_tpu/core/logging.py``). The JSONL metrics writer, the running meter
and the no-op logger serve training only and are not ported (ROADMAP A14)."""

from __future__ import annotations

import logging
import os

_LOG_FMT = "%(asctime)s - %(levelname)s - %(name)s -   %(message)s"
_DATE_FMT = "%m/%d/%Y %H:%M:%S"
logging.basicConfig(format=_LOG_FMT, datefmt=_DATE_FMT, level=logging.INFO)
LOGGER = logging.getLogger("alpro_tpu_torch")


def add_log_to_file(log_path: str) -> None:
    """Also write the log to ``log_path`` (once per path)."""
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    path = os.path.abspath(log_path)
    if any(getattr(h, "baseFilename", None) == path for h in LOGGER.handlers):
        return
    fh = logging.FileHandler(log_path)
    fh.setFormatter(logging.Formatter(_LOG_FMT, datefmt=_DATE_FMT))
    LOGGER.addHandler(fh)
