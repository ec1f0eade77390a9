"""Logging and metering (the port's copy of ``alpro_tpu/core/logging.py``):
the ``LOGGER``, ``add_log_to_file``, the ``TB_LOGGER`` scalar writer and
``RunningMeter``'s EWMA smoothing. The scalar sink is a JSONL file,
``<dir>/metrics.jsonl``, of rows {step, key, value, ts}, and the ``NoOp``
sink that stands in for it on every process but rank 0.

One difference: the JAX loop never advances its logger's step, so every row
it writes says step 0; the port's train loop sets ``TB_LOGGER.global_step``
to the step it logs (ROADMAP C3).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

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


class MetricsLogger:
    """Scalar logger with a global step: JSONL rows {step, key, value, ts}
    appended to ``<dir>/metrics.jsonl`` once ``create`` named the
    directory; before that every call is a no-op."""

    def __init__(self):
        self._path: Optional[str] = None
        self._fh = None
        self.global_step = 0

    def create(self, output_dir: str) -> None:
        """Write to ``output_dir/metrics.jsonl`` from now on (appending), at
        global step 0."""
        self.close()
        os.makedirs(output_dir, exist_ok=True)
        self._path = os.path.join(output_dir, "metrics.jsonl")
        self._fh = open(self._path, "a")
        self.global_step = 0

    def add_scalar(self, key: str, value, step: Optional[int] = None) -> None:
        if self._fh is None:
            return
        row = {"step": self.global_step if step is None else step, "key": key,
               "value": float(value), "ts": time.time()}
        self._fh.write(json.dumps(row) + "\n")

    def log_scalar_dict(self, log_dict, prefix: str = "") -> None:
        if self._fh is None:
            return
        prefix = prefix + "_" if prefix and not prefix.endswith("_") else prefix
        for k, v in log_dict.items():
            self.add_scalar(prefix + k, v)
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


TB_LOGGER = MetricsLogger()


class RunningMeter:
    """EWMA smoothing of a scalar series (NaN values are skipped)."""

    def __init__(self, name: str, val: Optional[float] = None, smooth: float = 0.99):
        self._name = name
        self._sm = smooth
        self._val = val

    def __call__(self, value: float) -> None:
        value = float(value)
        if value != value:  # skip nan
            return
        self._val = value if self._val is None else self._val * self._sm + value * (1 - self._sm)

    def __str__(self) -> str:
        return f"{self._name}: {self._val:.4f}"

    @property
    def val(self) -> Optional[float]:
        return self._val

    @property
    def name(self) -> str:
        return self._name


class NoOp:
    """Swallows every call: the metrics sink of a process other than rank 0
    (reference ``logger.py:92``)."""

    def __getattr__(self, _name):
        return self.noop

    def noop(self, *args, **kwargs):
        return
