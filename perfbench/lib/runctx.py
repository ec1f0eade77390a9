"""What ``run.py`` hands a driver, and what a driver hands back."""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, List, Optional

import torch

from perfbench.lib.harness import Cell, Check
from perfbench.lib.spans import Spans
from perfbench.lib.trace import TraceRun


@dataclasses.dataclass
class RunCtx:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    spans: Spans
    control: bool = False            # the fp8 reference in the program's place
    rate: Optional[float] = None     # an open loop's rate in place of the traffic's
    t_start: float = 0.0             # the process's start on time.perf_counter

    def phase(self, name: str) -> None:
        """Note on standard error when a phase of the run ends."""
        print(f"perfbench: {name} done at {time.perf_counter() - self.t_start:.3f} s",
              file=sys.stderr)


@dataclasses.dataclass
class Outcome:
    """``e2e``: end-to-end metric → value; ``checks``: the numbers that
    decide ``correct``; ``trace``: the traced span (``--trace 1``);
    ``info``: what the per-layer readers read besides the trace."""

    setup_end: float
    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Check]
    peak_bytes: int
    trace: Optional[TraceRun] = None
    info: Dict[str, object] = dataclasses.field(default_factory=dict)


def check(cell: Cell, name: str, value: float) -> Check:
    """``name``'s reading beside the cell's limit (nan where none is set:
    the check fails)."""
    return Check(name, float(value), cell.limits.get(name, float("nan")))
