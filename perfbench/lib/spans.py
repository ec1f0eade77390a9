"""The harness's own host spans around the calls it makes into the program.

A span is (name, start, end) on ``time.perf_counter``. While a trace is
being taken the span is also a ``torch.profiler.record_function`` named
``pb.<name>``, so the trace can tell what the host was doing in a gap."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch


class Spans:
    def __init__(self):
        self.spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        self.tracing = False

    @contextlib.contextmanager
    def span(self, name: str):
        rf = (torch.profiler.record_function("pb." + name) if self.tracing
              else contextlib.nullcontext())
        t0 = time.perf_counter()
        try:
            with rf:
                yield
        finally:
            self.spans[name].append((t0, time.perf_counter()))

    def total(self, name: str, lo: float = float("-inf"), hi: float = float("inf")) -> float:
        """Seconds of ``name`` spans inside [lo, hi]."""
        return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in self.spans.get(name, ()))
