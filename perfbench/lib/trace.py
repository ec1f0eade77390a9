"""A device trace of a steady span inside the measured window, and what the
per-layer readers and the result line take from it.

``torch.profiler`` (CUPTI) records the span; the span itself is the
record_function ``pb.traced_window``, which ends after a synchronize, so
``window_s`` holds all the device work that the traced calls queued."""

from __future__ import annotations

import dataclasses
import re
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from perfbench.lib.spans import Spans

WINDOW = "pb.traced_window"
_ANON = re.compile(r"\(anonymous namespace\)::")


def kernel_base_name(name: str) -> str:
    """``void ns::(anonymous namespace)::gemm_wgmma<2, 1, float>(Params)`` →
    ``gemm_wgmma``: the function's own name, without namespaces, template
    arguments, parameters or return type."""
    head = re.split(r"[<(]", _ANON.sub("", name.strip()), maxsplit=1)[0]
    return head.split()[-1].split("::")[-1] if head.split() else name


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


@dataclasses.dataclass
class TraceRun:
    """What one traced span holds. Times in microseconds of the trace's
    clock; ``kernels`` are the device operations (kernels, copies, sets)
    that lie in the span."""

    window: Tuple[float, float]
    kernels: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy(self) -> List[Tuple[float, float]]:
        return _union([(a, b) for _, a, b in self.kernels])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def device_seconds(self, names: Optional[set] = None) -> float:
        """Summed durations of the device operations whose base name is in
        ``names`` (all when None)."""
        return sum(b - a for n, a, b in self.kernels
                   if names is None or kernel_base_name(n) in names) * 1e-6

    def gaps(self) -> List[Tuple[float, float]]:
        busy = self.busy()
        lo, hi = self.window
        edges = [lo] + [x for ab in busy for x in ab] + [hi]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def _host_at(self, t: float) -> str:
        """The innermost (shortest) harness span covering ``t``."""
        covering = [(b - a, name) for name, a, b in self.host if a <= t < b]
        return min(covering)[1][3:] if covering else "outside_harness_spans"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the harness span the host was in when each began."""
        ops: Dict[str, float] = defaultdict(float)
        for n, a, b in self.kernels:
            ops[n[:120]] += (b - a) * 1e-6
        idle: Dict[str, float] = defaultdict(float)
        for a, b in self.gaps():
            idle[self._host_at(a)] += (b - a) * 1e-6
        srt = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": srt(ops), "idle_gaps": srt(idle)}


def _device_type_is_cuda(evt) -> bool:
    dt = getattr(evt, "device_type", None)
    return dt is not None and getattr(dt, "name", str(dt)).upper().endswith("CUDA")


class Tracer:
    """Traces from ``start()`` to ``stop()``; ``run`` parses the trace into
    a ``TraceRun`` when first read (after the window: parsing takes
    seconds). ``host_s`` is the host time the tracer itself took inside the
    window (starting, synchronizing, stopping), which the window's host
    shares leave out."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.stopped = False
        self.host_s = 0.0
        self._run: Optional[TraceRun] = None

    def start(self) -> "Tracer":
        t0 = time.perf_counter()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        torch.cuda.synchronize()   # nothing queued before the span runs inside it
        self.spans.tracing = True
        self._rf = torch.profiler.record_function(WINDOW)
        self._rf.__enter__()
        self.started_at = time.perf_counter()
        self.host_s += self.started_at - t0
        return self

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.stopped_at = time.perf_counter()
        self._rf.__exit__(None, None, None)
        self.spans.tracing = False
        self._prof.__exit__(None, None, None)
        self.stopped = True
        self.host_s += time.perf_counter() - self.stopped_at

    @property
    def run(self) -> TraceRun:
        if self._run is None:
            self._run = parse(self._prof.events())
        return self._run


def parse(events) -> TraceRun:
    """Device operations and harness spans of a profiler's events."""
    window, device, host = None, [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if _device_type_is_cuda(e):
            if not e.name.startswith("pb."):   # not the annotations' device copies
                device.append((e.name, a, b))
        elif e.name == WINDOW:
            window = (a, b)
        elif e.name.startswith("pb."):
            host.append((e.name, a, b))
    if window is None:
        raise RuntimeError("the trace holds no traced window span")
    lo, hi = window
    kernels = [(n, max(a, lo), min(b, hi)) for n, a, b in device if b > lo and a < hi]
    return TraceRun(window=window, kernels=kernels, host=host)
