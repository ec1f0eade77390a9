"""The program's own spans (``alpro_tpu_torch/core/trace.py``) over a few
micro-steps of a training window, and the window's schedule around them.

In a ``--trace 1`` run a training driver turns the spans on for
``span_steps`` micro-steps, then off, drains them into ``info["program"]``
and only then starts the device trace: no ``alpro.*`` annotation enters the
trace, whose parse would count their device copies as busy. A program
without the spans module, or without the span a reader asks for, reads
nothing. Spans travel as plain tuples (name, start, end, id, parent,
thread, rid), so that a driver's worker process can hand them over."""

from __future__ import annotations

import time
from typing import Optional

from perfbench.lib.trace import Tracer


def _trace_module():
    try:
        from alpro_tpu_torch.core import trace
    except ImportError:
        return None
    return trace


def ms_per_step(info: dict, name: str, step: str = "alpro.step") -> Optional[float]:
    """The mean host ms a micro-step inside the spans called ``name``: their
    summed durations over the count of ``step`` spans. None where the spans
    were not taken, some were dropped, or ``name`` never opened."""
    prog = info.get("program")
    if not prog or prog["dropped"]:
        return None
    spans = prog["spans"]
    steps = sum(1 for s in spans if s[0] == step)
    hits = [s for s in spans if s[0] == name]
    if not steps or not hits:
        return None
    return 1000.0 * sum(s[2] - s[1] for s in hits) / steps


class Window:
    """The schedule of a training window, one call of ``before()`` and one of
    ``after()`` around each micro-step. With ``trace``: from ``span_at`` of
    the window the program's spans are on for ``span_steps`` micro-steps;
    then the device trace (``lead`` only: the process that traces) takes
    ``trace_steps`` micro-steps. ``after()`` tells whether the window may
    close: past the deadline with the trace, if any, stopped. With
    ``steps``, the window is that many micro-steps instead (at least enough
    for the spans and the trace after ``span_at`` of them), and ``span_at``
    a share of them, so that processes that agreed on ``steps`` close it
    together without a word between them."""

    def __init__(self, ctx, span_steps: int, trace_steps: int, span_at: float = 0.3,
                 lead: bool = True, steps: Optional[int] = None):
        self.ctx, self.span_steps, self.trace_steps = ctx, span_steps, trace_steps
        self.span_at, self.lead = span_at, lead
        self.micro, self.phase = 0, "plain"    # plain → spans → tracing → done
        self.mark, self.tracer, self.program = 0, None, None
        self.steps, self.span_from = steps, None
        if steps is not None:
            self.span_from = int(span_at * steps)
            self.steps = max(steps, self.span_from + span_steps + trace_steps)
        self.t0 = time.perf_counter()
        self.deadline = self.t0 + ctx.seconds

    def _spans_due(self) -> bool:
        if self.steps is not None:
            return self.micro >= self.span_from
        return time.perf_counter() - self.t0 >= self.span_at * self.ctx.seconds

    def before(self) -> None:
        if not (self.ctx.trace and self.lead):
            return
        if self.phase == "plain" and self._spans_due():
            mod = _trace_module()
            if mod is not None:
                mod.disable()
                mod.drain()
                mod.enable()
            self.phase, self.mark = "spans", self.micro
        if self.phase == "spans" and self.micro - self.mark >= self.span_steps:
            mod = _trace_module()
            if mod is not None:
                mod.disable()
                spans, dropped = mod.drain()
                self.program = {"spans": [tuple(s) for s in spans], "dropped": int(dropped)}
            self.tracer = Tracer(self.ctx.spans).start()
            self.phase, self.mark = "tracing", self.micro

    def after(self) -> bool:
        self.micro += 1
        if self.phase == "tracing" and self.micro - self.mark == self.trace_steps:
            self.tracer.stop()
            self.phase = "done"
        if self.steps is not None:
            return self.micro >= self.steps
        traced = not (self.ctx.trace and self.lead) or self.phase == "done"
        return time.perf_counter() >= self.deadline and traced

    @property
    def traced_steps(self) -> int:
        return self.trace_steps if self.tracer is not None else 0

    @property
    def traced_s(self) -> float:
        """The traced span's seconds and the tracer's own host time."""
        if self.tracer is None:
            return 0.0
        return self.tracer.stopped_at - self.tracer.started_at + self.tracer.host_s
