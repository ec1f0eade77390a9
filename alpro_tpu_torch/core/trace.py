"""The port's tracing: spans at the program's layer boundaries, and
``maybe_profile``, the ``--profile`` Chrome trace (the counterpart of
``alpro_tpu/core/misc.py::maybe_profile``).

A span, ``with span(name, rid=None):``, records its name
(``alpro.<name>``), its start and end on ``time.perf_counter``, its thread,
its ``id``, and its parent: the ``id`` of the innermost span open on the
same thread when it opened, so a request's spans are those under its top
span. It may carry a request id (``rid``: the micro-step's number; a span
given none takes its parent's).

Spans are off by default. Off, ``span`` reads one module flag and returns a
shared null context: it records nothing and never touches the profiler.
``enable()`` turns them on, and each closed span is kept in memory until
``drain()`` hands them over, up to ``CAP`` spans; those past it are counted
as dropped, and ``drain`` returns that count beside the spans so that a
reader can refuse a store with holes. On, and while a ``torch.profiler``
is recording, a span is also a ``record_function('alpro.<name>')``, which
puts it on the device trace's clock. Nothing here waits for the device: a
span's times are the host's, and a span around asynchronous work ends when
the work is queued.

The spans and where they are opened:

- ``alpro.video``, ``alpro.text``, ``alpro.fusion``: ``AlproModel.
  embed_video``, ``embed_text`` and ``fuse``, on every path.
- ``alpro.ingest`` ⊃ ``alpro.ingest.h2d`` (the clips' copy to the
  device), then ``alpro.video``: ``add_videos`` of ``RetrievalIndex`` and
  of ``ShardedRetrievalIndex``.
- ``alpro.query`` ⊃ ``alpro.query.tokenize``, ``alpro.text``,
  ``alpro.fusion``, ``alpro.query.readback``: ``_score`` of both indexes,
  which ``query`` and ``query_batch`` share (the sharded index's gathers
  lie between ``alpro.text`` and ``alpro.fusion``).
- ``alpro.step`` (rid: the micro-step, ``state.step``) ⊃
  ``alpro.step.forward`` (the loss, holding the model spans),
  ``alpro.step.backward``, ``alpro.step.reduce`` (with a process group
  only), ``alpro.step.optimizer``: ``TrainStep.__call__``.
- ``alpro.pretrain.vtc``, ``alpro.pretrain.vtm``, ``alpro.pretrain.mlm``
  and ``alpro.pretrain.mpm``, in that order under ``alpro.step.forward``
  (after the towers' ``alpro.video`` and ``alpro.text``): the objectives of
  ``make_pretrain_train_step``'s loss, each around its own forward (VTM's
  3B-row ``alpro.fusion``, MLM's second ``alpro.text`` and
  ``alpro.fusion``, the heads and the loss).
- ``alpro.teacher``: the frozen teacher's no-grad forward of the erased
  crops and its soft labels (``_teacher_pseudo_labels``), inside
  ``alpro.pretrain.mpm`` in a step and inside the pretraining ``validate``.
- ``alpro.prompt_bank``: one a prompt bank built (``objectives/pem.py::
  build_prompt_bank``, which ``cli/run_pretrain.py::setup_prompt_banks``
  calls for the video and the image bank).
- ``alpro.loop.data_wait``: ``run_train_loop``'s wait for the next staged
  batch.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import List, NamedTuple, Optional, Tuple

import torch

from alpro_tpu_torch.core.logging import LOGGER

CAP = 1 << 16      # spans kept until a drain; those past it are dropped and counted

_on = False
_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_store: List["Span"] = []
_dropped = 0
_ids = itertools.count()
_local = threading.local()


class Span(NamedTuple):
    """One closed span. ``parent`` is the ``id`` of the span it opened
    inside on the same thread (None at the top)."""

    name: str
    start: float
    end: float
    id: int
    parent: Optional[int]
    thread: int
    rid: Optional[int]


class _Open:
    __slots__ = ("name", "rid", "id", "parent", "stack", "rf", "start")

    def __init__(self, name: str, rid: Optional[int]):
        self.name, self.rid = "alpro." + name, rid

    def __enter__(self):
        stack = getattr(_local, "stack", None)   # (id, rid) of the open spans
        if stack is None:
            stack = _local.stack = []
        self.stack = stack
        self.parent = None
        if stack:
            self.parent, rid = stack[-1]
            if self.rid is None:
                self.rid = rid
        self.id = next(_ids)
        stack.append((self.id, self.rid))
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.stack.pop()
        _keep(Span(self.name, self.start, end, self.id, self.parent, threading.get_ident(),
                   self.rid))
        return False


def _keep(s: Span) -> None:
    global _dropped
    with _lock:
        if len(_store) < CAP:
            _store.append(s)
        else:
            _dropped += 1


def span(name: str, rid: Optional[int] = None):
    """A context manager that records ``alpro.<name>`` while spans are on,
    and a shared null context while they are off."""
    if not _on:
        return _NULL
    return _Open(name, rid)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until ``drain``."""
    global _on
    _on = False


def drain() -> Tuple[List[Span], int]:
    """(the closed spans kept since the last drain, in the order they
    closed; how many were dropped at ``CAP`` over that time), and empty
    the store."""
    global _store, _dropped
    with _lock:
        out, dropped = _store, _dropped
        _store, _dropped = [], 0
    return out, dropped


@contextlib.contextmanager
def maybe_profile(output_dir: Optional[str], enabled: bool = False):
    """A ``torch.profiler`` trace (CPU, and CUDA when a card is present) of
    the body, with the program's spans on, written as a Chrome trace to
    ``output_dir/profile/trace.json``; a no-op unless ``enabled`` and
    ``output_dir`` are given. Spans it turned on are turned off again at
    its end and the ones it kept dropped: the trace holds them."""
    if not enabled or not output_dir:
        yield
        return
    trace_dir = os.path.join(output_dir, "profile")
    os.makedirs(trace_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    turned_on = not _on
    enable()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield
    finally:
        if turned_on:
            disable()
            drain()
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    LOGGER.info("wrote profiler trace to %s", path)
