"""Selective rematerialization policies for per-block gradient checkpointing
(the port's counterpart of ``alpro_tpu/models/remat.py``).

A policy says which results of a checkpointed block's forward are kept for
the backward pass; everything else is recomputed there. Every policy of the
JAX package is ported, as ``torch.utils.checkpoint`` selective-checkpoint
contexts over the aten ops that the block dispatches:

- ``nothing``: keep nothing inside the block, recompute it whole (the
  reference's checkpointing);
- ``dots``: keep the outputs of the matrix products without batch
  dimensions (``aten.mm`` and ``aten.addmm``: the q/k/v, output and MLP
  projections, not attention's batched products), as JAX's
  ``dots_with_no_batch_dims_saveable``;
- ``dots_all``: also the batched products (``aten.bmm``, ``aten.baddbmm``:
  the plain attention's scores and p·v), as ``dots_saveable``;
- ``dots_rng``: ``dots`` and the dropout and drop-path mask draws
  (``aten.bernoulli.p``), so the recompute draws no mask;
- ``dots_ln`` (the JAX CLI's default): ``dots`` and the LayerNorms' per-row
  statistics (the two ``aten.mean`` results inside ``layernorm_region``),
  as JAX's ``ln_stat`` names;
- ``names``, ``dots_names``, ``dots_ln_names``: the tagged outputs
  (``checkpoint_name``: ``ts_temporal_attn_out``, ``ts_spatial_attn_out``,
  ``bert_attn_out``, at JAX's three sites) alone, with ``dots``, or with
  ``dots_ln``;
- ``dots_ln_offload``: ``dots_ln``, with the tagged outputs kept in pinned
  host memory and copied back when the backward recomputes the block.

*What a tag keeps, in eager mode.* The recompute replays every op of the
block's forward that was not itself kept: a kept tensor does not stop the
ops that produced it from running again, it only replaces their result.
On the plain path the names family therefore trades memory, not time: the
attention that made a tagged value still runs in the recompute. Where the
tagged value comes from one of the attention kernels (K1 or K2 with their
backward, ``ops/qkv_attn.py``; B13, ``ops/masked_attn.py``), the kernel's
launch is a ``torch.library`` custom op that the policy sees, and the tag
keeps the kernel's output in place of the tagged value: the recompute then
reads it back and launches nothing (the launch counters count only real
launches). The recompute draws the dropout and drop-path masks the forward
drew under every policy (``ops/layers.py::checkpoint`` restores the step's
generator for it, and ``dots_rng`` keeps the draws themselves), so every
gradient equals the one without checkpointing.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

REMAT_POLICIES = ("nothing", "dots", "dots_all", "dots_names", "names",
                  "dots_rng", "dots_ln", "dots_ln_offload", "dots_ln_names")

# the tags, at JAX's sites: the temporal attention's output before its
# drop-path and temporal_fc, the spatial attention's after its projection,
# BERT's attention context
TS_TEMPORAL_ATTN = "ts_temporal_attn_out"
TS_SPATIAL_ATTN = "ts_spatial_attn_out"
BERT_ATTN = "bert_attn_out"
SAVED_NAMES = (TS_TEMPORAL_ATTN, TS_SPATIAL_ATTN, BERT_ATTN)

_aten = torch.ops.aten
_PRODUCTS = frozenset((_aten.mm.default, _aten.addmm.default))
_BATCHED = frozenset((_aten.bmm.default, _aten.baddbmm.default))
_RNG = frozenset((_aten.bernoulli.p,))  # ops/layers.py's mask draws
_LN_STAT = _aten.mean.dim
_region = threading.local()


@contextlib.contextmanager
def layernorm_region():
    """Marks the ops of one LayerNorm, whose statistics ``dots_ln`` keeps."""
    depth = getattr(_region, "depth", 0)
    _region.depth = depth + 1
    try:
        yield
    finally:
        _region.depth = depth


def _keep(keep: bool) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if keep else CheckpointPolicy.PREFER_RECOMPUTE


def _dots(ctx, op, *args, **kwargs):
    return _keep(op in _PRODUCTS)


def _dots_all(ctx, op, *args, **kwargs):
    return _keep(op in _PRODUCTS or op in _BATCHED)


def _dots_rng(ctx, op, *args, **kwargs):
    return _keep(op in _PRODUCTS or op in _RNG)


def _dots_ln(ctx, op, *args, **kwargs):
    return _keep(op in _PRODUCTS or (op is _LN_STAT and getattr(_region, "depth", 0) > 0))


class _Kept:
    """The tagged tensors of one checkpointed call: its forward appends them
    in order (a detached reference, or under offload a host copy, pinned for
    a CUDA tensor, made on the stream), its recompute takes them back in the
    same order."""

    def __init__(self, offload: bool):
        self.offload = offload
        self.items = collections.deque()

    def put(self, t: torch.Tensor) -> None:
        if self.offload:  # the copies keep t's strides: the ops after it see the same layout
            host = torch.empty_like(t, device="cpu", pin_memory=t.is_cuda)
            self.items.append(host.copy_(t, non_blocking=True))
        else:
            self.items.append(t.detach())

    def take(self, device) -> torch.Tensor:
        t = self.items.popleft()
        if not self.offload:
            return t
        return torch.empty_like(t, device=device).copy_(t, non_blocking=True)


@contextlib.contextmanager
def _phase(kept: _Kept, recompute: bool, inner):
    prev = getattr(_region, "kept", None)
    _region.kept = (kept, recompute)
    try:
        with inner:
            yield
    finally:
        _region.kept = prev


def _named_contexts(base: Optional[Callable], offload: bool):
    """The forward and recompute contexts of one checkpointed call under a
    names-family policy: ``base``'s selective checkpointing (None: keep
    nothing), and the tags kept through ``_Kept``."""
    kept = _Kept(offload)
    if base is None:
        fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
    else:
        fwd, rec = create_selective_checkpoint_contexts(base)
    return _phase(kept, False, fwd), _phase(kept, True, rec)


def keep_output(run: Callable[[], torch.Tensor], device) -> torch.Tensor:
    """Inside an attention kernel's custom op: ``run()`` launches it. In a
    tagged region of a checkpointed block under a names-family policy the
    forward keeps the output and the recompute reads it back instead of
    launching; elsewhere this is ``run()``."""
    state, marks = getattr(_region, "kept", None), getattr(_region, "marks", None)
    if state is None or marks is None:
        return run()
    kept, recompute = state
    marks[0] = True
    if recompute:
        return kept.take(device)
    out = run()
    kept.put(out)
    return out


@torch.library.custom_op("alpro_tpu_torch::remat_kept", mutates_args=())
def _kept_op(x: torch.Tensor) -> torch.Tensor:
    kept, recompute = _region.kept
    if recompute:
        return kept.take(x.device)
    out = x.clone()
    kept.put(out)
    return out


_kept_op.register_autograd(lambda ctx, g: g, setup_context=lambda ctx, inputs, output: None)


def checkpoint_name(name: str, compute: Callable[[], torch.Tensor]) -> torch.Tensor:
    """``compute()``, tagged ``name`` (JAX ``checkpoint_name``). Inside a
    checkpointed block under a names-family policy the forward keeps the
    value (or, where ``compute`` launched an attention kernel, that
    kernel's output: ``keep_output``) and the recompute reads the kept
    tensor back in its place; elsewhere it is ``compute()`` and nothing
    else."""
    if getattr(_region, "kept", None) is None or name not in SAVED_NAMES:
        return compute()
    prev, _region.marks = getattr(_region, "marks", None), [False]
    try:
        out = compute()
        from_kernel = _region.marks[0]
    finally:
        _region.marks = prev
    return out if from_kernel else torch.ops.alpro_tpu_torch.remat_kept(out)


# policy → the name of its function here, looked up when a policy is
# resolved (so a test can record through a patched one)
_SELECTIVE = {"dots": "_dots", "dots_all": "_dots_all", "dots_rng": "_dots_rng",
              "dots_ln": "_dots_ln"}
# the names family: the selective policy under the tags (None: nothing), offload
_NAMED = {"names": (None, False), "dots_names": ("_dots", False),
          "dots_ln_names": ("_dots_ln", False), "dots_ln_offload": ("_dots_ln", True)}


def resolve_remat_policy(name: str) -> Optional[Callable]:
    """The ``context_fn`` that ``torch.utils.checkpoint.checkpoint`` takes for
    policy ``name``, or None for ``nothing`` (keep nothing). Raises
    ``ValueError`` for a name outside ``REMAT_POLICIES``."""
    if name == "nothing":
        return None
    if name in _SELECTIVE:
        return functools.partial(create_selective_checkpoint_contexts,
                                 globals()[_SELECTIVE[name]])
    if name in _NAMED:
        base, offload = _NAMED[name]
        return functools.partial(_named_contexts, base and globals()[base], offload)
    raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, got {name!r}")
