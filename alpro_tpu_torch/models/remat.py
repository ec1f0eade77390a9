"""Selective rematerialization policies for per-block gradient checkpointing
(the port's counterpart of ``alpro_tpu/models/remat.py``).

A policy says which results of a checkpointed block's forward are kept for
the backward pass; everything else is recomputed there. Two of the JAX
package's policies are ported, as ``torch.utils.checkpoint`` selective
checkpoint policies over the aten ops that the block dispatches:

- ``nothing``: keep nothing inside the block, recompute it whole (the
  reference's checkpointing);
- ``dots_ln`` (the JAX CLI's default): keep the outputs of the matrix
  products without batch dimensions (``aten.mm`` and ``aten.addmm``: the
  q/k/v, output and MLP projections, not attention's batched products), as
  JAX's ``dots_with_no_batch_dims_saveable``, and the LayerNorms' per-row
  statistics (the two ``aten.mean`` results inside ``layernorm_region``), as
  JAX's ``ln_stat`` names; recompute the rest.

A kernel behind a ``torch.autograd.Function`` (the masked-attention kernel
B13 under ``attn_impl='pallas'``) is not an aten op: the policy sees only
the tensors its wrapper allocates, so under either policy the recompute
launches the kernel again, and the products around it are kept.

The recompute draws the dropout and drop-path masks the forward drew
(``ops/layers.py::checkpoint`` restores the step's generator for it), and
the random ops are never kept, so every gradient equals the one without
checkpointing. The other JAX policies (``dots``, ``dots_all``,
``dots_rng``, the ``names`` family, ``dots_ln_offload``) are not ported:
naming one raises (ROADMAP A18).
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Optional

import torch

REMAT_POLICIES = ("nothing", "dots", "dots_all", "dots_names", "names",
                  "dots_rng", "dots_ln", "dots_ln_offload", "dots_ln_names")

_PRODUCTS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default))
_LN_STAT = torch.ops.aten.mean.dim
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


def _dots_ln(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    if op in _PRODUCTS or (op is _LN_STAT and getattr(_region, "depth", 0)):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def resolve_remat_policy(name: str) -> Optional[Callable]:
    """The ``context_fn`` that ``torch.utils.checkpoint.checkpoint`` takes for
    policy ``name``, or None for ``nothing`` (keep nothing). Raises
    ``ValueError`` for a policy that is not ported or does not exist."""
    if name == "nothing":
        return None
    if name == "dots_ln":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        return functools.partial(create_selective_checkpoint_contexts, _dots_ln)
    if name in REMAT_POLICIES:
        raise ValueError(f"remat_policy={name!r} is not ported yet (ROADMAP A18); the port "
                         "has 'dots_ln' and 'nothing'")
    raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, got {name!r}")
