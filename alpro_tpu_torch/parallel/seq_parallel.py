"""Sequence-parallel temporal attention (counterpart of
``alpro_tpu/parallel/seq_parallel.py``).

For long videos the frame axis is split over a group: each process holds
(BN, T/W, D) of the temporal attention's input, computes q, k, v for its
frames, gathers k and v over the group along T, with gradient, and attends
its queries over all T frames. The attention is exact: no approximation,
and one all-gather beats a ring at these head widths.

The local attention is the port's plain attention, as JAX runs
``impl="xla"`` here and its ``auto`` keeps the kernels off under sp. The
video tower calls it from its plain temporal branch when its ``sp_axis`` is
active (``models/timesformer.py``, ``core/mesh.py::active_axis``), then
gathers the frames of the output with ``gather_frames``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from alpro_tpu_torch.ops.attention import multi_head_attention
from alpro_tpu_torch.parallel.collectives import all_gather_with_grad, group_rank, group_size


def gather_frames(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in rank order, with
    gradient (each rank gets its slice of the summed gradient back)."""
    moved = x.movedim(dim, 0).contiguous()
    return all_gather_with_grad(moved, group).movedim(0, dim)


def sharded_temporal_attention(x: torch.Tensor, qkv_w: torch.Tensor, qkv_b: torch.Tensor,
                               proj_w: torch.Tensor, proj_b: torch.Tensor, num_heads: int,
                               group, dropout_rate: float = 0.0,
                               generator: Optional[torch.Generator] = None,
                               training: bool = False) -> torch.Tensor:
    """Temporal self-attention over axis 1 of the local x: (BN, T/W, D), the
    frames of the group's processes in rank order. Weights in ``nn.Linear``
    layout, the port's: ``qkv_w`` (3D, D) with [q; k; v] row chunks,
    ``proj_w`` (D, D); their dtype is the compute dtype, and x is cast to
    it. In training, ``dropout_rate`` drops attention probabilities with the
    mask the unsplit attention draws from ``generator`` over all T query
    rows, of which this process keeps its own. Returns (BN, T/W, D), equal
    to this process's frames of the unsplit attention."""
    BN, T_local, D = x.shape
    hd = D // num_heads
    qkv = F.linear(x.to(qkv_w.dtype), qkv_w, qkv_b).reshape(BN, T_local, 3, num_heads, hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (BN, H, T_local, hd)
    rows = (T_local * group_size(group), T_local * group_rank(group))
    out = multi_head_attention(q, gather_frames(k, group, 2), gather_frames(v, group, 2),
                               impl="xla", dropout_rate=dropout_rate, generator=generator,
                               training=training, query_rows=rows)
    return F.linear(out.transpose(1, 2).reshape(BN, T_local, D), proj_w, proj_b)
