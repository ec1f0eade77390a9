"""Sequence-parallel temporal attention (counterpart of
``alpro_tpu/parallel/seq_parallel.py``).

For long videos the frame axis is split over a group: each process holds
(BN, T/W, D) of the temporal attention's input, computes q, k, v for its
frames, gathers k and v over the group along T, with gradient, and attends
its queries over all T frames. The attention is exact: no approximation,
and one all-gather beats a ring at these head widths.

The local attention is the port's plain attention, as JAX runs
``impl="xla"`` here and its ``auto`` keeps the kernels off under sp. The
model's ``sp_axis`` and ``--mesh_shape DP SP`` with SP > 1 are not ported
(ROADMAP A19); this function is their building block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from alpro_tpu_torch.ops.attention import multi_head_attention
from alpro_tpu_torch.parallel.collectives import all_gather_with_grad


def _gather_frames(t: torch.Tensor, group) -> torch.Tensor:
    """(BN, H, T_local, hd) → (BN, H, T, hd), gathered along T."""
    return all_gather_with_grad(t.permute(2, 0, 1, 3).contiguous(), group).permute(1, 2, 0, 3)


def sharded_temporal_attention(x: torch.Tensor, qkv_w: torch.Tensor, qkv_b: torch.Tensor,
                               proj_w: torch.Tensor, proj_b: torch.Tensor, num_heads: int,
                               group) -> torch.Tensor:
    """Temporal self-attention over axis 1 of the local x: (BN, T/W, D), the
    frames of the group's processes in rank order. Weights in ``nn.Linear``
    layout, the port's: ``qkv_w`` (3D, D) with [q; k; v] row chunks,
    ``proj_w`` (D, D). Returns (BN, T/W, D), equal to this process's frames
    of the unsplit attention."""
    BN, T_local, D = x.shape
    hd = D // num_heads
    qkv = F.linear(x, qkv_w, qkv_b).reshape(BN, T_local, 3, num_heads, hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (BN, H, T_local, hd)
    out = multi_head_attention(q, _gather_frames(k, group), _gather_frames(v, group), impl="xla")
    return F.linear(out.transpose(1, 2).reshape(BN, T_local, D), proj_w, proj_b)
