"""VTC — video-text contrastive loss with in-batch negatives.

Counterpart of ``alpro_tpu/objectives/vtc.py``: the global-batch form, with
identity targets over the (B, B) similarity matrix. Gradient flows through
both sides of the similarities (the standard CLIP loss); ``stop_gather_grad``
reproduces the reference's one-sided gradient, where the gathered features
carry none.

With a ``dp`` group each process holds b rows of the global batch: its rows
are scored against the group's gathered features of both sides, with
gradient through the gather (``parallel/collectives.py::
all_gather_with_grad``), the targets at the global offset ``b · rank``, and
the loss returned is this process's share, 1/W of its rows' mean, so that
the shares sum to the loss of the whole batch.
"""

from __future__ import annotations

from typing import Tuple

import torch

from alpro_tpu_torch.parallel.collectives import all_gather_with_grad, group_rank, group_size


def vtc_loss(video_feat: torch.Tensor, text_feat: torch.Tensor, temp: torch.Tensor,
             stop_gather_grad: bool = False,
             group=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """video_feat, text_feat: (b, d) L2-normalised features; temp: the
    clamped temperature. Returns (loss, sim_v2t, sim_t2v), the sims (b, B)
    fp32 logits scaled by 1/temp (b = B in one process)."""
    vf, tf = video_feat.float(), text_feat.float()
    g_vf, g_tf = all_gather_with_grad(vf, group), all_gather_with_grad(tf, group)
    if stop_gather_grad:
        g_vf, g_tf = g_vf.detach(), g_tf.detach()
    sim_v2t = vf @ g_tf.T / temp
    sim_t2v = tf @ g_vf.T / temp
    b = vf.shape[0]
    rows = torch.arange(b, device=vf.device)[:, None] + b * group_rank(group)
    targets = (torch.arange(g_tf.shape[0], device=vf.device)[None, :] == rows).float()
    loss_v2t = -torch.mean(torch.sum(torch.log_softmax(sim_v2t, dim=1) * targets, dim=1))
    loss_t2v = -torch.mean(torch.sum(torch.log_softmax(sim_t2v, dim=1) * targets, dim=1))
    loss = (loss_v2t + loss_t2v) / 2.0
    return (loss if group is None else loss / group_size(group)), sim_v2t, sim_t2v
