"""VTC — video-text contrastive loss with in-batch negatives.

Counterpart of ``alpro_tpu/objectives/vtc.py``: the global-batch form, with
identity targets over the (B, B) similarity matrix. Gradient flows through
both sides of the similarities (the standard CLIP loss); ``stop_gather_grad``
reproduces the reference's one-sided gradient, where the gathered features
carry none.
"""

from __future__ import annotations

from typing import Tuple

import torch


def vtc_loss(video_feat: torch.Tensor, text_feat: torch.Tensor, temp: torch.Tensor,
             stop_gather_grad: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """video_feat, text_feat: (B, d) L2-normalised features; temp: the
    clamped temperature. Returns (loss, sim_v2t, sim_t2v), the sims (B, B)
    fp32 logits scaled by 1/temp."""
    vf, tf = video_feat.float(), text_feat.float()
    if stop_gather_grad:
        sim_v2t = vf @ tf.detach().T / temp
        sim_t2v = tf @ vf.detach().T / temp
    else:
        sim_v2t = vf @ tf.T / temp
        sim_t2v = tf @ vf.T / temp
    targets = torch.eye(vf.shape[0], dtype=torch.float32, device=vf.device)
    loss_v2t = -torch.mean(torch.sum(torch.log_softmax(sim_v2t, dim=1) * targets, dim=1))
    loss_t2v = -torch.mean(torch.sum(torch.log_softmax(sim_t2v, dim=1) * targets, dim=1))
    return (loss_v2t + loss_t2v) / 2.0, sim_v2t, sim_t2v
