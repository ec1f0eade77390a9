"""Explicit collectives (counterpart of ``alpro_tpu/parallel/__init__.py``).

The default distribution is the train step's (``train/step.py::shard_step``):
each process computes its share of the global loss and the gradients are
summed over ``dp``. ``vtc_loss_explicit`` is the reference-shaped VTC kept
for cross-checks: remote features gathered without gradient, targets at the
global offset ``b · rank`` (the reference indexed by ``hvd.local_rank()``,
wrong across nodes, SURVEY.md §1).
"""

from __future__ import annotations

import torch

from alpro_tpu_torch.parallel.collectives import all_gather, all_reduce_mean, group_rank


def vtc_loss_explicit(video_feat: torch.Tensor, text_feat: torch.Tensor, temp: torch.Tensor,
                      group) -> torch.Tensor:
    """This process's (b, d) features against the group's gathered ones,
    which carry no gradient; the local rows carry it. Returns the mean over
    the group of the local losses (JAX's ``pmean``), the same on every
    process."""
    vf, tf = video_feat.float(), text_feat.float()
    b = vf.shape[0]
    g_vf, g_tf = all_gather(vf, group), all_gather(tf, group)
    sim_v2t = vf @ g_tf.T / temp
    sim_t2v = tf @ g_vf.T / temp
    rows = torch.arange(b, device=vf.device)[:, None] + b * group_rank(group)
    targets = (torch.arange(g_tf.shape[0], device=vf.device)[None, :] == rows).float()
    loss_v2t = -torch.mean(torch.sum(torch.log_softmax(sim_v2t, dim=1) * targets, dim=1))
    loss_t2v = -torch.mean(torch.sum(torch.log_softmax(sim_t2v, dim=1) * targets, dim=1))
    return all_reduce_mean((loss_v2t + loss_t2v) / 2.0, group)
