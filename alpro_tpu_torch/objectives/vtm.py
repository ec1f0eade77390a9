"""VTM — video-text matching with hard-negative mining.

Counterpart of ``alpro_tpu/objectives/vtm.py``. One hard negative per
example, sampled ∝ softmax of the similarity row with the example itself
masked out (-1e30), by one batched ``torch.multinomial`` over all rows drawn
from the step's generator — no per-row host sync. ``num_local_blocks > 1``
restricts the candidates to the example's own block of the batch (the
reference's per-device negatives).

With a ``dp`` group the (b, B) similarity rows of every process are
gathered into the (B, B) matrix and the negatives are drawn from it with a
generator that is the same on every process (``train/step.py`` seeds it from
(seed, step) alone), so W processes draw what one process draws on the whole
batch; each keeps its own rows of the global indices. The VTM loss is this
process's share: 1/W of its rows' mean.
"""

from __future__ import annotations

from typing import Tuple

import torch

from alpro_tpu_torch.parallel.collectives import all_gather, group_rank, group_size

_NEG_INF = -1e30


def sample_hard_negatives(generator: torch.Generator, sim_v2t: torch.Tensor,
                          sim_t2v: torch.Tensor,
                          num_local_blocks: int = 1,
                          group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (neg_text_idx, neg_video_idx), each (b,) int64 global batch
    indices: the hard negative text of each video, drawn from
    softmax(sim_v2t[i]) without i, and the hard negative video of each text,
    from softmax(sim_t2v[i])."""
    b = sim_v2t.shape[0]
    sim_v2t, sim_t2v = all_gather(sim_v2t, group), all_gather(sim_t2v, group)
    B = sim_v2t.shape[0]
    allowed = ~torch.eye(B, dtype=torch.bool, device=sim_v2t.device)
    if num_local_blocks > 1:
        if B % num_local_blocks:
            raise ValueError(f"batch {B} does not divide into {num_local_blocks} blocks")
        block = torch.arange(B, device=sim_v2t.device) // (B // num_local_blocks)
        allowed = allowed & (block[:, None] == block[None, :])
    bias = torch.where(allowed, 0.0, _NEG_INF)
    with torch.no_grad():
        probs = torch.softmax(torch.cat([sim_v2t.float() + bias, sim_t2v.float() + bias]), dim=-1)
        idx = torch.multinomial(probs, 1, generator=generator)[:, 0]
    start = group_rank(group) * b
    return idx[start:start + b], idx[B + start:B + start + b]


def vtm_loss_from_logits(pos_logits: torch.Tensor, neg_logits: torch.Tensor, group=None):
    """2-way cross entropy over [B positives; the negatives]. Returns
    (loss, logits, labels); the loss is this process's share with a group."""
    logits = torch.cat([pos_logits, neg_logits]).float()
    labels = torch.cat([
        torch.ones(pos_logits.shape[0], dtype=torch.long, device=logits.device),
        torch.zeros(neg_logits.shape[0], dtype=torch.long, device=logits.device),
    ])
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.mean(torch.gather(logp, 1, labels[:, None]))
    return (loss if group is None else loss / group_size(group)), logits, labels
