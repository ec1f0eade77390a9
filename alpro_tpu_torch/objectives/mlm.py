"""MLM — masked language modelling cross entropy over the fused text rows.

Counterpart of ``alpro_tpu/objectives/mlm.py``: the masked ids run through
the text half, the fusion over [text; video], the MLM head on the text rows,
and the cross entropy (``ignore_index`` -100) in fp32. The summed NLL is
divided by the masked tokens of the whole batch: with a ``dp`` group their
count is summed over the group, so each process's loss is its share of the
global loss whatever the processes' own counts.
"""

from __future__ import annotations

import torch

from alpro_tpu_torch.parallel.collectives import all_reduce_sum

IGNORE_INDEX = -100


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor, group=None) -> torch.Tensor:
    """logits: (B, L, V); labels: (B, L) with -100 at unmasked positions.
    The mean cross entropy over the labelled positions (their count clamped
    to at least 1), in fp32."""
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros((), dtype=nll.dtype, device=nll.device))
    return nll.sum() / all_reduce_sum(valid.sum(), group).clamp(min=1)
