"""MLM — masked language modelling cross entropy over the fused text rows.

Counterpart of ``alpro_tpu/objectives/mlm.py``: the masked ids run through
the text half, the fusion over [text; video], the MLM head on the text rows,
and the cross entropy (``ignore_index`` -100) in fp32.
"""

from __future__ import annotations

import torch

IGNORE_INDEX = -100


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits: (B, L, V); labels: (B, L) with -100 at unmasked positions.
    The mean cross entropy over the labelled positions (their count clamped
    to at least 1), in fp32."""
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros((), dtype=nll.dtype, device=nll.device))
    return nll.sum() / valid.sum().clamp(min=1)
