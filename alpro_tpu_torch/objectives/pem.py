"""PEM/MPM — prompting entity modelling with a frozen prompter teacher.

Counterpart of ``alpro_tpu/objectives/pem.py``. The teacher encodes
num_templates × num_entities prompt sentences once and averages them per
entity into a (num_entities, 256) prompt bank; each training clip's erased
crop is pseudo-labelled by the softmax of its teacher video feature against
the bank; the student's MPM head predicts those soft labels from the mean
fusion embedding of the erased patches.

As in the JAX package (and unlike ALPRO's code, which compares the argmax
index with the threshold), a row is ignored when its largest softmax
probability is below ``MPM_IGNORE_THRESHOLD``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

MPM_IGNORE_THRESHOLD = 0.2


def build_prompt_bank(encode_text_feat: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                      prompt_ids: torch.Tensor, prompt_mask: torch.Tensor, num_entities: int,
                      chunk_size: int = 1024) -> torch.Tensor:
    """(num_templates · num_entities, L) prompt ids and mask → the
    (num_entities, d) bank: the mean over templates of
    ``encode_text_feat(ids, mask)`` (the teacher's text half → ``text_proj``
    → L2 norm), run in chunks of ``chunk_size`` rows. Prompts are
    template-major (template t holds rows [t·E, (t+1)·E)). The mean is not
    normalized again, as in the JAX function."""
    total = prompt_ids.shape[0]
    if total % num_entities:
        raise ValueError(f"{total} prompts are not a multiple of {num_entities} entities")
    feats = torch.cat([encode_text_feat(prompt_ids[s: s + chunk_size],
                                        prompt_mask[s: s + chunk_size])
                       for s in range(0, total, chunk_size)])
    return feats.reshape(total // num_entities, num_entities, -1).mean(dim=0)


def pseudo_labels_from_feats(crop_video_feat: torch.Tensor, prompt_bank: torch.Tensor,
                             temp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, d) crop features → ((B, E) soft labels, (B,) ignore mask)."""
    sim = crop_video_feat.float() @ prompt_bank.float().T / temp
    soft = torch.softmax(sim, dim=1)
    return soft, soft.max(dim=1).values < MPM_IGNORE_THRESHOLD


def masked_patch_mean(fusion_hidden: torch.Tensor, patch_masks: torch.Tensor,
                      txt_len: int) -> torch.Tensor:
    """The mean fp32 fusion embedding of the erased patches. fusion_hidden:
    (B, Lt + 1 + N, D); patch_masks: (B, h, w), 1 kept and 0 erased. The
    visual CLS (row Lt) is skipped."""
    B = fusion_hidden.shape[0]
    visual = fusion_hidden[:, txt_len + 1:, :].float()
    inv = 1.0 - patch_masks.reshape(B, -1).float()
    denom = inv.sum(dim=1, keepdim=True).clamp(min=1.0)
    return (visual * inv[:, :, None]).sum(dim=1) / denom


def mpm_loss(mpm_logits: torch.Tensor, soft_labels: torch.Tensor,
             ignore_masks: torch.Tensor) -> torch.Tensor:
    """Soft cross entropy, the ignored rows zeroed, over the count of rows
    kept (at least 1)."""
    ce = -(torch.log_softmax(mpm_logits.float(), dim=1) * soft_labels.float()).sum(dim=1)
    ce = torch.where(ignore_masks, torch.zeros((), dtype=ce.dtype, device=ce.device), ce)
    denom = (mpm_logits.shape[0] - ignore_masks.sum()).clamp(min=1)
    return ce.sum() / denom
