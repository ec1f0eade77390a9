"""Plain multi-head attention on (B, S, H, hd) — the BERT attention of the
retrieval slice and the plain spatial/temporal path of the TimeSformer.

Counterpart of ``alpro_tpu/ops/attention.py::multi_head_attention_bshd``
(its ``xla`` lowering), with the same numerics:

* bf16 inputs: the scale is folded into q (fp32 multiply, one bf16
  rounding), the score product is emitted in bf16 (fp32 accumulation), the
  HF ``(1-mask)·-10000`` bias is added in bf16, the softmax runs in fp32
  and the probabilities are cast back to bf16 for the PV product;
* fp32 inputs keep every step in fp32 (scale on the fp32 scores).
"""

from __future__ import annotations

from typing import Optional

import torch


def multi_head_attention_bshd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    key_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, H, hd); key_mask: optional (B, Sk),
    1 for valid keys. Returns (B, Sq, H, hd) in q.dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dtype = q.dtype
    bias = None
    if key_mask is not None:
        bias = ((1.0 - key_mask.float()) * -10000.0)[:, None, None, :]
    if dtype == torch.bfloat16:
        q = (q.float() * scale).to(dtype)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if bias is not None:
            scores = scores + bias.to(dtype)
    else:
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        if bias is not None:
            scores = scores + bias
    probs = torch.softmax(scores.float(), dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
