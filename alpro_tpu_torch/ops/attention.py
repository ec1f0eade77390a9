"""Multi-head attention on (B, S, H, hd) and (B, H, S, hd), the attention
core of the TimeSformer and BERT layers.

Counterpart of ``alpro_tpu/ops/attention.py``. ``impl``:

* ``xla`` (or ``plain``): einsum → softmax → einsum, with the JAX lowering's
  numerics — bf16 inputs fold the scale into q (fp32 multiply, one bf16
  rounding), emit the score product in bf16 (fp32 accumulation), add the HF
  ``(1-mask)·-10000`` bias in bf16, take the softmax in fp32 and cast the
  probabilities back to bf16 for the PV product; fp32 inputs keep every step
  in fp32 (scale on the fp32 scores). In training, ``dropout_rate`` drops
  attention probabilities (fp32, scaled by 1/keep) with masks drawn from
  ``generator``;
* ``pallas``: the masked-attention kernel (``ops/masked_attn.py``). Like the
  JAX ``pallas`` branch, it ignores ``dropout_rate``;
* ``auto`` resolves to ``xla``, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from alpro_tpu_torch.ops.layers import dropout
from alpro_tpu_torch.ops.masked_attn import fused_attention, fused_attention_bshd

_IMPLS = ("auto", "xla", "plain", "pallas")


def _resolve(impl: str) -> str:
    if impl not in _IMPLS:
        raise ValueError(f"attention impl={impl!r}: expected one of {_IMPLS}")
    return "xla" if impl in ("auto", "plain") else impl


def _plain(q, k, v, key_mask, scale, eq_scores, eq_out, dropout_rate, generator, training,
           query_rows=None):
    dtype = q.dtype
    bias = None
    if key_mask is not None:
        bias = ((1.0 - key_mask.float()) * -10000.0)[:, None, None, :]
    if dtype == torch.bfloat16:
        q = (q.float() * scale).to(dtype)
        scores = torch.einsum(eq_scores, q, k)
        if bias is not None:
            scores = scores + bias.to(dtype)
    else:
        scores = torch.einsum(eq_scores, q, k) * scale
        if bias is not None:
            scores = scores + bias
    probs = torch.softmax(scores.float(), dim=-1)
    probs = dropout(probs, dropout_rate, generator, training, rows=query_rows)
    return torch.einsum(eq_out, probs.to(dtype), v)


def multi_head_attention_bshd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    key_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    impl: str = "auto",
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    training: bool = False,
) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, H, hd); key_mask: optional (B, Sk),
    1 for valid keys. Returns (B, Sq, H, hd) in q.dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _resolve(impl) == "pallas":
        B, Sq, H, hd = q.shape
        # flat-channel views (no copy for views of a packed projection)
        out = fused_attention_bshd(q.flatten(2), k.flatten(2), v.flatten(2), H,
                                   key_mask=key_mask, scale=scale)
        return out.reshape(B, Sq, H, hd)
    return _plain(q, k, v, key_mask, scale, "bqhd,bkhd->bhqk", "bhqk,bkhd->bqhd",
                  dropout_rate, generator, training)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    key_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    impl: str = "auto",
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    training: bool = False,
    query_rows: Optional[tuple] = None,
) -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, H, Sk, hd); key_mask: optional (B, Sk).
    Returns (B, H, Sq, hd) in q.dtype. ``query_rows`` (n, start): q is rows
    [start, start + Sq) of n queries, and the attention dropout keeps those
    rows of a mask drawn for all n (``ops/layers.py::dropout``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _resolve(impl) == "pallas":
        return fused_attention(q, k, v, key_mask=key_mask, scale=scale)
    return _plain(q, k, v, key_mask, scale, "bhqd,bhkd->bhqk", "bhqk,bhkd->bhqd",
                  dropout_rate, generator, training, query_rows)
