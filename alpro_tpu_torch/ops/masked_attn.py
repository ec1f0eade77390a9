"""Masked multi-head attention: one CUDA kernel for two layouts, with its
plain twin and its gradient.

Counterpart of ``alpro_tpu/ops/pallas_attn.py``:

* ``fused_attention_bshd`` ← ``fused_attention_bshd`` (``_attn_kernel_heads``):
  q (B, Sq, H·hd), k/v (B, Sk, H·hd), each head a window of hd channels;
* ``fused_attention`` ← ``fused_attention`` (``_attn_kernel``): q (B, H, Sq,
  hd), k/v (B, H, Sk, hd).

Both launch ``csrc/masked_attn.cu``, which reads q, k and v in place through
their strides (the channel axis contiguous), so views of a packed qkv
projection go in without a copy. The twin ``attention_plain`` copies the
TPU kernel's contract step by step: q·kᵀ on the operands upcast to fp32, times
the scale, plus the fp32 bias ``(1-mask)·-10000``; fp32 row max and exp; the
unnormalised p rounded to v's dtype for P·V in fp32; division by the fp32 row
sum last; output in q's dtype.

The gradient is ``_fused_attention_bwd`` / ``_fab_bwd``: a plain fp32
recompute of p, then dv, dp, ds, dq and dk, each cast to its input's dtype
(the JAX package's custom_vjp backward is XLA einsums, not a kernel). The key
mask takes no gradient.

A wrapper runs the twin only for CPU tensors; for CUDA tensors it launches
the kernel or raises. ``bshd_launches`` and ``bhsd_launches`` count kernel
launches, one per forward call (a recompute under gradient checkpointing is a
launch too).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from alpro_tpu_torch.ops import _build

bshd_launches = 0
bhsd_launches = 0

_DTYPES = (torch.bfloat16, torch.float32)
_HEAD_DIMS = (32, 64, 128)  # csrc/masked_attn.cu instantiations
_MAX_GRID_YZ = 65535


def key_bias(key_mask: Optional[torch.Tensor], B: int, Sk: int, device) -> torch.Tensor:
    """(B, Sk) fp32 additive bias: ``(1-mask)·-10000``, zeros without a mask."""
    if key_mask is None:
        return torch.zeros((B, Sk), dtype=torch.float32, device=device)
    return (1.0 - key_mask.float()) * -10000.0


def attention_plain(q, k, v, bias, scale: float) -> torch.Tensor:
    """Plain twin on (B, H, S, hd) tensors or views; bias (B, Sk) fp32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s = s + bias.float()[:, None, None, :]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype)


def attention_grads(q, k, v, bias, g, scale: float):
    """The JAX backward on (B, H, S, hd) tensors or views: (dq, dk, dv) in
    the dtypes of q, k, v."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale + bias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def max_seq_len(dtype: torch.dtype, head_dim: int, device) -> int:
    """The largest Sk the kernel takes for ``dtype`` and ``head_dim`` on
    ``device`` (K and V of one head live in shared memory)."""
    dev = torch.device(device).index
    if dev is None:
        dev = torch.cuda.current_device()
    n = _build.lib().alpro_masked_attn_max_seq(int(dtype == torch.bfloat16), head_dim, dev)
    if n < 0:
        _build.check(-n, "masked_attn max_seq_len")
    return n


def _check_operand(t: torch.Tensor, name: str, dtype) -> None:
    """A (B, H, S, hd) CUDA view the kernel can read in place: head_dim
    contiguous, 16-byte aligned rows."""
    if t.device.type != "cuda":
        raise ValueError(f"masked_attn {name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"masked_attn {name}: dtype {t.dtype}, expected {dtype} (one of {_DTYPES})")
    vec = 16 // t.element_size()
    if (t.stride(-1) != 1 or t.data_ptr() % 16
            or any(t.stride(i) % vec for i in range(3) if t.shape[i] > 1)):
        raise ValueError(
            f"masked_attn {name}: head_dim must be contiguous and every row 16-byte "
            f"aligned; got strides {t.stride()}, data pointer {t.data_ptr() % 16} mod 16"
        )


def _launch(q, k, v, bias, out, scale: float) -> None:
    """q, k, v, out: (B, H, S, hd) CUDA views; bias (B, Sk) fp32."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    if q.dtype not in _DTYPES:
        raise ValueError(f"masked_attn: dtype {q.dtype} not in {_DTYPES}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        _check_operand(t, name, q.dtype)
    if hd not in _HEAD_DIMS or B > _MAX_GRID_YZ or H > _MAX_GRID_YZ or Sq < 1 or Sk < 1:
        raise ValueError(
            f"masked_attn kernel needs head_dim in {_HEAD_DIMS}, B and H <= {_MAX_GRID_YZ} "
            f"and Sq, Sk >= 1; got head_dim={hd}, B={B}, H={H}, Sq={Sq}, Sk={Sk}"
        )
    limit = max_seq_len(q.dtype, hd, q.device)
    if Sk > limit:
        raise ValueError(
            f"masked_attn kernel takes Sk <= {limit} for {q.dtype} at head_dim {hd} on this "
            f"device (K and V of a head in shared memory); got Sk={Sk}"
        )
    bias = bias.to(device=q.device, dtype=torch.float32).contiguous()
    strides = (ctypes.c_longlong * 12)(*(t.stride(i) for t in (q, k, v, out) for i in (0, 2, 1)))
    dev, stream = _build.stream_args(q)
    err = _build.lib().alpro_masked_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
        ctypes.addressof(strides), B, H, Sq, Sk, hd, float(scale),
        int(q.dtype == torch.bfloat16), dev, stream,
    )
    _build.check(err, "masked_attn")


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, H·hd) → (B, H, S, hd) view."""
    return x.unflatten(-1, (num_heads, x.shape[-1] // num_heads)).transpose(1, 2)


def _forward(q, k, v, bias, scale: float, num_heads: Optional[int]) -> torch.Tensor:
    """num_heads given: the (B, S, H·hd) layout; None: (B, H, S, hd)."""
    global bshd_launches, bhsd_launches
    bshd = num_heads is not None
    qh, kh, vh = (_heads(t, num_heads) for t in (q, k, v)) if bshd else (q, k, v)
    if q.device.type == "cpu":
        o = attention_plain(qh, kh, vh, bias, scale)
        return o.transpose(1, 2).flatten(2) if bshd else o
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(qh, kh, vh, bias, _heads(out, num_heads) if bshd else out, scale)
    if bshd:
        bshd_launches += 1
    else:
        bhsd_launches += 1
    return out


class _MaskedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, scale, num_heads):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale, ctx.num_heads = scale, num_heads
        return _forward(q, k, v, bias, scale, num_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        H = ctx.num_heads
        if H is None:
            dq, dk, dv = attention_grads(q, k, v, bias, g, ctx.scale)
        else:
            dq, dk, dv = (d.transpose(1, 2).flatten(2) for d in attention_grads(
                _heads(q, H), _heads(k, H), _heads(v, H), bias, _heads(g, H), ctx.scale))
        return dq, dk, dv, None, None, None


def _check_shapes(q, k, v, key_mask, seq_axis: int) -> None:
    if q.dim() != k.dim() or k.shape != v.shape or q.shape[-1] != k.shape[-1] \
            or q.shape[0] != k.shape[0]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    want = (k.shape[0], k.shape[seq_axis])
    if key_mask is not None and tuple(key_mask.shape) != want:
        raise ValueError(f"key_mask: shape {tuple(key_mask.shape)} != {want}")


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    key_mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Masked softmax attention on (B, H, S, hd): q (B, H, Sq, hd), k/v (B, H,
    Sk, hd), key_mask (B, Sk) with 1 for valid keys. Returns (B, H, Sq, hd)
    in q.dtype."""
    if q.dim() != 4:
        raise ValueError(f"expected (B, H, S, hd) q, got shape {tuple(q.shape)}")
    _check_shapes(q, k, v, key_mask, 2)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    bias = key_bias(key_mask, k.shape[0], k.shape[2], q.device)
    return _MaskedAttention.apply(q, k, v, bias, float(scale), None)


def fused_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                         *, key_mask: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Masked softmax attention on flat channels: q (B, Sq, H·hd), k/v (B, Sk,
    H·hd) (views of a packed projection included), key_mask (B, Sk). Returns
    (B, Sq, H·hd) in q.dtype, with no head-split copy on either side."""
    if q.dim() != 3 or q.shape[-1] % num_heads:
        raise ValueError(f"expected (B, S, H·hd) q with H={num_heads}, got {tuple(q.shape)}")
    _check_shapes(q, k, v, key_mask, 1)
    if scale is None:
        scale = (q.shape[-1] // num_heads) ** -0.5
    bias = key_bias(key_mask, k.shape[0], k.shape[1], q.device)
    return _MaskedAttention.apply(q, k, v, bias, float(scale), int(num_heads))
