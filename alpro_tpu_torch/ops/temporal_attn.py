"""Temporal attention over packed qkv in three forms: the roll kernel and
two plain-torch lowerings.

Counterpart of ``alpro_tpu/ops/pallas_temporal_attn.py``:

* ``temporal_attention_roll`` ← ``temporal_attention_roll`` (B16; kernel
  ``csrc/temporal_attn.cu``, twin ``temporal_attention_roll_plain`` =
  ``_xla_reference``). Its TPU kernel scales q in fp32, takes the fp32
  bands q·k over every key, then max, exp, sum and Σ p·v / l, rounded once:
  the function of K2 (``ops/qkv_attn.py`` ``temporal_attention_qkv``), whose
  kernel it shares, counted apart in ``roll_launches``. Any T up to 128 and
  any head_dim that is a multiple of 8 up to 128.
* ``temporal_attention_packed`` ← ``temporal_attention_packed`` and
  ``temporal_attention_circulant`` ← ``temporal_attention_circulant``: plain
  torch with the JAX functions' rounding points (``packed`` rounds p and o
  to qkv's dtype, ``circulant`` rounds once), natively differentiable. The
  model reaches them through ``temporal_attn_impl='packed'|'circulant'``.

qkv is (B, T, N, 3·H·hd) with ``[q | k | v]`` channel chunks, each (H, hd)
head-major; every form returns (B, T, N, H·hd) in qkv's dtype, scale
hd^-½. The roll wrapper runs the twin only for a CPU tensor; for a CUDA
tensor it launches the kernel or raises. Its gradient, as JAX's ``_bwd``, is
the vjp of the twin recomputed from the saved qkv, the cotangent cast to
qkv's dtype.
"""

from __future__ import annotations

import torch

from alpro_tpu_torch.ops.qkv_attn import (
    KERNELS,
    _head_dim,
    kernel_attention,
    temporal_attention_plain,
    temporal_kernel,
)

roll_launches = 0


def temporal_attention_roll_plain(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain twin (``_xla_reference``): fp32 scores from the stored q and k
    (the upcast products of bf16 values are exact in fp32), scaled, fp32
    softmax and p·v, output in qkv's dtype: K2's twin at scale hd^-½."""
    return temporal_attention_plain(qkv, num_heads, _head_dim(qkv, num_heads) ** -0.5)


def _roll_launch(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    global roll_launches
    out = temporal_kernel(qkv, num_heads, scale, "temporal_attention_roll")
    roll_launches += 1
    return out


KERNELS["roll"] = (_roll_launch, temporal_attention_plain)


def temporal_attention_roll(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Attention over T at each (b, n) and head: (B, T, N, 3D) → (B, T, N,
    D), bf16 or fp32."""
    if qkv.dim() != 4:
        raise ValueError(f"expected (B, T, N, 3D) qkv, got shape {tuple(qkv.shape)}")
    scale = _head_dim(qkv, num_heads) ** -0.5
    if qkv.device.type == "cpu":
        return temporal_attention_plain(qkv, num_heads, scale)
    return kernel_attention(qkv, num_heads, scale, "roll")


def _split(qkv: torch.Tensor, num_heads: int):
    B, T, N, threeD = qkv.shape
    D = threeD // 3
    return B, T, N, D, num_heads, _head_dim(qkv, num_heads)


def temporal_attention_packed(qkv: torch.Tensor, num_heads: int, pack: int = 16) -> torch.Tensor:
    """``pack`` patch locations per tile: (pack·T, hd)×(hd, pack·T) score
    tiles with a block-diagonal mask confining each location's softmax to
    its own (T, T) block. Scores and softmax in fp32, p rounded to qkv's
    dtype, p·v accumulated in fp32 and rounded to qkv's dtype."""
    B, T, N, D, H, hd = _split(qkv, num_heads)
    G = -(-N // pack)
    Np = G * pack
    x = torch.nn.functional.pad(qkv, (0, 0, 0, Np - N))
    x = x.reshape(B, T, G, pack, 3, H, hd).permute(4, 0, 2, 5, 3, 1, 6)  # (3, B, G, H, pack, T, hd)
    q, k, v = (x[i].reshape(B, G, H, pack * T, hd) for i in range(3))
    s = torch.einsum("bghik,bghjk->bghij", q.float(), k.float()) * hd ** -0.5
    blk = torch.arange(pack * T, device=qkv.device) // T
    neg = torch.where(blk[:, None] == blk[None, :], 0.0, float("-inf"))
    p = torch.softmax(s + neg, dim=-1).to(qkv.dtype)
    o = torch.einsum("bghij,bghjd->bghid", p.float(), v.float()).to(qkv.dtype)
    o = o.reshape(B, G, H, pack, T, hd).permute(0, 4, 1, 3, 2, 5).reshape(B, T, Np, D)
    return o[:, :, :N, :]


def temporal_attention_circulant(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The δ-roll identity elementwise over (B, T, N, H, hd): band_δ[t] =
    Σ_d q[t]·k[(t+δ) mod T], softmax over δ, out[t] = Σ_δ p_δ[t]·v[(t+δ)
    mod T]. All in fp32, rounded once to qkv's dtype."""
    B, T, N, D, H, hd = _split(qkv, num_heads)
    q = qkv[..., :D].reshape(B, T, N, H, hd).float() * hd ** -0.5
    k = qkv[..., D:2 * D].reshape(B, T, N, H, hd).float()
    v = qkv[..., 2 * D:].reshape(B, T, N, H, hd).float()
    bands = torch.stack([(q * torch.roll(k, -d, dims=1)).sum(-1) for d in range(T)])
    e = torch.exp(bands - bands.amax(dim=0, keepdim=True))  # (T_δ, B, T, N, H)
    denom = e.sum(dim=0)
    out = e[0][..., None] * v
    for d in range(1, T):
        out = out + e[d][..., None] * torch.roll(v, -d, dims=1)
    out = out / denom[..., None]
    return out.reshape(B, T, N, D).to(qkv.dtype)
