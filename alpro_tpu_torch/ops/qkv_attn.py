"""Packed-qkv attention of the divided space-time block: spatial (per frame)
and temporal (per patch location), each a CUDA kernel with its plain twin.

Counterpart of ``alpro_tpu/ops/pallas_qkv_attn.py``:

* ``spatial_attention_qkv`` ← ``fused_attention_qkv`` (kernel
  ``csrc/spatial_attn.cu``, twin ``spatial_attention_plain`` =
  ``_spatial_xla_reference``);
* ``temporal_attention_qkv`` ← ``fused_temporal_attention_qkv`` (kernel
  ``csrc/temporal_attn.cu``, twin ``temporal_attention_plain`` =
  ``_temporal_xla_reference``).

Channel layout is the fused qkv projection's: ``[q | k | v]``, each (H, hd)
head-major. A wrapper runs the twin only for a CPU tensor; for a CUDA tensor
it launches the kernel or raises. ``spatial_launches`` and
``temporal_launches`` count kernel launches.

Gradient: as the JAX custom_vjp (``_spatial_bwd`` / ``_temporal_bwd``), the
kernel call is a ``torch.autograd.Function`` whose backward is the vjp of the
plain twin, recomputed from the saved packed qkv. On a CPU tensor the twin is
differentiated directly, which is the same vjp.
"""

from __future__ import annotations

from typing import Optional

import torch

from alpro_tpu_torch.ops import _build

spatial_launches = 0
temporal_launches = 0

_DTYPES = (torch.bfloat16, torch.float32)
_MAX_GRID_YZ = 65535


def _split_heads(qkv: torch.Tensor, num_heads: int):
    D = qkv.shape[-1] // 3
    shape = qkv.shape[:-1] + (num_heads, D // num_heads)
    return (qkv[..., :D].reshape(shape).float(),
            qkv[..., D:2 * D].reshape(shape).float(),
            qkv[..., 2 * D:].reshape(shape).float())


def spatial_attention_plain(qkv: torch.Tensor, num_heads: int,
                            scale: float) -> torch.Tensor:
    """Plain twin (``_spatial_xla_reference``): fp32 math, output in the
    input dtype."""
    M, S, threeD = qkv.shape
    q, k, v = _split_heads(qkv, num_heads)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o.reshape(M, S, threeD // 3).to(qkv.dtype)


def temporal_attention_plain(qkv: torch.Tensor, num_heads: int,
                             scale: float) -> torch.Tensor:
    """Plain twin (``_temporal_xla_reference``): fp32 math, output in the
    input dtype."""
    B, T, N, threeD = qkv.shape
    q, k, v = _split_heads(qkv, num_heads)
    s = torch.einsum("btnhd,bsnhd->bnhts", q, k) * scale
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bnhts,bsnhd->btnhd", p, v)
    return o.reshape(B, T, N, threeD // 3).to(qkv.dtype)


def _head_dim(qkv: torch.Tensor, num_heads: int) -> int:
    threeD = qkv.shape[-1]
    if threeD % 3 or (threeD // 3) % num_heads:
        raise ValueError(
            f"packed qkv width {threeD} is not 3·H·hd for H={num_heads}"
        )
    return threeD // 3 // num_heads


def _twin_vjp(twin, qkv, g, num_heads: int, scale: float) -> torch.Tensor:
    """d qkv of ``twin(qkv)`` against the cotangent g (cast to qkv's dtype)."""
    with torch.enable_grad():
        x = qkv.detach().requires_grad_(True)
        (dx,) = torch.autograd.grad(twin(x, num_heads, scale), x, g.to(qkv.dtype))
    return dx


class _KernelAttention(torch.autograd.Function):
    """kernel(qkv) forward, vjp of the plain twin backward."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale, kernel, twin):
        ctx.save_for_backward(qkv)
        ctx.args = (num_heads, scale, twin)
        return kernel(qkv, num_heads, scale)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        num_heads, scale, twin = ctx.args
        return _twin_vjp(twin, qkv, g, num_heads, scale), None, None, None, None


def spatial_attention_qkv(qkv: torch.Tensor, num_heads: int, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Mask-free attention over packed qkv (M, S, 3·H·hd) → (M, S, H·hd)."""
    if qkv.dim() != 3:
        raise ValueError(f"expected (M, S, 3D) qkv, got shape {tuple(qkv.shape)}")
    hd = _head_dim(qkv, num_heads)
    if scale is None:
        scale = hd ** -0.5
    if qkv.device.type == "cpu":
        return spatial_attention_plain(qkv, num_heads, float(scale))
    return _KernelAttention.apply(qkv, num_heads, float(scale), _spatial_launch,
                                  spatial_attention_plain)


def _spatial_launch(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    global spatial_launches
    hd = _head_dim(qkv, num_heads)
    _build.check_cuda_operand(qkv, "spatial_attention_qkv", _DTYPES)
    M, S, _ = qkv.shape
    if hd % 16 or M > _MAX_GRID_YZ or num_heads > _MAX_GRID_YZ or S < 1:
        raise ValueError(
            f"spatial kernel needs head_dim % 16 == 0 and M, H <= {_MAX_GRID_YZ};"
            f" got head_dim={hd}, M={M}, H={num_heads}, S={S}"
        )
    out = torch.empty((M, S, num_heads * hd), dtype=qkv.dtype, device=qkv.device)
    dev, stream = _build.stream_args(qkv)
    err = _build.lib().alpro_spatial_attn(
        qkv.data_ptr(), out.data_ptr(), M, S, num_heads, hd, float(scale),
        int(qkv.dtype == torch.bfloat16), dev, stream,
    )
    _build.check(err, "spatial_attention_qkv")
    spatial_launches += 1
    return out


def temporal_attention_qkv(qkv: torch.Tensor, num_heads: int, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Attention over T at each (b, n): packed qkv (B, T, N, 3·H·hd) →
    (B, T, N, H·hd), no relayout."""
    if qkv.dim() != 4:
        raise ValueError(
            f"expected (B, T, N, 3D) qkv, got shape {tuple(qkv.shape)}"
        )
    hd = _head_dim(qkv, num_heads)
    if scale is None:
        scale = hd ** -0.5
    if qkv.device.type == "cpu":
        return temporal_attention_plain(qkv, num_heads, float(scale))
    return _KernelAttention.apply(qkv, num_heads, float(scale), _temporal_launch,
                                  temporal_attention_plain)


def _temporal_launch(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    global temporal_launches
    hd = _head_dim(qkv, num_heads)
    _build.check_cuda_operand(qkv, "temporal_attention_qkv", _DTYPES)
    B, T, N, _ = qkv.shape
    if hd not in (32, 64, 96, 128) or not 1 <= T <= 32:
        raise ValueError(
            f"temporal kernel needs head_dim in (32, 64, 96, 128) and 1 <= T <= 32;"
            f" got head_dim={hd}, T={T}"
        )
    out = torch.empty((B, T, N, num_heads * hd), dtype=qkv.dtype, device=qkv.device)
    dev, stream = _build.stream_args(qkv)
    err = _build.lib().alpro_temporal_attn(
        qkv.data_ptr(), out.data_ptr(), B, T, N, num_heads, hd, float(scale),
        int(qkv.dtype == torch.bfloat16), dev, stream,
    )
    _build.check(err, "temporal_attention_qkv")
    temporal_launches += 1
    return out
