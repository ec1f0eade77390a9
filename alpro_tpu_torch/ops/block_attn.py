"""The whole attention sublayer of a ViT block in one kernel: qkv projection,
attention with an optional key mask, output projection (before the
residual).

Counterpart of ``alpro_tpu/ops/pallas_block_attn.py::fused_attention_block``
(B17): kernel ``csrc/block_attn.cu``, twin ``fused_attention_block_plain`` =
``_xla_reference``. It computes what the port's ``Attention`` module
(``models/timesformer.py``) computes with its ``qkv`` and ``proj`` weights.
No model path reaches it, as in JAX: no ``attn_impl`` value routes to it.

Weights are in torch Linear layout, as in ``Attention``: wqkv (3D, D) with
``[q | k | v]`` row chunks, each (H, hd) head-major, and wproj (D, D), the
transposes of the JAX function's kernels. key_mask (B, S), 1 = valid key,
adds the HF ``(1 - mask)·-10000`` bias in fp32.

The wrapper runs the twin only for a CPU tensor; for a CUDA tensor it
launches the kernel or raises (head_dim 64, D in (256, 512, 768, 1024), S up
to ``max_seq``). ``launches`` counts kernel launches (one per call; the
kernel is two CUDA launches). Gradient, as JAX's ``_bwd``: a
``torch.autograd.Function`` whose backward is the vjp of the twin with
respect to x, wqkv, bqkv, wproj and bproj, recomputed from the saved inputs,
none for the mask.
"""

from __future__ import annotations

from typing import Optional

import torch

from alpro_tpu_torch.ops import _build
from alpro_tpu_torch.ops.ln_mlp import _WIDTHS

launches = 0

_DTYPES = (torch.bfloat16, torch.float32)
_HEAD_DIM = 64  # csrc/block_attn.cu (head_proj.cuh kHD)
_QUERY_TILE = 64  # csrc/block_attn.cu kQT
_MAX_GRID_YZ = 65535


def key_bias(key_mask: torch.Tensor) -> torch.Tensor:
    """The HF additive key bias ``(1 - mask)·-10000`` in fp32."""
    return (1.0 - key_mask.float()) * -10000.0


def fused_attention_block_plain(x, wqkv, bqkv, wproj, bproj, num_heads: int,
                                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin (``_xla_reference``): qkv = x·wqkvᵀ + b in x's dtype
    (rounded after the bias), fp32 scores from it (the upcast products of
    bf16 values are exact in fp32), scaled, plus the key bias, fp32 softmax
    rounded to x's dtype, p·v in fp32 rounded to x's dtype, then the
    projection in x's dtype."""
    B, S, D = x.shape
    hd = D // num_heads
    qkv = x @ wqkv.to(x.dtype).t() + bqkv.to(x.dtype)
    q, k, v = qkv.reshape(B, S, 3, num_heads, hd).unbind(2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
    if key_mask is not None:
        s = s + key_bias(key_mask)[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(x.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(x.dtype).reshape(B, S, D)
    return o @ wproj.to(x.dtype).t() + bproj.to(x.dtype)


def _smem_bytes(S: int, dtype: torch.dtype) -> int:
    """Shared memory of one heads block (``csrc/block_attn.cu`` smem_bytes)."""
    es = dtype.itemsize
    pad, sp = 16 // es, -(-S // 16) * 16
    ldf, ldc = _HEAD_DIM + 4, 64 + pad
    staging = (64 + 2 * _HEAD_DIM) * ldc * es
    warp = 16 * (sp + 4) * 4 + 256 * 4 + 16 * 4 + 16 * (sp + pad) * es
    return (sp * ldf * 4 + _QUERY_TILE * ldf * 4 + sp * (_HEAD_DIM + pad) * es + sp * 4
            + max(staging, 4 * warp))


def max_seq(dtype: torch.dtype, smem: int) -> int:
    """The largest S the kernel takes in ``dtype`` given ``smem`` bytes of
    opt-in shared memory per block (fp32 K, rounded V and the fp32 score
    rows of a head; 256 in bf16 and 192 in fp32 on an H100)."""
    s = 0
    while _smem_bytes(s + 16, dtype) <= smem:
        s += 16
    return s


def fits(B: int, S: int, D: int, num_heads: int, dtype: torch.dtype, smem: int) -> bool:
    """Whether the kernel takes x (B, S, D) in ``dtype``."""
    return (dtype in _DTYPES and D % num_heads == 0 and D // num_heads == _HEAD_DIM
            and D in _WIDTHS and 1 <= B <= _MAX_GRID_YZ and num_heads <= _MAX_GRID_YZ
            and 1 <= S <= max_seq(dtype, smem))


def _launch(x, wqkv, bqkv, wproj, bproj, num_heads: int, key_mask) -> torch.Tensor:
    global launches
    name = "fused_attention_block"
    B, S, D = x.shape
    _build.check_cuda_operand(x, f"{name} x", _DTYPES)
    wqkv, wproj = wqkv.to(x.dtype).contiguous(), wproj.to(x.dtype).contiguous()
    _build.check_cuda_operand(wqkv, f"{name} wqkv", (x.dtype,))
    _build.check_cuda_operand(wproj, f"{name} wproj", (x.dtype,))
    smem = _build.smem_optin(x.device)
    if not fits(B, S, D, num_heads, x.dtype, smem):
        raise ValueError(
            f"{name} kernel needs head_dim {_HEAD_DIM}, D in {_WIDTHS}, B <= {_MAX_GRID_YZ} and "
            f"S <= {max_seq(x.dtype, smem)} for {x.dtype} on this device (fp32 K, V and score "
            f"rows in shared memory); got head_dim={D // num_heads}, D={D}, B={B}, S={S}")
    vecs = [v.detach().float().contiguous() for v in (bqkv, bproj)]
    if key_mask is not None:
        vecs.append(key_bias(key_mask).contiguous())
    for v in vecs:
        _build.check_cuda_operand(v, f"{name} bias", (torch.float32,), align=4)
    heads = torch.empty_like(x)
    out = torch.empty_like(x)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    q_split = min(max(1, -(-sms // (B * num_heads))), -(-S // _QUERY_TILE))
    dev, stream = _build.stream_args(x)
    err = _build.lib().alpro_block_attn(
        x.data_ptr(), wqkv.data_ptr(), vecs[0].data_ptr(), wproj.data_ptr(), vecs[1].data_ptr(),
        vecs[2].data_ptr() if key_mask is not None else None, heads.data_ptr(), out.data_ptr(),
        B, S, num_heads, q_split, float((D // num_heads) ** -0.5),
        int(x.dtype == torch.bfloat16), dev, stream,
    )
    _build.check(err, name)
    launches += 1
    return out


class _KernelBlock(torch.autograd.Function):
    """kernel forward, vjp of the plain twin backward."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wproj, bproj, num_heads, key_mask):
        ctx.save_for_backward(x, wqkv, bqkv, wproj, bproj)
        ctx.args = (num_heads, key_mask)
        return _launch(x, wqkv, bqkv, wproj, bproj, num_heads, key_mask)

    @staticmethod
    def backward(ctx, g):
        num_heads, key_mask = ctx.args
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            grads = torch.autograd.grad(
                fused_attention_block_plain(*ins, num_heads, key_mask), ins, g)
        return (*grads, None, None)


def fused_attention_block(x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
                          wproj: torch.Tensor, bproj: torch.Tensor, num_heads: int,
                          key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``proj(attention(qkv(x))) + bproj`` over x (B, S, D) → (B, S, D),
    before the residual; bf16 or fp32."""
    if x.dim() != 3:
        raise ValueError(f"expected (B, S, D) x, got shape {tuple(x.shape)}")
    B, S, D = x.shape
    if D % num_heads:
        raise ValueError(f"D={D} is not a multiple of num_heads={num_heads}")
    if (tuple(wqkv.shape) != (3 * D, D) or tuple(bqkv.shape) != (3 * D,)
            or tuple(wproj.shape) != (D, D) or tuple(bproj.shape) != (D,)):
        raise ValueError(f"weight shapes {tuple(wqkv.shape)}, {tuple(bqkv.shape)}, "
                         f"{tuple(wproj.shape)}, {tuple(bproj.shape)} for D={D}")
    if key_mask is not None and tuple(key_mask.shape) != (B, S):
        raise ValueError(f"key_mask: shape {tuple(key_mask.shape)} != {(B, S)}")
    if x.device.type == "cpu":
        return fused_attention_block_plain(x, wqkv, bqkv, wproj, bproj, num_heads, key_mask)
    return _KernelBlock.apply(x, wqkv, bqkv, wproj, bproj, num_heads, key_mask)
