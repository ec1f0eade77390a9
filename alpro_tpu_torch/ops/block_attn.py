"""The whole attention sublayer of a ViT block on the card: qkv projection,
attention with an optional key mask, output projection (before the
residual).

Counterpart of ``alpro_tpu/ops/pallas_block_attn.py::fused_attention_block``
(B17): kernel ``csrc/block_attn.cu``, twin ``fused_attention_block_plain`` =
``_xla_reference``, and ``fused_attention_block_reference``, the TPU
kernel's own contract (its ``_kernel`` body) in plain torch. It computes what
the port's ``Attention`` module (``models/timesformer.py``) computes with its
``qkv`` and ``proj`` weights. No model path reaches it, as in JAX: no
``attn_impl`` value routes to it.

Weights are in torch Linear layout, as in ``Attention``: wqkv (3D, D) with
``[q | k | v]`` row chunks, each (H, hd) head-major, and wproj (D, D), the
transposes of the JAX function's kernels. key_mask (B, S), 1 = valid key,
adds the HF ``(1 - mask)·-10000`` bias in fp32; the kernel computes the bias
from the mask itself.

In bf16 one wrapper call is three launches behind one C call (the source
gives the design): the TMA/``wgmma`` GEMM (``csrc/gemm_wgmma.cuh``) writes
q and k as bf16 pairs hi + lo (fp32 to ~2^-16, so q and k are not rounded
at the contract's 2^-8) and v rounded into a scratch; the attention body
(``csrc/attn_wgmma.cuh`` under ``kSplit``) takes its scores from the three
products q_hi·k_hiᵀ + q_hi·k_loᵀ + q_lo·k_hiᵀ; the GEMM again projects the
heads. fp32 keeps a CUDA-core body. ``gemm_bf16`` runs the GEMM alone.

The wrapper runs the twin only for a CPU tensor; for a CUDA tensor it
launches the kernel or raises (head_dim 64, D in (256, 512, 768, 1024), S up
to ``max_seq``). ``launches`` counts wrapper calls that launched (one per
call). Gradient, as JAX's ``_bwd``: a ``torch.autograd.Function`` whose
backward is the vjp of the twin with respect to x, wqkv, bqkv, wproj and
bproj, recomputed from the saved inputs, none for the mask; a call that needs
no gradient skips the Function.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from alpro_tpu_torch.ops import _build
from alpro_tpu_torch.ops.ln_mlp import _WIDTHS
from alpro_tpu_torch.ops.qkv_attn import attn_wgmma_smem

launches = 0

_DTYPES = (torch.bfloat16, torch.float32)
_HEAD_DIM = 64  # csrc/block_attn.cu (head_proj.cuh kHD, kHeadsBf16)
_QUERY_TILE = 64  # csrc/block_attn.cu kQT (fp32)
_MAX_GRID_YZ = 65535
_GEMM_TILE = 128  # csrc/gemm_wgmma.cuh kBN: N and the split width are multiples
_GEMM_K = 64  # csrc/gemm_wgmma.cuh kBK: K is a multiple
_SCRATCH = {torch.bfloat16: 6, torch.float32: 1}  # (B, S, D) tensors of scratch


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


def fused_attention_block_reference(x, wqkv, bqkv, wproj, bproj, num_heads: int,
                                    key_mask: Optional[torch.Tensor] = None,
                                    query_chunk: Optional[int] = None) -> torch.Tensor:
    """The TPU kernel's contract (``_kernel`` of
    ``alpro_tpu/ops/pallas_block_attn.py``) in plain torch: fp32 q, k and v
    from the operands in x's dtype, upcast, plus the fp32 bias, never
    rounded; s = q·kᵀ·scale + key bias in fp32; p = exp(s - max) rounded to
    x's dtype, v rounded to x's dtype, p·v in fp32 divided by the fp32 sum of
    the unrounded p, rounded per head; the heads through Wp summed in fp32,
    plus the fp32 b_proj, rounded once. ``query_chunk`` bounds the query rows
    whose fp32 scores exist at once (long S). Only tests and
    ``chip_smoke.py`` call it."""
    B, S, D = x.shape
    hd, dt = D // num_heads, x.dtype
    qkv = x.float() @ wqkv.to(dt).float().t() + bqkv.float()
    q, k, v = qkv.reshape(B, S, 3, num_heads, hd).unbind(2)
    v = v.to(dt).float()
    kb = None if key_mask is None else key_bias(key_mask)[:, None, None, :]
    chunk = S if query_chunk is None else query_chunk
    heads = []
    for q0 in range(0, S, chunk):
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, q0:q0 + chunk], k) * hd ** -0.5
        if kb is not None:
            s = s + kb
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        o = torch.einsum("bhqk,bkhd->bqhd", p.to(dt).float(), v)
        heads.append((o / p.sum(dim=-1).transpose(1, 2)[..., None]).to(dt))
    o = torch.cat(heads, dim=1).reshape(B, S, D).float()
    return (o @ wproj.to(dt).float().t() + bproj.float()).to(dt)


def attention_smem(S: int, smem: int, masked: bool) -> int:
    """Dynamic shared memory of the bf16 route's attention launch at S keys
    (``csrc/attn_wgmma.cuh`` ``plan_bf16`` under kSplit, with the key-bias
    row where ``masked``), or 0 where none fits ``smem``."""
    return attn_wgmma_smem(S, _HEAD_DIM, smem, bias=masked, split=True)


def _f32_smem_bytes(S: int) -> int:
    """Shared memory of one fp32 heads block (``csrc/block_attn.cu``
    smem_bytes<float>)."""
    sp = -(-S // 16) * 16
    ldf, ldc, pad = _HEAD_DIM + 4, 64 + 4, 4
    staging = (64 + 2 * _HEAD_DIM) * ldc * 4
    warp = 16 * (sp + 4) * 4 + 256 * 4 + 16 * 4 + 16 * (sp + pad) * 4
    return (sp * ldf * 4 + _QUERY_TILE * ldf * 4 + sp * (_HEAD_DIM + pad) * 4 + sp * 4
            + max(staging, 4 * warp))


def _seq_fits(S: int, dtype: torch.dtype, smem: int) -> bool:
    """Whether S keys fit ``smem``: in bf16 the attention plan with the
    key-bias row (the unmasked plan is smaller), in fp32 the heads block."""
    if dtype == torch.bfloat16:
        return attention_smem(S, smem, True) > 0
    return _f32_smem_bytes(S) <= smem


@functools.lru_cache(maxsize=None)
def max_seq(dtype: torch.dtype, smem: int) -> int:
    """The largest S the kernel takes in ``dtype`` given ``smem`` bytes of
    opt-in shared memory per block: in bf16 the attention plan with the
    key-bias row (past 256 keys a ring of two slots of k_hi, v and k_lo
    beside a bias row of 4 bytes a key: 4096 on an H100), in fp32 K, V and
    the score rows of a head (192 on an H100)."""
    s = 0
    while _seq_fits(s + 1, dtype, smem):
        s += 1
    return s


def fits(B: int, S: int, D: int, num_heads: int, dtype: torch.dtype, smem: int) -> bool:
    """Whether the kernel takes x (B, S, D) in ``dtype``."""
    return (dtype in _DTYPES and D % num_heads == 0 and D // num_heads == _HEAD_DIM
            and D in _WIDTHS and 1 <= B <= _MAX_GRID_YZ and num_heads <= _MAX_GRID_YZ
            and S >= 1 and _seq_fits(S, dtype, smem))


def scratch_shape(B: int, S: int, D: int, dtype: torch.dtype) -> tuple:
    """The scratch one call allocates (in ``dtype``): bf16 q_hi, q_lo, k_hi,
    k_lo, v and the heads; fp32 the heads."""
    return (_SCRATCH[dtype], B, S, D)


def _launch(x, wqkv, bqkv, wproj, bproj, num_heads: int, key_mask) -> torch.Tensor:
    global launches
    name = "fused_attention_block"
    B, S, D = x.shape
    _build.check_cuda_operand(x, f"{name} x", _DTYPES)
    smem = _build.smem_optin(x.device)
    if not fits(B, S, D, num_heads, x.dtype, smem):
        raise ValueError(
            f"{name} kernel needs head_dim {_HEAD_DIM}, D in {_WIDTHS}, B <= {_MAX_GRID_YZ} and "
            f"S <= {max_seq(x.dtype, smem)} for {x.dtype} on this device (the attention's K, V "
            f"and scores in shared memory); got head_dim={D // num_heads}, D={D}, B={B}, S={S}")
    wqkv, wproj = wqkv.to(x.dtype).contiguous(), wproj.to(x.dtype).contiguous()
    _build.check_cuda_operand(wqkv, f"{name} wqkv", (x.dtype,))
    _build.check_cuda_operand(wproj, f"{name} wproj", (x.dtype,))
    vecs = [v.detach().float().contiguous() for v in (bqkv, bproj)]
    if key_mask is not None:
        vecs.append(key_mask.to(device=x.device, dtype=torch.float32).contiguous())
    for v in vecs:
        _build.check_cuda_operand(v, f"{name} bias", (torch.float32,), align=4)
    scratch = torch.empty(scratch_shape(B, S, D, x.dtype), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    q_split = min(max(1, -(-_build.sm_count(x.device) // (B * num_heads))),
                  -(-S // _QUERY_TILE))
    dev, stream = _build.stream_args(x)
    err = _build.lib().alpro_block_attn(
        x.data_ptr(), wqkv.data_ptr(), vecs[0].data_ptr(), wproj.data_ptr(), vecs[1].data_ptr(),
        vecs[2].data_ptr() if key_mask is not None else None, scratch.data_ptr(), out.data_ptr(),
        B, S, num_heads, q_split, float((D // num_heads) ** -0.5),
        int(x.dtype == torch.bfloat16), dev, stream,
    )
    _build.check(err, name)
    launches += 1
    return out


def gemm_bf16(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, split: int = 0):
    """B17's GEMM alone (``csrc/gemm_wgmma.cuh``) on CUDA tensors: a (M, K)
    · w (N, K)ᵀ + bias (N, fp32), bf16 a and w, fp32 accumulation. split 0:
    the (M, N) bf16 result; split D (N = 3D): (q_hi, q_lo, k_hi, k_lo, v),
    each (M, D) bf16, q and k as hi = bf16(y), lo = bf16(y - hi). N and D
    multiples of 128, K of 64. Not counted in ``launches``."""
    (M, K), N = a.shape, w.shape[0]
    if (tuple(w.shape) != (N, K) or tuple(bias.shape) != (N,) or N % _GEMM_TILE or K % _GEMM_K
            or (split and (split % _GEMM_TILE or N != 3 * split))):
        raise ValueError(f"gemm_bf16: a {tuple(a.shape)}, w {tuple(w.shape)}, bias "
                         f"{tuple(bias.shape)}, split {split}: N and split must be multiples of "
                         f"{_GEMM_TILE}, K of {_GEMM_K}, N = 3·split")
    for t, what in ((a, "a"), (w, "w")):
        _build.check_cuda_operand(t, f"gemm_bf16 {what}", (torch.bfloat16,))
    _build.check_cuda_operand(bias, "gemm_bf16 bias", (torch.float32,), align=4)
    outs = [torch.empty(M, split or N, dtype=torch.bfloat16, device=a.device)
            for _ in range(5 if split else 1)]
    ptrs = (ctypes.c_void_p * 5)(*[t.data_ptr() for t in outs])
    dev, stream = _build.stream_args(a)
    err = _build.lib().alpro_gemm_bf16(a.data_ptr(), w.data_ptr(), bias.data_ptr(),
                                       ctypes.addressof(ptrs), M, N, K, split, dev, stream)
    _build.check(err, "gemm_bf16")
    return tuple(outs) if split else outs[0]


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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, wqkv, bqkv, wproj, bproj)):
        return _KernelBlock.apply(x, wqkv, bqkv, wproj, bproj, num_heads, key_mask)
    return _launch(x, wqkv, bqkv, wproj, bproj, num_heads, key_mask)
