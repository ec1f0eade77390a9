"""Whole attention chains of the divided space-time block, LN → qkv →
attention → projection, behind one call each.

Counterpart of ``alpro_tpu/ops/pallas_fused_block.py``:

* ``fused_spatial_block`` ← ``fused_spatial_block`` (kernel
  ``csrc/fused_block.cu``, twin ``fused_spatial_block_plain`` =
  ``_spatial_block_xla_reference``): ``[x +] proj(softmax(q kᵀ·hd^-½) v)``
  with q, k, v = LN(x)·Wqkvᵀ + b, per cell (M, S, D);
* ``fused_temporal_block`` ← ``fused_temporal_block`` (same source, twin
  ``fused_temporal_block_plain`` = ``_temporal_block_xla_reference``):
  ``x + attn_T(qkv(LN(x)))·w_effᵀ + b_eff`` on (B, T, N, D), attention over
  T at each (b, n) and head, w_eff the folded proj·temporal_fc.

Weights are in torch Linear layout (out, in): wqkv (3D, D) with ``[q|k|v]``
rows, each head-major; wproj and w_eff (D, D). Rounding points: the LN output
rounds to the weights' dtype and the products accumulate in fp32; the twins
keep q, k, v, scores and p in fp32, as the XLA references do. The spatial
kernel does too (its TPU kernel keeps q, k, v in fp32): in bf16 it carries
q, k, v and p as bf16 pairs hi + lo (fp32 to ~2^-16) through the tensor-core
products; the temporal kernel rounds q, k, v to x's dtype after their fp32
bias, as its TPU kernel does, so in bf16 it is held to the twin with the
tolerance of the kernels that round where their twins do not, and to
``fused_temporal_block_reference``, the TPU kernel's own rounding points,
within one output ulp. The per-head output rounds to the projection
weight's dtype, and the projection sums the heads in fp32, + bias (+ the
fp32 residual).

In bf16 each call is four launches behind one C call (the source gives the
design). Spatial: the LN rows, the TMA/``wgmma`` GEMM into six bf16 scratch
tensors (q, k, v as hi + lo pairs), the attention body
(``csrc/attn_wgmma.cuh`` under kSplit and kPSplit) and the GEMM again for
the projection. Temporal: the LN rows and the GEMM into the packed (R, 3D)
qkv scratch (``ops/ln_matmul.py``'s route), K2's body
(``csrc/temporal_attn.cuh``) on it in place, and the GEMM for the
projection + b_eff + the residual. Both take the layer's bf16 LN and bias
vectors as they are (``_build.layer_vectors``). fp32 is a test dtype, two
launches (a heads launch, then ``proj_rows``).

A wrapper runs the twin only for a CPU tensor; for a CUDA tensor it launches
the kernel or raises. ``spatial_launches`` and ``temporal_launches`` count
wrapper calls that launched (one per call). Neither kernel has a backward
(the JAX model reaches them only at serving): a wrapper raises when grad mode
is on and an input requires grad.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from alpro_tpu_torch.ops import _build
from alpro_tpu_torch.ops.kernel_math import ln_rows_f32
from alpro_tpu_torch.ops.ln_mlp import _WIDTHS  # the D values row_tile.cuh's kernels take
from alpro_tpu_torch.ops.qkv_attn import attn_wgmma_smem, largest_seq, seq_limit_text
from alpro_tpu_torch.ops.qkv_attn import temporal_fits as temporal_attn_fits

spatial_launches = 0
temporal_launches = 0

_DTYPES = (torch.bfloat16, torch.float32)
_HEAD_DIM = 64  # csrc/fused_block.cu kHD
_QUERY_TILE = 64  # csrc/fused_block.cu kQT
_MAX_T = 32  # csrc/fused_block.cu, fp32: the temporal softmax holds one score per lane
_MAX_GRID_YZ = 65535
_GEMM_TILE = 128  # csrc/gemm_wgmma.cuh kBN: the temporal bf16 route's D (qkv 3D and proj D columns)
_MAX_D_BF16 = 1024  # csrc/ln_rows.cuh: a row in one warp's registers
_VECTORS = ("ln_s", "ln_b", "bqkv", "bproj")
_TEMPORAL_VECTORS = ("ln_s", "ln_b", "bqkv", "b_eff")
# (M·S, D) tensors of scratch one spatial call allocates: bf16 xn (then the
# heads), q_hi, q_lo, k_hi, k_lo, v_hi, v_lo; fp32 the heads
_SPATIAL_SCRATCH = {torch.bfloat16: 7, torch.float32: 1}
# (R, D) tensors of scratch one temporal call allocates: bf16 xn (then the
# heads) and the packed qkv's three; fp32 the heads
_TEMPORAL_SCRATCH = {torch.bfloat16: 4, torch.float32: 1}


def _lin_f32(x, w, b) -> torch.Tensor:
    """x·Wᵀ + b on x rounded to the weight's dtype, fp32 products and sums."""
    return x.to(w.dtype).float() @ w.float().t() + b.float()


def _qkv_f32(x, ln_s, ln_b, wqkv, bqkv, num_heads, eps):
    """q (pre-scaled), k, v in fp32, each (..., H, hd)."""
    D = x.shape[-1]
    hd = D // num_heads
    qkv = _lin_f32(ln_rows_f32(x, ln_s, ln_b, eps), wqkv, bqkv)
    shape = x.shape[:-1] + (num_heads, hd)
    return (qkv[..., :D].reshape(shape) * hd ** -0.5, qkv[..., D:2 * D].reshape(shape),
            qkv[..., 2 * D:].reshape(shape))


def fused_spatial_block_plain(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, num_heads: int,
                              eps: float, residual: bool = False) -> torch.Tensor:
    """Plain twin (``_spatial_block_xla_reference``): q, k, v, scores,
    softmax and PV in fp32; the attention output rounds to wproj's dtype;
    fp32 projection, bias and residual; output in x.dtype."""
    M, S, D = x.shape
    q, k, v = _qkv_f32(x, ln_s, ln_b, wqkv, bqkv, num_heads, eps)
    p = torch.softmax(torch.einsum("mqhd,mkhd->mhqk", q, k), dim=-1)
    o = torch.einsum("mhqk,mkhd->mqhd", p, v).reshape(M, S, D)
    y = _lin_f32(o, wproj, bproj)
    if residual:
        y = y + x.float()
    return y.to(x.dtype)


def fused_temporal_block_plain(x, ln_s, ln_b, wqkv, bqkv, w_eff, b_eff, num_heads: int,
                               eps: float) -> torch.Tensor:
    """Plain twin (``_temporal_block_xla_reference``): q, k, v, scores,
    softmax and PV in fp32; the attention output rounds to w_eff's dtype;
    fp32 projection, bias and residual; output in x.dtype."""
    B, T, N, D = x.shape
    q, k, v = _qkv_f32(x, ln_s, ln_b, wqkv, bqkv, num_heads, eps)
    p = torch.softmax(torch.einsum("btnhd,bsnhd->bnhts", q, k), dim=-1)
    o = torch.einsum("bnhts,bsnhd->btnhd", p, v).reshape(B, T, N, D)
    return (_lin_f32(o, w_eff, b_eff) + x.float()).to(x.dtype)


def _check_args(name, x, wqkv, bqkv, wo, bo, ln_s, ln_b, num_heads) -> int:
    D = x.shape[-1]
    if D % num_heads:
        raise ValueError(f"{name}: D={D} is not a multiple of num_heads={num_heads}")
    if (tuple(wqkv.shape) != (3 * D, D) or bqkv.shape != (3 * D,)
            or tuple(wo.shape) != (D, D) or bo.shape != (D,)
            or ln_s.shape != (D,) or ln_b.shape != (D,)):
        raise ValueError(
            f"{name}: shape mismatch: x {tuple(x.shape)}, wqkv {tuple(wqkv.shape)}, "
            f"bqkv {tuple(bqkv.shape)}, w {tuple(wo.shape)}, b {tuple(bo.shape)}"
        )
    _build.refuse_grad(name, x, wqkv, bqkv, wo, bo, ln_s, ln_b)
    return D // num_heads


def _cuda_operands(name, x, wqkv, wo, hd) -> None:
    """Check x and the two weights on the card."""
    D = x.shape[-1]
    _build.check_cuda_operand(x, f"{name} x", _DTYPES)
    for key, w in (("wqkv", wqkv), ("w", wo)):
        _build.check_cuda_operand(w, f"{name} {key}", (x.dtype,))
    if hd != _HEAD_DIM or D not in _WIDTHS:
        raise ValueError(
            f"{name} kernel needs head_dim {_HEAD_DIM} and D in {_WIDTHS}; got head_dim={hd}, "
            f"D={D}"
        )


def _f32_smem(S: int) -> int:
    """Shared memory of one fp32 spatial heads block (``csrc/fused_block.cu``
    spatial_smem<float>): the cell's fp32 K and V, a query tile, the LN
    statistics, and the staging area or four warps' score rows."""
    sp, ldf = -(-S // 16) * 16, _HEAD_DIM + 4
    staging = (64 + 2 * _HEAD_DIM) * (64 + 4) * 4  # head_proj.cuh staging_bytes<float>(2)
    warps = 4 * (16 * (sp + 4) + 256 + 16) * 4
    return 2 * sp * ldf * 4 + _QUERY_TILE * ldf * 4 + 2 * sp * 4 + max(staging, warps)


def spatial_smem(S: int, dtype: torch.dtype, smem: int) -> int:
    """Dynamic shared memory of B9's launch at S keys (``csrc/fused_block.cu``
    ``alpro_fused_spatial_smem``) on a device with ``smem`` bytes of opt-in
    shared memory per block, or 0 where none fits: in bf16 the attention
    body's plan under kSplit with v_lo (a K slot of k_hi, v_hi, v_lo and
    k_lo; past 256 keys a ring of slots of 128), in fp32 the heads block."""
    if S < 1:
        return 0
    if dtype == torch.bfloat16:
        return attn_wgmma_smem(S, _HEAD_DIM, smem, split=True, vlo=True)
    need = _f32_smem(S)
    return need if need <= smem else 0


@functools.lru_cache(maxsize=None)
def spatial_max_seq(dtype: torch.dtype, smem: int) -> Optional[int]:
    """The largest S the spatial kernel takes in ``dtype`` given ``smem``
    bytes of opt-in shared memory per block: None in bf16 on an H100 (past
    256 keys they stream through a ring of K/V slots, so S has no limit),
    256 in fp32 (the cell's fp32 K, V and score rows)."""
    return largest_seq(lambda S: spatial_smem(S, dtype, smem), dtype)


def spatial_fits(M: int, S: int, D: int, num_heads: int, dtype: torch.dtype,
                 smem: int) -> bool:
    """Whether the spatial kernel takes x (M, S, D) in ``dtype``: head_dim
    64, D in (256, 512, 768, 1024), M and H within the grid, S >= 1 and a
    launch that fits shared memory."""
    return (dtype in _DTYPES and D % num_heads == 0 and D // num_heads == _HEAD_DIM
            and D in _WIDTHS and 1 <= M <= _MAX_GRID_YZ and num_heads <= _MAX_GRID_YZ
            and spatial_smem(S, dtype, smem) > 0)


def spatial_max_seq_len(dtype: torch.dtype, device) -> Optional[int]:
    """``spatial_max_seq`` on ``device`` (None: no limit)."""
    return spatial_max_seq(dtype, _build.smem_optin(device))


def spatial_scratch_shape(M: int, S: int, D: int, dtype: torch.dtype) -> tuple:
    """The scratch one spatial call allocates (in ``dtype``): bf16 xn (then
    the heads) and q, k, v as hi + lo pairs; fp32 the heads."""
    return (_SPATIAL_SCRATCH[dtype], M * S, D)


def fused_spatial_block(x: torch.Tensor, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                        num_heads: int, *, eps: float, residual: bool = False) -> torch.Tensor:
    """``[x +] proj(attn(qkv(LN(x))))`` per cell of x (M, S, D). The kernel
    takes x and the weights contiguous in one dtype (bf16 or fp32), the LN
    and bias vectors in bf16 (all four, beside bf16 x: read as they are) or
    fp32, head_dim 64, D in (256, 512, 768, 1024) and S up to
    ``spatial_max_seq_len`` (bf16: any S); it raises on anything else."""
    name = "fused_spatial_block"
    if x.dim() != 3:
        raise ValueError(f"expected (M, S, D) x, got shape {tuple(x.shape)}")
    hd = _check_args(name, x, wqkv, bqkv, wproj, bproj, ln_s, ln_b, num_heads)
    if x.device.type == "cpu":
        return fused_spatial_block_plain(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, num_heads,
                                         eps, residual)
    _cuda_operands(name, x, wqkv, wproj, hd)
    M, S, D = x.shape
    smem = _build.smem_optin(x.device)
    if not spatial_fits(M, S, D, num_heads, x.dtype, smem):
        raise ValueError(
            f"{name} kernel takes {seq_limit_text(spatial_max_seq(x.dtype, smem))} for {x.dtype}"
            f" on this device and M <= {_MAX_GRID_YZ}; got S={S}, M={M}"
        )
    vecs, vec_bf16 = _build.layer_vectors(name, x, dict(zip(_VECTORS,
                                                             (ln_s, ln_b, bqkv, bproj))))
    return _launch_spatial(x, vecs, vec_bf16, wqkv, wproj, num_heads, eps, residual)


def _launch_spatial(x, vecs, vec_bf16: int, wqkv, wproj, num_heads: int, eps: float,
                    residual: bool) -> torch.Tensor:
    """One launch of the checked operands; vecs (ln_s, ln_b, bqkv, bproj)
    as ``_build.layer_vectors`` gives them."""
    global spatial_launches
    M, S, D = x.shape
    hd = D // num_heads
    bf16 = x.dtype == torch.bfloat16
    scratch = torch.empty(spatial_scratch_shape(M, S, D, x.dtype), dtype=x.dtype,
                          device=x.device)
    out = torch.empty_like(x)
    q_split = 0 if bf16 else min(max(1, -(-_build.sm_count(x.device) // (M * num_heads))),
                                 -(-S // _QUERY_TILE))
    dev, stream = _build.stream_args(x)
    err = _build.lib().alpro_fused_spatial_block(
        x.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(), wqkv.data_ptr(),
        vecs[2].data_ptr(), wproj.data_ptr(), vecs[3].data_ptr(), scratch.data_ptr(),
        out.data_ptr(), M, S, num_heads, q_split, float(hd ** -0.5), float(eps), int(residual),
        int(bf16), vec_bf16, dev, stream,
    )
    _build.check(err, "fused_spatial_block")
    spatial_launches += 1
    return out


def temporal_fits(B: int, T: int, D: int, num_heads: int, dtype: torch.dtype,
                  smem: int) -> bool:
    """Whether the temporal kernel takes x (B, T, N, D) in ``dtype`` given
    ``smem`` bytes of opt-in shared memory per block: bf16 the limits of
    its parts — K2's body (``qkv_attn.temporal_fits``: head_dim a multiple
    of 8 up to 128, 1 <= T <= 128) and the LN rows and GEMM (D a multiple of
    128 up to 1024); fp32 head_dim 64, D in (256, 512, 768, 1024), 1 <= T
    <= 32 and B within the grid."""
    if dtype not in _DTYPES or D % num_heads or B < 1:
        return False
    hd = D // num_heads
    if dtype == torch.bfloat16:
        return (temporal_attn_fits(T, hd, dtype, smem) and D % _GEMM_TILE == 0
                and D <= _MAX_D_BF16)
    return hd == _HEAD_DIM and D in _WIDTHS and 1 <= T <= _MAX_T and B <= _MAX_GRID_YZ


def temporal_scratch_shape(B: int, T: int, N: int, D: int, dtype: torch.dtype) -> tuple:
    """The scratch one temporal call allocates (in ``dtype``), R = B·T·N:
    bf16 (4, R, D) — xn (then the heads) and the packed qkv (R, 3D), K2's
    (B, T, N, 3D) input; fp32 the (1, R, D) heads."""
    return (_TEMPORAL_SCRATCH[dtype], B * T * N, D)


def fused_temporal_block_reference(x, ln_s, ln_b, wqkv, bqkv, w_eff, b_eff, num_heads: int,
                                   eps: float) -> torch.Tensor:
    """The TPU kernel's contract (``_temporal_block_kernel`` of
    ``alpro_tpu/ops/pallas_fused_block.py``) in plain torch: xn = LN(x)
    rounded to wqkv's dtype; q, k and v = xn·Wᵀ with fp32 accumulation plus
    the fp32 bias, rounded to x's dtype; per head in fp32, q times hd^-½,
    scores over all T, p = exp(s - max) with the exact max, o = Σ p·v / Σ p,
    rounded to w_eff's dtype; the projection summed over the heads in fp32
    + b_eff + the fp32 residual, rounded once to x's dtype. Only the tests
    and ``chip_smoke.py`` use it (the twin is
    ``fused_temporal_block_plain``)."""
    B, T, N, D = x.shape
    hd = D // num_heads
    qkv = _lin_f32(ln_rows_f32(x, ln_s, ln_b, eps), wqkv, bqkv).to(x.dtype).float()
    shape = (B, T, N, num_heads, hd)
    q = qkv[..., :D].reshape(shape) * hd ** -0.5
    k, v = qkv[..., D:2 * D].reshape(shape), qkv[..., 2 * D:].reshape(shape)
    s = torch.einsum("btnhd,bsnhd->bnhts", q, k)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bnhts,bsnhd->btnhd", p, v) / p.sum(dim=-1).permute(0, 3, 1, 2)[..., None]
    return (_lin_f32(o.reshape(B, T, N, D), w_eff, b_eff) + x.float()).to(x.dtype)


def fused_temporal_block(x: torch.Tensor, ln_s, ln_b, wqkv, bqkv, w_eff, b_eff,
                         num_heads: int, *, eps: float) -> torch.Tensor:
    """``x + attn_T(qkv(LN(x)))·w_effᵀ + b_eff`` on x (B, T, N, D). The
    kernel takes x (contiguous: the projection reads it in place as the
    residual) and the weights contiguous in one dtype (bf16 or fp32), the
    vectors all bf16 beside bf16 x (read as they are) or as fp32, and the
    shapes of ``temporal_fits``; it raises on anything else."""
    name = "fused_temporal_block"
    if x.dim() != 4:
        raise ValueError(f"expected (B, T, N, D) x, got shape {tuple(x.shape)}")
    _check_args(name, x, wqkv, bqkv, w_eff, b_eff, ln_s, ln_b, num_heads)
    if x.device.type == "cpu":
        return fused_temporal_block_plain(x, ln_s, ln_b, wqkv, bqkv, w_eff, b_eff, num_heads,
                                          eps)
    _build.check_cuda_operand(x, f"{name} x", _DTYPES)
    for key, w in (("wqkv", wqkv), ("w_eff", w_eff)):
        _build.check_cuda_operand(w, f"{name} {key}", (x.dtype,))
    B, T, N, D = x.shape
    if N < 1 or not temporal_fits(B, T, D, num_heads, x.dtype, _build.smem_optin(x.device)):
        limit = ("head_dim a multiple of 8 up to 128, 1 <= T <= 128 and D a multiple of 128 up"
                 " to 1024" if x.dtype == torch.bfloat16 else
                 f"head_dim {_HEAD_DIM}, D in {_WIDTHS}, 1 <= T <= {_MAX_T} and B <= "
                 f"{_MAX_GRID_YZ}")
        raise ValueError(f"{name} kernel needs, for {x.dtype}, {limit}; got B={B}, T={T}, "
                         f"N={N}, D={D}, head_dim={D / num_heads:g}")
    vecs, vec_bf16 = _build.layer_vectors(name, x, dict(zip(_TEMPORAL_VECTORS,
                                                             (ln_s, ln_b, bqkv, b_eff))))
    return _launch_temporal(x, vecs, vec_bf16, wqkv, w_eff, num_heads, eps)


def _launch_temporal(x, vecs, vec_bf16: int, wqkv, w_eff, num_heads: int, eps: float,
                     scratch: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the checked operands; vecs (ln_s, ln_b, bqkv, b_eff)
    as ``_build.layer_vectors`` gives them; ``scratch`` of
    ``temporal_scratch_shape`` (default: a new one), which the call leaves
    holding the heads and, in bf16, the packed qkv."""
    global temporal_launches
    B, T, N, D = x.shape
    hd = D // num_heads
    if scratch is None:
        scratch = torch.empty(temporal_scratch_shape(B, T, N, D, x.dtype), dtype=x.dtype,
                              device=x.device)
    out = torch.empty_like(x)
    dev, stream = _build.stream_args(x)
    err = _build.lib().alpro_fused_temporal_block(
        x.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(), wqkv.data_ptr(),
        vecs[2].data_ptr(), w_eff.data_ptr(), vecs[3].data_ptr(), scratch.data_ptr(),
        out.data_ptr(), B, T, N, num_heads, hd, float(hd ** -0.5), float(eps),
        int(x.dtype == torch.bfloat16), vec_bf16, dev, stream,
    )
    _build.check(err, "fused_temporal_block")
    temporal_launches += 1
    return out
