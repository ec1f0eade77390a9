"""Packed-qkv attention of the divided space-time block: spatial (per frame)
and temporal (per patch location), each a CUDA kernel with its plain twin.

Counterpart of ``alpro_tpu/ops/pallas_qkv_attn.py``:

* ``spatial_attention_qkv`` ← ``fused_attention_qkv`` (kernel
  ``csrc/spatial_attn.cu``, twin ``spatial_attention_plain`` =
  ``_spatial_xla_reference``);
* ``temporal_attention_qkv`` ← ``fused_temporal_attention_qkv`` (kernel
  ``csrc/temporal_attn.cu``, twin ``temporal_attention_plain`` =
  ``_temporal_xla_reference``);
* ``spatial_attention_qkv_cls`` ← ``fused_attention_qkv_cls`` (the CLS-
  sideband variant of ``csrc/spatial_attn.cu``, twin
  ``spatial_attention_qkv_cls_plain`` = ``_spatial_cls_xla_reference``):
  per frame over [CLS | N patches], the CLS row one per sample;
* ``spatial_attention_qkv_proj`` ← ``fused_attention_qkv_proj`` and
  ``temporal_attention_qkv_proj`` ← ``fused_temporal_attention_qkv_proj``
  (kernels ``csrc/qkv_proj.cu``, twins ``*_qkv_proj_plain`` =
  ``_spatial_qkv_proj_xla_reference`` / ``_temporal_qkv_proj_xla_reference``):
  the attention then the output projection, the per-head output rounded to
  the weight's dtype and the heads summed in fp32.

Channel layout is the fused qkv projection's: ``[q | k | v]``, each (H, hd)
head-major; projection weights in torch Linear layout (out, in). A wrapper
runs the twin only for a CPU tensor; for a CUDA tensor it launches the kernel
or raises. ``*_launches`` count kernel launches (one per call). K1 (with
B6) and K2 each have one limit predicate (``spatial_fits``: head_dim 32,
64 or 128 and a launch that fits shared memory, any S;
``temporal_fits``: head_dim a multiple of 8 up to 128, T up to 128 and a
launch that fits shared memory), which their wrappers' checks and the
model's ``auto`` read; B8's (``temporal_proj_fits``) takes K2's in bf16.
The temporal kernel also carries B16 (``ops/temporal_attn.py``).

Gradient: as the JAX custom_vjp (``_spatial_bwd`` / ``_temporal_bwd``), a
K1/K2 call under grad is the ``torch.library`` custom op
``alpro_tpu_torch::qkv_attention`` whose backward is the vjp of the plain
twin, recomputed from the saved packed qkv (an op that the checkpointing
policies of ``models/remat.py`` see). On a CPU tensor the twin is
differentiated directly, which is the same vjp. The CLS-sideband and
projection kernels have no backward (the JAX model reaches them only at
serving): their wrappers raise when grad mode is on and an input requires
grad.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from alpro_tpu_torch.models.remat import keep_output
from alpro_tpu_torch.ops import _build
from alpro_tpu_torch.ops.ln_mlp import _WIDTHS  # the D values row_tile.cuh's kernels take

spatial_launches = 0
temporal_launches = 0
spatial_cls_launches = 0
spatial_proj_launches = 0
temporal_proj_launches = 0

_DTYPES = (torch.bfloat16, torch.float32)
_MAX_GRID_YZ = 65535
_PROJ_HEAD_DIM = 64  # csrc/qkv_proj.cu (attn_f32.cuh kHD)
_PROJ_QUERY_TILE = 64  # csrc/qkv_proj.cu kQT
_MAX_T = 32  # csrc/qkv_proj.cu, fp32 B8: T x 32/T locations per 32-row tile
_GEMM_TILE = 128  # csrc/gemm_wgmma.cuh kBN: B8's bf16 D is a multiple of it
_TEMPORAL_MAX_T = 128  # csrc/temporal_attn.cuh kMaxT
_TEMPORAL_MAX_HD = 128  # csrc/temporal_attn.cuh: up to 4 channels per lane (wide path)
# csrc/temporal_attn.cuh's fast path: kFastMaxT, kRowThreads, kStageBytes
_TEMPORAL_FAST_MAX_T, _TEMPORAL_ROW_THREADS, _TEMPORAL_STAGE_BYTES = 32, 128, 49152


# ---- the limits of K1 and K2: one predicate each, read by the wrappers and
#      by 'auto' (models/timesformer.py); smem is the device's opt-in shared
#      memory per block (_build.smem_optin) ----


_SPATIAL_HEAD_DIMS = (32, 64, 128)  # csrc/attn_wgmma.cuh Cfg, csrc/spatial_attn.cu dispatch
_SPATIAL_MAX_SLOTS = 30  # csrc/attn_wgmma.cuh kMaxSlots


def attn_wgmma_smem(keys: int, hd: int, smem: int, bias: bool = False,
                    split: bool = False, vlo: bool = False) -> int:
    """Dynamic shared memory of a launch of the bf16 attention body
    (``csrc/attn_wgmma.cuh`` ``plan_bf16``) at ``keys`` keys on a device with
    ``smem`` bytes of opt-in shared memory per block, or 0 where no launch
    fits: two 64-row query tiles and the CLS key block, the key-bias row
    (B12/B13, ``bias``), and K and V in chunks of up to 256 keys (128 at
    head_dim 128) — all of them where they fit, else a ring of at least two.
    ``split`` (B17's kSplit): one query buffer of q_hi and q_lo in place of
    two of q, a K/V slot of k_hi, v and k_lo, and one chunk's keys rounded
    to 16 rows, not 64, with a pad after the slots for the last 64-key
    block's over-read. ``vlo`` (B9's kSplit with kPSplit): a slot holds
    v_lo too, and past one chunk the chunks are half as long (128 keys)."""
    if keys < 1 or hd not in _SPATIAL_HEAD_DIMS:
        return 0
    max_n = 128 if hd == 128 else 256
    if keys <= max_n:
        n, rows = 1, -(-keys // (16 if split else 64)) * (16 if split else 64)
    else:
        rows = max_n // 2 if vlo else max_n
        n = -(-keys // rows)
    fixed = 2048 + 2 * 64 * hd * 2 + -(-8 * hd * 2 // 1024) * 1024
    fixed += (-(-rows // 64) * 64 - rows) * min(hd, 64) * 2  # the pad
    if bias:
        fixed += -(-n * rows * 4 // 1024) * 1024
    slot = (4 if vlo else 3 if split else 2) * rows * hd * 2
    slots = min(n, _SPATIAL_MAX_SLOTS, max(0, (smem - fixed) // slot))
    return fixed + slots * slot if slots >= (2 if n > 1 else 1) else 0


def spatial_smem_bytes(S: int, hd: int, dtype: torch.dtype, smem: int) -> int:
    """Dynamic shared memory of a K1 launch at S keys (``csrc/spatial_attn.cu``
    ``alpro_spatial_attn_smem``) on a device with ``smem`` bytes of opt-in
    shared memory per block, or 0 where no launch fits. bf16: the attention
    body's plan (``attn_wgmma_smem``); fp32: a 64-row query tile, K, V and o
    chunks and the score chunk, whatever S. A B6 launch at S = N + 1 needs no
    more."""
    if S < 1 or hd not in _SPATIAL_HEAD_DIMS:
        return 0
    if dtype == torch.float32:
        need = (4 * 64 * hd + 64 * 64 + 2 * 64) * 4
        return need if need <= smem else 0
    return attn_wgmma_smem(S, hd, smem)


def spatial_fits(M: int, S: int, num_heads: int, hd: int, dtype: torch.dtype,
                 smem: int) -> bool:
    """Whether K1 takes (M, S, 3·H·hd) qkv in ``dtype`` (and B6 its N = S - 1
    patches): head_dim 32, 64 or 128, M and H within the grid, and a launch
    that fits the device's shared memory. S has no upper limit: past one
    chunk of keys the kernel walks them twice and streams K and V."""
    return (dtype in _DTYPES and 1 <= S and M <= _MAX_GRID_YZ and num_heads <= _MAX_GRID_YZ
            and spatial_smem_bytes(S, hd, dtype, smem) > 0)


def spatial_launch_smem(S: int, hd: int, dtype: torch.dtype, device) -> int:
    """The CUDA side's figure for ``spatial_smem_bytes`` on ``device``."""
    dev = torch.device(device).index
    return _build.lib().alpro_spatial_attn_smem(
        S, hd, int(dtype == torch.bfloat16), torch.cuda.current_device() if dev is None else dev)


def _spatial_check(name: str, M: int, S: int, num_heads: int, hd: int, dtype, device) -> None:
    if not spatial_fits(M, S, num_heads, hd, dtype, _build.smem_optin(device)):
        raise ValueError(
            f"{name}: the spatial kernel needs head_dim in {_SPATIAL_HEAD_DIMS}, M, H <= "
            f"{_MAX_GRID_YZ}, S >= 1 and a launch that fits shared memory; got head_dim={hd}, "
            f"M={M}, H={num_heads}, S={S}"
        )


def temporal_smem_bytes(T: int, hd: int, dtype: torch.dtype, smem: int) -> int:
    """Dynamic shared memory of a K2 launch at T frames and head_dim ``hd``
    (``csrc/temporal_attn.cu`` ``alpro_temporal_attn_smem``) on a device
    with ``smem`` bytes of opt-in shared memory per block, or 0 where none
    fits or the shape is outside K2's limits (head_dim a multiple of 8 up to
    128, 1 <= T <= 128). The fast path (T <= 32, ``csrc/temporal_attn.cuh``
    ``fast_smem``): 128 bytes of barriers and two stages of a tile's q, k
    and v boxes, each T x rows x hd values rounded up to 128 bytes, where a
    tile has rows = 128 // T (location, head) rows, fewer where 3·T·rows·hd
    values pass 48 KiB, and at least one. Past it, or where that does not
    fit, the wide path: up to four warps' fp32 K and V (2·T·hd floats
    each)."""
    if dtype not in _DTYPES or hd % 8 or not 8 <= hd <= _TEMPORAL_MAX_HD or \
            not 1 <= T <= _TEMPORAL_MAX_T:
        return 0
    if T <= _TEMPORAL_FAST_MAX_T:
        e = dtype.itemsize
        rows = max(1, min(_TEMPORAL_ROW_THREADS // T, _TEMPORAL_STAGE_BYTES // (3 * T * hd * e)))
        fast = 128 + 2 * 3 * (-(-T * rows * hd * e // 128) * 128)
        if fast <= smem:
            return fast
    per_warp = 2 * T * hd * 4
    return min(4, smem // per_warp) * per_warp if per_warp <= smem else 0


def temporal_fits(T: int, hd: int, dtype: torch.dtype, smem: int) -> bool:
    """Whether K2 (and B16, B10's and B8's attention) takes T frames at
    head_dim ``hd`` in ``dtype``: hd a multiple of 8 up to 128, 1 <= T <=
    128, and a launch that fits shared memory (``temporal_smem_bytes``)."""
    return temporal_smem_bytes(T, hd, dtype, smem) > 0


def temporal_launch_smem(T: int, hd: int, dtype: torch.dtype, device) -> int:
    """The CUDA side's figure for ``temporal_smem_bytes`` on ``device``."""
    dev = torch.device(device).index
    return _build.lib().alpro_temporal_attn_smem(
        T, hd, int(dtype == torch.bfloat16), torch.cuda.current_device() if dev is None else dev)


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


# kind → (launch, twin) of the kernels whose gradient is the twin's vjp: K1,
# K2 and (``ops/temporal_attn.py`` adds it) B16
KERNELS = {}


@torch.library.custom_op("alpro_tpu_torch::qkv_attention", mutates_args=())
def _kernel_attention(qkv: torch.Tensor, num_heads: int, scale: float, kind: str) -> torch.Tensor:
    launch = KERNELS[kind][0]
    return keep_output(lambda: launch(qkv, num_heads, scale), qkv.device)


def _kernel_attention_setup(ctx, inputs, output):
    qkv, num_heads, scale, kind = inputs
    ctx.save_for_backward(qkv)
    ctx.args = (num_heads, scale, KERNELS[kind][1])


def _kernel_attention_backward(ctx, g):
    (qkv,) = ctx.saved_tensors
    num_heads, scale, twin = ctx.args
    return _twin_vjp(twin, qkv, g, num_heads, scale), None, None, None


_kernel_attention.register_autograd(_kernel_attention_backward,
                                    setup_context=_kernel_attention_setup)


def kernel_attention(qkv: torch.Tensor, num_heads: int, scale: float, kind: str) -> torch.Tensor:
    """One launch of kernel ``kind`` on CUDA qkv: under grad, through the
    custom op ``alpro_tpu_torch::qkv_attention`` (its backward the vjp of the
    twin, recomputed from the saved qkv; a launch that a checkpointing policy
    sees, ``models/remat.py::keep_output``); else the launch alone."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return torch.ops.alpro_tpu_torch.qkv_attention(qkv, num_heads, scale, kind)
    return KERNELS[kind][0](qkv, num_heads, scale)


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
    return kernel_attention(qkv, num_heads, float(scale), "spatial")


def _spatial_launch(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    global spatial_launches
    hd = _head_dim(qkv, num_heads)
    _build.check_cuda_operand(qkv, "spatial_attention_qkv", _DTYPES)
    M, S, _ = qkv.shape
    _spatial_check("spatial_attention_qkv", M, S, num_heads, hd, qkv.dtype, qkv.device)
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
    return kernel_attention(qkv, num_heads, float(scale), "temporal")


def temporal_kernel(qkv: torch.Tensor, num_heads: int, scale: float,
                    name: str = "temporal_attention_qkv") -> torch.Tensor:
    """One launch of ``csrc/temporal_attn.cu`` on CUDA qkv (B, T, N, 3D),
    uncounted (the callers count: K2 here, B16 in ``ops/temporal_attn.py``)."""
    hd = _head_dim(qkv, num_heads)
    _build.check_cuda_operand(qkv, name, _DTYPES)
    B, T, N, _ = qkv.shape
    if not temporal_fits(T, hd, qkv.dtype, _build.smem_optin(qkv.device)):
        raise ValueError(
            f"{name}: the temporal kernel needs head_dim a multiple of 8 up to "
            f"{_TEMPORAL_MAX_HD} and 1 <= T <= {_TEMPORAL_MAX_T}; got head_dim={hd}, T={T}"
        )
    out = torch.empty((B, T, N, num_heads * hd), dtype=qkv.dtype, device=qkv.device)
    dev, stream = _build.stream_args(qkv)
    err = _build.lib().alpro_temporal_attn(
        qkv.data_ptr(), out.data_ptr(), B, T, N, num_heads, hd, float(scale),
        int(qkv.dtype == torch.bfloat16), dev, stream,
    )
    _build.check(err, name)
    return out


def _temporal_launch(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    global temporal_launches
    out = temporal_kernel(qkv, num_heads, scale)
    temporal_launches += 1
    return out


KERNELS.update(spatial=(_spatial_launch, spatial_attention_plain),
               temporal=(_temporal_launch, temporal_attention_plain))


# ---- CLS sideband (B6) ----------------------------------------------------


def spatial_attention_qkv_cls_plain(qkv_x: torch.Tensor, qkv_c: torch.Tensor, num_heads: int,
                                    scale: float, T: int):
    """Plain twin (``_spatial_cls_xla_reference``): the CLS row broadcast to
    each of its sample's T frames, concatenated before the patches, the plain
    spatial attention, split back into (patch out, cls out)."""
    M, N, threeD = qkv_x.shape
    c_rep = qkv_c[:, None].expand(M // T, T, 1, threeD).reshape(M, 1, threeD)
    out = spatial_attention_plain(torch.cat([c_rep, qkv_x], dim=1), num_heads, scale)
    return out[:, 1:], out[:, :1]


def spatial_attention_qkv_cls(qkv_x: torch.Tensor, qkv_c: torch.Tensor, num_heads: int, T: int,
                              *, scale: Optional[float] = None):
    """Per-frame attention over [cls | N patches] with no concat: qkv_x
    (B·T, N, 3D) the patch projections, qkv_c (B, 1, 3D) the sample-shared
    CLS projection. Returns (patch out (B·T, N, D), cls out (B·T, 1, D))."""
    global spatial_cls_launches
    if qkv_x.dim() != 3 or qkv_c.dim() != 3:
        raise ValueError(f"expected (B·T, N, 3D) and (B, 1, 3D) qkv, got shapes "
                         f"{tuple(qkv_x.shape)}, {tuple(qkv_c.shape)}")
    M, N, threeD = qkv_x.shape
    if M % T:
        raise ValueError(f"leading dim {M} not divisible by T={T}")
    if tuple(qkv_c.shape) != (M // T, 1, threeD):
        raise ValueError(f"cls qkv shape {tuple(qkv_c.shape)} != {(M // T, 1, threeD)}")
    hd = _head_dim(qkv_x, num_heads)
    scale = hd ** -0.5 if scale is None else float(scale)
    if qkv_x.device.type == "cpu":
        return spatial_attention_qkv_cls_plain(qkv_x, qkv_c, num_heads, scale, T)
    _build.refuse_grad("spatial_attention_qkv_cls", qkv_x, qkv_c)
    _build.check_cuda_operand(qkv_x, "spatial_attention_qkv_cls", _DTYPES)
    _build.check_cuda_operand(qkv_c, "spatial_attention_qkv_cls cls", (qkv_x.dtype,))
    _spatial_check("spatial_attention_qkv_cls", M, N + 1, num_heads, hd, qkv_x.dtype,
                   qkv_x.device)
    out_x = qkv_x.new_empty((M, N, threeD // 3))
    out_c = qkv_x.new_empty((M, 1, threeD // 3))
    dev, stream = _build.stream_args(qkv_x)
    err = _build.lib().alpro_spatial_cls_attn(
        qkv_x.data_ptr(), qkv_c.data_ptr(), out_x.data_ptr(), out_c.data_ptr(), M, N, T,
        num_heads, hd, scale, int(qkv_x.dtype == torch.bfloat16), dev, stream,
    )
    _build.check(err, "spatial_attention_qkv_cls")
    spatial_cls_launches += 1
    return out_x, out_c


# ---- attention + output projection (B7, B8) --------------------------------


def _proj_f32(o: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """o rounded to w's dtype, ·wᵀ with fp32 products and sums, + fp32 b, in
    ``dtype``."""
    return (o.to(w.dtype).float() @ w.float().t() + b.float()).to(dtype)


def spatial_attention_qkv_proj_plain(qkv, wproj, bproj, num_heads: int,
                                     scale: float) -> torch.Tensor:
    """Plain twin (``_spatial_qkv_proj_xla_reference``)."""
    return _proj_f32(spatial_attention_plain(qkv, num_heads, scale), wproj, bproj, qkv.dtype)


def temporal_attention_qkv_proj_plain(qkv, w_eff, b_eff, num_heads: int,
                                      scale: float) -> torch.Tensor:
    """Plain twin (``_temporal_qkv_proj_xla_reference``)."""
    return _proj_f32(temporal_attention_plain(qkv, num_heads, scale), w_eff, b_eff, qkv.dtype)


def _proj_operands(name, qkv, w, b, num_heads) -> int:
    """Check the projection's shapes and, on CUDA, the operands (no grad;
    qkv and w contiguous in one dtype); returns head_dim."""
    D = qkv.shape[-1] // 3
    hd = _head_dim(qkv, num_heads)
    if tuple(w.shape) != (D, D) or tuple(b.shape) != (D,):
        raise ValueError(f"{name}: projection shapes {tuple(w.shape)}, {tuple(b.shape)} for D={D}")
    if qkv.device.type != "cpu":
        _build.refuse_grad(name, qkv, w, b)
        _build.check_cuda_operand(qkv, name, _DTYPES)
        _build.check_cuda_operand(w, f"{name} w", (qkv.dtype,))
    return hd


def _proj_f32_smem(S: int) -> int:
    """Shared memory of one fp32 B7 heads block (``csrc/qkv_proj.cu``
    spatial_smem): the cell's fp32 K and V, a 64-row query tile and four
    warps' score rows."""
    sp, ldf = -(-S // 16) * 16, _PROJ_HEAD_DIM + 4
    warp_floats = 16 * (sp + 4) + 256 + 16
    return (2 * sp + _PROJ_QUERY_TILE) * ldf * 4 + 4 * warp_floats * 4


def spatial_proj_smem(S: int, dtype: torch.dtype, smem: int) -> int:
    """Dynamic shared memory of B7's launch at S keys (``csrc/qkv_proj.cu``
    ``alpro_spatial_qkv_proj_smem``) on a device with ``smem`` bytes of
    opt-in shared memory per block, or 0 where none fits: in bf16 the
    attention body's plan (K1's: kPSplit needs no more), in fp32 the heads
    block."""
    if S < 1:
        return 0
    if dtype == torch.bfloat16:
        return attn_wgmma_smem(S, _PROJ_HEAD_DIM, smem)
    need = _proj_f32_smem(S)
    return need if need <= smem else 0


def largest_seq(smem_at, dtype: torch.dtype) -> Optional[int]:
    """The largest S at which ``smem_at(S)`` (a launch's shared memory, 0
    where none fits) is non-zero, or None where S has no limit: an unmasked
    bf16 attention plan that fits past one chunk of 256 keys fits at every
    longer S (its ring of slots does not grow with S); fp32 heads blocks
    grow with S."""
    if dtype == torch.bfloat16 and smem_at(257):
        return None
    lo, hi = 0, 256 if dtype == torch.bfloat16 else 1 << 16
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if smem_at(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


def seq_limit_text(limit: Optional[int]) -> str:
    """``largest_seq``'s answer for an error message."""
    return "any S" if limit is None else f"S <= {limit}"


@functools.lru_cache(maxsize=None)
def spatial_proj_max_seq(dtype: torch.dtype, smem: int) -> Optional[int]:
    """The largest S B7 takes in ``dtype`` given ``smem`` bytes of opt-in
    shared memory per block: None in bf16 on an H100 (past 256 keys they
    stream through a ring of K/V slots, so S has no limit), 256 in fp32 (the
    cell's fp32 K, V and score rows)."""
    return largest_seq(lambda S: spatial_proj_smem(S, dtype, smem), dtype)


def spatial_proj_fits(M: int, S: int, D: int, num_heads: int, dtype: torch.dtype,
                      smem: int) -> bool:
    """Whether B7 takes packed qkv (M, S, 3D) in ``dtype``: head_dim 64, D in
    (256, 512, 768, 1024), M and H within the grid, S >= 1 and a launch that
    fits shared memory."""
    return (dtype in _DTYPES and D % num_heads == 0 and D // num_heads == _PROJ_HEAD_DIM
            and D in _WIDTHS and 1 <= M <= _MAX_GRID_YZ and num_heads <= _MAX_GRID_YZ
            and spatial_proj_smem(S, dtype, smem) > 0)


def spatial_max_seq_len(dtype: torch.dtype, device) -> Optional[int]:
    """``spatial_proj_max_seq`` on ``device`` (None: no limit)."""
    return spatial_proj_max_seq(dtype, _build.smem_optin(device))


def spatial_attention_qkv_proj(qkv: torch.Tensor, wproj: torch.Tensor, bproj: torch.Tensor,
                               num_heads: int, *, scale: Optional[float] = None) -> torch.Tensor:
    """``attn(qkv)·wprojᵀ + bproj`` over packed qkv (M, S, 3D) → (M, S, D);
    wproj (D, D) in qkv's dtype, bproj (D,) in bf16 or fp32 (bf16 beside bf16
    qkv goes in as it is). The kernel takes head_dim 64, D in (256, 512,
    768, 1024) and, in fp32, S up to ``spatial_max_seq_len`` (bf16 has no
    limit on S: ``spatial_proj_fits``)."""
    if qkv.dim() != 3:
        raise ValueError(f"expected (M, S, 3D) qkv, got shape {tuple(qkv.shape)}")
    name = "spatial_attention_qkv_proj"
    hd = _proj_operands(name, qkv, wproj, bproj, num_heads)
    scale = hd ** -0.5 if scale is None else float(scale)
    if qkv.device.type == "cpu":
        return spatial_attention_qkv_proj_plain(qkv, wproj, bproj, num_heads, scale)
    M, S, threeD = qkv.shape
    if hd != _PROJ_HEAD_DIM or threeD // 3 not in _WIDTHS:
        raise ValueError(f"{name} kernel needs head_dim {_PROJ_HEAD_DIM} and D in {_WIDTHS}; "
                         f"got head_dim={hd}, D={threeD // 3}")
    smem = _build.smem_optin(qkv.device)
    if not spatial_proj_fits(M, S, threeD // 3, num_heads, qkv.dtype, smem):
        raise ValueError(f"{name} kernel takes M <= {_MAX_GRID_YZ} and "
                         f"{seq_limit_text(spatial_proj_max_seq(qkv.dtype, smem))} for "
                         f"{qkv.dtype} on this device; got S={S}, M={M}")
    (b,), vec_bf16 = _build.layer_vectors(name, qkv, {"b": bproj})
    return _launch_spatial_proj(qkv, wproj, b, vec_bf16, num_heads, scale)


def _launch_spatial_proj(qkv, wproj, b, vec_bf16: int, num_heads: int,
                         scale: float) -> torch.Tensor:
    """One launch of B7 on the checked operands; b as
    ``_build.layer_vectors`` gives it."""
    global spatial_proj_launches
    M, S, threeD = qkv.shape
    bf16 = qkv.dtype == torch.bfloat16
    heads = qkv.new_empty((M, S, threeD // 3))
    out = torch.empty_like(heads)
    q_split = 0 if bf16 else min(max(1, -(-_build.sm_count(qkv.device) // (M * num_heads))),
                                 -(-S // _PROJ_QUERY_TILE))
    dev, stream = _build.stream_args(qkv)
    err = _build.lib().alpro_spatial_qkv_proj(
        qkv.data_ptr(), wproj.data_ptr(), b.data_ptr(), heads.data_ptr(), out.data_ptr(), M, S,
        num_heads, q_split, scale, int(bf16), vec_bf16, dev, stream,
    )
    _build.check(err, "spatial_attention_qkv_proj")
    spatial_proj_launches += 1
    return out


def temporal_proj_fits(B: int, T: int, D: int, num_heads: int, dtype: torch.dtype,
                       smem: int) -> bool:
    """Whether B8 takes packed qkv (B, T, N, 3D) in ``dtype`` given ``smem``
    bytes of opt-in shared memory per block: bf16 the limits of its two
    launches — K2's body (``temporal_fits``: head_dim a multiple of 8 up to
    128, 1 <= T <= 128) and the GEMM (D a multiple of 128); fp32 head_dim
    64, D in (256, 512, 768, 1024), 1 <= T <= 32 and B within the grid."""
    if dtype not in _DTYPES or num_heads < 1 or D % num_heads or B < 1:
        return False
    hd = D // num_heads
    if dtype == torch.bfloat16:
        return temporal_fits(T, hd, dtype, smem) and D % _GEMM_TILE == 0
    return hd == _PROJ_HEAD_DIM and D in _WIDTHS and 1 <= T <= _MAX_T and B <= _MAX_GRID_YZ


def temporal_attention_qkv_proj(qkv: torch.Tensor, w_eff: torch.Tensor, b_eff: torch.Tensor,
                                num_heads: int, *, scale: Optional[float] = None) -> torch.Tensor:
    """``attn_T(qkv)·w_effᵀ + b_eff`` over packed qkv (B, T, N, 3D) → (B, T,
    N, D), attention over T at each (b, n); w_eff (D, D) in qkv's dtype,
    b_eff (D,) in bf16 or fp32 (bf16 beside bf16 qkv goes in as it is). The
    kernel takes the shapes of ``temporal_proj_fits``: in bf16 T up to 128,
    head_dim a multiple of 8 up to 128 and D a multiple of 128; in fp32
    head_dim 64, D in (256, 512, 768, 1024) and T up to 32."""
    name = "temporal_attention_qkv_proj"
    if qkv.dim() != 4:
        raise ValueError(f"expected (B, T, N, 3D) qkv, got shape {tuple(qkv.shape)}")
    hd = _proj_operands(name, qkv, w_eff, b_eff, num_heads)
    scale = hd ** -0.5 if scale is None else float(scale)
    if qkv.device.type == "cpu":
        return temporal_attention_qkv_proj_plain(qkv, w_eff, b_eff, num_heads, scale)
    B, T, N, threeD = qkv.shape
    D = threeD // 3
    if N < 1 or not temporal_proj_fits(B, T, D, num_heads, qkv.dtype,
                                       _build.smem_optin(qkv.device)):
        limit = ("head_dim a multiple of 8 up to 128, 1 <= T <= 128 and D a multiple of 128"
                 if qkv.dtype == torch.bfloat16 else
                 f"head_dim {_PROJ_HEAD_DIM}, D in {_WIDTHS}, 1 <= T <= {_MAX_T} and B <= "
                 f"{_MAX_GRID_YZ}")
        raise ValueError(f"{name} kernel needs, for {qkv.dtype}, {limit}; got B={B}, T={T}, "
                         f"N={N}, D={D}, head_dim={D / num_heads:g}")
    (b,), vec_bf16 = _build.layer_vectors(name, qkv, {"b": b_eff})
    return _launch_temporal_proj(qkv, w_eff, b, vec_bf16, num_heads, scale)


def _launch_temporal_proj(qkv, w_eff, b, vec_bf16: int, num_heads: int, scale: float,
                          heads: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of B8 on the checked operands; b as
    ``_build.layer_vectors`` gives it. bf16: ``heads`` (default: a new one),
    the (B, T, N, D) scratch that the call leaves holding K2's output."""
    global temporal_proj_launches
    B, T, N, threeD = qkv.shape
    bf16 = qkv.dtype == torch.bfloat16
    if bf16 and heads is None:
        heads = qkv.new_empty((B, T, N, threeD // 3))
    out = qkv.new_empty((B, T, N, threeD // 3))
    dev, stream = _build.stream_args(qkv)
    err = _build.lib().alpro_temporal_qkv_proj(
        qkv.data_ptr(), w_eff.data_ptr(), b.data_ptr(), heads.data_ptr() if bf16 else None,
        out.data_ptr(), B, T, N, num_heads, threeD // 3 // num_heads, scale, int(bf16),
        vec_bf16, dev, stream,
    )
    _build.check(err, "temporal_attention_qkv_proj")
    temporal_proj_launches += 1
    return out
