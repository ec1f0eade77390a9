"""Masked multi-head attention: one CUDA kernel for two layouts, with its
plain twin and its gradient.

Counterpart of ``alpro_tpu/ops/pallas_attn.py``:

* ``fused_attention_bshd`` ← ``fused_attention_bshd`` (``_attn_kernel_heads``):
  q (B, Sq, H·hd), k/v (B, Sk, H·hd), each head a window of hd channels;
* ``fused_attention`` ← ``fused_attention`` (``_attn_kernel``): q (B, H, Sq,
  hd), k/v (B, H, Sk, hd).

Both launch ``csrc/masked_attn.cu``, which reads q, k and v in place through
their strides (the channel axis contiguous), so views of a packed qkv
projection go in without a copy. In bf16 it is K1's Hopper body
(``csrc/attn_wgmma.cuh``: TMA and ``wgmma``, the score rows and the key bias
in registers), reaching each operand through a 4-D tensor map whose
geometry ``map_geometry`` computes here; its plan's shared memory
(``smem_bytes``) bounds only the bias row. fp32 keeps a CUDA-core body whose
K and V of one head bound Sk. The twin ``attention_plain`` copies the
TPU kernel's contract step by step: q·kᵀ on the operands upcast to fp32, times
the scale, plus the fp32 bias ``(1-mask)·-10000``; fp32 row max and exp; the
unnormalised p rounded to v's dtype for P·V in fp32; division by the fp32 row
sum last; output in q's dtype.

The kernel takes the key mask and computes the bias ``(1-mask)·-10000`` as
``key_bias`` does, so a call launches nothing else. The gradient is
``_fused_attention_bwd`` / ``_fab_bwd``: a plain fp32 recompute of p, then
dv, dp, ds, dq and dk, each cast to its input's dtype (the JAX package's
custom_vjp backward is XLA einsums, not a kernel), on either device: a
call under grad is the ``torch.library`` custom op
``alpro_tpu_torch::masked_attention`` (an op that the checkpointing policies
of ``models/remat.py`` see). The key mask takes no gradient; where no input
needs one, the call skips the custom op.

A wrapper runs the twin only for CPU tensors; for CUDA tensors it launches
the kernel or raises. ``bshd_launches`` and ``bhsd_launches`` count kernel
launches, one per launch: a recompute under gradient checkpointing launches
again, except under the names family of ``models/remat.py``, which keeps
the output of a launch on a tagged route and launches nothing there.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from alpro_tpu_torch.models.remat import keep_output
from alpro_tpu_torch.ops import _build
from alpro_tpu_torch.ops.qkv_attn import attn_wgmma_smem

bshd_launches = 0
bhsd_launches = 0

_DTYPES = (torch.bfloat16, torch.float32)
_HEAD_DIMS = (32, 64, 128)  # csrc/masked_attn.cu instantiations
_MAX_GRID_YZ = 65535
_MAX_KEYS = 1 << 24  # the search bound of max_keys


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


def smem_bytes(Sk: int, hd: int, dtype: torch.dtype, smem: int) -> int:
    """Dynamic shared memory of a launch at Sk keys and head_dim ``hd``
    (``csrc/masked_attn.cu`` ``alpro_masked_attn_smem``) on a device with
    ``smem`` bytes of opt-in shared memory per block, or 0 where none fits.
    bf16: the attention body's plan with the key-bias row
    (``qkv_attn.attn_wgmma_smem``); fp32: the smallest launch (one warp),
    K and V of the head and the bias row, padded to 16 keys, and one warp's
    Q tile, score and p chunks."""
    if Sk < 1 or hd not in _HEAD_DIMS:
        return 0
    if dtype == torch.bfloat16:
        return attn_wgmma_smem(Sk, hd, smem, bias=True)
    skp = -(-Sk // 16) * 16
    need = 4 * (2 * skp * hd + 16 * hd + skp + 16 * (max(64, hd) + 4) + 16 * 72)
    return need if need <= smem else 0


def max_keys(dtype: torch.dtype, head_dim: int, smem: int) -> int:
    """The largest Sk for which ``smem_bytes`` fits ``smem`` (0 if none)."""
    lo, hi = 0, _MAX_KEYS
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if smem_bytes(mid, head_dim, dtype, smem):
            lo = mid
        else:
            hi = mid - 1
    return lo


def max_seq_len(dtype: torch.dtype, head_dim: int, device) -> int:
    """The largest Sk the kernel takes for ``dtype`` and ``head_dim`` on
    ``device``: in bf16 the plan's limit (the key-bias row in shared memory;
    K and V stream past what fits), in fp32 K and V of one head in shared
    memory."""
    return max_keys(dtype, head_dim, _build.smem_optin(device))


def map_geometry(t: torch.Tensor, num_heads: Optional[int] = None,
                 name: str = "operand") -> tuple:
    """The 4-D tensor map through which the kernel reads an operand
    (``csrc/attn_wgmma.cuh`` ``encode_operand``; the fp32 body takes the same
    strides): a (B, H, S, hd) view, or with ``num_heads`` a (B, S, H·hd) one,
    gives ``(dims, strides)``, dims (hd, S, H, B) and the byte strides of the
    S, H and B axes. head_dim must be contiguous and the data pointer and
    every stride 16-byte aligned, as TMA demands. An axis of extent 1 is never
    stepped, so its stride is replaced by the view's byte span rounded up to
    16 (any stride its view may carry, 0 included, then encodes)."""
    if num_heads is None:
        B, H, S, hd = t.shape
        sb, sh, ss, sd = t.stride()
    else:
        (B, S, D), H = t.shape, num_heads
        hd = D // H
        sb, ss, sd = t.stride()
        sh = hd * sd
    es = t.element_size()
    strides = (ss * es, sh * es, sb * es)
    if 1 in (S, H, B):
        span = es * (1 + (B - 1) * abs(sb) + (H - 1) * abs(sh) + (S - 1) * abs(ss)
                     + (hd - 1) * abs(sd))
        span = -(-span // 16) * 16
        strides = tuple(st if n > 1 else span for st, n in zip(strides, (S, H, B)))
    if sd != 1 or t.data_ptr() % 16 or any(st % 16 or st <= 0 for st in strides):
        raise ValueError(
            f"masked_attn {name}: head_dim must be contiguous and every row 16-byte aligned; got "
            f"strides {t.stride()} of {es}-byte elements, data pointer {t.data_ptr() % 16} "
            f"mod 16"
        )
    return (hd, S, H, B), strides


def _check_operand(t: torch.Tensor, name: str, dtype, num_heads: Optional[int]) -> tuple:
    """An operand the kernel can read in place: its ``map_geometry``."""
    if t.device.type != "cuda":
        raise ValueError(f"masked_attn {name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"masked_attn {name}: dtype {t.dtype}, expected {dtype} (one of {_DTYPES})")
    return map_geometry(t, num_heads, name)


def _launch(q, k, v, mask, out, scale: float, num_heads: Optional[int]) -> None:
    """q, k, v, out: CUDA tensors, (B, S, H·hd) given ``num_heads``, else (B,
    H, S, hd); mask: the (B, Sk) fp32 key mask on q's device, or None."""
    if q.dtype not in _DTYPES:
        raise ValueError(f"masked_attn: dtype {q.dtype} not in {_DTYPES}")
    geo = [_check_operand(t, name, q.dtype, num_heads)
           for name, t in (("q", q), ("k", k), ("v", v), ("out", out))]
    (hd, Sq, H, B), Sk = geo[0][0], geo[1][0][1]
    if hd not in _HEAD_DIMS or B > _MAX_GRID_YZ or H > _MAX_GRID_YZ or Sq < 1 or Sk < 1:
        raise ValueError(
            f"masked_attn kernel needs head_dim in {_HEAD_DIMS}, B and H <= {_MAX_GRID_YZ} "
            f"and Sq, Sk >= 1; got head_dim={hd}, B={B}, H={H}, Sq={Sq}, Sk={Sk}"
        )
    if not smem_bytes(Sk, hd, q.dtype, _build.smem_optin(q.device)):
        raise ValueError(
            f"masked_attn kernel takes Sk <= {max_seq_len(q.dtype, hd, q.device)} for "
            f"{q.dtype} at head_dim {hd} on this device; got Sk={Sk}"
        )
    strides = (ctypes.c_longlong * 12)(*(st for _, sts in geo for st in sts))
    dev, stream = _build.stream_args(q)
    err = _build.lib().alpro_masked_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), ctypes.addressof(strides), B, H, Sq, Sk, hd, float(scale),
        int(q.dtype == torch.bfloat16), dev, stream,
    )
    _build.check(err, "masked_attn")


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, H·hd) → (B, H, S, hd) view."""
    return x.unflatten(-1, (num_heads, x.shape[-1] // num_heads)).transpose(1, 2)


def _forward(q, k, v, mask, scale: float, num_heads: Optional[int]) -> torch.Tensor:
    """num_heads given: the (B, S, H·hd) layout; None: (B, H, S, hd). mask:
    the (B, Sk) fp32 key mask or None."""
    global bshd_launches, bhsd_launches
    bshd = num_heads is not None
    if q.device.type == "cpu":
        qh, kh, vh = (_heads(t, num_heads) for t in (q, k, v)) if bshd else (q, k, v)
        o = attention_plain(qh, kh, vh, key_bias(mask, kh.shape[0], kh.shape[2], q.device), scale)
        return o.transpose(1, 2).flatten(2) if bshd else o
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, mask, out, scale, num_heads)
    if bshd:
        bshd_launches += 1
    else:
        bhsd_launches += 1
    return out


@torch.library.custom_op("alpro_tpu_torch::masked_attention", mutates_args=())
def _masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: Optional[torch.Tensor], scale: float,
                      num_heads: Optional[int]) -> torch.Tensor:
    return keep_output(lambda: _forward(q, k, v, mask, scale, num_heads), q.device)


def _masked_attention_setup(ctx, inputs, output):
    q, k, v, mask, scale, num_heads = inputs
    ctx.save_for_backward(q, k, v, mask)
    ctx.scale, ctx.num_heads = scale, num_heads


def _masked_attention_backward(ctx, g):
    q, k, v, mask = ctx.saved_tensors
    H = ctx.num_heads
    if H is not None:
        q, k, v, g = (_heads(t, H) for t in (q, k, v, g))
    bias = key_bias(mask, k.shape[0], k.shape[2], k.device)
    grads = attention_grads(q, k, v, bias, g, ctx.scale)
    if H is not None:
        grads = (d.transpose(1, 2).flatten(2) for d in grads)
    return (*grads, None, None, None)


_masked_attention.register_autograd(_masked_attention_backward,
                                    setup_context=_masked_attention_setup)


def _attend(q, k, v, key_mask, scale: float, num_heads: Optional[int]) -> torch.Tensor:
    """The forward, through the custom op only where a gradient is wanted
    (its bookkeeping is a good share of a call's host time)."""
    mask = None if key_mask is None else \
        key_mask.to(device=q.device, dtype=torch.float32).contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return torch.ops.alpro_tpu_torch.masked_attention(q, k, v, mask, scale, num_heads)
    return _forward(q, k, v, mask, scale, num_heads)


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
    return _attend(q, k, v, key_mask, float(scale), None)


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
    return _attend(q, k, v, key_mask, float(scale), int(num_heads))
