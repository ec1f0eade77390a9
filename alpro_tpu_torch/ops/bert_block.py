"""Fused post-LN BERT layer: the masked attention chain and the MLP chain.

Counterpart of ``alpro_tpu/ops/pallas_bert_block.py``:

* ``bert_attention_block`` ← ``fused_bert_attention_block`` (kernel
  ``csrc/bert_attn.cu``, twin ``bert_attention_block_plain`` =
  ``_bert_attn_xla_reference``):
  ``LN(x + proj(softmax(q kᵀ·hd^-½ + (1-mask)·-10000) v))``;
* ``bert_mlp_block`` ← ``fused_bert_mlp_block`` (the post-LN variant of the
  ``csrc/ln_mlp.cu`` kernel, twin ``bert_mlp_block_plain`` =
  ``_bert_mlp_xla_reference``): ``LN(x + fc2(gelu_erf(fc1(x))) + b2)``.

Weights are in torch Linear layout (out, in), the transposes of the JAX
functions', so the model's ``nn.Linear`` weights go in without a copy. A
wrapper runs the twin only for a CPU tensor; for a CUDA tensor it launches
the kernel or raises. ``attn_launches`` and ``mlp_launches`` count kernel
launches (one per call; the attention chain is two CUDA launches, the bf16
MLP chain three). Neither kernel has a backward (the JAX model runs them
only at serving): a wrapper raises when grad mode is on and an input
requires grad.
"""

from __future__ import annotations

import torch

from alpro_tpu_torch.ops import _build
from alpro_tpu_torch.ops.kernel_math import gelu_exact_f32, ln_rows_f32
from alpro_tpu_torch.ops.ln_mlp import (_F32_WIDTHS, _HIDDEN_CHUNK, _WIDTHS, launch_scratch,
                                        ln_mlp_fits, ptr)

attn_launches = 0
mlp_launches = 0

_DTYPES = (torch.bfloat16, torch.float32)
_HEAD_DIM = 64  # csrc/bert_attn.cu kHD
_QUERY_TILE = 64  # csrc/bert_attn.cu kQT
_CHUNK = 64  # csrc/bert_attn.cu kKC = kRC: projection depth and rows, softmax key chunk
_MAX_GRID_Z = 65535


def _lin_f32(x, w, b) -> torch.Tensor:
    """x·Wᵀ + b on operands rounded to the weights' dtype, fp32 products
    and sums (the upcast products of bf16 values are exact in fp32)."""
    return x.to(w.dtype).float() @ w.float().t() + b.float()


def bert_attention_block_plain(x, attention_mask, wq, bq, wk, bk, wv, bv, wo, bo,
                               ln_s, ln_b, num_heads: int, eps: float) -> torch.Tensor:
    """Plain twin (``_bert_attn_xla_reference``): q, k, v, scores, softmax
    and PV in fp32; the attention output rounds to the weights' dtype before
    the output projection; fp32 residual and LN; output in x.dtype."""
    M, S, D = x.shape
    hd = D // num_heads
    q = _lin_f32(x, wq, bq).reshape(M, S, num_heads, hd) * hd ** -0.5
    k = _lin_f32(x, wk, bk).reshape(M, S, num_heads, hd)
    v = _lin_f32(x, wv, bv).reshape(M, S, num_heads, hd)
    bias = (1.0 - attention_mask.float()) * -10000.0
    s = torch.einsum("mqhd,mkhd->mhqk", q, k) + bias[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("mhqk,mkhd->mqhd", p, v).reshape(M, S, D)
    y = _lin_f32(o, wo, bo) + x.float()
    return ln_rows_f32(y, ln_s, ln_b, eps).to(x.dtype)


def bert_mlp_block_plain(x, w1, b1, w2, b2, ln_s, ln_b, eps: float) -> torch.Tensor:
    """Plain twin (``_bert_mlp_xla_reference``): fc1/fc2 on operands in the
    weights' dtype with fp32 accumulation, exact GELU, fp32 residual and
    LN; output in x.dtype."""
    g = gelu_exact_f32(_lin_f32(x, w1, b1))
    y = _lin_f32(g, w2, b2) + x.float()
    return ln_rows_f32(y, ln_s, ln_b, eps).to(x.dtype)


def _f32_vectors(name: str, **vecs) -> list:
    out = []
    for key, v in vecs.items():
        v = v.float().contiguous()
        _build.check_cuda_operand(v, f"{name} {key}", (torch.float32,), align=4)
        out.append(v)
    return out


def max_seq(dtype: torch.dtype, smem: int) -> int:
    """The largest S the attention kernel takes for ``dtype`` given ``smem``
    bytes of opt-in shared memory per block (``csrc/bert_attn.cu`` max_seq:
    K and V of one head for the whole sequence beside a fixed query tile and
    staging area; 752 in bf16 on an H100)."""
    es = dtype.itemsize
    pad = 16 // es
    ldc, ld_sc = _CHUNK + pad, _CHUNK + 4
    staging = (_CHUNK + 2 * _HEAD_DIM) * ldc * es
    warp_bufs = 4 * (16 * ld_sc * 4 + 16 * ldc * es)
    room = smem - (_QUERY_TILE * (_HEAD_DIM + pad) * es + max(staging, warp_bufs))
    return max(room, 0) // (2 * _HEAD_DIM * es) // 16 * 16


def max_seq_len(dtype: torch.dtype, device) -> int:
    """``max_seq`` on ``device``."""
    return max_seq(dtype, _build.smem_optin(device))


def attention_fits(M: int, S: int, D: int, num_heads: int, dtype: torch.dtype,
                   smem: int) -> bool:
    """Whether K4 takes (M, S, D) rows in ``dtype``."""
    return (dtype in _DTYPES and D % num_heads == 0 and D // num_heads == _HEAD_DIM
            and D in _WIDTHS and 1 <= M <= _MAX_GRID_Z and 1 <= S <= max_seq(dtype, smem))


def bert_attention_block(x: torch.Tensor, attention_mask: torch.Tensor,
                         wq, bq, wk, bk, wv, bv, wo, bo, ln_s, ln_b,
                         num_heads: int, *, eps: float) -> torch.Tensor:
    """``LN(x + proj(masked_attn(q(x), k(x), v(x))))``. x: (M, S, D);
    attention_mask: (M, S), 1 = valid key; w*: (D, D) in torch layout; b*,
    ln_*: (D,). The kernel takes x and the weights contiguous in one dtype
    (bf16 or fp32), head_dim 64, D in (256, 512, 768, 1024), and S up to
    ``max_seq_len`` (752 in bf16 on an H100); it raises on anything else."""
    global attn_launches
    if x.dim() != 3:
        raise ValueError(f"expected (M, S, D) x, got shape {tuple(x.shape)}")
    M, S, D = x.shape
    if D % num_heads:
        raise ValueError(f"D={D} is not a multiple of num_heads={num_heads}")
    for name, w in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)):
        if tuple(w.shape) != (D, D):
            raise ValueError(f"{name}: shape {tuple(w.shape)} != {(D, D)}")
    if tuple(attention_mask.shape) != (M, S):
        raise ValueError(f"attention_mask: shape {tuple(attention_mask.shape)} != {(M, S)}")
    _build.refuse_grad("bert_attention_block", x, wq, bq, wk, bk, wv, bv, wo, bo, ln_s, ln_b)
    if x.device.type == "cpu":
        return bert_attention_block_plain(x, attention_mask, wq, bq, wk, bk, wv, bv, wo, bo,
                                          ln_s, ln_b, num_heads, eps)
    _build.check_cuda_operand(x, "bert_attention_block x", _DTYPES)
    for name, w in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)):
        _build.check_cuda_operand(w, f"bert_attention_block {name}", (x.dtype,))
    hd = D // num_heads
    smem = _build.smem_optin(x.device)
    if not attention_fits(M, S, D, num_heads, x.dtype, smem):
        raise ValueError(
            f"bert_attn kernel needs head_dim {_HEAD_DIM}, D in {_WIDTHS}, M <= {_MAX_GRID_Z} "
            f"and S <= {max_seq(x.dtype, smem)} for {x.dtype} on this device (K and V of a "
            f"head in shared memory); got head_dim={hd}, D={D}, M={M}, S={S}"
        )
    mask = attention_mask.to(torch.float32).contiguous()
    _build.check_cuda_operand(mask, "bert_attention_block mask", (torch.float32,), align=4)
    vq, vk, vv, vo, vs, vb = _f32_vectors(
        "bert_attention_block", bq=bq, bk=bk, bv=bv, bo=bo, ln_s=ln_s, ln_b=ln_b)
    heads = torch.empty_like(x)
    out = torch.empty_like(x)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    q_split = max(1, -(-sms // (M * num_heads)))
    dev, stream = _build.stream_args(x)
    err = _build.lib().alpro_bert_attn(
        x.data_ptr(), mask.data_ptr(), wq.data_ptr(), vq.data_ptr(), wk.data_ptr(),
        vk.data_ptr(), wv.data_ptr(), vv.data_ptr(), wo.data_ptr(), vo.data_ptr(),
        vs.data_ptr(), vb.data_ptr(), heads.data_ptr(), out.data_ptr(), M, S, num_heads,
        min(q_split, -(-S // _QUERY_TILE)), float(hd ** -0.5), float(eps),
        int(x.dtype == torch.bfloat16), dev, stream,
    )
    _build.check(err, "bert_attention_block")
    attn_launches += 1
    return out


def bert_mlp_block(x: torch.Tensor, w1, b1, w2, b2, ln_s, ln_b, *,
                   eps: float) -> torch.Tensor:
    """``LN(x + fc2(gelu_exact(fc1(x))))`` over the rows of x (..., D). w1:
    (Dh, D), w2: (D, Dh). The kernel takes x, w1, w2 contiguous in one dtype
    (bf16 or fp32), D in (256, 512, 768, 1024) (fp32: up to 768) and Dh %
    128 == 0, and raises on anything else. In bf16 it runs fc1 + GELU, fc2
    into fp32 partials and the row LN as three launches
    (``ln_mlp.bf16_plan``)."""
    global mlp_launches
    D = x.shape[-1]
    Dh = w1.shape[0]
    if (tuple(w1.shape) != (Dh, D) or tuple(w2.shape) != (D, Dh)
            or b1.shape != (Dh,) or b2.shape != (D,)
            or ln_s.shape != (D,) or ln_b.shape != (D,)):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
            f"w2 {tuple(w2.shape)}, b1 {tuple(b1.shape)}, b2 {tuple(b2.shape)}"
        )
    _build.refuse_grad("bert_mlp_block", x, w1, b1, w2, b2, ln_s, ln_b)
    if x.device.type == "cpu":
        return bert_mlp_block_plain(x, w1, b1, w2, b2, ln_s, ln_b, eps)
    _build.check_cuda_operand(x, "bert_mlp_block x", _DTYPES)
    for name, w in (("w1", w1), ("w2", w2)):
        _build.check_cuda_operand(w, f"bert_mlp_block {name}", (x.dtype,))
    R = x.numel() // D
    if not ln_mlp_fits(D, Dh, x.dtype) or R < 1:
        raise ValueError(
            f"bert_mlp kernel needs D in {_WIDTHS} ({_F32_WIDTHS} in fp32) and Dh % "
            f"{_HIDDEN_CHUNK} == 0; got R={R}, D={D}, Dh={Dh}, {x.dtype}"
        )
    v1, v2, vs, vb = _f32_vectors("bert_mlp_block", b1=b1, b2=b2, ln_s=ln_s, ln_b=ln_b)
    out = torch.empty_like(x)
    h_split, partial, hidden, _ = launch_scratch(x, R, D, Dh, post_ln=True)
    dev, stream = _build.stream_args(x)
    err = _build.lib().alpro_bert_mlp(
        x.data_ptr(), w1.data_ptr(), v1.data_ptr(), w2.data_ptr(), v2.data_ptr(),
        vs.data_ptr(), vb.data_ptr(), out.data_ptr(), ptr(partial), ptr(hidden), R, D, Dh,
        h_split, float(eps), int(x.dtype == torch.bfloat16), dev, stream,
    )
    _build.check(err, "bert_mlp_block")
    mlp_launches += 1
    return out
