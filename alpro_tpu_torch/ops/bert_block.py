"""Fused post-LN BERT layer: the masked attention chain and the MLP chain.

Counterpart of ``alpro_tpu/ops/pallas_bert_block.py``:

* ``bert_attention_block`` ← ``fused_bert_attention_block`` (kernel
  ``csrc/bert_attn.cu``, twin ``bert_attention_block_plain`` =
  ``_bert_attn_xla_reference``, and ``bert_attention_block_reference``, the
  TPU kernel's own rounding points in plain torch):
  ``LN(x + proj(softmax(q kᵀ·hd^-½ + (1-mask)·-10000) v))``;
* ``bert_mlp_block`` ← ``fused_bert_mlp_block`` (the post-LN variant of the
  ``csrc/ln_mlp.cu`` kernel, twin ``bert_mlp_block_plain`` =
  ``_bert_mlp_xla_reference``): ``LN(x + fc2(gelu_erf(fc1(x))) + b2)``.

Weights are in torch Linear layout (out, in), the transposes of the JAX
functions', so the model's ``nn.Linear`` weights go in without a copy. A
wrapper runs the twin only for a CPU tensor; for a CUDA tensor it launches
the kernel or raises. ``attn_launches`` and ``mlp_launches`` count kernel
launches (one per call). In bf16 the attention chain is four CUDA launches
behind one C call (the source gives the design): the packed q/k/v GEMM into
an (M·S, 3D) scratch, the masked attention on views of it into an (M·S, D)
heads scratch, the output projection into fp32 partials (``proj_plan``), and
the post-LN finalize; fp32 is two. The bf16 MLP chain is three. Neither
kernel has a backward (the JAX model runs them only at serving): a wrapper
raises when grad mode is on and an input requires grad.
"""

from __future__ import annotations

import functools

import torch

from alpro_tpu_torch.ops import _build, masked_attn
from alpro_tpu_torch.ops.kernel_math import gelu_exact_f32, ln_rows_f32
from alpro_tpu_torch.ops.ln_mlp import (_F32_WIDTHS, _HIDDEN_CHUNK, _WIDTHS, bf16_plan,
                                        launch_scratch, ln_mlp_fits, ptr)

attn_launches = 0
mlp_launches = 0

_DTYPES = (torch.bfloat16, torch.float32)
_HEAD_DIM = 64  # csrc/bert_attn.cu kHD
_QUERY_TILE = 64  # csrc/bert_attn.cu kQT (fp32)
_CHUNK = 64  # csrc/bert_attn.cu kKC = kRC (fp32): projection depth and rows, key chunk
_MAX_GRID_Z = 65535
_VECTORS = ("bq", "bk", "bv", "bo", "ln_s", "ln_b")


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


def bert_attention_block_reference(x, attention_mask, wq, bq, wk, bk, wv, bv, wo, bo,
                                   ln_s, ln_b, num_heads: int, eps: float) -> torch.Tensor:
    """The TPU kernel's contract (``_bert_attn_kernel`` of
    ``alpro_tpu/ops/pallas_bert_block.py``) in plain torch: q, k and v =
    x·Wᵀ on operands in the weights' dtype with fp32 accumulation, plus the
    fp32 bias, then rounded to that dtype; s = q·kᵀ in fp32, times hd^-½,
    plus ``(1-mask)·-10000`` in fp32; p = exp(s - max) with the exact fp32
    row max, l the fp32 sum of the unrounded p; p rounded to the dtype for
    P·V in fp32, the division by l after; o rounded to the dtype; o·Woᵀ
    summed in fp32, plus bo and the fp32 residual x, the fp32 LN, one
    rounding into x's dtype. The twin ``bert_attention_block_plain`` keeps
    q, k and v in fp32 instead, so at large scores only this function pins
    the kernel's rounding points. Only tests and ``chip_smoke.py`` call
    it."""
    M, S, D = x.shape
    hd, dt = D // num_heads, wq.dtype
    q, k, v = (_lin_f32(x, w, b).to(dt).float().reshape(M, S, num_heads, hd)
               for w, b in ((wq, bq), (wk, bk), (wv, bv)))
    bias = ((1.0 - attention_mask.float()) * -10000.0)[:, None, None, :]
    s = torch.einsum("mqhd,mkhd->mhqk", q, k) * hd ** -0.5 + bias
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("mhqk,mkhd->mqhd", p.to(dt).float(), v)
    o = (o / p.sum(dim=-1).transpose(1, 2)[..., None]).to(dt).reshape(M, S, D)
    y = _lin_f32(o, wo, bo) + x.float()
    return ln_rows_f32(y, ln_s, ln_b, eps).to(x.dtype)


def bert_mlp_block_plain(x, w1, b1, w2, b2, ln_s, ln_b, eps: float) -> torch.Tensor:
    """Plain twin (``_bert_mlp_xla_reference``): fc1/fc2 on operands in the
    weights' dtype with fp32 accumulation, exact GELU, fp32 residual and
    LN; output in x.dtype."""
    g = gelu_exact_f32(_lin_f32(x, w1, b1))
    y = _lin_f32(g, w2, b2) + x.float()
    return ln_rows_f32(y, ln_s, ln_b, eps).to(x.dtype)


def _f32_max_seq(smem: int) -> int:
    """The fp32 body's largest S (``csrc/bert_attn.cu`` max_seq<float>): K
    and V of one head for the whole sequence beside a fixed query tile and
    staging area (304 on an H100)."""
    es, pad = 4, 4
    ldc, ld_sc = _CHUNK + pad, _CHUNK + 4
    staging = (_CHUNK + 2 * _HEAD_DIM) * ldc * es
    warp_bufs = 4 * (16 * ld_sc * 4 + 16 * ldc * es)
    room = smem - (_QUERY_TILE * (_HEAD_DIM + pad) * es + max(staging, warp_bufs))
    return max(room, 0) // (2 * _HEAD_DIM * es) // 16 * 16


@functools.lru_cache(maxsize=None)
def max_seq(dtype: torch.dtype, smem: int) -> int:
    """The largest S the kernel takes for ``dtype`` given ``smem`` bytes of
    opt-in shared memory per block (``alpro_bert_attn_max_seq``): in bf16
    the masked attention's plan with its key-bias row
    (``masked_attn.max_keys``; K and V stream past what fits: 20 480 on an
    H100), in fp32 K and V of one head for the whole sequence in shared
    memory (304)."""
    if dtype == torch.bfloat16:
        return masked_attn.max_keys(dtype, _HEAD_DIM, smem)
    return _f32_max_seq(smem)


def max_seq_len(dtype: torch.dtype, device) -> int:
    """``max_seq`` on ``device``."""
    return max_seq(dtype, _build.smem_optin(device))


def attention_fits(M: int, S: int, D: int, num_heads: int, dtype: torch.dtype,
                   smem: int) -> bool:
    """Whether K4 takes (M, S, D) rows in ``dtype``: head_dim 64, D in
    ``_WIDTHS`` (multiples of the GEMM's 128-column tiles, at most the
    finalize's 1024), M within the grid and S up to ``max_seq``."""
    return (dtype in _DTYPES and D % num_heads == 0 and D // num_heads == _HEAD_DIM
            and D in _WIDTHS and 1 <= M <= _MAX_GRID_Z and 1 <= S <= max_seq(dtype, smem))


def proj_plan(R: int, D: int, num_sms: int) -> tuple:
    """(k_split, splits) of the bf16 output projection over R rows: its
    ceil(R / 128) · D / 128 tiles; where they leave CTA slots free, the
    heads (its K axis, D columns) are cut into equal 64-column slices, as
    many as one wave of slots takes — ``ln_mlp.bf16_plan``'s rule with D in
    the place of the hidden width. Each slice writes an fp32 partial."""
    plan = bf16_plan(R, D, D, num_sms, post_ln=True)
    return plan.h_split, plan.splits


def qkv_geometry(M: int, S: int, D: int, num_heads: int) -> list:
    """How the bf16 attention reads q, k and v from the packed (M·S, 3D)
    scratch (``csrc/bert_attn.cu`` packed_operand): per operand (byte
    offset, dims (hd, S, H, M), byte strides of the S, H and M axes), an
    axis of extent 1 given the view's byte span rounded up to 16 — what
    ``masked_attn.map_geometry`` gives for the views
    ``scratch.view(M, S, 3D)[..., i·D:(i+1)·D]``."""
    hd, es = D // num_heads, 2
    ss, sh, sb = 3 * D, hd, 3 * D * S  # elements
    span = -(-es * (1 + (M - 1) * sb + (num_heads - 1) * sh + (S - 1) * ss + hd - 1) // 16) * 16
    strides = tuple(es * st if n > 1 else span for st, n in ((ss, S), (sh, num_heads), (sb, M)))
    return [(es * i * D, (hd, S, num_heads, M), strides) for i in range(3)]


def _vectors(x: torch.Tensor, vecs: tuple) -> tuple:
    """(vectors, vec_bf16) for the launch: in bf16 the layer's six bias and
    LN vectors as they are where all are bf16 (the kernels widen them on
    load), else each in fp32 (exact); fp32 kernels take fp32."""
    return _build.layer_vectors("bert_attention_block", x, dict(zip(_VECTORS, vecs)))


def bert_attention_block(x: torch.Tensor, attention_mask: torch.Tensor,
                         wq, bq, wk, bk, wv, bv, wo, bo, ln_s, ln_b,
                         num_heads: int, *, eps: float) -> torch.Tensor:
    """``LN(x + proj(masked_attn(q(x), k(x), v(x))))``. x: (M, S, D);
    attention_mask: (M, S), 1 = valid key; w*: (D, D) in torch layout; b*,
    ln_*: (D,), bf16 or fp32 (the kernel reads them as given where all six
    are bf16 and x is, else in fp32). The kernel takes x and the weights
    contiguous in one dtype (bf16 or fp32), head_dim 64, D in (256, 512,
    768, 1024), and S up to ``max_seq_len`` (20 480 in bf16 on an H100, 304
    in fp32); it raises on anything else."""
    global attn_launches
    if x.dim() != 3:
        raise ValueError(f"expected (M, S, D) x, got shape {tuple(x.shape)}")
    M, S, D = x.shape
    if D % num_heads:
        raise ValueError(f"D={D} is not a multiple of num_heads={num_heads}")
    for name, w in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)):
        if tuple(w.shape) != (D, D):
            raise ValueError(f"{name}: shape {tuple(w.shape)} != {(D, D)}")
    for name, v in zip(_VECTORS, (bq, bk, bv, bo, ln_s, ln_b)):
        if tuple(v.shape) != (D,):
            raise ValueError(f"{name}: shape {tuple(v.shape)} != {(D,)}")
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
            f"and S <= {max_seq(x.dtype, smem)} for {x.dtype} on this device; got "
            f"head_dim={hd}, D={D}, M={M}, S={S}"
        )
    mask = attention_mask.to(torch.float32).contiguous()
    _build.check_cuda_operand(mask, "bert_attention_block mask", (torch.float32,), align=4)
    vecs, vec_bf16 = _vectors(x, (bq, bk, bv, bo, ln_s, ln_b))
    out = torch.empty_like(x)
    R, sms = M * S, _build.sm_count(x.device)
    qkv = partial = None
    q_split = k_split = 0
    if x.dtype == torch.bfloat16:
        k_split, splits = proj_plan(R, D, sms)
        qkv = torch.empty((R, 3 * D), dtype=x.dtype, device=x.device)
        heads = torch.empty((R, D), dtype=x.dtype, device=x.device)
        partial = torch.empty((splits, R, D), dtype=torch.float32, device=x.device)
    else:
        heads = torch.empty_like(x)
        q_split = min(max(1, -(-sms // (M * num_heads))), -(-S // _QUERY_TILE))
    dev, stream = _build.stream_args(x)
    err = _build.lib().alpro_bert_attn(
        x.data_ptr(), mask.data_ptr(), wq.data_ptr(), vecs[0].data_ptr(), wk.data_ptr(),
        vecs[1].data_ptr(), wv.data_ptr(), vecs[2].data_ptr(), wo.data_ptr(), vecs[3].data_ptr(),
        vecs[4].data_ptr(), vecs[5].data_ptr(), ptr(qkv), heads.data_ptr(), ptr(partial),
        out.data_ptr(), M, S, num_heads, q_split, k_split, float(hd ** -0.5), float(eps),
        int(x.dtype == torch.bfloat16), vec_bf16, dev, stream,
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
    v1, v2, vs, vb = _build.f32_vectors("bert_mlp_block",
                                        dict(b1=b1, b2=b2, ln_s=ln_s, ln_b=ln_b))
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
