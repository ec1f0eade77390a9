"""B9's and B7's host-side plan (``alpro_tpu_torch.ops.fused_block`` and
``ops.qkv_attn``), on the CPU, and the arithmetic their bf16 routes rest on.

In bf16, B9 (``fused_spatial_block``) is four launches behind one C call
(``csrc/fused_block.cu``): the LN rows, the TMA/``wgmma`` GEMM into six
(M·S, D) scratch tensors (q, k and v as bf16 pairs hi + lo), the attention
body under kSplit and kPSplit, and the projection GEMM; B7
(``spatial_attention_qkv_proj``, ``csrc/qkv_proj.cu``) is the attention body
under kPSplit on the packed input, then the projection GEMM. Here: the
attention's shared-memory plan (a K slot of k_hi, v_hi, v_lo and k_lo for
B9, K1's plan for B7), the limits and ``fits`` at S = 197, 257 and 577 and
one past a limit, the scratch, and, with the launch replaced by a recorder
and a CUDA stand-in for the tensors, that the wrappers hand the layer's bf16
vectors over without a cast. The shared memory is an H100's: 232,448 bytes
a block may opt in to. ``csrc`` reports the same bytes on the card
(tests/test_torch_cuda_kernels.py).

Then the design's arithmetic against the TPU kernel: a plain emulation of
the bf16 route — q, k, v and p each as hi = bf16(y), lo = bf16(y - hi), the
three-term products q_hi·k_hiᵀ + q_hi·k_loᵀ + q_lo·k_hiᵀ and p_hi·v_hi +
p_hi·v_lo + p_lo·v_hi in fp32 — against the JAX kernel
(``alpro_tpu.ops.pallas_fused_block.fused_spatial_block``) in interpret mode
in fp32, where rounding q, k, v and p to bf16 instead misses it by more than
ten times the stated tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpro_tpu.ops.pallas_fused_block import fused_spatial_block as jax_spatial_block
from alpro_tpu_torch.ops import _build, fused_block, qkv_attn
from alpro_tpu_torch.ops.kernel_math import ln_rows_f32

H100_SMEM = 232_448
BF16, F32 = torch.bfloat16, torch.float32
FIXED = 2048 + 2 * 64 * 64 * 2 + 1024  # barriers and slack, the query buffer, the CLS block


@pytest.mark.parametrize("S,smem", [(150, FIXED + 32 * 128 + 4 * 160 * 128),
                                    (197, FIXED + 48 * 128 + 4 * 208 * 128),
                                    (256, FIXED + 4 * 256 * 128),
                                    (257, FIXED + 3 * 4 * 128 * 128),
                                    (577, FIXED + 3 * 4 * 128 * 128)])
def test_spatial_block_plan_bytes(S, smem):
    """B9's attention plan: one chunk's keys rounded to 16 rows with the
    rest of the last 64-key block as a pad (kSplit's over-read), a K slot of
    four panels (k_hi, v_hi, v_lo, k_lo); past 256 keys chunks of 128 keys,
    three 64 KB slots (S = 257 all of them resident, S = 577 a ring). At the
    ViT's 197 keys 132,096 bytes: one CTA an SM (B17's three panels kept
    two)."""
    assert fused_block.spatial_smem(S, BF16, H100_SMEM) == smem
    assert qkv_attn.attn_wgmma_smem(S, 64, H100_SMEM, split=True, vlo=True) == smem
    if S == 197:
        assert 2 * (smem + 1024) > 228 * 1024 >= smem + 1024


@pytest.mark.parametrize("S,smem", [(197, 84992), (257, FIXED + 2 * 2 * 256 * 128),
                                    (577, FIXED + 3 * 2 * 256 * 128)])
def test_spatial_proj_plan_is_k1s(S, smem):
    """B7 takes K1's plan (kPSplit keeps p_lo in registers, no shared
    memory): two query tiles, K and V slots of 256 keys, a ring past three."""
    assert qkv_attn.spatial_proj_smem(S, BF16, H100_SMEM) == smem
    assert qkv_attn.spatial_proj_smem(S, BF16, H100_SMEM) == qkv_attn.spatial_smem_bytes(
        S, 64, BF16, H100_SMEM)


def test_limits():
    """In bf16 neither kernel has an S limit on an H100 (past 256 keys the
    keys stream through the slot ring); fp32 keeps 256 (the cell's fp32 K, V
    and score rows). On a card with 100,000 bytes a block, the bf16 plans end
    at 144 (B9's four panels) and 256 keys (B7)."""
    for mod_max in (fused_block.spatial_max_seq, qkv_attn.spatial_proj_max_seq):
        assert mod_max(BF16, H100_SMEM) is None
        assert mod_max(F32, H100_SMEM) == 256
    assert fused_block.spatial_max_seq(BF16, 100_000) == 144
    assert qkv_attn.spatial_proj_max_seq(BF16, 100_000) == 256


@pytest.mark.parametrize("fits,M,S,D,H,dtype,smem", [
    (True, 64, 197, 768, 12, BF16, H100_SMEM), (True, 32, 197, 768, 12, BF16, H100_SMEM),
    (True, 8, 257, 768, 12, BF16, H100_SMEM), (True, 8, 577, 768, 12, BF16, H100_SMEM),
    (True, 1, 20481, 1024, 16, BF16, H100_SMEM), (True, 2, 1, 256, 4, BF16, H100_SMEM),
    (True, 4, 256, 768, 12, F32, H100_SMEM), (False, 4, 257, 768, 12, F32, H100_SMEM),
    (True, 2, 144, 768, 12, BF16, 100_000), (False, 2, 145, 768, 12, BF16, 100_000),
    (False, 65536, 197, 768, 12, BF16, H100_SMEM), (False, 2, 0, 768, 12, BF16, H100_SMEM),
    (False, 2, 197, 768, 24, BF16, H100_SMEM), (False, 2, 197, 384, 6, BF16, H100_SMEM)])
def test_spatial_block_fits(fits, M, S, D, H, dtype, smem):
    """S 197 (the ViT at 224²), 257 (256²) and 577 (384²) and far past, one
    past each limit (fp32's 256, a smaller card's 144), the grid (M),
    head_dim 32 and a width no kernel takes."""
    assert fused_block.spatial_fits(M, S, D, H, dtype, smem) is fits


@pytest.mark.parametrize("fits,M,S,dtype,smem", [
    (True, 64, 197, BF16, H100_SMEM), (True, 32, 197, BF16, H100_SMEM),
    (True, 8, 257, BF16, H100_SMEM), (True, 8, 577, BF16, H100_SMEM),
    (True, 4, 256, F32, H100_SMEM), (False, 4, 257, F32, H100_SMEM),
    (True, 2, 256, BF16, 100_000), (False, 2, 257, BF16, 100_000),
    (False, 65536, 197, BF16, H100_SMEM)])
def test_spatial_proj_fits(fits, M, S, dtype, smem):
    assert qkv_attn.spatial_proj_fits(M, S, 768, 12, dtype, smem) is fits


def test_scratch_shapes():
    """bf16: xn (reused for the heads) and six q/k/v halves; fp32: the heads."""
    assert fused_block.spatial_scratch_shape(64, 197, 768, BF16) == (7, 64 * 197, 768)
    assert fused_block.spatial_scratch_shape(4, 150, 1024, F32) == (1, 600, 1024)


class _StandIn:
    """A tensor that reports a CUDA device: shape, dtype and dim of the CPU
    tensor it wraps; ``float()`` wraps the fp32 copy."""

    requires_grad = False

    def __init__(self, t):
        self.t, self.device, self.shape, self.dtype = t, torch.device("cuda"), t.shape, t.dtype

    def dim(self):
        return self.t.dim()

    def float(self):
        return _StandIn(self.t.float())

    def contiguous(self):
        return self


@pytest.fixture
def recorded(monkeypatch):
    """Both wrappers' launches replaced by recorders of what they were
    handed; operand checks off, an H100's shared memory."""
    calls = []
    monkeypatch.setattr(fused_block, "_launch_spatial", lambda *a: calls.append(a))
    monkeypatch.setattr(qkv_attn, "_launch_spatial_proj", lambda *a: calls.append(a))
    monkeypatch.setattr(_build, "check_cuda_operand", lambda *a, **k: None)
    monkeypatch.setattr(_build, "smem_optin", lambda device: H100_SMEM)
    return calls


@pytest.mark.parametrize("vec_dtype", [BF16, F32])
def test_spatial_block_hands_vectors_over(recorded, vec_dtype):
    """bf16 x with bf16 LN and bias vectors: the very tensors reach the
    launch (the kernel widens them on load, no cast launch), vec_bf16 1;
    fp32 vectors: fp32, vec_bf16 0."""
    M, S, D, H = 2, 197, 256, 4
    vecs = [_StandIn(torch.zeros(n, dtype=vec_dtype)) for n in (D, D, 3 * D, D)]
    x = _StandIn(torch.zeros(M, S, D, dtype=BF16))
    w = [_StandIn(torch.zeros(n, D, dtype=BF16)) for n in (3 * D, D)]
    fused_block.fused_spatial_block(x, vecs[0], vecs[1], w[0], vecs[2], w[1], vecs[3], H,
                                    eps=1e-6)
    (got,) = recorded
    assert got[0] is x and got[3] is w[0] and got[4] is w[1] and got[5] == H
    assert got[2] == int(vec_dtype == BF16)
    if vec_dtype == BF16:
        assert all(a is b for a, b in zip(got[1], vecs))
    assert all(v.dtype == vec_dtype for v in got[1])


@pytest.mark.parametrize("vec_dtype", [BF16, F32])
def test_spatial_proj_hands_bias_over(recorded, vec_dtype):
    M, S, D, H = 2, 197, 256, 4
    qkv = _StandIn(torch.zeros(M, S, 3 * D, dtype=BF16))
    w, b = _StandIn(torch.zeros(D, D, dtype=BF16)), _StandIn(torch.zeros(D, dtype=vec_dtype))
    qkv_attn.spatial_attention_qkv_proj(qkv, w, b, H)
    (got,) = recorded
    assert got[0] is qkv and got[1] is w and got[3] == int(vec_dtype == BF16)
    assert (got[2] is b) if vec_dtype == BF16 else got[2].dtype == F32


def test_past_the_limit_raises_before_a_launch(recorded):
    """One past the fp32 limit, and bf16 past a smaller card's: ValueError,
    and no launch."""
    D, H = 256, 4
    x = _StandIn(torch.zeros(1, 257, D))
    vec = _StandIn(torch.zeros(D))
    w = [_StandIn(torch.zeros(n, D)) for n in (3 * D, D)]
    with pytest.raises(ValueError, match="S <= 256"):
        fused_block.fused_spatial_block(x, vec, vec, w[0], _StandIn(torch.zeros(3 * D)), w[1],
                                        vec, H, eps=1e-6)
    with pytest.raises(ValueError, match="S <= 256"):
        qkv_attn.spatial_attention_qkv_proj(_StandIn(torch.zeros(1, 257, 3 * D)), w[1], vec, H)
    assert recorded == []


# ---- the split-bf16 arithmetic against the TPU kernel ----


def _split(t: torch.Tensor):
    hi = t.to(BF16).float()
    return hi, (t - hi).to(BF16).float()


def _spatial_block_bf16_route(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, H, eps, split: bool):
    """B9's bf16 route in plain torch on fp32 operands (JAX layout weights):
    q, k, v and p each split into bf16 hi + lo and multiplied in the three
    terms the kernel issues (``split``), or each rounded to bf16 once; every
    product exact in fp32, every sum fp32; l the fp32 sum of the unrounded
    p."""
    M, S, D = x.shape
    hd = D // H
    qkv = ln_rows_f32(x, ln_s, ln_b, eps) @ wqkv + bqkv
    q, k, v = (qkv[..., i * D:(i + 1) * D].reshape(M, S, H, hd) for i in range(3))
    qk, pv = "mqhd,mkhd->mhqk", "mhqk,mkhd->mqhd"
    if split:
        (qh, ql), (kh, kl) = _split(q), _split(k)
        s = torch.einsum(qk, qh, kh) + torch.einsum(qk, qh, kl) + torch.einsum(qk, ql, kh)
    else:
        s = torch.einsum(qk, _split(q)[0], _split(k)[0])
    p = torch.exp(s * hd ** -0.5 - (s * hd ** -0.5).amax(dim=-1, keepdim=True))
    if split:
        (ph, pl), (vh, vl) = _split(p), _split(v)
        o = torch.einsum(pv, ph, vh) + torch.einsum(pv, ph, vl) + torch.einsum(pv, pl, vh)
    else:
        o = torch.einsum(pv, _split(p)[0], _split(v)[0])
    o = (o / p.sum(dim=-1).transpose(1, 2)[..., None]).reshape(M, S, D)
    return o @ wproj + bproj


@pytest.mark.parametrize("qk_std,atol", [(1.0, 1e-4), (4.0, 5e-4)])
def test_split_route_holds_the_tpu_kernel(qk_std, atol):
    """fp32, head_dim 64, the q and k weights at std qk_std·D^-½ (at 4 the
    scores reach the tens), v and the projection at D^-½: the split route
    is within ``atol`` of the JAX kernel, where rounding q, k, v and p to
    bf16 misses it by more than ten times that. At std D^-½ the split route
    reads ~7e-6 off; at 4·D^-½ ~2e-4, the hi + lo pairs' own precision
    (~2^-17 of each score's terms, scores of std 16) — a fourth product
    q_lo·k_loᵀ halves it only, so the kernel issues three — hence 5e-4
    there. Rounding reads ~4e-3 and ~7e-2."""
    rng = np.random.RandomState(int(qk_std))
    M, S, H, hd = 2, 33, 2, 64
    D = H * hd
    x = rng.randn(M, S, D).astype(np.float32)
    wqkv = np.concatenate([qk_std * D ** -0.5 * rng.randn(D, 2 * D),
                           D ** -0.5 * rng.randn(D, D)], axis=1)
    ws = [1 + 0.1 * rng.randn(D), 0.1 * rng.randn(D), wqkv, 0.1 * rng.randn(3 * D),
          D ** -0.5 * rng.randn(D, D), 0.1 * rng.randn(D)]
    ws = [a.astype(np.float32) for a in ws]
    want = np.asarray(jax_spatial_block(jnp.asarray(x), *map(jnp.asarray, ws), H, eps=1e-6))
    args = [torch.from_numpy(a) for a in [x] + ws]
    split = _spatial_block_bf16_route(*args, H, 1e-6, split=True).numpy()
    rounded = _spatial_block_bf16_route(*args, H, 1e-6, split=False).numpy()
    np.testing.assert_allclose(split, want, atol=atol, rtol=0)
    assert np.abs(rounded - want).max() > 10 * atol
