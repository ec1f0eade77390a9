"""B10's contract and host-side plan (``alpro_tpu_torch.ops.fused_block``),
on the CPU.

In bf16, B10 (``fused_temporal_block``) is four launches behind one C call
(``csrc/fused_block.cu``): the LN rows and the TMA/``wgmma`` GEMM into the
packed (R, 3D) qkv scratch, rounded once (B11's route), K2's body on it in
place, and the projection GEMM with b_eff and the residual. Its rounding
points are the TPU kernel's, which ``fused_temporal_block_reference`` states
in plain torch: q, k and v rounded to x's dtype after their fp32 bias. Here:

* the reference against the JAX kernel
  (``alpro_tpu.ops.pallas_fused_block.fused_temporal_block``) in interpret
  mode on bf16 inputs, within one output bf16 ulp (|diff| <= 2^-8 + 2^-7 ·
  |JAX|): both round at the same points, only fp32 sums differ in order. At
  q/k weights of std 4·D^-½ (scores in the tens) the fp32 twin, which keeps
  q, k and v in fp32 as the XLA reference does, misses the kernel by more
  than three times that (4.5-8.6 times at these seeds, where the reference
  is bit for bit the kernel); in fp32 the reference is the twin;
* the limits (``temporal_fits``): bf16 those of its parts, K2's body
  (head_dim a multiple of 8 up to 128, T up to 128) and the LN rows and
  GEMM (D a multiple of 128 up to 1024); fp32 head_dim 64 and T <= 32;
* with the launch replaced by a recorder and a CUDA stand-in for the
  tensors, that the wrapper hands the layer's bf16 vectors over without a
  cast (fp32 vectors as fp32), and raises past a limit before a launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpro_tpu.ops.pallas_fused_block import fused_temporal_block as jax_temporal_block
from alpro_tpu_torch.ops import _build, fused_block
from test_torch_fused_block_plan import H100_SMEM, _StandIn

BF16, F32 = torch.bfloat16, torch.float32
ULP_ATOL, ULP_RTOL = 2 ** -8, 2 ** -7  # one bf16 ulp of the output


def _case(B, T, N, H, hd, qk_scale, seed):
    """x (B, T, N, D) and the block's weights in JAX layout, rounded to bf16
    (fp32 arrays of bf16 values): ln scale, ln bias, wqkv (D, 3D) with the
    q/k columns at std qk_scale·D^-½, bqkv, w_eff (D, D), b_eff."""
    rng = np.random.RandomState(seed)
    D = H * hd
    wqkv = rng.randn(D, 3 * D) * D ** -0.5
    wqkv[:, :2 * D] *= qk_scale
    arrays = [rng.randn(B, T, N, D), 1 + 0.1 * rng.randn(D), 0.1 * rng.randn(D), wqkv,
              0.1 * rng.randn(3 * D), rng.randn(D, D) * D ** -0.5, 0.1 * rng.randn(D)]
    return [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32) for a in arrays]


def _jax(arrays, H, dtype):
    x, *ws = (jnp.asarray(a, dtype) for a in arrays)
    return np.asarray(jax_temporal_block(x, *ws, H, eps=1e-6), np.float32)


def _port(fn, arrays, H, dtype):
    x, s, b, wqkv, bqkv, w, bw = (torch.from_numpy(a).to(dtype) for a in arrays)
    return fn(x, s, b, wqkv.t().contiguous(), bqkv, w.t().contiguous(), bw, H, 1e-6)


def _ulps(got, want):
    """max |got - want| in units of the stated tolerance."""
    return float((np.abs(got - want) / (ULP_ATOL + ULP_RTOL * np.abs(want))).max())


@pytest.mark.parametrize("B,T,N,H,hd", [(2, 5, 6, 3, 8), (1, 8, 4, 2, 16), (1, 16, 3, 2, 16)])
@pytest.mark.parametrize("qk_scale", [1.0, 4.0])
def test_reference_matches_jax_kernel_in_bf16(B, T, N, H, hd, qk_scale):
    a = _case(B, T, N, H, hd, qk_scale, seed=T)
    want = _jax(a, H, jnp.bfloat16)
    got = _port(fused_block.fused_temporal_block_reference, a, H, BF16)
    assert got.dtype == BF16 and got.shape == (B, T, N, H * hd)
    assert _ulps(got.float().numpy(), want) <= 1.0


@pytest.mark.parametrize("B,T,N,H,hd", [(2, 5, 6, 3, 8), (1, 8, 4, 2, 16), (1, 16, 3, 2, 16)])
def test_twin_misses_jax_kernel_where_q_k_v_rounding_matters(B, T, N, H, hd):
    """Scores in the tens: rounding q and k to bf16 moves them by ~0.1, so
    the twin (q, k, v in fp32) is more than three tolerances off the kernel
    where the reference is within one."""
    a = _case(B, T, N, H, hd, 4.0, seed=T)
    want = _jax(a, H, jnp.bfloat16)
    twin = _port(fused_block.fused_temporal_block_plain, a, H, BF16).float().numpy()
    ref = _port(fused_block.fused_temporal_block_reference, a, H, BF16).float().numpy()
    assert _ulps(ref, want) <= 1.0 < 3.0 < _ulps(twin, want)


def test_reference_is_the_twin_in_fp32():
    """Nothing rounds in fp32: the reference, the twin and the JAX kernel
    agree to summation order (the JAX package's 3e-5)."""
    a = _case(2, 5, 6, 3, 8, 4.0, seed=0)
    want = _jax(a, 3, jnp.float32)
    for fn in (fused_block.fused_temporal_block_reference, fused_block.fused_temporal_block_plain):
        np.testing.assert_allclose(_port(fn, a, 3, F32).numpy(), want, atol=3e-5, rtol=0)


@pytest.mark.parametrize("fits,B,T,D,H,dtype", [
    (True, 8, 8, 768, 12, BF16), (True, 2, 16, 768, 12, BF16), (True, 1, 32, 768, 12, BF16),
    (True, 1, 48, 768, 12, BF16), (True, 1, 128, 768, 12, BF16), (False, 1, 129, 768, 12, BF16),
    (True, 8, 8, 768, 24, BF16), (True, 8, 8, 1024, 8, BF16), (True, 8, 8, 768, 6, BF16),
    (False, 8, 8, 768, 4, BF16), (False, 8, 8, 192, 3, BF16), (False, 8, 8, 1152, 9, BF16),
    (False, 8, 0, 768, 12, BF16), (True, 70000, 8, 768, 12, BF16),
    (True, 8, 8, 768, 12, F32), (True, 1, 32, 768, 12, F32), (False, 1, 33, 768, 12, F32),
    (False, 8, 8, 768, 24, F32), (False, 70000, 8, 768, 12, F32),
    (False, 8, 8, 768, 12, torch.float16)])
def test_temporal_fits(fits, B, T, D, H, dtype):
    """bf16: T = 8 (retrieval), 16 (QA), 32, 48 (K2's wide path), 128 and
    one past; head_dim 32, 128 (at D 768 and 1024) and 192 (past K2's 128);
    D 192 (not a multiple of the GEMM's 128-column tile) and 1152 (past the
    LN rows' 1024); no grid limit on B. fp32: T <= 32, head_dim 64, B within
    the grid's 65535."""
    assert fused_block.temporal_fits(B, T, D, H, dtype, H100_SMEM) is fits


def test_scratch_shapes():
    """bf16: xn (then the heads) and the packed qkv; fp32: the heads."""
    assert fused_block.temporal_scratch_shape(8, 8, 196, 768, BF16) == (4, 12544, 768)
    assert fused_block.temporal_scratch_shape(2, 16, 196, 768, F32) == (1, 6272, 768)


@pytest.fixture
def recorded(monkeypatch):
    """The temporal launch replaced by a recorder of what it was handed;
    operand checks off, an H100's shared memory."""
    calls = []
    monkeypatch.setattr(fused_block, "_launch_temporal", lambda *a: calls.append(a))
    monkeypatch.setattr(_build, "check_cuda_operand", lambda *a, **k: None)
    monkeypatch.setattr(_build, "smem_optin", lambda device: H100_SMEM)
    return calls


def _operands(B, T, N, D, dtype, vec_dtype):
    x = _StandIn(torch.zeros(B, T, N, D, dtype=dtype))
    vecs = [_StandIn(torch.zeros(n, dtype=vec_dtype)) for n in (D, D, 3 * D, D)]
    w = [_StandIn(torch.zeros(n, D, dtype=dtype)) for n in (3 * D, D)]
    return x, vecs, w


@pytest.mark.parametrize("T", [8, 48])
@pytest.mark.parametrize("vec_dtype", [BF16, F32])
def test_hands_vectors_over(recorded, vec_dtype, T):
    """bf16 x with bf16 LN and bias vectors: the very tensors reach the
    launch (the kernel widens them on load, no cast launch), vec_bf16 1;
    fp32 vectors: fp32, vec_bf16 0. T = 48 (K2's wide path) too."""
    B, N, D, H = 1, 196, 768, 12
    x, vecs, w = _operands(B, T, N, D, BF16, vec_dtype)
    fused_block.fused_temporal_block(x, vecs[0], vecs[1], w[0], vecs[2], w[1], vecs[3], H,
                                     eps=1e-6)
    (got,) = recorded
    assert got[0] is x and got[3] is w[0] and got[4] is w[1] and got[5] == H
    assert got[2] == int(vec_dtype == BF16)
    if vec_dtype == BF16:
        assert all(a is b for a, b in zip(got[1], vecs))
    assert all(v.dtype == vec_dtype for v in got[1])


def test_fp32_hands_fp32_vectors_over(recorded):
    x, vecs, w = _operands(2, 8, 5, 256, F32, F32)
    fused_block.fused_temporal_block(x, vecs[0], vecs[1], w[0], vecs[2], w[1], vecs[3], 4,
                                     eps=1e-6)
    (got,) = recorded
    assert got[2] == 0 and all(v.dtype == F32 for v in got[1])


@pytest.mark.parametrize("dtype,T,D,H,match", [
    (BF16, 129, 768, 12, "1 <= T <= 128"), (F32, 33, 768, 12, "1 <= T <= 32"),
    (BF16, 8, 1152, 9, "D a multiple of 128 up to 1024"),
    (BF16, 8, 768, 4, "head_dim a multiple of 8 up to 128"), (F32, 8, 768, 6, "head_dim 64")])
def test_past_a_limit_raises_before_a_launch(recorded, dtype, T, D, H, match):
    x, vecs, w = _operands(1, T, 2, D, dtype, dtype)
    with pytest.raises(ValueError, match=match):
        fused_block.fused_temporal_block(x, vecs[0], vecs[1], w[0], vecs[2], w[1], vecs[3], H,
                                         eps=1e-6)
    assert recorded == []
