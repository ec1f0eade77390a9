"""Packed-qkv attention of the port (alpro_tpu_torch.ops.qkv_attn).

On the CPU: each plain twin against the JAX Pallas kernel function run in
interpret mode (alpro_tpu.ops.pallas_qkv_attn), fp32 and bf16, and the
wrapper's CPU dispatch and input checks. The CUDA kernels are held against
these twins on the card by tests/test_torch_cuda_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpro_tpu.ops.pallas_qkv_attn import (
    fused_attention_qkv,
    fused_temporal_attention_qkv,
)
from alpro_tpu_torch.ops import qkv_attn

# fp32: both sides compute in fp32, only the summation order differs.
FP32_ATOL = 2e-5
# bf16: same bf16 inputs; the Pallas kernel rounds p to bf16 before PV, the
# twin (its _xla_reference) does not, and both round the output to bf16:
# a few bf16 ulps of |o| < 2.
BF16_ATOL = 3e-2


def _qkv(shape, seed, dtype="float32"):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return x, jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# S = 257 and 577: 256² and 384² frames, the lengths past one key chunk that
# the kernel walks twice
@pytest.mark.parametrize("M,S,H,hd", [(3, 17, 4, 8), (4, 5, 2, 16), (2, 257, 2, 8),
                                      (1, 577, 2, 8)])
def test_spatial_twin_matches_jax_kernel(M, S, H, hd, dtype):
    _, xj, xt = _qkv((M, S, 3 * H * hd), seed=S, dtype=dtype)
    want = np.asarray(fused_attention_qkv(xj, H), np.float32)
    got = qkv_attn.spatial_attention_qkv(xt, H)
    assert got.dtype == xt.dtype and got.shape == (M, S, H * hd)
    atol = FP32_ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,N,H,hd", [(2, 2, 5, 2, 8), (2, 4, 9, 3, 8), (1, 16, 3, 2, 8)])
def test_temporal_twin_matches_jax_kernel(B, T, N, H, hd, dtype):
    _, xj, xt = _qkv((B, T, N, 3 * H * hd), seed=T, dtype=dtype)
    want = np.asarray(fused_temporal_attention_qkv(xj, H), np.float32)
    got = qkv_attn.temporal_attention_qkv(xt, H)
    assert got.dtype == xt.dtype and got.shape == (B, T, N, H * hd)
    atol = FP32_ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


def test_cpu_wrappers_dispatch_to_twins_without_counting():
    _, _, x3 = _qkv((2, 7, 3 * 16), seed=1)
    _, _, x4 = _qkv((1, 4, 3, 3 * 16), seed=2)
    before = (qkv_attn.spatial_launches, qkv_attn.temporal_launches)
    torch.testing.assert_close(qkv_attn.spatial_attention_qkv(x3, 2, scale=0.3),
                               qkv_attn.spatial_attention_plain(x3, 2, 0.3), rtol=0, atol=0)
    torch.testing.assert_close(qkv_attn.temporal_attention_qkv(x4, 2),
                               qkv_attn.temporal_attention_plain(x4, 2, 8 ** -0.5),
                               rtol=0, atol=0)
    assert (qkv_attn.spatial_launches, qkv_attn.temporal_launches) == before


@pytest.mark.parametrize("fn,shape", [
    (qkv_attn.spatial_attention_qkv, (2, 5, 3, 48)),   # 4-D into the spatial op
    (qkv_attn.spatial_attention_qkv, (2, 5, 50)),      # 50 != 3·H·hd
    (qkv_attn.temporal_attention_qkv, (2, 5, 48)),     # 3-D into the temporal op
])
def test_wrappers_reject_bad_shapes(fn, shape):
    with pytest.raises(ValueError):
        fn(torch.zeros(shape), 2)
