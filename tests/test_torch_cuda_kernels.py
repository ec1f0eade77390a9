"""The port's CUDA kernels against their plain twins, on the card.

Every test carries the ``cuda`` marker and skips without a CUDA device. The
file imports only torch and the port (no jax), so it runs on the machine with
the GPU: ``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``.
Tolerances: bf16 outputs within a few bf16 ulps of the twin (the spatial
kernel rounds p to bf16 before PV, its twin does not); fp32 within
summation-order noise.
"""

import pytest
import torch

from alpro_tpu_torch.ops import ln_mlp, qkv_attn

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, device, dtype, std=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * std).to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,S", [(16, 197), (3, 17), (2, 64)])
def test_spatial_kernel_matches_twin(cuda, M, S, dtype):
    H, hd = 12, 64
    x = _randn((M, S, 3 * H * hd), S, cuda, dtype)
    n = qkv_attn.spatial_launches
    got = qkv_attn.spatial_attention_qkv(x, H)
    torch.cuda.synchronize()
    assert qkv_attn.spatial_launches == n + 1
    want = qkv_attn.spatial_attention_plain(x, H, hd ** -0.5)
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T", [1, 8, 16])
def test_temporal_kernel_matches_twin(cuda, T, dtype):
    B, N, H, hd = 2, 196, 12, 64
    x = _randn((B, T, N, 3 * H * hd), T, cuda, dtype)
    n = qkv_attn.temporal_launches
    got = qkv_attn.temporal_attention_qkv(x, H)
    torch.cuda.synchronize()
    assert qkv_attn.temporal_launches == n + 1
    want = qkv_attn.temporal_attention_plain(x, H, hd ** -0.5)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R,residual", [(3136, True), (2, False), (45, True)])
def test_ln_mlp_kernel_matches_twin(cuda, R, residual, dtype):
    D, Dh = 768, 3072
    args = (
        _randn((R, D), R, cuda, dtype, 2.0),
        1 + _randn((D,), 1, cuda, torch.float32, 0.1),
        _randn((D,), 2, cuda, torch.float32, 0.1),
        _randn((Dh, D), 3, cuda, dtype, D ** -0.5),
        _randn((Dh,), 4, cuda, dtype, 0.1),
        _randn((D, Dh), 5, cuda, dtype, Dh ** -0.5),
        _randn((D,), 6, cuda, dtype, 0.1),
    )
    n = ln_mlp.launches
    got = ln_mlp.ln_mlp(*args, eps=1e-6, residual=residual)
    torch.cuda.synchronize()
    assert ln_mlp.launches == n + 1
    want = ln_mlp.ln_mlp_plain(*args, eps=1e-6, residual=residual)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_kernels_reject_what_they_do_not_take(cuda):
    strided = torch.zeros(4, 9, 2 * 3 * 64, device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        qkv_attn.spatial_attention_qkv(strided, 1)
    with pytest.raises(ValueError, match="dtype"):
        qkv_attn.temporal_attention_qkv(torch.zeros(1, 2, 3, 192, device=cuda,
                                                    dtype=torch.float16), 1)
    with pytest.raises(ValueError, match="T <= 32"):
        qkv_attn.temporal_attention_qkv(torch.zeros(1, 33, 1, 192, device=cuda), 1)
    x = torch.zeros(2, 768, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(3072, 768, device=cuda)  # fp32 weights for bf16 rows
    v = torch.zeros(768, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        ln_mlp.ln_mlp(x, v, v, w, torch.zeros(3072, device=cuda), w.t().contiguous(), v,
                      eps=1e-6)
