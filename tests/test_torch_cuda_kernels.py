"""The port's CUDA kernels against their plain twins, on the card.

Every test carries the ``cuda`` marker and skips without a CUDA device. The
file imports only torch and the port (no jax), so it runs on the machine with
the GPU: ``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``.
Tolerances: bf16 outputs within a few bf16 ulps of the twin (the spatial
kernel rounds p to bf16 before PV, and the BERT attention kernel q, k, v and
p as its TPU kernel does, where the twins keep fp32); fp32 within
summation-order noise.
"""

import pytest
import torch

from alpro_tpu_torch.ops import bert_block, ln_mlp, qkv_attn

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


def _bert_attn_args(M, S, cuda, dtype, seed=0):
    D = 768
    g = torch.Generator().manual_seed(seed)
    mask = torch.ones(M, S)
    for m in range(M):  # padding tails of different lengths
        mask[m, S - (m * 7) % max(S // 2, 1):] = 0.0
    mask[:, 0] = 1.0
    ws = []
    for _ in range(4):
        ws += [_randn((D, D), int(torch.randint(1 << 30, (1,), generator=g)), cuda, dtype,
                      D ** -0.5),
               _randn((D,), int(torch.randint(1 << 30, (1,), generator=g)), cuda, dtype, 0.1)]
    ln = (1 + _randn((D,), 7, cuda, torch.float32, 0.1), _randn((D,), 8, cuda, torch.float32, 0.1))
    return _randn((M, S, D), S + M, cuda, dtype), mask.to(cuda), ws, ln


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,S", [(1, 40), (8, 237), (16, 237), (3, 17)])
def test_bert_attn_kernel_matches_twin(cuda, M, S, dtype):
    x, mask, ws, ln = _bert_attn_args(M, S, cuda, dtype)
    n = bert_block.attn_launches
    got = bert_block.bert_attention_block(x, mask, *ws, *ln, 12, eps=1e-12)
    torch.cuda.synchronize()
    assert bert_block.attn_launches == n + 1
    want = bert_block.bert_attention_block_plain(x, mask, *ws, *ln, 12, 1e-12)
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_bert_attn_kernel_takes_the_longest_fusion_sequence(cuda):
    """512 text positions + 197 video tokens, in bf16; fp32 has a lower
    limit, and past it the wrapper raises naming it."""
    x, mask, ws, ln = _bert_attn_args(1, 512 + 197, cuda, torch.bfloat16, seed=1)
    got = bert_block.bert_attention_block(x, mask, *ws, *ln, 12, eps=1e-12)
    want = bert_block.bert_attention_block_plain(x, mask, *ws, *ln, 12, 1e-12)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)
    limit = bert_block.max_seq_len(torch.float32, cuda)
    x, mask, ws, ln = _bert_attn_args(1, limit + 1, cuda, torch.float32)
    with pytest.raises(ValueError, match=f"S <= {limit}"):
        bert_block.bert_attention_block(x, mask, *ws, *ln, 12, eps=1e-12)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R", [40, 320, 1896, 3])
def test_bert_mlp_kernel_matches_twin(cuda, R, dtype):
    D, Dh = 768, 3072
    args = (
        _randn((R, D), R, cuda, dtype, 2.0),
        _randn((Dh, D), 3, cuda, dtype, D ** -0.5),
        _randn((Dh,), 4, cuda, dtype, 0.1),
        _randn((D, Dh), 5, cuda, dtype, Dh ** -0.5),
        _randn((D,), 6, cuda, dtype, 0.1),
        1 + _randn((D,), 1, cuda, torch.float32, 0.1),
        _randn((D,), 2, cuda, torch.float32, 0.1),
    )
    n = bert_block.mlp_launches
    got = bert_block.bert_mlp_block(*args, eps=1e-12)
    torch.cuda.synchronize()
    assert bert_block.mlp_launches == n + 1
    want = bert_block.bert_mlp_block_plain(*args, 1e-12)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_bert_kernels_reject_what_they_do_not_take(cuda):
    x, mask, ws, ln = _bert_attn_args(1, 8, cuda, torch.float32)
    with pytest.raises(ValueError, match="head_dim 64"):
        bert_block.bert_attention_block(x, mask, *ws, *ln, 8, eps=1e-12)
    with pytest.raises(ValueError, match="dtype"):
        bert_block.bert_attention_block(x.to(torch.bfloat16), mask, *ws, *ln, 12, eps=1e-12)
    with pytest.raises(ValueError, match="Dh"):
        bert_block.bert_mlp_block(x[0], torch.zeros(100, 768, device=cuda),
                                  torch.zeros(100, device=cuda),
                                  torch.zeros(768, 100, device=cuda), ln[1], *ln, eps=1e-12)
