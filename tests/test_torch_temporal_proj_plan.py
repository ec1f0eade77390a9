"""B8's contract and host-side plan (``alpro_tpu_torch.ops.qkv_attn``
``temporal_attention_qkv_proj``) and K2's limit, on the CPU.

In bf16, B8 is two launches behind one C call (``csrc/qkv_proj.cu``): K2's
body (``csrc/temporal_attn.cuh``) into an (R, D) bf16 heads scratch — the
per-head output rounded once to w_eff's dtype, where the TPU kernel rounds
``opart`` — then the TMA/``wgmma`` GEMM's ``kRound``, heads · w_effᵀ +
b_eff in fp32, rounded once. Its twin rounds at the same points. Here:

* the twin against the JAX kernel (``fused_temporal_attention_qkv_proj`` in
  interpret mode) at T = 8, 16 and 40 (past the fp32 route's 32; the bf16
  route takes it): in fp32 within 2e-5, the JAX package's own tolerance
  (tests/test_qkv_attn.py); in bf16 within one output ulp (|diff| <= 2^-8
  + 2^-7·|JAX|): both round the per-head output and the output at the same
  points, only fp32 sums differ in order;
* B8's limit predicate ``temporal_proj_fits`` against its parts': bf16 K2's
  ``temporal_fits`` and the GEMM's D a multiple of 128; fp32 head_dim 64, D
  in (256, 512, 768, 1024), T <= 32 and B within the grid;
* with the launch replaced by a recorder and a CUDA stand-in for the
  tensors, that the wrapper hands b_eff over without a cast (a bf16 b_eff
  beside bf16 qkv the very tensor, an fp32 one as fp32) and raises past a
  limit before a launch;
* K2's limit predicate (``temporal_fits``, read by K2, B16, B10 and B8)
  against the shared memory of its launch: the fast path's two stages of TMA
  boxes at T <= 32, the wide path's warps past it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpro_tpu.ops.pallas_qkv_attn import fused_temporal_attention_qkv_proj
from alpro_tpu_torch.ops import _build, qkv_attn
from test_torch_fused_block_plan import H100_SMEM, _StandIn

BF16, F32 = torch.bfloat16, torch.float32
ULP_ATOL, ULP_RTOL = 2 ** -8, 2 ** -7  # one bf16 ulp of the output


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,N,H,hd", [(2, 8, 5, 2, 16), (1, 16, 3, 2, 16), (1, 40, 2, 2, 8)])
def test_twin_matches_jax_kernel(B, T, N, H, hd, dtype):
    rng = np.random.RandomState(T)
    D = H * hd
    arrays = [rng.randn(B, T, N, 3 * D), 0.2 * rng.randn(D, D), 0.2 * rng.randn(D)]
    # the same values in both packages: rounded to the dtype first
    qkv, we, be = (np.asarray(jnp.asarray(a, dtype), np.float32) for a in arrays)
    want = np.asarray(fused_temporal_attention_qkv_proj(
        *(jnp.asarray(a, dtype) for a in (qkv, we, be)), H), np.float32)
    tdt = getattr(torch, dtype)
    got = qkv_attn.temporal_attention_qkv_proj(torch.from_numpy(qkv).to(tdt),
                                               torch.from_numpy(we.T.copy()).to(tdt),
                                               torch.from_numpy(be).to(tdt), H)
    assert got.dtype == tdt and got.shape == (B, T, N, D)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=ULP_ATOL, rtol=ULP_RTOL)


_FITS = [
    (True, 8, 8, 768, 12, BF16), (True, 2, 16, 768, 12, BF16), (True, 1, 32, 768, 12, BF16),
    (True, 1, 48, 768, 12, BF16), (True, 1, 128, 768, 12, BF16), (False, 1, 129, 768, 12, BF16),
    (True, 8, 8, 768, 24, BF16), (True, 8, 8, 1024, 8, BF16), (True, 8, 8, 768, 6, BF16),
    (True, 8, 8, 640, 10, BF16), (True, 8, 8, 2048, 16, BF16), (False, 8, 8, 768, 4, BF16),
    (False, 8, 8, 576, 9, BF16), (False, 8, 0, 768, 12, BF16), (True, 70000, 8, 768, 12, BF16),
    (True, 8, 8, 768, 12, F32), (True, 1, 32, 768, 12, F32), (False, 1, 33, 768, 12, F32),
    (False, 8, 8, 768, 24, F32), (False, 70000, 8, 768, 12, F32), (False, 8, 8, 640, 10, F32),
    (False, 8, 8, 768, 12, torch.float16)]


@pytest.mark.parametrize("fits,B,T,D,H,dtype", _FITS)
def test_temporal_proj_fits(fits, B, T, D, H, dtype):
    """bf16: T = 8 (retrieval), 16 (QA), 32, 48 and 128 (K2's wide path)
    and one past; head_dim 32, 128 (D 768 and 1024), 192 (past K2's 128);
    D 640 and 2048 (multiples of the GEMM's 128 columns past the fp32
    route's widths), 576 (not one); no grid limit on B. fp32: T <= 32,
    head_dim 64, D in its widths, B within the grid's 65535."""
    assert qkv_attn.temporal_proj_fits(B, T, D, H, dtype, H100_SMEM) is fits


def test_bf16_limit_is_its_parts():
    """bf16: B8 takes exactly what K2's body and the GEMM take, over T 1 to
    129, head_dim 8 to 136 and 1 to 16 heads."""
    for T in (1, 8, 16, 32, 33, 48, 128, 129):
        for hd in (8, 16, 32, 40, 64, 96, 128, 136):
            for H in (1, 2, 6, 7, 12, 16):
                parts = qkv_attn.temporal_fits(T, hd, BF16, H100_SMEM) and hd * H % 128 == 0
                assert qkv_attn.temporal_proj_fits(2, T, hd * H, H, BF16, H100_SMEM) is parts


@pytest.fixture
def recorded(monkeypatch):
    """B8's launch replaced by a recorder of what it was handed; operand
    checks off, an H100's shared memory."""
    calls = []
    monkeypatch.setattr(qkv_attn, "_launch_temporal_proj", lambda *a: calls.append(a))
    monkeypatch.setattr(_build, "check_cuda_operand", lambda *a, **k: None)
    monkeypatch.setattr(_build, "smem_optin", lambda device: H100_SMEM)
    return calls


@pytest.mark.parametrize("dtype,vec_dtype,T", [(BF16, BF16, 8), (BF16, BF16, 48), (BF16, F32, 8),
                                               (BF16, F32, 48), (F32, F32, 8)])
def test_hands_bias_over(recorded, dtype, vec_dtype, T):
    """bf16 qkv with a bf16 b_eff (the model's): the very tensor reaches the
    launch (the GEMM widens it on load, no cast launch), vec_bf16 1; an fp32
    b_eff, beside bf16 or fp32 qkv: fp32, vec_bf16 0. T = 48 (K2's wide
    path) too."""
    D, H = 768, 12
    qkv = _StandIn(torch.zeros(1, T, 196, 3 * D, dtype=dtype))
    w, b = _StandIn(torch.zeros(D, D, dtype=dtype)), _StandIn(torch.zeros(D, dtype=vec_dtype))
    qkv_attn.temporal_attention_qkv_proj(qkv, w, b, H)
    (got,) = recorded
    assert got[0] is qkv and got[1] is w and got[3] == int(vec_dtype == BF16)
    assert got[4] == H and got[5] == 0.125
    assert (got[2] is b) if vec_dtype == BF16 else got[2].dtype == F32


@pytest.mark.parametrize("dtype,T,D,H,match", [
    (BF16, 129, 768, 12, "1 <= T <= 128"), (F32, 33, 768, 12, "1 <= T <= 32"),
    (BF16, 8, 576, 9, "D a multiple of 128"),
    (BF16, 8, 768, 4, "head_dim a multiple of 8 up to 128"), (F32, 8, 768, 6, "head_dim 64")])
def test_past_a_limit_raises_before_a_launch(recorded, dtype, T, D, H, match):
    qkv = _StandIn(torch.zeros(1, T, 2, 3 * D, dtype=dtype))
    w, b = _StandIn(torch.zeros(D, D, dtype=dtype)), _StandIn(torch.zeros(D, dtype=dtype))
    with pytest.raises(ValueError, match=match):
        qkv_attn.temporal_attention_qkv_proj(qkv, w, b, H)
    assert recorded == []


def _fast_smem(T, hd, elem):
    """K2's fast path (csrc/temporal_attn.cuh fast_smem): 128 bytes of
    mbarriers, then two stages of q, k and v boxes of T frames x rows
    (location, head) rows x hd values, each rounded up to 128 bytes; rows =
    128 // T, fewer where the three boxes pass 48 KiB, at least 1."""
    rows = max(1, min(128 // T, 49152 // (3 * T * hd * elem)))
    return 128 + 2 * 3 * (-(-T * rows * hd * elem // 128) * 128)


@pytest.mark.parametrize("T,hd,dtype,smem", [
    (8, 64, BF16, 128 + 6 * 16384),   # the main shape: 16 rows, 128 threads
    (16, 64, BF16, 128 + 6 * 16384),  # QA: 8 rows
    (32, 64, BF16, 128 + 6 * 16384),  # 4 rows
    (8, 128, BF16, 128 + 6 * 16384),  # 8 rows: three 16 KiB boxes
    (32, 128, F32, 128 + 6 * 16384),  # one row
    (5, 8, BF16, 128 + 6 * 2048),     # 25 rows of 16 bytes, 2000 rounded up
    (1, 64, F32, 128 + 6 * 16384),    # 64 rows, not 128: the 48 KiB budget binds
    (48, 64, BF16, 4 * 2 * 48 * 64 * 4),  # the wide path: four warps' fp32 K and V
    (128, 128, F32, 2 * 128 * 128 * 4),  # the wide path: one warp
    (129, 64, BF16, 0), (8, 136, BF16, 0), (8, 36, BF16, 0), (8, 64, torch.float16, 0)])
def test_temporal_smem_is_the_new_bodys(T, hd, dtype, smem):
    """``temporal_smem_bytes`` — the figure ``temporal_fits`` reads and the C
    side's ``alpro_temporal_attn_smem`` must equal on the card — at the
    main path's shapes, the fast path's edges, the wide path and past every
    limit."""
    assert qkv_attn.temporal_smem_bytes(T, hd, dtype, H100_SMEM) == smem
    assert qkv_attn.temporal_fits(T, hd, dtype, H100_SMEM) is (smem > 0)
    if 0 < smem and T <= 32:
        assert smem == _fast_smem(T, hd, dtype.itemsize)


def test_small_card_falls_back_to_the_wide_path():
    """Where the fast path's two stages do not fit (a card with 64 KiB a
    block), the launch is the wide path's, as the C dispatch picks it."""
    assert qkv_attn.temporal_smem_bytes(8, 64, BF16, 65536) == 4 * 2 * 8 * 64 * 4
    assert qkv_attn.temporal_smem_bytes(8, 64, BF16, 98432) == 98432
    assert qkv_attn.temporal_smem_bytes(32, 128, F32, 32767) == 0
