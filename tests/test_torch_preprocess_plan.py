"""The host-side plan of the raw-frame patch embed's bf16 route
(alpro_tpu_torch.ops.preprocess, B15).

On the CPU:

* ``patch_rows_plain``, the contract of the route's scratch (the patch rows
  pass, csrc/patchify_embed.cu), against the JAX package's ``_normalize``
  followed by the (ph, pw, c) patchify, bit for bit in bf16 and fp32 (XLA's
  CPU normalize divides as IEEE does): on seeded frames whose sides are and
  are not multiples of p, at p 8 and 16, and on every (value, channel)
  pair, the 768 entries of the pass's lookup table;
* the twin against the JAX kernel function in interpret mode in bf16 at p
  8 and 16, within one output ulp (fp32 sums in another order);
* ``fits``, the one limit predicate, at and one past each limit: bf16 K a
  multiple of 64 (p 8 and 16, not 4 and 12), D of 128, H and W at least p;
  fp32 keeps its row tile's limits;
* with the launch replaced by a recorder and a CUDA stand-in for the
  tensors: a bf16 bias beside a bf16 kernel reaches the launch as it is (no
  cast launch), an fp32 one as fp32, and past a limit the wrapper raises
  before a launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpro_tpu.models.timesformer import TimeSformerConfig as JaxCfg
from alpro_tpu.ops.pallas_preprocess import _normalize, fused_patchify_embed
from alpro_tpu_torch.ops import _build, preprocess
from test_torch_fused_block_plan import _StandIn

MEAN, STD = JaxCfg.pixel_mean, JaxCfg.pixel_std
BF16, F32 = torch.bfloat16, torch.float32
ULP_ATOL, ULP_RTOL = 2 ** -8, 2 ** -7


def _jax_rows(raw: np.ndarray, p: int, dtype) -> np.ndarray:
    """The JAX function's normalize, then the (ph, pw, c) patchify in numpy,
    as fp32 (B·T·N, p·p·3)."""
    x = np.asarray(_normalize(jnp.asarray(raw), MEAN, STD, dtype).astype(jnp.float32))
    B, T, H, W, C = raw.shape
    hp, wp = H // p, W // p
    x = x[:, :, :hp * p, :wp * p].reshape(B, T, hp, p, wp, p, C).transpose(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(-1, p * p * C)


@pytest.mark.parametrize("dtype,jdtype", [(BF16, jnp.bfloat16), (F32, jnp.float32)])
@pytest.mark.parametrize("p,H,W", [(16, 48, 32), (16, 40, 56), (8, 40, 56), (8, 24, 16)])
def test_patch_rows_plain_is_the_jax_normalize(p, H, W, dtype, jdtype):
    raw = np.random.RandomState(p + H + W).randint(0, 256, (2, 3, H, W, 3)).astype(np.uint8)
    got = preprocess.patch_rows_plain(torch.from_numpy(raw), p, MEAN, STD, dtype)
    assert got.shape == (2 * 3 * (H // p) * (W // p), 3 * p * p) and got.dtype == dtype
    want = _jax_rows(raw, p, jdtype)
    np.testing.assert_array_equal(got.float().numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("dtype,jdtype", [(BF16, jnp.bfloat16), (F32, jnp.float32)])
def test_every_table_entry_is_the_jax_normalize(dtype, jdtype):
    """Every value 0..255 in every channel: the entries of the rows pass's
    lookup table."""
    raw = np.broadcast_to(np.arange(256, dtype=np.uint8).reshape(1, 1, 16, 16, 1),
                          (1, 1, 16, 16, 3)).copy()
    got = preprocess.patch_rows_plain(torch.from_numpy(raw), 16, MEAN, STD, dtype)
    np.testing.assert_array_equal(got.float().numpy().view(np.uint32),
                                  _jax_rows(raw, 16, jdtype).view(np.uint32))


@pytest.mark.parametrize("p,side", [(16, 48), (8, 40)])
def test_bf16_twin_matches_jax_kernel(p, side):
    rng = np.random.RandomState(p)
    K, D = 3 * p * p, 128
    raw = rng.randint(0, 256, (2, 2, side, side, 3)).astype(np.uint8)
    kernel = (rng.randn(K, D) * K ** -0.5).astype(np.float32)
    bias = (rng.randn(D) * 0.02).astype(np.float32)
    kb, bb = jnp.asarray(kernel, jnp.bfloat16), jnp.asarray(bias, jnp.bfloat16)
    want = np.asarray(fused_patchify_embed(jnp.asarray(raw), kb, bb, MEAN, STD).astype(
        jnp.float32))
    got = preprocess.patchify_embed(torch.from_numpy(raw), torch.from_numpy(kernel).to(BF16),
                                    torch.from_numpy(bias).to(BF16), MEAN, STD)
    assert got.dtype == BF16 and got.shape == (2, 2, (side // p) ** 2, D)
    np.testing.assert_allclose(got.float().numpy(), want, atol=ULP_ATOL, rtol=ULP_RTOL)


@pytest.mark.parametrize("fits,p,D,H,W,dtype", [
    (True, 16, 768, 224, 224, BF16), (True, 8, 768, 224, 224, BF16),
    (False, 4, 768, 224, 224, BF16), (False, 12, 768, 224, 224, BF16),
    (False, 9, 768, 224, 224, BF16), (True, 24, 768, 224, 224, BF16),
    (True, 16, 128, 224, 224, BF16), (False, 16, 192, 224, 224, BF16),
    (True, 16, 896, 224, 224, BF16), (False, 16, 832, 224, 224, BF16),
    (True, 16, 4096, 224, 224, BF16), (False, 16, 0, 224, 224, BF16),
    (True, 16, 768, 16, 16, BF16), (False, 16, 768, 15, 224, BF16),
    (False, 16, 768, 224, 15, BF16), (True, 8, 256, 8, 216, BF16),
    (True, 16, 768, 224, 224, F32), (False, 8, 768, 224, 224, F32),
    (False, 16, 896, 224, 224, F32), (False, 24, 768, 224, 224, F32),
    (False, 16, 768, 224, 224, torch.float16)])
def test_fits(fits, p, D, H, W, dtype):
    """bf16: the GEMM's K chunk (K = 3p² a multiple of 64: p 8, 16, 24, not
    4, 9, 12) and column tile (D % 128: 896 and 4096 taken, 192 and 832
    not), frames at least p; fp32: the row tile's K % 128 up to 1024 (p 16
    only) and D in 256-1024."""
    assert preprocess.fits(p, D, H, W, dtype) is fits


@pytest.fixture
def recorded(monkeypatch):
    """The launch replaced by a recorder of what it was handed; operand
    checks off."""
    calls = []
    monkeypatch.setattr(preprocess, "_launch", lambda *a: calls.append(a))
    monkeypatch.setattr(_build, "check_cuda_operand", lambda *a, **k: None)
    return calls


def _operands(p, D, H, W, dtype, bias_dtype):
    raw = _StandIn(torch.zeros(2, 8, H, W, 3, dtype=torch.uint8))
    return (raw, _StandIn(torch.zeros(3 * p * p, D, dtype=dtype)),
            _StandIn(torch.zeros(D, dtype=bias_dtype)))


@pytest.mark.parametrize("dtype,bias_dtype", [(BF16, BF16), (BF16, F32), (F32, F32),
                                              (F32, BF16)])
def test_hands_bias_over(recorded, dtype, bias_dtype):
    """A bf16 kernel with a bf16 bias: the very tensor reaches the launch
    (the GEMM widens it on load: no cast launch), vec_bf16 1; otherwise an
    fp32 bias, vec_bf16 0."""
    raw, kernel, bias = _operands(16, 768, 224, 224, dtype, bias_dtype)
    preprocess.patchify_embed(raw, kernel, bias, MEAN, STD)
    (got,) = recorded
    assert got[0] is raw and got[1] is kernel and got[4:] == (MEAN, STD)
    as_is = dtype == bias_dtype == BF16
    assert got[3] == int(as_is)
    assert got[2] is bias if as_is else got[2].dtype == F32


@pytest.mark.parametrize("p,D,H,W,dtype", [(4, 768, 224, 224, BF16), (12, 768, 224, 224, BF16),
                                           (16, 832, 224, 224, BF16), (16, 768, 15, 224, BF16),
                                           (16, 896, 224, 224, F32), (8, 768, 224, 224, F32)])
def test_past_a_limit_raises_before_a_launch(recorded, p, D, H, W, dtype):
    raw, kernel, bias = _operands(p, D, H, W, dtype, dtype)
    with pytest.raises(ValueError, match=f"for {dtype}"):
        preprocess.patchify_embed(raw, kernel, bias, MEAN, STD)
    assert recorded == []
