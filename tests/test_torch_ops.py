"""Port plain ops (alpro_tpu_torch.ops) vs their alpro_tpu counterparts.

Same numpy inputs through both; fp32 within atol 2e-4 (docs/PARITY.md
activations gate) or tighter, bf16 within one-to-two bf16 ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpro_tpu.ops import attention as jax_attention
from alpro_tpu.ops import kernel_math as jax_km
from alpro_tpu.ops import layers as jax_layers
from alpro_tpu_torch.ops import attention, kernel_math, layers


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.mark.parametrize("eps", [1e-6, 1e-12])
def test_ln_rows_f32_matches_jax(eps):
    rng = np.random.RandomState(0)
    x = (rng.randn(5, 7, 48) * 3 + 1).astype(np.float32)
    s = rng.randn(48).astype(np.float32)
    b = rng.randn(48).astype(np.float32)
    want = jax_km.ln_rows_f32(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), eps)
    got = kernel_math.ln_rows_f32(torch.from_numpy(x), torch.from_numpy(s),
                                  torch.from_numpy(b), eps)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=1e-5)


def test_erf_and_gelu_within_as_polynomial_bound():
    """True erf (the port) vs the JAX kernels' Abramowitz–Stegun erf: the
    polynomial's max error is 1.5e-7, plus the fp32 rounding of its
    evaluation (measured 4.1e-7 in all)."""
    x = np.linspace(-6, 6, 4001).astype(np.float32)
    np.testing.assert_allclose(
        _np(kernel_math.erf_f32(torch.from_numpy(x))),
        _np(jax_km.erf_f32(jnp.asarray(x))), atol=5e-7, rtol=0,
    )
    np.testing.assert_allclose(
        _np(kernel_math.gelu_exact_f32(torch.from_numpy(x))),
        _np(jax.nn.gelu(jnp.asarray(x), approximate=False)), atol=2e-6, rtol=1e-6,
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_apply_matches_jax(dtype):
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 4, 32) * 2).astype(np.float32)
    s = (1 + 0.1 * rng.randn(32)).astype(np.float32)
    b = (0.1 * rng.randn(32)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_layers.layernorm_apply(jnp.asarray(x, jdt), jnp.asarray(s),
                                      jnp.asarray(b), 1e-6, jdt)
    got = layers.layernorm_apply(torch.from_numpy(x).to(tdt), torch.from_numpy(s),
                                 torch.from_numpy(b), 1e-6, tdt)
    assert got.dtype == tdt
    atol = 2e-5 if dtype == "float32" else 2e-2  # bf16: one ulp at |y| ~ 4
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def test_gelu_exact_keeps_dtype():
    x = torch.linspace(-4, 4, 257)
    for dt in (torch.float32, torch.bfloat16):
        y = layers.gelu_exact(x.to(dt))
        assert y.dtype == dt
        np.testing.assert_allclose(
            _np(y), _np(jax.nn.gelu(jnp.asarray(x.numpy()), approximate=False)),
            atol=2e-6 if dt == torch.float32 else 2e-2,
        )


@pytest.mark.parametrize("dtype,masked", [
    ("float32", False), ("float32", True), ("bfloat16", False), ("bfloat16", True),
])
def test_multi_head_attention_bshd_matches_jax(dtype, masked):
    rng = np.random.RandomState(2)
    B, Sq, Sk, H, hd = 2, 5, 7, 3, 8
    q = rng.randn(B, Sq, H, hd).astype(np.float32)
    k = rng.randn(B, Sk, H, hd).astype(np.float32)
    v = rng.randn(B, Sk, H, hd).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((B, Sk), np.int32)
        mask[0, 4:] = 0
        mask[1, 6:] = 0
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_attention.multi_head_attention_bshd(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        key_mask=None if mask is None else jnp.asarray(mask), impl="xla",
    )
    got = attention.multi_head_attention_bshd(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt),
        key_mask=None if mask is None else torch.from_numpy(mask),
    )
    assert got.dtype == tdt and got.shape == (B, Sq, H, hd)
    # bf16: scores and probs round to bf16 at the same points on both sides;
    # the remaining gap is one ulp of the bf16 output (|o| < 2)
    atol = 2e-5 if dtype == "float32" else 1.6e-2
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def test_layernorm_module_uses_one_pass_stats():
    """The module is the functional LN with its own weight/bias, not
    F.layer_norm: identical to layernorm_apply bit for bit."""
    ln = layers.LayerNorm(16, 1e-12)
    with torch.no_grad():
        ln.weight.normal_(generator=torch.Generator().manual_seed(0))
    x = torch.randn(4, 16, generator=torch.Generator().manual_seed(1)) * 50 + 300
    torch.testing.assert_close(
        ln(x, torch.float32),
        layers.layernorm_apply(x, ln.weight, ln.bias, 1e-12, torch.float32),
        rtol=0, atol=0,
    )
