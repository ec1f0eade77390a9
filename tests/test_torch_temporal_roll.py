"""Temporal attention's three forms in the port (alpro_tpu_torch.ops.
temporal_attn) against alpro_tpu.ops.pallas_temporal_attn, on the CPU.

The roll kernel's wrapper runs its twin on a CPU tensor; the JAX kernel runs
in interpret mode, as tests/test_temporal_attn.py runs it: fp32, atol 2e-5
forward and 1e-4 gradient (that file's tolerances), at its shapes. The
packed and circulant forms are plain torch against the JAX functions: atol
1e-5 and rtol 1e-5 for packed (tests/test_temporal_attn.py's), 2e-5 for
circulant. The model under ``temporal_attn_impl='packed'|'circulant'``
against the JAX model on the same weights: 2e-4 (the flagship-parity
tolerance, tests/test_torch_timesformer.py). The CUDA kernel is held against
the twin on the card by tests/test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpro_tpu.ops import pallas_temporal_attn as jax_ta
from alpro_tpu_torch.models.timesformer import TimeSformerConfig
from alpro_tpu_torch.ops import temporal_attn
from test_torch_timesformer import ATOL, _clips, _pair, _run


def _mk(B=2, T=4, N=9, D=32, seed=0, std=1.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, N, 3 * D) * std).astype(np.float32)


@pytest.mark.parametrize("B,T,N,D,H,seed", [(2, 4, 9, 32, 4, 0), (1, 3, 5, 16, 2, 1)])
def test_roll_matches_jax_kernel(B, T, N, D, H, seed):
    """The default shape and the non-power-of-two T of
    tests/test_temporal_attn.py."""
    x = _mk(B, T, N, D, seed)
    want = np.asarray(jax_ta.temporal_attention_roll(jnp.asarray(x), H))
    n = temporal_attn.roll_launches
    got = temporal_attn.temporal_attention_roll(torch.from_numpy(x), H)
    assert temporal_attn.roll_launches == n  # the twin on a CPU tensor
    assert got.shape == (B, T, N, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(
        temporal_attn.temporal_attention_roll_plain(torch.from_numpy(x), H).numpy(),
        np.asarray(jax_ta._xla_reference(jnp.asarray(x), H)), atol=2e-5, rtol=0)


def test_roll_gradient_matches_jax():
    x = _mk(B=1, T=3, N=4, D=16, seed=2)
    want = jax.grad(lambda v: jnp.sum(jax_ta.temporal_attention_roll(v, 2) ** 2))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad((temporal_attn.temporal_attention_roll(t, 2) ** 2).sum(), t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_roll_each_patch_independent():
    """Changing patch n's channels moves no other patch's outputs."""
    x = torch.from_numpy(_mk(B=1, T=4, N=6, D=16, seed=3))
    out1 = temporal_attn.temporal_attention_roll(x, 2)
    x2 = x.clone()
    x2[:, :, 2, :] += 1.0
    out2 = temporal_attn.temporal_attention_roll(x2, 2)
    keep = torch.ones(6, dtype=torch.bool)
    keep[2] = False
    torch.testing.assert_close(out1[:, :, keep], out2[:, :, keep], atol=1e-6, rtol=0)
    assert not torch.allclose(out1[:, :, 2], out2[:, :, 2])


@pytest.mark.parametrize("B,T,N,D,H", [(2, 4, 9, 24, 4), (1, 8, 33, 16, 2), (2, 3, 16, 12, 3)])
def test_packed_matches_jax(B, T, N, D, H):
    x = _mk(B, T, N, D, seed=3, std=0.3)
    want = jax_ta.temporal_attention_packed(jnp.asarray(x), H, pack=4)
    got = temporal_attn.temporal_attention_packed(torch.from_numpy(x), H, pack=4)
    assert got.shape == (B, T, N, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,T,N,D,H", [(2, 4, 9, 24, 4), (1, 8, 33, 16, 2), (2, 3, 16, 12, 3)])
def test_circulant_matches_jax(B, T, N, D, H):
    x = _mk(B, T, N, D, seed=5, std=0.3)
    want = jax_ta.temporal_attention_circulant(jnp.asarray(x), H)
    got = temporal_attn.temporal_attention_circulant(torch.from_numpy(x), H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("form", ["packed", "circulant"])
def test_plain_form_gradients_match_jax(form):
    """The plain forms differentiate natively: d qkv of sum(out²) against
    jax.grad of the JAX function (tests/test_temporal_attn.py's 1e-4)."""
    x = _mk(2, 4, 9, 12, seed=4, std=0.3)
    if form == "packed":
        jf = lambda v: jax_ta.temporal_attention_packed(v, 3, pack=4)  # noqa: E731
        tf = lambda v: temporal_attn.temporal_attention_packed(v, 3, pack=4)  # noqa: E731
    else:
        jf = lambda v: jax_ta.temporal_attention_circulant(v, 3)  # noqa: E731
        tf = lambda v: temporal_attn.temporal_attention_circulant(v, 3)  # noqa: E731
    want = jax.grad(lambda v: (jf(v) ** 2).sum())(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad((tf(t) ** 2).sum(), t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("form", ["packed", "circulant"])
def test_model_plain_form_matches_jax(form):
    """A JAX config with temporal_attn_impl='packed'|'circulant' builds in the
    port; the 2-block TimeSformer matches JAX's (TemporalNativeLayoutAttention
    between the unfolded qkv and proj) on the same weights, and the form is
    kept in training."""
    impls = dict(attn_impl="xla", temporal_attn_impl=form, mlp_impl="xla")
    jm, params, port = _pair(4, impls)
    got, want = _run(jm, params, port, _clips(2, 4, seed=12, form="raw_uint8"))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    x = torch.zeros(1, 4, 4, 32)
    assert port.cfg.impl("temporal_attn_impl", x, True) == form
    assert port.cfg.impl("temporal_attn_impl", x, False) == form
    assert TimeSformerConfig(temporal_attn_impl="auto").impl("temporal_attn_impl", x, False) == "plain"
    with pytest.raises(ValueError):
        TimeSformerConfig(attn_impl=form)
