"""The LayerNorm kernel's twin and backward (alpro_tpu_torch.ops.layernorm)
and ``LayerNorm(impl='pallas')``.

On the CPU, against the JAX kernel function in Pallas interpret mode
(alpro_tpu.ops.pallas_layernorm.fused_layernorm): the twin in fp32 (atol
1e-5, the JAX test's own) and with a bf16 output (one bf16 ulp: both round
the same fp32 value, which may sit on a rounding boundary); the gradient —
autograd through the twin and the kernel's backward function, JAX's
analytic ``_bwd`` — against ``jax.grad`` through the custom_vjp (1e-5); the
module against JAX ``LayerNorm(1e-6, impl='pallas')``. The CUDA kernel is
held against the twin on the card by tests/test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpro_tpu.ops.layers import LayerNorm as JaxLayerNorm
from alpro_tpu.ops.pallas_layernorm import fused_layernorm
from alpro_tpu_torch.ops import layernorm as ln
from alpro_tpu_torch.ops.layers import LayerNorm


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32) * 3 + 1,
            rng.randn(shape[-1]).astype(np.float32), rng.randn(shape[-1]).astype(np.float32))


@pytest.mark.parametrize("shape", [(7, 16), (3, 5, 32), (300, 64)])
def test_twin_matches_jax_kernel_fp32(shape):
    x, s, b = _inputs(shape, len(shape))
    want = fused_layernorm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 1e-6, jnp.float32)
    got = ln.layernorm(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b), eps=1e-6)
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_twin_matches_jax_kernel_bf16_out(in_dtype):
    """bf16 output from fp32 or bf16 input: within one bf16 ulp of |y|."""
    x, s, b = _inputs((40, 32), 5)
    xj = jnp.asarray(x, getattr(jnp, in_dtype))
    want = np.asarray(fused_layernorm(xj, jnp.asarray(s), jnp.asarray(b), 1e-6, jnp.bfloat16),
                      np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, in_dtype))
    got = ln.layernorm(xt, torch.from_numpy(s), torch.from_numpy(b), eps=1e-6,
                       out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=0, rtol=2 ** -8)


def test_gradient_matches_jax_grad():
    x, s, b = _inputs((20, 16), 2)
    g = np.random.RandomState(3).randn(20, 16).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: fused_layernorm(*a, 1e-6, jnp.float32),
                     *map(jnp.asarray, (x, s, b)))
    want = [np.asarray(w) for w in vjp(jnp.asarray(g))]
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, s, b)]
    twin = torch.autograd.grad(ln.layernorm(*ts, eps=1e-6), ts, torch.from_numpy(g))
    kernel_bwd = ln.layernorm_backward(torch.from_numpy(x), torch.from_numpy(s),
                                       torch.from_numpy(g), 1e-6)
    for got in (twin, kernel_bwd):
        for a, w in zip(got, want):
            np.testing.assert_allclose(a.numpy(), w, atol=1e-5, rtol=1e-5)


def test_module_pallas_impl_matches_jax_module():
    """``LayerNorm(impl='pallas')`` (the kernel's twin on the CPU) against
    JAX ``LayerNorm(1e-6, impl='pallas')`` with the same parameters, as
    tests/test_pallas_layernorm.py holds JAX's against its xla impl; the
    state dict keeps the ALPRO names; an unknown impl raises."""
    x, s, b = _inputs((6, 9, 24), 4)
    jm = JaxLayerNorm(1e-6, impl="pallas")
    want = np.asarray(jm.apply({"params": {"scale": jnp.asarray(s), "bias": jnp.asarray(b)}},
                               jnp.asarray(x)))
    port = LayerNorm(24, 1e-6, impl="pallas")
    port.load_state_dict({"weight": torch.from_numpy(s), "bias": torch.from_numpy(b)})
    n = ln.launches
    got = port(torch.from_numpy(x), torch.float32)
    assert ln.launches == n  # the CPU runs the twin
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="impl"):
        LayerNorm(24, 1e-6, impl="fused")
