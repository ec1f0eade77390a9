"""LN → matmul of the port (alpro_tpu_torch.ops.ln_matmul).

On the CPU: the plain twin against the JAX Pallas kernel function in
interpret mode (alpro_tpu.ops.pallas_ln_mlp.fused_ln_matmul), fp32 within
atol 3e-5 (summation order only) and bf16 within one output ulp, at row
counts that are and are not a multiple of the JAX kernel's 256-row tile. The
CUDA kernel is held against the twin on the card by
tests/test_torch_cuda_kernels.py. The port takes the torch Linear layout
weight (F, D), so it goes in transposed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpro_tpu.ops.pallas_ln_mlp import fused_ln_matmul
from alpro_tpu_torch.ops import ln_matmul


def _inputs(R, D, F, seed):
    rng = np.random.RandomState(seed)
    return dict(
        x=(rng.randn(R, D) * 2).astype(np.float32),
        scale=(1 + 0.1 * rng.randn(D)).astype(np.float32),
        bias=(0.1 * rng.randn(D)).astype(np.float32),
        w=(rng.randn(D, F) * D ** -0.5).astype(np.float32),
        b=(0.1 * rng.randn(F)).astype(np.float32),
    )


def _torch_args(a, dtype):
    dt = getattr(torch, dtype)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    return (t["x"].to(dt), t["scale"], t["bias"], t["w"].t().contiguous().to(dt), t["b"].to(dt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R", [37, 512])
def test_twin_matches_jax_kernel(R, dtype):
    a = _inputs(R, 32, 96, seed=R)
    dt = getattr(jnp, dtype)
    want = np.asarray(fused_ln_matmul(
        jnp.asarray(a["x"], dt), jnp.asarray(a["scale"]), jnp.asarray(a["bias"]),
        jnp.asarray(a["w"], dt), jnp.asarray(a["b"], dt), eps=1e-6), np.float32)
    got = ln_matmul.ln_matmul(*_torch_args(a, dtype), eps=1e-6)
    assert got.dtype == getattr(torch, dtype) and got.shape == (R, 96)
    # bf16: identical operand roundings, the outputs are bf16 (one ulp is
    # 1.6e-2 at |y| ~ 4)
    atol = 3e-5 if dtype == "float32" else 3.2e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


def test_leading_axes_and_cpu_wrapper():
    """(B, T, N, D) rows as the temporal path passes them; the CPU wrapper
    counts no launch and rejects a weight in the JAX layout."""
    a = _inputs(2 * 3 * 5, 32, 96, seed=1)
    args = list(_torch_args(a, "float32"))
    n = ln_matmul.launches
    flat = ln_matmul.ln_matmul(*args, eps=1e-6)
    args[0] = args[0].reshape(2, 3, 5, 32)
    got = ln_matmul.ln_matmul(*args, eps=1e-6)
    assert ln_matmul.launches == n and got.shape == (2, 3, 5, 96)
    torch.testing.assert_close(got.reshape(30, 96), flat, rtol=0, atol=0)
    args[3] = args[3].t()
    with pytest.raises(ValueError, match="shape mismatch"):
        ln_matmul.ln_matmul(*args, eps=1e-6)
