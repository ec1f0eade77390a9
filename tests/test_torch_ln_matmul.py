"""LN → matmul of the port (alpro_tpu_torch.ops.ln_matmul).

On the CPU: the plain twin against the JAX Pallas kernel function in
interpret mode (alpro_tpu.ops.pallas_ln_mlp.fused_ln_matmul), fp32 within
atol 3e-5 (summation order only) and bf16 within one output ulp, at row
counts that are and are not a multiple of the JAX kernel's 256-row tile. The
CUDA kernel is held against the twin on the card by
tests/test_torch_cuda_kernels.py. The port takes the torch Linear layout
weight (F, D), so it goes in transposed.

The host-side plan of the bf16 route (the LN rows, then the TMA/``wgmma``
GEMM): its limits (``fits``: D a multiple of 64 up to 1024, F of 128; fp32
keeps its row tile's D % 128 and F % 768), and, with the launch replaced
by a recorder and a CUDA stand-in for the tensors, that the wrapper hands
the layer's bf16 vectors over without a cast (fp32 ones as fp32) and
raises past a limit before a launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpro_tpu.ops.pallas_ln_mlp import fused_ln_matmul
from alpro_tpu_torch.ops import _build, ln_matmul
from test_torch_fused_block_plan import _StandIn

BF16, F32 = torch.bfloat16, torch.float32


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


@pytest.mark.parametrize("fits,D,F,dtype", [
    (True, 768, 2304, BF16), (True, 768, 896, BF16), (True, 768, 128, BF16),
    (False, 768, 2368, BF16), (False, 768, 64, BF16), (True, 64, 128, BF16),
    (True, 1024, 3072, BF16), (False, 1088, 3264, BF16), (False, 32, 96, BF16),
    (True, 768, 2304, F32), (False, 768, 896, F32), (False, 64, 768, F32),
    (False, 768, 2304, torch.float16)])
def test_fits(fits, D, F, dtype):
    """bf16: the GEMM's K chunk (D % 64) and column tile (F % 128), the LN
    rows' D <= 1024 — F = 896 is taken, 2368 and 64 are not; fp32: the row
    tile's D % 128 and passes of 768 columns."""
    assert ln_matmul.fits(D, F, dtype) is fits


class _Rows(_StandIn):
    def numel(self):
        return self.t.numel()


@pytest.fixture
def recorded(monkeypatch):
    """The launch replaced by a recorder of what it was handed; operand
    checks off."""
    calls = []
    monkeypatch.setattr(ln_matmul, "_launch", lambda *a: calls.append(a))
    monkeypatch.setattr(_build, "check_cuda_operand", lambda *a, **k: None)
    return calls


def _operands(R, D, F, dtype, vec_dtype):
    x, w = _Rows(torch.zeros(R, D, dtype=dtype)), _Rows(torch.zeros(F, D, dtype=dtype))
    return x, w, [_Rows(torch.zeros(n, dtype=vec_dtype)) for n in (D, D, F)]


@pytest.mark.parametrize("x_dtype,vec_dtype", [(BF16, BF16), (BF16, F32), (F32, F32),
                                               (F32, BF16)])
def test_hands_vectors_over(recorded, x_dtype, vec_dtype):
    """bf16 x with bf16 vectors: the very tensors reach the launch (the
    kernel widens them on load: no cast launch), vec_bf16 1; otherwise fp32
    vectors, vec_bf16 0."""
    x, w, vecs = _operands(45, 768, 2304, x_dtype, vec_dtype)
    ln_matmul.ln_matmul(x, vecs[0], vecs[1], w, vecs[2], eps=1e-6)
    (got,) = recorded
    assert got[0] is x and got[3] is w and got[4] == 1e-6
    as_is = x_dtype == vec_dtype == BF16
    assert got[2] == int(as_is)
    if as_is:
        assert all(a is b for a, b in zip(got[1], vecs))
    else:
        assert all(v.dtype == F32 for v in got[1])


@pytest.mark.parametrize("dtype,D,F", [(BF16, 768, 2368), (BF16, 1088, 1152), (BF16, 96, 128),
                                       (F32, 768, 896)])
def test_past_a_limit_raises_before_a_launch(recorded, dtype, D, F):
    x, w, vecs = _operands(12608, D, F, dtype, dtype)
    with pytest.raises(ValueError, match=f"for {dtype}, D %"):
        ln_matmul.ln_matmul(x, vecs[0], vecs[1], w, vecs[2], eps=1e-6)
    assert recorded == []
