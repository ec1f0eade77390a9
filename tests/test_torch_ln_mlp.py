"""Fused LN→MLP→residual of the port (alpro_tpu_torch.ops.ln_mlp).

On the CPU: the plain twin against the JAX Pallas kernel function in
interpret mode (alpro_tpu.ops.pallas_ln_mlp.fused_ln_mlp), fp32 and bf16,
with and without the residual, including R = B cls rows. The CUDA kernel is
held against the twin on the card by tests/test_torch_cuda_kernels.py.
The port takes torch Linear layout weights, so w1/w2 go in transposed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpro_tpu.ops.pallas_ln_mlp import fused_ln_mlp
from alpro_tpu_torch.ops import ln_mlp


def _inputs(R, D, Dh, seed):
    rng = np.random.RandomState(seed)
    return dict(
        x=(rng.randn(R, D) * 2).astype(np.float32),
        scale=(1 + 0.1 * rng.randn(D)).astype(np.float32),
        bias=(0.1 * rng.randn(D)).astype(np.float32),
        w1=(rng.randn(D, Dh) * D ** -0.5).astype(np.float32),
        b1=(0.1 * rng.randn(Dh)).astype(np.float32),
        w2=(rng.randn(Dh, D) * Dh ** -0.5).astype(np.float32),
        b2=(0.1 * rng.randn(D)).astype(np.float32),
    )


def _jax(a, dtype, residual):
    dt = getattr(jnp, dtype)
    out = fused_ln_mlp(
        jnp.asarray(a["x"], dt), jnp.asarray(a["scale"]), jnp.asarray(a["bias"]),
        jnp.asarray(a["w1"], dt), jnp.asarray(a["b1"], dt),
        jnp.asarray(a["w2"], dt), jnp.asarray(a["b2"], dt),
        eps=1e-6, residual=residual,
    )
    return np.asarray(out, np.float32)


def _torch_args(a, dtype, device="cpu"):
    dt = getattr(torch, dtype)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    return (t["x"].to(device, dt), t["scale"].to(device), t["bias"].to(device),
            t["w1"].t().contiguous().to(device, dt), t["b1"].to(device, dt),
            t["w2"].t().contiguous().to(device, dt), t["b2"].to(device, dt))


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R", [2, 37])
def test_twin_matches_jax_kernel(R, dtype, residual):
    a = _inputs(R, 32, 128, seed=R)
    want = _jax(a, dtype, residual)
    got = ln_mlp.ln_mlp(*_torch_args(a, dtype), eps=1e-6, residual=residual)
    assert got.dtype == getattr(torch, dtype) and got.shape == (R, 32)
    # fp32: summation order only. bf16: identical operand roundings, the
    # outputs are bf16 (one ulp is 1.6e-2 at |y| ~ 4)
    atol = 2e-5 if dtype == "float32" else 3.2e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


def test_cpu_wrapper_does_not_count():
    a = _inputs(4, 32, 64, seed=0)
    n = ln_mlp.launches
    ln_mlp.ln_mlp(*_torch_args(a, "float32"), eps=1e-6)
    assert ln_mlp.launches == n


def test_wrapper_rejects_mismatched_weights():
    args = list(_torch_args(_inputs(4, 32, 64, seed=0), "float32"))
    args[3] = args[3].t()  # (D, Dh) instead of torch layout (Dh, D)
    with pytest.raises(ValueError):
        ln_mlp.ln_mlp(*args, eps=1e-6)


@pytest.mark.parametrize("R,want", [(12544, 3072), (3136, 1536), (45, 128), (2, 128)])
def test_hidden_split_fills_the_sms(R, want):
    """Row tiles of 32 fill 132 SMs at R=12544 (no split); fewer row tiles
    split the 24 hidden chunks of 128 across blocks."""
    assert ln_mlp.hidden_split(R, 3072, 132) == want


@pytest.mark.parametrize("R,post_ln,splits", [
    (3136, False, 1), (2, False, 24), (12544, False, 1), (8, False, 24),  # K3, phase 3
    (40, True, 24), (320, True, 12), (1896, True, 2), (3792, True, 1),  # K5, phase 3
    (128, False, 24), (129, True, 16)])
def test_bf16_plan_fills_the_sms(R, post_ln, splits):
    """The bf16 plan on 132 SMs: fc2's 128 x 128 output tiles times the
    slices of its hidden (64-column multiples covering Dh) fit one wave of
    two CTAs an SM; K3 in one slice rounds into the output (no partials),
    K5 always sums fp32 partials before its LN."""
    D, Dh = 768, 3072
    plan = ln_mlp.bf16_plan(R, D, Dh, 132, post_ln)
    assert plan.splits == splits
    assert plan.h_split % 64 == 0 and (splits - 1) * plan.h_split < Dh <= splits * plan.h_split
    tiles = -(-R // 128) * (D // 128)
    assert tiles * splits <= max(tiles, 2 * 132)
    assert plan.hidden == (R, Dh)
    assert plan.normed == (None if post_ln else (R, D))
    assert plan.partial == (None if splits == 1 and not post_ln else (splits, R, D))


@pytest.mark.parametrize("D,dtype,fits", [
    (768, torch.bfloat16, True), (1024, torch.bfloat16, True), (768, torch.float32, True),
    (1024, torch.float32, False), (384, torch.bfloat16, False)])
def test_fits_keeps_fp32_inside_shared_memory(D, dtype, fits):
    """bf16 takes the four widths; fp32's row kernel, whose shared memory
    (32 x D tile + 32 x 132 fp32 hidden chunk + 32 x 132 GELU chunk + 128 x
    132 weight tile, 4 bytes each) is 232,960 bytes at D = 1024 against a
    Hopper block's 232,448, stops at 768, so `auto` takes the plain path
    there."""
    assert 4 * (32 * (1024 + 4) + 2 * 32 * 132 + 128 * 132) == 232960
    assert ln_mlp.ln_mlp_fits(D, 4 * D, dtype) == fits
