"""The whole attention sublayer in one kernel (alpro_tpu_torch.ops.
block_attn, B17) against alpro_tpu.ops.pallas_block_attn, on the CPU.

The wrapper runs its twin on a CPU tensor; the JAX kernel runs in interpret
mode, as tests/test_block_attn.py runs it, at its shapes and tolerances:
fp32, atol 2e-5 forward (unmasked and with a key mask), 1e-4 for the
gradients of x, the qkv weight and bias and the projection weight and bias.
The contract reference ``fused_attention_block_reference`` (the JAX
``_kernel`` body in plain torch) against the JAX kernel in fp32 (2e-5) and
bf16 (4e-3, one bf16 ulp of these outputs, under 0.5: p, v, the per-head
output and the result round to bf16 in both, and a sum taken in another
order may put a value on the other side of a rounding).
Then B17 against the port's ``Attention`` module on the weights of a JAX
``VitAttention`` (2e-5), which is what ties B17 to the model. The JAX
function takes (D, 3D) and (D, D) kernels; the port takes torch Linear
layout, so they go in transposed. The CUDA kernel is held against the twin
on the card by tests/test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpro_tpu.ops.pallas_block_attn import _xla_reference, fused_attention_block as jax_block
from alpro_tpu_torch.models.timesformer import Attention
from alpro_tpu_torch.ops import block_attn


def _mk(B=2, S=17, D=32, seed=0):
    """x, qkv kernel (D, 3D), qkv bias, proj kernel (D, D), proj bias: JAX
    layout (tests/test_block_attn.py's draws)."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, D).astype(np.float32),
            (rng.randn(D, 3 * D) * 0.1).astype(np.float32),
            (rng.randn(3 * D) * 0.01).astype(np.float32),
            (rng.randn(D, D) * 0.1).astype(np.float32),
            (rng.randn(D) * 0.01).astype(np.float32))


def _port(ws):
    """The same arrays as torch tensors, the kernels transposed."""
    x, qk, qb, pk, pb = (torch.from_numpy(a) for a in ws)
    return x, qk.t().contiguous(), qb, pk.t().contiguous(), pb


def _mask():
    mask = np.ones((2, 17), np.int32)
    mask[0, 9:] = 0
    mask[1, 4:] = 0
    return mask


@pytest.mark.parametrize("masked", [False, True])
def test_matches_jax_kernel(masked):
    ws = _mk(seed=int(masked))
    mask = _mask() if masked else None
    want = jax_block(*map(jnp.asarray, ws), 4, None if mask is None else jnp.asarray(mask))
    n = block_attn.launches
    got = block_attn.fused_attention_block(*_port(ws), 4,
                                           None if mask is None else torch.from_numpy(mask))
    assert block_attn.launches == n  # the twin on a CPU tensor
    assert got.shape == (2, 17, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    np.testing.assert_allclose(
        block_attn.fused_attention_block_plain(*_port(ws), 4, None if mask is None
                                               else torch.from_numpy(mask)).numpy(),
        np.asarray(_xla_reference(*map(jnp.asarray, ws), 4, None if mask is None
                                  else jnp.asarray(mask))), atol=2e-5, rtol=0)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-5), ("bfloat16", 4e-3)])
@pytest.mark.parametrize("masked", [False, True])
def test_contract_reference_matches_jax_kernel(masked, dtype, tol):
    """The reference the CUDA kernel is held to on the card (q and k never
    rounded) is the JAX kernel's own arithmetic."""
    ws = _mk(seed=4 + int(masked))
    mask = _mask() if masked else None
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx = jnp.asarray(ws[0]).astype(jdt)
    jw = [jnp.asarray(w) for w in ws[1:]]
    want = jax_block(jx, jw[0].astype(jdt), jw[1], jw[2].astype(jdt), jw[3], 4,
                     None if mask is None else jnp.asarray(mask))
    x, qk, qb, pk, pb = _port(ws)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    got = block_attn.fused_attention_block_reference(
        x.to(tdt), qk.to(tdt), qb, pk.to(tdt), pb, 4,
        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == tdt and got.shape == (2, 17, 32)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=0)
    # evaluated in query chunks, as the card test at long S does
    chunked = block_attn.fused_attention_block_reference(
        x.to(tdt), qk.to(tdt), qb, pk.to(tdt), pb, 4,
        None if mask is None else torch.from_numpy(mask), query_chunk=5)
    np.testing.assert_allclose(chunked.float().numpy(), got.float().numpy(), atol=tol, rtol=0)


def test_gradients_match_jax():
    """All five gradients (x, qkv weight and bias, proj weight and bias)."""
    ws = _mk(B=1, S=9, D=16, seed=2)

    def loss(*args):
        return jnp.sum(jax_block(*args, 2) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, ws))
    ins = [t.requires_grad_(True) for t in _port(ws)]
    got = torch.autograd.grad((block_attn.fused_attention_block(*ins, 2) ** 2).sum(), ins)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        if i in (1, 3):  # the port's weights are the transposes
            w = w.T
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=0)


def test_matches_port_attention_module():
    """B17 computes the port's ``Attention`` (qkv → attention → proj) with its
    own weights, carried over from a JAX ``VitAttention``; both match JAX."""
    from alpro_tpu.models.timesformer import VitAttention

    rng = np.random.RandomState(3)
    B, S, D, H = 2, 11, 24, 4
    x = rng.randn(B, S, D).astype(np.float32)
    attn = VitAttention(H, attn_impl="xla")
    params = attn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(attn.apply(params, jnp.asarray(x)))
    p = params["params"]
    mod = Attention(D)
    with torch.no_grad():
        for name in ("qkv", "proj"):
            getattr(mod, name).weight.copy_(torch.from_numpy(np.array(p[name]["kernel"]).T))
            getattr(mod, name).bias.copy_(torch.from_numpy(np.array(p[name]["bias"])))
        xt = torch.from_numpy(x)
        module = mod.plain(xt, H, torch.float32)
        got = block_attn.fused_attention_block(xt, mod.qkv.weight, mod.qkv.bias,
                                               mod.proj.weight, mod.proj.bias, H)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), module.numpy(), atol=2e-5, rtol=0)


def test_wrapper_checks_shapes_and_limits():
    x, qk, qb, pk, pb = _port(_mk())
    with pytest.raises(ValueError, match="weight shapes"):
        block_attn.fused_attention_block(x, qk.t(), qb, pk, pb, 4)  # JAX (D, 3D) layout
    with pytest.raises(ValueError, match="key_mask"):
        block_attn.fused_attention_block(x, qk, qb, pk, pb, 4, torch.ones(2, 16))
    # the kernel's limits, given an H100's 227 KB of opt-in shared memory
    smem = 232448
    assert block_attn.max_seq(torch.bfloat16, smem) == 4096
    assert block_attn.max_seq(torch.float32, smem) == 192
    assert block_attn.fits(64, 197, 768, 12, torch.bfloat16, smem)
    assert block_attn.fits(64, 257, 768, 12, torch.bfloat16, smem)
    assert not block_attn.fits(64, 4097, 768, 12, torch.bfloat16, smem)
    assert not block_attn.fits(64, 197, 768, 16, torch.bfloat16, smem)  # head_dim 48
    assert not block_attn.fits(2, 17, 32, 4, torch.float32, smem)  # the CPU tests' toy width
    assert block_attn.max_seq(torch.bfloat16, 100_000) < 197
