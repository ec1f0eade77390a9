"""Port masked attention (``alpro_tpu_torch.ops.masked_attn``) vs alpro_tpu's
``pallas_attn`` kernels, and the attention front door (``ops/attention.py``).

Same numpy inputs through ``fused_attention`` (B, H, S, hd) and
``fused_attention_bshd`` (B, S, H·hd) of both packages; the JAX kernels run
in Pallas interpret mode, the port's wrappers their plain twin on the CPU.
Ragged lengths (Sq 17, Sk 23), with and without a key mask. Tolerances:
fp32 atol 1e-5 (summation order); bf16 atol 2e-2 (a few bf16 ulps of outputs
of magnitude ~1, from p rounded to bf16 before P·V on both sides);
gradients against ``jax.grad`` through the JAX custom_vjp, fp32, atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpro_tpu.ops import attention as jax_attention
from alpro_tpu.ops.pallas_attn import fused_attention as jax_fa
from alpro_tpu.ops.pallas_attn import fused_attention_bshd as jax_fab
from alpro_tpu_torch.ops import masked_attn
from alpro_tpu_torch.ops.attention import multi_head_attention, multi_head_attention_bshd

B, H, HD, SQ, SK = 2, 2, 16, 17, 23
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(layout, masked, seed=0):
    rng = np.random.RandomState(seed)
    shape = {"bhsd": lambda s: (B, H, s, HD), "bshd": lambda s: (B, s, H * HD)}[layout]
    q, k, v = (rng.randn(*shape(s)).astype(np.float32) for s in (SQ, SK, SK))
    mask = None
    if masked:
        mask = np.ones((B, SK), np.int32)
        mask[0, 15:] = 0
        mask[1, 5:] = 0
    return q, k, v, mask


def _jax(layout, q, k, v, mask, dtype):
    args = [jnp.asarray(t, dtype) for t in (q, k, v)]
    km = None if mask is None else jnp.asarray(mask)
    if layout == "bhsd":
        return jax_fa(*args, key_mask=km)
    return jax_fab(*args, H, key_mask=km)


def _port(layout, q, k, v, mask, dtype):
    args = [torch.from_numpy(t).to(dtype) for t in (q, k, v)]
    km = None if mask is None else torch.from_numpy(mask)
    if layout == "bhsd":
        return masked_attn.fused_attention(*args, key_mask=km)
    return masked_attn.fused_attention_bshd(*args, H, key_mask=km)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_twin_matches_jax_kernel(layout, masked, dtype):
    q, k, v, mask = _inputs(layout, masked)
    want = np.asarray(_jax(layout, q, k, v, mask, getattr(jnp, dtype)).astype(jnp.float32))
    got = _port(layout, q, k, v, mask, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_gradients_match_jax_custom_vjp(layout, masked):
    q, k, v, mask = _inputs(layout, masked, seed=1)
    g = np.random.RandomState(2).randn(*q.shape).astype(np.float32)

    def loss(q_, k_, v_):
        return jnp.sum(_jax(layout, q_, k_, v_, mask, jnp.float32) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    km = None if mask is None else torch.from_numpy(mask)
    out = (masked_attn.fused_attention(*ts, key_mask=km) if layout == "bhsd"
           else masked_attn.fused_attention_bshd(*ts, H, key_mask=km))
    out.backward(torch.from_numpy(g))
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4, rtol=0)


def test_backward_is_the_jax_recompute_not_the_twins_autograd():
    """The custom op's backward gives the fp32 recompute of ``_fab_bwd``; in
    fp32 it agrees with autograd through the twin to rounding."""
    q, k, v, mask = _inputs("bshd", True, seed=3)
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = masked_attn.fused_attention_bshd(*ts, H, key_mask=torch.from_numpy(mask))
    assert out.grad_fn is not None and "masked_attention" in type(out.grad_fn).__name__
    g = torch.ones_like(out)
    grads = torch.autograd.grad(out, ts, g)
    heads = [t.detach().unflatten(-1, (H, HD)).transpose(1, 2).requires_grad_(True) for t in ts]
    bias = masked_attn.key_bias(torch.from_numpy(mask), B, SK, "cpu")
    ref = masked_attn.attention_plain(*heads, bias, HD ** -0.5)
    ref_grads = torch.autograd.grad(ref, heads, g.unflatten(-1, (H, HD)).transpose(1, 2))
    for got, want in zip(grads, ref_grads):
        torch.testing.assert_close(got, want.transpose(1, 2).flatten(2), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_front_door_impls_match_jax(masked):
    """``multi_head_attention{,_bshd}`` with impl 'xla' and 'pallas' against
    the JAX functions of the same names, fp32."""
    q, k, v, mask = _inputs("bhsd", masked, seed=4)
    km_j = None if mask is None else jnp.asarray(mask)
    km_t = None if mask is None else torch.from_numpy(mask)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    for impl in ("xla", "pallas"):
        want = jax_attention.multi_head_attention(*map(jnp.asarray, (q, k, v)), key_mask=km_j,
                                                  impl=impl)
        got = multi_head_attention(tq, tk, tv, key_mask=km_t, impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        sw = [np.ascontiguousarray(t.transpose(0, 2, 1, 3)) for t in (q, k, v)]
        want = jax_attention.multi_head_attention_bshd(*map(jnp.asarray, sw), key_mask=km_j,
                                                       impl=impl)
        got = multi_head_attention_bshd(*(torch.from_numpy(t) for t in sw), key_mask=km_t,
                                        impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_attention_dropout_plain_only():
    """In training the plain attention drops probabilities with masks from
    the generator (same seed, same output); 'pallas' ignores the rate, as the
    JAX pallas branch does; outside training the rate does nothing."""
    q, k, v, _ = _inputs("bhsd", False, seed=5)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))

    def run(impl, training, seed=0):
        return multi_head_attention(tq, tk, tv, impl=impl, dropout_rate=0.5, training=training,
                                    generator=torch.Generator().manual_seed(seed))

    base = multi_head_attention(tq, tk, tv)
    torch.testing.assert_close(run("xla", True), run("xla", True), rtol=0, atol=0)
    assert (run("xla", True) - base).abs().max() > 1e-2
    assert (run("xla", True) - run("xla", True, seed=1)).abs().max() > 1e-2
    torch.testing.assert_close(run("xla", False), base, rtol=0, atol=0)
    torch.testing.assert_close(run("pallas", True), masked_attn.fused_attention(tq, tk, tv),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="generator"):
        multi_head_attention(tq, tk, tv, dropout_rate=0.1, training=True)
    with pytest.raises(ValueError, match="impl"):
        multi_head_attention(tq, tk, tv, impl="flash")


def test_packed_qkv_views_read_in_place():
    """Views of a packed (B, S, 3D) projection give what contiguous copies
    give, and the CPU path counts no kernel launch."""
    x = torch.from_numpy(np.random.RandomState(6).randn(B, SQ, 3 * H * HD).astype(np.float32))
    D = H * HD
    n = (masked_attn.bshd_launches, masked_attn.bhsd_launches)
    views = masked_attn.fused_attention_bshd(x[..., :D], x[..., D:2 * D], x[..., 2 * D:], H)
    copies = masked_attn.fused_attention_bshd(
        *(x[..., i * D:(i + 1) * D].contiguous() for i in range(3)), H)
    torch.testing.assert_close(views, copies, rtol=0, atol=0)
    assert (masked_attn.bshd_launches, masked_attn.bhsd_launches) == n
    with pytest.raises(ValueError, match="key_mask"):
        masked_attn.fused_attention_bshd(x[..., :D], x[..., D:2 * D], x[..., 2 * D:], H,
                                         key_mask=torch.ones(B, SQ + 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_twin_matches_jax_kernel_past_a_chunk(layout, dtype):
    """Sq 40, Sk 300: past the kernel's one-pass chunk of 256 keys, with a
    masked tail and a fully masked sequence (every key's bias -10000), so the
    twin that holds the card's kernel is pinned where the kernel walks its
    keys twice."""
    rng = np.random.RandomState(7)
    sq, sk = 40, 300
    shape = {"bhsd": lambda s: (B, H, s, HD), "bshd": lambda s: (B, s, H * HD)}[layout]
    q, k, v = (rng.randn(*shape(s)).astype(np.float32) for s in (sq, sk, sk))
    mask = np.ones((B, sk), np.int32)
    mask[0, 263:] = 0
    mask[1, :] = 0
    want = np.asarray(_jax(layout, q, k, v, mask, getattr(jnp, dtype)).astype(jnp.float32))
    got = _port(layout, q, k, v, mask, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype], rtol=0)
