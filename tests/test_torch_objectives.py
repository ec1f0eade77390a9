"""Port VTC / VTM (``alpro_tpu_torch.objectives``) vs alpro_tpu's.

VTC value and gradients, with and without ``stop_gather_grad``, fp32
within 1e-6 absolute and relative (the temperature's gradient is ~55); the VTM loss from logits. The hard-negative sampler cannot draw JAX's
random bits, so it is held to its distribution: never the example itself,
never outside its local block, and at B = 6 the frequencies of 20 000 draws
per row within a chi-square bound of the masked softmax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpro_tpu.objectives.vtc import vtc_loss as jax_vtc
from alpro_tpu.objectives.vtm import vtm_loss_from_logits as jax_vtm
from alpro_tpu_torch.objectives.vtc import vtc_loss
from alpro_tpu_torch.objectives.vtm import sample_hard_negatives, vtm_loss_from_logits


def _feats(B, d, seed):
    rng = np.random.RandomState(seed)
    f = rng.randn(2, B, d).astype(np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


@pytest.mark.parametrize("stop_gather_grad", [False, True])
def test_vtc_value_and_gradients_match_jax(stop_gather_grad):
    vf, tf = _feats(5, 8, 0)
    temp = np.float32(0.07)

    def f(v, t, tmp):
        return jax_vtc(v, t, tmp, stop_gather_grad)[0]

    want, want_g = jax.value_and_grad(f, argnums=(0, 1, 2))(jnp.asarray(vf), jnp.asarray(tf),
                                                            jnp.asarray(temp))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (vf, tf, np.asarray(temp))]
    loss, sim_v2t, sim_t2v = vtc_loss(*ts, stop_gather_grad=stop_gather_grad)
    _, jv2t, jt2v = jax_vtc(jnp.asarray(vf), jnp.asarray(tf), jnp.asarray(temp))
    np.testing.assert_allclose(sim_v2t.detach().numpy(), np.asarray(jv2t), atol=1e-6, rtol=0)
    np.testing.assert_allclose(sim_t2v.detach().numpy(), np.asarray(jt2v), atol=1e-6, rtol=0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), atol=1e-6, rtol=1e-6)
    for t, w in zip(ts, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)


def test_vtm_loss_matches_jax():
    rng = np.random.RandomState(1)
    pos, neg = rng.randn(4, 2).astype(np.float32), rng.randn(8, 2).astype(np.float32)
    loss, logits, labels = vtm_loss_from_logits(torch.from_numpy(pos), torch.from_numpy(neg))
    jloss, jlogits, jlabels = jax_vtm(jnp.asarray(pos), jnp.asarray(neg))
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-6, rtol=0)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=0, rtol=0)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))


def test_sampler_never_self_and_respects_local_blocks():
    B = 8
    sims = torch.from_numpy(np.random.RandomState(2).randn(2, B, B).astype(np.float32) * 3)
    g = torch.Generator().manual_seed(0)
    for blocks in (1, 2, 4):
        for _ in range(200):
            nt, nv = sample_hard_negatives(g, sims[0], sims[1], num_local_blocks=blocks)
            rows = torch.arange(B)
            for idx in (nt, nv):
                assert idx.shape == (B,) and idx.dtype == torch.int64
                assert bool((idx != rows).all())
                assert bool((idx // (B // blocks) == rows // (B // blocks)).all())
    with pytest.raises(ValueError, match="blocks"):
        sample_hard_negatives(g, sims[0], sims[1], num_local_blocks=3)


def test_sampler_distribution_is_the_masked_softmax():
    """B = 6, 20 000 draws: Pearson's chi-square of each row's counts over
    its 5 allowed columns (4 degrees of freedom), summed over the 12 rows of
    both kinds: 48 degrees of freedom, whose 99.99th percentile is 93.2."""
    B, n = 6, 20_000
    sims = np.random.RandomState(3).randn(2, B, B).astype(np.float32) * 1.5
    sv, st = (torch.from_numpy(s) for s in sims)
    g = torch.Generator().manual_seed(1)
    counts = np.zeros((2, B, B))
    rows = np.arange(B)
    for _ in range(n):
        nt, nv = sample_hard_negatives(g, sv, st)
        counts[0, rows, nt.numpy()] += 1
        counts[1, rows, nv.numpy()] += 1
    eye = np.eye(B, dtype=bool)
    assert counts[:, eye].sum() == 0
    logits = sims.astype(np.float64) - np.where(eye, np.inf, 0)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    expected = n * p
    chi2 = float((((counts - expected) ** 2)[:, ~eye] / expected[:, ~eye]).sum())
    assert chi2 < 93.2, chi2
