"""Raw-frame patch embed of the port (alpro_tpu_torch.ops.preprocess).

On the CPU: the plain twin against the JAX Pallas kernel function in
interpret mode (alpro_tpu.ops.pallas_preprocess.fused_patchify_embed), fp32
within atol 3e-5, at 32² and 48² frames; its backward against ``jax.grad``
of the JAX function (the same recompute, summation order only); the port's
TimeSformer with ``fused_patchify='on'`` and the default impls against JAX's
(atol 2e-4, tests/test_torch_timesformer.py); and one retrieval train step
with ``fused_patchify='on'`` against the JAX step (loss and every gradient,
the patch embedding's among them; tests/test_torch_train_step.py). The CUDA
kernel is held against the twin on the card by
tests/test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpro_tpu.models.timesformer import TimeSformerConfig as JaxCfg
from alpro_tpu.ops.pallas_preprocess import fused_patchify_embed
from alpro_tpu.train import step as jax_step
from alpro_tpu_torch.ops import preprocess
from alpro_tpu_torch.train.step import make_retrieval_train_step
from test_torch_timesformer import ATOL, _clips, _pair, _run
from test_torch_train_step import _batch, _check, _models, _run_both

MEAN, STD = JaxCfg.pixel_mean, JaxCfg.pixel_std
K, D = 16 * 16 * 3, 32


def _inputs(side, seed, frames=2):
    rng = np.random.RandomState(seed)
    raw = rng.randint(0, 256, (2, frames, side, side, 3)).astype(np.uint8)
    return (raw, (rng.randn(K, D) * 0.05).astype(np.float32),
            (rng.randn(D) * 0.01).astype(np.float32))


@pytest.mark.parametrize("side", [32, 48])
def test_twin_matches_jax_kernel(side):
    raw, kernel, bias = _inputs(side, seed=side)
    want = np.asarray(fused_patchify_embed(jnp.asarray(raw), jnp.asarray(kernel),
                                           jnp.asarray(bias), MEAN, STD))
    n = preprocess.launches
    got = preprocess.patchify_embed(torch.from_numpy(raw), torch.from_numpy(kernel),
                                    torch.from_numpy(bias), MEAN, STD)
    assert preprocess.launches == n
    assert got.shape == (2, 2, (side // 16) ** 2, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=0)


def test_backward_matches_jax_grad():
    raw, kernel, bias = _inputs(48, seed=3)
    gk_j, gb_j = jax.grad(
        lambda k, b: jnp.sum(fused_patchify_embed(jnp.asarray(raw), k, b, MEAN, STD) ** 2),
        argnums=(0, 1))(jnp.asarray(kernel), jnp.asarray(bias))
    k = torch.from_numpy(kernel).requires_grad_(True)
    b = torch.from_numpy(bias).requires_grad_(True)
    out = preprocess.patchify_embed(torch.from_numpy(raw), k, b, MEAN, STD)
    gk, gb = torch.autograd.grad((out ** 2).sum(), (k, b))
    np.testing.assert_allclose(gk.numpy(), np.asarray(gk_j), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(gb.numpy(), np.asarray(gb_j), rtol=1e-5, atol=1e-4)


def test_rejects_what_it_does_not_take():
    raw, kernel, bias = _inputs(32, seed=0)
    with pytest.raises(ValueError, match="uint8"):
        preprocess.patchify_embed(torch.zeros(2, 2, 32, 32, 3), torch.from_numpy(kernel),
                                  torch.from_numpy(bias), MEAN, STD)
    with pytest.raises(ValueError, match="p·p·C"):
        preprocess.patchify_embed(torch.from_numpy(raw), torch.zeros(700, D), torch.zeros(D),
                                  MEAN, STD)


def test_model_fused_patchify_matches_jax():
    """Path (c): the raw-frame patch embed with the default impls; the
    pre-patchified form never takes it."""
    jm, params, port = _pair(2, dict(fused_patchify="on"))
    got, want = _run(jm, params, port, _clips(2, 2, seed=30, form="raw_uint8"))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    n = preprocess.launches
    x = torch.from_numpy(_clips(2, 2, seed=30, form="patchified_uint8"))
    with torch.no_grad():
        pre = port(x).numpy()
    np.testing.assert_allclose(pre, want, atol=ATOL, rtol=0)
    assert preprocess.launches == n


def test_retrieval_step_with_fused_patchify_matches_jax():
    jm, params, port = _models("xla", vis_impls=dict(attn_impl="xla", fused_patchify="on"))
    _check(*_run_both(jm, params, port,
                      lambda m, tx: jax_step.make_retrieval_train_step(m, tx),
                      make_retrieval_train_step, _batch(2, seed=4)))
