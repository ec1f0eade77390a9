"""Port TimeSformer (alpro_tpu_torch.models.timesformer) vs alpro_tpu's.

Same weights (the JAX init, exported to the ALPRO key space and loaded into
the port) and the same numpy clips. The JAX side runs the serving kernels
explicitly (attn_impl='fused_qkv', temporal_attn_impl='fused_qkv_fold',
mlp_impl='fused' — what 'auto' gives on a TPU at serving), in Pallas
interpret mode; the port runs the kernels' twins on the CPU. fp32 activations
within atol 2e-4 (docs/PARITY.md:151-170).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpro_tpu.checkpoint.export_torch import export_timesformer
from alpro_tpu.models.timesformer import TimeSformer as JaxTimeSformer
from alpro_tpu.models.timesformer import TimeSformerConfig as JaxCfg
from alpro_tpu_torch.checkpoint.load import load_alpro_state_dict
from alpro_tpu_torch.models.timesformer import TimeSformer, TimeSformerConfig

ATOL = 2e-4
KERNELS = dict(attn_impl="fused_qkv", temporal_attn_impl="fused_qkv_fold", mlp_impl="fused")
PLAIN = dict(attn_impl="xla", temporal_attn_impl="xla", mlp_impl="xla")


def _toy(T):
    return dict(img_size=32, patch_size=16, num_frames=T, embed_dim=32, depth=2,
                num_heads=4)


def _pair(T, impls, port_impls=None):
    """JAX model + params, and the port model with the same weights."""
    jcfg = JaxCfg(**_toy(T), drop_path_rate=0.0, **impls)
    jm = JaxTimeSformer(jcfg)
    params = jm.init({"params": jax.random.PRNGKey(T)},
                     jnp.zeros((1, T, 32, 32, 3), jnp.float32))
    # randomize LN params and biases too (the JAX init leaves them at 1/0)
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.RandomState(T)
    leaves = [np.asarray(l) + 0.05 * rng.randn(*np.shape(l)).astype(np.float32)
              for l in leaves]
    params = jax.tree.unflatten(tree, [jnp.asarray(l) for l in leaves])
    port = TimeSformer(TimeSformerConfig(**_toy(T), **(port_impls or impls)))
    load_alpro_state_dict(port, export_timesformer(params["params"], prefix=""))
    return jm, params, port


def _run(jm, params, port, x):
    want = np.asarray(jm.apply(params, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(np.asarray(x))).float().numpy()
    return got, want


def _clips(B, T, seed, form):
    rng = np.random.RandomState(seed)
    raw = rng.randint(0, 256, (B, T, 32, 32, 3)).astype(np.uint8)
    if form == "raw_uint8":
        return raw
    if form == "float":
        mean, std = np.array(JaxCfg.pixel_mean), np.array(JaxCfg.pixel_std)
        return ((raw / 255.0 - mean) / std).astype(np.float32)
    # pre-patchified uint8 (B, T, N, p·p·3), (ph, pw, c) column order
    p = 16
    v = raw.reshape(B, T, 2, p, 2, p, 3).transpose(0, 1, 2, 4, 3, 5, 6)
    return np.ascontiguousarray(v.reshape(B, T, 4, p * p * 3))


@pytest.mark.parametrize("T", [2, 4])
@pytest.mark.parametrize("form", ["raw_uint8", "float", "patchified_uint8"])
def test_kernel_path_matches_jax(T, form):
    jm, params, port = _pair(T, KERNELS)
    x = _clips(2, T, seed=T, form=form)
    got, want = _run(jm, params, port, x)
    assert got.shape == (2, 1 + 4, 32)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("T", [2, 4])
def test_plain_path_matches_jax_xla_path(T):
    jm, params, port = _pair(T, PLAIN, port_impls=dict(
        attn_impl="plain", temporal_attn_impl="plain", mlp_impl="plain"))
    got, want = _run(jm, params, port, _clips(2, T, seed=10 + T, form="raw_uint8"))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_auto_is_plain_on_cpu():
    """'auto' on a CPU tensor takes the plain path, and the kernel twins give
    the same tokens as the plain path."""
    _, _, port = _pair(2, KERNELS)
    x = torch.from_numpy(_clips(2, 2, seed=3, form="raw_uint8"))
    with torch.no_grad():
        kern = port(x)
        port.cfg = TimeSformerConfig(**_toy(2))  # auto
        auto = port(x)
        port.cfg = TimeSformerConfig(**_toy(2), **PLAIN)
        plain = port(x)
    torch.testing.assert_close(auto, plain, rtol=0, atol=0)
    np.testing.assert_allclose(kern.numpy(), plain.numpy(), atol=ATOL, rtol=0)


def test_resized_pos_and_time_embeds_match_jax():
    """48x48 frames (3x3 patches vs the trained 2x2) and T=3 vs 2 frames:
    nearest-resized position and time embeddings."""
    jm, params, port = _pair(2, KERNELS)
    x = np.random.RandomState(5).randint(0, 256, (1, 3, 48, 48, 3)).astype(np.uint8)
    got, want = _run(jm, params, port, x)
    assert got.shape == (1, 1 + 9, 32)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_bf16_fold_matches_jax():
    """bf16 compute folds the uint8 normalize into the patch embed on both
    sides; activations agree to a few bf16 ulps after two blocks."""
    jcfg = JaxCfg(**_toy(2), drop_path_rate=0.0, **KERNELS)
    jm = JaxTimeSformer(jcfg, dtype=jnp.bfloat16)
    params = jm.init({"params": jax.random.PRNGKey(0)},
                     jnp.zeros((1, 2, 32, 32, 3), jnp.float32))
    port = TimeSformer(TimeSformerConfig(**_toy(2), **KERNELS), dtype=torch.bfloat16)
    load_alpro_state_dict(port, export_timesformer(params["params"], prefix=""))
    got, want = _run(jm, params, port, _clips(2, 2, seed=7, form="raw_uint8"))
    np.testing.assert_allclose(got, want, atol=6e-2, rtol=0)


def test_temporal_fused_qkv_matches_jax():
    """temporal_attn_impl='fused_qkv' (JAX TemporalNativeLayoutAttention: the
    temporal kernel between the unfolded proj and temporal_fc) loads from
    the JAX config's values and matches JAX in eval."""
    impls = dict(attn_impl="fused_qkv", temporal_attn_impl="fused_qkv", mlp_impl="xla")
    jm, params, port = _pair(3, impls)
    got, want = _run(jm, params, port, _clips(2, 3, seed=11, form="raw_uint8"))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_config_rejects_unknown_impl():
    """A value no package accepts raises; JAX's opt-in serving forms
    ``cls_sideband`` and ``fused_qkv_proj`` are taken."""
    for field in ("attn_impl", "temporal_attn_impl", "mlp_impl"):
        with pytest.raises(ValueError):
            TimeSformerConfig(**{field: "bogus"})
    with pytest.raises(ValueError):
        TimeSformerConfig(temporal_attn_impl="cls_sideband")
    TimeSformerConfig(attn_impl="cls_sideband")
    TimeSformerConfig(attn_impl="fused_qkv_proj", temporal_attn_impl="fused_qkv_proj")
