"""The CLS-sideband spatial attention (B6) and the attention + projection
kernels (B7, B8) of the port (alpro_tpu_torch.ops.qkv_attn), and its
TimeSformer under the opt-in serving forms that reach them.

On the CPU: each plain twin against the JAX Pallas kernel function in
interpret mode (alpro_tpu.ops.pallas_qkv_attn), fp32, at the JAX tests' own
tolerances (tests/test_qkv_attn.py: 1e-5 for B6, 2e-5 for B7 and B8); then
the port's TimeSformer against JAX's on the same weights and raw uint8 clips,
atol 2e-4 (tests/test_torch_timesformer.py), under path (c) —
``attn_impl='cls_sideband'``, the default temporal kernel and MLP tail — and
path (d) — ``fused_qkv_proj`` on both axes, fused MLP tail; path (d) in bf16
too; and the training mapping of both values. The CUDA kernels are held
against the twins on the card by tests/test_torch_cuda_kernels.py. The port
takes torch Linear layout weights, so the projections go in transposed.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpro_tpu.ops.pallas_qkv_attn import (
    fused_attention_qkv_cls,
    fused_attention_qkv_proj,
    fused_temporal_attention_qkv_proj,
)
from alpro_tpu_torch.models.timesformer import TimeSformerConfig
from alpro_tpu_torch.ops import qkv_attn
from test_torch_timesformer import ATOL, _clips, _pair, _run, _toy

PATH_C = dict(attn_impl="cls_sideband", temporal_attn_impl="fused_qkv_fold", mlp_impl="fused")
PATH_D = dict(attn_impl="fused_qkv_proj", temporal_attn_impl="fused_qkv_proj", mlp_impl="fused")


def _arrays(rng, *shapes, std=1.0):
    return [(std * rng.randn(*s)).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("B,T,N,H,hd", [(2, 3, 10, 2, 8), (1, 4, 5, 3, 16), (1, 2, 256, 2, 8),
                                         (1, 2, 576, 2, 8)])
def test_cls_twin_matches_jax_kernel(B, T, N, H, hd):
    D = H * hd
    qx, qc = _arrays(np.random.RandomState(T), (B * T, N, 3 * D), (B, 1, 3 * D))
    want_x, want_c = fused_attention_qkv_cls(jnp.asarray(qx), jnp.asarray(qc), H, T)
    got_x, got_c = qkv_attn.spatial_attention_qkv_cls(torch.from_numpy(qx),
                                                      torch.from_numpy(qc), H, T)
    assert got_x.shape == (B * T, N, D) and got_c.shape == (B * T, 1, D)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-5, rtol=0)


@pytest.mark.parametrize("M,S,H,hd", [(3, 9, 4, 8), (2, 17, 2, 16)])
def test_spatial_proj_twin_matches_jax_kernel(M, S, H, hd):
    D = H * hd
    rng = np.random.RandomState(S)
    qkv, = _arrays(rng, (M, S, 3 * D))
    wp, bp = _arrays(rng, (D, D), (D,), std=0.2)
    want = fused_attention_qkv_proj(jnp.asarray(qkv), jnp.asarray(wp), jnp.asarray(bp), H)
    got = qkv_attn.spatial_attention_qkv_proj(torch.from_numpy(qkv),
                                              torch.from_numpy(wp.T.copy()),
                                              torch.from_numpy(bp), H)
    assert got.shape == (M, S, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("B,T,N,H,hd", [(2, 4, 6, 3, 8), (1, 16, 3, 2, 8), (2, 5, 4, 2, 16)])
def test_temporal_proj_twin_matches_jax_kernel(B, T, N, H, hd):
    D = H * hd
    rng = np.random.RandomState(T)
    qkv, = _arrays(rng, (B, T, N, 3 * D))
    we, be = _arrays(rng, (D, D), (D,), std=0.2)
    want = fused_temporal_attention_qkv_proj(jnp.asarray(qkv), jnp.asarray(we), jnp.asarray(be),
                                             H)
    got = qkv_attn.temporal_attention_qkv_proj(torch.from_numpy(qkv),
                                               torch.from_numpy(we.T.copy()),
                                               torch.from_numpy(be), H)
    assert got.shape == (B, T, N, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_cpu_wrappers_do_not_count_and_check_shapes():
    rng = np.random.RandomState(0)
    qx, qc, q4 = (torch.from_numpy(a) for a in _arrays(rng, (4, 5, 48), (2, 1, 48),
                                                        (1, 2, 3, 48)))
    w, b = torch.zeros(16, 16), torch.zeros(16)
    n = (qkv_attn.spatial_cls_launches, qkv_attn.spatial_proj_launches,
         qkv_attn.temporal_proj_launches)
    qkv_attn.spatial_attention_qkv_cls(qx, qc, 2, 2)
    qkv_attn.spatial_attention_qkv_proj(qx, w, b, 2)
    qkv_attn.temporal_attention_qkv_proj(q4, w, b, 2)
    assert (qkv_attn.spatial_cls_launches, qkv_attn.spatial_proj_launches,
            qkv_attn.temporal_proj_launches) == n
    with pytest.raises(ValueError, match="not divisible by T"):
        qkv_attn.spatial_attention_qkv_cls(qx, qc, 2, 3)
    with pytest.raises(ValueError, match="cls qkv shape"):
        qkv_attn.spatial_attention_qkv_cls(qx, qc[:1], 2, 2)
    with pytest.raises(ValueError, match="projection shapes"):
        qkv_attn.spatial_attention_qkv_proj(qx, torch.zeros(16, 8), b, 2)
    with pytest.raises(ValueError, match="expected"):
        qkv_attn.temporal_attention_qkv_proj(qx, w, b, 2)


@pytest.mark.parametrize("path", ["c", "d"])
def test_model_path_matches_jax(path):
    """The port's TimeSformer under path (c) or (d) against JAX's with the
    same impls (its kernels in interpret mode), raw uint8 clips."""
    jm, params, port = _pair(4, PATH_C if path == "c" else PATH_D)
    got, want = _run(jm, params, port, _clips(2, 4, seed=30, form="raw_uint8"))
    assert got.shape == (2, 1 + 4, 32)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_model_path_d_bf16_matches_jax():
    """Path (d) in bf16 on both sides: activations agree to a few bf16 ulps
    after two blocks (the tolerance of test_bf16_fold_matches_jax)."""
    from alpro_tpu.checkpoint.export_torch import export_timesformer
    from alpro_tpu.models.timesformer import TimeSformer as JaxTimeSformer
    from alpro_tpu.models.timesformer import TimeSformerConfig as JaxCfg
    from alpro_tpu_torch.checkpoint.load import load_alpro_state_dict
    from alpro_tpu_torch.models.timesformer import TimeSformer

    jm = JaxTimeSformer(JaxCfg(**_toy(2), drop_path_rate=0.0, **PATH_D), dtype=jnp.bfloat16)
    params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 2, 32, 32, 3), jnp.uint8))
    port = TimeSformer(TimeSformerConfig(**_toy(2), **PATH_D), dtype=torch.bfloat16)
    load_alpro_state_dict(port, export_timesformer(params["params"], prefix=""))
    got, want = _run(jm, params, port, _clips(2, 2, seed=31, form="raw_uint8"))
    np.testing.assert_allclose(got, want, atol=6e-2, rtol=0)


def test_training_mapping_follows_jax(monkeypatch):
    """In training (JAX ``deterministic=False``): ``cls_sideband`` defers to
    ``auto`` (plain in training), ``fused_qkv_proj`` is ``fused_qkv`` on both
    axes (plain spatial with attention dropout on); in eval each names its
    kernel, on a CPU tensor too; ``auto`` never picks either."""
    cpu = torch.zeros(1, 2, 4, 32)
    # a CUDA stand-in: impl() reads the device, the shape (D = 4 heads of 64,
    # which the kernels take), the dtype and the device's opt-in shared memory
    monkeypatch.setattr(qkv_attn._build, "smem_optin", lambda device: 232448)
    cuda = types.SimpleNamespace(device=torch.device("cuda"), shape=(1, 2, 4, 256),
                                 dtype=torch.bfloat16)
    fields = ("attn_impl", "temporal_attn_impl", "mlp_impl")
    c, d = TimeSformerConfig(**_toy(2), **PATH_C), TimeSformerConfig(**_toy(2), **PATH_D)
    assert [c.impl(f, cpu, False) for f in fields] == ["cls_sideband", "fused_qkv_fold", "fused"]
    assert [c.impl(f, cpu, True) for f in fields] == ["plain", "fused_qkv", "plain"]
    assert [d.impl(f, cpu, False) for f in fields] == ["fused_qkv_proj", "fused_qkv_proj", "fused"]
    assert [d.impl(f, cpu, True) for f in fields] == ["fused_qkv", "fused_qkv", "plain"]
    dropped = TimeSformerConfig(**_toy(2), **PATH_D, attn_drop_rate=0.1)
    assert dropped.impl("attn_impl", cpu, True) == "plain"
    auto = TimeSformerConfig(**_toy(2))
    assert [auto.impl(f, cuda, False) for f in fields] == ["fused_qkv", "fused_qkv_fold", "fused"]
