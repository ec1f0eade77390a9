"""Fused attention chains of the port (alpro_tpu_torch.ops.fused_block) and
the fused video ingest of its TimeSformer.

On the CPU: each plain twin against the JAX Pallas kernel function in
interpret mode (alpro_tpu.ops.pallas_fused_block), fp32, atol 3e-5 (the JAX
package's own tolerance for these kernels, tests/test_fused_block.py); then
the port's TimeSformer against JAX's on the same weights and raw uint8
clips, atol 2e-4 (tests/test_torch_timesformer.py), under path (a) — the
raw-frame patch embed, ``fused_block`` on both axes, fused MLP tail — and
path (b), ``fused_ln_qkv`` on both axes; and (a) in bf16. The CUDA kernels
are held against the twins on the card by tests/test_torch_cuda_kernels.py.
The port takes torch Linear layout weights, so they go in transposed.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpro_tpu.ops.pallas_fused_block import fused_spatial_block as jax_spatial_block
from alpro_tpu.ops.pallas_fused_block import fused_temporal_block as jax_temporal_block
from alpro_tpu_torch.models.timesformer import TimeSformerConfig
from alpro_tpu_torch.ops import fused_block
from test_torch_timesformer import ATOL, _clips, _pair, _run, _toy

PATH_A = dict(attn_impl="fused_block", temporal_attn_impl="fused_block", mlp_impl="fused",
              fused_patchify="on")
PATH_B = dict(attn_impl="fused_ln_qkv", temporal_attn_impl="fused_ln_qkv", mlp_impl="fused")


def _weights(rng, D):
    """ln scale, ln bias, wqkv (D, 3D), bqkv, w (D, D), b — JAX layout."""
    return [(1 + 0.1 * rng.randn(D)).astype(np.float32), (0.1 * rng.randn(D)).astype(np.float32),
            (0.2 * rng.randn(D, 3 * D)).astype(np.float32), (0.1 * rng.randn(3 * D)).astype(np.float32),
            (0.2 * rng.randn(D, D)).astype(np.float32), (0.1 * rng.randn(D)).astype(np.float32)]


def _port_args(ws):
    """The same weights in the port's layout: the matrices transposed."""
    s, b, wqkv, bqkv, w, bw = (torch.from_numpy(a) for a in ws)
    return s, b, wqkv.t().contiguous(), bqkv, w.t().contiguous(), bw


@pytest.mark.parametrize("residual", [False, True])
def test_spatial_twin_matches_jax_kernel(residual):
    rng = np.random.RandomState(0)
    M, S, H, hd = 3, 9, 2, 8
    x = rng.randn(M, S, H * hd).astype(np.float32)
    ws = _weights(rng, H * hd)
    want = jax_spatial_block(jnp.asarray(x), *map(jnp.asarray, ws), H, eps=1e-6,
                             residual=residual)
    got = fused_block.fused_spatial_block(torch.from_numpy(x), *_port_args(ws), H, eps=1e-6,
                                          residual=residual)
    assert got.dtype == torch.float32 and got.shape == (M, S, H * hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=0)


@pytest.mark.parametrize("T", [3, 5])
def test_temporal_twin_matches_jax_kernel(T):
    rng = np.random.RandomState(T)
    B, N, H, hd = 2, 6, 3, 8
    x = rng.randn(B, T, N, H * hd).astype(np.float32)
    ws = _weights(rng, H * hd)
    want = jax_temporal_block(jnp.asarray(x), *map(jnp.asarray, ws), H, eps=1e-6)
    got = fused_block.fused_temporal_block(torch.from_numpy(x), *_port_args(ws), H, eps=1e-6)
    assert got.shape == (B, T, N, H * hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=0)


def test_cpu_wrappers_do_not_count_and_check_shapes():
    rng = np.random.RandomState(1)
    ws = _port_args(_weights(rng, 16))
    n = (fused_block.spatial_launches, fused_block.temporal_launches)
    fused_block.fused_spatial_block(torch.zeros(2, 5, 16), *ws, 2, eps=1e-6)
    fused_block.fused_temporal_block(torch.zeros(1, 2, 3, 16), *ws, 2, eps=1e-6)
    assert (fused_block.spatial_launches, fused_block.temporal_launches) == n
    bad = list(ws)
    bad[2] = bad[2].t()  # JAX (D, 3D) layout instead of torch (3D, D)
    with pytest.raises(ValueError, match="shape mismatch"):
        fused_block.fused_spatial_block(torch.zeros(2, 5, 16), *bad, 2, eps=1e-6)


@pytest.mark.parametrize("path", ["a", "b"])
def test_fused_ingest_matches_jax(path):
    """The port's TimeSformer under path (a) or (b) against JAX's with the
    same impls (its kernels in interpret mode), raw uint8 clips."""
    impls = PATH_A if path == "a" else PATH_B
    jm, params, port = _pair(4, impls)
    got, want = _run(jm, params, port, _clips(2, 4, seed=20, form="raw_uint8"))
    assert got.shape == (2, 1 + 4, 32)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_fused_ingest_bf16_matches_jax():
    """Path (a) in bf16 on both sides: activations agree to a few bf16 ulps
    after two blocks (the tolerance of test_bf16_fold_matches_jax)."""
    from alpro_tpu.checkpoint.export_torch import export_timesformer
    from alpro_tpu.models.timesformer import TimeSformer as JaxTimeSformer
    from alpro_tpu.models.timesformer import TimeSformerConfig as JaxCfg
    from alpro_tpu_torch.checkpoint.load import load_alpro_state_dict
    from alpro_tpu_torch.models.timesformer import TimeSformer

    jm = JaxTimeSformer(JaxCfg(**_toy(2), drop_path_rate=0.0, **PATH_A), dtype=jnp.bfloat16)
    params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 2, 32, 32, 3), jnp.uint8))
    port = TimeSformer(TimeSformerConfig(**_toy(2), **PATH_A), dtype=torch.bfloat16)
    load_alpro_state_dict(port, export_timesformer(params["params"], prefix=""))
    got, want = _run(jm, params, port, _clips(2, 2, seed=21, form="raw_uint8"))
    np.testing.assert_allclose(got, want, atol=6e-2, rtol=0)


def test_auto_never_picks_the_fused_ingest(monkeypatch):
    """'auto' resolves to the first kernel value in eval on a CUDA tensor
    inside the kernels' limits and to plain otherwise — never to
    fused_ln_qkv or fused_block — and the fused patch embed is off unless
    set."""
    cfg = TimeSformerConfig(**_toy(2))
    cpu = torch.zeros(1, 2, 4, 32)
    # a CUDA stand-in: impl() reads the device, the shape (D = 4 heads of 64,
    # which the kernels take), the dtype and the device's opt-in shared memory
    monkeypatch.setattr(fused_block._build, "smem_optin", lambda device: 232448)
    cuda = types.SimpleNamespace(device=torch.device("cuda"), shape=(1, 2, 4, 256),
                                 dtype=torch.bfloat16)
    for field, first in (("attn_impl", "fused_qkv"), ("temporal_attn_impl", "fused_qkv_fold")):
        assert cfg.impl(field, cuda, False) == first
        for x, training in ((cuda, True), (cpu, False), (cpu, True)):
            assert cfg.impl(field, x, training) == "plain"
    assert cfg.fused_patchify == "auto"
    fused = TimeSformerConfig(**_toy(2), **PATH_A)
    assert [fused.impl(f, cpu, False) for f in ("attn_impl", "temporal_attn_impl")] == [
        "fused_block", "fused_block"]
    assert [fused.impl(f, cpu, True) for f in ("attn_impl", "temporal_attn_impl")] == [
        "fused_qkv", "fused_qkv"]
    with pytest.raises(ValueError):
        TimeSformerConfig(fused_patchify="yes")
