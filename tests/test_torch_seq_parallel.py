"""``parallel/seq_parallel.py::sharded_temporal_attention`` on two gloo
processes, each holding half of the frames, against the JAX function on a
2-device mesh (as ``tests/test_seq_parallel.py`` holds JAX's to the unsplit
attention): (BN 3, T 8, D 32), 4 heads, fp32; the output within 2e-4 of
JAX's; the gradients of sum(out · c) over the local input within 1e-5 of
one process's autograd through the unsplit attention, and the weights'
summed over the processes likewise. One spawn of
``tests/torch_dist_worker.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_dist_worker as W
from alpro_tpu.core.mesh import make_mesh
from alpro_tpu.parallel.seq_parallel import sharded_temporal_attention as jax_sharded
from alpro_tpu_torch.ops.attention import multi_head_attention

BN, T, D, H = 3, 8, 32, 4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("seq"))
    rng = np.random.RandomState(0)
    f32 = np.float32
    inputs = {"x": rng.randn(BN, T, D).astype(f32), "heads": H,
              "qkv_w": (rng.randn(3 * D, D) * 0.2).astype(f32),
              "qkv_b": (rng.randn(3 * D) * 0.1).astype(f32),
              "proj_w": (rng.randn(D, D) * 0.2).astype(f32),
              "proj_b": (rng.randn(D) * 0.1).astype(f32), "c": rng.randn(BN, T, D).astype(f32)}
    torch.save(inputs, os.path.join(workdir, "seq_in.pt"))
    return inputs, W.spawn("seq", 2, workdir)


def test_forward_matches_jax(setup):
    inputs, out = setup
    want = np.asarray(jax_sharded(
        jnp.asarray(inputs["x"]), jnp.asarray(inputs["qkv_w"].T), jnp.asarray(inputs["qkv_b"]),
        jnp.asarray(inputs["proj_w"].T), jnp.asarray(inputs["proj_b"]), num_heads=H,
        mesh=make_mesh(devices=jax.devices()[:2])))
    got = np.concatenate([o["out"] for o in out], axis=1)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_gradients_match_the_unsplit_attention(setup):
    inputs, out = setup
    x = torch.from_numpy(inputs["x"]).requires_grad_(True)
    ws = [torch.from_numpy(inputs[k]).requires_grad_(True)
          for k in ("qkv_w", "qkv_b", "proj_w", "proj_b")]
    q, k, v = (F.linear(x, ws[0], ws[1]).reshape(BN, T, 3, H, D // H)[:, :, i].transpose(1, 2)
               for i in range(3))
    y = F.linear(multi_head_attention(q, k, v, impl="xla").transpose(1, 2).reshape(BN, T, D),
                 ws[2], ws[3])
    (y * torch.from_numpy(inputs["c"])).sum().backward()
    got_x = np.concatenate([o["x_grad"] for o in out], axis=1)
    np.testing.assert_allclose(got_x, x.grad.numpy(), atol=1e-5, rtol=0)
    assert np.abs(got_x).max() > 1e-2
    for i, w in enumerate(ws):
        np.testing.assert_allclose(sum(o["w_grads"][i] for o in out), w.grad.numpy(),
                                   atol=1e-5, rtol=0)
