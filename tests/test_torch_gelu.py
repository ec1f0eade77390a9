"""The exact GELU's wrapper (``alpro_tpu_torch/ops/gelu.py``) on the CPU.

The analytic backward twin against autograd through ``gelu_exact_f32``; the
wrapper on a CPU tensor is the plain path of before (output and gradient
bit for bit); the module imports and registers its custom op without a CUDA
toolkit, and builds nothing. With a CUDA stand-in, a call that needs a
gradient goes through the custom op ``alpro_tpu_torch::gelu`` and any other
launches directly; with the launches replaced by the twins, the custom op's
registered backward gives autograd's gradient, and a checkpointed call
replays the forward in the recompute under ``dots_ln`` and ``nothing``. The
kernels themselves are tested on the card (``tests/test_torch_cuda_kernels.py``).
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from alpro_tpu_torch.models.remat import resolve_remat_policy
from alpro_tpu_torch.ops import gelu as gelu_mod
from alpro_tpu_torch.ops.kernel_math import gelu_exact_f32
from alpro_tpu_torch.ops.layers import checkpoint, gelu_exact

REPO = Path(__file__).resolve().parent.parent
BF16, F32 = torch.bfloat16, torch.float32


def _x(shape, dtype, seed=0, scale=3.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dtype)


def _autograd(x, dg):
    h = x.detach().requires_grad_(True)
    (dh,) = torch.autograd.grad(gelu_exact_f32(h).to(h.dtype), h, dg)
    return dh


@pytest.mark.parametrize("shape", [(64, 3072), (3, 5, 7), (1,)])
def test_backward_plain_fp32_matches_autograd(shape):
    x = _x(shape, F32)
    x.view(-1)[0] = -0.7517915  # near the derivative's zero
    dg = _x(shape, F32, seed=1, scale=1.0)
    got, want = gelu_mod.gelu_backward_plain(x, dg), _autograd(x, dg)
    assert got.dtype == F32
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("shape", [(64, 3072), (24, 3072), (9,)])
def test_backward_plain_bf16_matches_autograd(shape):
    x, dg = _x(shape, BF16), _x(shape, BF16, seed=1, scale=1.0)
    got, want = gelu_mod.gelu_backward_plain(x, dg), _autograd(x, dg)
    assert got.dtype == BF16
    # within one bf16 ulp of autograd's (both round an fp32 value once)
    ulp = torch.finfo(BF16).eps * want.float().abs().clamp_min(torch.finfo(BF16).tiny)
    assert bool(((got.float() - want.float()).abs() <= ulp).all())


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_cpu_wrapper_is_the_plain_gelu(dtype):
    """On a CPU tensor ``gelu_exact`` (and ``gelu``) are the plain path of
    before: ``gelu_exact_f32(x).to(x.dtype)`` and its autograd gradient, bit
    for bit, with no launch counted."""
    x = _x((37, 96), dtype).requires_grad_(True)
    dg = _x((37, 96), dtype, seed=2, scale=1.0)
    n = (gelu_mod.launches, gelu_mod.backward_launches)
    for fn in (gelu_exact, gelu_mod.gelu):
        y = fn(x)
        want = gelu_exact_f32(x).to(dtype)
        assert y.dtype == dtype and torch.equal(y, want)
        (got_dx,) = torch.autograd.grad(y, x, dg)
        (want_dx,) = torch.autograd.grad(want, x, dg)
        assert torch.equal(got_dx, want_dx)
    assert torch.equal(gelu_mod.gelu_plain(x.detach()), gelu_exact_f32(x.detach()).to(dtype))
    assert torch.equal(gelu_mod.gelu_backward(x.detach(), dg),
                       gelu_mod.gelu_backward_plain(x.detach(), dg))
    assert (gelu_mod.launches, gelu_mod.backward_launches) == n


def test_gelu_imports_without_a_cuda_toolkit(tmp_path):
    """A fresh process with no CUDA toolkit on its path and no card imports
    the module and the layers that route through it, has the custom op
    registered, runs the CPU path, and has built and loaded nothing."""
    code = (
        "import torch\n"
        "from alpro_tpu_torch.ops import _build, gelu\n"
        "from alpro_tpu_torch.ops import layers\n"
        "assert torch.ops.alpro_tpu_torch.gelu.default is not None\n"
        "x = torch.linspace(-4, 4, 17)\n"
        "assert torch.equal(layers.gelu_exact(x), gelu.gelu_plain(x))\n"
        "assert _build._lib is None\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in ("CUDACXX", "CUDA_HOME", "CUDA_PATH")}
    env.update(PATH=str(tmp_path), PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


class _StandIn:
    """A tensor that reports a CUDA device and whether it needs a gradient."""

    def __init__(self, requires_grad):
        self.device, self.requires_grad = torch.device("cuda"), requires_grad


@pytest.mark.parametrize("requires_grad", [False, True])
def test_cuda_call_routes_by_gradient(monkeypatch, requires_grad):
    """A CUDA tensor that needs a gradient, in grad mode: the custom op; one
    that needs none, or any call under ``no_grad``/``inference_mode``: the
    launch alone."""
    calls = []
    monkeypatch.setattr(gelu_mod, "_launch", lambda x: calls.append("launch"))
    monkeypatch.setattr(gelu_mod, "_gelu_op", lambda x: calls.append("op"))
    x = _StandIn(requires_grad)
    gelu_mod.gelu(x)
    assert calls == ["op" if requires_grad else "launch"]
    calls.clear()
    with torch.no_grad():
        gelu_mod.gelu(x)
    with torch.inference_mode():
        gelu_mod.gelu(x)
    assert calls == ["launch", "launch"]


@pytest.fixture
def twin_launches(monkeypatch):
    """The custom op's two launches replaced by the twins (on CPU tensors),
    each counted."""
    n = {"fwd": 0, "bwd": 0}

    def fwd(x):
        n["fwd"] += 1
        return gelu_mod.gelu_plain(x)

    def bwd(h, dg):
        assert dg.is_contiguous()
        n["bwd"] += 1
        return gelu_mod.gelu_backward_plain(h, dg)

    monkeypatch.setattr(gelu_mod, "_launch", fwd)
    monkeypatch.setattr(gelu_mod, "_launch_backward", bwd)
    return n


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_custom_op_backward_is_autograds(twin_launches, dtype):
    x = _x((24, 3072), dtype).requires_grad_(True)
    dg = _x((24, 3072), dtype, seed=3, scale=1.0)
    y = torch.ops.alpro_tpu_torch.gelu(x)
    assert torch.equal(y, gelu_exact_f32(x).to(dtype))
    (dx,) = torch.autograd.grad(y, x, dg)
    assert torch.equal(dx, gelu_mod.gelu_backward_plain(x.detach(), dg))
    assert twin_launches == {"fwd": 1, "bwd": 1}
    # a broadcast cotangent reaches the backward launch contiguous
    (ds,) = torch.autograd.grad(torch.ops.alpro_tpu_torch.gelu(x).sum(), x)
    assert torch.equal(ds, gelu_mod.gelu_backward_plain(x.detach(), torch.ones_like(x)))


@pytest.mark.parametrize("policy", ["nothing", "dots_ln"])
def test_checkpointed_custom_op_is_recomputed(twin_launches, policy):
    """Inside a checkpointed region (fc1 → the custom op → fc2, as the
    video tower's MLP) no policy keeps the GELU: the recompute launches its
    forward again, and the gradients are those of the region unchecked."""
    torch.manual_seed(0)
    fc1, fc2 = torch.nn.Linear(32, 128), torch.nn.Linear(128, 32)
    x = torch.randn(6, 32, requires_grad=True)

    def region(v):
        return fc2(torch.ops.alpro_tpu_torch.gelu(fc1(v)))

    want = torch.autograd.grad(region(x).square().sum(), [x, fc1.weight, fc2.weight])
    assert twin_launches == {"fwd": 1, "bwd": 1}
    out = checkpoint(region, None, x, context_fn=resolve_remat_policy(policy))
    got = torch.autograd.grad(out.square().sum(), [x, fc1.weight, fc2.weight])
    assert twin_launches == {"fwd": 3, "bwd": 2}
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)
