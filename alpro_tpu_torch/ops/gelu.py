"""The exact-erf GELU as a CUDA kernel forward and backward, with its plain
twins.

Counterpart of no TPU kernel: on the TPU, XLA fused the chain
``kernel_math.gelu_exact_f32(x).to(x.dtype)`` into its neighbours, where
eager PyTorch runs it as seven fp32 launches forward and about a dozen in
autograd (kernel ``csrc/gelu.cu``, twin ``gelu_plain``; its backward's twin
``gelu_backward_plain``, autograd's own operations through ``gelu_plain``).
The forward is bit-equal to the twin on the card; the backward rounds once
where autograd rounds once too.

A wrapper runs the twin only for a CPU tensor (differentiated by autograd);
for a CUDA tensor it launches the kernel or raises (bf16 or fp32,
contiguous). Under grad the call is the ``torch.library`` custom op
``alpro_tpu_torch::gelu``, whose backward launches ``gelu_bwd`` from the
saved input: one op that the checkpointing policies of ``models/remat.py``
see (none keeps it, so a checkpointed block's recompute launches it again).
A call that needs no gradient launches directly. ``launches`` and
``backward_launches`` count the two kernels' launches.
"""

from __future__ import annotations

import math

import torch

from alpro_tpu_torch.ops import _build
from alpro_tpu_torch.ops.kernel_math import erf_f32, gelu_exact_f32

launches = 0
backward_launches = 0

_DTYPES = (torch.bfloat16, torch.float32)
_RSQRT2 = 2.0 ** -0.5  # gelu_exact_f32's constant


def gelu_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain twin: the exact GELU in fp32, returned in x's dtype."""
    return gelu_exact_f32(x).to(x.dtype)


def gelu_backward_plain(h: torch.Tensor, dg: torch.Tensor) -> torch.Tensor:
    """d/dh of ``gelu_plain(h)`` against dg, in h's dtype: the operations
    autograd runs through the twin, in its order (u = h·2^-½, b = 1 + erf(u),
    t = h·0.5; dt = dg·b, db = dg·t, du = (2/√π · exp(−u²))·db, dh = du·2^-½
    + dt·0.5), in fp32."""
    hf = h.float()
    u = hf * _RSQRT2
    b = 1.0 + erf_f32(u)
    gy = dg.float()
    dt = gy * b
    db = gy * (hf * 0.5)
    du = 2.0 / math.sqrt(math.pi) * torch.exp(-(u * u)) * db
    return (du * _RSQRT2 + dt * 0.5).to(h.dtype)


def _launch(x: torch.Tensor) -> torch.Tensor:
    global launches
    _build.check_cuda_operand(x, "gelu x", _DTYPES, align=x.element_size())
    out = torch.empty_like(x)
    if x.numel():
        dev, stream = _build.stream_args(x)
        err = _build.lib().alpro_gelu_fwd(x.data_ptr(), out.data_ptr(), x.numel(),
                                          int(x.dtype == torch.bfloat16), dev, stream)
        _build.check(err, "gelu")
        launches += 1
    return out


def _launch_backward(h: torch.Tensor, dg: torch.Tensor) -> torch.Tensor:
    global backward_launches
    _build.check_cuda_operand(h, "gelu backward h", _DTYPES, align=h.element_size())
    _build.check_cuda_operand(dg, "gelu backward dg", (h.dtype,), align=h.element_size())
    if dg.shape != h.shape or dg.device != h.device:
        raise ValueError(f"gelu backward: dg {tuple(dg.shape)} on {dg.device} against h "
                         f"{tuple(h.shape)} on {h.device}")
    dh = torch.empty_like(h)
    if h.numel():
        dev, stream = _build.stream_args(h)
        err = _build.lib().alpro_gelu_bwd(h.data_ptr(), dg.data_ptr(), dh.data_ptr(),
                                          h.numel(), int(h.dtype == torch.bfloat16), dev,
                                          stream)
        _build.check(err, "gelu backward")
        backward_launches += 1
    return dh


@torch.library.custom_op("alpro_tpu_torch::gelu", mutates_args=())
def _gelu_op(x: torch.Tensor) -> torch.Tensor:
    return _launch(x)


def _gelu_op_setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[0])


def _gelu_op_backward(ctx, g):
    (x,) = ctx.saved_tensors
    # a broadcast cotangent (of a sum, say) arrives strided
    return _launch_backward(x, g.contiguous())


_gelu_op.register_autograd(_gelu_op_backward, setup_context=_gelu_op_setup)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU in fp32, returned in x's dtype. A CUDA tensor must be
    bf16 or fp32 and contiguous; anything else raises."""
    if x.device.type == "cpu":
        return gelu_plain(x)
    if torch.is_grad_enabled() and x.requires_grad:
        return _gelu_op(x)
    return _launch(x)


def gelu_backward(h: torch.Tensor, dg: torch.Tensor) -> torch.Tensor:
    """``gelu``'s gradient against dg alone: the twin on a CPU tensor, else
    one launch of ``gelu_bwd`` (h and dg contiguous, of one dtype)."""
    if h.device.type == "cpu":
        return gelu_backward_plain(h, dg)
    return _launch_backward(h, dg)
