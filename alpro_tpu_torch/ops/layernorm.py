"""Row LayerNorm as a CUDA kernel, with its plain twin and the analytic
backward.

Counterpart of ``alpro_tpu/ops/pallas_layernorm.py::fused_layernorm``
(kernel ``csrc/layernorm.cu``, twin ``layernorm_plain`` = the one-pass
``ln_rows_f32`` cast to ``out_dtype``, the math of the JAX kernel and of
``ops/layers.py::layernorm_apply``). ``out_dtype`` may differ from x's dtype
(bf16 or fp32 each way).

Gradient: as the JAX custom_vjp, the kernel call is a
``torch.autograd.Function`` whose backward is JAX's analytic ``_bwd``
(``layernorm_backward``: fp32 dx, dscale, dbias); a call that needs no
gradient (grad mode off, or no input requiring one) launches directly, since
the Function's bookkeeping costs more host time than the kernel takes on the
card. A wrapper runs the twin only for a CPU tensor (differentiated directly
by autograd, the same gradient up to rounding); for a CUDA tensor it
launches the kernel or raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from alpro_tpu_torch.ops import _build
from alpro_tpu_torch.ops.kernel_math import ln_rows_f32

launches = 0

_DTYPES = (torch.bfloat16, torch.float32)
_VEC = 8  # csrc/layernorm.cu kVec: elements per chunk
_MAX_D = 2048  # csrc/layernorm.cu: 8 chunks of 8 per lane held in registers


def layernorm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """Plain twin: one-pass fp32 statistics, fp32 scale and bias, cast."""
    return ln_rows_f32(x, scale, bias, eps).to(out_dtype)


def layernorm_backward(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, eps: float):
    """JAX ``_bwd``: (dx in x's dtype, dscale, dbias in scale's dtype), all
    computed in fp32 from the recomputed statistics."""
    xf, gf = x.float(), g.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mean) * rstd
    gs = gf * scale.float()
    dx = rstd * (gs - gs.mean(dim=-1, keepdim=True)
                 - xhat * (gs * xhat).mean(dim=-1, keepdim=True))
    rows = tuple(range(x.dim() - 1))
    return (dx.to(x.dtype), (gf * xhat).sum(dim=rows).to(scale.dtype),
            gf.sum(dim=rows).to(scale.dtype))


def _fp32_operand(v: torch.Tensor) -> torch.Tensor:
    """scale or bias as the kernel reads it: an fp32 contiguous tensor passes
    as it is, anything else is converted once."""
    if v.dtype == torch.float32 and v.is_contiguous():
        return v
    return v.detach().float().contiguous()


def _launch(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
            out_dtype: torch.dtype) -> torch.Tensor:
    global launches
    D = x.shape[-1]
    _build.check_cuda_operand(x, "layernorm x", _DTYPES)
    if out_dtype not in _DTYPES:
        raise ValueError(f"layernorm: out_dtype {out_dtype} not in {_DTYPES}")
    if D % _VEC or D > _MAX_D or tuple(scale.shape) != (D,) or tuple(bias.shape) != (D,):
        raise ValueError(f"layernorm kernel needs D % {_VEC} == 0, D <= {_MAX_D} and (D,) scale "
                         f"and bias; got D={D}, {tuple(scale.shape)}, {tuple(bias.shape)}")
    s, b = _fp32_operand(scale), _fp32_operand(bias)
    for key, v in (("scale", s), ("bias", b)):
        _build.check_cuda_operand(v, f"layernorm {key}", (torch.float32,))
    out = torch.empty_like(x, dtype=out_dtype)
    dev, stream = _build.stream_args(x)
    err = _build.lib().alpro_layernorm(
        x.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(), x.numel() // D, D, float(eps),
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16), dev, stream,
    )
    _build.check(err, "layernorm")
    launches += 1
    return out


class _KernelLayerNorm(torch.autograd.Function):
    """kernel forward, JAX's analytic backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, out_dtype):
        ctx.save_for_backward(x, scale)
        ctx.eps, ctx.bias_dtype = eps, bias.dtype
        return _launch(x, scale, bias, eps, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale, dbias = layernorm_backward(x, scale, g, ctx.eps)
        return dx, dscale, dbias.to(ctx.bias_dtype), None, None


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *, eps: float,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """LayerNorm over the last axis of x, returned in ``out_dtype`` (x's
    dtype by default). The kernel takes x contiguous in bf16 or fp32, D % 8
    == 0 and D <= 2048; it raises on anything else."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type == "cpu":
        return layernorm_plain(x, scale, bias, eps, out_dtype)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad or bias.requires_grad):
        return _KernelLayerNorm.apply(x, scale, bias, float(eps), out_dtype)
    return _launch(x, scale, bias, float(eps), out_dtype)
