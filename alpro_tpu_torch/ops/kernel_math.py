"""Shared fp32 math of the kernels and their plain twins.

Counterpart of ``alpro_tpu/ops/kernel_math.py``. One definition of the
one-pass LayerNorm statistics and of the exact GELU, so that the plain twins
and the CUDA kernels (``csrc/ln_mlp.cu``) agree by construction.

erf: the port uses the true erf (``torch.erf`` here, ``erff`` in CUDA).
The JAX kernels use the Abramowitz–Stegun 7.1.26 polynomial only because
Mosaic has no erf; its error is at most 1.5e-7 in erf (5e-7 with the fp32
rounding of its evaluation), so the two GELUs differ by at most 2.5e-7·|x| —
far inside the 2e-4 fp32 parity tolerance (tests/test_torch_ops.py holds
the two erfs to atol 5e-7).
"""

from __future__ import annotations

import torch


def ln_rows_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    """fp32 one-pass LN over the last axis: E[x²]−E[x]², clamped at 0.
    Returns fp32; the caller casts."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return y * scale.float() + bias.float()


def erf_f32(x: torch.Tensor) -> torch.Tensor:
    """fp32 erf (true erf; see the module docstring for the A–S bound)."""
    return torch.erf(x.float())


def gelu_exact_f32(x: torch.Tensor) -> torch.Tensor:
    """x·Φ(x) with the exact-erf CDF, in fp32."""
    xf = x.float()
    return xf * 0.5 * (1.0 + erf_f32(xf * (2.0 ** -0.5)))
