"""LayerNorm and GELU of the encoders (counterpart of ``alpro_tpu/ops/layers.py``).

LayerNorm statistics are one-pass fp32 (E[x²]−E[x]², clamped at 0) whatever
the compute dtype. That is not the algorithm of ``torch.nn.functional
.layer_norm`` (Welford), so it is written out here; the JAX package, the
fused kernels and this module all share it.
"""

from __future__ import annotations

import torch
from torch import nn

from alpro_tpu_torch.ops.kernel_math import gelu_exact_f32, ln_rows_f32


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU evaluated in fp32, returned in ``x.dtype``."""
    return gelu_exact_f32(x).to(x.dtype)


def layernorm_apply(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float, out_dtype: torch.dtype) -> torch.Tensor:
    """Functional LN with one-pass fp32 statistics, cast to ``out_dtype``."""
    return ln_rows_f32(x, scale, bias, eps).to(out_dtype)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics; parameters named ``weight``/``bias``
    as in the ALPRO state dict. Output dtype is the caller's compute dtype."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = float(eps)
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
        return layernorm_apply(x, self.weight, self.bias, self.eps, out_dtype)


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``x @ W.T + b`` in the compute dtype (flax ``Dense(dtype=...)``: the
    fp32-stored weights are cast to the compute dtype at use)."""
    b = None if layer.bias is None else layer.bias.to(dtype)
    return torch.nn.functional.linear(x.to(dtype), layer.weight.to(dtype), b)
