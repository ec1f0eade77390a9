"""Int8 weight storage for the serving path (counterpart of
``alpro_tpu/ops/quant.py``).

Two rungs, as in the JAX package:

* **w8 storage** (``quantize_tree`` / ``dequantize_tree``): every matmul
  weight of at least ``min_elems`` entries is held as int8 with a
  per-output-channel fp32 scale and dequantized as the forward reads it;
  every other fp32 parameter is cast to bf16. Symmetric round-to-nearest:
  ``scale = amax / 127`` over the contraction axis, a zero channel gets
  scale 0 (and dequantizes to 0), ``q = clip(round(w / scale), ±127)``.
* **w8a8 math** (``int8_dense``): per-row int8 activations times an int8
  weight, accumulated exactly, rescaled in fp32. Plain torch, no kernel
  (XLA code in the JAX package).

*Which weights.* JAX quantizes the leaves named ``kernel`` of ndim 2 or 3,
at least ``min_elems`` entries, floating. Under the port's mapping
(``checkpoint/from_jax.py``) a Dense kernel (in, out) is an ``nn.Linear``
weight (out, in), and the patch embedding's (p·p·C, D) kernel is
``PatchEmbed.kernel``, which the port keeps in JAX's layout; embeddings and
LayerNorm scales are never kernels, and the port holds no stacked (ndim 3)
weight. So the port picks the ``weight`` of every ``nn.Linear`` and every
2-D parameter named ``kernel``. The scale reduces over the contraction
axis: -1 for a Linear weight (scale (out, 1)), -2 for a ``kernel`` (scale
(1, out), as JAX's). The division is by a tensor, not by a Python float:
CUDA divides by a host scalar through its reciprocal, which is not IEEE
division; ``torch.round`` rounds half to even, as ``np.rint``.

*Where the int8 weights live.* ``quantize_tree(model)`` returns a new
module: each quantized weight is the int8 original of a
``torch.nn.utils.parametrize`` parametrization that holds the scale, so the
device holds int8 at rest and no bf16 copy. Reading ``module.weight``
dequantizes it in one launch (``torch.mul(q, scale, out=bf16)``: the
product in fp32, rounded once to bf16), a new tensor on every read: a call
holds only the bf16 weights its kernels are reading at the time, and
nothing may cache a weight by its storage. ``wrap_dequant`` gives JAX's
form instead, every weight dequantized once per call (its peak holds all of
them). The caller's model is not changed and not copied in full precision:
the new module's parameters are the int8 tensors, the bf16 casts of the
fp32 ones, and the caller's own tensors where they are already bf16 (shared,
as ``jnp.asarray(x, bfloat16)`` returns x).
"""

from __future__ import annotations

import copy
from typing import Callable, Optional, Tuple

import torch
from torch import nn
from torch.nn.utils import parametrize

MIN_ELEMS = 1 << 12


def _q_max(device) -> torch.Tensor:
    return torch.tensor(127.0, device=device)


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """``(q.float() * scale).to(dtype)`` in one launch."""
    return torch.mul(q, scale, out=torch.empty(q.shape, dtype=dtype, device=q.device))


class QTensor:
    """An int8-quantized weight: ``dequant() == (q.float() * scale).to(dtype)``.
    ``scale`` has the weight's shape with the contraction axis 1."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16):
        self.q = q
        self.scale = scale
        self.dtype = dtype

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.dim()

    def dequant(self) -> torch.Tensor:
        return dequantize(self.q, self.scale, self.dtype)

    def __repr__(self):
        return f"QTensor(shape={tuple(self.q.shape)}, dtype={self.dtype})"


def quantize_weight(w: torch.Tensor, axis: int = -1, dtype=torch.bfloat16) -> QTensor:
    """Symmetric int8 quantization of a matmul weight, one scale per output
    channel: |w| reduced over the contraction ``axis`` only (-1 for a
    Linear weight (out, in), -2 for a JAX-layout (in, out) kernel)."""
    w = w.detach().float()
    scale = w.abs().amax(dim=axis, keepdim=True) / _q_max(w.device)
    safe = torch.where(scale == 0.0, torch.ones((), device=w.device), scale)
    q = torch.clamp(torch.round(w / safe), -127, 127).to(torch.int8)
    return QTensor(q, scale, dtype)


class _Dequantize(nn.Module):
    """The parametrization of one int8 weight: its scale, dequantized on read."""

    def __init__(self, scale: torch.Tensor, dtype):
        super().__init__()
        self.register_buffer("scale", scale)
        self.dtype = dtype

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        return dequantize(q, self.scale, self.dtype)


def quantized_weights(model: nn.Module, min_elems: int = MIN_ELEMS):
    """[(module name, parameter name, contraction axis)] of the weights
    ``quantize_tree`` quantizes: every Linear's ``weight`` and every 2-D
    ``kernel`` with at least ``min_elems`` floating entries."""
    picks = []
    for name, m in model.named_modules():
        pname, axis = ("weight", -1) if isinstance(m, nn.Linear) else ("kernel", -2)
        p = m._parameters.get(pname)
        if p is not None and p.dim() == 2 and p.numel() >= min_elems and p.is_floating_point():
            picks.append((name, pname, axis))
    return picks


def quantize_tree(model: nn.Module, dtype=torch.bfloat16, min_elems: int = MIN_ELEMS) -> nn.Module:
    """A new module computing as ``model`` does from int8 weights (see the
    module docstring): the weights of ``quantized_weights`` int8 with their
    scales, every other fp32 parameter cast to ``dtype``, buffers shared."""
    if parametrize.is_parametrized(model) or any(
            parametrize.is_parametrized(m) for m in model.modules()):
        raise ValueError("quantize_tree takes a model without parametrizations")
    modules = dict(model.named_modules())
    picks = {id(modules[m]._parameters[p]): (m, p, axis)
             for m, p, axis in quantized_weights(model, min_elems)}
    memo, scales = {}, {}
    for p in model.parameters():
        if id(p) in picks:
            qt = quantize_weight(p, picks[id(p)][2], dtype)
            memo[id(p)], scales[picks[id(p)][:2]] = qt.q, qt.scale
        else:
            memo[id(p)] = p.detach().to(dtype) if p.dtype == torch.float32 else p.detach()
        memo[id(p)] = nn.Parameter(memo[id(p)], requires_grad=False)
    for b in model.buffers():
        memo[id(b)] = b
    new = copy.deepcopy(model, memo)
    new_modules = dict(new.named_modules())
    for (m, p), scale in scales.items():
        parametrize.register_parametrization(new_modules[m], p, _Dequantize(scale, dtype),
                                             unsafe=True)
    return new


def dequantize_tree(qmodel: nn.Module) -> nn.Module:
    """A new module with every int8 weight of ``qmodel`` as its dense
    dequantized tensor (``quantize_tree``'s inverse, up to the rounding).
    The copy's modules drop their parametrization by taking back their
    class; ``parametrize.remove_parametrizations`` would delete the
    property from the class the copy shares with ``qmodel``."""
    dense = copy.deepcopy(qmodel)
    for m in list(dense.modules()):
        if parametrize.is_parametrized(m):
            values = {name: getattr(m, name) for name in m.parametrizations}
            m.__class__ = type(m).__bases__[0]
            del m.parametrizations
            for name, value in values.items():
                m.register_parameter(name, nn.Parameter(value, requires_grad=False))
    return dense


def wrap_dequant(fn: Callable) -> Callable:
    """``fn(model, *a, **kw)`` → the same function taking a quantized model,
    each int8 weight dequantized once per call (``parametrize.cached``), as
    the JAX wrapper dequantizes the whole tree once per jitted call."""

    def wrapped(qmodel, *args, **kwargs):
        with parametrize.cached():
            return fn(qmodel, *args, **kwargs)

    return wrapped


# ---- w8a8: dynamic activation quantization + an exact int8 product ----------


def quantize_acts(x: torch.Tensor, axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization of activations: (x_int8,
    row_scale), row_scale shaped like x with ``axis`` 1; a zero row gets
    scale 1/127."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax == 0.0, torch.ones((), device=x.device), amax) / _q_max(x.device)
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def int8_dense(x: torch.Tensor, qw: QTensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ Wᵀ (+ bias) with both operands int8: x (..., in) float, qw
    the QTensor of a Linear weight (out, in). The int8 product accumulates
    exactly (in fp64, where |sum| <= in·127² < 2^53; an fp32 sum is not
    exact once in·127² passes 2^24, in > 1040), is rounded to fp32 as
    JAX's int32 accumulator is converted, then rescaled by row_scale ⊗
    channel scale in fp32 and cast to ``qw.dtype``."""
    if qw.ndim != 2:
        raise ValueError(f"int8_dense takes a 2-D (out, in) weight, got {tuple(qw.shape)}")
    xq, xs = quantize_acts(x, -1)
    acc = torch.matmul(xq.double(), qw.q.double().T).float()
    y = acc * xs * qw.scale.T
    if bias is not None:
        y = y + bias.float()
    return y.to(qw.dtype)
