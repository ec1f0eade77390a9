"""LayerNorm, GELU, dropout, drop-path and per-block checkpointing of the
encoders (counterpart of ``alpro_tpu/ops/layers.py``).

LayerNorm statistics are one-pass fp32 (E[x²]−E[x]², clamped at 0) whatever
the compute dtype. That is not the algorithm of ``torch.nn.functional
.layer_norm`` (Welford), so it is written out here; the JAX package, the
fused kernels and this module all share it. ``LayerNorm(impl='pallas')`` runs
it as the CUDA kernel of ``ops/layernorm.py``, as the JAX module's
``impl='pallas'`` runs its Pallas kernel. The exact GELU on a CUDA tensor is
the kernel of ``ops/gelu.py`` (one pass forward, one backward), on a CPU
tensor its plain twin.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint
from torch import nn

from alpro_tpu_torch.models.remat import layernorm_region
from alpro_tpu_torch.ops.gelu import gelu
from alpro_tpu_torch.ops.kernel_math import ln_rows_f32
from alpro_tpu_torch.ops.layernorm import layernorm


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU evaluated in fp32, returned in ``x.dtype``
    (``ops/gelu.py``: the kernel on a CUDA tensor, the twin on a CPU one)."""
    return gelu(x)


def layernorm_apply(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float, out_dtype: torch.dtype) -> torch.Tensor:
    """Functional LN with one-pass fp32 statistics, cast to ``out_dtype``
    (inside ``layernorm_region``: ``remat_policy='dots_ln'`` keeps its
    statistics)."""
    with layernorm_region():
        return ln_rows_f32(x, scale, bias, eps).to(out_dtype)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics; parameters named ``weight``/``bias``
    as in the ALPRO state dict. Output dtype is the caller's compute dtype.

    impl (the JAX module's): 'auto' (the plain math, as JAX's 'auto' is XLA),
    'xla' or 'plain', or 'pallas' (the kernel of ``ops/layernorm.py``, with
    its analytic backward). No model config sets it."""

    def __init__(self, dim: int, eps: float, impl: str = "auto"):
        super().__init__()
        if impl not in ("auto", "xla", "plain", "pallas"):
            raise ValueError(f"LayerNorm impl={impl!r}: expected 'auto', 'xla', 'plain' or "
                             "'pallas'")
        self.eps = float(eps)
        self.impl = impl
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
        if self.impl == "pallas":
            return layernorm(x, self.weight, self.bias, eps=self.eps, out_dtype=out_dtype)
        return layernorm_apply(x, self.weight, self.bias, self.eps, out_dtype)


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``x @ W.T + b`` in the compute dtype (flax ``Dense(dtype=...)``: the
    fp32-stored weights are cast to the compute dtype at use)."""
    b = None if layer.bias is None else layer.bias.to(dtype)
    return torch.nn.functional.linear(x.to(dtype), layer.weight.to(dtype), b)


# ---- training-time randomness, drawn from explicit generators ----------------
# Masks come from the ``generator`` passed in (on the activations' device), never
# from the global RNG, so a train step's draws are a function of its seed and
# step (see ``checkpoint``).


def _keep_mask(shape, rate: float, generator: torch.Generator, device) -> torch.Tensor:
    if generator is None:
        raise ValueError(f"a dropout or drop-path rate of {rate} in training needs a generator")
    # out of place (aten.bernoulli.p, bernoulli_'s draws): an op whose output
    # remat_policy='dots_rng' can keep
    return torch.bernoulli(torch.empty(shape, device=device), 1.0 - rate,
                           generator=generator).bool()


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            training: bool, rows: Optional[tuple] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: in training, each element kept with probability
    1 - rate and scaled by 1/(1 - rate); the identity otherwise. ``rows``
    (n, start): x holds rows [start, start + x.shape[-2]) of n along dim -2;
    the mask is drawn for all n rows and those rows of it kept, so that a
    split along dim -2 draws what the whole does."""
    if not training or rate == 0.0:
        return x
    if rows is None:
        keep = _keep_mask(x.shape, rate, generator, x.device)
    else:
        n, start = rows
        keep = _keep_mask((*x.shape[:-2], n, x.shape[-1]), rate, generator, x.device)
        keep = keep[..., start:start + x.shape[-2], :]
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def drop_path(x: torch.Tensor, rate: float, mask_shape, generator: Optional[torch.Generator],
              training: bool) -> torch.Tensor:
    """Stochastic depth (``layers.py::apply_drop_path`` and the TimeSformer
    block's masks): one keep draw per entry of ``mask_shape`` (x's shape with
    1 on the shared axes), as ``x · keep / keep_prob`` in x's dtype."""
    if not training or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = _keep_mask(mask_shape, rate, generator, x.device).to(x.dtype)
    return x * keep / torch.tensor(keep_prob, dtype=x.dtype, device=x.device)


def checkpoint(fn, generator: Optional[torch.Generator], *args, context_fn=None):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant), keeping
    what the selective-checkpoint ``context_fn`` of ``models/remat.py``
    keeps (None: nothing inside ``fn``, the JAX package's
    ``remat_policy='nothing'``). The recompute in the backward pass draws its
    dropout and drop-path masks from ``generator`` as the forward did, under
    every policy: its state at the forward's start is restored for the
    recompute, and the state the step had reached is put back after it
    (checkpoint itself preserves only the global RNG); under ``dots_rng``
    the recompute reads the kept draws instead and the restored state goes
    unused."""
    kw = {} if context_fn is None else {"context_fn": context_fn}
    if generator is None:
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False, **kw)
    start = generator.get_state()
    first = [True]

    def run(*a):
        if first[0]:
            first[0] = False
            return fn(*a)
        resume = generator.get_state()
        generator.set_state(start)
        try:
            return fn(*a)
        finally:
            generator.set_state(resume)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False, **kw)
