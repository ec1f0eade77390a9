"""AdamW and the learning-rate schedules, with optax's semantics.

Counterpart of ``alpro_tpu/train/optimizer.py``. The schedules are those of
the reference (``warmup_linear``, ``noam_schedule``, ``multi_step_schedule``
with its quirk, ``get_lr_schedule`` with its 1e-8 floor), as Python floats of
the optimizer step. ``build_optimizer`` composes, as the JAX package's optax
chain does:

1. ``clip_by_global_norm(grad_norm)``: when the global norm g is not below
   the limit, every gradient becomes (grad / g) · limit;
2. Adam moments in fp32 (stored in ``mu_dtype`` / ``nu_dtype``, upcast on
   read), mu = (1-b1)·g + b1·mu, nu = (1-b2)·g² + b2·nu, bias correction at
   count t, update mu_hat / (sqrt(nu_hat) + eps) — eps outside the sqrt;
3. decoupled weight decay ``+ wd · param`` on the ``_wd_mask`` parameters
   (off by default: the reference never forwards its weight decay);
4. ``-lr(count) ·``, the schedule read at the number of earlier updates;
5. with ``accum_steps = k > 1``, ``optax.MultiSteps``: gradients are averaged
   (acc += (grad - acc) / (n + 1)) over k calls, and the update 1-4 runs on
   every k-th call only.

It is a small class of its own: ``torch.optim.AdamW`` places eps and the
decay differently. Parameters are updated in place (the JAX update returns
new arrays).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

import torch

_NO_DECAY = ("bias", "scale", "temp", "cls_token", "pos_embed", "time_embed")


# ---- schedules (value = multiplier · base_lr, evaluated per step) ----------
def warmup_linear(step: float, warmup_step: int, tot_step: int) -> float:
    if step < warmup_step:
        return step / max(warmup_step, 1)
    return max(0.0, (tot_step - step) / max(tot_step - warmup_step, 1))


def noam_schedule(step: float, warmup_step: int = 4000) -> float:
    if step <= warmup_step:
        return step / max(warmup_step, 1)
    return warmup_step ** 0.5 * max(step, 1) ** -0.5


def multi_step_schedule(n_epoch: int, milestones: Sequence[int], gamma: float = 0.5) -> float:
    """Reference-exact, including its quirk: past the last milestone the
    multiplier jumps to gamma^(len+1), skipping gamma^len."""
    n_passed = sum(n_epoch >= m for m in milestones)
    n = len(milestones)
    return gamma ** (n + 1 if n_passed == n else n_passed)


def get_lr_schedule(decay: str, learning_rate: float, num_train_steps: int,
                    warmup_ratio: float = 0.1, decay_epochs: Sequence[int] = (),
                    steps_per_epoch: int = 0) -> Callable[[int], float]:
    """step → learning rate, never below 1e-8 (the reference's safeguard).
    ``multi_step`` derives the epoch from the step as the reference does."""
    warmup_steps = int(warmup_ratio * num_train_steps)
    if decay == "multi_step" and not (steps_per_epoch > 0 and decay_epochs):
        raise ValueError("multi_step decay needs steps_per_epoch and decay_epochs")
    if decay not in ("linear", "invsqrt", "constant", "multi_step"):
        raise ValueError(f"unknown decay {decay!r}")

    def sched(step: int) -> float:
        step = float(step)
        if decay == "linear":
            lr = learning_rate * warmup_linear(step, warmup_steps, num_train_steps)
        elif decay == "invsqrt":
            lr = learning_rate * noam_schedule(step, warmup_steps)
        elif decay == "constant":
            lr = learning_rate
        else:
            lr = learning_rate * multi_step_schedule(math.floor(step / steps_per_epoch),
                                                     decay_epochs)
        return max(lr, 1e-8)

    return sched


# ---- parameter projections and masks --------------------------------------
@torch.no_grad()
def project_temp(model: torch.nn.Module, lo: float = 0.001, hi: float = 0.5) -> None:
    """Clamp the contrastive temperature in place after each update
    (``self.temp.clamp_(0.001, 0.5)`` of the reference)."""
    temp = getattr(model, "temp", None)
    if temp is not None:
        temp.clamp_(lo, hi)


def _wd_mask(name: str, param: torch.Tensor) -> bool:
    """True where weight decay applies: 2-D+ weights and embeddings only —
    never biases, LayerNorm parameters, cls/pos/time tokens or ``temp``."""
    return not any(k in name for k in _NO_DECAY) and param.dim() >= 2


def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (a host scalar: no device copy)."""
    return torch.tensor(value, dtype=dtype).item()


@dataclasses.dataclass
class AdamWState:
    count: int  # Adam updates applied
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    decay: List[bool]  # _wd_mask per parameter
    mini_step: int = 0  # calls into the current accumulation window
    acc: Optional[List[torch.Tensor]] = None


class AdamW:
    """The optax chain of ``build_optimizer`` on lists of torch tensors."""

    def __init__(self, schedule: Callable[[int], float], betas=(0.9, 0.98), eps: float = 1e-6,
                 weight_decay: float = 0.0, grad_norm: Optional[float] = None,
                 accum_steps: int = 1, mu_dtype: Optional[torch.dtype] = None,
                 nu_dtype: Optional[torch.dtype] = None):
        self.schedule = schedule
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.grad_norm = grad_norm if grad_norm and grad_norm > 0 else None
        self.accum_steps = accum_steps
        self.mu_dtype, self.nu_dtype = mu_dtype, nu_dtype

    def init(self, named_params: Dict[str, torch.Tensor]) -> AdamWState:
        ps = list(named_params.values())
        return AdamWState(
            count=0,
            mu=[torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for p in ps],
            nu=[torch.zeros_like(p, dtype=self.nu_dtype or p.dtype) for p in ps],
            decay=[_wd_mask(n, p) for n, p in named_params.items()],
            acc=[torch.zeros_like(p) for p in ps] if self.accum_steps > 1 else None,
        )

    @torch.no_grad()
    def update(self, state: AdamWState, params: List[torch.Tensor],
               grads: List[torch.Tensor]) -> bool:
        """Apply one call's gradients to ``params`` in place (same order as
        ``init``). Returns whether the parameters were updated (with
        accumulation, every ``accum_steps``-th call)."""
        g = [x.float() for x in grads]
        if self.accum_steps > 1:
            n = state.mini_step
            state.acc = [a + (x - a) / (n + 1) for a, x in zip(state.acc, g)]
            if n < self.accum_steps - 1:
                state.mini_step = n + 1
                return False
            g, state.acc = state.acc, [torch.zeros_like(a) for a in state.acc]
            state.mini_step = 0
        if self.grad_norm is not None:  # selected on the device: no host sync
            norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
            keep = norm < self.grad_norm
            g = [torch.where(keep, x, (x / norm) * self.grad_norm) for x in g]
        b1, b2 = self.b1, self.b2
        # optax.adamw multiplies a stored moment by b rounded to the moment's
        # dtype (a Python float is weakly typed in JAX; the jitted step keeps
        # the product in fp32); the JAX package's dtype-aware moments
        # (nu_dtype set) upcast the moment and keep b in fp32
        r1, r2 = ((b1, b2) if self.nu_dtype else
                  (_rounded(b1, state.mu[0].dtype), _rounded(b2, state.nu[0].dtype)))
        mu = [(1 - b1) * x + r1 * m.float() for x, m in zip(g, state.mu)]
        nu = [(1 - b2) * (x * x) + r2 * v.float() for x, v in zip(g, state.nu)]
        t = state.count + 1
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        lr = self.schedule(state.count)
        for i, p in enumerate(params):
            u = (mu[i] / bc1) / (torch.sqrt(nu[i] / bc2) + self.eps)
            if self.weight_decay and state.decay[i]:
                u = u + self.weight_decay * p
            p.add_((-lr) * u)
        state.mu = [m.to(self.mu_dtype) if self.mu_dtype else m for m in mu]
        state.nu = [v.to(self.nu_dtype) if self.nu_dtype else v for v in nu]
        state.count = t
        return True


def build_optimizer(learning_rate_schedule: Callable[[int], float], betas=(0.9, 0.98),
                    eps: float = 1e-6, weight_decay: float = 0.0,
                    apply_weight_decay: bool = False, grad_norm: Optional[float] = None,
                    accum_steps: int = 1, mu_dtype: Optional[str] = None,
                    nu_dtype: Optional[str] = None) -> AdamW:
    """AdamW as the JAX package builds it (module docstring); weight decay
    applies only with ``apply_weight_decay``; ``mu_dtype`` / ``nu_dtype``
    name a storage dtype ('bfloat16') for the moments."""
    return AdamW(
        learning_rate_schedule, betas=betas, eps=eps,
        weight_decay=weight_decay if apply_weight_decay else 0.0, grad_norm=grad_norm,
        accum_steps=accum_steps,
        mu_dtype=getattr(torch, mu_dtype) if mu_dtype else None,
        nu_dtype=getattr(torch, nu_dtype) if nu_dtype else None,
    )
