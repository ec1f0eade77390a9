"""The reference's QA finetuning steps: cross entropy over the answer labels,
gradients by autograd in fp32, and AdamW as the configuration states it
(optax's chain: gradients averaged over ``gradient_accumulation_steps``
calls, clipped to the global norm ``grad_norm``, Adam with ``betas`` and
eps 1e-6 outside the square root, no weight decay, the learning rate of a
linear schedule with 10% warmup and a floor of 1e-8)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.alpro import Net, exact_fp32, qa_logits


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of micro-step ``step``: seeded from (seed, step) as the
    program seeds its own, so both sides draw the same masks."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1))
    return g


def linear_lr(count: int, base: float, total: int, warmup_ratio: float = 0.1) -> float:
    warm = int(warmup_ratio * total)
    if count < warm:
        mult = count / max(warm, 1)
    else:
        mult = max(0.0, (total - count) / max(total - warm, 1))
    return max(base * mult, 1e-8)


def qa_steps(w0: Dict[str, torch.Tensor], cfg: dict, batches: List[dict], seed: int,
             opt_steps: int, total_opt_steps: int, numerics: str = "fp32") -> dict:
    """``opt_steps`` optimizer steps of ``accum`` micro-steps each on
    ``batches`` (one per micro-step, on the device) from weights ``w0``
    (not changed). Returns each micro-step's loss, each parameter's first
    gradient as the optimizer gets it (averaged, clipped) and its change
    after the steps."""
    accum = int(cfg.get("gradient_accumulation_steps", 1))
    b1, b2 = cfg["betas"]
    clip = float(cfg["grad_norm"])
    names = list(w0)
    params = {n: w0[n].detach().clone().requires_grad_(True) for n in names}
    mu = {n: torch.zeros_like(params[n]) for n in names}
    nu = {n: torch.zeros_like(params[n]) for n in names}
    losses, first_grad = [], None
    net = Net(params, numerics)
    ckpt = bool(cfg["visual_model_cfg"].get("gradient_checkpointing", False))
    with exact_fp32():
        for opt_step in range(opt_steps):
            acc = {n: torch.zeros_like(params[n]) for n in names}
            for k in range(accum):
                micro = opt_step * accum + k
                batch = batches[micro]
                g = step_generator(seed, micro, batch["visual_inputs"].device)
                logits = qa_logits(net, batch["visual_inputs"], batch["text_input_ids"].long(),
                                   batch["text_input_mask"].long(), cfg, g, train=True, ckpt=ckpt)
                loss = F.cross_entropy(logits, batch["labels"].long())
                grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
                with torch.no_grad():
                    for n, gr in zip(names, grads):
                        if gr is not None:
                            acc[n] += gr / accum
                losses.append(float(loss.detach()))
                del logits, loss, grads
            with torch.no_grad():
                norm = torch.sqrt(sum(torch.sum(a * a) for a in acc.values()))
                if norm >= clip:
                    acc = {n: a / norm * clip for n, a in acc.items()}
                if first_grad is None:
                    first_grad = {n: float(torch.linalg.vector_norm(a)) for n, a in acc.items()}
                t = opt_step + 1
                lr = linear_lr(opt_step, float(cfg["learning_rate"]), total_opt_steps)
                for n in names:
                    mu[n] = (1 - b1) * acc[n] + b1 * mu[n]
                    nu[n] = (1 - b2) * acc[n] * acc[n] + b2 * nu[n]
                    u = (mu[n] / (1 - b1 ** t)) / (torch.sqrt(nu[n] / (1 - b2 ** t)) + 1e-6)
                    params[n].add_(-lr * u)
                if "temp" in params:
                    params["temp"].clamp_(0.001, 0.5)
    with torch.no_grad():
        delta = {n: float(torch.linalg.vector_norm(params[n] - w0[n])) for n in names}
    return {"losses": losses, "first_grad": first_grad, "delta": delta}
