"""The plain forms of what ALPRO's retrieval finetuning and pretraining share:
the step's generators, VTC, VTM with hard negatives, the gather with
gradient of data-parallel training, and AdamW as the configurations state it.
Nothing of the program is imported.

With a ``torch.distributed`` group each process holds b rows of the global
batch of B: VTC scores its rows against the gathered features of both sides,
VTM draws its negatives from the gathered (B, B) similarities (the same
generator on every process, each keeping its own rows) and reads them from
the gathered embeddings, and each loss is this process's share, 1/W of its
rows' mean, so that the shares sum to the loss of the whole batch and the
gradients summed over the group are the whole batch's."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from perfbench.reference.alpro import Net, fusion


def step_generator(seed: int, step: int, device, *more: int) -> torch.Generator:
    """The generator seeded from (seed, step, *more): micro-step ``step``'s
    dropout and drop-path masks (``more``: the process's rank where there
    are several) and its hard negatives (no rank)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, step, *more]).generate_state(
        1, np.uint64)[0] >> 1))
    return g


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every process's rows along dim 0, in rank order, without gradient."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


class _GatherWithGrad(torch.autograd.Function):
    """Forward: ``gather``. Backward: the gathered gradient summed over the
    group (every process's loss reads every process's rows), then this
    process's rows of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        start = _rank(ctx.group) * ctx.rows
        return grad[start:start + ctx.rows], None


def gather_with_grad(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _GatherWithGrad.apply(x, group)


def share(mean: torch.Tensor, group) -> torch.Tensor:
    return mean / _size(group)


def vtc(video_feat, text_feat, temp, group=None):
    """The contrastive loss's share and the (b, B) similarity rows of both
    directions over the temperature."""
    g_vf, g_tf = gather_with_grad(video_feat, group), gather_with_grad(text_feat, group)
    sim_v2t = video_feat @ g_tf.T / temp
    sim_t2v = text_feat @ g_vf.T / temp
    target = torch.arange(video_feat.shape[0], device=video_feat.device) + \
        video_feat.shape[0] * _rank(group)
    loss = (F.cross_entropy(sim_v2t, target) + F.cross_entropy(sim_t2v, target)) / 2
    return share(loss, group), sim_v2t, sim_t2v


def draw_negatives(gen: torch.Generator, sim_v2t, sim_t2v, blocks: int,
                   group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(negative text of each video, negative video of each text) of this
    process's rows, as global indices: one draw a row from the softmax of its
    gathered similarity row, the row itself and every column outside its
    block of B / ``blocks`` rows left out, in one ``multinomial`` over the
    2B rows."""
    b = sim_v2t.shape[0]
    sim_v2t, sim_t2v = gather(sim_v2t.detach(), group), gather(sim_t2v.detach(), group)
    B = sim_v2t.shape[0]
    block = torch.arange(B, device=sim_v2t.device) // (B // blocks)
    allowed = (block[:, None] == block[None, :]) & ~torch.eye(B, dtype=torch.bool,
                                                              device=sim_v2t.device)
    bias = torch.where(allowed, 0.0, -1e30)
    probs = torch.softmax(torch.cat([sim_v2t + bias, sim_t2v + bias]), dim=-1)
    idx = torch.multinomial(probs, 1, generator=gen)[:, 0]
    start = _rank(group) * b
    return idx[start:start + b], idx[B + start:B + start + b]


def vtm(net: Net, text, mask, video, neg_text, neg_video, bcfg: dict, gen, train: bool,
        group=None):
    """VTM's share and the fusion of the positives: one fusion call over
    [positives; (text, negative video); (negative text, video)], the
    negatives read from the gathered embeddings and masks."""
    b = text.shape[0]
    text_all = torch.cat([text, text, gather_with_grad(text, group)[neg_text]])
    mask_all = torch.cat([mask, mask, gather(mask, group)[neg_text]])
    video_all = torch.cat([video, gather_with_grad(video, group)[neg_video], video])
    fused = fusion(net, text_all, mask_all, video_all, bcfg, gen, train)
    logits = net.lin(fused[:, 0], "itm_head")
    labels = torch.cat([torch.ones(b, dtype=torch.long, device=text.device),
                        torch.zeros(2 * b, dtype=torch.long, device=text.device)])
    return share(F.cross_entropy(logits, labels), group), fused[:b]


def linear_lr(count: int, base: float, total: int, warmup_ratio: float) -> float:
    warm = int(warmup_ratio * total)
    if count < warm:
        mult = count / max(warm, 1)
    else:
        mult = max(0.0, (total - count) / max(total - warm, 1))
    return max(base * mult, 1e-8)


class AdamW:
    """optax's chain as the configurations state it: the gradient clipped to
    the global norm ``grad_norm``, Adam with ``betas`` and eps 1e-6 outside
    the square root, no weight decay, the linear schedule with
    ``warmup_ratio`` warm-up and a floor of 1e-8; ``temp`` clamped to
    [0.001, 0.5] after each update. ``first_grad``: each parameter's norm of
    the first clipped gradient."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict, total_opt_steps: int):
        self.params, self.total = params, total_opt_steps
        self.b1, self.b2 = cfg["betas"]
        self.clip, self.lr = float(cfg["grad_norm"]), float(cfg["learning_rate"])
        self.warmup = float(cfg.get("warmup_ratio", 0.1))
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0
        self.first_grad: Optional[Dict[str, float]] = None

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> None:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        if norm >= self.clip:
            grads = {n: g / norm * self.clip for n, g in grads.items()}
        if self.first_grad is None:
            self.first_grad = {n: float(torch.linalg.vector_norm(g)) for n, g in grads.items()}
        lr = linear_lr(self.t, self.lr, self.total, self.warmup)
        self.t += 1
        b1, b2, t = self.b1, self.b2, self.t
        for n, p in self.params.items():
            self.mu[n] = (1 - b1) * grads[n] + b1 * self.mu[n]
            self.nu[n] = (1 - b2) * grads[n] * grads[n] + b2 * self.nu[n]
            u = (self.mu[n] / (1 - b1 ** t)) / (torch.sqrt(self.nu[n] / (1 - b2 ** t)) + 1e-6)
            p.add_(-lr * u)
        if "temp" in self.params:
            self.params["temp"].clamp_(0.001, 0.5)


def gradients(loss: torch.Tensor, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each parameter's gradient of ``loss``, zeros where it has none."""
    names = list(params)
    grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
    return {n: torch.zeros_like(params[n]) if g is None else g for n, g in zip(names, grads)}


def temperature(w: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.clamp(w["temp"], 0.001, 0.5)
