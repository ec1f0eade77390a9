"""The reference's data-parallel retrieval finetuning steps, one process a
card: VTC gathered over the group, VTM with hard negatives drawn from the
gathered (B, B) similarities, each loss this process's share, the gradients
summed over the group with ``torch.distributed``, then AdamW, in fp32 (or
with every matmul in fp8: the control). Nothing of the program is imported.

Dropout and drop-path draw from (seed, micro-step, rank), the hard negatives
from (seed, micro-step), as the program's data-parallel step draws them (one
process: both from the one generator of (seed, micro-step)).
The negatives are drawn here and the picks that differ from the program's
are counted; the losses use the program's picks (``picks``)."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from perfbench.reference.alpro import Net, exact_fp32, feature, text_embeds, video_tokens, \
    vision_config
from perfbench.reference.objectives import (
    AdamW,
    draw_negatives,
    gradients,
    step_generator,
    temperature,
    vtc,
    vtm,
)


def retrieval_loss(net: Net, batch: dict, cfg: dict, gen, negatives_gen, group,
                   picks: Optional[tuple] = None) -> dict:
    """This process's share of VTC + VTM on its rows of the global batch."""
    bcfg = cfg["model_config"]
    ids, mask = batch["text_input_ids"].long(), batch["text_input_mask"].long()
    ckpt = bool(cfg["visual_model_cfg"].get("gradient_checkpointing", False))
    video = video_tokens(net, batch["visual_inputs"], vision_config(cfg), gen, train=True,
                         ckpt=ckpt)
    text = text_embeds(net, ids, mask, bcfg, gen, train=True)
    v_feat, t_feat = feature(net, video, "vision_proj"), feature(net, text, "text_proj")
    loss_vtc, sim_v2t, sim_t2v = vtc(v_feat, t_feat, temperature(net.w), group)
    drawn = draw_negatives(negatives_gen, sim_v2t, sim_t2v,
                           int(cfg.get("vtm_negative_blocks", 1)), group)
    used = drawn if picks is None or picks[0].shape != drawn[0].shape else picks
    loss_vtm, _ = vtm(net, text, mask, video, used[0], used[1], bcfg, gen, True, group)
    return {"loss": loss_vtc + loss_vtm, "vtc_loss": loss_vtc, "vtm_loss": loss_vtm,
            "drawn": drawn, "used": used, "feats": (v_feat.detach(), t_feat.detach())}


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x


def retrieval_dp_steps(w0: Dict[str, torch.Tensor], cfg: dict, batches: List[dict], seed: int,
                       opt_steps: int, total_opt_steps: int, group=None,
                       picks: Optional[List[tuple]] = None, numerics: str = "fp32") -> dict:
    """``opt_steps`` optimizer steps on this process's ``batches`` (one a
    micro-step, on its card) from weights ``w0`` (not changed). Returns each
    micro-step's global loss (the shares summed over the group) and this
    process's L2-normed video and text features, each
    parameter's first gradient as the optimizer gets it (summed over the
    group, clipped), its change after the steps, the parameters themselves,
    the hard negatives drawn here and how many of them differ from
    ``picks``."""
    accum = int(cfg.get("gradient_accumulation_steps", 1))
    names = list(w0)
    params = {n: w0[n].detach().clone().requires_grad_(True) for n in names}
    net = Net(params, numerics)
    opt = AdamW(params, cfg, total_opt_steps)
    rank = dist.get_rank(group) if group is not None else 0
    world = dist.get_world_size(group) if group is not None else 1
    out = {"losses": [], "feats": [], "picks": [], "picks_differ": 0, "picks_compared": 0}
    with exact_fp32():
        for opt_step in range(opt_steps):
            acc = {n: torch.zeros_like(params[n]) for n in names}
            for k in range(accum):
                micro = opt_step * accum + k
                batch = batches[micro]
                dev = batch["visual_inputs"].device
                if world == 1:      # one process: one generator serves both
                    g = neg = step_generator(seed, micro, dev)
                else:
                    g, neg = step_generator(seed, micro, dev, rank), step_generator(seed, micro,
                                                                                      dev)
                res = retrieval_loss(net, batch, cfg, g, neg, group,
                                     None if picks is None else picks[micro])
                grads = gradients(res["loss"], params)
                with torch.no_grad():
                    for n in names:
                        acc[n] += grads[n] / accum
                out["picks"].append(res["drawn"])
                out["feats"].append(res["feats"])
                loss = res["loss"].detach()
                out["losses"].append(float(loss if group is None else _summed(loss, group)))
                if picks is not None:
                    out["picks_differ"] += sum(int((a != b).sum())
                                               for a, b in zip(res["drawn"], res["used"]))
                    out["picks_compared"] += sum(a.numel() for a in res["drawn"])
                del res, grads
            if group is not None:
                with torch.no_grad():
                    for n in names:
                        dist.all_reduce(acc[n], group=group)
            opt.update(acc)
    with torch.no_grad():
        out["delta"] = {n: float(torch.linalg.vector_norm(params[n] - w0[n])) for n in names}
    out["first_grad"] = opt.first_grad
    out["params"] = {n: p.detach() for n, p in params.items()}
    return out
