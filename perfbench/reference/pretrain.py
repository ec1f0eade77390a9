"""The reference's ALPRO pretraining steps: VTC + VTM + MLM + MPM, the frozen
prompter teacher's soft labels of the erased crops against a prompt bank,
the banks themselves, gradients by autograd and AdamW, in fp32 (or with every
matmul in fp8: the control). Nothing of the program is imported.

* The student's video tower is recomputed block by block in the backward
  (``alpro.py::checkpointed``, which draws the forward's drop-path masks
  again), so that a micro-batch of 64 clips fits on the card in fp32; the
  program keeps the tower's activations. The arithmetic is the same.
* Dropout and drop-path draw from the micro-step's generator in the
  program's order: the video tower, the text half, the hard negatives (one
  ``multinomial`` over the 2B similarity rows), VTM's fusion, MLM's text
  half and fusion. The hard negatives are drawn here from that generator,
  and the picks that differ from the program's are counted; the losses use
  the program's picks, which the caller passes in (``picks``; where they
  are not of the batch's rows, its own), so that one flipped draw near a tie
  does not move VTM's loss by a whole pair.
* A bank row is the mean over the 12 templates of the teacher's L2-normed
  ``text_proj`` feature of the prompt (template-major rows, not normalized
  again); a soft label is the softmax over the bank of the teacher's crop
  feature over the teacher's temperature, and a row is ignored where its
  largest soft label is under 0.2. MPM's loss is the soft cross entropy of
  the kept rows over their count."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from perfbench.reference.alpro import (
    Net,
    exact_fp32,
    feature,
    fusion,
    text_embeds,
    video_tokens,
    vision_config,
)
from perfbench.reference.objectives import (
    AdamW,
    draw_negatives,
    gradients,
    step_generator,
    temperature,
    vtc,
    vtm,
)

IGNORE_BELOW = 0.2
MLM_HEAD = "text_encoder.cls.predictions."


@torch.no_grad()
def prompt_bank(tnet: Net, ids: torch.Tensor, mask: torch.Tensor, num_entities: int,
                bcfg: dict, chunk: int = 512) -> torch.Tensor:
    """(templates · entities, L) prompt ids, template-major → the
    (entities, 256) bank through the teacher's text half in eval mode."""
    feats = torch.cat([feature(tnet, text_embeds(tnet, ids[s:s + chunk].long(),
                                                 mask[s:s + chunk].long(), bcfg), "text_proj")
                       for s in range(0, ids.shape[0], chunk)])
    return feats.reshape(-1, num_entities, feats.shape[-1]).mean(dim=0)


@torch.no_grad()
def teacher_labels(tnet: Net, crops: torch.Tensor, bank: torch.Tensor, cfg: dict,
                   temp: float) -> dict:
    """The teacher's crop features (eval mode), soft labels and ignore mask."""
    feat = feature(tnet, video_tokens(tnet, crops, vision_config(cfg)), "vision_proj")
    soft = torch.softmax(feat @ bank.T / temp, dim=1)
    return {"feat": feat, "soft": soft, "ignore": soft.max(dim=1).values < IGNORE_BELOW}


def mlm_logits(net: Net, hidden: torch.Tensor, eps: float) -> torch.Tensor:
    """The MLM head: dense, exact GELU, LayerNorm, the decoder."""
    x = F.gelu(net.lin(hidden, MLM_HEAD + "transform.dense"))
    return net.lin(net.ln(x, MLM_HEAD + "transform.LayerNorm", eps), MLM_HEAD + "decoder")


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    valid = labels != -100
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long(),
                          ignore_index=-100, reduction="sum")
    return nll / valid.sum().clamp(min=1)


def mpm_loss(net: Net, fused_pos: torch.Tensor, patch_mask: torch.Tensor, txt_len: int,
             soft: torch.Tensor, ignore: torch.Tensor) -> torch.Tensor:
    """The MPM head on the mean fusion row of the erased patches (the
    visual CLS skipped) against the soft labels, over the rows kept."""
    B = fused_pos.shape[0]
    erased = 1.0 - patch_mask.reshape(B, -1).float()
    visual = fused_pos[:, txt_len + 1:]
    mean = (visual * erased[:, :, None]).sum(dim=1) / erased.sum(dim=1, keepdim=True).clamp(min=1)
    logits = net.lin(torch.relu(net.lin(mean, "mpm_head.0")), "mpm_head.2")
    ce = -(torch.log_softmax(logits, dim=1) * soft).sum(dim=1)
    ce = torch.where(ignore, torch.zeros((), device=ce.device), ce)
    return ce.sum() / (~ignore).sum().clamp(min=1)


def pretrain_loss(net: Net, batch: dict, labels: dict, cfg: dict, gen: torch.Generator,
                  picks: Optional[tuple] = None) -> dict:
    """One micro-step's objectives on a batch (the program's keys) with the
    teacher's ``labels`` of its crops: each loss, their sum, and the hard
    negatives drawn here beside the ones used, and the L2-normed video and
    text features that VTC contrasts."""
    bcfg, vcfg = cfg["model_config"], vision_config(cfg)
    ids, mask = batch["text_input_ids"].long(), batch["text_input_mask"].long()
    video = video_tokens(net, batch["visual_inputs"], vcfg, gen, train=True, ckpt=True)
    text = text_embeds(net, ids, mask, bcfg, gen, train=True)
    v_feat, t_feat = feature(net, video, "vision_proj"), feature(net, text, "text_proj")
    loss_vtc, sim_v2t, sim_t2v = vtc(v_feat, t_feat, temperature(net.w))
    drawn = draw_negatives(gen, sim_v2t, sim_t2v, int(cfg.get("vtm_negative_blocks", 1)))
    used = drawn if picks is None or picks[0].shape != drawn[0].shape else picks
    loss_vtm, fused_pos = vtm(net, text, mask, video, used[0], used[1], bcfg, gen, True)
    text_m = text_embeds(net, batch["mlm_text_input_ids"].long(), mask, bcfg, gen, train=True)
    fused_m = fusion(net, text_m, mask, video, bcfg, gen, train=True)
    loss_mlm = mlm_loss(mlm_logits(net, fused_m[:, :ids.shape[1]], bcfg["layer_norm_eps"]),
                        batch["mlm_labels"])
    loss_mpm = mpm_loss(net, fused_pos, batch["mpm_mask"], ids.shape[1], labels["soft"],
                        labels["ignore"])
    total = loss_vtc + loss_vtm + loss_mlm + loss_mpm
    return {"loss": total, "itc_loss": loss_vtc, "itm_loss": loss_vtm, "mlm_loss": loss_mlm,
            "mpm_loss": loss_mpm, "drawn": drawn, "used": used,
            "feats": (v_feat.detach(), t_feat.detach())}


def pretrain_steps(w0: Dict[str, torch.Tensor], tw: Dict[str, torch.Tensor], cfg: dict,
                   batches: List[dict], types: Sequence[str], prompts: Dict[str, tuple],
                   seed: int, opt_steps: int, total_opt_steps: int, teacher_temp: float,
                   picks: Optional[List[tuple]] = None, numerics: str = "fp32") -> dict:
    """``opt_steps`` optimizer steps of ``gradient_accumulation_steps``
    micro-steps each on ``batches`` (one a micro-step, on the device, whose
    task ``types`` pick the bank), from student weights ``w0`` and teacher
    weights ``tw`` (neither changed). ``prompts``: bank name → (ids, mask)
    of its prompts. Returns each micro-step's losses, the banks, each
    micro-step's soft labels and ignore mask and teacher crop features, its
    student's L2-normed VTC video and text features (``feats``), each
    parameter's first gradient as the optimizer gets it and its change after
    the steps, the hard negatives drawn here and how many of them differ
    from ``picks``."""
    accum = int(cfg.get("gradient_accumulation_steps", 1))
    names = list(w0)
    params = {n: w0[n].detach().clone().requires_grad_(True) for n in names}
    net, tnet = Net(params, numerics), Net(tw, numerics)
    opt = AdamW(params, cfg, total_opt_steps)
    out = {k: [] for k in ("loss", "itc_loss", "itm_loss", "mlm_loss", "mpm_loss", "soft",
                           "ignore", "teacher_feat", "feats")}
    out["picks"], out["picks_differ"], out["picks_compared"] = [], 0, 0
    with exact_fp32():
        out["banks"] = {k: prompt_bank(tnet, ids, mask, int(cfg["num_entities"]),
                                       cfg["model_config"], int(cfg.get("prompt_chunk_size", 512)))
                        for k, (ids, mask) in prompts.items()}
        for opt_step in range(opt_steps):
            acc = {n: torch.zeros_like(params[n]) for n in names}
            for k in range(accum):
                micro = opt_step * accum + k
                batch = batches[micro]
                labels = teacher_labels(tnet, batch["crop_visual_inputs"],
                                        out["banks"][types[micro]], cfg, teacher_temp)
                g = step_generator(seed, micro, batch["visual_inputs"].device)
                res = pretrain_loss(net, batch, labels, cfg, g,
                                    None if picks is None else picks[micro])
                grads = gradients(res["loss"], params)
                with torch.no_grad():
                    for n in names:
                        acc[n] += grads[n] / accum
                for key in ("loss", "itc_loss", "itm_loss", "mlm_loss", "mpm_loss"):
                    out[key].append(float(res[key].detach()))
                out["soft"].append(labels["soft"])
                out["ignore"].append(labels["ignore"])
                out["teacher_feat"].append(labels["feat"])
                out["feats"].append(res["feats"])
                out["picks"].append(res["drawn"])
                if picks is not None:
                    out["picks_differ"] += sum(int((a != b).sum())
                                               for a, b in zip(res["drawn"], res["used"]))
                    out["picks_compared"] += sum(a.numel() for a in res["drawn"])
                del res, grads
            opt.update(acc)
    with torch.no_grad():
        out["delta"] = {n: float(torch.linalg.vector_norm(params[n] - w0[n])) for n in names}
    out["first_grad"] = opt.first_grad
    return out
