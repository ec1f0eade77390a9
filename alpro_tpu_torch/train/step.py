"""Finetuning, pretraining and prompter steps (counterpart of
``alpro_tpu/train/step.py``).

A step is ``step(state, batch, seed, *extras) -> (state, metrics)``: the
model in training mode, one forward and backward, the optimizer update
applied to the parameters in place, ``project_temp``, and ``state.step + 1``.
Its randomness — dropout, drop-path, hard negatives — comes from one
``torch.Generator`` on the model's device, seeded from ``(seed, state.step)``
(``step_generator``), as the JAX step folds the step into its key. The losses
keep the reference's composition: retrieval = VTC + VTM, with the VTM
positives and both kinds of hard negatives in one 3B-row fusion call; QA =
cross entropy over the answer labels, with the reference's multi-clip quirk
(only the last clip's loss is backpropagated); pretraining = VTC + VTM + MLM
+ MPM under the ``use_*`` flags, MPM against the pseudo-labels of a frozen
teacher; the prompter = VTC alone.

A parameter that gets no gradient in a step (the QA classifier in a
retrieval model, the heads a QA step does not use) is updated with a zero
gradient, as the JAX step's gradient tree holds zeros there.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from alpro_tpu_torch.models.alpro import AlproModel
from alpro_tpu_torch.objectives.mlm import IGNORE_INDEX, mlm_loss
from alpro_tpu_torch.objectives.pem import masked_patch_mean, mpm_loss, pseudo_labels_from_feats
from alpro_tpu_torch.objectives.vtc import vtc_loss
from alpro_tpu_torch.objectives.vtm import sample_hard_negatives, vtm_loss_from_logits
from alpro_tpu_torch.serving.inference import qa_logits
from alpro_tpu_torch.train.optimizer import project_temp
from alpro_tpu_torch.train.state import TrainState


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one train step, seeded from (seed, step)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1))
    return g


def _alignment_forward(model: AlproModel, batch, generator) -> Dict[str, torch.Tensor]:
    """Both towers and the contrastive features (shared by retrieval,
    pretraining and the prompter)."""
    video_embeds = model.embed_video(batch["visual_inputs"], generator)
    text_embeds = model.embed_text(batch["text_input_ids"], batch["text_input_mask"], generator)
    return dict(video_embeds=video_embeds, text_embeds=text_embeds,
                video_feat=model.video_feat(video_embeds), text_feat=model.text_feat(text_embeds),
                temp=model.temperature())


def _vtm_forward(model: AlproModel, batch, fwd, sim_v2t, sim_t2v, generator,
                 num_local_blocks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hard-negative VTM in one 3B-row fusion call: rows [0, B) are (text_i,
    video_i), [B, 2B) (text_i, video[neg_video_idx_i]), [2B, 3B)
    (text[neg_text_idx_i], video_i). Returns (vtm_loss, fusion of the
    positives)."""
    text_embeds, video_embeds = fwd["text_embeds"], fwd["video_embeds"]
    text_mask = batch["text_input_mask"]
    neg_text_idx, neg_video_idx = sample_hard_negatives(
        generator, sim_v2t.detach(), sim_t2v.detach(), num_local_blocks)
    B = text_embeds.shape[0]
    text_all = torch.cat([text_embeds, text_embeds, text_embeds[neg_text_idx]])
    mask_all = torch.cat([text_mask, text_mask, text_mask[neg_text_idx]])
    video_all = torch.cat([video_embeds, video_embeds[neg_video_idx], video_embeds])
    fusion_all = model.fuse(text_all, mask_all, video_all, None, generator)
    logits = model.itm_logits(fusion_all[:, 0, :])
    loss, _, _ = vtm_loss_from_logits(logits[:B], logits[B:])
    return loss, fusion_all[:B]


def retrieval_loss(model: AlproModel, batch, generator,
                   num_local_blocks: int = 1) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """VTC + VTM on a batch of ``visual_inputs``, ``text_input_ids`` and
    ``text_input_mask``: (loss, metrics ``loss``/``vtc_loss``/``vtm_loss``)."""
    fwd = _alignment_forward(model, batch, generator)
    vtc, sim_v2t, sim_t2v = vtc_loss(fwd["video_feat"], fwd["text_feat"], fwd["temp"])
    vtm, _ = _vtm_forward(model, batch, fwd, sim_v2t, sim_t2v, generator, num_local_blocks)
    loss = vtc + vtm
    return loss, {"loss": loss.detach(), "vtc_loss": vtc.detach(), "vtm_loss": vtm.detach()}


def qa_loss(model: AlproModel, batch, generator,
            n_options: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross entropy of ``qa_logits`` against ``labels`` (B,): (loss, acc)."""
    logits = qa_logits(model, batch, n_options, generator)
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.mean(torch.gather(logp, 1, labels[:, None]))
    acc = torch.mean((logits.argmax(dim=-1) == labels).float())
    return loss, acc


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _apply_updates(state: TrainState, optimizer) -> None:
    params = [p for _, p in state.model.named_parameters()]
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    with torch.no_grad():
        optimizer.update(state.opt_state, params, grads)
    project_temp(state.model)
    state.step += 1


def _train_step(model, optimizer, loss_fn: Callable) -> Callable:
    """``loss_fn(batch, generator, *extras) -> (loss, metrics)`` as a train
    step; the model is in training mode for the step and back in its mode
    after."""

    def step(state: TrainState, batch, seed: int = 0, *extras):
        was_training = model.training
        model.train()
        try:
            model.zero_grad(set_to_none=True)
            loss, metrics = loss_fn(batch, step_generator(seed, state.step, _device(model)),
                                    *extras)
            loss.backward()
        finally:
            model.train(was_training)
        _apply_updates(state, optimizer)
        model.zero_grad(set_to_none=True)
        return state, metrics

    return step


def make_retrieval_train_step(model: AlproModel, optimizer,
                              num_local_blocks: int = 1) -> Callable:
    """Retrieval finetuning: loss = VTC + VTM; metrics ``loss``,
    ``vtc_loss``, ``vtm_loss``."""
    return _train_step(model, optimizer,
                       lambda batch, g: retrieval_loss(model, batch, g, num_local_blocks))


def make_qa_train_step(model: AlproModel, optimizer, n_options: int = 1, n_clips: int = 1,
                       num_frm: Optional[int] = None) -> Callable:
    """QA finetuning. ``n_clips > 1``: the (B, n_clips·num_frm, ...) frame
    stack splits into per-clip forwards; every clip's loss is computed, but —
    the reference's quirk, kept — only the last clip's loss is
    backpropagated (earlier clips run in training mode without a graph).
    ``n_options > 1``: multi-choice rows (``qa_logits``)."""

    def loss_fn(batch, g):
        if n_clips <= 1:
            loss, acc = qa_loss(model, batch, g, n_options)
            return loss, {"loss": loss.detach(), "acc": acc}
        if num_frm is None:
            raise ValueError("n_clips > 1 needs num_frm")
        vis = batch["visual_inputs"]
        vis = vis.reshape(vis.shape[0], n_clips, num_frm, *vis.shape[2:])
        losses, accs = [], []
        for c in range(n_clips):
            sub = dict(batch, visual_inputs=vis[:, c])
            with torch.set_grad_enabled(c == n_clips - 1):
                loss_c, acc_c = qa_loss(model, sub, g, n_options)
            losses.append(loss_c)
            accs.append(acc_c)
        loss = losses[-1]
        return loss, {"loss": loss.detach(), "acc": accs[-1],
                      "loss_all_clips": torch.stack([x.detach() for x in losses]).mean(),
                      "acc_all_clips": torch.stack(accs).mean()}

    return _train_step(model, optimizer, loss_fn)


# ---- pretraining (VTC + VTM + MLM + MPM) and the prompter (VTC) ----
def _teacher_pseudo_labels(teacher: AlproModel, batch, bank: torch.Tensor):
    """The frozen teacher's soft labels and ignore mask for the erased crops
    (its eval-mode video tower, its feature and temperature, no graph)."""
    with torch.no_grad():
        crop_feat = teacher.video_feat(teacher.embed_video(batch["crop_visual_inputs"]))
        return pseudo_labels_from_feats(crop_feat, bank, teacher.temperature())


def _mlm_logits(model: AlproModel, batch, video_embeds, generator) -> torch.Tensor:
    """The masked ids through the text half, fused with the unmasked step's
    ``video_embeds`` (no detach), the MLM head on the text rows."""
    ids, mask = batch["mlm_text_input_ids"], batch["text_input_mask"]
    text = model.embed_text(ids, mask, generator)
    fusion = model.fuse(text, mask, video_embeds, None, generator)
    return model.mlm_logits(fusion[:, :ids.shape[1], :])


def _mpm(model: AlproModel, teacher: AlproModel, batch, bank, fusion_pos) -> torch.Tensor:
    """MPM: the student's MPM logits of the mean fusion row over the erased
    patches of the VTM positives, against the teacher's soft labels."""
    soft, ignore = _teacher_pseudo_labels(teacher, batch, bank)
    mean = masked_patch_mean(fusion_pos, batch["mpm_mask"], batch["text_input_ids"].shape[1])
    return mpm_loss(model.mpm_logits(mean), soft, ignore)


def _check_objectives(use_itm: bool, use_mpm: bool, teacher) -> None:
    if use_mpm and not use_itm:
        raise ValueError("use_mpm needs use_itm: MPM reads the fusion of the VTM positives")
    if use_mpm and teacher is None:
        raise ValueError("use_mpm needs a teacher")


def make_pretrain_train_step(model: AlproModel, optimizer, use_itc: bool = True,
                             use_itm: bool = True, use_mlm: bool = True, use_mpm: bool = True,
                             num_local_blocks: int = 1, teacher: Optional[AlproModel] = None,
                             banks: Optional[Dict[str, torch.Tensor]] = None) -> Callable:
    """ALPRO pretraining: loss = the sum of VTC, VTM, MLM and MPM as the
    ``use_*`` flags select (VTC is computed either way: VTM's hard negatives
    read its similarities). ``step(state, batch, seed, task_type='video')``:
    MPM pseudo-labels the batch's erased crops by the frozen ``teacher``
    against ``banks[task_type]``. The teacher is outside the train state:
    not optimized, not checkpointed. Metrics: ``itc_loss``, ``itm_loss``,
    ``mlm_loss``, ``mpm_loss`` (the ones in use) and ``loss``."""
    _check_objectives(use_itm, use_mpm, teacher)

    def loss_fn(batch, g, task_type: str = "video"):
        fwd = _alignment_forward(model, batch, g)
        metrics: Dict[str, torch.Tensor] = {}
        loss = torch.zeros((), device=fwd["video_feat"].device)
        vtc, sim_v2t, sim_t2v = vtc_loss(fwd["video_feat"], fwd["text_feat"], fwd["temp"])
        if use_itc:
            loss = loss + vtc
            metrics["itc_loss"] = vtc.detach()
        fusion_pos = None
        if use_itm:
            vtm, fusion_pos = _vtm_forward(model, batch, fwd, sim_v2t, sim_t2v, g,
                                           num_local_blocks)
            loss = loss + vtm
            metrics["itm_loss"] = vtm.detach()
        if use_mlm:
            mlm = mlm_loss(_mlm_logits(model, batch, fwd["video_embeds"], g), batch["mlm_labels"])
            loss = loss + mlm
            metrics["mlm_loss"] = mlm.detach()
        if use_mpm:
            mpm = _mpm(model, teacher, batch, banks[task_type], fusion_pos)
            loss = loss + mpm
            metrics["mpm_loss"] = mpm.detach()
        metrics["loss"] = loss.detach()
        return loss, metrics

    return _train_step(model, optimizer, loss_fn)


def _accuracy(sim: torch.Tensor) -> torch.Tensor:
    labels = torch.arange(sim.shape[0], device=sim.device)
    return torch.mean((sim.argmax(dim=-1) == labels).float())


def make_pretrain_eval_fn(model: AlproModel, use_itc: bool = True, use_itm: bool = True,
                          use_mlm: bool = True, use_mpm: bool = False,
                          teacher: Optional[AlproModel] = None,
                          num_local_blocks: int = 1) -> Callable:
    """Pretraining validation: ``evaluate(batch, bank=None)`` →
    the JAX function's metrics of one batch in eval mode, without a graph:
    ``val_itc_loss``, ``val_v2t_acc``, ``val_t2v_acc``, ``val_itm_loss``,
    ``val_mlm_loss``, ``val_mlm_acc`` and ``val_mpm_loss`` (the ones in use;
    MPM where a teacher and a bank are given)."""

    @torch.no_grad()
    def evaluate(batch, bank: Optional[torch.Tensor] = None):
        was_training = model.training
        model.eval()
        try:
            g = step_generator(0, 0, _device(model))  # the hard negatives' draw
            fwd = _alignment_forward(model, batch, g)
            metrics: Dict[str, torch.Tensor] = {}
            vtc, sim_v2t, sim_t2v = vtc_loss(fwd["video_feat"], fwd["text_feat"], fwd["temp"])
            if use_itc:
                metrics.update(val_itc_loss=vtc, val_v2t_acc=_accuracy(sim_v2t),
                               val_t2v_acc=_accuracy(sim_t2v))
            fusion_pos = None
            if use_itm:
                metrics["val_itm_loss"], fusion_pos = _vtm_forward(
                    model, batch, fwd, sim_v2t, sim_t2v, g, num_local_blocks)
            if use_mlm and "mlm_text_input_ids" in batch:
                logits = _mlm_logits(model, batch, fwd["video_embeds"], g)
                labels = batch["mlm_labels"]
                metrics["val_mlm_loss"] = mlm_loss(logits, labels)
                valid = labels != IGNORE_INDEX
                correct = (logits.argmax(dim=-1) == labels) & valid
                metrics["val_mlm_acc"] = correct.sum() / valid.sum().clamp(min=1)
            if use_mpm and teacher is not None and fusion_pos is not None and bank is not None:
                metrics["val_mpm_loss"] = _mpm(model, teacher, batch, bank, fusion_pos)
            return metrics
        finally:
            model.train(was_training)

    return evaluate


def make_prompter_train_step(model: AlproModel, optimizer) -> Callable:
    """The prompter: loss = VTC; metrics ``loss``, ``i2t_acc``, ``t2i_acc``."""

    def loss_fn(batch, g):
        fwd = _alignment_forward(model, batch, g)
        vtc, sim_v2t, sim_t2v = vtc_loss(fwd["video_feat"], fwd["text_feat"], fwd["temp"])
        return vtc, {"loss": vtc.detach(), "i2t_acc": _accuracy(sim_v2t),
                     "t2i_acc": _accuracy(sim_t2v)}

    return _train_step(model, optimizer, loss_fn)
