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

``shard_step(step, mesh)`` runs the same step over the mesh's ``dp`` group,
each process on its b rows of the global batch, and computes the JAX step's
global program: each loss is the process's share of the global loss (a
row mean 1/W of its rows' mean, MLM and MPM over the counts of the whole
batch), VTC and VTM read the group's gathered rows with gradient, the
gradients are summed over ``dp`` in one flat all-reduce per dtype before the
optimizer clips and updates, and the metrics are summed over ``dp``. With
W > 1, dropout and drop-path draw from (seed, step, dp rank) and the hard
negatives from (seed, step), the same on every process; with W = 1 one
generator serves both, so the wrapped step is the unwrapped one bit for bit.

Over a (DP, SP) mesh with SP > 1 the step runs inside ``use_mesh(mesh)``,
where a video tower built with ``sp_axis='sp'`` splits its temporal
attention's frames over ``sp``. The SP processes of a dp coordinate hold
the same rows (sp rank 0 alone loads them, and its batch and extras are
broadcast over ``sp``: loader threads' draws would part the processes,
and the other ranks' loaders read nothing, ``BatchLoader(placeholder=
True)``), draw from the same generators (seeded by
the dp coordinate) and compute the same loss, but each holds only its
frames' part of the temporal weights' gradient. The rule: each process's
loss is its dp share / SP, and the gradients and metrics are summed over
every process. It is exact because the frame gathers' backward
(``all_gather_with_grad``) already sums over ``sp``: the processes' losses
add up to the global loss, and each process's gradient is its part of that
sum's. VTC and VTM gather over ``dp`` alone.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from alpro_tpu_torch.core.mesh import SEQ_AXIS, use_mesh
from alpro_tpu_torch.core.trace import span
from alpro_tpu_torch.models.alpro import AlproModel
from alpro_tpu_torch.objectives.mlm import IGNORE_INDEX, mlm_loss
from alpro_tpu_torch.objectives.pem import masked_patch_mean, mpm_loss, pseudo_labels_from_feats
from alpro_tpu_torch.objectives.vtc import vtc_loss
from alpro_tpu_torch.objectives.vtm import sample_hard_negatives, vtm_loss_from_logits
from alpro_tpu_torch.parallel.collectives import (
    all_gather,
    all_gather_with_grad,
    all_reduce_sum,
    flat_all_reduce_,
    group_rank,
    group_size,
)
from alpro_tpu_torch.serving.inference import qa_logits
from alpro_tpu_torch.train.optimizer import project_temp
from alpro_tpu_torch.train.state import TrainState


def step_generator(seed: int, step: int, device, *more: int) -> torch.Generator:
    """The generator of one train step, seeded from (seed, step, *more)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, step, *more]).generate_state(
        1, np.uint64)[0] >> 1))
    return g


@dataclasses.dataclass
class StepContext:
    """What a loss function draws from and reduces over: the dropout and
    drop-path generator, the hard negatives' generator (the same object in
    one process), and the ``dp`` group (None in one process)."""

    generator: torch.Generator
    negatives: torch.Generator
    group: Optional[object] = None

    def share(self, mean: torch.Tensor) -> torch.Tensor:
        """This process's share of a mean over the global batch's rows."""
        return mean if self.group is None else mean / group_size(self.group)


def _alignment_forward(model: AlproModel, batch, generator) -> Dict[str, torch.Tensor]:
    """Both towers and the contrastive features (shared by retrieval,
    pretraining and the prompter)."""
    video_embeds = model.embed_video(batch["visual_inputs"], generator)
    text_embeds = model.embed_text(batch["text_input_ids"], batch["text_input_mask"], generator)
    return dict(video_embeds=video_embeds, text_embeds=text_embeds,
                video_feat=model.video_feat(video_embeds), text_feat=model.text_feat(text_embeds),
                temp=model.temperature())


def _vtm_forward(model: AlproModel, batch, fwd, sim_v2t, sim_t2v, ctx: StepContext,
                 num_local_blocks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hard-negative VTM in one 3B-row fusion call: rows [0, B) are (text_i,
    video_i), [B, 2B) (text_i, video[neg_video_idx_i]), [2B, 3B)
    (text[neg_text_idx_i], video_i). With a group, B is this process's rows
    and the negatives are rows of the group's gathered embeddings and masks.
    Returns (vtm_loss, fusion of the positives)."""
    text_embeds, video_embeds = fwd["text_embeds"], fwd["video_embeds"]
    text_mask = batch["text_input_mask"]
    neg_text_idx, neg_video_idx = sample_hard_negatives(
        ctx.negatives, sim_v2t.detach(), sim_t2v.detach(), num_local_blocks, group=ctx.group)
    B = text_embeds.shape[0]
    text_neg = all_gather_with_grad(text_embeds, ctx.group)[neg_text_idx]
    mask_neg = all_gather(text_mask, ctx.group)[neg_text_idx]
    video_neg = all_gather_with_grad(video_embeds, ctx.group)[neg_video_idx]
    text_all = torch.cat([text_embeds, text_embeds, text_neg])
    mask_all = torch.cat([text_mask, text_mask, mask_neg])
    video_all = torch.cat([video_embeds, video_neg, video_embeds])
    fusion_all = model.fuse(text_all, mask_all, video_all, None, ctx.generator)
    logits = model.itm_logits(fusion_all[:, 0, :])
    loss, _, _ = vtm_loss_from_logits(logits[:B], logits[B:], group=ctx.group)
    return loss, fusion_all[:B]


def retrieval_loss(model: AlproModel, batch, ctx,
                   num_local_blocks: int = 1) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """VTC + VTM on a batch of ``visual_inputs``, ``text_input_ids`` and
    ``text_input_mask``: (loss, metrics ``loss``/``vtc_loss``/``vtm_loss``).
    ``ctx``: the step's ``StepContext``."""
    fwd = _alignment_forward(model, batch, ctx.generator)
    vtc, sim_v2t, sim_t2v = vtc_loss(fwd["video_feat"], fwd["text_feat"], fwd["temp"],
                                     group=ctx.group)
    vtm, _ = _vtm_forward(model, batch, fwd, sim_v2t, sim_t2v, ctx, num_local_blocks)
    loss = vtc + vtm
    return loss, {"loss": loss.detach(), "vtc_loss": vtc.detach(), "vtm_loss": vtm.detach()}


def qa_loss(model: AlproModel, batch, ctx,
            n_options: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross entropy of ``qa_logits`` against ``labels`` (B,): (loss, acc),
    each this process's share with a group. ``ctx``: the step's
    ``StepContext``."""
    logits = qa_logits(model, batch, n_options, ctx.generator)
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.mean(torch.gather(logp, 1, labels[:, None]))
    acc = torch.mean((logits.argmax(dim=-1) == labels).float())
    return ctx.share(loss), ctx.share(acc)


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _grads(model) -> list:
    """Every parameter's gradient, zeros where a step gave it none."""
    return [torch.zeros_like(p) if p.grad is None else p.grad for p in model.parameters()]


def _apply_updates(state: TrainState, optimizer, grads: list) -> None:
    params = [p for _, p in state.model.named_parameters()]
    with torch.no_grad():
        optimizer.update(state.opt_state, params, grads)
    project_temp(state.model)
    state.step += 1


def _sum_metrics(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """Each metric (a share) summed over the group, in one all-reduce."""
    keys = list(metrics)
    total = all_reduce_sum(torch.stack([metrics[k].float() for k in keys]), group)
    return {k: total[i].to(metrics[k].dtype) for i, k in enumerate(keys)}


class TrainStep:
    """``loss_fn(batch, ctx, *extras) -> (loss, metrics)`` as a train step;
    the model is in training mode for the step and back in its mode after.
    ``group`` None: one process. Else the ``dp`` group of ``shard_step``,
    whose ``mesh`` the step runs under (None: no mesh)."""

    def __init__(self, model, optimizer, loss_fn: Callable, group=None, mesh=None):
        self.model, self.optimizer, self.loss_fn, self.group = model, optimizer, loss_fn, group
        self.mesh = mesh
        self.sp = 1 if mesh is None else mesh.sp_size
        # where the gradients and metrics are summed: dp, or every process under sp
        self.reduce_group = dist.group.WORLD if self.sp > 1 else group

    def _context(self, seed: int, step: int) -> StepContext:
        device = _device(self.model)
        g = step_generator(seed, step, device)
        if group_size(self.group) == 1:
            return StepContext(g, g, self.group)
        return StepContext(step_generator(seed, step, device, group_rank(self.group)), g,
                           self.group)

    def _sp_rows(self, batch, extras) -> tuple:
        """(batch, extras) of sp rank 0 on every process of its ``sp``
        group: the keys, shapes, dtypes and extras in one object broadcast,
        then each tensor; the other ranks' own batch goes unread."""
        axis = self.mesh[SEQ_AXIS]
        src = dist.get_global_rank(axis.group, 0)
        lead = axis.rank == 0
        spec = [([(k, tuple(v.shape), v.dtype) for k, v in batch.items()], extras)
                if lead else None]
        dist.broadcast_object_list(spec, src, group=axis.group)
        layout, extras = spec[0]
        if not lead:
            device = _device(self.model)
            batch = {k: torch.empty(shape, dtype=dtype, device=device)
                     for k, shape, dtype in layout}
        for k, _, _ in layout:
            dist.broadcast(batch[k], src, group=axis.group)
        return batch, tuple(extras)

    def __call__(self, state: TrainState, batch, seed: int = 0, *extras):
        with span("step", rid=state.step):
            return self._step(state, batch, seed, *extras)

    def _step(self, state: TrainState, batch, seed: int, *extras):
        model = self.model
        was_training = model.training
        model.train()
        try:
            model.zero_grad(set_to_none=True)
            with use_mesh(self.mesh):
                if self.sp > 1:
                    batch, extras = self._sp_rows(batch, extras)
                with span("step.forward"):
                    loss, metrics = self.loss_fn(batch, self._context(seed, state.step), *extras)
                if self.sp > 1:  # the SP equal losses add up to the dp share
                    loss = loss / self.sp
                    metrics = {k: v / self.sp for k, v in metrics.items()}
                with span("step.backward"):
                    loss.backward()
        finally:
            model.train(was_training)
        grads = _grads(model)
        if self.reduce_group is not None:
            with span("step.reduce"):
                flat_all_reduce_(grads, self.reduce_group)
                metrics = _sum_metrics(metrics, self.reduce_group)
        with span("step.optimizer"):
            _apply_updates(state, self.optimizer, grads)
        model.zero_grad(set_to_none=True)
        return state, metrics


def shard_step(step_fn: TrainStep, mesh) -> TrainStep:
    """The step over ``mesh``: each process feeds its dp coordinate's b rows
    of the global batch and gets the global step's update and metrics; over
    a (DP, SP) mesh the step runs under ``use_mesh(mesh)`` and the SP
    processes of a coordinate split the frames (the module docstring's
    rule). ``accum_steps`` and every ``remat_policy`` go through unchanged
    (the gradients are summed at each micro-step, as the JAX step's are).
    DDP's module wrapper does not fit: the steps call ``embed_video``,
    ``embed_text`` and ``fuse``, not ``forward``."""
    return TrainStep(step_fn.model, step_fn.optimizer, step_fn.loss_fn, group=mesh.dp.group,
                     mesh=mesh)


def make_retrieval_train_step(model: AlproModel, optimizer,
                              num_local_blocks: int = 1) -> TrainStep:
    """Retrieval finetuning: loss = VTC + VTM; metrics ``loss``,
    ``vtc_loss``, ``vtm_loss``."""
    return TrainStep(model, optimizer,
                     lambda batch, ctx: retrieval_loss(model, batch, ctx, num_local_blocks))


def make_qa_train_step(model: AlproModel, optimizer, n_options: int = 1, n_clips: int = 1,
                       num_frm: Optional[int] = None) -> TrainStep:
    """QA finetuning. ``n_clips > 1``: the (B, n_clips·num_frm, ...) frame
    stack splits into per-clip forwards; every clip's loss is computed, but —
    the reference's quirk, kept — only the last clip's loss is
    backpropagated (earlier clips run in training mode without a graph).
    ``n_options > 1``: multi-choice rows (``qa_logits``)."""

    def loss_fn(batch, ctx):
        if n_clips <= 1:
            loss, acc = qa_loss(model, batch, ctx, n_options)
            return loss, {"loss": loss.detach(), "acc": acc}
        if num_frm is None:
            raise ValueError("n_clips > 1 needs num_frm")
        vis = batch["visual_inputs"]
        vis = vis.reshape(vis.shape[0], n_clips, num_frm, *vis.shape[2:])
        losses, accs = [], []
        for c in range(n_clips):
            sub = dict(batch, visual_inputs=vis[:, c])
            with torch.set_grad_enabled(c == n_clips - 1):
                loss_c, acc_c = qa_loss(model, sub, ctx, n_options)
            losses.append(loss_c)
            accs.append(acc_c)
        loss = losses[-1]
        return loss, {"loss": loss.detach(), "acc": accs[-1],
                      "loss_all_clips": torch.stack([x.detach() for x in losses]).mean(),
                      "acc_all_clips": torch.stack(accs).mean()}

    return TrainStep(model, optimizer, loss_fn)


# ---- pretraining (VTC + VTM + MLM + MPM) and the prompter (VTC) ----
def _teacher_pseudo_labels(teacher: AlproModel, batch, bank: torch.Tensor):
    """The frozen teacher's soft labels and ignore mask for the erased crops
    (its eval-mode video tower, its feature and temperature, no graph)."""
    with span("teacher"), torch.no_grad():
        crop_feat = teacher.video_feat(teacher.embed_video(batch["crop_visual_inputs"]))
        return pseudo_labels_from_feats(crop_feat, bank, teacher.temperature())


def _mlm_logits(model: AlproModel, batch, video_embeds, generator) -> torch.Tensor:
    """The masked ids through the text half, fused with the unmasked step's
    ``video_embeds`` (no detach), the MLM head on the text rows."""
    ids, mask = batch["mlm_text_input_ids"], batch["text_input_mask"]
    text = model.embed_text(ids, mask, generator)
    fusion = model.fuse(text, mask, video_embeds, None, generator)
    return model.mlm_logits(fusion[:, :ids.shape[1], :])


def _mpm(model: AlproModel, teacher: AlproModel, batch, bank, fusion_pos,
         group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """MPM: the student's MPM logits of the mean fusion row over the erased
    patches of the VTM positives, against the teacher's soft labels →
    (loss, this process's rows kept: the count the loss divides by before
    it is summed over the group)."""
    soft, ignore = _teacher_pseudo_labels(teacher, batch, bank)
    mean = masked_patch_mean(fusion_pos, batch["mpm_mask"], batch["text_input_ids"].shape[1])
    kept = ignore.shape[0] - ignore.sum()
    return mpm_loss(model.mpm_logits(mean), soft, ignore, group=group, kept=kept), kept


def _check_objectives(use_itm: bool, use_mpm: bool, teacher) -> None:
    if use_mpm and not use_itm:
        raise ValueError("use_mpm needs use_itm: MPM reads the fusion of the VTM positives")
    if use_mpm and teacher is None:
        raise ValueError("use_mpm needs a teacher")


def make_pretrain_train_step(model: AlproModel, optimizer, use_itc: bool = True,
                             use_itm: bool = True, use_mlm: bool = True, use_mpm: bool = True,
                             num_local_blocks: int = 1, teacher: Optional[AlproModel] = None,
                             banks: Optional[Dict[str, torch.Tensor]] = None) -> TrainStep:
    """ALPRO pretraining: loss = the sum of VTC, VTM, MLM and MPM as the
    ``use_*`` flags select (VTC is computed either way: VTM's hard negatives
    read its similarities). ``step(state, batch, seed, task_type='video')``:
    MPM pseudo-labels the batch's erased crops by the frozen ``teacher``
    against ``banks[task_type]``. The teacher is outside the train state:
    not optimized, not checkpointed. Metrics: ``itc_loss``, ``itm_loss``,
    ``mlm_loss``, ``mpm_loss`` (the ones in use), ``loss`` and, with MPM,
    ``mpm_kept``: the rows whose largest soft label reaches
    ``MPM_IGNORE_THRESHOLD``, a device tensor summed over the group like
    every metric. Each objective runs in its span, ``alpro.pretrain.vtc``,
    ``.vtm``, ``.mlm`` and ``.mpm`` (⊃ ``alpro.teacher``)."""
    _check_objectives(use_itm, use_mpm, teacher)

    def loss_fn(batch, ctx, task_type: str = "video"):
        fwd = _alignment_forward(model, batch, ctx.generator)
        metrics: Dict[str, torch.Tensor] = {}
        loss = torch.zeros((), device=fwd["video_feat"].device)
        with span("pretrain.vtc"):
            vtc, sim_v2t, sim_t2v = vtc_loss(fwd["video_feat"], fwd["text_feat"], fwd["temp"],
                                             group=ctx.group)
            if use_itc:
                loss = loss + vtc
                metrics["itc_loss"] = vtc.detach()
        fusion_pos = None
        if use_itm:
            with span("pretrain.vtm"):
                vtm, fusion_pos = _vtm_forward(model, batch, fwd, sim_v2t, sim_t2v, ctx,
                                               num_local_blocks)
                loss = loss + vtm
                metrics["itm_loss"] = vtm.detach()
        if use_mlm:
            with span("pretrain.mlm"):
                mlm = mlm_loss(_mlm_logits(model, batch, fwd["video_embeds"], ctx.generator),
                               batch["mlm_labels"], group=ctx.group)
                loss = loss + mlm
                metrics["mlm_loss"] = mlm.detach()
        if use_mpm:
            with span("pretrain.mpm"):
                mpm, kept = _mpm(model, teacher, batch, banks[task_type], fusion_pos,
                                 group=ctx.group)
                loss = loss + mpm
                metrics["mpm_loss"] = mpm.detach()
                metrics["mpm_kept"] = kept
        metrics["loss"] = loss.detach()
        return loss, metrics

    return TrainStep(model, optimizer, loss_fn)


def _accuracy(sim: torch.Tensor, group=None) -> torch.Tensor:
    """The share of rows whose best column is their own (global) one."""
    labels = torch.arange(sim.shape[0], device=sim.device) + sim.shape[0] * group_rank(group)
    acc = torch.mean((sim.argmax(dim=-1) == labels).float())
    return acc if group is None else acc / group_size(group)


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
            # the hard negatives' draw
            g = step_generator(0, 0, _device(model))
            ctx = StepContext(g, g)
            fwd = _alignment_forward(model, batch, ctx.generator)
            metrics: Dict[str, torch.Tensor] = {}
            vtc, sim_v2t, sim_t2v = vtc_loss(fwd["video_feat"], fwd["text_feat"], fwd["temp"])
            if use_itc:
                metrics.update(val_itc_loss=vtc, val_v2t_acc=_accuracy(sim_v2t),
                               val_t2v_acc=_accuracy(sim_t2v))
            fusion_pos = None
            if use_itm:
                metrics["val_itm_loss"], fusion_pos = _vtm_forward(
                    model, batch, fwd, sim_v2t, sim_t2v, ctx, num_local_blocks)
            if use_mlm and "mlm_text_input_ids" in batch:
                logits = _mlm_logits(model, batch, fwd["video_embeds"], ctx.generator)
                labels = batch["mlm_labels"]
                metrics["val_mlm_loss"] = mlm_loss(logits, labels)
                valid = labels != IGNORE_INDEX
                correct = (logits.argmax(dim=-1) == labels) & valid
                metrics["val_mlm_acc"] = correct.sum() / valid.sum().clamp(min=1)
            if use_mpm and teacher is not None and fusion_pos is not None and bank is not None:
                metrics["val_mpm_loss"] = _mpm(model, teacher, batch, bank, fusion_pos)[0]
            return metrics
        finally:
            model.train(was_training)

    return evaluate


def make_prompter_train_step(model: AlproModel, optimizer) -> TrainStep:
    """The prompter: loss = VTC; metrics ``loss``, ``i2t_acc``, ``t2i_acc``."""

    def loss_fn(batch, ctx):
        fwd = _alignment_forward(model, batch, ctx.generator)
        vtc, sim_v2t, sim_t2v = vtc_loss(fwd["video_feat"], fwd["text_feat"], fwd["temp"],
                                         group=ctx.group)
        return vtc, {"loss": vtc.detach(), "i2t_acc": _accuracy(sim_v2t, ctx.group),
                     "t2i_acc": _accuracy(sim_t2v, ctx.group)}

    return TrainStep(model, optimizer, loss_fn)
