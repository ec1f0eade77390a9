"""ALPRO pretraining: VTC + VTM + MLM + PEM over video and image datasets
mixed by ``MetaLoader``.

The port's counterpart of ``alpro_tpu/cli/run_pretrain.py``:

    python -m alpro_tpu_torch.cli.run_pretrain --config configs/pretrain_alpro.json \
        --output_dir out/ [--device cpu]

The run builds the student (the pretraining model: the MLM head and the MPM
head over ``num_entities``), the frozen prompter teacher from
``teacher_weights_path`` (an ALPRO-key ``.pt``, such as ``run_prompter``'s
deploy checkpoint), the video and image prompt banks once through the
teacher's text half, one loader per ``train_datasets`` entry (``type``
``video`` or ``image``) mixed by ``MetaLoader``, and then trains through
``cli/common.py``'s setup and loop: ``validate`` over ``val_datasets``
(``num_val_batches`` batches of each), deploy checkpoints
``ckpt/model_step_N.pt`` and resume checkpoints in ``restore/``. The teacher
and the banks are not in the train state: a resumed run rebuilds them from
``teacher_weights_path``.

Each mixed batch's ``type`` leaves the batch before it is staged on the
device and travels beside it to the step, which picks the video or the image
bank by it (the JAX CLI's ``_MixIter``). The collated
``context_visual_inputs`` view is not read by the step, and is not staged.
"""

from __future__ import annotations

import os

import torch

from alpro_tpu_torch.checkpoint.reference import load_reference_checkpoint, merge_state_dict
from alpro_tpu_torch.cli import common
from alpro_tpu_torch.cli.prompts import (
    IMAGE_TEMPLATES,
    VIDEO_TEMPLATES,
    build_prompt_strings,
    load_entities,
)
from alpro_tpu_torch.core.config import Config, get_pretraining_args
from alpro_tpu_torch.core.distributed import data_shards, local_batch_size, reads_rows
from alpro_tpu_torch.core.logging import LOGGER, TB_LOGGER
from alpro_tpu_torch.data.datasets import (
    PretrainCollator,
    PretrainImageDataset,
    PretrainVideoDataset,
    load_datalist,
)
from alpro_tpu_torch.data.loader import BatchLoader, MetaLoader, stage_batch
from alpro_tpu_torch.data.tokenization import build_tokenizer
from alpro_tpu_torch.objectives.pem import build_prompt_bank
from alpro_tpu_torch.parallel.host_sync import all_gather_list
from alpro_tpu_torch.train.step import make_pretrain_eval_fn, make_pretrain_train_step

# collated for MPM but read by no step: kept on the host
_UNSTAGED = ("context_visual_inputs",)


def build_teacher(cfg: Config):
    """The frozen prompter: the bare model in eval mode, no gradient, its
    weights from ``teacher_weights_path`` merged over its init (a missing
    path warns and keeps the init, as the JAX CLI does)."""
    teacher = common.build_model_from_cfg(cfg, "prompter")
    path = cfg.get("teacher_weights_path")
    if path and os.path.exists(path):
        vis = teacher.visual_encoder.model.cfg
        sd, _ = load_reference_checkpoint(path, num_patches=vis.num_patches,
                                          num_frames=vis.num_frames)
        merge_state_dict(teacher, sd)
        LOGGER.info("teacher weights from %s", path)
    else:
        LOGGER.warning("teacher_weights_path missing; teacher runs from init")
    return teacher.eval().requires_grad_(False)


@torch.no_grad()
def setup_prompt_banks(cfg: Config, teacher, tokenizer) -> dict:
    """The video and image prompt banks, (num_entities, 256) each: 12
    templates × the entity list's first ``num_entities`` words through the
    teacher's text half, ``prompt_chunk_size`` prompts a call."""
    entities = load_entities(cfg.entity_file_path, cfg.get("num_entities", 1000))
    device = common.model_device(teacher)

    def encode(ids, mask):
        return teacher.text_feat(teacher.embed_text(ids, mask))

    banks = {}
    for name, templates in (("video", VIDEO_TEMPLATES), ("image", IMAGE_TEMPLATES)):
        enc = tokenizer(build_prompt_strings(entities, templates),
                        max_length=cfg.get("max_txt_len", 30))
        ids = torch.as_tensor(enc["input_ids"], device=device)
        mask = torch.as_tensor(enc["attention_mask"], device=device)
        banks[name] = build_prompt_bank(encode, ids, mask, len(entities),
                                        chunk_size=int(cfg.get("prompt_chunk_size", 512)))
        LOGGER.info("built %s prompt bank: %s", name, tuple(banks[name].shape))
    return banks


def build_pretrain_loaders(cfg: Config, tokenizer, use_mpm: bool,
                           placeholder: bool = False) -> dict:
    """One ``BatchLoader`` per ``train_datasets`` entry over this process's
    stripe of it, this process's rows of ``train_batch_size`` a batch,
    sharing one ``PretrainCollator`` (``placeholder``: loaders that read
    nothing, for an sp rank > 0)."""
    collator = PretrainCollator(tokenizer, cfg.get("max_txt_len", 30),
                                mlm=bool(cfg.get("use_mlm", True)), mpm=use_mpm,
                                patch_size=16, seed=cfg.get("seed", 42))
    loaders = {}
    for spec in cfg.train_datasets:
        rows = load_datalist(spec.get("ann") or spec["txt"])
        if cfg.get("data_ratio", 1.0) < 1.0:
            rows = rows[: max(1, int(len(rows) * cfg.data_ratio))]
        if spec.get("type", "video") == "image":
            ds = PretrainImageDataset(rows, spec["img"], num_frm=cfg.num_frm,
                                      resize_size=cfg.resize_size, crop_size=cfg.crop_img_size,
                                      seed=cfg.get("seed", 42))
        else:
            ds = PretrainVideoDataset(
                rows, spec["img"], num_frm=cfg.num_frm,
                frm_sampling_strategy=cfg.get("frm_sampling_strategy", "headtail"),
                resize_size=cfg.resize_size, crop_size=cfg.crop_img_size,
                seed=cfg.get("seed", 42))
        num_shards, shard_id = data_shards(cfg.get("mesh_shape"))
        rows_here = local_batch_size(cfg.train_batch_size, cfg.get("mesh_shape"))
        loaders[spec["name"]] = BatchLoader(ds, collator, rows_here,
                                            seed=cfg.get("seed", 42), num_shards=num_shards,
                                            shard_id=shard_id,
                                            num_workers=int(cfg.get("n_workers", 4)),
                                            placeholder=placeholder)
    return loaders


def mixed_batches(meta: MetaLoader):
    """``MetaLoader``'s batches as (batch, (type,)): the ``type`` string and
    the unstaged views out of the batch, the type beside it."""
    for _task, batch in meta:
        batch = {k: v for k, v in batch.items() if k not in _UNSTAGED}
        yield batch, (batch.pop("type", "video"),)


def make_validate(cfg: Config, model, teacher, banks: dict, tokenizer, use_mpm: bool):
    """``validate(state, step)``: the eval function over the first
    ``num_val_batches`` batches of each ``val_datasets`` loader (each process
    its stripe), each ``val_*`` metric averaged over every process's
    batches, logged and written to the metrics file. Returns the averages
    (an empty dict without val sets)."""
    eval_fn = make_pretrain_eval_fn(
        model, use_itc=bool(cfg.get("use_itc", True)), use_itm=bool(cfg.get("use_itm", True)),
        use_mlm=bool(cfg.get("use_mlm", True)), use_mpm=use_mpm, teacher=teacher,
        num_local_blocks=cfg.get("vtm_negative_blocks", 1))
    specs = cfg.get("val_datasets") or []
    loaders = (build_pretrain_loaders(Config(dict(cfg, train_datasets=specs)), tokenizer, use_mpm)
               if specs else {})
    device = common.model_device(model)

    def validate(state, step) -> dict:
        sums, n = {}, 0
        for loader in loaders.values():
            for bi, batch in enumerate(loader):
                if bi >= int(cfg.get("num_val_batches", 2)):
                    break
                batch = {k: v for k, v in batch.items() if k not in _UNSTAGED}
                bank = banks.get(batch.pop("type", "video"))
                metrics = eval_fn(stage_batch(batch, device).wait(), bank)
                for k, v in metrics.items():
                    sums[k] = sums.get(k, 0.0) + float(v)
                n += 1
        parts = all_gather_list((sums, n))
        keys = set().union(*(p[0] for p in parts))
        sums = {k: sum(p[0].get(k, 0.0) for p in parts) for k in keys}
        n = sum(p[1] for p in parts)
        if not n:
            return {}
        means = {k: v / n for k, v in sorted(sums.items())}
        LOGGER.info("step %s val: %s", step, {k: round(v, 4) for k, v in means.items()})
        TB_LOGGER.log_scalar_dict(means)
        return means

    return validate


def start_training(cfg: Config):
    """Pretrain; returns the train state."""
    common.setup_environment(cfg)
    tokenizer = build_tokenizer(cfg.tokenizer_dir)
    model = common.build_model_from_cfg(cfg, "pretrain", seed=cfg.get("seed", 42))
    use_mpm = bool(cfg.get("use_mpm", True))
    teacher, banks = None, {}
    if use_mpm:
        teacher = build_teacher(cfg)
        banks = setup_prompt_banks(cfg, teacher, tokenizer)

    loaders = build_pretrain_loaders(cfg, tokenizer, use_mpm,
                                     placeholder=not reads_rows(cfg.get("mesh_shape")))
    meta = MetaLoader(loaders, accum_steps=cfg.get("gradient_accumulation_steps", 1),
                      seed=cfg.get("seed", 42))
    steps_per_epoch = sum(len(loader) for loader in loaders.values())

    def make_step(m, optimizer):
        return make_pretrain_train_step(
            m, optimizer, use_itc=bool(cfg.get("use_itc", True)),
            use_itm=bool(cfg.get("use_itm", True)), use_mlm=bool(cfg.get("use_mlm", True)),
            use_mpm=use_mpm, num_local_blocks=cfg.get("vtm_negative_blocks", 1),
            teacher=teacher, banks=banks)

    step_fn, state, num_steps, restorer = common.setup_training(
        cfg, model, make_step, steps_per_epoch=steps_per_epoch)
    LOGGER.info("pretraining for %d steps over %s on %s", num_steps, list(loaders),
                common.model_device(model))
    return common.run_train_loop(
        cfg, step_fn, state, mixed_batches(meta), num_steps, restorer=restorer,
        validate_fn=make_validate(cfg, model, teacher, banks, tokenizer, use_mpm),
        save_model_fn=common.default_save_model_fn(cfg, model),
    )


def main(argv=None):
    return start_training(get_pretraining_args(argv))


if __name__ == "__main__":
    main()
