"""Shared CLI machinery (the port's counterpart of ``alpro_tpu/cli/common.py``):
environment, device, model construction, the weights to start from, the
training setup and loop, and the deploy and resume checkpoints.

The model runs on ``cfg.device`` (default ``cuda``, the counterpart of the
JAX package's ``ALPRO_PLATFORM``): with no CUDA device the default raises,
and the CPU is used only when ``device`` says ``cpu``. Several processes,
one per GPU, run as one job when the environment names a rendezvous
(``core/distributed.py``: ``torchrun``'s variables with
``ALPRO_DISTRIBUTED=1``, or ``ALPRO_COORDINATOR``), NCCL on CUDA and gloo on
the CPU. The train step then runs over the mesh of ``mesh_shape`` (default:
every process on ``dp``; ``DP SP`` with SP > 1 also splits the video
tower's temporal attention's frames over ``sp``), each process loads the
stripe of its dp coordinate, rank 0's start state is broadcast, the
processes agree on the resumed step, and rank 0 alone writes logs, metrics
and checkpoints; ``validate`` runs unsplit. The blocks are not
scanned, so unlike the JAX CLI the port turns no gradient checkpointing on
by itself: a tower checkpoints its blocks when its model config sets
``gradient_checkpointing``, keeping what ``remat_policy`` keeps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import math
import os
import time
from typing import Callable, Dict, Optional

import torch

from alpro_tpu_torch.checkpoint.reference import load_reference_checkpoint, merge_state_dict
from alpro_tpu_torch.checkpoint.restore import TrainingRestorer, load_params, save_params
from alpro_tpu_torch.checkpoint.visual_init import load_visual_weights
from alpro_tpu_torch.core.config import Config, load_json_config
from alpro_tpu_torch.core.distributed import (
    is_primary,
    maybe_initialize,
    process_info,
    sp_width,
)
from alpro_tpu_torch.core.logging import LOGGER, TB_LOGGER, NoOp, RunningMeter, add_log_to_file
from alpro_tpu_torch.core.mesh import SEQ_AXIS, make_mesh, replicate
from alpro_tpu_torch.core.misc import save_training_meta, set_random_seed
from alpro_tpu_torch.core.trace import maybe_profile, span
from alpro_tpu_torch.data.loader import DevicePrefetcher, stage_batch
from alpro_tpu_torch.data.transforms import IMAGE_MEAN_CLIP, IMAGE_STD_CLIP
from alpro_tpu_torch.models.alpro import (
    AlproModel,
    build_pretrain_model,
    build_prompter_model,
    build_qa_model,
    build_retrieval_model,
    init_random_,
)
from alpro_tpu_torch.models.bert import BertConfig
from alpro_tpu_torch.models.timesformer import TimeSformerConfig
from alpro_tpu_torch.parallel.host_sync import all_gather_list, barrier
from alpro_tpu_torch.train.optimizer import build_optimizer, get_lr_schedule
from alpro_tpu_torch.train.state import TrainState
from alpro_tpu_torch.train.step import shard_step


def resolve_device(cfg: Config) -> torch.device:
    """``cfg.device`` (default ``cuda``); raises when it names CUDA and no
    CUDA device is present — the run never carries on on the CPU."""
    device = torch.device(cfg.get("device") or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for (the default) but torch sees no CUDA "
            "device; pass device='cpu' (--device cpu) to run on the CPU"
        )
    return device


def setup_environment(cfg: Config) -> None:
    """Open the process group when the environment asks for one (first: the
    reference's ``hvd.init()`` slot), check the device and seed the host
    RNGs and torch. With an output directory, rank 0 logs to
    ``output_dir/log/log.txt``, writes the scalars to
    ``output_dir/log/metrics.jsonl`` and, for a training run, snapshots the
    config to ``output_dir/log/args.json`` (an inference run reads that file
    back and leaves it as it is); the other processes log warnings only and
    write nothing. Without one, no scalars are written."""
    device = resolve_device(cfg)
    distributed = maybe_initialize(device)
    set_random_seed(cfg.get("seed", 42))
    TB_LOGGER.close()
    if not is_primary():
        LOGGER.setLevel(logging.WARNING)
        return
    if cfg.get("output_dir"):
        os.makedirs(cfg.output_dir, exist_ok=True)
        add_log_to_file(os.path.join(cfg.output_dir, "log", "log.txt"))
        TB_LOGGER.create(os.path.join(cfg.output_dir, "log"))
        if not cfg.get("do_inference"):
            save_training_meta(cfg.output_dir, cfg)
    if distributed:
        LOGGER.info("distributed: process 0 of %d on %s", process_info()[1], device)
    LOGGER.info("scan_blocks=%s and xla_compiler_options=%r steer XLA's compile alone: "
                "accepted, with no effect on the port", cfg.get("scan_blocks", 1),
                cfg.get("xla_compiler_options", ""))


def compute_dtype(cfg: Config) -> torch.dtype:
    if cfg.get("fp16"):
        # the reference's fp16 flag: bf16 (fp32's exponent range, no loss scaling)
        LOGGER.info("fp16=1 requested: using bfloat16 compute")
        return torch.bfloat16
    name = cfg.get("compute_dtype", "bfloat16")
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def build_model_from_cfg(cfg: Config, task: str, seed: int = 0) -> AlproModel:
    """The ``retrieval``, ``qa``, ``pretrain`` (the MLM head and the MPM
    head over ``num_entities``, default 1000) or ``prompter`` model of
    ``cfg.model_config`` (a BERT json) and ``cfg.visual_model_cfg`` (a
    TimeSformer json) at
    ``crop_img_size`` and ``num_frm``, with fp32 parameters on
    ``resolve_device(cfg)`` drawn by ``init_random_`` from a
    ``torch.Generator`` seeded with ``seed``, computing in
    ``compute_dtype(cfg)``. ``attn_impl`` sets both towers' attention,
    ``remat_policy`` (default ``dots_ln``) what their checkpointed blocks
    keep, ``fused_patchify`` the video tower's patch embedding and a
    ``mesh_shape`` DP SP with SP > 1 its ``sp_axis``, as in the JAX CLI."""
    if task not in ("retrieval", "qa", "pretrain", "prompter"):
        raise ValueError(task)
    device = resolve_device(cfg)
    attn_impl = cfg.get("attn_impl") or "auto"
    remat_policy = cfg.get("remat_policy") or "dots_ln"
    bert_dict = dict(load_json_config(cfg.model_config))
    bert_dict.setdefault("attn_impl", attn_impl)
    bert = dataclasses.replace(BertConfig.from_json_dict(bert_dict), remat_policy=remat_policy)
    vis_dict = dict(load_json_config(cfg.visual_model_cfg))
    vis = TimeSformerConfig(
        img_size=cfg.crop_img_size,
        patch_size=vis_dict.get("patch_size", 16),
        num_frames=cfg.num_frm,
        embed_dim=vis_dict.get("embed_dim", 768),
        depth=vis_dict.get("depth", 12),
        num_heads=vis_dict.get("num_heads", 12),
        drop_rate=vis_dict.get("drop_rate", 0.0),
        attn_drop_rate=vis_dict.get("attn_drop_rate", 0.0),
        drop_path_rate=vis_dict.get("drop_path_rate", 0.1),
        attn_impl=attn_impl,
        gradient_checkpointing=bool(vis_dict.get("gradient_checkpointing", False)),
        remat_policy=remat_policy,
        pixel_mean=tuple(cfg.get("img_pixel_mean") or IMAGE_MEAN_CLIP),
        pixel_std=tuple(cfg.get("img_pixel_std") or IMAGE_STD_CLIP),
        fused_patchify=cfg.get("fused_patchify") or "auto",
        sp_axis=SEQ_AXIS if sp_width(cfg.get("mesh_shape")) > 1 else None,
    )
    dtype = compute_dtype(cfg)
    with torch.device("meta"):
        if task == "retrieval":
            model = build_retrieval_model(bert, vis, dtype=dtype)
        elif task == "qa":
            model = build_qa_model(bert, vis, num_labels=cfg.num_labels,
                                   cls_hidden_scale=cfg.get("cls_hidden_scale", 2), dtype=dtype)
        elif task == "pretrain":
            model = build_pretrain_model(bert, vis, num_entities=cfg.get("num_entities", 1000),
                                         dtype=dtype)
        else:
            model = build_prompter_model(bert, vis, dtype=dtype)
    model = model.to_empty(device=device)
    init_random_(model, torch.Generator(device=device).manual_seed(seed))
    return model.eval()


def maybe_load_e2e_weights(model: AlproModel, cfg: Config) -> AlproModel:
    """Merge the ALPRO-key ``.pt`` at ``e2e_weights_path`` non-strictly over
    the model's init (keys the file lacks keep their values; a missing file
    leaves the init, with a warning). Either text-encoder prefix is read, so
    the JAX CLI's ``remove_text_encoder_prefix`` needs no counterpart;
    ``albef_init`` reads the visual tower as ALBEF's plain ViT."""
    path = cfg.get("e2e_weights_path")
    if not path:
        return model
    if not os.path.exists(path):
        LOGGER.warning("e2e_weights_path %s not found; running from init", path)
        return model
    vis = model.visual_encoder.model.cfg
    sd, _prompter = load_reference_checkpoint(path, num_patches=vis.num_patches,
                                              num_frames=vis.num_frames,
                                              albef=bool(cfg.get("albef_init", False)))
    merge_state_dict(model, sd)
    LOGGER.info("loaded weights from %s", path)
    return model


def load_inference_params(model: AlproModel, cfg: Config) -> AlproModel:
    """The inference weights, as the JAX CLI resolves them:
    ``inference_model_step`` N reads the run's own deploy checkpoint
    ``output_dir/ckpt/model_step_N.pt`` (every key; ``FileNotFoundError``
    naming the path when it is missing); else ``inference_model_ckpt`` (an
    ALPRO-key ``.pt``, which must exist) or ``e2e_weights_path``, merged
    non-strictly over the model's init."""
    step = str(cfg.get("inference_model_step", "") or "")
    if step and cfg.get("output_dir"):
        path = os.path.join(cfg.output_dir, "ckpt", f"model_step_{step}.pt")
        if not os.path.exists(path):
            raise FileNotFoundError(f"inference_model_step={step}: no checkpoint {path}")
        load_params(path, model)
        LOGGER.info("loaded inference params from %s", path)
        return model
    path = cfg.get("inference_model_ckpt")
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(f"inference_model_ckpt not found: {path}")
        cfg = Config(dict(cfg, e2e_weights_path=path))
    return maybe_load_e2e_weights(model, cfg)


def merge_stored_args(cfg: Config, keep=("output_dir",)) -> None:
    """A training run's stored ``output_dir/log/args.json`` overrides every
    key of ``cfg`` but the ``*inference*`` keys and ``keep`` (the reference's
    inference re-merge)."""
    stored = os.path.join(cfg.get("output_dir") or "", "log", "args.json")
    if not os.path.exists(stored):
        return
    with open(stored) as f:
        train_args = json.load(f)
    for k, v in train_args.items():
        if "inference" not in k and k not in keep:
            cfg[k] = Config._wrap(v)


def model_device(model: AlproModel) -> torch.device:
    return next(model.parameters()).device


def setup_training(cfg: Config, model: AlproModel, make_step: Callable, steps_per_epoch: int):
    """The optimizer, the start state and the train step of ``model``, as
    the JAX CLI sizes them → (step, state, num_train_steps, restorer).

    ``num_train_steps`` = ceil(``num_train_epochs`` · ``steps_per_epoch``)
    micro-steps; the schedule runs over ceil(num_train_steps /
    ``gradient_accumulation_steps``) optimizer steps (an epoch of
    ``steps_per_epoch // accum`` of them for ``multi_step``); ``AdamW``
    accumulates over ``accum`` calls. The model starts from
    ``e2e_weights_path`` when given, else its video tower from
    ``visual_weights_path`` when given (``checkpoint/visual_init.py``). With
    an ``output_dir``, the restorer
    saves every max(1, ``save_steps_ratio`` · num_train_steps) steps and the
    state resumes from its newest slot. ``make_step(model, optimizer)``
    builds the step, which runs over the mesh of ``mesh_shape``
    (``train/step.py::shard_step``; its product must be the number of
    processes): each call of the returned step runs under ``use_mesh`` of
    that mesh, where a DP SP mesh with SP > 1 splits the frames. Every
    process starts from rank 0's state and resumes from the same step (the
    agreement over every process), or the run stops."""
    mesh = make_mesh(train_mesh_shape(cfg))
    if mesh.sp_size > 1:
        LOGGER.info("mesh (dp, sp) = %s: each train step splits the frames of the video "
                    "tower's temporal attention over sp", tuple(mesh.shape))
    if cfg.get("optim", "adamw") != "adamw":
        raise ValueError(f"optim={cfg.optim!r}: only adamw exists")
    accum = int(cfg.get("gradient_accumulation_steps", 1))
    num_train_steps = int(math.ceil(cfg.num_train_epochs * steps_per_epoch))
    num_opt_steps = int(math.ceil(num_train_steps / accum))
    if cfg.get("transformer_lr_mul", 1.0) != 1.0:
        # parsed for flag compatibility; the reference parses it too and
        # never reads it (ROADMAP C3)
        LOGGER.warning("transformer_lr_mul is accepted but has no effect "
                       "(unused in the reference as well)")
    sched = get_lr_schedule(
        cfg.get("decay", "linear"), cfg.learning_rate, num_opt_steps,
        warmup_ratio=cfg.get("warmup_ratio", 0.1),
        decay_epochs=cfg.get("step_decay_epochs") or (),
        steps_per_epoch=max(1, int(steps_per_epoch // accum)),
    )
    optimizer = build_optimizer(
        sched, betas=tuple(cfg.get("betas", (0.9, 0.98))),
        weight_decay=cfg.get("weight_decay", 0.0),
        apply_weight_decay=bool(cfg.get("apply_weight_decay", False)),
        grad_norm=cfg.get("grad_norm", None), accum_steps=accum,
        mu_dtype=cfg.get("adam_mu_dtype") or None, nu_dtype=cfg.get("adam_nu_dtype") or None,
    )
    if cfg.get("e2e_weights_path"):
        maybe_load_e2e_weights(model, cfg)
    elif cfg.get("visual_weights_path"):
        load_visual_weights(model, cfg.visual_weights_path)
    state = TrainState.create(model, optimizer)
    replicate(model, state.opt_state)
    restorer = None
    if cfg.get("output_dir"):
        save_steps = max(1, int(cfg.get("save_steps_ratio", 0.05) * num_train_steps))
        restorer = TrainingRestorer(cfg.output_dir, save_steps)
        restored = restorer.restore(state)
        steps = all_gather_list(-1 if restored is None else int(state.step))
        if len(set(steps)) != 1:
            # the reference broadcasts rank 0's restore; a disagreement here
            # means output_dir is not one shared directory
            raise RuntimeError(f"inconsistent restore across processes (steps={steps}); "
                               "output_dir must be a shared filesystem")
        if restored is not None:
            LOGGER.info("resumed from step %d", state.step)
    return shard_step(make_step(model, optimizer), mesh), state, num_train_steps, restorer


def train_mesh_shape(cfg: Config) -> list:
    """``mesh_shape`` as the train step's mesh: N (dp) or DP SP; default
    every process on dp."""
    shape = cfg.get("mesh_shape")
    if shape is None:
        return [process_info()[1]]
    return [int(n) for n in shape]


def run_train_loop(cfg: Config, step_fn: Callable, state: TrainState, train_iter,
                   num_train_steps: int, restorer: Optional[TrainingRestorer] = None,
                   validate_fn: Optional[Callable] = None,
                   save_model_fn: Optional[Callable] = None) -> TrainState:
    """The JAX CLI's training loop from ``state.step`` to ``num_train_steps``.

    Host batches from ``train_iter`` are staged on the model's device by a
    ``DevicePrefetcher`` thread (``prefetch_depth`` batches ahead; 0 stages
    each batch in the loop). An item of ``train_iter`` is a batch dict or a
    (batch, extras) tuple, whose extras (the pretraining batch's task type)
    travel beside the staged batch. Each step is ``step_fn(state, batch,
    seed, *extras)`` with the config's ``seed``. The metrics are read to the
    host only every ``log_interval`` steps (into ``RunningMeter`` EWMAs, logged and written
    to ``TB_LOGGER``); every ``valid_steps`` (about ``num_valid`` times,
    rounded up to a multiple of ``min_valid_steps``) ``validate_fn`` and
    ``save_model_fn`` run; a resume checkpoint is saved where
    ``restorer.due``. ``debug`` validates every step and stops after four;
    ``profile`` traces steps [start+2, start+7), with the program's spans
    (``core/trace.py``). On the way out the last
    async save is committed and the prefetcher closed."""
    device = model_device(state.model)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(item):
        batch, extras = item if isinstance(item, tuple) else (item, ())
        return stage_batch(batch, device, stream), extras

    depth = int(cfg.get("prefetch_depth", 2))
    prefetcher = DevicePrefetcher(train_iter, put, depth=depth) if depth > 0 else None
    staged = prefetcher if prefetcher is not None else map(put, train_iter)

    seed = cfg.get("seed", 42)
    start_step = int(state.step)
    meters: Dict[str, RunningMeter] = {}
    log_interval = cfg.get("log_interval", 100)
    min_valid = max(int(cfg.get("min_valid_steps", 1)), 1)
    valid_steps = max(
        math.ceil(num_train_steps / max(cfg.get("num_valid", 10), 1) / min_valid) * min_valid, 1)
    debug = bool(cfg.get("debug", False))
    profile = bool(cfg.get("profile")) and bool(cfg.get("output_dir")) and is_primary()
    tb = TB_LOGGER if is_primary() else NoOp()
    t0 = time.time()
    try:
        with contextlib.ExitStack() as profiling:
            for global_step in range(start_step, num_train_steps):
                if profile and global_step == start_step + 2:
                    profiling.enter_context(maybe_profile(cfg.output_dir, True))
                elif profile and global_step == start_step + 7:
                    profiling.close()
                with span("loop.data_wait"):
                    staged_batch, extras = next(staged)
                    batch = staged_batch.wait()
                state, metrics = step_fn(state, batch, seed, *extras)
                # metrics stay on the device between log steps: reading them
                # every step would wait for the device every step
                if (global_step + 1) % log_interval == 0 or debug:
                    for k, v in metrics.items():
                        meters.setdefault(k, RunningMeter(k))(float(v))
                if (global_step + 1) % log_interval == 0:
                    rate = (global_step + 1 - start_step) / (time.time() - t0)
                    LOGGER.info("step %d/%d (%.2f it/s): %s", global_step + 1, num_train_steps,
                                rate, "  ".join(str(m) for m in meters.values()))
                    tb.global_step = global_step + 1
                    tb.log_scalar_dict({m.name: m.val for m in meters.values()}, prefix="train")
                if (global_step + 1) % valid_steps == 0 or debug:
                    if validate_fn is not None:
                        validate_fn(state, global_step + 1)
                    if save_model_fn is not None:
                        save_model_fn(state, global_step + 1)
                if restorer is not None and restorer.due(global_step + 1):
                    if is_primary():
                        restorer.save(state)
                    barrier("resume-save")
                if debug and global_step - start_step >= 3:
                    LOGGER.info("debug mode: stopping after %d steps", global_step + 1)
                    break
        if restorer is not None:
            restorer.wait_until_finished()  # commit the last async save
            barrier("resume-save-done")
    finally:
        if prefetcher is not None:
            prefetcher.close()
    return state


def default_save_model_fn(cfg: Config, model: AlproModel) -> Callable:
    """``save(state, step)``: the deploy checkpoint
    ``output_dir/ckpt/model_step_{step}.pt`` (when there is an output
    directory), written by rank 0 while the others wait at a barrier."""

    def save(state, step):
        if cfg.get("output_dir"):
            if is_primary():
                save_params(cfg.output_dir, step, model)
            barrier("deploy-save")

    return save
