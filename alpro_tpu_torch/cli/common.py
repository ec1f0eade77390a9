"""Shared CLI machinery of the inference protocols: environment, device,
model construction and the inference checkpoint.

The inference half of ``alpro_tpu/cli/common.py``. The model runs on
``cfg.device`` (default ``cuda``, the counterpart of the JAX package's
``ALPRO_PLATFORM``): with no CUDA device the default raises, and the CPU is
used only when ``device`` says ``cpu``. The port runs one process: the
multi-host striping and gathers of the JAX CLIs are not ported (ROADMAP
A12), nor is training (``setup_training``, the train loop and the orbax
restorer: A13, A14).
"""

from __future__ import annotations

import json
import os
import random

import numpy as np
import torch

from alpro_tpu_torch.checkpoint.reference import load_reference_checkpoint, merge_state_dict
from alpro_tpu_torch.core.config import Config, load_json_config
from alpro_tpu_torch.core.logging import LOGGER, add_log_to_file
from alpro_tpu_torch.data.transforms import IMAGE_MEAN_CLIP, IMAGE_STD_CLIP
from alpro_tpu_torch.models.alpro import (
    AlproModel,
    build_qa_model,
    build_retrieval_model,
    init_random_,
)
from alpro_tpu_torch.models.bert import BertConfig
from alpro_tpu_torch.models.timesformer import TimeSformerConfig

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
    """Check the device, seed the host RNGs and torch, and log to
    ``output_dir/log/log.txt`` when an output directory is given."""
    resolve_device(cfg)
    seed = cfg.get("seed", 42)
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    if cfg.get("output_dir"):
        os.makedirs(cfg.output_dir, exist_ok=True)
        add_log_to_file(os.path.join(cfg.output_dir, "log", "log.txt"))


def compute_dtype(cfg: Config) -> torch.dtype:
    if cfg.get("fp16"):
        # the reference's fp16 flag: bf16 (fp32's exponent range, no loss scaling)
        LOGGER.info("fp16=1 requested: using bfloat16 compute")
        return torch.bfloat16
    name = cfg.get("compute_dtype", "bfloat16")
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def build_model_from_cfg(cfg: Config, task: str, seed: int = 0) -> AlproModel:
    """The ``retrieval`` or ``qa`` model of ``cfg.model_config`` (a BERT
    json) and ``cfg.visual_model_cfg`` (a TimeSformer json) at
    ``crop_img_size`` and ``num_frm``, with fp32 parameters on
    ``resolve_device(cfg)`` drawn by ``init_random_`` from a
    ``torch.Generator`` seeded with ``seed``, computing in
    ``compute_dtype(cfg)``. ``attn_impl`` sets both towers' attention and
    ``fused_patchify`` the video tower's, as in the JAX CLI."""
    if task in ("pretrain", "prompter"):
        raise NotImplementedError(
            f"task {task!r}: the pretraining and prompter models are not ported yet "
            "(ROADMAP A11)"
        )
    if task not in ("retrieval", "qa"):
        raise ValueError(task)
    device = resolve_device(cfg)
    attn_impl = cfg.get("attn_impl") or "auto"
    bert_dict = dict(load_json_config(cfg.model_config))
    bert_dict.setdefault("attn_impl", attn_impl)
    bert = BertConfig.from_json_dict(bert_dict)
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
        pixel_mean=tuple(cfg.get("img_pixel_mean") or IMAGE_MEAN_CLIP),
        pixel_std=tuple(cfg.get("img_pixel_std") or IMAGE_STD_CLIP),
        fused_patchify=cfg.get("fused_patchify") or "auto",
    )
    dtype = compute_dtype(cfg)
    with torch.device("meta"):
        if task == "retrieval":
            model = build_retrieval_model(bert, vis, dtype=dtype)
        else:
            model = build_qa_model(bert, vis, num_labels=cfg.num_labels,
                                   cls_hidden_scale=cfg.get("cls_hidden_scale", 2), dtype=dtype)
    model = model.to_empty(device=device)
    init_random_(model, torch.Generator(device=device).manual_seed(seed))
    return model.eval()


def load_inference_params(model: AlproModel, cfg: Config) -> AlproModel:
    """The inference weights, as the JAX CLI resolves them:
    ``inference_model_ckpt`` (an ALPRO-key ``.pt``, which must exist), else
    ``e2e_weights_path`` (a missing file leaves the init, with a warning),
    merged non-strictly over the model's init. ``inference_model_step``
    names a run's own orbax checkpoint, which the port cannot read yet
    (ROADMAP A13)."""
    step = str(cfg.get("inference_model_step", "") or "")
    if step:
        raise NotImplementedError(
            f"inference_model_step={step!r}: the run-local training checkpoints "
            "(the orbax restorer) are not ported yet (ROADMAP A13); pass "
            "inference_model_ckpt=<ALPRO .pt> instead"
        )
    path = cfg.get("inference_model_ckpt")
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(f"inference_model_ckpt not found: {path}")
    else:
        path = cfg.get("e2e_weights_path")
        if not path:
            return model
        if not os.path.exists(path):
            LOGGER.warning("e2e_weights_path %s not found; running from init", path)
            return model
    vis = model.visual_encoder.model.cfg
    sd, _prompter = load_reference_checkpoint(path, num_patches=vis.num_patches,
                                              num_frames=vis.num_frames)
    merge_state_dict(model, sd)
    LOGGER.info("loaded inference params from %s", path)
    return model


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
