"""Visual-tower initialization from a ViT or TimeSformer checkpoint
(``visual_weights_path``), when no whole-model checkpoint is given.

The port's counterpart of ``alpro_tpu/cli/common.py::maybe_load_visual_weights``
and of the converters it dispatches to (``convert_imagenet_vit`` /
``convert_clip_vit`` and ``convert_kinetics_timesformer`` in
``alpro_tpu/checkpoint/torch_convert.py``). The port's parameters are the
ALPRO keys, so the converters here mostly rename into
``visual_encoder.model.*``:

  * a plain ViT (timm/imagenet, or CLIP's ViT-B/16 in ViT keys): each
    block's spatial ``attn`` is duplicated into ``temporal_attn``, ``norm1``
    into ``temporal_norm1``, ``temporal_fc`` is zeroed for blocks > 0 (block
    0 keeps its init), and ``time_embed`` keeps its init;
  * a Kinetics TimeSformer: every key read as it is.

``pos_embed`` and ``time_embed`` are resized by the loader's 1-D nearest
rule (``checkpoint/reference.py``). The dispatch is JAX's: a file whose name
holds ``CLIP_ViT``, or one with no ``temporal_attn`` keys, is a plain ViT;
else a TimeSformer. A ``model``/``state_dict``/``module`` wrapper and a
``model.``/``module.`` key prefix are removed first. A path that does not
exist (such as the timm name ``vit_base_patch16_224``, which the JAX package
resolves only as a local file) warns and keeps the init.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import torch
from torch import nn

from alpro_tpu_torch.checkpoint.reference import (
    merge_state_dict,
    resize_spatial_embedding,
    resize_temporal_embedding,
)
from alpro_tpu_torch.core.logging import LOGGER

_TOWER = "visual_encoder.model."
_VIT_BLOCK = ("norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias",
              "attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight", "attn.proj.bias",
              "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias")
_TEMPORAL_BLOCK = ("temporal_norm1.weight", "temporal_norm1.bias",
                   "temporal_attn.qkv.weight", "temporal_attn.qkv.bias",
                   "temporal_attn.proj.weight", "temporal_attn.proj.bias",
                   "temporal_fc.weight", "temporal_fc.bias")


def _depth(sd: Mapping) -> int:
    n = 0
    while f"blocks.{n}.norm1.weight" in sd:
        n += 1
    return n


def _stem(sd: Mapping, num_patches: int = None) -> Dict[str, torch.Tensor]:
    pos = sd["pos_embed"]
    if num_patches is not None and pos.shape[1] != num_patches + 1:
        pos = resize_spatial_embedding(pos, num_patches)
    out = {_TOWER + "cls_token": sd["cls_token"], _TOWER + "pos_embed": pos}
    for k in ("patch_embed.proj.weight", "patch_embed.proj.bias", "norm.weight", "norm.bias"):
        out[_TOWER + k] = sd[k]
    return out


def convert_vit(sd: Mapping, num_patches: int = None) -> Dict[str, torch.Tensor]:
    """A plain ViT state dict (timm keys) → the TimeSformer's ALPRO keys,
    the spatial attention and ``norm1`` duplicated into the temporal ones,
    ``temporal_fc`` zero past block 0."""
    out = _stem(sd, num_patches)
    D = sd["patch_embed.proj.weight"].shape[0]
    for i in range(_depth(sd)):
        src, dst = f"blocks.{i}.", f"{_TOWER}blocks.{i}."
        for k in _VIT_BLOCK:
            out[dst + k] = sd[src + k]
        for part in ("weight", "bias"):
            out[f"{dst}temporal_norm1.{part}"] = sd[f"{src}norm1.{part}"]
            for lin in ("qkv", "proj"):
                out[f"{dst}temporal_attn.{lin}.{part}"] = sd[f"{src}attn.{lin}.{part}"]
        if i > 0:
            out[dst + "temporal_fc.weight"] = torch.zeros(D, D)
            out[dst + "temporal_fc.bias"] = torch.zeros(D)
    return out


def convert_timesformer(sd: Mapping, num_patches: int = None,
                        num_frames: int = None) -> Dict[str, torch.Tensor]:
    """A Kinetics TimeSformer state dict → ALPRO keys, ``pos_embed`` and
    ``time_embed`` resized."""
    out = _stem(sd, num_patches)
    if "time_embed" in sd:
        t = sd["time_embed"]
        if num_frames is not None and t.shape[1] != num_frames:
            t = resize_temporal_embedding(t, num_frames)
        out[_TOWER + "time_embed"] = t
    for i in range(_depth(sd)):
        src, dst = f"blocks.{i}.", f"{_TOWER}blocks.{i}."
        for k in _VIT_BLOCK + _TEMPORAL_BLOCK:
            out[dst + k] = sd[src + k]
    return out


def read_visual_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint file → its tensors, the wrappers and key prefixes gone."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    for wrap in ("model", "state_dict", "module"):
        if isinstance(raw, dict) and isinstance(raw.get(wrap), dict):
            raw = raw[wrap]
    sd = {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(v) for k, v in raw.items()}
    for pfx in ("model.", "module."):
        if any(k.startswith(pfx + "patch_embed") for k in sd):
            sd = {k[len(pfx):] if k.startswith(pfx) else k: v for k, v in sd.items()}
    return sd


def load_visual_weights(model: nn.Module, path: str) -> nn.Module:
    """Initialize ``model``'s video tower from the checkpoint at ``path``
    (merged non-strictly over its init); a missing path warns and keeps the
    init."""
    if not os.path.exists(path):
        LOGGER.warning("visual_weights_path %s not found; visual tower keeps init", path)
        return model
    sd = read_visual_state_dict(path)
    vis = model.visual_encoder.model.cfg
    clip = "CLIP_ViT" in os.path.basename(path)
    if any("temporal_attn" in k for k in sd) and not clip:
        visual, family = convert_timesformer(sd, vis.num_patches, vis.num_frames), \
            "kinetics-timesformer"
    else:
        visual, family = convert_vit(sd, vis.num_patches), "clip-vit" if clip else "imagenet-vit"
    LOGGER.info("visual init from %s (%s family)", path, family)
    merge_state_dict(model, visual)
    return model
