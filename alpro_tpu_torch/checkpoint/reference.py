"""Load a reference ALPRO ``.pt`` checkpoint into the port's model,
non-strictly.

The port's counterpart of ``alpro_tpu/checkpoint/torch_convert.py::
load_reference_checkpoint`` and ``cli/common.py::merge_params``, in the port's
key space (the ALPRO keys themselves, ``checkpoint/load.py``), so nothing is
converted but what the model's shapes need:

  * the file is a torch pickle read on the CPU (``weights_only=False``, as the
    JAX loader reads it: ALPRO checkpoints may carry non-tensor entries), a
    ``{"model": state_dict}`` wrapper is unwrapped, and the ``prompter.*``
    teacher of a pretraining checkpoint is split off and returned apart;
  * a text encoder saved as a bare ``BertModel`` (``text_encoder.*``, as
    ALPRO's QA checkpoints and its ``remove_text_encoder_prefix`` load give
    it) is read as the port's ``text_encoder.bert.*``; a checkpoint with
    ``text_encoder.bert.*`` keys is read as it is (the JAX converter reads
    either prefix whatever its flag);
  * an ALBEF checkpoint (a plain-ViT visual tower under ``visual_encoder.*``
    with no ``visual_encoder.model.*`` keys; or ``albef=True``, the
    ``albef_init`` flag) has its spatial keys read as the TimeSformer's
    ``visual_encoder.model.*``, 1:1; its temporal keys (``temporal_attn``,
    ``temporal_norm1``, ``temporal_fc``, ``time_embed``) are missing and
    keep their init, as ALPRO's non-strict load leaves them;
  * the spatial ``pos_embed`` and the temporal ``time_embed`` are resized by
    the JAX converter's 1-D nearest rule when the patch or frame count
    differs (the CLS position kept);
  * the merge is non-strict: a model key the checkpoint lacks keeps its
    init, and a checkpoint key the model lacks or holds at another shape is
    skipped and logged.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from alpro_tpu_torch.checkpoint.load import _to_port_keys
from alpro_tpu_torch.core.logging import LOGGER

_POS = "visual_encoder.model.pos_embed"
_TIME = "visual_encoder.model.time_embed"
_TEXT = "text_encoder."
_BERT = "text_encoder.bert."
_MLM = "text_encoder.cls."
_VIS = "visual_encoder."
_TOWER = "visual_encoder.model."
_TEMPORAL = ("temporal_attn", "temporal_norm1", "temporal_fc", "time_embed")


def _nearest_1d(x: torch.Tensor, new_len: int) -> torch.Tensor:
    """torch ``F.interpolate`` 'nearest' along dim 1: floor(i · old / new),
    in float64 as the JAX converter computes it."""
    old_len = x.shape[1]
    idx = np.floor(np.arange(new_len) * (old_len / new_len)).astype(np.int64)
    return x.index_select(1, torch.from_numpy(idx))


def resize_spatial_embedding(pos_embed: torch.Tensor, num_patches: int) -> torch.Tensor:
    """(1, 1+P, D) → (1, 1+num_patches, D): CLS kept, 1-D nearest on the rest."""
    return torch.cat([pos_embed[:, :1], _nearest_1d(pos_embed[:, 1:], num_patches)], dim=1)


def resize_temporal_embedding(time_embed: torch.Tensor, num_frames: int) -> torch.Tensor:
    """(1, T, D) → (1, num_frames, D), 1-D nearest."""
    return _nearest_1d(time_embed, num_frames)


def text_encoder_as_bert(sd: Mapping) -> Dict:
    """A bare-BertModel text encoder's ``text_encoder.*`` keys as the port's
    ``text_encoder.bert.*`` (the MLM head's ``text_encoder.cls.*`` as they
    are); a state dict that has ``text_encoder.bert.*`` keys comes back as
    it is."""
    if any(k.startswith(_BERT) for k in sd):
        return dict(sd)
    return {(_BERT + k[len(_TEXT):] if k.startswith(_TEXT) and not k.startswith(_MLM) else k): v
            for k, v in sd.items()}


def albef_visual_as_timesformer(sd: Mapping) -> Dict:
    """An ALBEF plain-ViT tower's ``visual_encoder.*`` keys as the
    TimeSformer's ``visual_encoder.model.*``, its temporal keys dropped
    (they keep the model's init)."""
    out = {}
    for k, v in sd.items():
        if k.startswith(_VIS) and not k.startswith(_TOWER):
            if any(t in k for t in _TEMPORAL):
                continue
            k = _TOWER + k[len(_VIS):]
        out[k] = v
    return out


def load_reference_checkpoint(path: str, *, num_patches: int = None,
                              num_frames: int = None, albef: bool = False) -> Tuple[Dict, Dict]:
    """Read an ALPRO ``.pt`` → (state dict in the port's ALPRO keys, with
    ``pos_embed``/``time_embed`` resized to ``num_patches``/``num_frames``
    where given; the ``prompter.*`` sub-dict, prefix removed). ``albef``
    (or a checkpoint with ``visual_encoder.pos_embed`` and no
    ``visual_encoder.model.pos_embed``) reads the visual tower as ALBEF's
    plain ViT."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(raw, dict) and isinstance(raw.get("model"), dict):
        raw = raw["model"]
    sd = {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
          for k, v in raw.items()}
    prompter = {k[len("prompter."):]: v for k, v in sd.items() if k.startswith("prompter.")}
    main = text_encoder_as_bert({k: v for k, v in sd.items() if not k.startswith("prompter.")})
    if albef or (_POS not in main and _VIS + "pos_embed" in main):
        main = albef_visual_as_timesformer(main)
    if num_patches is not None and _POS in main and main[_POS].shape[1] != num_patches + 1:
        main[_POS] = resize_spatial_embedding(main[_POS], num_patches)
    if num_frames is not None and _TIME in main and main[_TIME].shape[1] != num_frames:
        main[_TIME] = resize_temporal_embedding(main[_TIME], num_frames)
    LOGGER.info("read checkpoint %s (%d tensors, %d prompter tensors)",
                path, len(main), len(prompter))
    return main, prompter


@torch.no_grad()
def merge_state_dict(model: nn.Module, sd: Mapping) -> Dict[str, list]:
    """Copy the entries of ``sd`` (ALPRO keys) whose key and shape the model
    has into its parameters (dtype and device converted); the rest of the
    model keeps its values. Returns {"loaded", "missing", "skipped"} key
    lists; missing and skipped keys are logged."""
    src = _to_port_keys(sd)
    own = dict(model.named_parameters())
    loaded, skipped = [], []
    for key, value in src.items():
        if key not in own:
            skipped.append(f"{key} (not in model)")
        elif tuple(value.shape) != tuple(own[key].shape):
            skipped.append(f"{key} (shape {tuple(value.shape)} vs {tuple(own[key].shape)})")
        else:
            own[key].copy_(value)
            loaded.append(key)
    missing = sorted(own.keys() - set(loaded))
    if skipped:
        LOGGER.info("checkpoint merge skipped %d keys: %s", len(skipped), skipped[:20])
    if missing:
        LOGGER.info("checkpoint lacks %d model keys (they keep their init): %s",
                    len(missing), missing[:20])
    return {"loaded": loaded, "missing": missing, "skipped": skipped}
