"""Load ALPRO-key-space weights into the port's model.

The port's parameter names *are* the original ALPRO torch keys (what
``alpro_tpu/checkpoint/export_torch.py::export_reference_state_dict``
emits, and the port's copy of it in ``checkpoint/from_jax.py``), with Linear weights in torch (out, in) layout, so a JAX-trained tree
and an official ALPRO ``.pt`` state dict load through the same function.
Nothing is transposed here that the export already transposed; the one
conversion is the strided-conv patch embedding ``patch_embed.proj.weight``
(D, C, p, p), which becomes the (p·p·C, D) matmul kernel of ``PatchEmbed``
with rows in (ph, pw, c) order. The MLM head's decoder bias has two keys in
an ALPRO checkpoint, ``cls.predictions.decoder.bias`` and
``cls.predictions.bias`` (one tensor in ALPRO's module): a load reads the
first and falls back to the second, and ``alpro_state_dict_of`` writes both,
equal, as the JAX export does.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from alpro_tpu_torch.checkpoint.from_jax import alpro_state_dict

_CONV_W = "patch_embed.proj.weight"
_CONV_B = "patch_embed.proj.bias"
_KERNEL = "patch_embed.kernel"
_BIAS = "patch_embed.bias"
_MLM_BIAS = "cls.predictions.bias"
_DECODER_BIAS = "cls.predictions.decoder.bias"


def _to_port_keys(sd: Mapping) -> dict:
    out = {}
    for key, value in sd.items():
        if key.endswith(_MLM_BIAS):  # the decoder's bias under its second name
            decoder = key[: -len(_MLM_BIAS)] + _DECODER_BIAS
            if decoder in sd:
                continue
            key = decoder
        t = value if isinstance(value, torch.Tensor) else torch.from_numpy(
            np.array(value, copy=True)
        )
        if key.endswith(_CONV_W):
            D, C, p, _ = t.shape
            t = t.permute(2, 3, 1, 0).reshape(p * p * C, D)
            key = key[: -len(_CONV_W)] + _KERNEL
        elif key.endswith(_CONV_B):
            key = key[: -len(_CONV_B)] + _BIAS
        out[key] = t
    return out


def to_alpro_keys(sd: Mapping) -> dict:
    """Tensors named by the port's parameters → the ALPRO key space (the
    patch embedding's (p·p·C, D) kernel as the (D, C, p, p) conv weight):
    the inverse of ``_to_port_keys``, bit for bit, in each tensor's dtype
    (the MLM decoder's bias under both its names)."""
    out = {}
    for key, value in sd.items():
        if key.endswith(_DECODER_BIAS):
            out[key[: -len(_DECODER_BIAS)] + _MLM_BIAS] = value.detach().clone()
        if key.endswith(_KERNEL):
            K, D = value.shape
            p = int(round((K / 3) ** 0.5))
            value = value.reshape(p, p, 3, D).permute(3, 2, 0, 1)
            key = key[: -len(_KERNEL)] + _CONV_W
        elif key.endswith(_BIAS):
            key = key[: -len(_BIAS)] + _CONV_B
        out[key] = value.detach().contiguous()
    return out


def alpro_state_dict_of(model: nn.Module) -> dict:
    """The model's parameters in the ALPRO key space (detached tensors as
    stored, the patch embedding as the (D, C, p, p) conv weight): what
    ``torch.save`` writes as a ``.pt`` that ALPRO's loaders, this package's
    and the JAX package's read."""
    return to_alpro_keys(model.state_dict())


@torch.no_grad()
def load_alpro_state_dict(model: nn.Module, sd: Mapping) -> nn.Module:
    """Copy ``sd`` (ALPRO keys → numpy arrays or tensors) into ``model``'s
    parameters, converting dtype and device. Raises ``KeyError`` on any
    missing or unexpected key and ``ValueError`` on a shape mismatch."""
    src = _to_port_keys(sd)
    own = dict(model.named_parameters())
    missing = sorted(own.keys() - src.keys())
    unexpected = sorted(src.keys() - own.keys())
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {missing}, unexpected {unexpected}")
    for key, param in own.items():
        if tuple(src[key].shape) != tuple(param.shape):
            raise ValueError(
                f"{key}: shape {tuple(src[key].shape)} != model {tuple(param.shape)}"
            )
        param.copy_(src[key])
    return model


def from_jax_params(model: nn.Module, params) -> nn.Module:
    """Load a JAX ``AlproModel`` param tree (numpy or jax arrays): the
    port's own tree → ALPRO-key mapping (``checkpoint/from_jax.py``)
    followed by ``load_alpro_state_dict``."""
    return load_alpro_state_dict(model, alpro_state_dict(params))
