"""A JAX ``AlproModel`` param tree → the ALPRO torch key space, in numpy.

The port's own copy of the mapping in
``alpro_tpu/checkpoint/export_torch.py::export_reference_state_dict``, so
that the port imports nothing of the JAX package. It covers the TimeSformer,
the BERT encoder, ``vision_proj`` / ``text_proj`` / ``itm_head``, ``temp``,
the QA classifier (``classifier.0.*`` / ``classifier.2.*``) and the
pretraining heads: the MLM head (``text_encoder.cls.predictions.*``, the
decoder's bias also as ``predictions.bias``) and the MPM head
(``mpm_head.0.*`` / ``mpm_head.2.*``). A tree holding any other top-level
subtree raises ``KeyError`` rather than loading without it.

Arrays may be numpy or JAX arrays (``np.asarray`` reads either without
importing JAX). Dense kernels (in, out) become torch Linear weights (out,
in); the (p·p·C, D) patch-embed kernel becomes the (D, C, p, p) conv weight
of the ALPRO checkpoint.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

_HEADS = ("vision_proj", "text_proj", "itm_head")
_KNOWN = {"visual_encoder", "text_encoder", "temp", "classifier_hidden",
          "classifier_out", "mlm_head", "mpm_hidden", "mpm_out", *_HEADS}
_MLM = "text_encoder.cls.predictions."


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).T)


def _put_dense(sd, pfx, tree):
    sd[pfx + "weight"] = _t(tree["kernel"])
    sd[pfx + "bias"] = np.asarray(tree["bias"])


def _put_ln(sd, pfx, tree):
    sd[pfx + "weight"] = np.asarray(tree["scale"])
    sd[pfx + "bias"] = np.asarray(tree["bias"])


def timesformer_state_dict(tree: dict,
                           prefix: str = "visual_encoder.model.") -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    p = prefix
    sd[p + "cls_token"] = np.asarray(tree["cls_token"])
    sd[p + "pos_embed"] = np.asarray(tree["pos_embed"])
    if "time_embed" in tree:
        sd[p + "time_embed"] = np.asarray(tree["time_embed"])
    k = np.asarray(tree["patch_embed"]["kernel"])  # (p·p·C, D), rows (ph, pw, c)
    ps = int(round((k.shape[0] / 3) ** 0.5))
    sd[p + "patch_embed.proj.weight"] = np.ascontiguousarray(
        k.reshape(ps, ps, 3, k.shape[1]).transpose(3, 2, 0, 1)
    )
    sd[p + "patch_embed.proj.bias"] = np.asarray(tree["patch_embed"]["bias"])
    _put_ln(sd, p + "norm.", tree["norm"])
    i = 0
    while f"blocks_{i}" in tree:
        b = tree[f"blocks_{i}"]
        bp = f"{p}blocks.{i}."
        for ln in ("norm1", "norm2", "temporal_norm1"):
            _put_ln(sd, bp + ln + ".", b[ln])
        for attn in ("attn", "temporal_attn"):
            _put_dense(sd, bp + f"{attn}.qkv.", b[attn]["qkv"])
            _put_dense(sd, bp + f"{attn}.proj.", b[attn]["proj"])
        _put_dense(sd, bp + "temporal_fc.", b["temporal_fc"])
        _put_dense(sd, bp + "mlp.fc1.", b["mlp"]["fc1"])
        _put_dense(sd, bp + "mlp.fc2.", b["mlp"]["fc2"])
        i += 1
    return sd


def bert_state_dict(tree: dict, prefix: str = "text_encoder.bert.") -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    p = prefix
    emb = tree["embeddings"]
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        sd[f"{p}embeddings.{name}.weight"] = np.asarray(emb[name]["embedding"])
    _put_ln(sd, p + "embeddings.LayerNorm.", emb["LayerNorm"])
    i = 0
    while f"layer_{i}" in tree:
        layer = tree[f"layer_{i}"]
        lp = f"{p}encoder.layer.{i}."
        for name in ("query", "key", "value"):
            _put_dense(sd, f"{lp}attention.self.{name}.", layer["attention"][name])
        _put_dense(sd, lp + "attention.output.dense.", layer["attention_output"])
        _put_ln(sd, lp + "attention.output.LayerNorm.", layer["attention_layernorm"])
        _put_dense(sd, lp + "intermediate.dense.", layer["intermediate"])
        _put_dense(sd, lp + "output.dense.", layer["output"])
        _put_ln(sd, lp + "output.LayerNorm.", layer["output_layernorm"])
        i += 1
    return sd


def alpro_state_dict(params: dict) -> Dict[str, np.ndarray]:
    """Full ``AlproModel`` param tree (``{'params': ...}`` or its inside) →
    ALPRO keys. Raises ``KeyError`` on a top-level subtree it does not map."""
    tree = params["params"] if "params" in params else params
    unmapped = sorted(set(tree) - _KNOWN)
    if unmapped:
        raise KeyError(f"param subtrees with no port module yet: {unmapped}")
    sd: Dict[str, np.ndarray] = {}
    sd.update(timesformer_state_dict(tree["visual_encoder"]))
    sd.update(bert_state_dict(tree["text_encoder"]))
    for name in _HEADS:
        _put_dense(sd, name + ".", tree[name])
    if "temp" in tree:
        sd["temp"] = np.asarray(tree["temp"])
    if "mlm_head" in tree:
        h = tree["mlm_head"]
        _put_dense(sd, _MLM + "transform.dense.", h["transform_dense"])
        _put_ln(sd, _MLM + "transform.LayerNorm.", h["transform_layernorm"])
        _put_dense(sd, _MLM + "decoder.", h["decoder"])
        sd[_MLM + "bias"] = np.asarray(h["decoder"]["bias"])
    if "classifier_hidden" in tree:
        _put_dense(sd, "classifier.0.", tree["classifier_hidden"])
        _put_dense(sd, "classifier.2.", tree["classifier_out"])
    if "mpm_hidden" in tree:
        _put_dense(sd, "mpm_head.0.", tree["mpm_hidden"])
        _put_dense(sd, "mpm_head.2.", tree["mpm_out"])
    return sd
