"""Tower-level inference functions of retrieval and QA serving and of the
eval protocols.

Counterpart of the inference builders in ``alpro_tpu/train/step.py``
(``make_text_encode_fn``, ``make_video_embed_fn``, ``make_fusion_score_fn``,
the batched pair builders ``make_fusion_score_pairs_fn`` and
``make_fusion_rerank_bank_fn``, the naive
``make_retrieval_inference_fn``, ``_qa_logits``, ``make_qa_inference_fn``,
``make_qa_video_encode_fn``; ``train/step.py`` trains through
``qa_logits``). The JAX builders return pure
functions of ``(params, ...)``; here the model owns its weights, so each
function takes only the inputs and runs under ``torch.inference_mode``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from alpro_tpu_torch.models.alpro import AlproModel


def make_text_encode_fn(model: AlproModel) -> Callable:
    """(batch with ``text_input_ids``/``text_input_mask``) →
    (text_embeds (B, L, D), text_feat (B, 256) fp32)."""

    @torch.inference_mode()
    def encode(batch):
        text_embeds = model.embed_text(batch["text_input_ids"], batch["text_input_mask"])
        return text_embeds, model.text_feat(text_embeds)

    return encode


def make_video_embed_fn(model: AlproModel) -> Callable:
    """pixels → (video_embeds (B, 1+N, D), video_feat (B, 256) fp32)."""

    @torch.inference_mode()
    def embed(pixels):
        video_embeds = model.embed_video(pixels)
        return video_embeds, model.video_feat(video_embeds)

    return embed


def make_fusion_score_fn(model: AlproModel) -> Callable:
    """ITM logits (B, 2) fp32 for pre-encoded (text, video) pairs; one video
    (1, 1+N, D) is broadcast over B texts."""

    @torch.inference_mode()
    def score(text_embeds, text_mask, video_embeds):
        n_text = text_embeds.shape[0]
        if video_embeds.shape[0] == 1 and n_text > 1:
            video_embeds = video_embeds.expand(n_text, *video_embeds.shape[1:])
        fusion = model.fuse(text_embeds, text_mask, video_embeds)
        return model.itm_logits(fusion[:, 0, :])

    return score


def make_fusion_score_pairs_fn(model: AlproModel) -> Callable:
    """ITM logits for the whole V×C cross product of pre-encoded videos and
    texts in one fusion call: (V, 1+N, D) videos × (C, L, D) texts →
    (V, C, 2). Pairs are video-major: the texts tile V times, each video
    repeats C times."""

    @torch.inference_mode()
    def score(text_embeds, text_mask, video_embeds):
        V, C = video_embeds.shape[0], text_embeds.shape[0]
        te = text_embeds.repeat(V, 1, 1)
        tm = text_mask.repeat(V, 1)
        ve = video_embeds.repeat_interleave(C, dim=0)
        fusion = model.fuse(te, tm, ve)
        return model.itm_logits(fusion[:, 0, :]).reshape(V, C, 2)

    return score


def make_fusion_rerank_bank_fn(model: AlproModel) -> Callable:
    """ITM logits for an arbitrary pair list against a device-resident video
    token bank: (C, L, D) text-chunk embeds + (V, 1+N, D) bank + per-pair
    index vectors tidx/vidx (P,) on the device → (P, 2) logits. Both gathers
    run on the device (``index_select``, a new contiguous tensor that the
    kernels read)."""

    @torch.inference_mode()
    def score(text_embeds, text_mask, bank, tidx, vidx):
        te = text_embeds.index_select(0, tidx)
        tm = text_mask.index_select(0, tidx)
        ve = bank.index_select(0, vidx)
        fusion = model.fuse(te, tm, ve)
        return model.itm_logits(fusion[:, 0, :])

    return score


def make_retrieval_inference_fn(model: AlproModel) -> Callable:
    """1 video vs N texts, both towers in one call (ALPRO's own eval
    forward): batch with ``visual_inputs`` (1, T, H, W, 3),
    ``text_input_ids``/``text_input_mask`` (N, L) → {"logits": (N, 2),
    "itc_scores": (1, N)}."""

    @torch.inference_mode()
    def infer(batch):
        video_embeds = model.embed_video(batch["visual_inputs"])
        mask = batch["text_input_mask"]
        text_embeds = model.embed_text(batch["text_input_ids"], mask)
        vfeat, tfeat = model.video_feat(video_embeds), model.text_feat(text_embeds)
        itc_scores = vfeat @ tfeat.T / model.temperature()
        n_text = text_embeds.shape[0]
        video_rep = video_embeds.expand(n_text, *video_embeds.shape[1:])
        fusion = model.fuse(text_embeds, mask, video_rep)
        return {"logits": model.itm_logits(fusion[:, 0, :]), "itc_scores": itc_scores}

    return infer


def qa_logits(model: AlproModel, batch, n_options: int = 1,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """QA logits (B, num_labels) fp32 (``_qa_logits``). ``batch`` holds
    ``text_input_ids``/``text_input_mask`` and either cached
    ``video_embeds`` (n, 1+N, D) or ``visual_inputs`` pixels. With
    ``n_options > 1`` (multi-choice, ``num_labels`` 1) the text rows are
    question-major (B·n_options) Q+option sequences against B videos: each
    video row repeats per option and the scores regroup to (B, n_options).
    ``generator``: the dropout masks' source when the model is in training
    (``train/step.py::make_qa_train_step``)."""
    if "video_embeds" in batch:
        video_embeds = batch["video_embeds"]
    else:
        video_embeds = model.embed_video(batch["visual_inputs"], generator)
    mask = batch["text_input_mask"]
    text_embeds = model.embed_text(batch["text_input_ids"], mask, generator)
    if n_options > 1:
        video_embeds = video_embeds.repeat_interleave(n_options, dim=0)
    fusion = model.fuse(text_embeds, mask, video_embeds, None, generator)
    logits = model.classify(fusion[:, 0, :])
    if n_options > 1:
        logits = logits.reshape(-1, n_options)
    return logits


def make_qa_inference_fn(model: AlproModel, n_options: int = 1) -> Callable:
    """batch → ``qa_logits(model, batch, n_options)``."""

    @torch.inference_mode()
    def infer(batch):
        return qa_logits(model, batch, n_options)

    return infer


def make_qa_video_encode_fn(model: AlproModel) -> Callable:
    """(n, T, H, W, 3) pixels → (n, 1+N, D) video tokens: the tower half of
    ``qa_logits``, so QA serving encodes a video once for many questions."""

    @torch.inference_mode()
    def encode(pixels):
        return model.embed_video(pixels)

    return encode
