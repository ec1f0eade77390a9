"""The program under test: ``alpro_tpu_torch`` built from a configuration
file of ``configs/`` as its CLIs build it (``cli/common.py::
build_model_from_cfg``: ``attn_impl`` auto, ``remat_policy`` dots_ln, bf16
compute, fp32 parameters), with the benchmark's weights in place of its
random init."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from perfbench.lib.text import WORDS


def build_model(config: dict, device) -> torch.nn.Module:
    """The retrieval model, or the QA model where ``num_labels`` is set,
    with uninitialised parameters on ``device``."""
    from alpro_tpu_torch.models.alpro import build_qa_model, build_retrieval_model
    from alpro_tpu_torch.models.bert import BertConfig
    from alpro_tpu_torch.models.timesformer import TimeSformerConfig

    attn_impl = config.get("attn_impl") or "auto"
    remat = config.get("remat_policy") or "dots_ln"
    bert = dataclasses.replace(
        BertConfig.from_json_dict({"attn_impl": attn_impl, **config["model_config"]}),
        remat_policy=remat)
    v = config["visual_model_cfg"]
    vis = TimeSformerConfig(
        img_size=config["crop_img_size"], patch_size=v.get("patch_size", 16),
        num_frames=config["num_frm"], embed_dim=v.get("embed_dim", 768), depth=v.get("depth", 12),
        num_heads=v.get("num_heads", 12), drop_rate=v.get("drop_rate", 0.0),
        attn_drop_rate=v.get("attn_drop_rate", 0.0), drop_path_rate=v.get("drop_path_rate", 0.1),
        attn_impl=attn_impl, gradient_checkpointing=bool(v.get("gradient_checkpointing", False)),
        remat_policy=remat, pixel_mean=tuple(config["img_pixel_mean"]),
        pixel_std=tuple(config["img_pixel_std"]), fused_patchify="auto")
    dtype = torch.bfloat16 if config.get("compute_dtype", "bfloat16") == "bfloat16" \
        else torch.float32
    with torch.device("meta"):
        if config.get("num_labels"):
            model = build_qa_model(bert, vis, num_labels=config["num_labels"],
                                   cls_hidden_scale=config.get("cls_hidden_scale", 2),
                                   dtype=dtype)
        else:
            model = build_retrieval_model(bert, vis, dtype=dtype)
    return model.to_empty(device=device).eval()


def model_with_weights(ctx):
    """The cell's model on its device with the seed's weights, and its
    layout (parameter names and shapes)."""
    from perfbench.lib.weights import make_weights

    import alpro_tpu_torch.models.alpro  # noqa: F401  (the port's import, timed apart)

    ctx.phase("the program imported")
    torch.empty(1, device=ctx.device)
    ctx.phase("the device's context made")
    model = build_model(ctx.cell.config, ctx.device)
    ctx.phase("model built")
    shapes = layout(model)
    load_weights(model, make_weights(shapes, ctx.seed, ctx.device))
    ctx.phase("weights made and loaded")
    return model, shapes


def layout(model) -> list:
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()]


@torch.no_grad()
def load_weights(model, weights: Dict[str, torch.Tensor]) -> None:
    for n, p in model.named_parameters():
        p.copy_(weights[n])


def tokenizer():
    """The port's WordPiece tokenizer over ``make_test_vocab(WORDS)``."""
    from alpro_tpu_torch.data.tokenization import WordPieceTokenizer, make_test_vocab

    return WordPieceTokenizer(make_test_vocab(WORDS))
