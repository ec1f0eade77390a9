"""Plain ALPRO-base in fp32: TimeSformer-B/16 with divided space-time
attention, the BERT-base text half and fusion half, the projections and the
ITM and QA heads. It judges what the program produces, so it imports nothing
of the program: it reads a dict of weights in the ALPRO key space
(``<module path>.weight``), the patch embedding held as its (p·p·3, D)
matmul kernel.

Departures from the published model, each on purpose:

* the uint8 clip is normalized here, (v/255 − mean)/std per channel, where
  the program folds that into its patch-embedding weights;
* in training, dropout and drop-path masks are drawn from the step's
  ``torch.Generator`` in the order, shapes and dtype in which the program
  draws them (``torch.bernoulli`` on an fp32 tensor of the mask's shape),
  so that on one card both sides drop the same units. The masks are no
  input: each side draws them from (seed, step);
* ``numerics="fp8"`` rounds both operands of every matmul (the linear
  layers' and the attention's) to float8 e4m3, each with a per-tensor scale
  (the control: a precision below the configuration's bf16).

Matmuls run in full fp32: ``exact_fp32()`` turns TF32 off."""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

Weights = Dict[str, torch.Tensor]
VIS = "visual_encoder.model."
BERT = "text_encoder.bert."


@contextlib.contextmanager
def exact_fp32():
    """fp32 matmuls and convolutions without TF32, restored after."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c
        torch.set_float32_matmul_precision(prec)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 at a per-tensor scale, back in fp32 (the gradient
    passes straight through)."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


class Net:
    """The weights and how matmuls round (``fp32`` or ``fp8``)."""

    def __init__(self, w: Weights, numerics: str = "fp32"):
        if numerics not in ("fp32", "fp8"):
            raise ValueError(numerics)
        self.w, self.fp8 = w, numerics == "fp8"

    def lin(self, x: torch.Tensor, name: str) -> torch.Tensor:
        w, b = self.w[name + ".weight"], self.w.get(name + ".bias")
        if self.fp8:
            x, w = _fp8(x), _fp8(w)
        return F.linear(x, w, b)

    def ln(self, x: torch.Tensor, name: str, eps: float) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.w[name + ".weight"], self.w[name + ".bias"],
                            eps)


# ---- the training-time draws (the order, shapes and dtype of the program's) ----
def keep_mask(shape, rate: float, gen: torch.Generator, device) -> torch.Tensor:
    return torch.bernoulli(torch.empty(shape, device=device), 1.0 - rate, generator=gen).bool()


def dropout(x, rate: float, gen, train: bool):
    if not train or rate == 0.0:
        return x
    keep = keep_mask(x.shape, rate, gen, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def drop_path(x, rate: float, shape, gen, train: bool):
    if not train or rate == 0.0:
        return x
    keep = keep_mask(shape, rate, gen, x.device).to(x.dtype)
    return x * keep / torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)


def checkpointed(fn, gen: Optional[torch.Generator], *args):
    """fn(*args) under activation checkpointing; the recompute draws the
    forward's masks again (the generator's state at the forward's start is
    restored for it, and the state reached is put back after)."""
    start = gen.get_state()
    first = [True]

    def run(*a):
        if first[0]:
            first[0] = False
            return fn(*a)
        resume = gen.get_state()
        gen.set_state(start)
        try:
            return fn(*a)
        finally:
            gen.set_state(resume)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


def attention(q, k, v, bias=None, rate: float = 0.0, gen=None, train: bool = False,
              fp8: bool = False):
    """q, k, v (B, S, H, hd) → (B, Sq, H, hd); ``bias`` (B, 1, 1, Sk) added
    to the scores; dropout on the probabilities."""
    if fp8:
        q, k, v = _fp8(q), _fp8(k), _fp8(v)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    if bias is not None:
        scores = scores + bias
    probs = dropout(torch.softmax(scores, dim=-1), rate, gen, train)
    return torch.einsum("bhqk,bkhd->bqhd", _fp8(probs) if fp8 else probs, v)


# ---- TimeSformer-B/16, divided space-time --------------------------------------
def _vit_attention(net: Net, x, name: str, heads: int):
    M, S, D = x.shape
    qkv = net.lin(x, name + ".qkv").reshape(M, S, 3, heads, D // heads)
    out = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], fp8=net.fp8)
    return net.lin(out.reshape(M, S, D), name + ".proj")


def _mlp(net: Net, x, name: str):
    return net.lin(F.gelu(net.lin(x, name + ".fc1")), name + ".fc2")


def divided_block(net: Net, i: int, cls, x, vcfg: dict, rate: float, gen, train: bool):
    """One block on cls (B, 1, D) and patches x (B, T, N, D)."""
    p, eps, H = f"{VIS}blocks.{i}.", vcfg["ln_eps"], vcfg["num_heads"]
    B, T, N, D = x.shape
    xt = net.ln(x, p + "temporal_norm1", eps).permute(0, 2, 1, 3).reshape(B * N, T, D)
    t = _vit_attention(net, xt, p + "temporal_attn", H).reshape(B, N, T, D).permute(0, 2, 1, 3)
    t = drop_path(t, rate, (B, 1, N, 1), gen, train)
    x = x + net.lin(t, p + "temporal_fc")
    xs = torch.cat([cls[:, None].expand(B, T, 1, D), x], dim=2).reshape(B * T, 1 + N, D)
    s = _vit_attention(net, net.ln(xs, p + "norm1", eps), p + "attn", H).reshape(B, T, 1 + N, D)
    s = drop_path(s, rate, (B, T, 1, 1), gen, train)
    cls = cls + s[:, :, 0].mean(dim=1, keepdim=True)
    x = x + s[:, :, 1:]
    m_cls = _mlp(net, net.ln(cls, p + "norm2", eps), p + "mlp")
    m_x = _mlp(net, net.ln(x, p + "norm2", eps), p + "mlp")
    if train and rate > 0.0:        # one per-sample mask for the CLS and the patches
        keep = drop_path(torch.ones((B, 1, 1), device=x.device), rate, (B, 1, 1), gen, train)
        m_cls, m_x = m_cls * keep, m_x * keep[:, :, None]
    return cls + m_cls, x + m_x


def video_tokens(net: Net, pixels: torch.Tensor, vcfg: dict, gen=None, train: bool = False,
                 ckpt: bool = False) -> torch.Tensor:
    """uint8 clips (B, T, H, W, 3) → the temporally pooled (B, 1+N, D)
    tokens after the final LayerNorm."""
    w, p, D = net.w, vcfg["patch_size"], vcfg["embed_dim"]
    mean = torch.tensor(vcfg["pixel_mean"], device=pixels.device)
    std = torch.tensor(vcfg["pixel_std"], device=pixels.device)
    x = (pixels.float() / 255.0 - mean) / std
    B, T, Hh, Ww, C = x.shape
    hp, wp = Hh // p, Ww // p
    v = x.reshape(B, T, hp, p, wp, p, C).permute(0, 1, 2, 4, 3, 5, 6).reshape(B, T, hp * wp, -1)
    kernel = w[VIS + "patch_embed.kernel"]
    if net.fp8:
        v, kernel = _fp8(v), _fp8(kernel)
    x = v @ kernel + w[VIS + "patch_embed.bias"]
    pos = w[VIS + "pos_embed"]
    x = x + pos[:, 1:][:, None] + w[VIS + "time_embed"][:, :T, None]
    cls = (w[VIS + "cls_token"] + pos[:, :1]).expand(B, 1, D)
    depth = vcfg["depth"]
    for i in range(depth):
        rate = vcfg["drop_path_rate"] * i / max(depth - 1, 1)
        fn = lambda c, xx, i=i, rate=rate: divided_block(net, i, c, xx, vcfg, rate, gen, train)
        if train and ckpt and torch.is_grad_enabled():
            cls, x = checkpointed(fn, gen, cls, x)
        else:
            cls, x = fn(cls, x)
    eps = vcfg["ln_eps"]
    cls, x = net.ln(cls, VIS + "norm", eps), net.ln(x, VIS + "norm", eps)
    return torch.cat([cls, x.mean(dim=1)], dim=1)


# ---- BERT-base, split at fusion_layer ------------------------------------------
def _bert_layers(net: Net, x, mask, lo: int, hi: int, bcfg: dict, gen, train: bool):
    B, L, D = x.shape
    H, eps = bcfg["num_attention_heads"], bcfg["layer_norm_eps"]
    rate_a, rate_h = bcfg["attention_probs_dropout_prob"], bcfg["hidden_dropout_prob"]
    bias = ((1.0 - mask.float()) * -10000.0)[:, None, None, :]
    for i in range(lo, hi):
        p = f"{BERT}encoder.layer.{i}."
        q, k, v = (net.lin(x, p + "attention.self." + n).reshape(B, L, H, D // H)
                   for n in ("query", "key", "value"))
        ctx = attention(q, k, v, bias, rate_a, gen, train, net.fp8).reshape(B, L, D)
        a = dropout(net.lin(ctx, p + "attention.output.dense"), rate_h, gen, train)
        x = net.ln(a + x, p + "attention.output.LayerNorm", eps)
        h = F.gelu(net.lin(x, p + "intermediate.dense"))
        y = dropout(net.lin(h, p + "output.dense"), rate_h, gen, train)
        x = net.ln(y + x, p + "output.LayerNorm", eps)
    return x


def text_embeds(net: Net, ids, mask, bcfg: dict, gen=None, train: bool = False):
    """Token ids (B, L) → (B, L, D) through layers [0, fusion_layer)."""
    w, L = net.w, ids.shape[1]
    x = (w[BERT + "embeddings.word_embeddings.weight"][ids]
         + w[BERT + "embeddings.position_embeddings.weight"][:L][None]
         + w[BERT + "embeddings.token_type_embeddings.weight"][0])
    x = net.ln(x, BERT + "embeddings.LayerNorm", bcfg["layer_norm_eps"])
    x = dropout(x, bcfg["hidden_dropout_prob"], gen, train)
    return _bert_layers(net, x, mask, 0, bcfg["fusion_layer"], bcfg, gen, train)


def fusion(net: Net, text, text_mask, video, bcfg: dict, gen=None, train: bool = False):
    """[text; video tokens] through layers [fusion_layer, num_hidden_layers)."""
    x = torch.cat([text, video], dim=1)
    mask = torch.cat([text_mask, torch.ones(video.shape[:2], dtype=text_mask.dtype,
                                            device=video.device)], dim=1)
    return _bert_layers(net, x, mask, bcfg["fusion_layer"], bcfg["num_hidden_layers"], bcfg,
                        gen, train)


# ---- heads ------------------------------------------------------------------------
def feature(net: Net, tokens, proj: str) -> torch.Tensor:
    """The CLS token through ``vision_proj`` or ``text_proj``, L2-normalized."""
    f = net.lin(tokens[:, 0], proj)
    return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)


def p_match(net: Net, fused) -> torch.Tensor:
    return torch.softmax(net.lin(fused[:, 0], "itm_head"), dim=-1)[:, 1]


def qa_logits(net: Net, pixels, ids, mask, cfg: dict, gen=None, train: bool = False,
              ckpt: bool = False) -> torch.Tensor:
    """The QA model: both towers, the fusion, the classifier on the fusion CLS."""
    bcfg = cfg["model_config"]
    video = video_tokens(net, pixels, vision_config(cfg), gen, train, ckpt)
    text = text_embeds(net, ids, mask, bcfg, gen, train)
    fused = fusion(net, text, mask, video, bcfg, gen, train)
    return net.lin(torch.relu(net.lin(fused[:, 0], "classifier.0")), "classifier.2")


def vision_config(cfg: dict) -> dict:
    """The tower's sizes from a configuration file of ``configs/``
    (TimeSformer-B/16: 12 blocks, 12 heads of 64, LayerNorm eps 1e-6)."""
    v = cfg["visual_model_cfg"]
    if v.get("drop_rate", 0.0) or v.get("attn_drop_rate", 0.0):
        raise ValueError("the reference draws no tower dropout: drop_rate and "
                         "attn_drop_rate must be 0, as in TimeSformer-B/16's config")
    return {"patch_size": v.get("patch_size", 16), "embed_dim": v.get("embed_dim", 768),
            "depth": v.get("depth", 12), "num_heads": v.get("num_heads", 12),
            "ln_eps": v.get("ln_eps", 1e-6), "drop_path_rate": v.get("drop_path_rate", 0.1),
            "pixel_mean": cfg["img_pixel_mean"], "pixel_std": cfg["img_pixel_std"]}
