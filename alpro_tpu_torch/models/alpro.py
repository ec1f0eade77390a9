"""ALPRO model: video tower, split BERT, projections and the task heads.

Counterpart of ``alpro_tpu/models/alpro.py``: one module for ALPRO's
pretraining model (``with_mlm_head`` and ``num_entities`` > 0: the MLM head
``text_encoder.cls.predictions`` and the MPM head ``mpm_head.0`` (768 →
1536), ReLU, ``mpm_head.2`` (→ num_entities)), the prompter and retrieval
model (the bare model) and the QA model (``num_labels`` > 0: the classifier
``classifier.0`` (768 → 768·cls_hidden_scale), ReLU, ``classifier.2`` (→
num_labels)). It exposes the building blocks the serving and training
paths compose (``embed_video``, ``embed_text``, ``video_feat``/
``text_feat``, ``fuse``, ``itm_logits``, ``mlm_logits``, ``mpm_logits``,
``classify``, ``temperature``). Parameter names are the ALPRO state-dict
keys (``checkpoint/load.py``).

``dtype`` is the compute dtype: weights are cast to it at use (so fp32
weights serve in bf16, as in the JAX package), LayerNorm statistics stay
fp32, and the contrastive features and logits come back in fp32.

The model is built in eval mode (the JAX ``deterministic=True`` default).
After ``train()``, ``embed_video``, ``embed_text`` and ``fuse`` take the
``generator`` their dropout and drop-path masks are drawn from
(``train/step.py`` derives one per step from its seed and step).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from alpro_tpu_torch.core.trace import span
from alpro_tpu_torch.models.bert import BertConfig, BertMLMHead, BertModel, container
from alpro_tpu_torch.models.timesformer import TimeSformer, TimeSformerConfig
from alpro_tpu_torch.ops.layers import LayerNorm, linear


@dataclasses.dataclass(frozen=True)
class AlproConfig:
    bert: BertConfig
    visual: TimeSformerConfig
    embed_dim: int = 256
    temp_init: float = 0.07
    num_labels: int = 0
    with_mlm_head: bool = False
    num_entities: int = 0
    cls_hidden_scale: int = 2


class AlproModel(nn.Module):
    def __init__(self, cfg: AlproConfig, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        D = cfg.bert.hidden_size
        self.visual_encoder = container(model=TimeSformer(cfg.visual, dtype))
        text = {"bert": BertModel(cfg.bert, dtype)}
        if cfg.with_mlm_head:
            text["cls"] = container(predictions=BertMLMHead(cfg.bert))
        self.text_encoder = container(**text)
        self.vision_proj = nn.Linear(cfg.visual.embed_dim, cfg.embed_dim)
        self.text_proj = nn.Linear(D, cfg.embed_dim)
        self.itm_head = nn.Linear(D, 2)
        self.temp = nn.Parameter(torch.tensor(cfg.temp_init))
        if cfg.num_labels > 0:
            hidden = D * cfg.cls_hidden_scale
            self.classifier = nn.Sequential(
                nn.Linear(D, hidden), nn.ReLU(), nn.Linear(hidden, cfg.num_labels)
            )
        if cfg.num_entities > 0:
            self.mpm_head = nn.Sequential(
                nn.Linear(D, 2 * D), nn.ReLU(), nn.Linear(2 * D, cfg.num_entities)
            )
        self.eval()  # deterministic until train(), as the JAX default

    def temperature(self) -> torch.Tensor:
        return torch.clamp(self.temp, 0.001, 0.5)

    def embed_video(self, pixels: torch.Tensor,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Video (see ``TimeSformer.forward`` for the input forms) →
        temporally pooled (B, 1+N, D) tokens."""
        with span("video"):
            return self.visual_encoder.model(pixels, generator)

    def embed_text(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Token ids → (B, Lt, D) through the text half (layers 0..fusion)."""
        with span("text"):
            return self.text_encoder.bert(
                input_ids=input_ids, attention_mask=attention_mask, mode="text",
                generator=generator,
            )

    def _l2_feat(self, tokens: torch.Tensor, proj: nn.Linear) -> torch.Tensor:
        feat = linear(tokens[:, 0, :], proj, self.dtype).float()
        return feat / torch.linalg.vector_norm(feat, dim=-1, keepdim=True)

    def video_feat(self, video_embeds: torch.Tensor) -> torch.Tensor:
        """CLS token → L2-normalized fp32 contrastive feature."""
        return self._l2_feat(video_embeds, self.vision_proj)

    def text_feat(self, text_embeds: torch.Tensor) -> torch.Tensor:
        return self._l2_feat(text_embeds, self.text_proj)

    def fuse(self, text_embeds: torch.Tensor, text_mask: torch.Tensor,
             video_embeds: torch.Tensor, video_mask: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[text; video] through the fusion half (layers fusion..end)."""
        with span("fusion"):
            B, Lv = video_embeds.shape[:2]
            if video_mask is None:
                video_mask = torch.ones((B, Lv), dtype=text_mask.dtype, device=text_mask.device)
            embeds = torch.cat(
                [text_embeds.to(self.dtype), video_embeds.to(self.dtype)], dim=1
            )
            mask = torch.cat([text_mask, video_mask], dim=1)
            return self.text_encoder.bert(
                encoder_embeds=embeds, attention_mask=mask, mode="fusion", generator=generator
            )

    def itm_logits(self, fusion_cls: torch.Tensor) -> torch.Tensor:
        return linear(fusion_cls, self.itm_head, self.dtype).float()

    def classify(self, fusion_cls: torch.Tensor) -> torch.Tensor:
        """QA head: (B, D) fusion CLS → (B, num_labels) fp32 logits."""
        hidden = torch.relu(linear(fusion_cls, self.classifier[0], self.dtype))
        return linear(hidden, self.classifier[2], self.dtype).float()

    def mlm_logits(self, fusion_text_hidden: torch.Tensor) -> torch.Tensor:
        """MLM head: (B, Lt, D) fusion rows of the text → (B, Lt, vocab) fp32."""
        return self.text_encoder.cls.predictions(fusion_text_hidden, self.dtype).float()

    def mpm_logits(self, masked_mean_embeds: torch.Tensor) -> torch.Tensor:
        """MPM head: (B, D) mean fusion embedding of the erased patches →
        (B, num_entities) fp32 logits."""
        hidden = torch.relu(linear(masked_mean_embeds, self.mpm_head[0], self.dtype))
        return linear(hidden, self.mpm_head[2], self.dtype).float()

    def forward(self, pixels: torch.Tensor, text_ids: torch.Tensor,
                text_mask: torch.Tensor) -> dict:
        """Every head once, as the JAX module's ``__call__``: the towers, the
        features and their (B, B) similarity over the temperature, the fusion
        and the ITM logits, and where the model has them the MLM logits of
        the text rows, the QA logits and the MPM logits of the mean fusion
        row after the visual CLS."""
        video_embeds = self.embed_video(pixels)
        text_embeds = self.embed_text(text_ids, text_mask)
        v_feat, t_feat = self.video_feat(video_embeds), self.text_feat(text_embeds)
        fusion = self.fuse(text_embeds, text_mask, video_embeds)
        out = dict(video_embeds=video_embeds, text_embeds=text_embeds, video_feat=v_feat,
                   text_feat=t_feat, sim=v_feat @ t_feat.T / self.temperature(),
                   fusion=fusion, itm_logits=self.itm_logits(fusion[:, 0, :]))
        Lt = text_ids.shape[1]
        if self.cfg.with_mlm_head:
            out["mlm_logits"] = self.mlm_logits(fusion[:, :Lt, :])
        if self.cfg.num_labels > 0:
            out["cls_logits"] = self.classify(fusion[:, 0, :])
        if self.cfg.num_entities > 0:
            out["mpm_logits"] = self.mpm_logits(torch.mean(fusion[:, Lt + 1:, :], dim=1))
        return out


def _cfgs(bert_cfg, video_enc_cfg, img_size: int, num_frm: int,
          attn_impl: Optional[str]):
    """Config objects pass through (``attn_impl`` replaces theirs when
    given); dicts go through as ``cli/common.py::build_model_from_cfg``
    reads them, with ``attn_impl`` ('auto' when None) for both towers."""
    if isinstance(bert_cfg, BertConfig):
        bert = bert_cfg if attn_impl is None else dataclasses.replace(bert_cfg, attn_impl=attn_impl)
    else:
        bert = BertConfig.from_json_dict({"attn_impl": attn_impl or "auto", **bert_cfg})
    if isinstance(video_enc_cfg, TimeSformerConfig):
        vis = (video_enc_cfg if attn_impl is None
               else dataclasses.replace(video_enc_cfg, attn_impl=attn_impl))
    else:
        vis = TimeSformerConfig.from_reference_cfg(video_enc_cfg, img_size, num_frm,
                                                   attn_impl=attn_impl or "auto")
    return bert, vis


def build_retrieval_model(bert_cfg, video_enc_cfg, img_size: int = 224,
                          num_frm: int = 8, dtype=torch.float32,
                          attn_impl: Optional[str] = None) -> AlproModel:
    """``bert_cfg``: a BertConfig or a ``configs/base_model.json`` dict;
    ``video_enc_cfg``: a TimeSformerConfig or a
    ``configs/timesformer_divst_8x32_224_k600.json`` dict; ``attn_impl``:
    the ``--attn_impl`` flag, set on both towers."""
    bert, vis = _cfgs(bert_cfg, video_enc_cfg, img_size, num_frm, attn_impl)
    return AlproModel(AlproConfig(bert=bert, visual=vis), dtype=dtype)


def build_qa_model(bert_cfg, video_enc_cfg, num_labels: int, img_size: int = 224,
                   num_frm: int = 16, cls_hidden_scale: int = 2,
                   dtype=torch.float32, attn_impl: Optional[str] = None) -> AlproModel:
    """The retrieval model plus the QA classifier (``configs/msrvtt_qa.json``:
    1500 labels, 16 frames, ``cls_hidden_scale`` 2)."""
    bert, vis = _cfgs(bert_cfg, video_enc_cfg, img_size, num_frm, attn_impl)
    return AlproModel(AlproConfig(bert=bert, visual=vis, num_labels=num_labels,
                                  cls_hidden_scale=cls_hidden_scale), dtype=dtype)


def build_pretrain_model(bert_cfg, video_enc_cfg, num_entities: int = 1000,
                         img_size: int = 224, num_frm: int = 4, dtype=torch.float32,
                         attn_impl: Optional[str] = None) -> AlproModel:
    """ALPRO's pretraining model: the retrieval model plus the MLM head and
    the MPM head over ``num_entities`` entities (``configs/pretrain_alpro.json``:
    1000, 4 frames)."""
    bert, vis = _cfgs(bert_cfg, video_enc_cfg, img_size, num_frm, attn_impl)
    return AlproModel(AlproConfig(bert=bert, visual=vis, with_mlm_head=True,
                                  num_entities=num_entities), dtype=dtype)


def build_prompter_model(bert_cfg, video_enc_cfg, img_size: int = 224, num_frm: int = 4,
                         dtype=torch.float32, attn_impl: Optional[str] = None) -> AlproModel:
    """The prompter (the pretraining teacher): the bare model, trained by
    VTC alone."""
    bert, vis = _cfgs(bert_cfg, video_enc_cfg, img_size, num_frm, attn_impl)
    return AlproModel(AlproConfig(bert=bert, visual=vis), dtype=dtype)


@torch.no_grad()
def init_random_(model: AlproModel, generator: torch.Generator) -> AlproModel:
    """Seeded random weights in place: every matrix, embedding and bias
    (the task heads' too) ~ N(0, initializer_range), LayerNorm scales 1
    and biases 0, ``temp`` at its init. For runs with no trained checkpoint."""
    std = model.cfg.bert.initializer_range
    norms = {id(p) for m in model.modules() if isinstance(m, LayerNorm)
             for p in m.parameters()}
    for name, p in model.named_parameters():
        if name == "temp":
            p.fill_(model.cfg.temp_init)
        elif id(p) in norms:
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        else:
            p.normal_(0.0, std, generator=generator)
    return model
