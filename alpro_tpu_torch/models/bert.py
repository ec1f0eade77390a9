"""Split text/fusion BERT encoder (counterpart of ``alpro_tpu/models/bert.py``).

One 12-layer post-LN encoder split by ``fusion_layer``: ``mode='text'`` runs
layers [0, fusion_layer) on token embeddings, ``mode='fusion'`` runs
[fusion_layer, num_layers) on pre-computed ``encoder_embeds``
(= concat[text, video tokens]), ``mode='multi_modal'`` runs all. Masking adds
the HF constant ``(1-mask)·-10000``. Parameter names follow the ALPRO state
dict (``text_encoder.bert.*``).

``block_impl``: ``fused`` runs each layer as two kernels — the masked
attention chain and the post-LN MLP chain (``ops/bert_block.py``), reading
the same parameters as the plain layer; ``plain`` runs the plain layer
(``xla``, as a JAX config names it, means the same); ``auto`` (the default)
resolves to ``fused`` for a CUDA tensor and to ``plain`` for a CPU tensor.
The TPU package's gate (``_on_tpu()``, S <= 640, D % 128) is not carried
over: the kernels take every S the model gives, up to a limit they raise on
(``bert_block.max_seq_len``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from alpro_tpu_torch.ops.attention import multi_head_attention_bshd
from alpro_tpu_torch.ops.bert_block import bert_attention_block, bert_mlp_block
from alpro_tpu_torch.ops.layers import LayerNorm, gelu_exact, linear


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    fusion_layer: int = 6
    initializer_range: float = 0.02
    block_impl: str = "auto"

    def __post_init__(self):
        if self.block_impl not in ("auto", "fused", "plain", "xla"):
            raise ValueError(
                f"block_impl={self.block_impl!r}: expected 'auto', 'fused', 'plain' or 'xla'"
            )

    def use_fused(self, x: torch.Tensor) -> bool:
        """Whether the layers run the fused kernels for activations ``x``."""
        if self.block_impl == "auto":
            return x.device.type == "cuda"
        return self.block_impl == "fused"

    @classmethod
    def from_json_dict(cls, d: dict) -> "BertConfig":
        keys = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in keys})


def container(**children: nn.Module) -> nn.Module:
    """A bare module holding ``children`` (mirrors the ALPRO key nesting)."""
    m = nn.Module()
    for name, child in children.items():
        m.add_module(name, child)
    return m


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        D = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, D)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, D)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, D)
        self.LayerNorm = LayerNorm(D, cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor, dtype) -> torch.Tensor:
        L = input_ids.shape[1]
        pos = torch.arange(L, device=input_ids.device)
        x = (self.word_embeddings(input_ids).to(dtype)
             + self.position_embeddings(pos)[None].to(dtype)
             + self.token_type_embeddings.weight[0].to(dtype))
        return self.LayerNorm(x, dtype)


class BertLayer(nn.Module):
    """Post-LN layer: LN(x + proj(MHA(x))), then LN(x + fc2(gelu(fc1(x))))."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        D, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.num_heads = cfg.num_attention_heads
        self.attention = container(
            self=container(query=nn.Linear(D, D), key=nn.Linear(D, D),
                            value=nn.Linear(D, D)),
            output=container(dense=nn.Linear(D, D), LayerNorm=LayerNorm(D, eps)),
        )
        self.intermediate = container(dense=nn.Linear(D, cfg.intermediate_size))
        self.output = container(
            dense=nn.Linear(cfg.intermediate_size, D), LayerNorm=LayerNorm(D, eps)
        )

    def forward(self, x, attention_mask, dtype, fused: bool):
        if fused:
            return self._fused(x, attention_mask, dtype)
        B, L, D = x.shape
        H = self.num_heads
        sa = self.attention.self
        q, k, v = (linear(x, lin, dtype).reshape(B, L, H, D // H)
                   for lin in (sa.query, sa.key, sa.value))
        ctx = multi_head_attention_bshd(q, k, v, key_mask=attention_mask).reshape(B, L, D)
        out = self.attention.output
        x = out.LayerNorm(linear(ctx, out.dense, dtype) + x, dtype)
        inter = gelu_exact(linear(x, self.intermediate.dense, dtype))
        return self.output.LayerNorm(linear(inter, self.output.dense, dtype) + x, dtype)

    def _fused(self, x, attention_mask, dtype):
        """The two kernels, on the weights and biases cast to the compute
        dtype (as the JAX layer casts them) and the LN parameters as stored."""
        sa, ao = self.attention.self, self.attention.output
        x = bert_attention_block(
            x.to(dtype), attention_mask,
            *(t.to(dtype) for lin in (sa.query, sa.key, sa.value, ao.dense)
              for t in (lin.weight, lin.bias)),
            ao.LayerNorm.weight, ao.LayerNorm.bias, self.num_heads, eps=ao.LayerNorm.eps,
        )
        fc1, fc2, ln = self.intermediate.dense, self.output.dense, self.output.LayerNorm
        return bert_mlp_block(
            x, fc1.weight.to(dtype), fc1.bias.to(dtype), fc2.weight.to(dtype),
            fc2.bias.to(dtype), ln.weight, ln.bias, eps=ln.eps,
        )


class BertModel(nn.Module):
    """Mode-routed encoder. For ``mode='fusion'``, pass ``encoder_embeds``."""

    def __init__(self, cfg: BertConfig, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = container(
            layer=nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_hidden_layers))
        )

    def forward(self, input_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                encoder_embeds: Optional[torch.Tensor] = None,
                mode: str = "multi_modal") -> torch.Tensor:
        cfg = self.cfg
        ranges = {
            "text": (0, cfg.fusion_layer),
            "fusion": (cfg.fusion_layer, cfg.num_hidden_layers),
            "multi_modal": (0, cfg.num_hidden_layers),
        }
        if mode not in ranges:
            raise ValueError(f"invalid mode {mode!r}")
        lo, hi = ranges[mode]
        if encoder_embeds is None:
            if input_ids is None:
                raise ValueError("input_ids required without encoder_embeds")
            x = self.embeddings(input_ids, self.dtype)
        else:
            x = encoder_embeds.to(self.dtype)
        if attention_mask is None:
            attention_mask = torch.ones(x.shape[:2], dtype=torch.int32, device=x.device)
        fused = cfg.use_fused(x)
        if fused:  # the kernels read an fp32 mask: convert once, not per layer
            attention_mask = attention_mask.float()
        for layer in self.encoder.layer[lo:hi]:
            x = layer(x, attention_mask, self.dtype, fused)
        return x
