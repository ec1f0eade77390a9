"""Split text/fusion BERT encoder (counterpart of ``alpro_tpu/models/bert.py``).

One 12-layer post-LN encoder split by ``fusion_layer``: ``mode='text'`` runs
layers [0, fusion_layer) on token embeddings, ``mode='fusion'`` runs
[fusion_layer, num_layers) on pre-computed ``encoder_embeds``
(= concat[text, video tokens]), ``mode='multi_modal'`` runs all. Masking adds
the HF constant ``(1-mask)·-10000``. Parameter names follow the ALPRO state
dict (``text_encoder.bert.*``).

The module is built in eval mode (the JAX ``deterministic=True`` default);
``train()`` turns on dropout after the embeddings, on the attention
probabilities (``attention_probs_dropout_prob``, plain attention only, as in
JAX) and on both hidden outputs (``hidden_dropout_prob``), with masks from
the ``generator`` passed to ``forward``, and per-layer gradient checkpointing
when ``gradient_checkpointing`` is set.

``block_impl``: ``fused`` runs each layer as two kernels — the masked
attention chain and the post-LN MLP chain (``ops/bert_block.py``), reading
the same parameters as the plain layer — in eval only: in training it gives
the plain layer, whose kernels have no backward; ``plain`` runs the plain
layer (``xla``, as a JAX config names it, means the same); ``auto`` (the
default) resolves to ``fused`` in eval on a CUDA tensor whose (M, S, D) both
kernels take (``BertConfig.use_fused``) and to ``plain`` otherwise.
``attn_impl`` picks the attention of the plain layer: ``auto``/``xla``/
``plain`` the plain attention, ``pallas`` the masked-attention kernel
(``ops/masked_attn.py``) with its gradient. The TPU
package's gate (``_on_tpu()``, S <= 640, D % 128) is not carried over:
``auto`` stays inside the kernels' own limits (S <= ``bert_block.max_seq``,
20 480 in bf16 on an H100), and an explicit ``fused`` raises past them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from alpro_tpu_torch.models.remat import resolve_remat_policy
from alpro_tpu_torch.ops.attention import multi_head_attention_bshd
from alpro_tpu_torch.ops import _build
from alpro_tpu_torch.ops.bert_block import attention_fits, bert_attention_block, bert_mlp_block
from alpro_tpu_torch.ops.ln_mlp import ln_mlp_fits
from alpro_tpu_torch.ops.layers import LayerNorm, checkpoint, dropout, gelu_exact, linear


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    fusion_layer: int = 6
    initializer_range: float = 0.02
    attn_impl: str = "auto"
    block_impl: str = "auto"
    # per-layer torch.utils.checkpoint in training, keeping what remat_policy
    # keeps (models/remat.py: 'nothing' or 'dots_ln')
    gradient_checkpointing: bool = False
    remat_policy: str = "nothing"

    def __post_init__(self):
        resolve_remat_policy(self.remat_policy)
        if self.block_impl not in ("auto", "fused", "plain", "xla"):
            raise ValueError(
                f"block_impl={self.block_impl!r}: expected 'auto', 'fused', 'plain' or 'xla'"
            )
        if self.attn_impl not in ("auto", "xla", "plain", "pallas"):
            raise ValueError(
                f"attn_impl={self.attn_impl!r}: expected 'auto', 'xla', 'plain' or 'pallas'"
            )

    def use_fused(self, x: torch.Tensor, training: bool = False) -> bool:
        """Whether the layers run the fused kernels for activations ``x``
        (M, S, D) in the compute dtype: never in training (JAX: ``fused``
        only when deterministic); ``auto`` only on a CUDA tensor that both
        kernels take (their limit predicates in ``ops/``, given the card's
        opt-in shared memory)."""
        if training:
            return False
        if self.block_impl == "auto":
            if x.device.type != "cuda":
                return False
            M, S, D = x.shape
            return (attention_fits(M, S, D, self.num_attention_heads, x.dtype,
                                   _build.smem_optin(x.device))
                    and ln_mlp_fits(D, self.intermediate_size, x.dtype))
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

    def forward(self, input_ids: torch.Tensor, dtype, rate: float = 0.0,
                generator=None) -> torch.Tensor:
        L = input_ids.shape[1]
        pos = torch.arange(L, device=input_ids.device)
        x = (self.word_embeddings(input_ids).to(dtype)
             + self.position_embeddings(pos)[None].to(dtype)
             + self.token_type_embeddings.weight[0].to(dtype))
        return dropout(self.LayerNorm(x, dtype), rate, generator, self.training)


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

    def forward(self, x, attention_mask, dtype, fused: bool, cfg: BertConfig, generator=None):
        if fused:
            return self._fused(x, attention_mask, dtype)
        train = self.training
        B, L, D = x.shape
        H = self.num_heads
        sa = self.attention.self
        q, k, v = (linear(x, lin, dtype).reshape(B, L, H, D // H)
                   for lin in (sa.query, sa.key, sa.value))
        ctx = multi_head_attention_bshd(
            q, k, v, key_mask=attention_mask, impl=cfg.attn_impl,
            dropout_rate=cfg.attention_probs_dropout_prob, generator=generator, training=train,
        ).reshape(B, L, D)
        out = self.attention.output
        attn = dropout(linear(ctx, out.dense, dtype), cfg.hidden_dropout_prob, generator, train)
        x = out.LayerNorm(attn + x, dtype)
        inter = gelu_exact(linear(x, self.intermediate.dense, dtype))
        y = dropout(linear(inter, self.output.dense, dtype), cfg.hidden_dropout_prob,
                    generator, train)
        return self.output.LayerNorm(y + x, dtype)

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
        self.eval()  # deterministic until train(), as the JAX default

    def forward(self, input_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                encoder_embeds: Optional[torch.Tensor] = None,
                mode: str = "multi_modal",
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """In training, dropout masks come from ``generator`` (on the
        activations' device)."""
        cfg, train = self.cfg, self.training
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
            x = self.embeddings(input_ids, self.dtype, cfg.hidden_dropout_prob, generator)
        else:
            x = encoder_embeds.to(self.dtype)
        if attention_mask is None:
            attention_mask = torch.ones(x.shape[:2], dtype=torch.int32, device=x.device)
        fused = cfg.use_fused(x, train)
        if fused:  # the kernels read an fp32 mask: convert once, not per layer
            attention_mask = attention_mask.float()
        remat = train and cfg.gradient_checkpointing and torch.is_grad_enabled()
        context_fn = resolve_remat_policy(cfg.remat_policy) if remat else None
        for layer in self.encoder.layer[lo:hi]:
            if remat:
                x = checkpoint(lambda h, layer=layer: layer(h, attention_mask, self.dtype, fused,
                                                            cfg, generator), generator, x,
                               context_fn=context_fn)
            else:
                x = layer(x, attention_mask, self.dtype, fused, cfg, generator)
        return x


class BertMLMHead(nn.Module):
    """The ``cls.predictions`` head: transform (dense → exact GELU →
    LayerNorm), then the decoder to ``vocab_size`` logits. The decoder is
    its own weight, not tied to the word embeddings (as in the JAX head);
    its bias is the checkpoint's ``cls.predictions.bias`` too
    (``checkpoint/load.py``)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        D = cfg.hidden_size
        self.transform = container(dense=nn.Linear(D, D),
                                   LayerNorm=LayerNorm(D, cfg.layer_norm_eps))
        self.decoder = nn.Linear(D, cfg.vocab_size)

    def forward(self, hidden: torch.Tensor, dtype) -> torch.Tensor:
        x = gelu_exact(linear(hidden, self.transform.dense, dtype))
        return linear(self.transform.LayerNorm(x, dtype), self.decoder, dtype)
