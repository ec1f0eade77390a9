"""``auto`` stays inside each kernel's limits, on the CPU with the limits
passed in.

Each of K1-K5 has one limit predicate in its ``ops`` module — the code the
wrapper's check calls — taking the device's opt-in shared memory per block
as a number. ``TimeSformerConfig.impl`` and ``BertConfig.use_fused`` resolve
``auto`` to a kernel only where that predicate holds for the call site's
shape and dtype, else to the plain path. Here the device is a stand-in
that reports a CUDA device and an H100's 227 KB (232,448 bytes) of opt-in
shared memory, so the resolution is checked without a card; on the card
``chip_smoke.py``'s phase 9 runs the forwards past the limits and counts
the launches.
"""

import types

import pytest
import torch

from alpro_tpu_torch.models.bert import BertConfig
from alpro_tpu_torch.models.timesformer import TimeSformerConfig
from alpro_tpu_torch.ops import _build, bert_block, ln_mlp, qkv_attn

H100_SMEM = 232448
BF16, F32 = torch.bfloat16, torch.float32


@pytest.fixture
def h100(monkeypatch):
    """A CUDA stand-in with an H100's opt-in shared memory: ``x(shape,
    dtype)`` makes activations that report device 'cuda'."""
    monkeypatch.setattr(_build, "smem_optin", lambda device: H100_SMEM)

    def x(shape, dtype=BF16):
        return types.SimpleNamespace(device=torch.device("cuda"), shape=torch.Size(shape),
                                     dtype=dtype)

    return x


def test_predicates_at_their_edges():
    # K1: S up to 224 in bf16 and 256 in fp32 at head_dim 64 (img 224 gives 197)
    assert qkv_attn.spatial_max_seq(64, BF16, H100_SMEM) == 224
    assert qkv_attn.spatial_max_seq(64, F32, H100_SMEM) == 256
    assert qkv_attn.spatial_fits(64, 224, 12, 64, BF16, H100_SMEM)
    assert not qkv_attn.spatial_fits(64, 225, 12, 64, BF16, H100_SMEM)
    assert not qkv_attn.spatial_fits(8, 257, 12, 64, BF16, H100_SMEM)  # img 256
    assert not qkv_attn.spatial_fits(8, 197, 12, 40, BF16, H100_SMEM)  # head_dim % 16
    assert not qkv_attn.spatial_fits(70000, 197, 12, 64, BF16, H100_SMEM)  # grid z
    # K2 / B16: T up to 128, head_dim a multiple of 8 up to 128
    assert qkv_attn.temporal_fits(128, 64, BF16, H100_SMEM)
    assert not qkv_attn.temporal_fits(129, 64, BF16, H100_SMEM)
    assert qkv_attn.temporal_fits(48, 40, F32, H100_SMEM)
    assert not qkv_attn.temporal_fits(8, 36, BF16, H100_SMEM)
    assert not qkv_attn.temporal_fits(8, 136, BF16, H100_SMEM)
    assert not qkv_attn.temporal_fits(8, 64, torch.float16, H100_SMEM)
    # K4: S up to 752 in bf16; K3 / K5: the four widths
    assert bert_block.max_seq(BF16, H100_SMEM) == 752
    assert bert_block.attention_fits(8, 752, 768, 12, BF16, H100_SMEM)
    assert not bert_block.attention_fits(8, 753, 768, 12, BF16, H100_SMEM)
    assert ln_mlp.ln_mlp_fits(768, 3072, BF16)
    assert not ln_mlp.ln_mlp_fits(384, 1536, BF16)
    # the predicates read the figure they are given
    assert qkv_attn.spatial_max_seq(64, BF16, 160_000) < 197
    assert bert_block.max_seq(BF16, 160_000) < 752


def test_timesformer_auto_stays_inside(h100):
    """Per call site: the temporal kernel at T, the spatial kernel at
    1 + N per frame, the MLP tail at D; one past any limit gives plain
    there and leaves the other call sites as they were."""
    cfg = TimeSformerConfig()  # auto, ALPRO-base: 12 heads of 64
    fields = ("attn_impl", "temporal_attn_impl", "mlp_impl")
    flagship = h100((8, 8, 196, 768))
    assert [cfg.impl(f, flagship, False) for f in fields] == ["fused_qkv", "fused_qkv_fold",
                                                              "fused"]
    assert [cfg.impl(f, flagship, True) for f in fields] == ["plain"] * 3
    assert cfg.impl("temporal_attn_impl", h100((1, 128, 4, 768)), False) == "fused_qkv_fold"
    long_t = h100((1, 129, 4, 768))
    assert [cfg.impl(f, long_t, False) for f in fields] == ["fused_qkv", "plain", "fused"]
    big_img = h100((8, 8, 256, 768))  # 256² frames: S = 257 per frame
    assert [cfg.impl(f, big_img, False) for f in fields] == ["plain", "fused_qkv_fold", "fused"]
    assert cfg.impl("attn_impl", big_img, False, dtype=F32) == "plain"  # 257 > 256 in fp32
    assert cfg.impl("attn_impl", h100((8, 8, 255, 768)), False, dtype=F32) == "fused_qkv"
    narrow = TimeSformerConfig(embed_dim=384, num_heads=6)  # K3 takes no D = 384
    assert [narrow.impl(f, h100((2, 8, 196, 384)), False) for f in fields] == [
        "fused_qkv", "fused_qkv_fold", "plain"]
    odd = TimeSformerConfig(embed_dim=640, num_heads=16)  # head_dim 40: K1 takes multiples of 16
    assert [odd.impl(f, h100((2, 8, 196, 640)), False) for f in fields] == [
        "plain", "fused_qkv_fold", "plain"]
    # explicit kernel values are not gated: the wrappers raise past the limits
    explicit = TimeSformerConfig(attn_impl="fused_qkv", temporal_attn_impl="fused_qkv_fold")
    assert explicit.impl("temporal_attn_impl", long_t, False) == "fused_qkv_fold"
    assert explicit.impl("attn_impl", big_img, False) == "fused_qkv"


def test_bert_auto_stays_inside(h100):
    cfg = BertConfig()
    assert cfg.use_fused(h100((8, 237, 768)))
    assert cfg.use_fused(h100((8, 752, 768)))
    assert not cfg.use_fused(h100((8, 800, 768)))  # past K4's 752 in bf16
    assert not cfg.use_fused(h100((8, 237, 768)), training=True)
    assert not cfg.use_fused(h100((8, 400, 768), F32))  # fp32 K4 takes S <= 304
    narrow = BertConfig(hidden_size=384, num_attention_heads=6, intermediate_size=1536)
    assert not narrow.use_fused(h100((8, 40, 384)))
    assert BertConfig(block_impl="fused").use_fused(h100((8, 800, 768)))  # raises at launch
