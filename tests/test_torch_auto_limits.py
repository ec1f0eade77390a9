"""``auto`` stays inside each kernel's limits, on the CPU with the limits
passed in.

Each of K1-K5 (K1 with B6) has one limit predicate in its ``ops`` module — the code the
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
from alpro_tpu_torch.ops import _build, bert_block, ln_mlp, masked_attn, qkv_attn

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
    # K1 (and B6 at S = N + 1): head_dim 32, 64 or 128 and any S — past one
    # chunk of keys it walks them twice (img 224 gives 197, 256 gives 257,
    # 384 gives 577, 400 gives 626); the launch's shared memory at the
    # main shape, at 256² and past what stays resident (streamed K and V)
    assert qkv_attn.spatial_smem_bytes(197, 64, BF16, H100_SMEM) == 84992
    assert qkv_attn.spatial_smem_bytes(257, 64, BF16, H100_SMEM) == 150528
    assert qkv_attn.spatial_smem_bytes(1000, 64, BF16, H100_SMEM) == 216064
    assert qkv_attn.spatial_smem_bytes(257, 64, F32, H100_SMEM) == 82432
    for S in (197, 224, 225, 257, 577, 626, 640, 4096):
        assert qkv_attn.spatial_fits(64, S, 12, 64, BF16, H100_SMEM)
        assert qkv_attn.spatial_fits(64, S, 12, 64, F32, H100_SMEM)
    assert qkv_attn.spatial_fits(8, 640, 12, 128, BF16, H100_SMEM)
    assert qkv_attn.spatial_fits(8, 640, 24, 32, F32, H100_SMEM)
    assert not qkv_attn.spatial_fits(8, 0, 12, 64, BF16, H100_SMEM)
    assert not qkv_attn.spatial_fits(8, 197, 12, 40, BF16, H100_SMEM)  # head_dim % 16
    assert not qkv_attn.spatial_fits(8, 197, 16, 48, BF16, H100_SMEM)  # no panel width
    assert not qkv_attn.spatial_fits(8, 197, 12, 256, F32, H100_SMEM)
    assert not qkv_attn.spatial_fits(70000, 197, 12, 64, BF16, H100_SMEM)  # grid z
    # K2 / B16: T up to 128, head_dim a multiple of 8 up to 128
    assert qkv_attn.temporal_fits(128, 64, BF16, H100_SMEM)
    assert not qkv_attn.temporal_fits(129, 64, BF16, H100_SMEM)
    assert qkv_attn.temporal_fits(48, 40, F32, H100_SMEM)
    assert not qkv_attn.temporal_fits(8, 36, BF16, H100_SMEM)
    assert not qkv_attn.temporal_fits(8, 136, BF16, H100_SMEM)
    assert not qkv_attn.temporal_fits(8, 64, torch.float16, H100_SMEM)
    # K4: S up to the masked attention's 20 480 keys in bf16 (its key-bias
    # row in shared memory; K and V stream), 304 in fp32 (K and V of a head
    # in shared memory); K3 / K5: the four widths
    assert bert_block.max_seq(BF16, H100_SMEM) == 20480
    assert bert_block.max_seq(BF16, H100_SMEM) == masked_attn.max_keys(BF16, 64, H100_SMEM)
    assert bert_block.attention_fits(8, 20480, 768, 12, BF16, H100_SMEM)
    assert not bert_block.attention_fits(8, 20481, 768, 12, BF16, H100_SMEM)
    assert bert_block.max_seq(F32, H100_SMEM) == 304
    assert ln_mlp.ln_mlp_fits(768, 3072, BF16)
    assert not ln_mlp.ln_mlp_fits(384, 1536, BF16)
    # the predicates read the figure they are given
    assert not qkv_attn.spatial_fits(8, 197, 12, 64, BF16, 80_000)  # 84,992 at S = 197
    assert qkv_attn.spatial_fits(8, 197, 12, 64, BF16, 84_992)
    assert not qkv_attn.spatial_fits(8, 257, 12, 64, BF16, 150_000)  # two 64 KB slots
    assert bert_block.max_seq(BF16, 160_000) < 20480


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
    big_img = h100((8, 8, 256, 768))  # 256² frames: S = 257 per frame, two key chunks
    assert [cfg.impl(f, big_img, False) for f in fields] == ["fused_qkv", "fused_qkv_fold",
                                                             "fused"]
    assert cfg.impl("attn_impl", big_img, False, dtype=F32) == "fused_qkv"
    assert cfg.impl("attn_impl", h100((8, 8, 625, 768)), False) == "fused_qkv"  # 400² frames
    # B6's predicate is K1's at S = N + 1 (explicit 'cls_sideband'; auto never picks it)
    sideband = TimeSformerConfig(attn_impl="cls_sideband")
    assert sideband.kernel_fits("attn_impl", (8, 8, 256, 768), BF16, H100_SMEM)
    assert sideband.impl("attn_impl", big_img, False) == "cls_sideband"
    assert not TimeSformerConfig(embed_dim=768, num_heads=16).kernel_fits(
        "attn_impl", (8, 8, 256, 768), BF16, H100_SMEM)  # head_dim 48
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
    odd48 = TimeSformerConfig(embed_dim=768, num_heads=16, attn_impl="fused_qkv")
    assert odd48.impl("attn_impl", flagship, False) == "fused_qkv"  # raises at launch


def test_bert_auto_stays_inside(h100):
    cfg = BertConfig()
    assert cfg.use_fused(h100((8, 237, 768)))
    assert cfg.use_fused(h100((8, 20480, 768)))
    assert not cfg.use_fused(h100((8, 20481, 768)))  # past K4's 20 480 in bf16
    assert not cfg.use_fused(h100((8, 237, 768)), training=True)
    assert not cfg.use_fused(h100((8, 400, 768), F32))  # fp32 K4 takes S <= 304
    narrow = BertConfig(hidden_size=384, num_attention_heads=6, intermediate_size=1536)
    assert not narrow.use_fused(h100((8, 40, 384)))
    assert BertConfig(block_impl="fused").use_fused(h100((8, 20481, 768)))  # raises at launch
