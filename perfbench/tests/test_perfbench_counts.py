"""The FLOP and byte counts against hand counts."""

from __future__ import annotations

import pytest

from perfbench.counts import kernels, model

D, DH = 768, 3072


def test_timesformer_b16_forward_at_8_frames_is_0_39_tflop():
    """17·D² multiply-adds a patch token a block (qkv, proj and temporal_fc
    of the temporal branch; qkv and proj of the spatial one; fc1 and fc2),
    over 12 blocks and 1568 tokens, plus the T CLS copies the spatial branch
    carries and the one the MLP carries, the attentions and the patch
    embedding. ``bench.py``'s 0.76 TFLOP a clip is about twice this."""
    T, N, blocks = 8, 196, 12
    tokens = T * N
    per_token = 2 * 17 * D * D
    hand = (blocks * per_token * tokens
            + blocks * 2 * 4 * D * D * T            # the spatial branch's T CLS rows
            + blocks * 2 * 8 * D * D                # the MLP's CLS row
            + blocks * 4 * T * (N + 1) ** 2 * D     # spatial attention
            + blocks * 4 * N * T * T * D            # temporal attention
            + 2 * tokens * 768 * D)                 # patch embedding
    got = model.timesformer_forward(T)
    assert got == hand
    assert 0.385e12 < got < 0.395e12
    assert 0.76e12 / got > 1.9


def test_timesformer_at_16_frames_is_about_0_78_tflop():
    got = model.timesformer_forward(16)
    assert 0.77e12 < got < 0.80e12


def test_a_fusion_pair_and_the_text_half():
    S = 40 + 197
    layer = 2 * S * D * D * 4 + 4 * S * S * D + 2 * S * D * DH * 2
    assert model.bert_layers(S, 6) == 6 * layer
    assert 20e9 < model.bert_layers(S, 6) < 22e9
    assert model.bert_layers(40, 6) == 6 * (2 * 40 * D * D * 4 + 4 * 40 * 40 * D
                                            + 2 * 40 * D * DH * 2)


def test_query_and_qa_counts_sum_their_parts():
    q = model.query(40, 1000, 128)
    parts = (model.bert_layers(40, 6) + 2 * D * 256 + 2 * 256 * 1000
             + 128 * (model.bert_layers(237, 6) + 2 * D * 2))
    assert q == parts
    assert 2.6e12 < q < 2.8e12
    fwd = model.qa_forward(16, 40, 1500)
    assert fwd == (model.timesformer_forward(16) + model.bert_layers(40, 6)
                   + model.bert_layers(237, 6) + 2 * D * 1536 + 2 * 1536 * 1500)
    assert model.qa_train_clip(16, 40, 1500) == 3 * fwd


@pytest.mark.parametrize("M,S", [(256, 197), (1, 40)])
def test_spatial_attention_work(M, S):
    flops, nbytes = kernels.spatial_attn(M, S)
    assert flops == 4 * M * 12 * S * S * 64
    assert nbytes == (M * S * 3 * D * 2) + (M * S * D * 2)     # qkv in, out back


def test_mlp_and_bert_attention_work():
    flops, nbytes = kernels.ln_mlp(100)
    assert flops == 4 * 100 * D * DH
    assert nbytes == 2 * 100 * D * 2 + 2 * D * DH * 2 + (DH + 3 * D) * 4
    flops, nbytes = kernels.bert_attn(8, 237)
    assert flops == 8 * 8 * 237 * D * D + 4 * 8 * 12 * 237 * 237 * 64
    assert nbytes == 2 * 8 * 237 * D * 2 + 4 * D * D * 2 + 8 * 237 * 4 + 6 * D * 2


def test_bounds_take_the_slower_of_compute_and_memory():
    assert kernels.bound_s((989e12, 0)) == pytest.approx(1.0)
    assert kernels.bound_s((0, 3.35e12)) == pytest.approx(1.0)
    # the ingest call's bound is the sum of its kernels' bounds, block by block
    parts = [kernels.temporal_attn(32, 8, 196), kernels.spatial_attn(256, 197),
             kernels.ln_mlp(32 * 8 * 196), kernels.ln_mlp(32)]
    assert kernels.ingest_call_bound_s(32, 8) == pytest.approx(
        12 * sum(kernels.bound_s(p) for p in parts))
    assert kernels.query_bound_s(40, 128) == pytest.approx(6 * sum(kernels.bound_s(p) for p in (
        kernels.bert_attn(1, 40), kernels.ln_mlp(40), kernels.bert_attn(128, 237),
        kernels.ln_mlp(128 * 237))))
