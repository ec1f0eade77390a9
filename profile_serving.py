#!/usr/bin/env python3
"""Where the device time of alpro_tpu_torch's serving calls goes, on one card.

    python3 profile_serving.py [--iters 5]

Builds the two ALPRO-base models of ``chip_smoke.py`` (seeded random bf16
weights, hashing stand-in tokenizer) and runs ``torch.profiler`` over
``iters`` repeats of each serving call, on the kernel path (``auto``) and on
the plain path (every ``*_impl='plain'``), each warmed through the same call
first:

* retrieval: ``add_videos`` of 8 clips (8 × 224², T=8), one ``query``
  (topk 16 of a 16-clip gallery); ``add_videos`` also on the video tower's
  opt-in paths (a)-(d) (``chip_smoke.OPT_IN_PATHS``);
* QA: ``encode_video`` of 2 clips (16 × 224²), one cached ``predict``, one
  ``predict_batch`` of 4 questions;
* ``LayerNorm(impl='pallas')`` (the LayerNorm kernel's only entry) and the
  plain ``LayerNorm`` over the rows of one ``add_videos`` call's spatial
  input (8 · 8 · 197, 768) in bf16, under ``no_grad``;
* ``fused_attention_block`` (B17) on the spatial attention sublayer of one
  ``add_videos`` call (64, 197, 768) in bf16, without and with a key mask,
  under ``no_grad``: its launches by kernel name (the per-launch split);
* the MLP kernels ``ln_mlp`` (K3) and ``bert_mlp_block`` (K5) in bf16 at
  their main shapes (12544 and 1896 rows of 768: one ``add_videos`` call's
  patch rows, the fusion of 8 candidates) and small ones (8 and 2 CLS rows;
  40 and 320 rows: one text query, 8 texts), with their device time per
  call by CUDA-graph replay (``chip_smoke.graph_ms``) beside the profile;
* the BERT attention chain ``bert_attention_block`` (K4) in bf16 at the
  fusion of 8 and of 16 candidates (8 and 16 sequences of 40 + 197) and at
  one text query and 8 texts (S = 40), every vector bf16 as the model
  passes them, with its device time per call by CUDA-graph replay;
* the video tower's whole spatial chain ``fused_spatial_block`` (B9) and
  its attention + projection ``spatial_attention_qkv_proj`` (B7) in bf16 at
  one ``add_videos`` call's spatial shape (64 frames of 197 tokens) and QA's
  (32), every vector bf16 as the model passes them, B9 also with the
  residual (then its two GEMMs have two names in the split line), with
  their device time per call by CUDA-graph replay;
* B11 ``ln_matmul`` at one ``add_videos`` call's spatial rows and QA's
  (12608 and 6304 rows of 768 → 2304), the temporal chain
  ``fused_temporal_block`` (B10) at its temporal shape (8, 8, 196) and QA's
  (2, 16, 196) and the temporal attention + projection
  ``temporal_attention_qkv_proj`` (B8) at the same two shapes on the packed
  qkv, in bf16, every vector bf16, and B15 ``patchify_embed`` at one
  ``add_videos`` call's frames (8, 8, 224, 224, 3) and QA's (2, 16, 224,
  224, 3) → 768 with the bf16 bias the model passes, with their device time
  per call by CUDA-graph replay;
* the device time per call (CUDA-graph replay, no profile) of the other
  attention kernels at their main shapes: K2 ``temporal_attention_qkv``
  (8, 8, 196) (its body is B10's and B8's; also at (2, 16, 196) and (1,
  32, 196)), K1 ``spatial_attention_qkv`` (64, 197),
  B6 ``spatial_attention_qkv_cls`` (64, 196) + CLS, B13
  ``fused_attention_bshd`` and B12 ``fused_attention`` at (64, 197) with a
  key mask; and a hash of K2's output on a seeded input.

``--kernels-only`` runs the last seven alone (no model is built). They call
only the wrappers' public entries, so the script also times an older
checkout's kernels when copied into it with ``chip_smoke.py``.

For each it prints one line: host ms per call (synchronised), device kernel
ms per call (the sum of kernel times), device busy ms (the union of kernel
intervals), the idle share of the span from first kernel start to last
kernel end, the copy launches per call (the dtype casts: PyTorch's
``direct_copy_kernel``), and the top kernels by device time with their launch counts;
where the redesigned kernels' bf16 launches ran, a second line splits their
time by kernel name (``SPLIT_STAGES``). Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import sys
import time

import numpy as np
import torch

import chip_smoke as smoke


# the bf16 launches of K3/K5 (csrc/ln_mlp.cu), K4 (csrc/bert_attn.cu), B9
# and B10 (csrc/fused_block.cu), B7 and B8 (csrc/qkv_proj.cu), B11
# (csrc/ln_matmul.cu), B15 (csrc/patchify_embed.cu) and K2's body
# (csrc/temporal_attn.cuh: K2, B16, B10, B8), by a substring of the short
# name; K4's projection is the same
# instantiation as K3/K5's fc2 (gemm_wgmma<2, 1, float>), K4 and K5 share
# the finalize, B9's qkv and (without the residual) projection GEMMs, B7's
# and B8's projections and, with bf16 vectors, B11's and B10's qkv GEMM are
# one instantiation, and B10's projection is B9's with the residual, so a
# call that runs several reads those stages summed. The last ten are the
# bodies before their redesign (an older checkout's).
SPLIT_STAGES = {"LN rows (K3, B9, B10, B11)": "ln_rows", "fc1 (K3/K5)": "gemm_wgmma<1",
                "qkv (K4)": "gemm_wgmma<0, 3",
                "attention (K4)": "attn_wgmma<64, false, true, false",
                "fp32 tiles (K3/K5 fc2, K4 projection)": "gemm_wgmma<2, 1, float>",
                "finalize": "_finalize<",
                "qkv hi/lo (B9), qkv (B10, B11), projection (B7, B8; B9 without residual)":
                    "gemm_wgmma<0, 1, __nv_bfloat16>",
                "attention (B9)": "attn_wgmma<64, false, false, true, true>",
                "attention (B7)": "attn_wgmma<64, false, false, false, true>",
                "projection + residual (B9, B10)": "gemm_wgmma<2, 1, __nv_bfloat16>",
                "attention over T (K2's body: K2, B16, B10, B8)": "temporal_attn_tma",
                "attention over T, wide (K2's body)": "temporal_attn_wide",
                "patch rows (B15)": "patch_rows",
                "GEMM over the patch rows, (K, D) kernel (B15)": "gemm_wgmma_kn",
                "attention over T (K2, B10, older body)": "temporal_attn_kernel",
                "attention + projection (B8, older body)": "temporal_proj",
                "heads (K4, older body)": "bert_attn_heads",
                "projection + LN (K4, older body)": "bert_attn_proj_ln",
                "heads (B9, older body)": "spatial_block_heads",
                "heads (B7, older body)": "spatial_proj_heads",
                "heads (B10, older body)": "temporal_block_heads",
                "LN + qkv (B11, older body)": "ln_matmul_kernel",
                "proj_rows (B9, B7, B10, older body)": "proj_rows",
                "row tile (B15, older body)": "patchify_embed_kernel"}


def _device_stats(prof, iters: int, top_n: int = 5) -> dict:
    """Kernel time by name, busy time and idle share from a profiler run."""
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.elapsed_us() > 0]
    smoke.fail_if(not events, "the profiler recorded no device kernel")
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    by_name: dict = {}
    for e in events:
        name = smoke.kernel_name(e.name)
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + e.time_range.elapsed_us(), n + 1)
    total = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"kernel_ms": total / iters / 1e3, "busy_ms": busy / iters / 1e3,
            "idle": 1.0 - busy / span,
            "top": [(name[:60], t / iters / 1e3, n // iters) for name, (t, n) in top[:top_n]],
            "by_name": {name: (t / iters / 1e3, n // iters) for name, (t, n) in top}}


def _profile(label: str, fn, iters: int, card: str, top_n: int = 5) -> dict:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / iters
    st = _device_stats(prof, iters, top_n)
    st["host_ms"] = host_ms
    top = "; ".join(f"{n} {t:.3f} ms ({c}x)" for n, t, c in st["top"])
    copies = sum(n for name, (_, n) in st["by_name"].items() if "direct_copy" in name)
    print(f"[profile] {label}: host {host_ms:.2f} ms/call, kernels {st['kernel_ms']:.2f} ms, "
          f"busy {st['busy_ms']:.2f} ms, idle {100 * st['idle']:.1f}%, {copies} copy launches "
          f"(casts) | {top} [{card}]", flush=True)
    split = []
    for stage, key in SPLIT_STAGES.items():
        hits = [(t, c) for n, (t, c) in st["by_name"].items() if key in n]
        if hits:
            split.append(f"{stage} {sum(t for t, _ in hits):.4f} ms "
                         f"({sum(c for _, c in hits)}x)")
    if split:
        print(f"[profile]   bf16 split: {'; '.join(split)} [{card}]", flush=True)
    return st


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--kernels-only", action="store_true",
                    help="profile only the LayerNorm, fused_attention_block, MLP, BERT "
                         "attention, spatial and temporal chain, LN-matmul and attention "
                         "kernel calls")
    args = ap.parse_args()
    iters = args.iters
    card = smoke.phase_device()
    smoke.phase_build()
    if not args.kernels_only:
        _profile_models(iters, card)
    _profile_kernels(iters, card)
    return 0


def _profile_models(iters: int, card: str) -> None:
    from alpro_tpu_torch.models.alpro import build_qa_model, build_retrieval_model
    from alpro_tpu_torch.serving.qa import VideoQAPredictor
    from alpro_tpu_torch.serving.retrieval import RetrievalIndex

    rng = np.random.RandomState(smoke.SEED)
    model = smoke._build_model(build_retrieval_model, "timesformer_divst_8x32_224_k600.json",
                               smoke.FRAMES)
    paths = {"kernels": (model.visual_encoder.model.cfg, model.text_encoder.bert.cfg),
             "plain": smoke._plain_cfgs(model)}
    tok = smoke.HashTokenizer(model.cfg.bert.vocab_size)
    clips = rng.randint(0, 256, (smoke.N_CLIPS, smoke.FRAMES, 224, 224, 3), dtype=np.uint8)
    vis, bert = paths["kernels"]
    for name, impls in smoke.OPT_IN_PATHS.items():
        paths[f"opt-in ({name})"] = (dataclasses.replace(vis, **impls), bert)
    for path, cfgs in paths.items():
        smoke._set_path(model, *cfgs)
        index = RetrievalIndex(model, tok, "cuda", max_txt_len=40, topk=16)
        index.add_videos(clips, [str(i) for i in range(smoke.N_CLIPS)])
        batch = clips[:smoke.CLIPS_PER_CALL]
        _profile(f"retrieval add_videos x{smoke.CLIPS_PER_CALL} clips, {path}",
                 lambda: index._embed_video(torch.as_tensor(batch).cuda()), iters, card)
        if not path.startswith("opt-in"):  # the opt-in paths change no text path
            _profile(f"retrieval query, {path}", lambda: index.query(smoke.TEXTS[0]), iters,
                     card)
    del model, index

    qa_model = smoke._build_model(build_qa_model, "timesformer_divst_8x32_224_k600_gc.json",
                                  smoke.QA_FRAMES, num_labels=1500, cls_hidden_scale=2)
    paths = {"kernels": (qa_model.visual_encoder.model.cfg, qa_model.text_encoder.bert.cfg),
             "plain": smoke._plain_cfgs(qa_model)}
    qa = VideoQAPredictor(qa_model, tok, {f"ans{i}": i for i in range(1500)}, "cuda",
                          max_txt_len=smoke.QA_TXT_LEN)
    qa_clips = rng.randint(0, 256, (smoke.QA_CLIPS, smoke.QA_FRAMES, 224, 224, 3),
                           dtype=np.uint8)
    for path, cfgs in paths.items():
        smoke._set_path(qa_model, *cfgs)
        feats = qa.encode_video(qa_clips)
        _profile(f"qa encode_video x{smoke.QA_CLIPS} clips T={smoke.QA_FRAMES}, {path}",
                 lambda: qa.encode_video(qa_clips), iters, card)
        _profile(f"qa predict (cached), {path}",
                 lambda: qa.predict(feats, smoke.QUESTIONS[0]), iters, card)
        _profile(f"qa predict_batch x{len(smoke.QUESTIONS)} (cached), {path}",
                 lambda: qa.predict_batch(feats, smoke.QUESTIONS), iters, card)
    del qa_model, qa


def _profile_kernels(iters: int, card: str) -> None:
    from alpro_tpu_torch.ops import block_attn
    from alpro_tpu_torch.ops.layers import LayerNorm

    rows = smoke.CLIPS_PER_CALL * smoke.FRAMES * (1 + smoke.PATCHES)
    x = torch.randn((rows, 768), device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        for impl in ("pallas", "plain"):
            ln = LayerNorm(768, 1e-6, impl=impl).cuda()
            # 10x the calls: one launch is ~10 µs, too short for the profiler to
            # catch every launch of a 5-call window
            _profile(f"LayerNorm(impl='{impl}') ({rows}, 768) bf16", lambda: ln(x, torch.bfloat16),
                     10 * iters, card)
    g = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    M, S, D, H = smoke.CLIPS_PER_CALL * smoke.FRAMES, 1 + smoke.PATCHES, 768, 12

    def randn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(dtype)

    xs = randn(M, S, D)
    w = (randn(3 * D, D, std=D ** -0.5), randn(3 * D, std=0.02, dtype=torch.float32),
         randn(D, D, std=D ** -0.5), randn(D, std=0.02, dtype=torch.float32))
    mask = (torch.arange(S, device="cuda")[None] < torch.randint(
        1, S + 1, (M, 1), generator=g, device="cuda")).float()
    with torch.no_grad():
        for what, key_mask in (("", None), (", masked", mask)):
            _profile(f"fused_attention_block ({M}, {S}, {D}) bf16{what}",
                     lambda: block_attn.fused_attention_block(xs, *w, H, key_mask),
                     10 * iters, card)
    _profile_mlp(iters, card, randn)
    _profile_bert_attn(iters, card, randn)
    _profile_spatial(iters, card, randn)
    _profile_ingest(iters, card, randn)
    _attention_device_times(card, randn)


def _profile_mlp(iters: int, card: str, randn) -> None:
    """K3 and K5 at their main and small shapes: the profile (50 calls) and
    the device time per call by CUDA-graph replay."""
    from alpro_tpu_torch.ops import bert_block, ln_mlp

    D, Dh = 768, 3072
    w = (randn(Dh, D, std=D ** -0.5), randn(Dh, std=0.02),
         randn(D, Dh, std=Dh ** -0.5), randn(D, std=0.02))
    ln = (1 + randn(D, std=0.1, dtype=torch.float32), randn(D, std=0.1, dtype=torch.float32))
    patches = smoke.CLIPS_PER_CALL * smoke.FRAMES * smoke.PATCHES
    fusion = 8 * (40 + 1 + smoke.PATCHES)
    calls = [(f"ln_mlp (K3) ({R}, {D}) bf16", R,
              lambda x: ln_mlp.ln_mlp(x, *ln, *w, eps=1e-6)) for R in (patches, 8, 2)]
    calls += [(f"bert_mlp_block (K5) ({R}, {D}) bf16", R,
               lambda x: bert_block.bert_mlp_block(x, *w, *ln, eps=1e-12))
              for R in (fusion, 40, 320)]
    with torch.no_grad():
        for label, R, fn in calls:
            x = randn(R, D, std=2.0)
            dev, why = smoke.graph_ms(lambda: fn(x))
            _profile(f"{label}, device per call (graph) "
                     + (f"not measured ({why})" if why else f"{dev:.4f} ms"),
                     lambda: fn(x), 10 * iters, card)


def _profile_bert_attn(iters: int, card: str, randn) -> None:
    """K4 at the fusion shapes (8 and 16 sequences of 40 + 197) and the text
    shapes (1 and 8 sequences of 40), chip_smoke's padded text mask, every
    vector bf16: the profile (50 calls) and the device time per call by
    CUDA-graph replay."""
    from alpro_tpu_torch.ops import bert_block

    D, H = 768, 12
    w = [t for _ in range(4) for t in (randn(D, D, std=D ** -0.5), randn(D, std=0.02))]
    ln = (1 + randn(D, std=0.1), randn(D, std=0.1))
    with torch.no_grad():
        for M, S in ((8, 40 + 1 + smoke.PATCHES), (16, 40 + 1 + smoke.PATCHES), (1, 40),
                     (8, 40)):
            x, mask = randn(M, S, D), smoke._text_mask(M, S)

            def fn():
                return bert_block.bert_attention_block(x, mask, *w, *ln, H, eps=1e-12)

            dev, why = smoke.graph_ms(fn)
            _profile(f"bert_attention_block (K4) ({M}, {S}, {D}) bf16, device per call (graph) "
                     + (f"not measured ({why})" if why else f"{dev:.4f} ms"), fn, 10 * iters, card)


def _profile_spatial(iters: int, card: str, randn) -> None:
    """B9 and B7 at one add_videos call's spatial shape and QA's, every
    vector bf16: the profile (50 calls) and the device time per call by
    CUDA-graph replay."""
    from alpro_tpu_torch.ops import fused_block, qkv_attn

    D, H, S = 768, 12, 1 + smoke.PATCHES
    ln = (1 + randn(D, std=0.1), randn(D, std=0.1))
    wqkv, bqkv = randn(3 * D, D, std=D ** -0.5), randn(3 * D, std=0.02)
    wo, bo = randn(D, D, std=D ** -0.5), randn(D, std=0.02)
    with torch.no_grad():
        for M in (smoke.CLIPS_PER_CALL * smoke.FRAMES, 2 * smoke.QA_FRAMES):
            x, qkv = randn(M, S, D), randn(M, S, 3 * D)
            calls = [(f"fused_spatial_block (B9) ({M}, {S}, {D}) bf16{tag}",
                      lambda r=residual: fused_block.fused_spatial_block(
                          x, *ln, wqkv, bqkv, wo, bo, H, eps=1e-6, residual=r))
                     for residual, tag in ((False, ""), (True, ", residual"))]
            calls.append((f"spatial_attention_qkv_proj (B7) ({M}, {S}, {3 * D}) bf16",
                           lambda: qkv_attn.spatial_attention_qkv_proj(qkv, wo, bo, H)))
            for label, fn in calls:
                dev, why = smoke.graph_ms(fn)
                _profile(f"{label}, device per call (graph) "
                         + (f"not measured ({why})" if why else f"{dev:.4f} ms"), fn, 10 * iters,
                         card)


def _profile_ingest(iters: int, card: str, randn) -> None:
    """B11 ``ln_matmul`` at one add_videos call's spatial rows (64 · 197)
    and QA's (32 · 197) → 3D, B10 ``fused_temporal_block`` and B8
    ``temporal_attention_qkv_proj`` at one add_videos call's temporal shape
    (8, 8, 196) and QA's (2, 16, 196), and B15 ``patchify_embed`` at their
    frames ((8, 8) and (2, 16) clips of 224²) → D, every vector bf16: the
    profile (50 calls) and the device time per call by CUDA-graph replay."""
    from alpro_tpu_torch.models.timesformer import TimeSformerConfig
    from alpro_tpu_torch.ops import fused_block, ln_matmul, preprocess, qkv_attn

    D, H, S, N = 768, 12, 1 + smoke.PATCHES, smoke.PATCHES
    ln = (1 + randn(D, std=0.1), randn(D, std=0.1))
    wqkv, bqkv = randn(3 * D, D, std=D ** -0.5), randn(3 * D, std=0.02)
    wo, bo = randn(D, D, std=D ** -0.5), randn(D, std=0.02)
    calls = []
    for M in (smoke.CLIPS_PER_CALL * smoke.FRAMES, 2 * smoke.QA_FRAMES):
        x = randn(M * S, D, std=2.0)
        calls.append((f"ln_matmul (B11) ({M * S}, {D}) -> {3 * D} bf16",
                      lambda x=x: ln_matmul.ln_matmul(x, *ln, wqkv, bqkv, eps=1e-6)))
    for B, T in ((smoke.CLIPS_PER_CALL, smoke.FRAMES), (2, smoke.QA_FRAMES)):
        x = randn(B, T, N, D)
        calls.append((f"fused_temporal_block (B10) ({B}, {T}, {N}, {D}) bf16",
                      lambda x=x: fused_block.fused_temporal_block(x, *ln, wqkv, bqkv, wo, bo, H,
                                                                   eps=1e-6)))
    for B, T in ((smoke.CLIPS_PER_CALL, smoke.FRAMES), (2, smoke.QA_FRAMES)):
        qkv = randn(B, T, N, 3 * D)
        calls.append((f"temporal_attention_qkv_proj (B8) ({B}, {T}, {N}, {3 * D}) bf16",
                      lambda qkv=qkv: qkv_attn.temporal_attention_qkv_proj(qkv, wo, bo, H)))
    mean, std = TimeSformerConfig.pixel_mean, TimeSformerConfig.pixel_std
    g = torch.Generator(device="cuda").manual_seed(smoke.SEED + 4)
    kern, kb = randn(768, D, std=768 ** -0.5), randn(D, std=0.02)
    for B, T in ((smoke.CLIPS_PER_CALL, smoke.FRAMES), (2, smoke.QA_FRAMES)):
        raw = torch.randint(0, 256, (B, T, 224, 224, 3), generator=g, device="cuda",
                            dtype=torch.uint8)
        calls.append((f"patchify_embed (B15) ({B}, {T}, 224, 224, 3) -> {D} bf16",
                      lambda raw=raw: preprocess.patchify_embed(raw, kern, kb, mean, std)))
    with torch.no_grad():
        for label, fn in calls:
            dev, why = smoke.graph_ms(fn)
            _profile(f"{label}, device per call (graph) "
                     + (f"not measured ({why})" if why else f"{dev:.4f} ms"), fn, 10 * iters,
                     card)


def _attention_device_times(card: str, randn) -> None:
    """The device time per call (CUDA-graph replay) of K2, K1, B6 and the
    masked attention B13/B12 at their main shapes, bf16: the kernels that
    share an attention body with B10, B9 and B7; K2 also at QA's (2, 16,
    196) and at one clip of T = 32 (``configs/msrvtt_ret_longT.json``). K2's
    output is also printed as a hash, so two trees' runs show whether it is
    bit-equal."""
    from alpro_tpu_torch.ops import masked_attn, qkv_attn

    H, hd, T = 12, 64, smoke.FRAMES
    M, N, D = smoke.CLIPS_PER_CALL * T, smoke.PATCHES, 12 * 64
    x, qx, qc = randn(M, 1 + N, 3 * D), randn(M, N, 3 * D), randn(M // T, 1, 3 * D)
    q, k, v = x[..., :D], x[..., D:2 * D], x[..., 2 * D:]
    heads = [t.unflatten(-1, (H, hd)).transpose(1, 2).contiguous() for t in (q, k, v)]
    mask = (torch.arange(1 + N, device="cuda")[None] < 150 + torch.arange(M, device="cuda")[:, None]
            % 48).float()
    xt = randn(smoke.CLIPS_PER_CALL, T, N, 3 * D)
    with torch.no_grad():
        k2 = qkv_attn.temporal_attention_qkv(xt, H)
    digest = hashlib.sha256(k2.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]
    print(f"[profile] K2 temporal_attention_qkv {tuple(xt.shape)} bf16 output sha256 {digest}"
          f" (seeded input: equal across two trees means bit-equal outputs) [{card}]",
          flush=True)
    x16, x32 = randn(2, smoke.QA_FRAMES, N, 3 * D), randn(1, 32, N, 3 * D)
    calls = {f"K2 temporal_attention_qkv {tuple(xt.shape)}": lambda:
                 qkv_attn.temporal_attention_qkv(xt, H),
             f"K2 {tuple(x16.shape)}": lambda: qkv_attn.temporal_attention_qkv(x16, H),
             f"K2 {tuple(x32.shape)}": lambda: qkv_attn.temporal_attention_qkv(x32, H),
             f"K1 spatial_attention_qkv ({M}, {1 + N})": lambda: qkv_attn.spatial_attention_qkv(
                 x, H),
             f"B6 spatial_attention_qkv_cls ({M}, {N}) + CLS": lambda:
                 qkv_attn.spatial_attention_qkv_cls(qx, qc, H, T),
             f"B13 fused_attention_bshd ({M}, {1 + N}) masked": lambda:
                 masked_attn.fused_attention_bshd(q, k, v, H, key_mask=mask),
             f"B12 fused_attention ({M}, {H}, {1 + N}, {hd}) masked": lambda:
                 masked_attn.fused_attention(*heads, key_mask=mask)}
    parts = []
    with torch.no_grad():
        for label, fn in calls.items():
            dev, why = smoke.graph_ms(fn)
            parts.append(f"{label} " + (f"not measured ({why})" if why else f"{dev:.4f} ms"))
    print(f"[profile] attention device per call (graph), bf16: {'; '.join(parts)} [{card}]",
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
