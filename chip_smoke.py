#!/usr/bin/env python3
"""Smoke run of alpro_tpu_torch on one CUDA card: kernels, then the
retrieval serving path at full ALPRO-base width.

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero before the result
line):

1. device — needs ``torch.cuda.is_available()``; prints the card's name and
   power limit (``nvidia-smi``); TF32 off for matmuls and cuDNN;
2. build — compiles ``alpro_tpu_torch/csrc/*.cu`` with nvcc for sm_90a;
3. kernels — each CUDA kernel against its plain PyTorch twin on the same
   bf16 inputs at the shapes of the main path, with the tolerance stated
   beside it, and the median time of both;
4. slice — TimeSformer-B/16 (224², T=8, depth 12) + BERT-base
   (``configs/base_model.json``) with seeded random bf16 weights and a
   hashing stand-in tokenizer: a ``RetrievalIndex`` embeds 16 clips in two
   ``add_videos`` calls, then answers 4 texts by ``query`` and by
   ``query_batch``. The kernel launch counts of that run must be 12
   (attention) and 24 (MLP tail) per embed call. The same index on the
   plain path (every ``*_impl='plain'``) is the reference for features and
   P(match), and must launch no kernel.

Then one JSON line with the kernels, the ``nvidia-smi`` line, and last the
result line ``{"ok": true, "device": {...}}``. There is no CPU path.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
SEED = 0
N_CLIPS, CLIPS_PER_CALL = 16, 8
FRAMES, PATCHES = 8, 196  # TimeSformer-B/16 at 8 x 224²
TEXTS = ["a dog catches a frisbee", "the cat jumps", "a person is playing",
         "a man is cooking"]
CHECK_TOPK = 8  # half the gallery, so the candidate set is a real choice

# kernel vs twin, elementwise |kernel - twin| <= atol + rtol·|twin|, bf16:
# the outputs are bf16 (one ulp is 2^-8 relative); the spatial kernel also
# rounds p to bf16 before PV where its twin keeps fp32
KERNEL_TOL = {"spatial_attn": 3e-2, "temporal_attn": 1e-2, "ln_mlp": 2e-2}
# query vs query_batch: the same bf16 towers at batch 1 and 4
QUERY_PROB_TOL = 1e-2
# kernel path vs plain path, 12 bf16 blocks apart: VTC features (unit norm,
# entries ~0.06) and P(match)
PLAIN_FEAT_TOL = 2e-2
PLAIN_PROB_TOL = 3e-2


def fail_if(cond: bool, msg: str) -> None:
    if cond:
        raise RuntimeError(msg)


def median_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back
    calls, by CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"allow_tf32 matmul=False cudnn=False", flush=True)
    return smi


def phase_build() -> None:
    from alpro_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    print(f"[build] nvcc -> {path.relative_to(REPO)} in {time.perf_counter() - t0:.2f} s",
          flush=True)


def _compare(name, shape, kernel, twin, card, main: bool = False) -> dict:
    """Kernel vs twin on the same inputs; ``main`` marks the shape one
    ``add_videos`` call of the slice gives the kernel (the JSON line reports
    that one)."""
    got, want = kernel(), twin()
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    tol = KERNEL_TOL[name]
    max_abs = float(diff.max())
    max_rel = max_abs / max(float(want.float().abs().max()), 1e-30)
    bad = int((diff > tol + tol * want.float().abs()).sum())
    ms, plain_ms = median_ms(kernel), median_ms(twin)
    print(f"[kernel] {name} {shape}: max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
          f"(tol atol=rtol={tol}, {bad} outside); kernel {ms:.4f} ms, twin {plain_ms:.4f} ms "
          f"[{card}]", flush=True)
    fail_if(not bool(torch.isfinite(got).all()), f"{name} {shape}: non-finite output")
    fail_if(bad > 0, f"{name} {shape}: {bad} elements outside tolerance {tol}")
    return {"shape": list(shape), "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "main": main}


def phase_kernels(card: str) -> dict:
    """Each kernel at B=2 clips (T=16 too for the temporal kernel, the QA
    frame count; R=B cls rows without the residual for the MLP tail) and at
    the shapes of one add_videos call of CLIPS_PER_CALL clips."""
    from alpro_tpu_torch.ops import ln_mlp, qkv_attn

    g = torch.Generator(device="cuda").manual_seed(SEED)
    bf = torch.bfloat16

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(bf)

    H, hd, T, N, B = 12, 64, FRAMES, PATCHES, CLIPS_PER_CALL
    res = {"spatial_attn": [], "temporal_attn": [], "ln_mlp": []}
    for M, main in ((2 * T, False), (B * T, True)):
        x = randn(M, 1 + N, 3 * H * hd)
        res["spatial_attn"].append(_compare(
            "spatial_attn", x.shape, lambda: qkv_attn.spatial_attention_qkv(x, H),
            lambda: qkv_attn.spatial_attention_plain(x, H, hd ** -0.5), card, main))
    for b, t, main in ((2, T, False), (2, 16, False), (B, T, True)):
        xt = randn(b, t, N, 3 * H * hd)
        res["temporal_attn"].append(_compare(
            "temporal_attn", xt.shape, lambda: qkv_attn.temporal_attention_qkv(xt, H),
            lambda: qkv_attn.temporal_attention_plain(xt, H, hd ** -0.5), card, main))
    D, Dh = 768, 3072
    w = (randn(Dh, D, std=D ** -0.5), randn(Dh, std=0.02),
         randn(D, Dh, std=Dh ** -0.5), randn(D, std=0.02))
    ln = (1 + randn(D, std=0.1).float(), randn(D, std=0.1).float())
    for R, residual, main in ((2 * T * N, True, False), (2, False, False),
                              (B * T * N, True, True), (B, True, False)):
        xr = randn(R, D, std=2.0)
        res["ln_mlp"].append(_compare(
            "ln_mlp", (R, D),
            lambda: ln_mlp.ln_mlp(xr, *ln, w[0], w[1], w[2], w[3], eps=1e-6,
                                  residual=residual),
            lambda: ln_mlp.ln_mlp_plain(xr, *ln, w[0], w[1], w[2], w[3], 1e-6, residual),
            card, main))
    return res


class HashTokenizer:
    """Stand-in for the WordPiece tokenizer with the tokenizer's call
    signature: lower-cased words hashed (crc32) into the BERT vocab, with
    [CLS] 101, [SEP] 102, [PAD] 0. The weights are random, so any fixed map
    from text to ids serves, and this script stays free of the JAX
    package."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def __call__(self, texts, max_length: int = 40):
        ids = np.zeros((len(texts), max_length), np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for i, text in enumerate(texts):
            words = [1000 + zlib.crc32(w.encode()) % (self.vocab_size - 1000)
                     for w in text.lower().split()][: max_length - 2]
            row = [101, *words, 102]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def _build_model():
    from alpro_tpu_torch.models.alpro import build_retrieval_model, init_random_

    bert_cfg = json.loads((REPO / "configs" / "base_model.json").read_text())
    vis_cfg = json.loads((REPO / "configs" / "timesformer_divst_8x32_224_k600.json").read_text())
    with torch.device("meta"):
        model = build_retrieval_model(bert_cfg, vis_cfg, img_size=224, num_frm=FRAMES,
                                      dtype=torch.bfloat16)
    model = model.to_empty(device="cuda")
    init_random_(model, torch.Generator(device="cuda").manual_seed(SEED))
    return model.to(torch.bfloat16).eval()


def _counts():
    from alpro_tpu_torch.ops import ln_mlp, qkv_attn

    return {"spatial_attn": qkv_attn.spatial_launches,
            "temporal_attn": qkv_attn.temporal_launches, "ln_mlp": ln_mlp.launches}


def _reset_counts():
    from alpro_tpu_torch.ops import ln_mlp, qkv_attn

    qkv_attn.spatial_launches = qkv_attn.temporal_launches = ln_mlp.launches = 0


def _warm(model, cfg, tok, clips) -> None:
    """Select ``cfg``'s path and run ``add_videos`` twice on a throwaway
    index at the timed batch size (lazy CUDA module loads, cuBLAS heuristics,
    allocator pools), right before timing that path."""
    from alpro_tpu_torch.serving.retrieval import RetrievalIndex

    model.visual_encoder.model.cfg = cfg
    scratch = RetrievalIndex(model, tok, "cuda")
    for _ in range(2):
        scratch.add_videos(clips[:CLIPS_PER_CALL], [""] * CLIPS_PER_CALL)
    torch.cuda.synchronize()


def _fill(index, clips, ids) -> float:
    """add_videos in calls of CLIPS_PER_CALL; returns clips/s."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, len(ids), CLIPS_PER_CALL):
        index.add_videos(clips[lo:lo + CLIPS_PER_CALL], ids[lo:lo + CLIPS_PER_CALL])
    torch.cuda.synchronize()
    return len(ids) / (time.perf_counter() - t0)


def _check_query_vs_batch(single, batched, text) -> None:
    fail_if({r[0] for r in single} != {r[0] for r in batched},
            f"{text!r}: query and query_batch chose different candidates")
    ps, pb = dict((r[0], r[1]) for r in single), dict((r[0], r[1]) for r in batched)
    gap = max(abs(ps[v] - pb[v]) for v in ps)
    fail_if(gap > QUERY_PROB_TOL, f"{text!r}: P(match) differs by {gap:.3e}")
    for a, b in zip(single, single[1:]):  # order must agree where P is apart
        if a[1] - b[1] > QUERY_PROB_TOL:
            fail_if(pb[a[0]] < pb[b[0]], f"{text!r}: query_batch reorders {a[0]}, {b[0]}")


def phase_slice(card: str) -> dict:
    from alpro_tpu_torch.serving.retrieval import RetrievalIndex

    model = _build_model()
    vis = model.visual_encoder.model
    kernel_cfg = vis.cfg
    tok = HashTokenizer(model.cfg.bert.vocab_size)
    clips = np.random.RandomState(SEED).randint(
        0, 256, (N_CLIPS, FRAMES, 224, 224, 3), dtype=np.uint8)
    ids = [f"vid{i:02d}" for i in range(N_CLIPS)]
    plain_cfg = dataclasses.replace(kernel_cfg, attn_impl="plain",
                                    temporal_attn_impl="plain", mlp_impl="plain")

    # ---- the main path, kernels on ('auto' on a CUDA tensor) ----
    _warm(model, kernel_cfg, tok, clips)
    index = RetrievalIndex(model, tok, "cuda", max_txt_len=40, topk=16)
    _reset_counts()
    clips_per_s = _fill(index, clips, ids)
    single = [index.query(t, topk=CHECK_TOPK) for t in TEXTS]
    batched = index.query_batch(TEXTS, topk=CHECK_TOPK)
    query_ms = []
    for _ in range(5):
        for t in TEXTS:
            t0 = time.perf_counter()
            index.query(t)
            query_ms.append((time.perf_counter() - t0) * 1e3)
    launches = _counts()
    calls = -(-N_CLIPS // CLIPS_PER_CALL)
    want = {"spatial_attn": 12 * calls, "temporal_attn": 12 * calls, "ln_mlp": 24 * calls}
    print(f"[slice] kernel launches {launches} (expected {want})", flush=True)
    fail_if(launches != want, f"launch counts {launches} != {want}")

    feats, tokens = index._banks()
    fail_if(tuple(feats.shape) != (N_CLIPS, 256) or tuple(tokens.shape) != (N_CLIPS, 1 + PATCHES, 768),
            f"bank shapes {tuple(feats.shape)}, {tuple(tokens.shape)}")
    fail_if(not (torch.isfinite(feats).all() and torch.isfinite(tokens.float()).all()),
            "non-finite gallery bank")
    for t, s, b in zip(TEXTS, single, batched):
        fail_if(len(s) != CHECK_TOPK, f"{t!r}: {len(s)} results")
        fail_if(not all(np.isfinite(r[1]) and np.isfinite(r[2]) for r in s + b),
                f"{t!r}: non-finite scores")
        _check_query_vs_batch(s, b, t)

    # ---- the same index on the plain path: the reference ----
    full = [index.query(t, topk=N_CLIPS) for t in TEXTS]
    before = _counts()
    _warm(model, plain_cfg, tok, clips)
    plain = RetrievalIndex(model, tok, "cuda", max_txt_len=40, topk=16)
    plain_clips_per_s = _fill(plain, clips, ids)
    plain_full = [plain.query(t, topk=N_CLIPS) for t in TEXTS]
    fail_if(_counts() != before, f"plain path launched kernels: {before} -> {_counts()}")
    vis.cfg = kernel_cfg
    pfeats, ptokens = plain._banks()
    feat_err = float((feats - pfeats).abs().max())
    tok_err = float((tokens.float() - ptokens.float()).abs().max())
    prob_err = max(abs(dict((r[0], r[1]) for r in a)[v] - p)
                   for a, b in zip(full, plain_full) for v, p, _ in b)
    print(f"[slice] kernel vs plain path: VTC feature max_abs {feat_err:.3e} (tol "
          f"{PLAIN_FEAT_TOL}), token bank max_abs {tok_err:.3e}, P(match) max_abs "
          f"{prob_err:.3e} (tol {PLAIN_PROB_TOL})", flush=True)
    fail_if(feat_err > PLAIN_FEAT_TOL, f"VTC features differ from the plain path by {feat_err}")
    fail_if(prob_err > PLAIN_PROB_TOL, f"P(match) differs from the plain path by {prob_err}")

    p50 = statistics.median(query_ms)
    print(f"[slice] add_videos {clips_per_s:.2f} clips/s with kernels, "
          f"{plain_clips_per_s:.2f} clips/s plain ({N_CLIPS} clips, {CLIPS_PER_CALL} per call); "
          f"query p50 {p50:.2f} ms over {len(query_ms)} (topk 16, gallery {N_CLIPS}) "
          f"[{card}]", flush=True)
    return launches


def main() -> int:
    card = phase_device()
    phase_build()
    res = phase_kernels(card)
    launches = phase_slice(card)
    sources = {
        "spatial_attn": ("alpro_tpu_torch/csrc/spatial_attn.cu",
                         "alpro_tpu/ops/pallas_qkv_attn.py:99"),
        "temporal_attn": ("alpro_tpu_torch/csrc/temporal_attn.cu",
                          "alpro_tpu/ops/pallas_qkv_attn.py:545"),
        "ln_mlp": ("alpro_tpu_torch/csrc/ln_mlp.cu", "alpro_tpu/ops/pallas_ln_mlp.py:85"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        main_shape = next(r for r in res[name] if r["main"])
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in res[name]),
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "shape": main_shape["shape"],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
