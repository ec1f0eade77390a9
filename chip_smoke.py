#!/usr/bin/env python3
"""Smoke run of alpro_tpu_torch on one CUDA card: kernels, then the
retrieval and the video QA serving paths, their finetuning steps, the video
tower's opt-in serving forms, ``LayerNorm(impl='pallas')``, the retrieval
and QA eval protocols of the inference CLIs, finetuning through the same
CLIs, pretraining and the prompter through theirs, and int8 serving, the
joint and space-only towers and the remat policies, at full ALPRO-base
width.

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero before the result
line):

1. device — needs ``torch.cuda.is_available()``; prints the card's name and
   power limit (``nvidia-smi``); TF32 off for matmuls and cuDNN;
2. build — compiles ``alpro_tpu_torch/csrc/*.cu`` with nvcc for sm_90a;
3. kernels — each CUDA kernel against its plain PyTorch twin on the same
   bf16 inputs at the shapes of the main paths, with the tolerance stated
   beside it (the masked attention's and the LayerNorm's gradients too); the
   median time of both per wrapper call, of one PyTorch library call that
   computes the same function where there is one, and the least time the
   card could take at the main shape (``bound_ms``); at the main shape also
   the device time of the kernel and of the library call (``device_ms``: 20
   calls captured in one CUDA graph, replays timed, so the host's share of
   a call drops out; a wrapper that cannot be captured says why), for the
   MLP kernels K3/K5 at their small shapes too and for the BERT attention
   chain K4 at all five of its shapes (the eval protocol's fusion call of 8
   videos × 64 texts, (512, 237), the largest; K5 there too), and beside
   them at the main shape a
   yardstick: ``F.linear`` at fc1's and fc2's shapes; for K4, ``F.linear``
   at the q/k/v and output projections' shapes, SDPA with the key mask on
   the same q/k/v views and ``F.layer_norm``; K4 also against the TPU
   kernel's own rounding points (``bert_attention_block_reference``) with
   scores in the tens (q/k/v/o weights at std 4·D^-½), at the fusion and
   the one-text shapes; B9 and B7 with their device time at the retrieval
   and QA shapes (64 and 32 frames of 197 tokens) beside a yardstick of the
   PyTorch calls that compute the same chain (``F.layer_norm``,
   ``F.linear``, SDPA on the q/k/v views, ``F.linear``), and at one clip of
   384² frames (S = 577); B8 with its device time and its split by launch
   (K2's body, the GEMM) at the retrieval and QA temporal shapes, and at T
   = 32 and 48 (K2's wide path); B15 with its device time, its split by
   launch (the patch rows pass, the GEMM) and its one-ulp contract at both
   video shapes, beside the normalize + ``F.conv2d`` and ``F.linear`` on
   its bf16 patch rows; the exact GELU of the training path (``ops/gelu.py``,
   not a TPU kernel) forward and backward at the QA finetuning's fc1 output
   (75264, 3072): the forward bit-equal to its twin, the backward within one
   bf16 ulp of autograd through the twin, beside the twin's times (its
   forward's seven launches, autograd's backward) and the byte bound;
4. retrieval — TimeSformer-B/16 (224², T=8, depth 12) + BERT-base
   (``configs/base_model.json``) with seeded random bf16 weights and a
   hashing stand-in tokenizer: a ``RetrievalIndex`` embeds 16 clips in two
   ``add_videos`` calls, then answers 4 texts by ``query`` and by
   ``query_batch``. The kernel launch counts of that run must be 12
   (spatial), 12 (temporal) and 24 (MLP tail) per embed call and 12 of each
   BERT kernel per query call. The same index on the plain path (every
   ``*_impl='plain'``) is the reference for features and P(match), and must
   launch no kernel. Query p50 is read with and without the BERT kernels;
5. QA — the ALPRO-base MSRVTT-QA model (``configs/msrvtt_qa.json``: T=16,
   1500 labels, synthetic answers ``ans{i}``) behind a ``VideoQAPredictor``:
   ``encode_video`` on 2 clips, ``predict`` on the cached tokens for 4
   questions and once from pixels, ``predict_batch`` on the 4 questions,
   each with its exact launch counts; cached agrees with pixels, ``predict``
   with ``predict_batch``, and the kernel path with the plain path;
6. finetuning — retrieval (``configs/msrvtt_ret.json``: B = 8 per card, its
   AdamW and schedule; fp32 parameters, bf16 compute, dropout and drop-path
   on) under ``--attn_impl pallas`` in turns with ``xla``: 24 masked-attention
   launches per pallas step and no serving kernel, finite losses, every
   parameter changed, temp clamped; then pallas vs xla loss, whole gradient
   and each parameter's gradient with dropout off; then two MSRVTT-QA steps (T=16, B=4) with
   their launch counts. Every step also launches the exact GELU's kernels
   (``ops/gelu.py``) by the model's depth: forward 2 a video block (the CLS
   rows and the patches; again in the recompute of the checkpointed QA
   tower) and 1 a BERT layer, backward 2 a block and 1 a layer. Step ms,
   train clips/s and peak device memory for both paths;
7. opt-in video paths — phase 4's model and clips under the video tower's
   opt-in serving forms (``OPT_IN_PATHS``): path (a) (raw-frame patch embed,
   whole spatial and temporal attention chains), path (b) (LN→qkv in front
   of the spatial and temporal kernels), path (c) (the CLS-sideband spatial
   attention) and path (d) (attention + projection in one kernel on both
   axes): two ``add_videos`` calls each with their exact launch counts, VTC
   features and P(match) against phase 4's plain path, clips/s beside phase
   4's; then phase 5's QA ``encode_video`` under paths (a) and (d), their
   counts, and the answers from their tokens against phase 5's plain path;
8. LayerNorm — ``LayerNorm(impl='pallas')``, the LayerNorm kernel's only
   entry (no model config sets it, as in JAX), forward and backward over the
   rows of one ``add_videos`` call's spatial input, with its launch count,
   against autograd through the twin;
9. the last two TPU kernels and ``auto``'s limits — ``temporal_attention_roll``
   (B16) and ``fused_attention_block`` (B17), which no model path reaches
   (as in JAX), each forward and backward once through its public entry at
   the shapes of one ``add_videos`` call (the temporal attention and the
   spatial attention sublayer) with the counts set to 0 just before and read
   just after; each against its twin at those and other shapes (B16 over
   its envelope: T = 48, head_dim 16 and 40, fp32; B17 with a key mask, at
   the QA shape, at 577 keys masked (streamed through its slot ring), fp32),
   gradients against autograd through the twins, B17
   against the port's ``Attention`` module on the same weights, B17 against
   the TPU kernel's contract (q and k unrounded) at the main shape, masked
   and with scores in the tens (where the twin, rounding q and k, must miss
   it), and B17's GEMM alone at its qkv and projection shapes; phase 4's
   video tower under ``temporal_attn_impl='packed'`` and ``'circulant'``
   against phase 4's plain path; the spatial kernels at 256² frames (S =
   257, past one key chunk: ``auto`` launches K1 and ``cls_sideband`` B6,
   each within TOWER_TOL of the forward with ``attn_impl='plain'``); then
   eval forwards under ``auto`` one past a kernel's limit (T = 129 frames,
   BERT S = 20 481 in bf16, head_dim 48 for K1, which has no S limit, and D =
   384 for the MLP tail, at narrow widths): each equals the forward with
   that call site set to ``plain`` and launches none of the kernel
   concerned, while the same model at the limit launches it;
10. eval protocols — the inference CLIs' ``start_inference`` on the card
   (``device='cuda'``): phase 4's and phase 5's bf16 weights saved as
   ALPRO-key ``.pt`` files (``inference_model_ckpt`` must load them back bit
   for bit), a synthetic retrieval set (32 ``.npy`` clips of 12 frames at
   240 × 320, resized to 256 and center-cropped to 224, each with a planted
   feature of its own so that the towers tell them apart; 64 captions) and
   QA set (8 planted clips of 16 × 2 frames, 16 questions over ``ans{i}``),
   a ``make_test_vocab`` vocab; retrieval (``configs/msrvtt_ret.json``) at K
   = 0 (8 videos × 64 texts = 512 pairs a fusion call), ``eval_rerank_topk``
   8 (512 pairs a rerank call) and ``eval_vtc_only``, QA
   (``configs/msrvtt_qa.json``) at ``inference_n_clips`` 2; each once on
   ``auto`` and once with the CLI's model on phase 4's plain path, with
   exact launch counts (per video batch 12 K1, 12 K2, 24 K3; per text chunk
   or fusion call 6 K4 and 6 K5; none on the plain runs); the kernel run
   held to the plain run at fixed tolerances (sims, P(match), top-K
   memberships, pooled answers; ranks within the bounds their near ties
   allow, R@k equal on the rows those bounds decide, and a least share of
   rows, video pairs, memberships and answers decided, so that a text
   scored against the wrong video fails); K4/K5's limits at the fusion
   call's (512, 237), and finite output on all-zero padded text rows;
   seconds per protocol, pairs/s of the fusion half, texts/s and the share
   of the protocol outside the towers;
11. finetuning through the CLIs — ``main(["--config", file])`` of both task
   CLIs on the card (``--do_inference 0``): retrieval on
   ``configs/msrvtt_ret.json`` (dropout and drop-path 0, B = 8, one
   hard-negative block, lr 5e-5, 8 steps over 64 planted videos × 2
   captions, resume saves at steps 4 and 8, ``validate`` at 4, 8 and at the
   end on phase 10's set) under ``--attn_impl pallas`` and on the plain
   path (replaying the kernel run's hard negatives), with exact launch
   counts (24 B13 a step; per ``validate`` video call 12 B13, 12 K2, 24 K3,
   per text call 6 K4 and 6 K5), finite logged losses, each step's
   vtc_loss within CLI_VTC_TOL of the plain run's and ``validate`` held to
   the plain run by phase 10's rules; then step 8's resume slot removed and
   the run started again on its ``output_dir``: step 4's slot restored bit
   for bit on the card, steps 5-8 run, ``model_step_8.pt`` written, and
   ``--inference_model_step 8`` giving that run's final R@k; the loop with
   ``prefetch_depth`` 2 and 0 (``n_workers`` 4); a sync resume save against
   the async ones; MSRVTT-QA (T = 16, its checkpointed video tower, B = 4, 4
   steps, one ``validate``) with its counts. Train clips/s (median step of
   3-8), the loop's share outside the steps, peak memory, the saves'
   blocking seconds and size and each ``validate``'s seconds;
12. pretraining through the CLIs — ``main(["--config", file])`` of
   ``run_prompter`` (``configs/pretrain_prompter.json``) and
   ``run_pretrain`` (``configs/pretrain_alpro.json``) on the card at
   ALPRO-base width (4 frames of 224², ``max_txt_len`` 30, 1000 entities,
   fp32 parameters, bf16 compute, dropout and drop-path 0), B = 16, 8
   steps, lr 2e-4, one hard-negative block, on 64 planted clips and 64
   planted ``.npy`` images, ``validate`` at the end over 2 batches of phase
   10's set: the prompter under ``--attn_impl pallas`` and on the plain
   path (18 B13 a step), its ``model_step_8.pt`` the teacher; pretraining
   (video + image mixed, all four objectives) under pallas and on the plain
   path with exact counts (36 B13 a step in the student; the teacher's crop
   forward 12 B13, 12 K2, 24 K3; each bank 24 chunks of 512 prompts, 6 K4
   and 6 K5 a chunk; ``validate`` 24 B13, 24 K2, 48 K3, 24 K4, 24 K5 a
   batch), each step's itc_loss and mlm_loss, the banks and the
   pseudo-label argmax held to the plain run; step 8's resume slot removed
   and the CLI run again: step 4's slot restored bit for bit, the teacher and
   the banks rebuilt bit-equal; ``run_video_retrieval`` finetuning 2 steps
   from the pretraining ``model_step_8.pt``, loading its tensors bit for bit
   and skipping the MLM and MPM heads. Train clips/s, the teacher's share of
   a step, the banks' seconds, the loop's share outside the steps, the
   MetaLoader mix, the MPM rows ignored, peak memory and ``validate``'s
   seconds.

13. variants — (a) ``RetrievalIndex(weights='int8')`` against 'bf16' at
   ALPRO-base: the weights' bytes at rest (``memory_allocated`` around each
   build; int8 below 0.6 of bf16), each call's peak bytes, a gallery of 64
   planted clips, the top-8 ids (equal wherever the bf16 similarities
   decide them), VTC similarities and P(match) within ``tests/test_quant.py``'s
   0.05, exact launches per call, clips/s and query ms; int8 with its
   kernels against int8 on the plain path; ``VideoQAPredictor(weights=
   'int8')`` against 'bf16' on the MSRVTT-QA model, answers and launches;
   (b) the ``joint_space_time`` and ``space_only`` towers (TimeSformer-B/16,
   8 x 224², bf16) with K1 and K3 against their plain path, 12 K1 and 12 K3
   a forward, the three poolings' shapes, and K1 alone at the joint tower's
   (2, 1569, 2304) against its twin with its device time, bound and SDPA;
   (c) one QA finetuning step (``--attn_impl pallas``, dropout on, the
   checkpointed video tower at depth 2, BERT at 2 layers) under each of the
   nine ``remat_policy`` values against the step without checkpointing:
   loss and gradients, B13's launches (the names family keeps B13's output:
   no relaunch in the recompute), peak bytes;
14. distributed — phase 11's retrieval finetuning CLI cut to 4 steps and one
   validate, without a process group; then a NCCL process group of one
   process on ``tcp://127.0.0.1`` at a free port, under which (a) the
   wrapped retrieval step (``shard_step``, ALPRO-base, bf16, B 8,
   ``--attn_impl pallas``, dropout 0.1) against the unwrapped one from the
   same state and seed, 4 steps each in turns: metrics and every parameter
   bit-equal, 24 B13 launches a step on both, the step times and the flat
   gradient all-reduce alone; (b) ``ShardedRetrievalIndex`` against
   ``RetrievalIndex`` on phase 4's model and 16 clips, top-8: ids equal,
   scores bit-equal, K1-K5 launched alike, query p50 of each; (c) the same
   CLI with ``--mesh_shape 1``: step metrics, final validate and deploy
   checkpoint bit-equal to the run without a group; (d)
   ``sharded_temporal_attention`` at (8·196, 8, 768), 12 heads, fp32, against
   the unsplit attention; the group destroyed; (e) two gloo processes
   (``python3 chip_smoke.py --gloo-worker``), both on cuda:0, the wrapped
   step on B 4 each against one process on B 8 (fp32 compute, dropout 0),
   losses within 1e-5 — or gloo's refusal of CUDA tensors, printed.
15. sequence parallelism and the FFmpeg decoder — (a) two gloo processes
   (``python3 chip_smoke.py --sp-worker``), both on cuda:0, a (1, 2) mesh:
   the retrieval step (``shard_step``) at ALPRO-base width cut to
   GLOO_DEPTHS, T = 16 split 8 + 8 in every divided block (``sp_axis``
   'sp'), bf16 compute, ``--attn_impl pallas``, the config's dropout and
   drop-path, B 4, against one process's unsplit step from the same state,
   seed and batch: the losses within SP_LOSS_TOL, AdamW's first moment (0.1
   · the clipped gradient) within phase 6's pallas-vs-xla tolerances
   (relative L2 overall, per parameter, the temporal q/k/v weights), beside
   the unsplit step in fp32 as the yardstick of bf16's own error, the two
   processes' parameters bit-equal, B13 launched 6 times a step by each;
   then the same split step in fp32 compute with the video blocks
   checkpointed against the unsplit fp32 step: losses, the gradient norm
   before clipping and AdamW's first moment to the SP_FP32_* tolerances;
   (b) where ``pkg-config`` finds FFmpeg,
   a test video encoded by the port's media library and decoded through
   ``read_video`` (its FFmpeg backend), bit-equal to the same frames saved
   as ``.npy`` and read through ``read_video``; else a line saying so. The
   phase prints its seconds.

Then one JSON line with the kernels (the 17 TPU kernels' and the GELU's
two; ``launches`` from the main paths, the GELU's from phase 6's steps,
``eval_launches`` from phase 10's kernel runs, ``cli_train_launches`` from
phase 11's, ``pretrain_launches`` from phase 12's prompter, pretraining and
resumed pretraining runs, ``variant_launches`` from phase 13's counted
calls, ``dist_launches`` from phase 14's runs under the process group,
``sp_launches`` from phase 15's two processes' steps, summed), the
``nvidia-smi`` line, and last the result line ``{"ok": true,
"device": {...}}``. There is no CPU path.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import re
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
QA_FRAMES, QA_CLIPS, QA_TXT_LEN = 16, 2, 40  # configs/msrvtt_qa.json
QUESTIONS = ["what is the man doing", "what color is the car", "who is singing",
             "how many people are dancing"]
TEXTS = ["a dog catches a frisbee", "the cat jumps", "a person is playing",
         "a man is cooking"]
CHECK_TOPK = 8  # half the gallery, so the candidate set is a real choice

# kernel vs twin, elementwise |kernel - twin| <= atol + rtol·|twin|, bf16:
# the outputs are bf16 (one ulp is 2^-8 relative); the spatial kernel also
# rounds p to bf16 before PV where its twin keeps fp32, and the BERT attention
# kernel q, k, v, p and the per-head output (its TPU kernel's rounding points);
# the masked-attention kernel rounds p where its twin does, so only the
# summation order and exp differ; K4 against its TPU kernel's own rounding
# points (bert_attention_block_reference: q, k, v rounded after the fp32
# bias) with scores in the tens, where only the fp32 sums' order differs
BERT_CONTRACT_TOL = 2e-2
# B11 and B10 against their TPU kernels' rounding points (ln_matmul_plain;
# fused_temporal_block_reference: q, k, v rounded after the fp32 bias), as
# (atol, rtol): B11 rounds where its reference does and only fp32 sums
# differ in order, so one output bf16 ulp; B10 also rounds q, k, v and the
# per-head output at fp32 values that differ in their last bits, and the few
# roundings that land one ulp apart reach an output through the projection
# (|w_eff| · ulp(o)), so one ulp and 2^-7 absolute
# B15's bf16 route rounds where its twin (the JAX function's math) does:
# the normalized pixels once, the fp32 sums + bias once, so one ulp as B11
CONTRACT_TOL = {"ln_matmul": (2 ** -8, 2 ** -7), "fused_temporal_block": (2 ** -7, 2 ** -7),
                "patchify_embed": (2 ** -8, 2 ** -7)}
# the fused ingest's kernels round where their twins do (the LN output, the
# per-head output, the outputs), except the temporal chain, which stages q,
# k, v in bf16 as its TPU kernel does where its twin keeps fp32; the
# CLS-sideband attention rounds p like the spatial kernel (but the CLS
# column's); the attention + projection kernels and the LayerNorm round
# where their twins do
KERNEL_TOL = {"spatial_attn": 3e-2, "temporal_attn": 1e-2, "ln_mlp": 2e-2,
              "bert_attn": 3e-2, "bert_mlp": 2e-2, "masked_attn_bshd": 2e-2,
              "masked_attn_bhsd": 2e-2, "ln_matmul": 2e-2, "patchify_embed": 2e-2,
              "fused_spatial_block": 2e-2, "fused_temporal_block": 3e-2,
              "spatial_cls_attn": 3e-2, "spatial_qkv_proj": 2e-2, "temporal_qkv_proj": 2e-2,
              "layernorm": 2e-2, "temporal_roll": 1e-2, "block_attn": 2e-2}
# B16 is K2's kernel (K2's tolerance); B17 keeps q, k and v in fp32 where its
# twin rounds them to bf16 (its TPU kernel's rounding points)
# the video tower's opt-in serving forms (phase 7; 'auto' picks none): path
# (a), the raw-frame patch embed and both whole attention chains in one kernel
# each; path (b), LN→qkv in one kernel in front of the spatial and temporal
# attention kernels; path (c), the CLS-sideband spatial attention (no [cls; x]
# concat) with the default temporal kernel; path (d), attention + projection
# in one kernel on both axes
OPT_IN_PATHS = {
    "a": dict(fused_patchify="on", attn_impl="fused_block", temporal_attn_impl="fused_block",
              mlp_impl="fused"),
    "b": dict(attn_impl="fused_ln_qkv", temporal_attn_impl="fused_ln_qkv", mlp_impl="fused"),
    "c": dict(attn_impl="cls_sideband", temporal_attn_impl="fused_qkv_fold", mlp_impl="fused"),
    "d": dict(attn_impl="fused_qkv_proj", temporal_attn_impl="fused_qkv_proj", mlp_impl="fused"),
}
# the kernels that only the opt-in paths launch
OPT_IN_KERNELS = ("ln_matmul", "patchify_embed", "fused_spatial_block", "fused_temporal_block",
                  "spatial_cls_attn", "spatial_qkv_proj", "temporal_qkv_proj")
# masked attention's gradient (the Function's fp32 recompute, cast to bf16)
# against autograd through the bf16 twin, which backpropagates through p
# rounded to bf16: max |difference| <= this share of max |twin gradient|
MASKED_GRAD_TOL = 3e-2
# the LayerNorm's gradient (the Function's fp32 analytic backward) against
# autograd through the twin, bf16: the same math in another order; max
# |difference| <= this share of max |twin gradient|
LN_GRAD_TOL = 2e-2
# B16's and B17's gradients (their Functions' backward is the twin's vjp,
# recomputed) against autograd through the twins: max |difference| <= this
# share of max |twin gradient|
LAST_GRAD_TOL = 3e-2
# a narrow bf16 video tower (2 blocks) with the spatial kernel vs with the
# plain spatial attention: the kernel rounds p to bf16 where the plain path
# keeps fp32 (KERNEL_TOL's 3e-2 on the attention output); the outputs may
# differ by this share of their largest entry
TOWER_TOL = 3e-2
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
# query vs query_batch: the same bf16 towers at batch 1 and 4
QUERY_PROB_TOL = 1e-2
# kernel path vs plain path, 12 bf16 blocks apart: VTC features (unit norm,
# entries ~0.06) and P(match)
PLAIN_FEAT_TOL = 2e-2
PLAIN_PROB_TOL = 3e-2
# QA, pooled answer distributions over 1500 labels (random weights make them
# near uniform, 1/1500 = 6.7e-4, so they are compared as probabilities and
# as log-probabilities): kernel path vs plain path (video tower and 12 BERT
# layers in bf16 apart) and predict vs predict_batch (the same kernels at
# other batch sizes). A top-1 answer must agree wherever the reference's
# top-1 log-probability margin exceeds twice the tolerance (each side may
# move by the tolerance).
QA_PLAIN_TOL = {"prob": 1e-4, "logp": 1e-1}
QA_BATCH_TOL = {"prob": 2e-5, "logp": 2e-2}
# cached tokens vs pixels: the same kernels on the same batch
QA_CACHE_TOL = {"prob": 1e-6, "logp": 1e-3}
# finetuning: the linear schedule with warmup ratio 0.1 runs over this many
# steps (the run takes the first few); QA takes 4 clips per step
FT_TRAIN_STEPS, QA_TRAIN_BATCH = 40, 4
# the exact GELU's main shape: fc1's output in the QA finetuning cell
# (perfbench's qa_train_t16_b24: 24 clips x 16 frames x 196 patches, 3072)
GELU_SHAPE = (24 * QA_FRAMES * PATCHES, 3072)
# attn_impl 'pallas' vs 'xla' in bf16, dropout off, same weights, batch and
# negatives: the two attentions round at other points (the xla path keeps
# bf16 scores), so the VTC + VTM loss may differ by this much and the whole
# gradient by this relative L2 distance; the whole gradient's norm is carried
# by its large leaves, so each parameter's gradient is also held to a
# relative L2 distance, and the q/k/v weights that feed the masked attention
# (the spatial attention's packed qkv, BERT's query/key/value) to a tighter
# one. BERT's key biases are left out: a key bias adds q·b to every score of
# a row, which the softmax cancels, so their exact gradient is 0 and both
# paths give rounding noise (relative L2 ~1.3 between them on the H100)
FT_LOSS_TOL, FT_GRAD_TOL = 2e-2, 5e-2
FT_PARAM_GRAD_TOL, FT_QKV_GRAD_TOL = 2e-1, 1.5e-1
QKV_WEIGHT = re.compile(r"(\.attn\.qkv|\.self\.(query|key|value))\.weight$")
ZERO_GRAD = re.compile(r"\.self\.key\.bias$")

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


def graph_ms(fn, iters: int = 20, reps: int = 5):
    """Device time per call: ``iters`` back-to-back calls captured in one
    CUDA graph, replays timed by CUDA events (median of ``reps``), so the
    wrappers' host time drops out. Returns (ms, None), or (None, reason)
    where the calls cannot be captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
    except Exception as e:  # a wrapper that synchronises or copies from the host
        torch.cuda.synchronize()
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(times), None


def kernel_name(name: str) -> str:
    """A kernel's demangled name without its return type, namespaces and
    argument list: ``gemm_wgmma<1>``, ``attn_wgmma<64, false, true, true>``."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    head, _, _ = name.partition("<")
    return name[len(head) - len(head.split("::")[-1]):]


def kernel_split(fn, iters: int = 10) -> tuple:
    """Device time of ``fn``'s launches by kernel name under
    ``torch.profiler``, after a warm call: ({name: (ms per call, launches
    per call)}, the sum in ms per call)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.elapsed_us() > 0:
            t, n = by_name.get(kernel_name(e.name), (0.0, 0))
            by_name[kernel_name(e.name)] = (t + e.time_range.elapsed_us(), n + 1)
    fail_if(not by_name, "the profiler recorded no device kernel")
    split = {k: (t / iters / 1e3, n / iters) for k, (t, n) in by_name.items()}
    return split, sum(t for t, _ in split.values())


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


def _compare(name, shape, kernel, twin, card, main: bool = False, library=None,
             work=None, device: bool = False) -> dict:
    """Kernel vs twin on the same inputs; ``main`` marks the shape the main
    path gives the kernel (the JSON line reports that one), with ``work`` =
    (FLOP, bytes) of the function there and ``library`` one PyTorch call
    that computes it, where one exists. At the main shape, and where
    ``device`` asks, also the device time of the kernel's and the library
    call's (``graph_ms``)."""
    got, want = _flat(kernel()), _flat(twin())
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    tol = KERNEL_TOL[name]
    max_abs = float(diff.max())
    max_rel = max_abs / max(float(want.float().abs().max()), 1e-30)
    bad = int((diff > tol + tol * want.float().abs()).sum())
    ms, plain_ms = median_ms(kernel), median_ms(twin)
    lib_ms = median_ms(library) if library is not None else None
    res = {"shape": list(shape), "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "main": main, "device_ms": None, "library_device_ms": None}
    extra = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
    if main or device:
        res["device_ms"], why = graph_ms(kernel)
        extra += (f"; device {res['device_ms']:.4f} ms" if why is None
                  else f"; device_ms not measured ({why})")
        if library is not None:
            res["library_device_ms"], why = graph_ms(library)
            extra += (f", library device {res['library_device_ms']:.4f} ms" if why is None
                      else f", library device_ms not measured ({why})")
    if work is not None:
        flop_ms, byte_ms = work[0] / PEAK_FLOPS * 1e3, work[1] / PEAK_BYTES * 1e3
        res["bound_ms"] = max(flop_ms, byte_ms)
        res["bound_by"] = "operations" if flop_ms >= byte_ms else "bytes"
        extra += (f"; bound {res['bound_ms']:.4f} ms by {res['bound_by']} ({work[0] / 1e9:.2f}"
                  f" GFLOP, {work[1] / 1e6:.2f} MB)")
    print(f"[kernel] {name} {tuple(shape)}: max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
          f"(tol atol=rtol={tol}, {bad} outside); kernel {ms:.4f} ms, twin {plain_ms:.4f} ms"
          f"{extra} [{card}]", flush=True)
    fail_if(not bool(torch.isfinite(got).all()), f"{name} {shape}: non-finite output")
    fail_if(bad > 0, f"{name} {shape}: {bad} elements outside tolerance {tol}")
    return res


def _flat(out) -> torch.Tensor:
    """A kernel's output, or its outputs flattened into one, in fp32."""
    if isinstance(out, tuple):
        return torch.cat([t.float().flatten() for t in out])
    return out.float()


def _sdpa(q, k, v):
    return torch.nn.functional.scaled_dot_product_attention(q, k, v)


def phase_kernels(card: str) -> dict:
    """Each kernel against its twin: the video kernels at B=2 clips (T=16
    too for the temporal kernel, QA's frame count; R=B cls rows without the
    residual for the MLP tail) and at the shapes of one add_videos call of
    CLIPS_PER_CALL clips (main); the BERT kernels at one text query, a
    batch of 8 texts, the fusion of 8 (main) and 16 candidates, and the eval
    protocol's fusion call of 8 videos x 64 texts."""
    from alpro_tpu_torch.ops import bert_block, ln_mlp, qkv_attn

    g = torch.Generator(device="cuda").manual_seed(SEED)
    bf = torch.bfloat16

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(bf)

    H, hd, T, N, B = 12, 64, FRAMES, PATCHES, CLIPS_PER_CALL
    D, Dh = H * hd, 3072
    res = {k: [] for k in KERNEL_TOL}
    # K1 also at 256² and 384² frames (S = 257, 577: two and three key chunks)
    for M, S, main in ((2 * T, 1 + N, False), (B * T, 1 + N, True), (B * T, 257, False),
                       (B * T, 577, False)):
        x = randn(M, S, 3 * D)
        q, k, v = (x[..., i * D:(i + 1) * D].unflatten(-1, (H, hd)).transpose(1, 2)
                   for i in range(3))
        res["spatial_attn"].append(_compare(
            "spatial_attn", x.shape, lambda: qkv_attn.spatial_attention_qkv(x, H),
            lambda: qkv_attn.spatial_attention_plain(x, H, hd ** -0.5), card, main,
            library=lambda: _sdpa(q, k, v),
            work=(4 * M * H * S * S * hd, 2 * x.numel() * 4 // 3)))
    for b, t, main in ((2, T, False), (2, 16, False), (B, T, True)):
        xt = randn(b, t, N, 3 * D)
        qt, kt, vt = (xt[..., i * D:(i + 1) * D].unflatten(-1, (H, hd)).permute(0, 2, 3, 1, 4)
                      for i in range(3))
        res["temporal_attn"].append(_compare(
            "temporal_attn", xt.shape, lambda: qkv_attn.temporal_attention_qkv(xt, H),
            lambda: qkv_attn.temporal_attention_plain(xt, H, hd ** -0.5), card, main,
            library=lambda: _sdpa(qt, kt, vt),
            work=(4 * b * N * H * t * t * hd, 2 * xt.numel() * 4 // 3)))
    w = (randn(Dh, D, std=D ** -0.5), randn(Dh, std=0.02),
         randn(D, Dh, std=Dh ** -0.5), randn(D, std=0.02))
    ln = (1 + randn(D, std=0.1).float(), randn(D, std=0.1).float())
    w_bytes = 2 * D * Dh * 2 + (Dh + 3 * D) * 4
    # the small shapes (the B cls rows; one text query, a batch of 8) with
    # their device time too: there the kernels' split of the hidden decides
    for R, residual, main in ((2 * T * N, True, False), (2, False, False),
                              (B * T * N, True, True), (B, True, False)):
        xr = randn(R, D, std=2.0)
        res["ln_mlp"].append(_compare(
            "ln_mlp", (R, D),
            lambda: ln_mlp.ln_mlp(xr, *ln, w[0], w[1], w[2], w[3], eps=1e-6,
                                  residual=residual),
            lambda: ln_mlp.ln_mlp_plain(xr, *ln, w[0], w[1], w[2], w[3], 1e-6, residual),
            card, main, work=(4 * R * D * Dh, 2 * R * D * 2 + w_bytes), device=R <= B))
        if main:
            _mlp_yardstick("ln_mlp", xr, w, card)
    # BERT layer: text S = 40 (max_txt_len), fusion S = 40 + 197 video tokens;
    # every bias and LN vector bf16, as the bf16 model passes them
    wa = [t for _ in range(4) for t in (randn(D, D, std=D ** -0.5), randn(D, std=0.02))]
    lna = tuple(t.to(bf) for t in ln)
    # (512, 237): the eval protocol's fusion call (phase 10), 8 videos x 64 texts
    for M, S, main in ((1, 40, False), (8, 40, False), (8, 40 + 1 + N, True),
                       (16, 40 + 1 + N, False), (8 * 64, 40 + 1 + N, False)):
        xa, mask = randn(M, S, D), _text_mask(M, S)
        res["bert_attn"].append(_compare(
            "bert_attn", xa.shape,
            lambda: bert_block.bert_attention_block(xa, mask, *wa, *lna, H, eps=1e-12),
            lambda: bert_block.bert_attention_block_plain(xa, mask, *wa, *lna, H, 1e-12),
            card, main,
            work=(8 * M * S * D * D + 4 * M * H * S * S * hd,
                  2 * xa.numel() * 2 + 4 * D * D * 2 + M * S * 4 + 6 * D * 2), device=True))
        if main:
            _bert_attn_yardstick(xa, mask, wa, lna, card)
        if M * S in (40, 8 * (40 + 1 + N)):
            _bert_attn_contract(xa, mask, [t * 4 if t.dim() == 2 else t for t in wa], lna, card)
    for R, main in ((40, False), (8 * 40, False), (8 * (40 + 1 + N), True),
                    (16 * (40 + 1 + N), False), (8 * 64 * (40 + 1 + N), False)):
        xr = randn(R, D, std=2.0)
        res["bert_mlp"].append(_compare(
            "bert_mlp", (R, D),
            lambda: bert_block.bert_mlp_block(xr, *w, *ln, eps=1e-12),
            lambda: bert_block.bert_mlp_block_plain(xr, *w, *ln, 1e-12),
            card, main, work=(4 * R * D * Dh, 2 * R * D * 2 + w_bytes),
            device=R <= 8 * 40 or R == 8 * 64 * (40 + 1 + N)))
        if main:
            _mlp_yardstick("bert_mlp", xr, w, card)
    _masked_attn_kernels(res, randn, card)
    _fused_ingest_kernels(res, randn, ln, card)
    _opt_in_kernels(res, randn, card)
    _gelu_kernels(res, card)
    return res


def _gelu_kernels(res, card) -> None:
    """The exact GELU's forward and backward kernels (``ops/gelu.py``; no TPU
    kernel: XLA fused the chain) at GELU_SHAPE in bf16: the forward bit-equal
    to ``gelu_plain``, the backward within one bf16 ulp of autograd through
    the twin; the median ms of a wrapper call and of the twin's (the
    forward's seven launches; autograd's backward through a kept graph), the
    kernel's device time (``graph_ms``), the twin's (the sum of its kernels,
    ``kernel_split``) and the byte bound (4 and 6 bytes an element)."""
    from alpro_tpu_torch.ops import gelu

    g = torch.Generator(device="cuda").manual_seed(SEED + 25)
    x = (torch.randn(GELU_SHAPE, generator=g, device="cuda") * 3.0).to(torch.bfloat16)
    dg = torch.randn(GELU_SHAPE, generator=g, device="cuda").to(torch.bfloat16)
    fail_if(not torch.equal(gelu.gelu(x), gelu.gelu_plain(x)),
            f"gelu {GELU_SHAPE}: the forward differs from its twin")
    h = x.detach().requires_grad_(True)
    y = gelu.gelu_plain(h)

    def twin_backward():
        return torch.autograd.grad(y, h, dg, retain_graph=True)[0]

    want = twin_backward().float()
    diff = (gelu.gelu_backward(x, dg).float() - want).abs()
    m, e = torch.frexp(want.abs())
    ulp = torch.where(m == 0, torch.zeros_like(m), torch.ldexp(torch.ones_like(m), e - 8))
    worst = float((diff / ulp.clamp_min(2.0 ** -133)).max())
    fail_if(worst > 1, f"gelu backward {GELU_SHAPE}: {worst:.2f} bf16 ulps from autograd")
    del want, diff, m, e, ulp
    n = x.numel()
    for name, kernel, twin, nbytes in (
            ("gelu_fwd", lambda: gelu.gelu(x), lambda: gelu.gelu_plain(x), 4 * n),
            ("gelu_bwd", lambda: gelu.gelu_backward(x, dg), twin_backward, 6 * n)):
        ms, plain_ms = median_ms(kernel), median_ms(twin)
        dev, why = graph_ms(kernel)
        # autograd's engine thread cannot launch into a capture: the twin's
        # device time is the sum of its kernels under the profiler
        plain_dev = kernel_split(twin, iters=5)[1]
        bound = nbytes / PEAK_BYTES * 1e3
        res[name] = [{"shape": list(GELU_SHAPE), "ms": ms,
                      "plain_ms": plain_ms, "library_ms": None, "main": True, "device_ms": dev,
                      "plain_device_ms": plain_dev, "library_device_ms": None,
                      "bound_ms": bound, "bound_by": "bytes", "max_ulps": worst}]
        dev_txt = (f"device {dev:.4f} ms ({100 * bound / dev:.1f}% of the bound)"
                   if why is None else f"device_ms not measured ({why})")
        print(f"[kernel] {name} {GELU_SHAPE} bf16: kernel {ms:.4f} ms, {dev_txt}; twin "
              f"{plain_ms:.4f} ms, device {plain_dev:.4f}; bound {bound:.4f} ms by bytes "
              f"({nbytes / 1e6:.1f} MB); forward bit-equal, backward within {worst:.2f} ulp "
              f"[{card}]", flush=True)
    del y, h


def _text_mask(M: int, S: int) -> torch.Tensor:
    """(M, S) fp32 key mask of M texts of 40 positions (max_txt_len), each
    with a padded tail of its own length, then S - 40 video tokens."""
    mask = torch.ones(M, S, device="cuda")
    for m in range(M):
        mask[m, 8 + 3 * m % 32:40] = 0.0
    return mask


def _bert_attn_contract(x, mask, w, ln, card) -> None:
    """K4 against ``bert_attention_block_reference``, the TPU kernel's own
    rounding points (q, k and v rounded to bf16 after the fp32 bias), with
    the q/k/v/o weights ``w`` at std 4·D^-½ (scores in the tens, where the
    twin, which keeps q, k and v in fp32, drifts from both)."""
    from alpro_tpu_torch.ops import bert_block

    H = x.shape[-1] // 64
    with torch.no_grad():
        got = bert_block.bert_attention_block(x, mask, *w, *ln, H, eps=1e-12).float()
        ref = bert_block.bert_attention_block_reference(x, mask, *w, *ln, H, 1e-12).float()
        twin = bert_block.bert_attention_block_plain(x, mask, *w, *ln, H, 1e-12).float()
    tol = BERT_CONTRACT_TOL
    bad = int(((got - ref).abs() > tol + tol * ref.abs()).sum())
    print(f"[kernel] bert_attn vs the contract reference, weights at std 4·D^-½, "
          f"{tuple(x.shape)}: max_abs {float((got - ref).abs().max()):.3e} (tol atol=rtol={tol}, "
          f"{bad} outside); the twin's max_abs {float((twin - ref).abs().max()):.3e} [{card}]",
          flush=True)
    fail_if(not bool(torch.isfinite(got).all()), f"bert_attn {tuple(x.shape)}: non-finite output")
    fail_if(bad > 0, f"bert_attn vs its contract reference: {bad} outside {tol}")


def _bert_attn_yardstick(x, mask, w, ln, card) -> None:
    """A yardstick beside K4 at its main shape, not a library call (no single
    PyTorch call computes the chain): the device time of ``F.linear`` at the
    packed q/k/v projection's shape (R, 3D), SDPA with the key mask on the
    (M, H, S, 64) views of that projection, ``F.linear`` at the output
    projection's shape (R, D) and ``F.layer_norm`` over the R rows, bf16."""
    F = torch.nn.functional
    M, S, D = x.shape
    H, R = D // 64, M * S
    a = x.reshape(R, D)
    wqkv, bqkv = torch.cat(w[0:6:2]), torch.cat(w[1:6:2])
    qkv = F.linear(a, wqkv, bqkv)
    q, k, v = (qkv.view(M, S, 3, H, 64)[:, :, i].transpose(1, 2) for i in range(3))
    bias = ((1.0 - mask) * -10000.0).to(x.dtype)[:, None, None, :]
    o = a.clone()
    parts = []
    for what, fn, flop in (
            (f"F.linear ({R}, {D}) x ({3 * D}, {D})^T", lambda: F.linear(a, wqkv, bqkv),
             6 * R * D * D),
            (f"SDPA ({M}, {H}, {S}, 64) masked", lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias), 4 * M * H * S * S * 64),
            (f"F.linear ({R}, {D}) x ({D}, {D})^T", lambda: F.linear(o, w[6], w[7]),
             2 * R * D * D),
            (f"F.layer_norm ({R}, {D})", lambda: F.layer_norm(a, (D,), ln[0], ln[1], 1e-12), 0)):
        dev, why = graph_ms(fn)
        rate = "" if why or not flop else f", {flop / dev / 1e9:.1f} TFLOP/s"
        parts.append(f"{what} " + (f"not measured ({why})" if why else f"{dev:.4f} ms{rate}"))
    print(f"[kernel] bert_attn yardstick, device: {'; '.join(parts)} [{card}]", flush=True)


def _mlp_yardstick(name, x, w, card) -> None:
    """A yardstick beside K3/K5 at their main shape, not a library call (no
    single PyTorch call computes the MLP): ``F.linear`` at fc1's and at
    fc2's shapes, bf16 with their biases, each by device time and rate."""
    (R, D), Dh = x.shape, w[0].shape[0]
    h = torch.nn.functional.linear(x, w[0], w[1])
    parts = []
    for what, a, wt, b in (("fc1", x, w[0], w[1]), ("fc2", h, w[2], w[3])):
        dev, why = graph_ms(lambda: torch.nn.functional.linear(a, wt, b))
        rate = "" if why else f", {2 * R * D * Dh / dev / 1e9:.1f} TFLOP/s"
        parts.append(f"{what} ({R}, {a.shape[1]}) x ({wt.shape[0]}, {a.shape[1]})^T "
                     + (f"not measured ({why})" if why else f"{dev:.4f} ms{rate}"))
    print(f"[kernel] {name} yardstick, F.linear device: {'; '.join(parts)} [{card}]", flush=True)


def _opt_in_kernels(res, randn, card) -> None:
    """B6, B7 and B8 at the shapes of one add_videos call of CLIPS_PER_CALL
    clips (main) and of the QA encode (2 clips, T=16); B6 also at 256² and
    384² frames (N = 256, 576), B7 at one clip of 384² frames (S = 577), B8
    at T=32 and 48 (K2's wide path), b_eff bf16. B14 at the rows of one
    add_videos call's spatial input, bf16 → bf16 (main) and fp32 → bf16.
    Library calls: SDPA over the pre-concatenated [cls; x] packed qkv for B6
    (the concat not timed), one ``layer_norm`` for B14; none computes B7 or
    B8. B7's device time at both video shapes, beside a yardstick
    (``_spatial_yardstick``); B8's at both, split by launch, beside one at
    its main shape (SDPA over T, ``F.linear``)."""
    from alpro_tpu_torch.ops import layernorm, qkv_attn

    H, hd, T, N, B = 12, 64, FRAMES, PATCHES, CLIPS_PER_CALL
    D, S = H * hd, 1 + PATCHES
    for b, t, n, main in ((B, T, N, True), (2, 16, N, False), (B, T, 256, False),
                          (B, T, 576, False)):
        qx, qc = randn(b * t, n, 3 * D), randn(b, 1, 3 * D)
        full = torch.cat([qc[:, None].expand(b, t, 1, 3 * D).reshape(b * t, 1, 3 * D), qx], 1)
        heads = [full[..., i * D:(i + 1) * D].unflatten(-1, (H, hd)).transpose(1, 2)
                 for i in range(3)]
        M, Sn = b * t, 1 + n
        res["spatial_cls_attn"].append(_compare(
            "spatial_cls_attn", (M, n, 3 * D),
            lambda: qkv_attn.spatial_attention_qkv_cls(qx, qc, H, t),
            lambda: qkv_attn.spatial_attention_qkv_cls_plain(qx, qc, H, hd ** -0.5, t), card,
            main, library=lambda: _sdpa(*heads),
            work=(4 * M * H * Sn * Sn * hd, 2 * (qx.numel() + qc.numel()) + 2 * M * Sn * D)))
    # B7's and B8's bias bf16, as the bf16 model passes it
    wp, bp_bf = randn(D, D, std=D ** -0.5), randn(D, std=0.02)
    # and one clip of 384² frames (S = 577: the keys streamed in chunks)
    for M, Sx, main in ((B * T, S, True), (2 * 16, S, False), (T, 577, False)):
        x = randn(M, Sx, 3 * D)
        res["spatial_qkv_proj"].append(_compare(
            "spatial_qkv_proj", x.shape,
            lambda: qkv_attn.spatial_attention_qkv_proj(x, wp, bp_bf, H),
            lambda: qkv_attn.spatial_attention_qkv_proj_plain(x, wp, bp_bf, H, hd ** -0.5), card,
            main, work=(4 * M * H * Sx * Sx * hd + 2 * M * Sx * D * D,
                        2 * x.numel() + 2 * M * Sx * D + D * D * 2 + D * 2), device=Sx == S))
        if Sx == S:
            _spatial_yardstick("spatial_qkv_proj", x, None, (wp, bp_bf), card)
    w_bytes = D * D * 2 + D * 2
    # B8 also at T = 48 (K2's wide path, past the fp32 route's 32); its split
    # by launch (K2's body, the GEMM) at the two video shapes
    for b, t, main in ((B, T, True), (2, 16, False), (1, 32, False), (1, 48, False)):
        xt = randn(b, t, N, 3 * D)
        R = b * t * N

        def b8(xt=xt):
            return qkv_attn.temporal_attention_qkv_proj(xt, wp, bp_bf, H)

        res["temporal_qkv_proj"].append(_compare(
            "temporal_qkv_proj", xt.shape, b8,
            lambda: qkv_attn.temporal_attention_qkv_proj_plain(xt, wp, bp_bf, H, hd ** -0.5),
            card, main, work=(4 * b * N * H * t * t * hd + 2 * R * D * D,
                              2 * xt.numel() + 2 * R * D + w_bytes), device=t == 16))
        if main or t == 16:
            _print_split("temporal_qkv_proj", xt.shape, b8, card)
        if main:  # a yardstick: SDPA over T on the q/k/v views, then F.linear (R, D)
            qt, kt, vt = (xt.view(b, t, N, 3, H, hd)[:, :, :, i].permute(0, 2, 3, 1, 4)
                          for i in range(3))
            o = xt[..., :D].reshape(R, D).clone()
            _yardstick("temporal_qkv_proj", xt.shape, [
                (f"SDPA over T ({b}, {N}, {H}, {t}, {hd})", lambda: _sdpa(qt, kt, vt),
                 4 * b * N * H * t * t * hd),
                (f"F.linear ({R}, {D}) x ({D}, {D})^T",
                 lambda: torch.nn.functional.linear(o, wp, bp_bf), 2 * R * D * D)],
                card)
    R = B * T * S
    s, sb = 1 + randn(D, std=0.1).float(), randn(D, std=0.1).float()
    lib_w = (s.to(torch.bfloat16), sb.to(torch.bfloat16))
    for in_dtype, main in ((torch.bfloat16, True), (torch.float32, False)):
        xr = (randn(R, D, std=2.0) + 1).to(in_dtype)
        res["layernorm"].append(_compare(
            "layernorm", (R, D),
            lambda: layernorm.layernorm(xr, s, sb, eps=1e-6, out_dtype=torch.bfloat16),
            lambda: layernorm.layernorm_plain(xr, s, sb, 1e-6, torch.bfloat16), card, main,
            library=(lambda: torch.nn.functional.layer_norm(xr, (D,), *lib_w, 1e-6))
            if in_dtype == torch.bfloat16 else None,
            work=(8 * R * D, R * D * (xr.element_size() + 2) + 2 * D * 4)))


def _fused_ingest_kernels(res, randn, ln, card) -> None:
    """B11, B15, B10 and B9 at the shapes of one add_videos call of
    CLIPS_PER_CALL clips (main) and of the QA encode (2 clips, T=16); B10
    also at T=32 (``configs/msrvtt_ret_longT.json``) and T=48 (K2's wide
    path), B11 at the temporal rows too, B9 at one clip of 384² frames (S =
    577). At the main shape every LN and bias vector is bf16, as the bf16
    model passes them; B11 and B10 take fp32 LN vectors at their other
    shapes; B15's bias is bf16 at both. No single PyTorch call computes any
    of the four: their device time at both video shapes, B11's, B15's and
    B10's split by launch, and a yardstick of PyTorch calls beside each at
    its main shape (B9's and B7's also at QA's; B15's also ``F.linear`` on
    its bf16 patch rows). B11, B15 and B10 are also held to their TPU
    kernels' rounding points (``_contract``, ``CONTRACT_TOL``)."""
    from alpro_tpu_torch.models.timesformer import TimeSformerConfig
    from alpro_tpu_torch.ops import fused_block, ln_matmul, preprocess

    H, hd, T, N, B = 12, 64, FRAMES, PATCHES, CLIPS_PER_CALL
    D, S = H * hd, 1 + PATCHES
    wqkv, bqkv = randn(3 * D, D, std=D ** -0.5), randn(3 * D, std=0.02)
    wo, bo = randn(D, D, std=D ** -0.5), randn(D, std=0.02)
    lnb = tuple(t.to(torch.bfloat16) for t in ln)
    w_bytes = 4 * D * D * 2 + 4 * D * 4
    for R, main in ((B * T * S, True), (B * T * N, False), (2 * 16 * S, False)):
        xr = randn(R, D, std=2.0)
        lv = lnb if main else ln
        qa = R == 2 * 16 * S

        def b11(xr=xr, lv=lv):
            return ln_matmul.ln_matmul(xr, *lv, wqkv, bqkv, eps=1e-6)

        def b11_plain(xr=xr, lv=lv):
            return ln_matmul.ln_matmul_plain(xr, *lv, wqkv, bqkv, 1e-6)

        res["ln_matmul"].append(_compare(
            "ln_matmul", (R, D), b11, b11_plain, card, main,
            work=(2 * R * D * 3 * D, R * D * 2 + R * 3 * D * 2 + 3 * D * D * 2
                  + (2 * D + 3 * D) * lv[0].element_size()), device=qa))
        _contract("ln_matmul", (R, D), b11, b11_plain, card)
        if main or qa:
            _print_split("ln_matmul", (R, D), b11, card)
        if main:
            xn = torch.nn.functional.layer_norm(xr, (D,), lnb[0], lnb[1], 1e-6)
            _yardstick("ln_matmul", (R, D), [
                (f"F.layer_norm ({R}, {D})",
                 lambda: torch.nn.functional.layer_norm(xr, (D,), lnb[0], lnb[1], 1e-6), 0),
                (f"F.linear ({R}, {D}) x ({3 * D}, {D})^T",
                 lambda: torch.nn.functional.linear(xn, wqkv, bqkv), 6 * R * D * D)], card)
    mean, std = TimeSformerConfig.pixel_mean, TimeSformerConfig.pixel_std
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    # the bias bf16, as the bf16 model passes it
    kern, kbias = randn(768, D, std=768 ** -0.5), randn(D, std=0.02)
    for b, t, main in ((B, T, True), (2, 16, False)):
        raw = torch.randint(0, 256, (b, t, 224, 224, 3), generator=g, device="cuda",
                            dtype=torch.uint8)
        R = b * t * N

        def b15(raw=raw):
            return preprocess.patchify_embed(raw, kern, kbias, mean, std)

        def b15_plain(raw=raw):
            return preprocess.patchify_embed_plain(raw, kern, kbias, mean, std)

        res["patchify_embed"].append(_compare(
            "patchify_embed", raw.shape, b15, b15_plain, card, main,
            work=(2 * R * 768 * D, raw.numel() + 768 * D * 2 + D * 2 + R * D * 2), device=True))
        _contract("patchify_embed", raw.shape, b15, b15_plain, card)
        _print_split("patchify_embed", raw.shape, b15, card)
        if main:
            _patchify_yardstick(raw, kern, kbias, mean, std, card)
    for b, t, main in ((B, T, True), (2, 16, False), (1, 32, False), (1, 48, False)):
        xt = randn(b, t, N, D)
        R = b * t * N
        lv = lnb if main else ln
        qa = (b, t) == (2, 16)
        args = (*lv, wqkv, bqkv, wo, bo, H)

        def b10(xt=xt, args=args):
            return fused_block.fused_temporal_block(xt, *args, eps=1e-6)

        res["fused_temporal_block"].append(_compare(
            "fused_temporal_block", xt.shape, b10,
            lambda: fused_block.fused_temporal_block_plain(xt, *args, 1e-6), card, main,
            work=(2 * R * D * 4 * D + 4 * b * N * H * t * t * hd, 2 * xt.numel() * 2 + w_bytes),
            device=qa))
        _contract("fused_temporal_block", xt.shape, b10,
                  lambda: fused_block.fused_temporal_block_reference(xt, *args, 1e-6), card)
        if main or qa:
            _print_split("fused_temporal_block", xt.shape, b10, card)
        if main:
            _temporal_yardstick(xt, lnb, (wqkv, bqkv, wo, bo), card)
    # B9 with every LN and bias vector bf16, as the bf16 model passes them
    for M, Sx, main in ((B * T, S, True), (2 * 16, S, False), (T, 577, False)):
        xs = randn(M, Sx, D)
        res["fused_spatial_block"].append(_compare(
            "fused_spatial_block", xs.shape,
            lambda: fused_block.fused_spatial_block(xs, *lnb, wqkv, bqkv, wo, bo, H, eps=1e-6),
            lambda: fused_block.fused_spatial_block_plain(xs, *lnb, wqkv, bqkv, wo, bo, H, 1e-6),
            card, main,
            work=(2 * M * Sx * D * 4 * D + 4 * M * H * Sx * Sx * hd,
                  2 * xs.numel() * 2 + 4 * D * D * 2 + 6 * D * 2), device=Sx == S))
        if Sx == S:
            _spatial_yardstick("fused_spatial_block", xs, lnb, (wqkv, bqkv, wo, bo), card)


def _patchify_yardstick(raw, kern, kbias, mean, std, card) -> None:
    """Two yardsticks beside B15, not library calls: the normalize ((x /
    255 - mean) / std from uint8 to bf16, elementwise calls) and
    ``F.conv2d`` with the (D, 3, 16, 16) kernel at stride 16 on the
    channels-last frames, bf16; and ``F.linear`` on the bf16 patch rows
    (``preprocess.patch_rows_plain``), the share of B15's GEMM."""
    from alpro_tpu_torch.ops import preprocess

    b, t, hgt, wid, c = raw.shape
    frames = raw.view(b * t, hgt, wid, c)
    m = torch.tensor(mean, device="cuda")
    inv = 1.0 / torch.tensor(std, device="cuda")

    def normalize():
        return ((frames.float() * (1 / 255) - m) * inv).to(torch.bfloat16).permute(0, 3, 1, 2)

    x = normalize()
    w4 = kern.t().reshape(-1, 16, 16, c).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    R, D = b * t * (hgt // 16) * (wid // 16), kern.shape[1]
    _yardstick("patchify_embed", raw.shape, [
        (f"normalize ({b * t}, {hgt}, {wid}, {c})", normalize, 0),
        (f"F.conv2d ({b * t}, {c}, {hgt}, {wid}) * ({D}, {c}, 16, 16) / 16",
         lambda: torch.nn.functional.conv2d(x, w4, kbias, stride=16), 2 * R * 768 * D)], card)
    # the GEMM's share against cuBLAS: F.linear on the bf16 patch rows
    rows = preprocess.patch_rows_plain(raw, 16, mean, std, torch.bfloat16)
    wt = kern.t().contiguous()
    _yardstick("patchify_embed", raw.shape, [
        (f"F.linear ({R}, 768) x ({D}, 768)^T on the bf16 patch rows",
         lambda: torch.nn.functional.linear(rows, wt, kbias), 2 * R * 768 * D)], card)


def _contract(name, shape, kernel, ref, card) -> None:
    """A kernel against its TPU kernel's rounding points in plain torch on
    the same inputs, within ``CONTRACT_TOL``."""
    with torch.no_grad():
        got, want = kernel().float(), ref().float()
    atol, rtol = CONTRACT_TOL[name]
    diff = (got - want).abs()
    bad = int((diff > atol + rtol * want.abs()).sum())
    print(f"[kernel] {name} {tuple(shape)} vs its contract reference: max_abs "
          f"{float(diff.max()):.3e} (tol atol={atol}, rtol={rtol}; {bad} outside) [{card}]",
          flush=True)
    fail_if(bad > 0, f"{name} {tuple(shape)} vs its contract reference: {bad} outside")


def _print_split(name, shape, fn, card) -> None:
    """A wrapper call's device time by launch (``kernel_split``)."""
    split, total = kernel_split(fn)
    parts = "; ".join(f"{k[:60]} {t:.4f} ms ({n:g}x)" for k, (t, n) in
                      sorted(split.items(), key=lambda kv: -kv[1][0]))
    print(f"[kernel] {name} {tuple(shape)} split by launch (profiler): {parts}; sum {total:.4f}"
          f" ms [{card}]", flush=True)


def _yardstick(name, shape, calls, card) -> None:
    """The device time (``graph_ms``) of the PyTorch calls (what, fn,
    FLOP) that compute the same function as a kernel, and their sum."""
    parts, total = [], 0.0
    for what, fn, flop in calls:
        dev, why = graph_ms(fn)
        total += dev or 0.0
        rate = "" if why or not flop else f", {flop / dev / 1e9:.1f} TFLOP/s"
        parts.append(f"{what} " + (f"not measured ({why})" if why else f"{dev:.4f} ms{rate}"))
    print(f"[kernel] {name} yardstick {tuple(shape)}, device: {'; '.join(parts)}; sum "
          f"{total:.4f} ms [{card}]", flush=True)


def _temporal_yardstick(x, ln, w, card) -> None:
    """A yardstick beside B10, not a library call (no single PyTorch call
    computes the chain): ``F.layer_norm``, ``F.linear`` (R, 3D), SDPA over T
    on the (B, N, H, T, 64) views of its output, ``F.linear`` (R, D) and the
    residual add, bf16."""
    F = torch.nn.functional
    B, T, N, D = x.shape
    H, R = D // 64, B * T * N
    wqkv, bqkv, wo, bo = w
    a = x.reshape(R, D)
    xn = F.layer_norm(a, (D,), ln[0], ln[1], 1e-6)
    qkv = F.linear(xn, wqkv, bqkv)
    q, k, v = (qkv.view(B, T, N, 3, H, 64)[:, :, :, i].permute(0, 2, 3, 1, 4) for i in range(3))
    o = qkv[:, :D].clone()
    y = F.linear(o, wo, bo)
    _yardstick("fused_temporal_block", x.shape, [
        (f"F.layer_norm ({R}, {D})", lambda: F.layer_norm(a, (D,), ln[0], ln[1], 1e-6), 0),
        (f"F.linear ({R}, {D}) x ({3 * D}, {D})^T", lambda: F.linear(xn, wqkv, bqkv),
         6 * R * D * D),
        (f"SDPA over T ({B}, {N}, {H}, {T}, 64)", lambda: F.scaled_dot_product_attention(q, k, v),
         4 * B * N * H * T * T * 64),
        (f"F.linear ({R}, {D}) x ({D}, {D})^T", lambda: F.linear(o, wo, bo), 2 * R * D * D),
        (f"add ({R}, {D})", lambda: y + a, 0)], card)


def _spatial_yardstick(name, x, ln, w, card) -> None:
    """A yardstick beside B9 and B7, not a library call (no single PyTorch
    call computes either chain): the device time of the PyTorch calls that
    compute the same function on the same inputs in bf16. B9 (``ln`` given,
    x (M, S, D), w = wqkv, bqkv, wo, bo): ``F.layer_norm``, ``F.linear`` (R,
    3D), SDPA on the (M, H, S, 64) views of its output, ``F.linear`` (R, D).
    B7 (x the packed (M, S, 3D) qkv, w = wo, bo): SDPA on the views,
    ``F.linear`` (R, D)."""
    F = torch.nn.functional
    M, S, width = x.shape
    D = width if ln is not None else width // 3
    H, R = D // 64, M * S
    calls = []
    if ln is not None:
        wqkv, bqkv, wo, bo = w
        a = x.reshape(R, D)
        xn = F.layer_norm(a, (D,), ln[0], ln[1], 1e-6)
        qkv = F.linear(xn, wqkv, bqkv).view(M, S, 3 * D)
        calls += [(f"F.layer_norm ({R}, {D})", lambda: F.layer_norm(a, (D,), ln[0], ln[1], 1e-6),
                   0),
                  (f"F.linear ({R}, {D}) x ({3 * D}, {D})^T", lambda: F.linear(xn, wqkv, bqkv),
                   6 * R * D * D)]
    else:
        (wo, bo), qkv = w, x
    q, k, v = (qkv.view(M, S, 3, H, 64)[:, :, i].transpose(1, 2) for i in range(3))
    o = qkv[..., :D].reshape(R, D).clone()
    calls += [(f"SDPA ({M}, {H}, {S}, 64)", lambda: F.scaled_dot_product_attention(q, k, v),
               4 * M * H * S * S * 64),
              (f"F.linear ({R}, {D}) x ({D}, {D})^T", lambda: F.linear(o, wo, bo), 2 * R * D * D)]
    _yardstick(name, x.shape, calls, card)


def _masked_grad_check(name, shape, fn, twin, inputs) -> None:
    """The kernel's autograd Function (the JAX backward: an fp32 recompute)
    against autograd through the twin, on the same inputs and cotangent."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    ts = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*ts)
    cot = torch.randn(out.shape, generator=g, device="cuda").to(out.dtype)
    got = torch.autograd.grad(out, ts, cot)
    refs = [t.detach().clone().requires_grad_(True) for t in inputs]
    want = torch.autograd.grad(twin(*refs), refs, cot)
    err = max(float((a.float() - b.float()).abs().max() / b.float().abs().max())
              for a, b in zip(got, want))
    print(f"[kernel] {name} {tuple(shape)} backward: dq, dk, dv max_abs / max|twin| {err:.3e} "
          f"(tol {MASKED_GRAD_TOL})", flush=True)
    fail_if(not all(bool(torch.isfinite(a).all()) for a in got), f"{name}: non-finite gradient")
    fail_if(err > MASKED_GRAD_TOL, f"{name} {shape}: gradient differs from the twin's by {err}")


def _masked_attn_kernels(res, randn, card) -> None:
    """B13 (flat channels) and B12 (B, H, S, hd), forward and backward, at the
    finetuning path's shapes: spatial attention on views of the packed qkv of
    one 8-clip batch (64 frames, main), the text half (8, 40) and the fusion
    of the 3B-row VTM batch (24, 237), and the longest fusion sequence (512
    text + 197 video tokens); then past the one-pass chunk of 256 keys (257:
    two passes) and past what stays resident (1000 keys: K and V streamed).
    The library call is SDPA with the float key bias on views of the same
    tensors."""
    from alpro_tpu_torch.ops import masked_attn

    sdpa = torch.nn.functional.scaled_dot_product_attention
    H, hd, T, N, B = 12, 64, FRAMES, PATCHES, CLIPS_PER_CALL
    D, bf, scale = H * hd, torch.bfloat16, hd ** -0.5
    print(f"[kernel] masked_attn takes Sk <= {masked_attn.max_seq_len(bf, hd, 'cuda')} in bf16, "
          f"<= {masked_attn.max_seq_len(torch.float32, hd, 'cuda')} in fp32 at head_dim {hd}",
          flush=True)
    for Bn, S, packed, main in ((B * T, 1 + N, True, True), (8, 40, False, False),
                                (24, 40 + 1 + N, False, False), (1, 512 + 1 + N, False, False),
                                (8, 257, False, False), (2, 1000, False, False)):
        if packed:
            x = randn(Bn, S, 3 * D)
            q, k, v = x[..., :D], x[..., D:2 * D], x[..., 2 * D:]
        else:
            q, k, v = (randn(Bn, S, D) for _ in range(3))
        mask = torch.ones(Bn, S, device="cuda")
        if not packed:
            for b in range(Bn):  # padded text tails of different lengths
                mask[b, 8 + 3 * b % 32:40] = 0.0
        bias = masked_attn.key_bias(mask, Bn, S, "cuda")
        lib_mask = bias[:, None, None, :].to(bf)
        heads = [t.unflatten(-1, (H, hd)).transpose(1, 2) for t in (q, k, v)]
        contig = [t.contiguous() for t in heads]
        work = (4 * Bn * H * S * S * hd, 4 * Bn * S * D * 2 + Bn * S * 4)
        res["masked_attn_bshd"].append(_compare(
            "masked_attn_bshd", (Bn, S, D),
            lambda: masked_attn.fused_attention_bshd(q, k, v, H, key_mask=mask),
            lambda: masked_attn.attention_plain(*heads, bias, scale).transpose(1, 2).flatten(2),
            card, main, library=lambda: sdpa(*heads, attn_mask=lib_mask), work=work))
        res["masked_attn_bhsd"].append(_compare(
            "masked_attn_bhsd", (Bn, H, S, hd),
            lambda: masked_attn.fused_attention(*contig, key_mask=mask),
            lambda: masked_attn.attention_plain(*contig, bias, scale),
            card, main, library=lambda: sdpa(*contig, attn_mask=lib_mask), work=work))
        _masked_grad_check(
            "masked_attn_bshd", (Bn, S, D),
            lambda a, b, c: masked_attn.fused_attention_bshd(a, b, c, H, key_mask=mask),
            lambda a, b, c: masked_attn.attention_plain(
                *(t.unflatten(-1, (H, hd)).transpose(1, 2) for t in (a, b, c)), bias,
                scale).transpose(1, 2).flatten(2),
            (q, k, v))
        _masked_grad_check(
            "masked_attn_bhsd", (Bn, H, S, hd),
            lambda a, b, c: masked_attn.fused_attention(a, b, c, key_mask=mask),
            lambda a, b, c: masked_attn.attention_plain(a, b, c, bias, scale), contig)


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


def _build_model(build, vis_json: str, frames: int, **kwargs):
    from alpro_tpu_torch.models.alpro import init_random_

    bert_cfg = json.loads((REPO / "configs" / "base_model.json").read_text())
    vis_cfg = json.loads((REPO / "configs" / vis_json).read_text())
    with torch.device("meta"):
        model = build(bert_cfg, vis_cfg, img_size=224, num_frm=frames, dtype=torch.bfloat16,
                      **kwargs)
    model = model.to_empty(device="cuda")
    init_random_(model, torch.Generator(device="cuda").manual_seed(SEED))
    return model.to(torch.bfloat16).eval()


def _counts():
    from alpro_tpu_torch.ops import (bert_block, block_attn, fused_block, layernorm, ln_matmul,
                                     ln_mlp, masked_attn, preprocess, qkv_attn, temporal_attn)

    return {"spatial_attn": qkv_attn.spatial_launches,
            "temporal_attn": qkv_attn.temporal_launches, "ln_mlp": ln_mlp.launches,
            "bert_attn": bert_block.attn_launches, "bert_mlp": bert_block.mlp_launches,
            "masked_attn_bshd": masked_attn.bshd_launches,
            "masked_attn_bhsd": masked_attn.bhsd_launches, "ln_matmul": ln_matmul.launches,
            "patchify_embed": preprocess.launches,
            "fused_spatial_block": fused_block.spatial_launches,
            "fused_temporal_block": fused_block.temporal_launches,
            "spatial_cls_attn": qkv_attn.spatial_cls_launches,
            "spatial_qkv_proj": qkv_attn.spatial_proj_launches,
            "temporal_qkv_proj": qkv_attn.temporal_proj_launches,
            "layernorm": layernorm.launches, "temporal_roll": temporal_attn.roll_launches,
            "block_attn": block_attn.launches}


def _reset_counts():
    from alpro_tpu_torch.ops import (bert_block, block_attn, fused_block, layernorm, ln_matmul,
                                     ln_mlp, masked_attn, preprocess, qkv_attn, temporal_attn)

    qkv_attn.spatial_launches = qkv_attn.temporal_launches = ln_mlp.launches = 0
    bert_block.attn_launches = bert_block.mlp_launches = 0
    masked_attn.bshd_launches = masked_attn.bhsd_launches = 0
    ln_matmul.launches = preprocess.launches = 0
    fused_block.spatial_launches = fused_block.temporal_launches = 0
    qkv_attn.spatial_cls_launches = qkv_attn.spatial_proj_launches = 0
    qkv_attn.temporal_proj_launches = layernorm.launches = 0
    temporal_attn.roll_launches = block_attn.launches = 0


def _launches(video_calls: int = 0, text_calls: int = 0, masked: int = 0,
              path: str = "") -> dict:
    """Serving: launches per video tower call (12 blocks) and per text +
    fusion call (6 + 6 BERT layers); the video tower on the default kernel
    path, or on the opt-in path ``path`` ('a'-'d', ``OPT_IN_PATHS``).
    Finetuning under attn_impl='pallas': ``masked`` launches of the
    masked-attention kernel, no other."""
    per_block = {"": ("spatial_attn", "temporal_attn"),
                 "a": ("fused_spatial_block", "fused_temporal_block"),
                 "b": ("spatial_attn", "temporal_attn", "ln_matmul", "ln_matmul"),
                 "c": ("spatial_cls_attn", "temporal_attn"),
                 "d": ("spatial_qkv_proj", "temporal_qkv_proj")}[path]
    want = {k: 0 for k in KERNEL_TOL}
    for name in per_block:
        want[name] += 12 * video_calls
    want["ln_mlp"] = 24 * video_calls
    want["patchify_embed"] = video_calls if path == "a" else 0
    want.update(bert_attn=12 * text_calls, bert_mlp=12 * text_calls, masked_attn_bshd=masked)
    return want


def _set_path(model, vis_cfg, bert_cfg) -> None:
    model.visual_encoder.model.cfg = vis_cfg
    model.text_encoder.bert.cfg = bert_cfg


def _plain_cfgs(model):
    vis, bert = model.visual_encoder.model.cfg, model.text_encoder.bert.cfg
    return (dataclasses.replace(vis, attn_impl="plain", temporal_attn_impl="plain",
                                mlp_impl="plain"),
            dataclasses.replace(bert, block_impl="plain"))


def _warm(model, cfgs, tok, clips) -> None:
    """Select the path of ``cfgs`` (video, BERT) and run ``add_videos`` twice
    and ``query`` twice on a throwaway index at the timed batch size (lazy
    CUDA module loads, cuBLAS heuristics, allocator pools), right before
    timing that path."""
    from alpro_tpu_torch.serving.retrieval import RetrievalIndex

    _set_path(model, *cfgs)
    scratch = RetrievalIndex(model, tok, "cuda")
    for _ in range(2):
        scratch.add_videos(clips[:CLIPS_PER_CALL], [""] * CLIPS_PER_CALL)
    for _ in range(2):
        scratch.query(TEXTS[0])
    torch.cuda.synchronize()


def _fill(index, clips, ids) -> float:
    """add_videos in calls of CLIPS_PER_CALL; returns clips/s."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, len(ids), CLIPS_PER_CALL):
        index.add_videos(clips[lo:lo + CLIPS_PER_CALL], ids[lo:lo + CLIPS_PER_CALL])
    torch.cuda.synchronize()
    return len(ids) / (time.perf_counter() - t0)


def _query_ms(index, rounds: int = 5) -> list:
    out = []
    for _ in range(rounds):
        for t in TEXTS:
            t0 = time.perf_counter()
            index.query(t)
            out.append((time.perf_counter() - t0) * 1e3)
    return out


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
    from alpro_tpu_torch.models.alpro import build_retrieval_model
    from alpro_tpu_torch.serving.retrieval import RetrievalIndex

    model = _build_model(build_retrieval_model, "timesformer_divst_8x32_224_k600.json", FRAMES)
    kernel_cfgs = (model.visual_encoder.model.cfg, model.text_encoder.bert.cfg)
    plain_cfgs = _plain_cfgs(model)
    tok = HashTokenizer(model.cfg.bert.vocab_size)
    clips = np.random.RandomState(SEED).randint(
        0, 256, (N_CLIPS, FRAMES, 224, 224, 3), dtype=np.uint8)
    ids = [f"vid{i:02d}" for i in range(N_CLIPS)]

    # ---- the main path, kernels on ('auto' on a CUDA tensor) ----
    _warm(model, kernel_cfgs, tok, clips)
    index = RetrievalIndex(model, tok, "cuda", max_txt_len=40, topk=16)
    _reset_counts()
    clips_per_s = _fill(index, clips, ids)
    single = [index.query(t, topk=CHECK_TOPK) for t in TEXTS]
    batched = index.query_batch(TEXTS, topk=CHECK_TOPK)
    query_ms = _query_ms(index)
    launches = _counts()
    want = _launches(video_calls=-(-N_CLIPS // CLIPS_PER_CALL),
                     text_calls=len(single) + 1 + len(query_ms))
    print(f"[retrieval] kernel launches {launches} (expected {want})", flush=True)
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

    # ---- query latency without the BERT kernels (video banks as they are) ----
    full = [index.query(t, topk=N_CLIPS) for t in TEXTS]
    _set_path(model, kernel_cfgs[0], plain_cfgs[1])
    _query_ms(index, rounds=1)  # warm the plain BERT path
    before = _counts()
    bert_plain_ms = _query_ms(index)
    fail_if(_counts()["bert_attn"] != before["bert_attn"], "plain BERT launched bert_attn")

    # ---- the same index on the plain path: the reference ----
    before = _counts()
    _warm(model, plain_cfgs, tok, clips)
    plain = RetrievalIndex(model, tok, "cuda", max_txt_len=40, topk=16)
    plain_clips_per_s = _fill(plain, clips, ids)
    plain_full = [plain.query(t, topk=N_CLIPS) for t in TEXTS]
    fail_if(_counts() != before, f"plain path launched kernels: {before} -> {_counts()}")
    _set_path(model, *kernel_cfgs)
    pfeats, ptokens = plain._banks()
    feat_err = float((feats - pfeats).abs().max())
    tok_err = float((tokens.float() - ptokens.float()).abs().max())
    prob_err = max(abs(dict((r[0], r[1]) for r in a)[v] - p)
                   for a, b in zip(full, plain_full) for v, p, _ in b)
    print(f"[retrieval] kernel vs plain path: VTC feature max_abs {feat_err:.3e} (tol "
          f"{PLAIN_FEAT_TOL}), token bank max_abs {tok_err:.3e}, P(match) max_abs "
          f"{prob_err:.3e} (tol {PLAIN_PROB_TOL})", flush=True)
    fail_if(feat_err > PLAIN_FEAT_TOL, f"VTC features differ from the plain path by {feat_err}")
    fail_if(prob_err > PLAIN_PROB_TOL, f"P(match) differs from the plain path by {prob_err}")

    print(f"[retrieval] add_videos {clips_per_s:.2f} clips/s with kernels, "
          f"{plain_clips_per_s:.2f} clips/s plain ({N_CLIPS} clips, {CLIPS_PER_CALL} per call); "
          f"query p50 {statistics.median(query_ms):.2f} ms with the BERT kernels, "
          f"{statistics.median(bert_plain_ms):.2f} ms with plain BERT layers, over "
          f"{len(query_ms)} each (topk 16, gallery {N_CLIPS}) [{card}]", flush=True)
    return launches, dict(model=model, tok=tok, clips=clips, ids=ids, kernel_cfgs=kernel_cfgs,
                          plain_feats=pfeats, plain_full=plain_full,
                          clips_per_s={"default kernels": clips_per_s, "plain": plain_clips_per_s})


def _answer_dists(answers, labels) -> tuple:
    """[(answer, prob)] over every label → (probs, log-probs) in label order."""
    p = np.zeros(len(labels))
    for a, prob in answers:
        p[labels[a]] = prob
    return p, np.log(np.maximum(p, 1e-30))


def _check_answers(got, ref, tol: dict, what: str) -> dict:
    """Per question: pooled probabilities and log-probabilities within
    ``tol``; the same top-1 wherever the reference's top-1 log-probability
    margin exceeds 2·tol['logp']."""
    worst = {"prob": 0.0, "logp": 0.0}
    for q, (gp, gl), (rp, rl) in zip(QUESTIONS, got, ref):
        worst["prob"] = max(worst["prob"], float(np.abs(gp - rp).max()))
        worst["logp"] = max(worst["logp"], float(np.abs(gl - rl).max()))
        top2 = np.sort(rl)[-2:]
        if top2[1] - top2[0] > 2 * tol["logp"]:
            fail_if(int(np.argmax(gp)) != int(np.argmax(rp)), f"{what}: {q!r} top-1 differs")
    print(f"[qa] {what}: pooled prob max_abs {worst['prob']:.3e} (tol {tol['prob']}), "
          f"log-prob max_abs {worst['logp']:.3e} (tol {tol['logp']})", flush=True)
    for key in worst:
        fail_if(worst[key] > tol[key], f"{what}: {key} differs by {worst[key]:.3e}")
    return worst


def _host_ms(fn, reps: int) -> list:
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_qa(card: str) -> dict:
    from alpro_tpu_torch.models.alpro import build_qa_model
    from alpro_tpu_torch.serving.qa import VideoQAPredictor

    qa_cfg = json.loads((REPO / "configs" / "msrvtt_qa.json").read_text())
    fail_if((qa_cfg["num_frm"], qa_cfg["max_txt_len"]) != (QA_FRAMES, QA_TXT_LEN),
            f"configs/msrvtt_qa.json changed: {qa_cfg['num_frm']}, {qa_cfg['max_txt_len']}")
    L = qa_cfg["num_labels"]
    model = _build_model(build_qa_model, Path(qa_cfg["visual_model_cfg"]).name, QA_FRAMES,
                         num_labels=L, cls_hidden_scale=qa_cfg["cls_hidden_scale"])
    kernel_cfgs, plain_cfgs = ((model.visual_encoder.model.cfg, model.text_encoder.bert.cfg),
                               _plain_cfgs(model))
    labels = {f"ans{i}": i for i in range(L)}
    qa = VideoQAPredictor(model, HashTokenizer(model.cfg.bert.vocab_size), labels, "cuda",
                          max_txt_len=QA_TXT_LEN)
    clips = np.random.RandomState(SEED + 1).randint(
        0, 256, (QA_CLIPS, QA_FRAMES, 224, 224, 3), dtype=np.uint8)

    def warm():
        feats = qa.encode_video(clips)
        qa.predict(clips, QUESTIONS[0])
        for _ in range(2):
            qa.encode_video(clips)
            qa.predict(feats, QUESTIONS[0])
            qa.predict_batch(feats, QUESTIONS)
        torch.cuda.synchronize()

    def counted(fn, want: dict, what: str):
        _reset_counts()
        out = fn()
        torch.cuda.synchronize()
        got = _counts()
        print(f"[qa] {what}: launches {got} (expected {want})", flush=True)
        fail_if(got != want, f"{what}: launch counts {got} != {want}")
        return out

    # ---- the main path, kernels on ----
    warm()
    feats = counted(lambda: qa.encode_video(clips), _launches(video_calls=1), "encode_video")
    fail_if(tuple(feats.shape) != (QA_CLIPS, 1 + PATCHES, 768)
            or not bool(torch.isfinite(feats.float()).all()), "bad video tokens")
    cached = counted(lambda: [qa.predict(feats, q, topk=L) for q in QUESTIONS],
                     _launches(text_calls=len(QUESTIONS)), "predict x4 (cached)")
    from_pixels = counted(lambda: qa.predict(clips, QUESTIONS[0], topk=L),
                          _launches(video_calls=1, text_calls=1), "predict (pixels)")
    batched = counted(lambda: qa.predict_batch(feats, QUESTIONS, topk=L),
                      _launches(text_calls=1), "predict_batch x4 (cached)")
    for answers in cached + [from_pixels] + batched:
        fail_if(len(answers) != L or not all(np.isfinite(p) for _, p in answers),
                "answers: wrong count or non-finite")
    cached_d = [_answer_dists(a, labels) for a in cached]
    _check_answers([_answer_dists(from_pixels, labels)], cached_d[:1], QA_CACHE_TOL,
                   "pixels vs cached")
    _check_answers([_answer_dists(a, labels) for a in batched], cached_d, QA_BATCH_TOL,
                   "predict_batch vs predict")
    encode_ms = _host_ms(lambda: qa.encode_video(clips), 5)
    predict_ms = _host_ms(lambda: qa.predict(feats, QUESTIONS[0]), 20)
    batch_ms = _host_ms(lambda: qa.predict_batch(feats, QUESTIONS), 5)

    # ---- the plain path: the reference ----
    _set_path(model, *plain_cfgs)
    warm()
    before = _counts()
    pfeats = qa.encode_video(clips)
    plain = [_answer_dists(qa.predict(pfeats, q, topk=L), labels) for q in QUESTIONS]
    plain_encode_ms = _host_ms(lambda: qa.encode_video(clips), 5)
    plain_predict_ms = _host_ms(lambda: qa.predict(pfeats, QUESTIONS[0]), 20)
    fail_if(_counts() != before, f"plain path launched kernels: {before} -> {_counts()}")
    _set_path(model, *kernel_cfgs)
    tok_err = float((feats.float() - pfeats.float()).abs().max())
    print(f"[qa] kernel vs plain path: video token max_abs {tok_err:.3e}", flush=True)
    _check_answers(cached_d, plain, QA_PLAIN_TOL, "kernel vs plain path")

    med = statistics.median
    print(f"[qa] encode_video ({QA_CLIPS} clips x {QA_FRAMES} frames) {med(encode_ms):.2f} ms "
          f"with kernels, {med(plain_encode_ms):.2f} ms plain; cached predict p50 "
          f"{med(predict_ms):.2f} ms with kernels, {med(plain_predict_ms):.2f} ms plain; "
          f"predict_batch ({len(QUESTIONS)} questions) {med(batch_ms):.2f} ms [{card}]",
          flush=True)
    return dict(model=model, qa=qa, clips=clips, kernel_cfgs=kernel_cfgs, plain_feats=pfeats,
                plain=plain, labels=labels, encode_ms={"default kernels": med(encode_ms), "plain": med(plain_encode_ms)})


def phase_opt_in(card: str, ret: dict, qa: dict) -> dict:
    """The video tower's opt-in serving forms on phase 4's retrieval model
    and clips: under each path of ``OPT_IN_PATHS`` a fresh
    ``RetrievalIndex`` embeds the 16 clips in two ``add_videos`` calls, each
    with its exact launch counts, and answers the 4 texts over the whole
    gallery; VTC features and P(match) are held against phase 4's plain path
    within its tolerances, and clips/s is printed beside phase 4's. Then
    phase 5's QA ``encode_video`` under paths (a) and (d), with their counts,
    against phase 5's plain path. Returns the launch counts summed over the
    counted calls."""
    from alpro_tpu_torch.serving.retrieval import RetrievalIndex

    model, tok, clips, ids = ret["model"], ret["tok"], ret["clips"], ret["ids"]
    vis, bert = ret["kernel_cfgs"]
    total = {k: 0 for k in KERNEL_TOL}

    def counted(fn, want: dict, what: str):
        _reset_counts()
        out = fn()
        torch.cuda.synchronize()
        got = _counts()
        fail_if(got != want, f"{what}: launch counts {got} != {want}")
        for k, v in got.items():
            total[k] += v
        return out

    rates = dict(ret["clips_per_s"])
    batch = torch.as_tensor(clips[:CLIPS_PER_CALL])

    def kernel_ms(index) -> float:
        """Device kernel ms of one add_videos call's video embedding (the
        clips' upload included), by the profiler over 3 calls."""
        return kernel_split(lambda: index._embed_video(batch.to("cuda")), iters=3)[1]

    _set_path(model, vis, bert)
    kernel_time = {"default kernels": kernel_ms(RetrievalIndex(model, tok, "cuda", max_txt_len=40,
                                                               topk=16))}
    for path, impls in OPT_IN_PATHS.items():
        cfgs = (dataclasses.replace(vis, **impls), bert)
        _warm(model, cfgs, tok, clips)
        index = RetrievalIndex(model, tok, "cuda", max_txt_len=40, topk=16)
        want = _launches(video_calls=1, path=path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for lo in range(0, N_CLIPS, CLIPS_PER_CALL):
            counted(lambda: index.add_videos(clips[lo:lo + CLIPS_PER_CALL],
                                             ids[lo:lo + CLIPS_PER_CALL]),
                    want, f"path ({path}) add_videos")
        rates[f"path ({path})"] = N_CLIPS / (time.perf_counter() - t0)
        kernel_time[f"path ({path})"] = kernel_ms(index)
        full = [index.query(t, topk=N_CLIPS) for t in TEXTS]
        _set_path(model, vis, bert)
        feats, _ = index._banks()
        fail_if(not bool(torch.isfinite(feats).all()), f"path ({path}): non-finite features")
        feat_err = float((feats - ret["plain_feats"]).abs().max())
        prob_err = max(abs(dict((r[0], r[1]) for r in a)[v] - p)
                       for a, b in zip(full, ret["plain_full"]) for v, p, _ in b)
        print(f"[opt-in] path ({path}) {impls}: launches per add_videos call {want}; vs the "
              f"plain path: VTC feature max_abs {feat_err:.3e} (tol {PLAIN_FEAT_TOL}), P(match) "
              f"max_abs {prob_err:.3e} (tol {PLAIN_PROB_TOL})", flush=True)
        fail_if(feat_err > PLAIN_FEAT_TOL, f"path ({path}): VTC features differ by {feat_err}")
        fail_if(prob_err > PLAIN_PROB_TOL, f"path ({path}): P(match) differs by {prob_err}")
    print("[opt-in] add_videos clips/s (kernel ms per call, profiler): " + ", ".join(
        f"{k} {v:.2f}" + (f" ({kernel_time[k]:.2f})" if k in kernel_time else "")
        for k, v in rates.items()) + f" ({N_CLIPS} clips, {CLIPS_PER_CALL} per call) [{card}]",
        flush=True)

    qa_model, predictor, vis_qa = qa["model"], qa["qa"], qa["kernel_cfgs"][0]
    L = len(qa["labels"])
    for path in ("a", "d"):
        _set_path(qa_model, dataclasses.replace(vis_qa, **OPT_IN_PATHS[path]),
                  qa["kernel_cfgs"][1])
        for _ in range(2):
            predictor.encode_video(qa["clips"])
        feats = counted(lambda: predictor.encode_video(qa["clips"]),
                        _launches(video_calls=1, path=path), f"QA encode_video, path ({path})")
        encode_ms = statistics.median(_host_ms(lambda: predictor.encode_video(qa["clips"]), 5))
        _set_path(qa_model, *qa["kernel_cfgs"])
        fail_if(tuple(feats.shape) != (QA_CLIPS, 1 + PATCHES, 768)
                or not bool(torch.isfinite(feats.float()).all()),
                f"path ({path}): bad QA video tokens")
        tok_err = float((feats.float() - qa["plain_feats"].float()).abs().max())
        print(f"[opt-in] QA encode_video path ({path}): video token max_abs {tok_err:.3e} vs the "
              f"plain path; {encode_ms:.2f} ms, "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in qa["encode_ms"].items()) + f" [{card}]",
              flush=True)
        _check_answers([_answer_dists(predictor.predict(feats, q, topk=L), qa["labels"])
                        for q in QUESTIONS], qa["plain"], QA_PLAIN_TOL,
                       f"path ({path}) tokens vs plain path")
    return total


def phase_layernorm(card: str) -> int:
    """``LayerNorm(impl='pallas')``, the LayerNorm kernel's only entry (no
    model config sets it, as in JAX): a pre-LN over the rows of one
    add_videos call's spatial input (B·T·(1+N), 768) in bf16, forward and
    backward, with the launch counts set to 0 just before and read just
    after (one launch: the backward is plain torch); the output and the
    gradients of x, weight and bias against autograd through the twin.
    Returns the kernel's launches."""
    from alpro_tpu_torch.ops import layernorm
    from alpro_tpu_torch.ops.layers import LayerNorm

    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    bf, R, D = torch.bfloat16, CLIPS_PER_CALL * FRAMES * (1 + PATCHES), 768
    mod = LayerNorm(D, 1e-6, impl="pallas").cuda()
    with torch.no_grad():
        mod.weight.add_(0.1 * torch.randn(D, generator=g, device="cuda"))
        mod.bias.add_(0.1 * torch.randn(D, generator=g, device="cuda"))
    x = (2 * torch.randn((R, D), generator=g, device="cuda") + 1).to(bf).requires_grad_(True)
    cot = torch.randn((R, D), generator=g, device="cuda").to(bf)
    params = (x, mod.weight, mod.bias)
    torch.cuda.synchronize()
    _reset_counts()
    out = mod(x, bf)
    got = torch.autograd.grad(out, params, cot)
    torch.cuda.synchronize()
    counts = _counts()
    want = {k: 0 for k in KERNEL_TOL}
    want["layernorm"] = 1
    fail_if(counts != want, f"LayerNorm(impl='pallas'): launch counts {counts} != {want}")
    refs = [t.detach().clone().requires_grad_(True) for t in params]
    ref_out = layernorm.layernorm_plain(*refs, 1e-6, bf)
    wants = torch.autograd.grad(ref_out, refs, cot)
    tol = KERNEL_TOL["layernorm"]
    fwd = (out.detach().float() - ref_out.detach().float()).abs()
    bad = int((fwd > tol + tol * ref_out.float().abs()).sum())
    errs = [float((a.float() - b.float()).abs().max() / b.float().abs().max())
            for a, b in zip(got, wants)]
    print(f"[layernorm] LayerNorm(impl='pallas') on ({R}, {D}) bf16: 1 launch forward + "
          f"backward; output max_abs {float(fwd.max()):.3e} (tol atol=rtol={tol}, {bad} outside);"
          f" dx, dweight, dbias max_abs / max|twin| "
          + ", ".join(f"{e:.3e}" for e in errs) + f" (tol {LN_GRAD_TOL}) [{card}]", flush=True)
    fail_if(bad > 0, f"LayerNorm(impl='pallas'): {bad} outputs outside tolerance {tol}")
    fail_if(not all(bool(torch.isfinite(t).all()) for t in got), "LayerNorm: non-finite gradient")
    fail_if(max(errs) > LN_GRAD_TOL, f"LayerNorm(impl='pallas'): gradient differs by {errs}")
    return counts["layernorm"]


def _grad_gap(name, shape, fn, twin, inputs, seed) -> float:
    """d(inputs) of ``fn`` (a kernel's autograd Function) against autograd
    through ``twin`` on the same inputs and cotangent: the largest max
    |difference| / max |twin gradient| over the inputs."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ts = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*ts)
    cot = torch.randn(out.shape, generator=g, device="cuda").to(out.dtype)
    got = torch.autograd.grad(out, ts, cot)
    refs = [t.detach().clone().requires_grad_(True) for t in inputs]
    want = torch.autograd.grad(twin(*refs), refs, cot)
    fail_if(not all(bool(torch.isfinite(a).all()) for a in got), f"{name}: non-finite gradient")
    err = max(float((a.float() - b.float()).abs().max() / b.float().abs().max())
              for a, b in zip(got, want))
    print(f"[last] {name} {tuple(shape)} backward: max_abs / max|twin| over the {len(ts)} "
          f"inputs {err:.3e} (tol {LAST_GRAD_TOL})", flush=True)
    fail_if(err > LAST_GRAD_TOL, f"{name} {shape}: gradient differs from the twin's by {err}")
    return err


def _seeded_(module, seed: int):
    """Seeded N(0, 0.02) weights, LayerNorm scales 1 and biases 0, in place
    (the narrow models of the limit checks)."""
    from alpro_tpu_torch.ops.layers import LayerNorm

    g = torch.Generator(device="cuda").manual_seed(seed)
    norms = {id(q) for m in module.modules() if isinstance(m, LayerNorm) for q in m.parameters()}
    with torch.no_grad():
        for name, q in module.named_parameters():
            if id(q) in norms:
                q.fill_(1.0 if name.endswith("weight") else 0.0)
            else:
                q.normal_(0.0, 0.02, generator=g)
    return module


def _auto_limit(what, model, cfg, past, at, field, kernels, forward, at_model=None) -> None:
    """``model`` under ``auto`` (config ``cfg``) on inputs ``past``, one past
    the limit of the kernels ``kernels`` at call site ``field``: none of them
    launches and the output equals the forward with ``field`` set to
    'plain'; on inputs ``at`` (through ``at_model`` where the limit is a
    width), at the limit, they launch."""
    with torch.no_grad():
        model.cfg = cfg
        _reset_counts()
        out = forward(model, past)
        torch.cuda.synchronize()
        n_past = _counts()
        model.cfg = dataclasses.replace(cfg, **{field: "plain"})
        ref = forward(model, past)
        model.cfg = cfg
        _reset_counts()
        forward(at_model or model, at)
        torch.cuda.synchronize()
        n_at = _counts()
    diff = float((out.float() - ref.float()).abs().max())
    print(f"[last] auto at {what}: launches past the limit "
          f"{ {k: n_past[k] for k in kernels} }, at the limit { {k: n_at[k] for k in kernels} }; "
          f"vs {field}='plain' max_abs {diff:.3e} (must be 0)", flush=True)
    fail_if(not bool(torch.isfinite(out.float()).all()), f"auto at {what}: non-finite output")
    fail_if(any(n_past[k] for k in kernels), f"auto at {what}: launched {n_past} past the limit")
    fail_if(not all(n_at[k] for k in kernels), f"auto at {what}: no launch at the limit: {n_at}")
    fail_if(diff != 0.0, f"auto at {what}: differs from {field}='plain' by {diff}")


def _kernel_vs_plain(what, model, cfg, x, field, kernel, forward) -> None:
    """``model`` under config ``cfg`` on ``x`` launches ``kernel`` and
    matches the forward with ``field`` set to 'plain' within TOWER_TOL of its
    largest entry."""
    with torch.no_grad():
        model.cfg = cfg
        _reset_counts()
        out = forward(model, x)
        torch.cuda.synchronize()
        n = _counts()[kernel]
        model.cfg = dataclasses.replace(cfg, **{field: "plain"})
        ref = forward(model, x)
        model.cfg = cfg
    diff = float((out.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    print(f"[last] {what}: {kernel} launches {n}; vs {field}='plain' max_abs {diff:.3e} "
          f"(max |plain| {scale:.3e}, tol {TOWER_TOL} of it)", flush=True)
    fail_if(not bool(torch.isfinite(out.float()).all()), f"{what}: non-finite output")
    fail_if(n == 0, f"{what}: {kernel} did not launch")
    fail_if(diff > TOWER_TOL * scale, f"{what}: differs from {field}='plain' by {diff}")


def _block_contract(xs, w, mask, H, randn, card) -> None:
    """B17 against the TPU kernel's contract (q and k never rounded:
    ``fused_attention_block_reference``) at the main shape and masked, then
    with scores in the tens (q and k weights 0.25), where the twin, which
    rounds q and k to bf16, must miss the reference by at least 5 x the
    tolerance. Then its GEMM alone at the qkv (split) and projection shapes
    against the fp32 product, with its device time and rate."""
    from alpro_tpu_torch.ops import block_attn

    tol = KERNEL_TOL["block_attn"]
    D = xs.shape[-1]
    wide = (torch.cat([randn(2 * D, D, std=0.25), w[0][2 * D:]]), *w[1:])
    for what, x, ws, key_mask in (("main", xs, w, None), ("masked", xs, w, mask),
                                  ("scores in the tens", xs[:8], wide, None)):
        with torch.no_grad():
            got = block_attn.fused_attention_block(x, *ws, H, key_mask).float()
            ref = block_attn.fused_attention_block_reference(x, *ws, H, key_mask).float()
            twin = block_attn.fused_attention_block_plain(x, *ws, H, key_mask).float()
        bad = int(((got - ref).abs() > tol + tol * ref.abs()).sum())
        twin_err = float((twin - ref).abs().max())
        print(f"[last] fused_attention_block vs the contract reference, {what} "
              f"{tuple(x.shape)}: max_abs {float((got - ref).abs().max()):.3e} (tol atol=rtol="
              f"{tol}, {bad} outside); the twin's max_abs {twin_err:.3e} [{card}]", flush=True)
        fail_if(bad > 0, f"B17 vs its contract reference ({what}): {bad} outside {tol}")
        if what == "scores in the tens":
            fail_if(twin_err < 5 * tol, f"B17 contract check: the rounded twin is within "
                    f"{twin_err} of the reference, so the check cannot tell them apart")
    M = xs.shape[0] * xs.shape[1]
    a = xs.reshape(M, D)
    for what, wt, bias, split in (("qkv, split", w[0], w[1], D), ("projection", w[2], w[3], 0)):
        y = a.float() @ wt.float().t() + bias
        got = block_attn.gemm_bf16(a, wt, bias, split)
        hi = torch.cat([got[0], got[2], got[4]], 1) if split else got
        err = float(((hi.float() - y).abs() / (y.abs() + 1e-3)).max())
        lo_err = 0.0
        if split:  # q and k as hi + lo
            pair = torch.cat([got[0], got[2]], 1).float() + torch.cat([got[1], got[3]], 1).float()
            lo_err = float((pair - y[:, :2 * D]).abs().max() / y[:, :2 * D].abs().max())
        ms = median_ms(lambda: block_attn.gemm_bf16(a, wt, bias, split))
        dev, why = graph_ms(lambda: block_attn.gemm_bf16(a, wt, bias, split))
        b16 = bias.to(torch.bfloat16)
        lib_dev, lib_why = graph_ms(lambda: torch.nn.functional.linear(a, wt, b16))
        flop = 2 * M * wt.shape[0] * D

        def rate(t, why):
            return f"not measured ({why})" if why else f"{t:.4f} ms, {flop / t / 1e9:.1f} TFLOP/s"

        print(f"[last] gemm_wgmma {what} ({M}, {D}) x ({wt.shape[0]}, {D})^T: max |y - bf16| / "
              f"|y| {err:.3e} (tol 2^-8), |q,k hi + lo - y| / max|y| {lo_err:.3e}; {ms:.4f} ms "
              f"a call, device {rate(dev, why)}; library F.linear (bf16 out, no split) device "
              f"{rate(lib_dev, lib_why)} [{card}]", flush=True)
        fail_if(err > 2 ** -8 or lo_err > 2 ** -14, f"gemm_wgmma {what}: error {err}, {lo_err}")


def phase_last(card: str, res: dict, ret: dict) -> dict:
    """Phase 9: B16 and B17 through their public entries (the main path,
    counted), against their twins, their gradients, B17 against the port's
    ``Attention``, the packed and circulant temporal forms on phase 4's
    video tower, and ``auto`` one past each kernel's limit. Fills
    ``res['temporal_roll']`` and ``res['block_attn']``; returns their launch
    counts from the main path's run."""
    from alpro_tpu_torch.models.bert import BertConfig, BertModel
    from alpro_tpu_torch.models.timesformer import Attention, TimeSformer, TimeSformerConfig
    from alpro_tpu_torch.ops import _build, bert_block, block_attn, qkv_attn, temporal_attn
    from alpro_tpu_torch.serving.retrieval import RetrievalIndex

    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    bf = torch.bfloat16

    def randn(*shape, std=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(dtype)

    H, hd, T, N, B = 12, 64, FRAMES, PATCHES, CLIPS_PER_CALL
    D, S = H * hd, 1 + PATCHES
    # ---- the main path: one add_videos call's temporal attention (B16) and
    #      spatial attention sublayer (B17), forward and backward ----
    xt = randn(B, T, N, 3 * D)
    xs = randn(B * T, S, D)
    w = (randn(3 * D, D, std=D ** -0.5), randn(3 * D, std=0.02, dtype=torch.float32),
         randn(D, D, std=D ** -0.5), randn(D, std=0.02, dtype=torch.float32))
    leaves = [t.clone().requires_grad_(True) for t in (xt, xs, *w)]
    torch.cuda.synchronize()
    _reset_counts()
    roll = temporal_attn.temporal_attention_roll(leaves[0], H)
    blk = block_attn.fused_attention_block(leaves[1], *leaves[2:], H)
    grads = torch.autograd.grad([roll.float().square().mean(), blk.float().square().mean()],
                                leaves)
    torch.cuda.synchronize()
    counts = _counts()
    want = {k: 0 for k in KERNEL_TOL}
    want.update(temporal_roll=1, block_attn=1)
    print(f"[last] main path: temporal_attention_roll {tuple(xt.shape)} and "
          f"fused_attention_block {tuple(xs.shape)} forward + backward: launches "
          f"{ {k: counts[k] for k in ('temporal_roll', 'block_attn')} }", flush=True)
    fail_if(counts != want, f"phase 9 main path: launch counts {counts} != {want}")
    fail_if(not all(bool(torch.isfinite(t.float()).all()) for t in (roll, blk, *grads)),
            "phase 9 main path: non-finite output or gradient")
    del roll, blk, grads, leaves

    # ---- B16 against its twin over its envelope ----
    print(f"[last] temporal kernel takes T <= {qkv_attn._TEMPORAL_MAX_T}, head_dim a multiple "
          f"of 8 up to {qkv_attn._TEMPORAL_MAX_HD}", flush=True)
    for shape, heads, dtype, main in (((B, T, N, 3 * D), H, bf, True),
                                      ((2, 16, N, 3 * D), H, bf, False),
                                      ((1, 48, N, 3 * D), H, bf, False),
                                      ((2, 8, 9, 3 * 4 * 16), 4, bf, False),
                                      ((2, 8, 9, 3 * 2 * 40), 2, bf, False),
                                      ((2, T, N, 3 * D), H, torch.float32, False)):
        x = xt if main else randn(*shape, dtype=dtype)
        b_, t_, n_ = shape[:3]
        d_ = shape[3] // 3
        q, k, v = (x[..., i * d_:(i + 1) * d_].unflatten(-1, (heads, d_ // heads))
                   .permute(0, 2, 3, 1, 4) for i in range(3))
        res["temporal_roll"].append(_compare(
            "temporal_roll", shape, lambda: temporal_attn.temporal_attention_roll(x, heads),
            lambda: temporal_attn.temporal_attention_roll_plain(x, heads), card, main,
            library=lambda: _sdpa(q, k, v),
            work=(4 * b_ * n_ * heads * t_ * t_ * (d_ // heads),
                  x.numel() * x.element_size() * 4 // 3)))
    small = randn(2, 12, 9, 3 * 2 * 40, dtype=torch.float32)
    _grad_gap("temporal_roll", small.shape, lambda a: temporal_attn.temporal_attention_roll(a, 2),
              lambda a: temporal_attn.temporal_attention_roll_plain(a, 2), [small], SEED + 7)

    # ---- B17 against its twin, the library call, Attention, gradients ----
    mask = torch.ones(B * T, S, device="cuda")
    for m in range(B * T):  # random lengths
        mask[m, int(torch.randint(1, S + 1, (1,), generator=g, device="cuda")):] = 0.0
    smem = _build.smem_optin("cuda")
    print(f"[last] fused_attention_block takes S <= {block_attn.max_seq(bf, smem)} in bf16, <= "
          f"{block_attn.max_seq(torch.float32, smem)} in fp32", flush=True)
    mha = torch.nn.MultiheadAttention(D, H, batch_first=True, device="cuda", dtype=bf).eval()
    with torch.no_grad():
        mha.in_proj_weight.copy_(w[0])
        mha.in_proj_bias.copy_(w[1])
        mha.out_proj.weight.copy_(w[2])
        mha.out_proj.bias.copy_(w[3])
    w_bytes = 4 * D * D * 2 + 4 * D * 4
    long_mask = (torch.arange(577, device="cuda")[None] < torch.tensor([[577], [300]],
                                                                        device="cuda")).float()
    for M, seq, key_mask, dtype, main in ((B * T, S, None, bf, True), (B * T, S, mask, bf, False),
                                          (2 * 16, S, None, bf, False),
                                          (2, 577, long_mask, bf, False),
                                          (4, 150, None, torch.float32, False)):
        x = xs if main else (xs[:M] if dtype == bf and seq == S else randn(M, seq, D, dtype=dtype))
        ws = w if dtype == bf else tuple(t.float() for t in w)
        kpm = None if key_mask is None else block_attn.key_bias(key_mask).to(bf)
        res["block_attn"].append(_compare(
            "block_attn", (M, seq, D) + (("masked",) if key_mask is not None else ()),
            lambda: block_attn.fused_attention_block(x, *ws, H, key_mask),
            lambda: block_attn.fused_attention_block_plain(x, *ws, H, key_mask), card, main,
            library=(lambda: mha(x, x, x, key_padding_mask=kpm, need_weights=False)[0])
            if dtype == bf else None,
            work=(2 * M * seq * D * 4 * D + 4 * M * H * seq * seq * hd,
                  2 * M * seq * D * x.element_size() + w_bytes)))
    attn = Attention(D).to(device="cuda", dtype=bf).eval()
    with torch.no_grad():
        for lin, (wt, bs) in ((attn.qkv, w[:2]), (attn.proj, w[2:])):
            lin.weight.copy_(wt)
            lin.bias.copy_(bs)
        module = attn.plain(xs, H, bf)
        got = block_attn.fused_attention_block(xs, attn.qkv.weight, attn.qkv.bias,
                                               attn.proj.weight, attn.proj.bias, H)
    tol = KERNEL_TOL["block_attn"]
    diff = (got.float() - module.float()).abs()
    bad = int((diff > tol + tol * module.float().abs()).sum())
    print(f"[last] fused_attention_block vs Attention.plain (the port's module, same weights) "
          f"{tuple(xs.shape)}: max_abs {float(diff.max()):.3e} (tol atol=rtol={tol}, {bad} "
          f"outside)", flush=True)
    fail_if(bad > 0, f"B17 vs Attention: {bad} elements outside tolerance {tol}")
    _grad_gap("block_attn", xs.shape,
              lambda *a: block_attn.fused_attention_block(*a, H, mask),
              lambda *a: block_attn.fused_attention_block_plain(*a, H, mask), [xs, *w], SEED + 8)
    _block_contract(xs, w, mask, H, randn, card)

    # ---- the packed and circulant temporal forms on phase 4's video tower ----
    model, tok, clips, ids = ret["model"], ret["tok"], ret["clips"], ret["ids"]
    vis, bert = ret["kernel_cfgs"]
    for form in ("packed", "circulant"):
        cfgs = (dataclasses.replace(vis, temporal_attn_impl=form), bert)
        _set_path(model, *cfgs)
        index = RetrievalIndex(model, tok, "cuda", max_txt_len=40, topk=16)
        rate = _fill(index, clips, ids)
        _set_path(model, vis, bert)
        feats, _ = index._banks()
        fail_if(not bool(torch.isfinite(feats).all()), f"{form}: non-finite features")
        feat_err = float((feats - ret["plain_feats"]).abs().max())
        print(f"[last] temporal_attn_impl={form!r}: VTC feature max_abs {feat_err:.3e} vs the "
              f"plain path (tol {PLAIN_FEAT_TOL}); add_videos {rate:.2f} clips/s on first use "
              f"({N_CLIPS} clips) [{card}]", flush=True)
        fail_if(feat_err > PLAIN_FEAT_TOL, f"{form}: VTC features differ by {feat_err}")

    # ---- auto one past each kernel's limit (narrow widths, 2 blocks) ----
    tmax = qkv_attn._TEMPORAL_MAX_T
    narrow = TimeSformerConfig(img_size=32, patch_size=16, num_frames=tmax + 1, embed_dim=256,
                               depth=2, num_heads=4)

    def frames(t, side):
        return torch.randint(0, 256, (1, t, side, side, 3), generator=g, device="cuda",
                             dtype=torch.uint8)

    def video(m, x):
        return m(x)

    def tower(cfg, seed):
        return _seeded_(TimeSformer(cfg, dtype=bf).cuda(), seed)

    _auto_limit(f"T = {tmax + 1} frames", tower(narrow, SEED + 9), narrow, frames(tmax + 1, 32),
                frames(tmax, 32), "temporal_attn_impl", ("temporal_attn",), video)
    # K1 and B6 take any S: at 256² frames (S = 257, two key chunks) 'auto'
    # and 'cls_sideband' launch them and match 'plain'; their limit is the
    # head_dim, so 'auto' one past it (48) is 'plain' bit for bit
    big = dataclasses.replace(narrow, img_size=256, num_frames=2)
    big_tower = tower(big, SEED + 10)
    for impl, kernel in (("auto", "spatial_attn"), ("cls_sideband", "spatial_cls_attn")):
        _kernel_vs_plain(f"attn_impl={impl!r} at 256² frames (S = 257)", big_tower,
                         dataclasses.replace(big, attn_impl=impl), frames(2, 256), "attn_impl",
                         kernel, video)
    odd = dataclasses.replace(narrow, embed_dim=192, num_heads=4, num_frames=2)
    _auto_limit("head_dim 48 (K1 takes 32, 64, 128; 64 at the limit)", tower(odd, SEED + 13),
                odd, frames(2, 32), frames(2, 32), "attn_impl", ("spatial_attn",), video,
                at_model=tower(dataclasses.replace(narrow, num_frames=2), SEED + 13))
    wide = dataclasses.replace(narrow, embed_dim=384, num_heads=6, num_frames=2)
    _auto_limit("D = 384 (MLP tail; D = 256 at the limit)", tower(wide, SEED + 11), wide,
                frames(2, 32), frames(2, 32), "mlp_impl", ("ln_mlp",), video,
                at_model=tower(dataclasses.replace(wide, embed_dim=256, num_heads=4), SEED + 11))
    bcfg = BertConfig(hidden_size=256, num_hidden_layers=2, num_attention_heads=4,
                      intermediate_size=1024)
    limit = bert_block.max_seq(bf, smem)
    _auto_limit(f"BERT S = {limit + 1} in bf16 (S = {limit} at the limit)",
                _seeded_(BertModel(bcfg, dtype=bf).cuda(), SEED + 12), bcfg,
                randn(1, limit + 1, 256), randn(1, limit, 256), "block_impl",
                ("bert_attn", "bert_mlp"),
                lambda m, x: m(encoder_embeds=x, mode="multi_modal"))
    return {k: counts[k] for k in ("temporal_roll", "block_attn")}


def _train_model(build, vis_json: str, frames: int, attn_impl: str,
                 dtype=torch.bfloat16, depths=None, **kwargs):
    """fp32 parameters (seeded random) with ``dtype`` compute (bf16), dropout
    and drop-path at the configs' rates, built on the card; ``depths``:
    (video blocks, BERT layers, fusion layer) in place of the configs'."""
    from alpro_tpu_torch.models.alpro import init_random_

    bert_cfg = json.loads((REPO / "configs" / "base_model.json").read_text())
    vis_cfg = json.loads((REPO / "configs" / vis_json).read_text())
    if depths is not None:
        from alpro_tpu_torch.models.timesformer import TimeSformerConfig

        vis_cfg = dataclasses.replace(TimeSformerConfig.from_reference_cfg(vis_cfg, 224, frames),
                                      depth=depths[0])
        bert_cfg.update(num_hidden_layers=depths[1], fusion_layer=depths[2])
    with torch.device("meta"):
        model = build(bert_cfg, vis_cfg, img_size=224, num_frm=frames, dtype=dtype,
                      attn_impl=attn_impl, **kwargs)
    model = model.to_empty(device="cuda")
    return init_random_(model, torch.Generator(device="cuda").manual_seed(SEED))


def _set_attn_impl(model, impl: str, **dropout) -> None:
    """Switch both towers' attn_impl (and, given, their dropout fields)."""
    vis, bert = model.visual_encoder.model, model.text_encoder.bert
    vis.cfg = dataclasses.replace(vis.cfg, attn_impl=impl,
                                  **{k: v for k, v in dropout.items() if hasattr(vis.cfg, k)})
    bert.cfg = dataclasses.replace(bert.cfg, attn_impl=impl,
                                   **{k: v for k, v in dropout.items() if hasattr(bert.cfg, k)})


def _retrieval_train_setup(seed: int, dtype=torch.bfloat16, depths=None, frames=None,
                           batch_size=None):
    """Phase 6's retrieval finetuning under attn_impl='pallas': the model of
    ``configs/msrvtt_ret.json`` (see ``_train_model``; ``dtype`` compute),
    its AdamW and linear schedule over FT_TRAIN_STEPS, a TrainState, the
    train step with one local block, and a batch of the reference's per-GPU
    B (train_batch_size 64 over 8 GPUs) synthetic uint8 clips and hashed
    texts drawn from ``seed`` (``frames`` and ``batch_size`` in place of the
    config's T and B). Returns (model, opt, state, step, batch)."""
    from alpro_tpu_torch.models.alpro import build_retrieval_model
    from alpro_tpu_torch.train.optimizer import build_optimizer, get_lr_schedule
    from alpro_tpu_torch.train.state import TrainState
    from alpro_tpu_torch.train.step import make_retrieval_train_step

    cfg = json.loads((REPO / "configs" / "msrvtt_ret.json").read_text())
    B = batch_size or cfg["train_batch_size"] // 8
    T = frames or cfg["num_frm"]
    model = _train_model(build_retrieval_model, Path(cfg["visual_model_cfg"]).name,
                         T, "pallas", dtype=dtype, depths=depths)
    opt = build_optimizer(get_lr_schedule(cfg["decay"], cfg["learning_rate"], FT_TRAIN_STEPS),
                          betas=tuple(cfg["betas"]), grad_norm=cfg["grad_norm"])
    state = TrainState.create(model, opt)
    step = make_retrieval_train_step(model, opt, num_local_blocks=1)
    rng = np.random.RandomState(seed)
    tok = HashTokenizer(model.cfg.bert.vocab_size)(
        [f"{TEXTS[i % len(TEXTS)]} {i}" for i in range(B)], max_length=cfg["max_txt_len"])
    batch = {"visual_inputs": torch.from_numpy(rng.randint(
                 0, 256, (B, T, 224, 224, 3), dtype=np.uint8)).cuda(),
             "text_input_ids": torch.from_numpy(tok["input_ids"]).long().cuda(),
             "text_input_mask": torch.from_numpy(tok["attention_mask"]).long().cuda()}
    return model, opt, state, step, batch


def grad_gaps(got: dict, ref: dict) -> dict:
    """Gradients ``got`` against ``ref`` (parameter name → fp32 tensor): the
    relative L2 distance and cosine of the whole (``whole``, ``cosine``,
    over ``values`` entries); per parameter with a gradient on either side,
    the relative L2 distance, worst first (inf where only ``got`` has one),
    for all but BERT's key biases (``params``), for the q/k/v weights among
    them (``qkv``), and for the key biases (``key_bias``)."""
    flat = [torch.cat([g.flatten() for g in gs.values()]) for gs in (got, ref)]
    rel = {}
    for n, r in ref.items():
        dn, rn = float((got[n] - r).norm()), float(r.norm())
        if dn > 0 or rn > 0:
            rel[n] = dn / rn if rn > 0 else float("inf")
    params = sorted(((n, r) for n, r in rel.items() if not ZERO_GRAD.search(n)),
                    key=lambda kv: -kv[1])
    return {"whole": float((flat[0] - flat[1]).norm() / flat[1].norm()),
            "cosine": float(torch.nn.functional.cosine_similarity(flat[0], flat[1], dim=0)),
            "values": flat[1].numel(), "params": params,
            "qkv": [(n, r) for n, r in params if QKV_WEIGHT.search(n)],
            "key_bias": [r for n, r in rel.items() if ZERO_GRAD.search(n)]}


def _gelu_counts() -> tuple:
    from alpro_tpu_torch.ops import gelu

    return gelu.launches, gelu.backward_launches


def _gelu_want(model) -> tuple:
    """The exact GELU's (forward, backward) launches in one train step of
    ``model``: 2 a video block (CLS rows, patches), again in the recompute
    of a checkpointed tower, and 1 a BERT layer; backward 2 a block and 1 a
    layer."""
    depth, layers = model.cfg.visual.depth, model.cfg.bert.num_hidden_layers
    remat = model.cfg.visual.gradient_checkpointing
    return 2 * depth * (1 + remat) + layers, 2 * depth + layers


def _timed_step(step, state, batch, want: dict, what: str, gelu_want=None):
    """One train step with the launch counts set to 0 just before it and
    read just after; returns (metrics, host ms, peak device bytes, launch
    counts, with the GELU's as ``gelu`` and ``gelu_backward``), holding the
    GELU's to ``gelu_want`` (forward, backward) where given."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    before = _gelu_counts()
    t0 = time.perf_counter()
    _, metrics = step(state, batch, SEED)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = _counts()
    fail_if(got != want, f"{what} step {state.step}: launch counts {got} != {want}")
    gelu_got = tuple(b - a for a, b in zip(before, _gelu_counts()))
    fail_if(gelu_want is not None and gelu_got != tuple(gelu_want),
            f"{what} step {state.step}: GELU launches (forward, backward) {gelu_got} != "
            f"{gelu_want}")
    got = dict(got, gelu=gelu_got[0], gelu_backward=gelu_got[1])
    values = {k: float(v) for k, v in metrics.items()}
    fail_if(not all(np.isfinite(v) for v in values.values()), f"{what}: non-finite {values}")
    return values, ms, torch.cuda.max_memory_allocated(), got


def phase_finetune(card: str) -> dict:
    """(a) Retrieval finetuning at ALPRO-base width under attn_impl='pallas'
    against 'xla', in turns on one model (a warm-up step each, then
    pallas, xla, pallas, xla, pallas, xla): every pallas step launches the
    masked-attention kernel 24 times (12 spatial, 6 text, 6 fusion) and no
    serving kernel, every xla step no kernel; losses finite; after the
    steps every parameter has changed and temp lies in [0.001, 0.5].
    (b) With dropout and drop-path at 0, the same weights and batch: one
    step's loss, whole gradient and each parameter's gradient under
    'pallas' against 'xla', the hard negatives drawn once and replayed. (c) Two MSRVTT-QA steps (T=16, B=4,
    gradient checkpointing and accumulation over 2 as in its config), with
    their launch counts. Returns the masked-attention launches counted in
    (a)'s pallas steps, per layout."""
    from alpro_tpu_torch.models.alpro import build_qa_model
    from alpro_tpu_torch.train import step as train_step
    from alpro_tpu_torch.train.optimizer import build_optimizer, get_lr_schedule
    from alpro_tpu_torch.train.state import TrainState

    model, opt, state, step, batch = _retrieval_train_setup(SEED + 2)
    B = batch["visual_inputs"].shape[0]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    want = {"pallas": _launches(masked=24), "xla": _launches()}
    runs = {"pallas": [], "xla": []}
    gelu_ret = _gelu_want(model)
    for impl in ["pallas", "xla"] + ["pallas", "xla"] * 3:
        _set_attn_impl(model, impl)
        runs[impl].append(_timed_step(step, state, batch, want[impl], f"retrieval {impl}",
                                      gelu_ret))
    for impl, rows in runs.items():
        print(f"[finetune] retrieval {impl}: losses "
              + ", ".join(f"{r[0]['loss']:.5f} (vtc {r[0]['vtc_loss']:.5f}, vtm "
                          f"{r[0]['vtm_loss']:.5f})" for r in rows), flush=True)
    unchanged = [n for n, p in model.named_parameters() if torch.equal(p, before[n])]
    fail_if(bool(unchanged), f"parameters unchanged after {state.step} steps: {unchanged}")
    temp = float(model.temp.detach())
    fail_if(not 0.001 <= temp <= 0.5, f"temp {temp} outside [0.001, 0.5]")
    del before
    for impl, rows in runs.items():
        ms = statistics.median(r[1] for r in rows[1:])
        print(f"[finetune] retrieval attn_impl={impl}: step p50 {ms:.2f} ms over {len(rows) - 1} "
              f"steps after a warm-up, {B / ms * 1e3:.2f} train clips/s, peak "
              f"{max(r[2] for r in rows) / 2**30:.2f} GiB (max_memory_allocated); launches per "
              f"step {[r[3]['masked_attn_bshd'] for r in rows]} masked_attn_bshd, 0 of K1-K5 "
              f"[{card}]", flush=True)
    print(f"[finetune] all {state.step} steps: every parameter changed, temp {temp:.6f}",
          flush=True)

    # ---- (b) pallas vs xla: one step's loss and gradient, no dropout ----
    drawn = []
    sample = train_step.sample_hard_negatives

    def record(*args, **kw):
        drawn.append(sample(*args, **kw))
        return drawn[-1]

    grads, losses = {}, {}
    for impl in ("pallas", "xla"):
        _set_attn_impl(model, impl, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                       drop_path_rate=0.0, drop_rate=0.0)
        train_step.sample_hard_negatives = record if impl == "pallas" else (
            lambda *a, **k: drawn[0])
        model.train()
        model.zero_grad(set_to_none=True)
        try:
            g = train_step.step_generator(SEED, 0, "cuda")
            loss, _ = train_step.retrieval_loss(model, batch, train_step.StepContext(g, g))
            loss.backward()
        finally:
            train_step.sample_hard_negatives = sample
            model.eval()
        losses[impl] = float(loss.detach())
        grads[impl] = {n: (torch.zeros_like(p) if p.grad is None else p.grad).float()
                       for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
    gap = grad_gaps(grads["pallas"], grads["xla"])
    worst, qkv = gap["params"], gap["qkv"]
    ldiff = abs(losses["pallas"] - losses["xla"])
    print(f"[finetune] pallas vs xla, no dropout: loss {losses['pallas']:.6f} vs "
          f"{losses['xla']:.6f} (|diff| {ldiff:.3e}, tol {FT_LOSS_TOL}); full gradient "
          f"({gap['values']} values) relative L2 {gap['whole']:.3e} (tol {FT_GRAD_TOL}), "
          f"cosine {gap['cosine']:.6f}; per parameter, worst of {len(worst)} (and of the "
          f"{len(gap['key_bias'])} key biases, not held: {max(gap['key_bias'], default=0):.3e}): "
          + ", ".join(f"{n} {r:.3e}" for n, r in worst[:5])
          + f" (tol {FT_PARAM_GRAD_TOL}); worst of the {len(qkv)} q/k/v weights: "
          + ", ".join(f"{n} {r:.3e}" for n, r in qkv[:3]) + f" (tol {FT_QKV_GRAD_TOL})",
          flush=True)
    fail_if(ldiff > FT_LOSS_TOL, f"pallas vs xla loss differs by {ldiff}")
    fail_if(gap["whole"] > FT_GRAD_TOL,
            f"pallas vs xla gradient differs by {gap['whole']} (relative L2)")
    fail_if(len(qkv) != model.cfg.visual.depth + 3 * model.cfg.bert.num_hidden_layers,
            f"{len(qkv)} q/k/v weights with a gradient")
    fail_if(worst[0][1] > FT_PARAM_GRAD_TOL, f"pallas vs xla gradient of {worst[0][0]} "
            f"differs by {worst[0][1]} (relative L2)")
    fail_if(qkv[0][1] > FT_QKV_GRAD_TOL, f"pallas vs xla gradient of {qkv[0][0]} differs by "
            f"{qkv[0][1]} (relative L2)")
    launches = {k: sum(r[3][k] for r in runs["pallas"])
                for k in ("masked_attn_bshd", "masked_attn_bhsd")}
    launches["gelu_fwd"] = sum(r[3]["gelu"] for rows in runs.values() for r in rows)
    launches["gelu_bwd"] = sum(r[3]["gelu_backward"] for rows in runs.values() for r in rows)
    print(f"[finetune] retrieval: GELU kernel launches per step {gelu_ret} (forward, backward) "
          f"on both paths", flush=True)
    del model, state, opt, grads, step
    torch.cuda.empty_cache()

    # ---- (c) MSRVTT-QA finetuning steps ----
    qa_cfg = json.loads((REPO / "configs" / "msrvtt_qa.json").read_text())
    Bq, T, L = QA_TRAIN_BATCH, qa_cfg["num_frm"], qa_cfg["num_labels"]
    vis_json = Path(qa_cfg["visual_model_cfg"]).name
    model = _train_model(build_qa_model, vis_json, T, "pallas", num_labels=L,
                         cls_hidden_scale=qa_cfg["cls_hidden_scale"])
    remat = model.cfg.visual.gradient_checkpointing
    opt = build_optimizer(
        get_lr_schedule(qa_cfg["decay"], qa_cfg["learning_rate"], FT_TRAIN_STEPS),
        betas=tuple(qa_cfg["betas"]), grad_norm=qa_cfg["grad_norm"],
        accum_steps=qa_cfg["gradient_accumulation_steps"])
    state = TrainState.create(model, opt)
    step = train_step.make_qa_train_step(model, opt)
    tok = HashTokenizer(model.cfg.bert.vocab_size)(QUESTIONS[:Bq], max_length=qa_cfg["max_txt_len"])
    rng = np.random.RandomState(SEED + 3)
    qbatch = {"visual_inputs": torch.from_numpy(rng.randint(
                  0, 256, (Bq, T, 224, 224, 3), dtype=np.uint8)).cuda(),
              "text_input_ids": torch.from_numpy(tok["input_ids"]).long().cuda(),
              "text_input_mask": torch.from_numpy(tok["attention_mask"]).long().cuda(),
              "labels": torch.from_numpy(rng.randint(0, L, Bq)).cuda()}
    # 12 spatial attentions, again in the backward's recompute when the
    # video tower is checkpointed (configs: gradient_checkpointing), + 6 + 6
    qa_want = _launches(masked=12 * (1 + remat) + 12)
    gelu_qa = _gelu_want(model)
    rows = [_timed_step(step, state, qbatch, qa_want, "qa", gelu_qa) for _ in range(2)]
    launches["gelu_fwd"] += sum(r[3]["gelu"] for r in rows)
    launches["gelu_bwd"] += sum(r[3]["gelu_backward"] for r in rows)
    fail_if(state.opt_state.count != 1, f"QA: {state.opt_state.count} updates after 2 steps "
            f"with accumulation over {qa_cfg['gradient_accumulation_steps']}")
    print(f"[finetune] QA (T={T}, B={Bq}, {L} labels, video tower checkpointed: {remat}, "
          f"accumulation {qa_cfg['gradient_accumulation_steps']}): losses "
          f"{', '.join(f'{r[0]['loss']:.5f}' for r in rows)}; step ms "
          f"{', '.join(f'{r[1]:.2f}' for r in rows)}; peak {max(r[2] for r in rows) / 2**30:.2f} "
          f"GiB; launches per step {[r[3]['masked_attn_bshd'] for r in rows]} masked_attn_bshd, "
          f"0 of K1-K5; GELU kernel launches per micro-step {gelu_qa} (forward, backward) "
          f"[{card}]", flush=True)
    del model, state, opt
    torch.cuda.empty_cache()
    return launches


# ---- phase 10: the retrieval and QA eval protocols (the inference CLIs) ----
EVAL_VIDEOS, EVAL_TEXTS, EVAL_SRC_FRAMES, EVAL_HW = 32, 64, 12, (240, 320)
QA_EVAL_VIDEOS, QA_EVAL_QUESTIONS, QA_EVAL_CLIPS = 8, 16, 2
EVAL_VID_BSZ, EVAL_TXT_BSZ, EVAL_PAIR_BSZ, EVAL_TOPK, QA_EVAL_BSZ = 8, 64, 512, 8, 8
EVAL_WORDS = ["a", "the", "person", "dog", "cat", "runs", "jumps", "video", "man", "woman",
              "is", "playing", "ball", "red", "blue", "green", "frisbee", "kitchen"]
ANSWER_TYPES = ["what", "who", "how", "where", "when"]
# kernel run vs plain run of one eval protocol on the planted set, 12 bf16
# blocks apart: P(match), the VTC similarity (a cosine over the temperature
# 0.07) and the pooled QA log-probabilities, each about twice the largest
# difference measured on the card (H100: 7.8e-3, 4.8e-2 and 1.5e-2). Two
# entries of a query row are a near tie when their plain scores lie within
# twice the tolerance: only near ties can change order between the runs.
EVAL_PROB_TOL, EVAL_SIM_TOL, EVAL_QA_LOGP_TOL = 2e-2, 1e-1, 3e-2
# the least share that these fixed windows must decide — text→video rows at
# each k of R@k, pairs of videos in a text's row, top-K memberships and QA
# top-1 answers — so that the comparison has power: a text scored against
# the wrong video moves its score past the tolerance
EVAL_MIN_DECIDED = 0.4


class _TowerClock:
    """Inside a protocol run: the wall time of ``AlproModel``'s
    ``embed_video``, ``embed_text`` and ``fuse`` (each call between two
    ``torch.cuda.synchronize``; the protocol moves every result to the host
    right after the call anyway), the fusion pairs, and the QA classifier's
    logits (fp32, in call order)."""

    METHODS = ("embed_video", "embed_text", "fuse", "classify")

    def __enter__(self):
        from alpro_tpu_torch.models.alpro import AlproModel

        self.seconds = {m: 0.0 for m in self.METHODS[:3]}
        self.pairs, self.logits, self._saved = 0, [], {}
        for name in self.METHODS:
            orig = getattr(AlproModel, name)
            self._saved[name] = orig
            setattr(AlproModel, name, self._wrap(name, orig))
        return self

    def _wrap(self, name, orig):
        def timed(model, *args, **kwargs):
            if name == "classify":
                out = orig(model, *args, **kwargs)
                self.logits.append(out.float().cpu().numpy())
                return out
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(model, *args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[name] += time.perf_counter() - t0
            if name == "fuse":
                self.pairs += args[0].shape[0]
            return out
        return timed

    def __exit__(self, *exc):
        from alpro_tpu_torch.models.alpro import AlproModel

        for name, orig in self._saved.items():
            setattr(AlproModel, name, orig)


def _planted_clip(rng, frames: int) -> np.ndarray:
    """(frames, 240, 320, 3) uint8 with a feature of its own, so that the
    towers tell the clips apart (on i.i.d. noise every clip looks alike to
    them and every score is a near tie): a base colour, a colour gradient
    whose direction drifts over the frames, and ±24 levels of noise."""
    h, w = EVAL_HW
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) / max(h, w)
    base, angle = rng.uniform(48, 208, 3), rng.uniform(0, 2 * np.pi)
    slope, drift = rng.uniform(-80, 80, 3), rng.uniform(-0.5, 0.5)
    out = []
    for t in range(frames):
        a = angle + drift * t / frames
        img = base + slope * (np.cos(a) * xx + np.sin(a) * yy)[..., None]
        img = img + rng.uniform(-24, 24, (h, w, 3))
        out.append(np.clip(np.rint(img), 0, 255).astype(np.uint8))
    return np.stack(out)


def _write_eval_data(root: Path, vocab_words) -> dict:
    """The synthetic eval sets: retrieval (EVAL_VIDEOS planted .npy clips of
    EVAL_SRC_FRAMES frames at 240 × 320, two captions a video with txt_ids)
    and QA (QA_EVAL_VIDEOS planted clips of num_frm · n_clips frames,
    questions with answer types over ``ans{i}``), a vocab file from
    ``make_test_vocab`` and an ``ans2label`` of 1500 answers."""
    from alpro_tpu_torch.data.tokenization import make_test_vocab

    rng = np.random.RandomState(SEED + 20)
    paths = {}
    for name, n_videos, frames in (("ret", EVAL_VIDEOS, EVAL_SRC_FRAMES),
                                   ("qa", QA_EVAL_VIDEOS, QA_FRAMES * QA_EVAL_CLIPS)):
        vid_dir = root / name / "videos"
        vid_dir.mkdir(parents=True)
        for i in range(n_videos):
            np.save(vid_dir / f"{name}{i:03d}.npy", _planted_clip(rng, frames))
        paths[name] = str(vid_dir)
    with open(root / "ret.jsonl", "w") as f:
        for j in range(EVAL_TEXTS):
            words = rng.choice(vocab_words, size=int(rng.randint(3, 12)))
            f.write(json.dumps({"vid_id": f"ret{j // 2:03d}", "txt_id": f"t{j}",
                                "txt": " ".join(words)}) + "\n")
    with open(root / "qa.jsonl", "w") as f:
        for q in range(QA_EVAL_QUESTIONS):
            f.write(json.dumps({
                "question_id": q, "vid_id": f"qa{q % QA_EVAL_VIDEOS:03d}",
                "question": f"{ANSWER_TYPES[q % 5]} is the {' '.join(rng.choice(vocab_words, 4))}",
                "answer": f"ans{int(rng.randint(0, 1500))}", "answer_type": ANSWER_TYPES[q % 5],
            }) + "\n")
    (root / "ans2label.json").write_text(json.dumps({f"ans{i}": i for i in range(1500)}))
    (root / "vocab.txt").write_text("".join(t + "\n" for t in make_test_vocab(vocab_words)))
    return {"ret_ann": str(root / "ret.jsonl"), "ret_videos": paths["ret"],
            "qa_ann": str(root / "qa.jsonl"), "qa_videos": paths["qa"],
            "ans2label": str(root / "ans2label.json"), "vocab": str(root / "vocab.txt")}


def _save_weights(model, path: Path, cfg: dict, task: str) -> None:
    """The model's bf16 weights as an ALPRO-key ``.pt``; the CLI's
    ``inference_model_ckpt`` must load every one back bit for bit."""
    from alpro_tpu_torch.checkpoint.load import alpro_state_dict_of
    from alpro_tpu_torch.cli import common
    from alpro_tpu_torch.core.config import Config

    torch.save({k: v.cpu() for k, v in alpro_state_dict_of(model).items()}, path)
    loaded = common.load_inference_params(common.build_model_from_cfg(Config(cfg), task),
                                          Config(cfg))
    want = dict(model.named_parameters())
    bad = [k for k, p in loaded.named_parameters() if not torch.equal(p, want[k].float())]
    fail_if(bool(bad) or len(want) != len(dict(loaded.named_parameters())),
            f"{task}: inference_model_ckpt did not load {bad[:5]} back bit for bit")
    print(f"[eval] {task}: {len(want)} bf16 tensors saved to an ALPRO-key .pt "
          f"({path.stat().st_size / 1e6:.1f} MB), inference_model_ckpt loads them back bit for bit",
          flush=True)
    del loaded
    torch.cuda.empty_cache()


def _eval_run(cli, cfg: dict, want: dict, what: str, plain: bool = False) -> dict:
    """``cli.start_inference`` on ``cfg`` with the launch counts set to 0
    just before and read just after (they must equal ``want``); the towers'
    clock; the protocol's own seconds (its ``inference_*`` function). With
    ``plain``, the CLI's model is put on the plain path of phase 4
    (``_plain_cfgs``) right after it is built."""
    from alpro_tpu_torch.cli import common
    from alpro_tpu_torch.core.config import Config

    name = "inference_qa" if cli.__name__.endswith("qa") else "inference_retrieval"
    protocol, build, spent = getattr(cli, name), common.build_model_from_cfg, {}

    def timed(*args):
        t0 = time.perf_counter()
        out = protocol(*args)
        spent["protocol"] = time.perf_counter() - t0
        return out

    def build_plain(*args, **kwargs):
        model = build(*args, **kwargs)
        _set_path(model, *_plain_cfgs(model))
        return model

    setattr(cli, name, timed)
    if plain:
        common.build_model_from_cfg = build_plain
    try:
        with _TowerClock() as clock:
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = cli.start_inference(Config(cfg))
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            counts = _counts()
    finally:
        setattr(cli, name, protocol)
        common.build_model_from_cfg = build
    fail_if(counts != want, f"{what}: launch counts {counts} != {want}")
    out_file = "qa_results.json" if name == "inference_qa" else "results.json"
    saved = json.loads((Path(cfg["output_dir"]) / out_file).read_text())
    towers = sum(clock.seconds.values())
    run = dict(metrics=metrics, results=saved["results"], counts=counts, total_s=total,
               protocol_s=spent["protocol"], towers=dict(clock.seconds), pairs=clock.pairs,
               logits=clock.logits, outside=1 - towers / spent["protocol"])
    fail_if(not all(np.isfinite(r.get("score", 0.0)) and np.isfinite(r.get("sim", 0.0))
                    for r in run["results"]), f"{what}: non-finite scores")
    return run


def _eval_launches(video_calls: int, text_calls: int) -> dict:
    """Per video tower call 12 K1, 12 K2, 24 K3; per text chunk or fusion
    call 6 K4 and 6 K5."""
    want = _launches(video_calls=video_calls)
    want["bert_attn"] = want["bert_mlp"] = 6 * text_calls
    return want


def _matrix(results, key):
    vids = sorted({r["vid_id"] for r in results})
    txts = sorted({r["txt_id"] for r in results}, key=lambda t: int(t[1:]))
    m = np.zeros((len(vids), len(txts)))
    vi, ti = {v: i for i, v in enumerate(vids)}, {t: j for j, t in enumerate(txts)}
    for r in results:
        m[vi[r["vid_id"]], ti[r["txt_id"]]] = r[key]
    return m, vids, txts


def _rank(row, gts) -> int:
    """The best 0-based position of the ground-truth entries ``gts`` in the
    row's stable descending order (``evals/retrieval.py``'s rank, less 1)."""
    pos = np.empty(len(row), np.int64)
    pos[np.argsort(-row, kind="stable")] = np.arange(len(row))
    return int(pos[gts].min())


def _rank_bounds(p_row, gts, tol: float) -> tuple:
    """(lo, hi): where the best 0-based rank of the ground truths ``gts`` in
    ``p_row`` can go when every score moves by at most ``tol``. An entry more
    than 2·tol above a ground truth stays above it, one more than 2·tol below
    stays below, and only the near ties between can pass it."""
    others = np.setdiff1d(np.arange(len(p_row)), gts)
    lo = min(int((p_row[others] > p_row[g] + 2 * tol).sum()) for g in gts)
    hi = min(int((p_row[others] >= p_row[g] - 2 * tol).sum()) for g in gts)
    return lo, hi


def _pairs_apart(m, tol: float) -> float:
    """The share of pairs of entries within a column of ``m`` (a text's
    videos) whose scores differ by more than 2·tol: swapping such a pair
    moves both scores past the tolerance."""
    i, j = np.triu_indices(m.shape[0], 1)
    return float((np.abs(m[i] - m[j]) > 2 * tol).mean())


def _rank_checks(kern: dict, plain: dict, tol: float, what: str, unstable) -> None:
    """The kernel run's ranks against the plain run's, every score within
    ``tol``. In a query row (a text for text→video, a video for
    video→text) the rank must lie within ``_rank_bounds``; a row is decided
    at k when those bounds put it on one side of k, and on decided rows
    R@k must be equal; where every row's bounds meet, all the metrics must
    be. Rows holding an ``unstable`` entry (one that changed band) are left
    out. At least EVAL_MIN_DECIDED of the text→video rows must be decided
    at each k."""
    ks, vids, txts = _matrix(kern["results"], "score")
    ps, _, _ = _matrix(plain["results"], "score")
    gt_col = np.asarray([vids.index(f"ret{int(t[1:]) // 2:03d}") for t in txts])
    notes = []
    for direction, k_rows, p_rows, u_rows, gts in (
            ("text2video", ks.T, ps.T, unstable.T, [np.asarray([g]) for g in gt_col]),
            ("video2text", ks, ps, unstable,
             [np.nonzero(gt_col == v)[0] for v in range(len(vids))])):
        held = exact = 0
        hits = {k: [0, 0, 0] for k in (1, 5, 10)}  # decided rows, kernel hits, plain hits
        for k_row, p_row, u_row, gt in zip(k_rows, p_rows, u_rows, gts):
            if u_row.any():
                continue
            held += 1
            lo, hi = _rank_bounds(p_row, gt, tol)
            got = _rank(k_row, gt)
            fail_if(not lo <= got <= hi,
                    f"{what} {direction}: rank {got} outside its bounds [{lo}, {hi}]")
            exact += lo == hi
            for k, h in hits.items():
                if lo >= k or hi < k:
                    h[0] += 1
                    h[1] += got < k
                    h[2] += _rank(p_row, gt) < k
        for k, (n, kh, ph) in hits.items():
            fail_if(kh != ph, f"{what} {direction}: R@{k} differs on its {n} decided rows")
            if direction == "text2video":
                fail_if(n < EVAL_MIN_DECIDED * len(gts),
                        f"{what}: only {n}/{len(gts)} text2video rows decided at R@{k}")
        if exact == len(gts):
            fail_if(kern["metrics"][direction] != plain["metrics"][direction],
                    f"{what} {direction}: metrics differ with every rank decided")
        notes.append(f"{direction}: {held}/{len(gts)} rows within their bounds, {exact} exact; "
                     "decided at R@1/5/10 " + "/".join(str(h[0]) for h in hits.values())
                     + ", hits there equal (" + "/".join(str(h[1]) for h in hits.values()) + ")"
                     + ("; metrics equal" if exact == len(gts) else ""))
    print(f"[eval] {what} (near ties within 2 x {tol:.3e}): " + "; ".join(notes), flush=True)


def _retrieval_checks(kern: dict, plain: dict, mode: str, prob_tol: float = EVAL_PROB_TOL,
                      sim_tol: float = EVAL_SIM_TOL) -> None:
    """VTC sims within ``sim_tol`` and P(match) (or, ranking by the sims,
    the scores) within ``prob_tol`` of the plain run (phase 10's
    EVAL_SIM_TOL and EVAL_PROB_TOL by default). At K = 0 and VTC
    only, at least EVAL_MIN_DECIDED of the pairs of videos in a text's row
    lie apart (``_pairs_apart``). Under top-K every video whose plain sim is
    surely among a text's K best (fewer than K others within 2·tol above or
    higher) is a candidate, every one surely outside is not, and at least
    EVAL_MIN_DECIDED of the memberships are so decided; candidates'
    P(match) and the others' sim band within tolerance. Then the ranks
    (``_rank_checks``), the window the scores' own tolerance."""
    (ksim, _, _), (psim, _, _) = _matrix(kern["results"], "sim"), _matrix(plain["results"], "sim")
    kscore, _, _ = _matrix(kern["results"], "score")
    pscore, _, _ = _matrix(plain["results"], "score")
    sim_err = float(np.abs(ksim - psim).max())
    fail_if(sim_err > sim_tol, f"{mode}: VTC sims differ by {sim_err}")
    line = f"VTC sim max_abs {sim_err:.3e} (tol {sim_tol})"
    unstable = np.zeros(kscore.shape, bool)
    if mode == "topk":
        kc, pc = kscore > 1.0, pscore > 1.0  # the reranked candidates, per text column
        fail_if(not (kc.sum(0) == EVAL_TOPK).all(), f"{mode}: not {EVAL_TOPK} candidates a text")
        others = np.eye(psim.shape[0]) == 0
        gap = psim[None, :, :] - psim[:, None, :]  # [i, i', text]: sim of i' above i's
        surely_in = ((gap >= -2 * sim_tol) & others[..., None]).sum(1) < EVAL_TOPK
        surely_out = ((gap > 2 * sim_tol) & others[..., None]).sum(1) >= EVAL_TOPK
        fail_if(bool((surely_in & ~kc).any() or (surely_out & kc).any()),
                f"{mode}: a candidate set differs where the sims decide it")
        decided = float((surely_in | surely_out).mean())
        fail_if(decided < EVAL_MIN_DECIDED, f"{mode}: only {decided:.2f} of memberships decided")
        unstable = kc != pc
        prob_err = float(np.abs(kscore - pscore)[kc & pc].max())
        band_err = float(np.abs(kscore - pscore)[~kc & ~pc].max())
        line += (f"; top-{EVAL_TOPK} memberships decided by the sims {100 * decided:.1f}%, all "
                 f"equal, {int(unstable.any(0).sum())} texts with another set; P(match) of shared "
                 f"candidates max_abs {prob_err:.3e} (tol {prob_tol}), sim band "
                 f"{band_err:.3e} (tol {sim_tol / np.pi:.3e})")
        fail_if(prob_err > prob_tol, f"{mode}: P(match) differs by {prob_err}")
        fail_if(band_err > sim_tol / np.pi, f"{mode}: sim band differs by {band_err}")
        tol = max(prob_tol, sim_tol / np.pi)
    else:
        tol = sim_tol if mode == "vtc_only" else prob_tol
        err = float(np.abs(kscore - pscore).max())
        apart = _pairs_apart(pscore, tol)
        line += (f"; score max_abs {err:.3e} (tol {tol}); {100 * apart:.1f}% of the pairs of "
                 f"videos in a text's row more than 2 tol apart")
        fail_if(err > tol, f"{mode}: scores differ by {err}")
        fail_if(apart < EVAL_MIN_DECIDED, f"{mode}: only {apart:.2f} of video pairs apart")
    print(f"[eval] retrieval {mode}, kernel vs plain run: {line}", flush=True)
    _rank_checks(kern, plain, tol, f"retrieval {mode}", unstable)


def _qa_checks(kern: dict, plain: dict, qid2data: dict) -> None:
    """Pooled answer distributions (the mean of the clips' logits,
    softmaxed) within phase 5's QA_PLAIN_TOL['prob'] and log-probabilities
    within EVAL_QA_LOGP_TOL; the same top-1 wherever the plain run's top-1
    log-probability margin exceeds 2·EVAL_QA_LOGP_TOL (so no pair of
    answers could swap), which at least EVAL_MIN_DECIDED of the questions
    must; ``evaluate_qa`` equal on those questions, and on all where every
    one is."""
    from alpro_tpu_torch.evals.qa import evaluate_qa

    def pooled(run):
        per_call = np.stack(run["logits"]).reshape(-1, QA_EVAL_CLIPS, QA_EVAL_BSZ, 1500)
        logits = torch.from_numpy(per_call.mean(axis=1).reshape(-1, 1500))
        return logits.softmax(-1).numpy(), logits.log_softmax(-1).numpy(), logits.numpy()

    (kp, kl, klogits), (pp, pl, _) = pooled(kern), pooled(plain)
    worst = {"prob": float(np.abs(kp - pp).max()), "logp": float(np.abs(kl - pl).max())}
    top2 = np.sort(pl, axis=-1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    clear = margin > 2 * EVAL_QA_LOGP_TOL
    same = [k["answer"] == p["answer"] for k, p in zip(kern["results"], plain["results"])]
    fail_if(any(c and not s for c, s in zip(clear, same)), "QA: a clear top-1 answer differs")
    fail_if(any(int(np.argmax(a)) != r["answer"] for a, r in zip(klogits, kern["results"])),
            "QA: the recorded logits are not the answers'")
    fail_if(clear.mean() < EVAL_MIN_DECIDED, f"QA: only {int(clear.sum())} clear margins")
    label2ans = {i: f"ans{i}" for i in range(1500)}
    on_clear = [evaluate_qa([r for r, c in zip(run["results"], clear) if c], qid2data, label2ans)
                for run in (kern, plain)]
    fail_if(on_clear[0] != on_clear[1], "QA: accuracy differs on the clear questions")
    if clear.all():
        fail_if(kern["metrics"] != plain["metrics"], "QA: accuracy differs with every margin clear")
    print(f"[eval] qa, kernel vs plain run: pooled prob max_abs {worst['prob']:.3e} (tol "
          f"{QA_PLAIN_TOL['prob']}), log-prob max_abs {worst['logp']:.3e} (tol "
          f"{EVAL_QA_LOGP_TOL}); top-1 equal for the {int(clear.sum())}/{clear.size} questions "
          f"whose margin exceeds 2 tol, accuracy there equal ({on_clear[0]['overall_acc']}); "
          f"{sum(same)}/{len(same)} answers equal"
          + ("; metrics equal" if clear.all() else ""), flush=True)
    fail_if(worst["prob"] > QA_PLAIN_TOL["prob"], f"QA: prob differs by {worst['prob']:.3e}")
    fail_if(worst["logp"] > EVAL_QA_LOGP_TOL, f"QA: logp differs by {worst['logp']:.3e}")


def _padded_rows_check(model, tok) -> None:
    """The protocol pads its last text chunk with all-zero ids and masks
    (every key bias of such a row is −10000): the text half's K4 and the
    fusion at EVAL_VID_BSZ × EVAL_TXT_BSZ pairs give finite output there
    too, though the protocol slices those rows off before scoring."""
    from alpro_tpu_torch.ops import bert_block
    from alpro_tpu_torch.serving.inference import make_fusion_score_pairs_fn, make_text_encode_fn

    enc = tok(TEXTS * (EVAL_TXT_BSZ // len(TEXTS) - 1), max_length=40)
    ids = torch.zeros(EVAL_TXT_BSZ, 40, dtype=torch.int32, device="cuda")
    mask = torch.zeros_like(ids)
    n = len(enc["input_ids"])
    ids[:n], mask[:n] = (torch.from_numpy(enc[k]).cuda() for k in ("input_ids", "attention_mask"))
    videos = torch.randn(EVAL_VID_BSZ, 1 + PATCHES, 768, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(SEED + 21))
    before = bert_block.attn_launches
    te, tf = make_text_encode_fn(model)({"text_input_ids": ids, "text_input_mask": mask})
    logits = make_fusion_score_pairs_fn(model)(te, mask, videos.to(torch.bfloat16))
    torch.cuda.synchronize()
    fail_if(bert_block.attn_launches - before != 12, "padded rows: K4 did not run")
    fail_if(not (torch.isfinite(te[n:].float()).all() and torch.isfinite(logits).all()),
            "padded rows: non-finite text embeds or fusion logits")
    print(f"[eval] {EVAL_TXT_BSZ - n} all-zero padded text rows: finite text embeds and "
          f"finite logits at ({EVAL_VID_BSZ} x {EVAL_TXT_BSZ}) pairs through K4/K5", flush=True)


def phase_eval(card: str, ret: dict, qa: dict) -> dict:
    """The retrieval and QA eval protocols through the inference CLIs'
    ``start_inference`` on the card (``device='cuda'``), at ALPRO-base width
    and depth (``configs/msrvtt_ret.json``, ``configs/msrvtt_qa.json``) with
    phase 4's and phase 5's seeded weights written as ALPRO-key ``.pt``
    files, on synthetic ``.npy`` sets. Retrieval K = 0 (8 × 64 = 512 pairs a
    fusion call), ``eval_rerank_topk`` 8 (512 pairs a rerank call) and
    ``eval_vtc_only``; QA at T = 16 × 2 clips. Each on ``auto`` and on the
    plain path, with exact launch counts, the kernel run held to the plain
    run (``_retrieval_checks``, ``_qa_checks``), and the seconds, pairs/s
    and texts/s of each. Returns the launch counts of the kernel runs,
    summed."""
    import tempfile

    from alpro_tpu_torch.cli import run_video_qa, run_video_retrieval
    from alpro_tpu_torch.ops import bert_block, _build
    from alpro_tpu_torch.ops.ln_mlp import ln_mlp_fits

    smem = _build.smem_optin(torch.device("cuda"))
    R = EVAL_VID_BSZ * EVAL_TXT_BSZ
    fail_if(not (bert_block.attention_fits(R, 40 + 1 + PATCHES, 768, 12, torch.bfloat16, smem)
                 and ln_mlp_fits(768, 3072, torch.bfloat16)),
            f"K4/K5 limits refuse the fusion call's ({R}, {40 + 1 + PATCHES}, 768)")
    _set_path(ret["model"], *ret["kernel_cfgs"])
    _padded_rows_check(ret["model"], ret["tok"])
    total = {k: 0 for k in KERNEL_TOL}
    with tempfile.TemporaryDirectory(prefix="alpro_eval_") as tmp:
        root = Path(tmp)
        data = _write_eval_data(root, EVAL_WORDS)
        shared = dict(model_config=str(REPO / "configs" / "base_model.json"),
                      tokenizer_dir=data["vocab"], device="cuda", do_inference=True,
                      e2e_weights_path=None, inference_txt_db=None, inference_img_db=None)
        ret_cfg = json.loads((REPO / "configs" / "msrvtt_ret.json").read_text())
        ret_cfg.update(shared, visual_model_cfg=str(REPO / "configs" / Path(
            ret_cfg["visual_model_cfg"]).name),
            val_datasets=[{"name": "synthetic", "txt": data["ret_ann"],
                           "img": data["ret_videos"]}],
            inference_batch_size=EVAL_TXT_BSZ, eval_video_batch_size=EVAL_VID_BSZ,
            eval_pair_batch_size=EVAL_PAIR_BSZ, inference_model_ckpt=str(root / "ret.pt"))
        qa_cfg = json.loads((REPO / "configs" / "msrvtt_qa.json").read_text())
        qa_cfg.update(shared, visual_model_cfg=str(REPO / "configs" / Path(
            qa_cfg["visual_model_cfg"]).name),
            val_datasets=[{"name": "synthetic", "txt": data["qa_ann"], "img": data["qa_videos"]}],
            ans2label_path=data["ans2label"], inference_batch_size=QA_EVAL_BSZ,
            inference_n_clips=QA_EVAL_CLIPS, inference_model_ckpt=str(root / "qa.pt"))
        _save_weights(ret["model"], root / "ret.pt", ret_cfg, "retrieval")
        _save_weights(qa["model"], root / "qa.pt", qa_cfg, "qa")

        n_vb = -(-EVAL_VIDEOS // EVAL_VID_BSZ)
        n_tc = -(-EVAL_TEXTS // EVAL_TXT_BSZ)
        n_rerank = -(-EVAL_TEXTS * EVAL_TOPK // EVAL_PAIR_BSZ)
        n_qa = -(-QA_EVAL_QUESTIONS // QA_EVAL_BSZ) * QA_EVAL_CLIPS
        modes = {"k0": ({}, _eval_launches(n_vb, n_tc + n_vb * n_tc)),
                 "topk": ({"eval_rerank_topk": EVAL_TOPK}, _eval_launches(n_vb, n_tc + n_rerank)),
                 "vtc_only": ({"eval_vtc_only": True}, _eval_launches(n_vb, n_tc))}
        runs, zero = {}, {k: 0 for k in KERNEL_TOL}
        for mode, (extra, want) in modes.items():
            for path, expect in (("kernels", want), ("plain", zero)):
                cfg = dict(ret_cfg, **extra, output_dir=str(root / "out" / mode / path))
                runs[mode, path] = _eval_run(run_video_retrieval, cfg, expect,
                                             f"retrieval {mode} ({path})", path == "plain")
            _retrieval_checks(runs[mode, "kernels"], runs[mode, "plain"], mode)
        for path, expect in (("kernels", _eval_launches(n_qa, 2 * n_qa)), ("plain", zero)):
            cfg = dict(qa_cfg, output_dir=str(root / "out" / "qa" / path))
            runs["qa", path] = _eval_run(run_video_qa, cfg, expect, f"qa ({path})",
                                         path == "plain")
        qid2data = {r["question_id"]: r for r in
                    map(json.loads, Path(data["qa_ann"]).read_text().splitlines())}
        _qa_checks(runs["qa", "kernels"], runs["qa", "plain"], qid2data)

    for (mode, path), run in runs.items():
        tw = run["towers"]
        n_texts = QA_EVAL_QUESTIONS if mode == "qa" else EVAL_TEXTS
        pairs = (f"; fusion {run['pairs']} pairs in {tw['fuse']:.3f} s = "
                 f"{run['pairs'] / tw['fuse']:.1f} pairs/s" if tw["fuse"] else "")
        print(f"[eval] {mode} ({path}): start_inference {run['total_s']:.3f} s, protocol "
              f"{run['protocol_s']:.3f} s ({n_texts / run['protocol_s']:.1f} texts/s); towers: "
              f"video {tw['embed_video']:.3f} s, text {tw['embed_text']:.3f} s, fusion "
              f"{tw['fuse']:.3f} s{pairs}; outside the towers {100 * run['outside']:.1f}% of the "
              f"protocol; metrics {json.dumps(run['metrics'])} [{card}]", flush=True)
        if path == "kernels":
            print(f"[eval] {mode} (kernels) launches {run['counts']}", flush=True)
            for k, v in run["counts"].items():
                total[k] += v
    return total


# ---- phase 11: retrieval and QA finetuning through the CLIs ----
# lr 5e-5, twice the config's 2.5e-5 (no warm-up over 8 steps at ratio 0.1)
CLI_TRAIN_VIDEOS, CLI_TRAIN_BATCH, CLI_TRAIN_STEPS, CLI_TRAIN_LR = 64, 8, 8, 5e-5
CLI_QA_TRAIN_ROWS, CLI_QA_BATCH = 16, 4
# kernel run vs plain run of the same 8 retrieval steps (same data, seed and
# init; dropout and drop-path 0; the plain run replays the hard negatives the
# kernel run drew, a discrete choice that one near tie would flip). From a
# random init the trajectory is chaotic (vtc_loss 2.34, 4.41, 3.33, ... at lr
# 5e-5), so the bf16 difference of step 1 (2.1e-3) grows to 2.3e-2 by step 8
# and, in validate at step 4 and at the end, to 2.6e-2 / 4.4e-2 in P(match)
# and 0.165 / 0.112 in the sims (NVIDIA H100 80GB HBM3 at 700 W, three runs,
# bit-equal): each step's vtc_loss within CLI_VTC_TOL; validate's scores
# within CLI_PROB_TOL and sims within CLI_SIM_TOL, about twice those for the
# sims and the loss, and 1.35 times for P(match), where twice would leave
# fewer than phase 10's EVAL_MIN_DECIDED of the rows decided at R@10
CLI_VTC_TOL, CLI_PROB_TOL, CLI_SIM_TOL = 5e-2, 6e-2, 0.35


class _LoopClock:
    """Inside one ``start_training`` of ``cli``: each train step between two
    ``torch.cuda.synchronize`` (its wall time and its metrics, kept on the
    device until the run ends), each ``validate`` (seconds, and the results of
    its protocol), each deploy save and resume save (the time it blocks the
    loop), ``run_train_loop``'s wall time, and the state right after a
    restore (``checkpoint/restore.py::snapshot``)."""

    def __init__(self, cli):
        self.cli = cli

    def __enter__(self):
        from alpro_tpu_torch.checkpoint import restore
        from alpro_tpu_torch.cli import common

        kind = self.cli.__name__.rsplit(".", 1)[-1]
        self.steps, self.metrics, self.validates, self.results = [], [], [], []
        self.deploy_s, self.resume_s, self.loop, self.restored = [], [], (0.0, 0.0), None
        self.extras = []
        # the step the loop runs: the CLI's step as ``setup_training`` shards it
        patches = [(common, "shard_step", self._make(common.shard_step))]
        if kind in ("run_video_qa", "run_video_retrieval"):
            infer = "inference_qa" if kind == "run_video_qa" else "inference_retrieval"
            patches += [(self.cli, "validate", self._timed(self.cli.validate, self.validates)),
                        (self.cli, infer, self._recording(getattr(self.cli, infer)))]
        elif kind == "run_pretrain":  # validate's averages are its results
            patches.append((self.cli, "make_validate", self._validating(self.cli.make_validate)))
        patches += [(common, "save_params", self._timed(common.save_params, self.deploy_s)),
                   (common, "run_train_loop", self._loop(common.run_train_loop)),
                   (restore.TrainingRestorer, "save",
                    self._timed(restore.TrainingRestorer.save, self.resume_s)),
                   (restore.TrainingRestorer, "restore",
                    self._restoring(restore.TrainingRestorer.restore))]
        self._saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
        for obj, name, fn in patches:
            setattr(obj, name, fn)
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self._saved:
            setattr(obj, name, fn)

    def _make(self, make):
        def timed_make(*args, **kwargs):
            step = make(*args, **kwargs)

            def run(state, batch, seed, *extras):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = step(state, batch, seed, *extras)
                torch.cuda.synchronize()
                self.steps.append(time.perf_counter() - t0)
                self.extras.append(extras)
                self.metrics.append({k: v.detach().clone() for k, v in metrics.items()})
                return state, metrics
            return run
        return timed_make

    def _timed(self, fn, into):
        """``fn`` recording its (start, end) into ``into``."""
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            into.append((t0, time.perf_counter()))
            return out
        return timed

    def _recording(self, fn):
        def recording(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.results.append(out)
            return out
        return recording

    def _validating(self, make):
        def made(*args, **kwargs):
            return self._recording(self._timed(make(*args, **kwargs), self.validates))
        return made

    def _loop(self, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.loop = (t0, time.perf_counter())
            return out
        return timed

    def _restoring(self, fn):
        def restoring(restorer, state):
            from alpro_tpu_torch.checkpoint.restore import snapshot

            out = fn(restorer, state)
            if out is not None:
                devices = ({p.device.type for p in state.model.parameters()}
                           | {m.device.type for m in state.opt_state.mu + state.opt_state.nu})
                self.restored = (snapshot(state), devices)
            return out
        return restoring

    @staticmethod
    def seconds(spans) -> list:
        return [t1 - t0 for t0, t1 in spans]

    def in_loop(self, spans) -> float:
        """Seconds of ``spans`` inside ``run_train_loop``."""
        return sum(t1 - t0 for t0, t1 in spans if self.loop[0] <= t0 and t1 <= self.loop[1])

    @property
    def loop_s(self) -> float:
        return self.loop[1] - self.loop[0]

    def outside(self) -> float:
        """The share of the loop's time, less its validations and saves,
        spent outside the train steps (waiting for data, staging, logging)."""
        rest = self.loop_s - sum(self.in_loop(x) for x in (self.validates, self.deploy_s,
                                                            self.resume_s))
        return 1 - sum(self.steps) / rest


def _write_train_data(root: Path, vocab_words, data: dict) -> dict:
    """The training splits beside phase 10's eval sets: CLI_TRAIN_VIDEOS
    planted retrieval clips (EVAL_SRC_FRAMES frames at 240 × 320), each row
    a list of 2 captions, and CLI_QA_TRAIN_ROWS questions over the QA clips
    with answers ``ans{i}``; model configs with dropout and drop-path 0."""
    rng = np.random.RandomState(SEED + 30)
    vid_dir = root / "ret_train" / "videos"
    vid_dir.mkdir(parents=True)
    with open(root / "ret_train.jsonl", "w") as f:
        for i in range(CLI_TRAIN_VIDEOS):
            np.save(vid_dir / f"tr{i:03d}.npy", _planted_clip(rng, EVAL_SRC_FRAMES))
            caps = [" ".join(rng.choice(vocab_words, size=int(rng.randint(3, 12))))
                    for _ in range(2)]
            f.write(json.dumps({"vid_id": f"tr{i:03d}", "txt": caps}) + "\n")
    with open(root / "qa_train.jsonl", "w") as f:
        for q in range(CLI_QA_TRAIN_ROWS):
            f.write(json.dumps({
                "question_id": 1000 + q, "vid_id": f"qa{q % QA_EVAL_VIDEOS:03d}",
                "question": f"{ANSWER_TYPES[q % 5]} is the {' '.join(rng.choice(vocab_words, 4))}",
                "answer": f"ans{int(rng.randint(0, 1500))}", "answer_type": ANSWER_TYPES[q % 5],
            }) + "\n")
    bert = json.loads((REPO / "configs" / "base_model.json").read_text())
    bert.update(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    vis = json.loads((REPO / "configs" / "timesformer_divst_8x32_224_k600.json").read_text())
    vis.update(drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.0)
    (root / "bert_nodrop.json").write_text(json.dumps(bert))
    (root / "vis_nodrop.json").write_text(json.dumps(vis))
    return dict(data, ret_train=str(root / "ret_train.jsonl"), ret_train_videos=str(vid_dir),
                qa_train=str(root / "qa_train.jsonl"), bert_nodrop=str(root / "bert_nodrop.json"),
                vis_nodrop=str(root / "vis_nodrop.json"))


def _cli_train_launches(steps: int, per_step: int, video_calls: int, text_calls: int) -> dict:
    """A training CLI run under attn_impl='pallas': ``per_step`` B13 launches
    a step; in its validations (eval mode) the video tower's spatial
    attention is B13 too, so per video call 12 B13, 12 K2, 24 K3 and no K1,
    per text chunk or fusion call 6 K4 and 6 K5."""
    want = _eval_launches(video_calls, text_calls)
    want["spatial_attn"] = 0
    want["masked_attn_bshd"] = steps * per_step + 12 * video_calls
    return want


def _train_run(cli, cfg: dict, want: dict, what: str, plain: bool = False,
               negatives: list = None, argv: tuple = ()) -> dict:
    """``cli.main(["--config", file, *argv])`` — the CLI as a user runs it,
    flags at the parser's defaults but those ``cfg`` and ``argv`` set — under a
    ``_LoopClock``, with the launch counts set to 0 just before and read
    just after (they must equal ``want``) and the peak device memory; with
    ``plain`` the CLI's model is put on the plain path (no kernel) right
    after it is built. ``negatives``: a list the run's hard-negative draws
    are appended to, or (``plain``) replayed from in order."""
    import tempfile

    from alpro_tpu_torch.cli import common
    from alpro_tpu_torch.train import step as train_step

    sample = train_step.sample_hard_negatives
    replay = iter(negatives or ())

    def record(*args, **kwargs):
        negatives.append(tuple(t.clone() for t in sample(*args, **kwargs)))
        return negatives[-1]

    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
        json.dump(cfg, f)
    build = common.build_model_from_cfg

    def build_plain(*args, **kwargs):
        model = build(*args, **kwargs)
        vis, bert = model.visual_encoder.model, model.text_encoder.bert
        vis.cfg = dataclasses.replace(vis.cfg, attn_impl="plain", temporal_attn_impl="plain",
                                      mlp_impl="plain")
        bert.cfg = dataclasses.replace(bert.cfg, attn_impl="plain", block_impl="plain")
        return model

    if plain:
        common.build_model_from_cfg = build_plain
    if negatives is not None:
        train_step.sample_hard_negatives = (lambda *a, **k: next(replay)) if plain else record
    try:
        with _LoopClock(cli) as clock:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            t0 = time.perf_counter()
            state = cli.main(["--config", f.name, *argv])
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            counts = _counts()
    finally:
        common.build_model_from_cfg = build
        train_step.sample_hard_negatives = sample
        Path(f.name).unlink()
    fail_if(counts != want, f"{what}: launch counts {counts} != {want}")
    metrics = [{k: float(v) for k, v in m.items()} for m in clock.metrics]
    fail_if(not all(np.isfinite(v) for m in metrics for v in m.values()),
            f"{what}: non-finite step metrics {metrics}")
    return dict(state=state, clock=clock, metrics=metrics, counts=counts, total_s=total,
                peak=torch.cuda.max_memory_allocated())


def _logged(out_dir: str, prefix: str) -> list:
    rows = [json.loads(line) for line in
            (Path(out_dir) / "log" / "metrics.jsonl").read_text().splitlines()]
    return [(r["step"], r["key"], r["value"]) for r in rows if r["key"].startswith(prefix)]


def _slot_of(out_dir: str, step: int) -> str:
    d = Path(out_dir) / "restore"
    slots = [s for s in ("a", "b") if (d / f"{s}.done").exists()
             and int((d / f"{s}.done").read_text()) == step]
    fail_if(len(slots) != 1, f"no single resume slot holds step {step}")
    return slots[0]


def _same_snapshot(got: dict, want: dict) -> list:
    """The entries of two resume snapshots that are not bit-equal."""
    bad = [k for k in ("step", "count", "mini_step") if got[k] != want[k]]
    for part in ("params", "mu", "nu", "acc"):
        g, w = got[part], want[part]
        if (g is None) != (w is None):
            bad.append(part)
            continue
        for k, v in (w or {}).items():
            if k not in g or g[k].dtype != v.dtype or not torch.equal(g[k], v):
                bad.append(f"{part}:{k}")
    return bad


def _run_line(what: str, run: dict, batch: int, card: str) -> str:
    c = run["clock"]
    steps = c.steps[2:] if len(c.steps) > 2 else c.steps
    med = statistics.median(steps)
    return (f"[cli-train] {what}: {len(c.steps)} steps, step p50 {med * 1e3:.2f} ms over steps "
            f"{len(c.steps) - len(steps) + 1}-{len(c.steps)} = {batch / med:.2f} train clips/s; "
            f"loop {c.loop_s:.3f} s, outside the steps {100 * c.outside():.1f}% (the loop less "
            f"its validates {c.in_loop(c.validates):.3f} s, deploy saves "
            f"{c.in_loop(c.deploy_s):.3f} s and resume saves' blocking {c.in_loop(c.resume_s):.3f}"
            f" s); steps ms {', '.join(f'{t * 1e3:.1f}' for t in c.steps)}; start_training "
            f"{run['total_s']:.3f} s; peak "
            f"{run['peak'] / 2**30:.2f} GiB (max_memory_allocated) [{card}]")


def phase_finetune_cli(card: str, root: Path) -> tuple:
    """Finetuning through the CLIs on the card (``device='cuda'``), at
    ALPRO-base width and depth: retrieval (``configs/msrvtt_ret.json``, bf16
    compute, fp32 parameters, dropout and drop-path 0) on phase 10's
    planted clips plus a training split of CLI_TRAIN_VIDEOS videos × 2
    captions (8 frames ``rand``-sampled, resized to 256, randomly cropped to
    224), B = 8, 8 steps at lr 1e-4, resume saves at steps 4 and 8,
    ``validate`` at 4 and 8 and at the end on 32 videos × 64 texts at K = 0.
    (a) Under ``--attn_impl pallas`` and on the plain path, each with exact
    launch counts: finite logged losses, each step's vtc_loss within
    CLI_VTC_TOL, the final ``validate`` held to the plain run by phase 10's
    rules. (b) Resume: step 8's slot removed, ``start_training`` again on the
    same ``output_dir`` restores step 4's slot bit for bit on the card, ends
    at step 8 and writes ``model_step_8.pt``; ``--do_inference 1
    --inference_model_step 8`` gives that run's final R@k. (c) The loop with
    ``prefetch_depth`` 2 and 0 (``n_workers`` 4, no output directory); a
    sync resume save against the async one. (d) MSRVTT-QA
    (``configs/msrvtt_qa.json``: T = 16, its checkpointed video tower and
    accumulation over 2) at B = 4, 4 steps and one ``validate``, counted.
    The data goes under ``root``, which outlives the phase. Returns the
    launch counts of the kernel runs, summed, and the reference of phase
    14's ``--mesh_shape 1`` run: (a)'s config and its kernel run's first 4
    steps (metrics, the validation at step 4, ``model_step_4.pt`` kept
    under ``root``)."""
    import shutil

    from alpro_tpu_torch.cli import run_video_qa, run_video_retrieval
    from alpro_tpu_torch.checkpoint.restore import TrainingRestorer

    total = {k: 0 for k in KERNEL_TOL}
    zero = {k: 0 for k in KERNEL_TOL}
    n_vb, n_tc = -(-EVAL_VIDEOS // EVAL_VID_BSZ), -(-EVAL_TEXTS // EVAL_TXT_BSZ)
    per_validate = (n_vb, n_tc + n_vb * n_tc)
    data = _write_train_data(root, EVAL_WORDS, _write_eval_data(root, EVAL_WORDS))
    ret_cfg = json.loads((REPO / "configs" / "msrvtt_ret.json").read_text())
    ret_cfg.update(
        model_config=data["bert_nodrop"], visual_model_cfg=data["vis_nodrop"],
        tokenizer_dir=data["vocab"], device="cuda", do_inference=False,
        e2e_weights_path=None, attn_impl="pallas", train_batch_size=CLI_TRAIN_BATCH,
        vtm_negative_blocks=1, num_train_epochs=1, learning_rate=CLI_TRAIN_LR,
        save_steps_ratio=0.5, num_valid=2, min_valid_steps=1, log_interval=1,
        frm_sampling_strategy="rand", n_workers=0, inference_batch_size=EVAL_TXT_BSZ,
        eval_video_batch_size=EVAL_VID_BSZ, inference_txt_db=None, inference_img_db=None,
        train_datasets=[{"name": "synthetic", "txt": data["ret_train"],
                         "img": data["ret_train_videos"]}],
        val_datasets=[{"name": "synthetic", "txt": data["ret_ann"],
                       "img": data["ret_videos"]}])
    out = str(root / "out" / "kernels")

    # ---- (a) kernel run and plain run ----
    want = _cli_train_launches(CLI_TRAIN_STEPS, 24, 3 * per_validate[0], 3 * per_validate[1])
    negatives = []
    kern = _train_run(run_video_retrieval, dict(ret_cfg, output_dir=out), want,
                      "retrieval (kernels)", negatives=negatives)
    plain = _train_run(run_video_retrieval, dict(ret_cfg, output_dir=None), zero,
                       "retrieval (plain)", plain=True, negatives=negatives)
    fail_if(len(negatives) != CLI_TRAIN_STEPS, f"{len(negatives)} hard-negative draws")
    for k, v in kern["counts"].items():
        total[k] += v
    fail_if(kern["state"].step != CLI_TRAIN_STEPS or len(kern["metrics"]) != CLI_TRAIN_STEPS,
            f"retrieval: {kern['state'].step} steps")
    logged = _logged(out, "train_")
    fail_if(len(logged) != 3 * CLI_TRAIN_STEPS or not all(np.isfinite(v) for *_, v in logged),
            f"retrieval: logged losses {logged}")
    vtc = [(m["vtc_loss"], p["vtc_loss"]) for m, p in zip(kern["metrics"], plain["metrics"])]
    worst = max(abs(a - b) for a, b in vtc)
    print("[cli-train] retrieval vtc_loss per step, kernels / plain: "
          + ", ".join(f"{a:.5f}/{b:.5f}" for a, b in vtc)
          + f"; max |diff| {worst:.3e} (tol {CLI_VTC_TOL}); vtm_loss kernels "
          + ", ".join(f"{m['vtm_loss']:.5f}" for m in kern["metrics"]), flush=True)
    fail_if(worst > CLI_VTC_TOL, f"retrieval: vtc_loss kernel vs plain differs by {worst}")
    kc, pc = kern["clock"], plain["clock"]
    fail_if(len(kc.results) != 3 or len(pc.results) != 3, "retrieval: not 3 validates")
    metrics = [run_video_retrieval.eval_retrieval(r, _gt_of(r)) for r in kc.results]
    plain_metrics = [run_video_retrieval.eval_retrieval(r, _gt_of(r)) for r in pc.results]
    for i, at in ((0, "step 4"), (2, "the end")):  # step 8's equals the end's
        print(f"[cli-train] validate at {at}, kernel run vs plain run:", flush=True)
        _retrieval_checks(dict(results=kc.results[i], metrics=metrics[i]),
                          dict(results=pc.results[i], metrics=plain_metrics[i]), "k0",
                          prob_tol=CLI_PROB_TOL, sim_tol=CLI_SIM_TOL)
    for what, run in (("kernels", kern), ("plain", plain)):
        print(_run_line(f"retrieval ({what}, prefetch_depth 2, n_workers 0)", run,
                        CLI_TRAIN_BATCH, card), flush=True)
        print(f"[cli-train] retrieval ({what}) validate s: "
              + ", ".join(f"{t:.3f}" for t in _LoopClock.seconds(run["clock"].validates))
              + "; R@1/5/10 t2v: " + ", ".join(
                  "/".join(str(m["text2video"][f"r{k}"]) for k in (1, 5, 10))
                  for m in (metrics if what == "kernels" else plain_metrics)), flush=True)
    print(f"[cli-train] retrieval (kernels) launches {kern['counts']}", flush=True)
    reference = dict(cfg=ret_cfg, per_validate=per_validate, metrics=kern["metrics"][:4],
                     validate=kc.results[0])
    size = (Path(out) / "restore" / f"{_slot_of(out, CLI_TRAIN_STEPS)}.pt").stat().st_size
    sync_dir = root / "sync"
    restorer = TrainingRestorer(str(sync_dir), save_steps=1, async_save=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restorer.save(kern["state"])
    sync_s = time.perf_counter() - t0
    print(f"[cli-train] resume save: async blocks the loop "
          + " / ".join(f"{t:.3f}" for t in _LoopClock.seconds(kc.resume_s))
          + f" s (the host snapshot), sync {sync_s:.3f} s; checkpoint {size / 1e9:.3f} GB "
          f"(parameters, mu, nu in fp32); deploy save "
          + ", ".join(f"{t:.3f}" for t in _LoopClock.seconds(kc.deploy_s)) + f" s [{card}]",
          flush=True)
    shutil.rmtree(sync_dir)
    del kern["state"], plain["state"], restorer
    torch.cuda.empty_cache()

    # ---- (b) resume from step 4's slot, then inference on step 8 ----
    slot8, slot4 = _slot_of(out, CLI_TRAIN_STEPS), _slot_of(out, CLI_TRAIN_STEPS // 2)
    (Path(out) / "restore" / f"{slot8}.done").unlink()
    (Path(out) / "restore" / f"{slot8}.pt").unlink()
    saved4 = torch.load(Path(out) / "restore" / f"{slot4}.pt", map_location="cpu",
                        weights_only=True)
    want = _cli_train_launches(CLI_TRAIN_STEPS // 2, 24, 2 * per_validate[0],
                               2 * per_validate[1])
    res = _train_run(run_video_retrieval, dict(ret_cfg, output_dir=out), want,
                     "retrieval resumed")
    for k, v in res["counts"].items():
        total[k] += v
    snap, devices = res["clock"].restored
    bad = _same_snapshot(snap, saved4)
    fail_if(bool(bad) or devices != {"cuda"},
            f"resume: restored state differs from slot {slot4} at {bad[:5]} ({devices})")
    fail_if(res["state"].step != CLI_TRAIN_STEPS or len(res["metrics"]) != CLI_TRAIN_STEPS // 2,
            f"resume: ended at {res['state'].step} after {len(res['metrics'])} steps")
    fail_if(not (Path(out) / "ckpt" / f"model_step_{CLI_TRAIN_STEPS}.pt").exists(),
            "resume: no model_step_8.pt")
    final = run_video_retrieval.eval_retrieval(res["clock"].results[-1],
                                               _gt_of(res["clock"].results[-1]))
    print(f"[cli-train] resumed from slot {slot4} (step {snap['step']}, count "
          f"{snap['count']}): {len(saved4['params'])} parameters, {len(saved4['mu'])} mu and "
          f"nu bit-equal on the card; ran steps {snap['step'] + 1}-{res['state'].step}; final "
          f"validate {json.dumps(final)}", flush=True)
    print(_run_line("retrieval resumed", res, CLI_TRAIN_BATCH, card), flush=True)
    del res["state"]
    torch.cuda.empty_cache()

    _reset_counts()
    inferred = run_video_retrieval.main(["--config", str(REPO / "configs" / "msrvtt_ret.json"),
                                         "--output_dir", out, "--do_inference", "1",
                                         "--inference_model_step", str(CLI_TRAIN_STEPS),
                                         "--device", "cuda"])
    icounts = _counts()
    fail_if(icounts != _cli_train_launches(0, 0, *per_validate),
            f"inference: launch counts {icounts}")
    fail_if(inferred != final, f"inference_model_step 8 gives {inferred}, the final "
            f"validate {final}")
    print(f"[cli-train] --do_inference 1 --inference_model_step {CLI_TRAIN_STEPS}: "
          f"R@k equal to the resumed run's final validate", flush=True)
    reference["ckpt"] = shutil.move(str(Path(out) / "ckpt" / "model_step_4.pt"),
                                    str(root / "reference_model_step_4.pt"))
    shutil.rmtree(root / "out")

    # ---- (c) the loop with and without the prefetcher ----
    for depth in (2, 0):
        cfg = dict(ret_cfg, output_dir=None, n_workers=4, prefetch_depth=depth,
                   num_valid=1, min_valid_steps=100)
        run = _train_run(run_video_retrieval, cfg,
                         _cli_train_launches(CLI_TRAIN_STEPS, 24, *per_validate),
                         f"retrieval prefetch_depth {depth}")
        for k, v in run["counts"].items():
            total[k] += v
        print(_run_line(f"retrieval (kernels, prefetch_depth {depth}, n_workers 4)", run,
                        CLI_TRAIN_BATCH, card), flush=True)
        del run["state"]
        torch.cuda.empty_cache()

    # ---- (d) MSRVTT-QA finetuning ----
    qa_cfg = json.loads((REPO / "configs" / "msrvtt_qa.json").read_text())
    qa_cfg.update(
        model_config=str(REPO / "configs" / "base_model.json"),
        visual_model_cfg=str(REPO / "configs" / Path(qa_cfg["visual_model_cfg"]).name),
        tokenizer_dir=data["vocab"], device="cuda", do_inference=False,
        e2e_weights_path=None, attn_impl="pallas", train_batch_size=CLI_QA_BATCH,
        num_train_epochs=1, learning_rate=CLI_TRAIN_LR, save_steps_ratio=0.5,
        log_interval=1, frm_sampling_strategy="rand", n_workers=4,
        inference_batch_size=QA_EVAL_BSZ, ans2label_path=data["ans2label"],
        train_datasets=[{"name": "synthetic", "txt": data["qa_train"],
                         "img": data["qa_videos"]}],
        val_datasets=[{"name": "synthetic", "txt": data["qa_ann"], "img": data["qa_videos"]}],
        output_dir=str(root / "out_qa"))
    remat = json.loads(Path(qa_cfg["visual_model_cfg"]).read_text())["gradient_checkpointing"]
    steps = CLI_QA_TRAIN_ROWS // CLI_QA_BATCH
    n_qa = -(-QA_EVAL_QUESTIONS // QA_EVAL_BSZ)
    # 12 spatial, again in the recompute of the checkpointed video tower, + 6 + 6
    qa = _train_run(run_video_qa, qa_cfg, _cli_train_launches(
        steps, 12 * (1 + remat) + 12, n_qa, 2 * n_qa), "qa")
    for k, v in qa["counts"].items():
        total[k] += v
    fail_if(qa["state"].step != steps or qa["state"].opt_state.count != steps // 2,
            f"QA: {qa['state'].step} steps, {qa['state'].opt_state.count} updates")
    print(f"[cli-train] QA (T={qa_cfg['num_frm']}, B={CLI_QA_BATCH}, video tower "
          f"checkpointed: {remat}, remat_policy {qa_cfg.get('remat_policy', 'dots_ln')}, "
          f"accumulation {qa_cfg['gradient_accumulation_steps']}): losses "
          + ", ".join(f"{m['loss']:.5f}" for m in qa["metrics"])
          + f"; validate s {_LoopClock.seconds(qa['clock'].validates)}; launches "
          f"{qa['counts']}", flush=True)
    print(_run_line("QA (kernels)", qa, CLI_QA_BATCH, card), flush=True)
    del qa["state"]
    torch.cuda.empty_cache()
    return total, reference


# ---- phase 12: pretraining and the prompter through their CLIs ----
# configs/pretrain_alpro.json at one card's share: B 16 (256 over 16 GPUs
# published), 8 steps, one hard-negative block (16 published), lr 2e-4 (twice
# the config's), 4 frames of 224², 1000 entities (12 000 prompts a bank)
PT_VIDEOS, PT_IMAGES, PT_BATCH, PT_STEPS, PT_LR = 64, 64, 16, 8, 2e-4
PT_ENTITIES, PT_CHUNK, PT_VAL_BATCHES = 1000, 512, 2
# launches a step under --attn_impl pallas: the prompter's 12 spatial + 6
# text B13; the student's 12 spatial + 6 text + 6 VTM fusion + 6 MLM text + 6
# MLM fusion B13; the teacher's crop forward (eval) 12 B13, 12 K2 and 24 K3
PT_PROMPTER_B13, PT_STUDENT_B13 = 18, 36
# kernel run vs plain run of the same steps (same data, seed, init and hard
# negatives; dropout and drop-path 0). Measured (NVIDIA H100 80GB HBM3 at
# 700 W, two runs in one call, bit-equal): step 1's itc_loss 1.67e-3 and
# mlm_loss 3.9e-4 apart; from a random init at lr 2e-4 the trajectory is
# chaotic (itc 2.8, 3.9, 6.3, ...), so over 8 steps 1.25e-1 and 7.3e-3; the
# banks 6.0e-4; the teacher's soft labels 3.8e-6. Each tolerance about
# twice its reading. With an 8-step teacher the 1000 soft labels are
# near-uniform (the largest 1.0e-3, every row under the 0.2 threshold) and
# the argmax agreed on 25.6% of the rows: it must agree on every row whose
# plain labels decide it (top-1 over top-2 by more than twice PT_SOFT_TOL,
# which no error within the tolerance can flip) and on a least
# PT_ARGMAX_SHARE of all rows. Since every row is ignored, the step's
# mpm_loss is 0 on both paths; ``mpm_all``, the MPM loss with no row
# ignored (each step's and each validate batch's), holds the MPM head, the
# erased rows' mean and the soft cross entropy instead. Measured in one
# call before these two were fixed: itm_loss 9.2e-5 at step 1, 1.80e-2 over
# 8 steps; mpm_all 6.2e-6 and 5.2e-5 (over the 8 steps and 2 batches)
PT_STEP1_TOL = {"itc_loss": 3.5e-3, "itm_loss": 2e-4, "mlm_loss": 8e-4, "mpm_all": 1.3e-5}
PT_TRAJ_TOL = {"itc_loss": 0.25, "itm_loss": 4e-2, "mlm_loss": 1.5e-2, "mpm_all": 1.1e-4}
PT_BANK_TOL, PT_SOFT_TOL, PT_ARGMAX_SHARE = 1.2e-3, 8e-6, 0.2


def _entity_words(n: int) -> list:
    """n distinct letter-only words ('entaa', 'entab', ...)."""
    return ["ent" + chr(97 + i // 26 % 26) + chr(97 + i % 26) + chr(97 + i // 676)
            for i in range(n)]


def _write_pretrain_data(root: Path, data: dict) -> dict:
    """The pretraining sets beside phases 10-11's: PT_VIDEOS planted clips
    (EVAL_SRC_FRAMES frames at 240 × 320) and PT_IMAGES planted .npy images
    (240 × 320), one caption each over EVAL_WORDS and the entities; an
    entity file of PT_ENTITIES words (``word count`` lines), which the vocab
    holds too."""
    from alpro_tpu_torch.data.tokenization import make_test_vocab

    rng = np.random.RandomState(SEED + 40)
    entities = _entity_words(PT_ENTITIES)
    words = EVAL_WORDS + entities[:200]
    (root / "unigrams.txt").write_text("".join(f"{e} {PT_ENTITIES - i}\n"
                                               for i, e in enumerate(entities)))
    (root / "pt_vocab.txt").write_text("".join(t + "\n" for t in
                                               make_test_vocab(EVAL_WORDS + entities)))
    out = {}
    for name, n, frames in (("pt_videos", PT_VIDEOS, EVAL_SRC_FRAMES), ("pt_images", PT_IMAGES, 1)):
        d = root / name
        d.mkdir()
        with open(root / f"{name}.jsonl", "w") as f:
            for i in range(n):
                clip = _planted_clip(rng, frames)
                np.save(d / f"{name[3]}{i:03d}.npy", clip if frames > 1 else clip[0])
                caption = " ".join(rng.choice(words, size=int(rng.randint(4, 14))))
                f.write(json.dumps({"vid_id": f"{name[3]}{i:03d}", "txt": caption}) + "\n")
        out[name] = {"name": name, "ann": str(root / f"{name}.jsonl"), "img": str(d),
                     "type": "video" if frames > 1 else "image"}
    return dict(data, pt_video=out["pt_videos"], pt_image=out["pt_images"],
                entities=str(root / "unigrams.txt"), pt_vocab=str(root / "pt_vocab.txt"))


class _PretrainProbe:
    """Inside a pretraining CLI run: the banks (host copies) and the
    seconds to build them, the teacher's weights as built, each call of the
    teacher's pseudo-labelling (its seconds between two synchronizes, its
    soft labels and its ignore mask), and each MPM loss's value with no row
    ignored (``mpm_all``: the student's MPM logits against the soft labels
    of every row, computed beside the step's own loss, outside its graph)."""

    def __enter__(self):
        from alpro_tpu_torch.cli import run_pretrain
        from alpro_tpu_torch.train import step as train_step

        self.banks, self.bank_s, self.teacher, self.labels, self.teacher_s = {}, 0.0, None, [], []
        self.mpm_all = []
        self._saved = [(run_pretrain, "setup_prompt_banks"), (run_pretrain, "build_teacher"),
                       (train_step, "_teacher_pseudo_labels"), (train_step, "mpm_loss")]
        self._saved = [(m, n, getattr(m, n)) for m, n in self._saved]
        banks, build, label, mpm = (f for _, _, f in self._saved)

        def timed_banks(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = banks(*args, **kwargs)
            torch.cuda.synchronize()
            self.bank_s = time.perf_counter() - t0
            self.banks = {k: v.detach().float().cpu() for k, v in out.items()}
            return out

        def built(*args, **kwargs):
            teacher = build(*args, **kwargs)
            self.teacher = {k: v.detach().cpu().clone() for k, v in teacher.state_dict().items()}
            return teacher

        def labelling(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            soft, ignore = label(*args, **kwargs)
            torch.cuda.synchronize()
            self.teacher_s.append(time.perf_counter() - t0)
            self.labels.append((soft.float().cpu(), ignore.cpu()))
            return soft, ignore

        def mpm_kept(logits, soft, ignore, group=None, kept=None):
            with torch.no_grad():
                self.mpm_all.append(mpm(logits, soft, torch.zeros_like(ignore), group=group))
            return mpm(logits, soft, ignore, group=group, kept=kept)

        for (m, n, _), fn in zip(self._saved, (timed_banks, built, labelling, mpm_kept)):
            setattr(m, n, fn)
        return self

    def __exit__(self, *exc):
        for m, n, fn in self._saved:
            setattr(m, n, fn)


def _pretrain_launches(steps: int, val_batches: int, banks: int) -> dict:
    """A pretraining CLI run under attn_impl='pallas': per step
    PT_STUDENT_B13 + the teacher's 12 B13, 12 K2, 24 K3; per eval batch
    (every tower in eval) the student's and the teacher's video towers (12
    B13, 12 K2, 24 K3 each) and the student's text, VTM fusion, MLM text and
    MLM fusion calls (6 K4 and 6 K5 each); per bank 6 K4 and 6 K5 a chunk of
    PT_CHUNK prompts."""
    want = {k: 0 for k in KERNEL_TOL}
    chunks = -(-12 * PT_ENTITIES // PT_CHUNK)
    want["masked_attn_bshd"] = steps * (PT_STUDENT_B13 + 12) + val_batches * 24
    want["temporal_attn"] = steps * 12 + val_batches * 24
    want["ln_mlp"] = steps * 24 + val_batches * 48
    want["bert_attn"] = want["bert_mlp"] = banks * chunks * 6 + val_batches * 24
    return want


def _pretrain_cfgs(data: dict) -> tuple:
    """(prompter, pretrain) configs: the shipped pretraining configs with
    the cuts of this phase, dropout and drop-path 0, --attn_impl pallas."""
    common = dict(model_config=data["bert_nodrop"], visual_model_cfg=data["vis_nodrop"],
                  tokenizer_dir=data["pt_vocab"], device="cuda", attn_impl="pallas",
                  train_batch_size=PT_BATCH, learning_rate=PT_LR, save_steps_ratio=0.5,
                  num_valid=1, min_valid_steps=1, log_interval=1, n_workers=0,
                  e2e_weights_path=None)
    prompter = json.loads((REPO / "configs" / "pretrain_prompter.json").read_text())
    prompter.update(common, num_train_epochs=PT_STEPS * PT_BATCH // PT_VIDEOS,
                    train_datasets=[data["pt_video"]], val_datasets=[])
    pretrain = json.loads((REPO / "configs" / "pretrain_alpro.json").read_text())
    pretrain.update(common, num_train_epochs=1, vtm_negative_blocks=1,
                    entity_file_path=data["entities"], num_entities=PT_ENTITIES,
                    prompt_chunk_size=PT_CHUNK, num_val_batches=PT_VAL_BATCHES,
                    train_datasets=[data["pt_video"], data["pt_image"]],
                    val_datasets=[{"name": "val", "ann": data["ret_ann"],
                                   "img": data["ret_videos"], "type": "video"}])
    return prompter, pretrain


def _pt_line(what: str, run: dict, probe, card: str) -> str:
    c = run["clock"]
    mix = collections.Counter(extras[0] if extras else "video" for extras in c.extras)
    out = _run_line(what, run, PT_BATCH, card) + f"; MetaLoader mix {dict(mix)}"
    if probe is not None and probe.teacher_s:
        share = [t / s for t, s in zip(probe.teacher_s, c.steps)]
        ignored = torch.cat([ig for _, ig in probe.labels[:len(c.steps)]]).float().mean()
        out += (f"; teacher's crop forward {statistics.median(share) * 100:.1f}% of a step "
                f"(median of {len(share)}); banks {probe.bank_s:.3f} s; MPM rows ignored "
                f"{float(ignored) * 100:.1f}%; validate s "
                + ", ".join(f"{t:.3f}" for t in _LoopClock.seconds(c.validates)))
    return out


def _pt_run(cli, cfg: dict, want: dict, what: str, plain: bool = False, negatives=None):
    with _PretrainProbe() as probe:
        run = _train_run(cli, cfg, want, what, plain=plain, negatives=negatives)
    return run, probe


def phase_pretrain_cli(card: str) -> dict:
    """Pretraining through the CLIs on the card at ALPRO-base width
    (``configs/pretrain_prompter.json`` and ``configs/pretrain_alpro.json``
    with this phase's cuts). (a) The prompter, 8 steps at B = 16, under
    ``--attn_impl pallas`` and on the plain path: exact counts, finite
    losses; its ``model_step_8.pt`` is the teacher. (b) Pretraining (video +
    image, all four objectives, 1000 entities), 8 steps, ``validate`` at the
    end over 2 batches, resume saves at 4 and 8, under pallas and on the
    plain path (the hard negatives replayed): exact counts, finite losses,
    each step's itc_loss, itm_loss, mlm_loss and MPM loss with no row
    ignored within PT_STEP1_TOL at step 1 and PT_TRAJ_TOL after, the
    banks within PT_BANK_TOL, the pseudo-label argmax agreeing on
    PT_ARGMAX_SHARE of the rows. (c) Resume: step 8's slot removed, the CLI
    run again: step 4's slot restored bit for bit, the teacher and the banks
    rebuilt bit-equal, the run ends at 8. (d) ``run_video_retrieval``
    finetunes 2 steps from the pretraining ``model_step_8.pt``: the tensors
    it loads equal the saved ones bit for bit, the MLM and MPM keys
    skipped. Returns the pretraining CLIs' kernel runs' counts, summed."""
    import tempfile

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="alpro_pretrain_") as tmp:
        root = Path(tmp)
        data = _write_eval_data(root, EVAL_WORDS)
        data = _write_pretrain_data(root, _write_train_data(root, EVAL_WORDS, data))
        total = _pretrain_cli_runs(card, data, root)
    print(f"[pretrain] phase 12: {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return total


def _pretrain_cli_runs(card: str, data: dict, root: Path) -> dict:
    from alpro_tpu_torch.checkpoint.reference import load_reference_checkpoint
    from alpro_tpu_torch.cli import common, run_pretrain, run_prompter, run_video_retrieval

    total = {k: 0 for k in KERNEL_TOL}
    zero = {k: 0 for k in KERNEL_TOL}
    prompter_cfg, pretrain_cfg = _pretrain_cfgs(data)
    out_p, out = str(root / "pt_out" / "prompter"), str(root / "pt_out" / "pretrain")

    # ---- (a) the prompter ----
    want = {**zero, "masked_attn_bshd": PT_STEPS * PT_PROMPTER_B13}
    kern = _train_run(run_prompter, dict(prompter_cfg, output_dir=out_p), want,
                      "prompter (kernels)")
    plain = _train_run(run_prompter, dict(prompter_cfg, output_dir=None), zero,
                       "prompter (plain)", plain=True)
    for k, v in kern["counts"].items():
        total[k] += v
    teacher_pt = Path(out_p) / "ckpt" / f"model_step_{PT_STEPS}.pt"
    fail_if(kern["state"].step != PT_STEPS or not teacher_pt.exists(),
            f"prompter: {kern['state'].step} steps, {teacher_pt.name} written: "
            f"{teacher_pt.exists()}")
    loss = [(m["loss"], p["loss"]) for m, p in zip(kern["metrics"], plain["metrics"])]
    print("[pretrain] prompter loss per step, kernels / plain: "
          + ", ".join(f"{a:.5f}/{b:.5f}" for a, b in loss)
          + f"; max |diff| {max(abs(a - b) for a, b in loss):.3e}", flush=True)
    for what, run in (("kernels", kern), ("plain", plain)):
        print(_pt_line(f"prompter ({what})", run, None, card), flush=True)
    del kern["state"], plain["state"]
    torch.cuda.empty_cache()

    # ---- (b) pretraining, kernels and plain ----
    pretrain_cfg["teacher_weights_path"] = str(teacher_pt)
    negatives = []
    want = _pretrain_launches(PT_STEPS, PT_VAL_BATCHES, 2)
    kern, kprobe = _pt_run(run_pretrain, dict(pretrain_cfg, output_dir=out), want,
                           "pretrain (kernels)", negatives=negatives)
    n_neg = len(negatives)
    plain, pprobe = _pt_run(run_pretrain, dict(pretrain_cfg, output_dir=None), zero,
                            "pretrain (plain)", plain=True, negatives=negatives)
    fail_if(n_neg != PT_STEPS + PT_VAL_BATCHES, f"{n_neg} hard-negative draws")
    for k, v in kern["counts"].items():
        total[k] += v
    fail_if(kern["state"].step != PT_STEPS or len(kern["metrics"]) != PT_STEPS,
            f"pretrain: {kern['state'].step} steps")
    logged = _logged(out, "train_")
    keys = {k for _, k, _ in logged}
    fail_if(keys != {"train_itc_loss", "train_itm_loss", "train_mlm_loss", "train_mpm_loss",
                     "train_mpm_kept", "train_loss"} or len(logged) != 6 * PT_STEPS
            or not all(np.isfinite(v) for *_, v in logged), f"pretrain: logged losses {logged}")
    late = []  # the comparisons' failures, raised once everything is printed
    for key, tol in PT_TRAJ_TOL.items():
        if key == "mpm_all":  # each step's, then each validate batch's
            pairs = [(float(a), float(b)) for a, b in zip(kprobe.mpm_all, pprobe.mpm_all)]
            n_want = PT_STEPS + PT_VAL_BATCHES
        else:
            pairs = [(m[key], p[key]) for m, p in zip(kern["metrics"], plain["metrics"])]
            n_want = PT_STEPS
        worst, first = max(abs(a - b) for a, b in pairs), abs(pairs[0][0] - pairs[0][1])
        print(f"[pretrain] {key} per step, kernels / plain: "
              + ", ".join(f"{a:.5f}/{b:.5f}" for a, b in pairs)
              + f"; step 1 |diff| {first:.3e} (tol {PT_STEP1_TOL[key]}), max {worst:.3e} "
              f"(tol {tol})", flush=True)
        if (worst > tol or first > PT_STEP1_TOL[key] or len(pairs) != n_want
                or not all(np.isfinite(a) and a > 0 for pair in pairs for a in pair)):
            late.append(f"pretrain: {key} kernel vs plain differs by {first} at step 1, {worst} "
                        f"over {len(pairs)} of {n_want}")
    print("[pretrain] kernels: mpm_loss (rows ignored as the step ignores them) "
          + ", ".join(f"{m['mpm_loss']:.5f}" for m in kern["metrics"]), flush=True)
    bank_gap = max(float((kprobe.banks[k] - pprobe.banks[k]).abs().max()) for k in kprobe.banks)
    if sorted(kprobe.banks) != ["image", "video"] or bank_gap > PT_BANK_TOL or any(
            tuple(b.shape) != (PT_ENTITIES, 256) for b in kprobe.banks.values()):
        late.append(f"banks: kernel vs plain {bank_gap} (tol {PT_BANK_TOL})")
    ksoft = torch.cat([soft for soft, _ in kprobe.labels])
    psoft = torch.cat([soft for soft, _ in pprobe.labels])
    soft_gap = float((ksoft - psoft).abs().max())
    agree = ksoft.argmax(dim=1) == psoft.argmax(dim=1)
    top2 = psoft.topk(2, dim=1).values
    decided = top2[:, 0] - top2[:, 1] > 2 * PT_SOFT_TOL  # no kernel error can flip these
    share = float(agree.float().mean())
    print(f"[pretrain] banks kernel vs plain max |diff| {bank_gap:.3e} (tol {PT_BANK_TOL}); "
          f"soft labels max |diff| {soft_gap:.3e} (tol {PT_SOFT_TOL}), largest "
          f"{float(psoft.max()):.4f}; pseudo-label argmax agreeing on {share * 100:.1f}% of "
          f"{agree.numel()} rows (least {PT_ARGMAX_SHARE * 100:.0f}%), on "
          f"{int(agree[decided].sum())} of the {int(decided.sum())} rows the plain labels "
          f"decide; validate {json.dumps(kern['clock'].results)}", flush=True)
    if soft_gap > PT_SOFT_TOL or share < PT_ARGMAX_SHARE or not bool(agree[decided].all()):
        late.append(f"pseudo-labels: soft labels differ by {soft_gap}, argmax agrees on {share}")
    fail_if(len(kern["clock"].results) != 1 or not all(
        np.isfinite(v) for v in kern["clock"].results[0].values()), "pretrain: validate")
    for what, run, probe in (("kernels", kern, kprobe), ("plain", plain, pprobe)):
        print(_pt_line(f"pretrain ({what})", run, probe, card), flush=True)
    print(f"[pretrain] pretrain (kernels) launches {kern['counts']}", flush=True)
    fail_if(bool(late), "; ".join(late))
    del kern["state"], plain["state"]
    torch.cuda.empty_cache()

    # ---- (c) resume from step 4's slot ----
    slot8, slot4 = _slot_of(out, PT_STEPS), _slot_of(out, PT_STEPS // 2)
    (Path(out) / "restore" / f"{slot8}.done").unlink()
    (Path(out) / "restore" / f"{slot8}.pt").unlink()
    saved4 = torch.load(Path(out) / "restore" / f"{slot4}.pt", map_location="cpu",
                        weights_only=True)
    res, rprobe = _pt_run(run_pretrain, dict(pretrain_cfg, output_dir=out),
                          _pretrain_launches(PT_STEPS // 2, PT_VAL_BATCHES, 2), "pretrain resumed")
    for k, v in res["counts"].items():
        total[k] += v
    snap, devices = res["clock"].restored
    bad = _same_snapshot(snap, saved4)
    fail_if(bool(bad) or devices != {"cuda"},
            f"resume: restored state differs from slot {slot4} at {bad[:5]} ({devices})")
    rebuilt = [k for k, v in kprobe.teacher.items() if not torch.equal(v, rprobe.teacher[k])]
    rebuilt += [k for k, v in kprobe.banks.items() if not torch.equal(v, rprobe.banks[k])]
    fail_if(bool(rebuilt) or len(rprobe.teacher) != len(kprobe.teacher),
            f"resume: teacher or banks rebuilt differently: {rebuilt[:5]}")
    fail_if(res["state"].step != PT_STEPS or len(res["metrics"]) != PT_STEPS // 2
            or not (Path(out) / "ckpt" / f"model_step_{PT_STEPS}.pt").exists(),
            f"resume: ended at {res['state'].step} after {len(res['metrics'])} steps")
    print(f"[pretrain] resumed from slot {slot4} (step {snap['step']}): {len(saved4['params'])} "
          f"parameters, mu and nu bit-equal on the card; teacher ({len(rprobe.teacher)} tensors) "
          f"and both banks rebuilt bit-equal; ran steps {snap['step'] + 1}-{res['state'].step}",
          flush=True)
    print(_pt_line("pretrain resumed", res, rprobe, card), flush=True)
    del res["state"]
    torch.cuda.empty_cache()

    # ---- (d) retrieval finetuning from the pretraining checkpoint ----
    pt_ckpt = Path(out) / "ckpt" / f"model_step_{PT_STEPS}.pt"
    ret_cfg = json.loads((REPO / "configs" / "msrvtt_ret.json").read_text())
    ret_cfg.update(
        model_config=data["bert_nodrop"], visual_model_cfg=data["vis_nodrop"],
        tokenizer_dir=data["vocab"], device="cuda", do_inference=False,
        e2e_weights_path=str(pt_ckpt), attn_impl="pallas", train_batch_size=CLI_TRAIN_BATCH,
        vtm_negative_blocks=1, num_train_epochs=1, learning_rate=CLI_TRAIN_LR,
        data_ratio=2 * CLI_TRAIN_BATCH / CLI_TRAIN_VIDEOS, num_valid=1, min_valid_steps=100,
        log_interval=1, frm_sampling_strategy="rand", n_workers=0,
        inference_batch_size=EVAL_TXT_BSZ, eval_video_batch_size=EVAL_VID_BSZ,
        inference_txt_db=None, inference_img_db=None, output_dir=None,
        train_datasets=[{"name": "synthetic", "txt": data["ret_train"],
                         "img": data["ret_train_videos"]}],
        val_datasets=[{"name": "synthetic", "txt": data["ret_ann"], "img": data["ret_videos"]}])
    merge, merged = common.merge_state_dict, []

    def recording_merge(model, sd):
        report = merge(model, sd)
        merged.append((report, {k: v.detach().cpu().clone() for k, v in
                                model.named_parameters()}))
        return report

    n_vb, n_tc = -(-EVAL_VIDEOS // EVAL_VID_BSZ), -(-EVAL_TEXTS // EVAL_TXT_BSZ)
    common.merge_state_dict = recording_merge
    try:
        ft = _train_run(run_video_retrieval, ret_cfg,
                        _cli_train_launches(2, 24, n_vb, n_tc + n_vb * n_tc),
                        "finetune from pretraining")
    finally:
        common.merge_state_dict = merge
    (report, start), = merged
    saved, _ = load_reference_checkpoint(str(pt_ckpt), num_patches=PATCHES, num_frames=8)
    from alpro_tpu_torch.checkpoint.load import _to_port_keys

    saved = _to_port_keys(saved)
    heads = sorted(k for k in saved if k.startswith(("text_encoder.cls.", "mpm_head.")))
    skipped = sorted(s.split(" ")[0] for s in report["skipped"])
    differ = [k for k, v in start.items() if not torch.equal(v, saved[k].to(v.dtype))]
    fail_if(skipped != heads or report["missing"] or differ,
            f"finetune load: skipped {skipped[:4]} (heads {heads[:4]}), missing "
            f"{report['missing'][:4]}, differ {differ[:4]}")
    fail_if(ft["state"].step != 2, f"finetune: {ft['state'].step} steps")
    print(f"[pretrain] finetune from model_step_{PT_STEPS}.pt: {len(start)} tensors loaded bit for "
          f"bit (time_embed resized 4 -> 8 frames), {len(heads)} MLM/MPM keys skipped and "
          f"logged; losses " + ", ".join(f"{m['loss']:.5f}" for m in ft["metrics"]), flush=True)
    del ft["state"]
    torch.cuda.empty_cache()
    return total


# ---- phase 13: int8 weights, the joint and space-only towers, the remat policies ----
# int8 against bf16: tests/test_quant.py's envelope for VTC similarities and
# P(match); the gallery's top-k ids must agree where the bf16 similarities
# leave the k-th candidate apart from the (k+1)-th by more than twice it
INT8_TOL, INT8_GALLERY, INT8_TOPK = 0.05, 64, 8
# QA: int8 against bf16 answers (pooled over 2 clips, 1500 near-uniform
# labels), fixed from one measurement call on the H100 (prob 2.4e-5, log-prob
# 2.8e-2 there)
INT8_QA_TOL = {"prob": 1e-4, "logp": 1e-1}
# joint and space-only towers (12 bf16 blocks) with K1 and K3 against the
# plain path: the largest difference over the largest entry
VARIANT_TOL = 5e-2
# remat: one QA step (video tower depth 2, checkpointed; BERT 2 layers)
# under each policy against the step without checkpointing: the recompute
# replays the forward's ops on the same inputs, so the loss and the whole
# gradient may differ only by this (relative L2)
REMAT_DEPTH, REMAT_GRAD_TOL = 2, 1e-5


def _planted_224(rng, n: int, frames: int) -> np.ndarray:
    """n planted clips (``_planted_clip``) cropped to 224², uint8."""
    return np.stack([_planted_clip(rng, frames)[:, 8:232, 48:272] for _ in range(n)])


def _peak_bytes(fn):
    """(fn(), the call's peak device bytes above what was allocated before it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - before


def _counted(fn, want: dict, what: str, into: dict):
    """fn() with the counts set to 0 just before it and read just after;
    they must equal ``want`` and are added to ``into``."""
    _reset_counts()
    out = fn()
    torch.cuda.synchronize()
    got = _counts()
    fail_if(got != want, f"{what}: launch counts {got} != {want}")
    for k, n in got.items():
        into[k] = into.get(k, 0) + n
    return out


def _topk_agrees(got: set, sims: dict, k: int, tol: float, what: str) -> bool:
    """int8's top-k ids against the bf16 similarities of the whole gallery:
    every id that bf16 puts more than 2·tol above the (k+1)-th is in it,
    none more than 2·tol below the k-th. Returns whether the sets are equal."""
    ranked = sorted(sims, key=lambda v: -sims[v])
    kth, next_ = sims[ranked[k - 1]], sims[ranked[k]]
    sure_in = {v for v in ranked if sims[v] > next_ + 2 * tol}
    sure_out = {v for v in ranked if sims[v] < kth - 2 * tol}
    fail_if(not sure_in <= got or got & sure_out,
            f"{what}: top-{k} {sorted(got)} misses {sorted(sure_in - got)} or holds "
            f"{sorted(got & sure_out)}")
    return got == set(ranked[:k])


def _int8_retrieval(card: str, launches: dict) -> dict:
    """RetrievalIndex with weights='int8' against 'bf16' at ALPRO-base: the
    weights' bytes at rest, each call's peak, a 64-clip planted gallery's
    top-k, VTC similarities and P(match), the launches per call, times; and
    int8 with its kernels against int8 on the plain path."""
    import gc

    from alpro_tpu_torch.models.alpro import build_retrieval_model
    from alpro_tpu_torch.ops.quant import quantized_weights
    from alpro_tpu_torch.serving.retrieval import RetrievalIndex

    vis_json = "timesformer_divst_8x32_224_k600.json"
    gc.collect()
    torch.cuda.empty_cache()
    m0 = torch.cuda.memory_allocated()
    model = _build_model(build_retrieval_model, vis_json, FRAMES)
    bf16_bytes = torch.cuda.memory_allocated() - m0
    n_params = sum(p.numel() for p in model.parameters())
    n_quant = sum(getattr(dict(model.named_modules())[m], p).numel()
                  for m, p, _ in quantized_weights(model))
    tok = HashTokenizer(model.cfg.bert.vocab_size)
    m1 = torch.cuda.memory_allocated()
    src = _build_model(build_retrieval_model, vis_json, FRAMES)  # the same seeded weights
    idx8 = RetrievalIndex(src, tok, "cuda", max_txt_len=40, topk=INT8_TOPK, weights="int8")
    del src
    gc.collect()
    int8_bytes = torch.cuda.memory_allocated() - m1
    fail_if(any(p.dtype not in (torch.int8, torch.bfloat16) for p in idx8.model.parameters()),
            "int8 model: a parameter neither int8 nor bf16")
    print(f"[int8] weights at rest: bf16 {bf16_bytes / 2 ** 30:.4f} GiB, int8 "
          f"{int8_bytes / 2 ** 30:.4f} GiB ({int8_bytes / bf16_bytes:.3f} of bf16); "
          f"{n_quant / 1e6:.2f} M of {n_params / 1e6:.2f} M parameters quantized [{card}]",
          flush=True)
    fail_if(int8_bytes >= 0.6 * bf16_bytes, f"int8 at rest {int8_bytes} >= 0.6 x {bf16_bytes}")

    idx16 = RetrievalIndex(model, tok, "cuda", max_txt_len=40, topk=INT8_TOPK)
    clips = _planted_224(np.random.RandomState(SEED + 13), INT8_GALLERY, FRAMES)
    ids = [f"g{i:02d}" for i in range(INT8_GALLERY)]
    out = {}
    for name, idx in (("bf16", idx16), ("int8", idx8)):
        _warm(idx.model, (idx.model.visual_encoder.model.cfg, idx.model.text_encoder.bert.cfg),
              tok, clips)
        _, add_peak = _peak_bytes(lambda: _counted(
            lambda: idx.add_videos(clips[:CLIPS_PER_CALL], ids[:CLIPS_PER_CALL]),
            _launches(video_calls=1), f"{name} add_videos", launches))
        t0 = time.perf_counter()
        _counted(lambda: [idx.add_videos(clips[lo:lo + CLIPS_PER_CALL], ids[lo:lo + CLIPS_PER_CALL])
                          for lo in range(CLIPS_PER_CALL, INT8_GALLERY, CLIPS_PER_CALL)],
                 _launches(video_calls=INT8_GALLERY // CLIPS_PER_CALL - 1),
                 f"{name} add_videos", launches)
        clips_per_s = (INT8_GALLERY - CLIPS_PER_CALL) / (time.perf_counter() - t0)
        idx.query(TEXTS[0])
        top, q_peak = _peak_bytes(lambda: _counted(lambda: [idx.query(t) for t in TEXTS],
                                                   _launches(text_calls=len(TEXTS)),
                                                   f"{name} query", launches))
        full = _counted(lambda: [idx.query(t, topk=INT8_GALLERY) for t in TEXTS],
                        _launches(text_calls=len(TEXTS)), f"{name} query (whole gallery)",
                        launches)
        q_ms = _query_ms(idx)
        out[name] = dict(top=top, full=full, feats=idx._banks()[0])
        print(f"[int8] {name}: add_videos {clips_per_s:.2f} clips/s, peak {add_peak / 2 ** 20:.1f} "
              f"MiB a call ({CLIPS_PER_CALL} clips); query p50 {statistics.median(q_ms):.2f} ms, "
              f"peak {q_peak / 2 ** 20:.1f} MiB over {len(TEXTS)} calls (topk {INT8_TOPK}, gallery "
              f"{INT8_GALLERY}) [{card}]", flush=True)
    sim_err = prob_err = 0.0
    exact = 0
    for t, a, b, fa, fb in zip(TEXTS, out["int8"]["top"], out["bf16"]["top"],
                               out["int8"]["full"], out["bf16"]["full"]):
        s8, s16 = {v: s for v, _, s in fa}, {v: s for v, _, s in fb}
        p8, p16 = {v: p for v, p, _ in fa}, {v: p for v, p, _ in fb}
        sim_err = max(sim_err, max(abs(s8[v] - s16[v]) for v in s16))
        prob_err = max(prob_err, max(abs(p8[v] - p16[v]) for v in p16))
        exact += _topk_agrees({v for v, _, _ in a}, s16, INT8_TOPK, INT8_TOL, f"int8 {t!r}")
    feat_err = float((out["int8"]["feats"] - out["bf16"]["feats"]).abs().max())
    print(f"[int8] int8 vs bf16: VTC similarity max_abs {sim_err:.3e}, P(match) max_abs "
          f"{prob_err:.3e} (tol {INT8_TOL}), VTC feature max_abs {feat_err:.3e}; top-{INT8_TOPK} "
          f"ids equal for {exact} of {len(TEXTS)} texts", flush=True)
    fail_if(sim_err > INT8_TOL or prob_err > INT8_TOL, "int8 outside the envelope of bf16")

    # int8 with its kernels against int8 on the plain path
    kernel_cfgs = (idx8.model.visual_encoder.model.cfg, idx8.model.text_encoder.bert.cfg)
    _set_path(idx8.model, *_plain_cfgs(idx8.model))
    plain = RetrievalIndex(idx8.model, tok, "cuda", max_txt_len=40, topk=INT8_TOPK)
    before = _counts()
    _fill(plain, clips, ids)
    plain_full = [plain.query(t, topk=INT8_GALLERY) for t in TEXTS]
    fail_if(_counts() != before, "int8 plain path launched kernels")
    _set_path(idx8.model, *kernel_cfgs)
    pfeat_err = float((out["int8"]["feats"] - plain._banks()[0]).abs().max())
    pprob_err = max(abs(dict((v, p) for v, p, _ in a)[v] - p)
                    for a, b in zip(out["int8"]["full"], plain_full) for v, p, _ in b)
    print(f"[int8] int8 kernels vs int8 plain path: VTC feature max_abs {pfeat_err:.3e} (tol "
          f"{PLAIN_FEAT_TOL}), P(match) max_abs {pprob_err:.3e} (tol {PLAIN_PROB_TOL})",
          flush=True)
    fail_if(pfeat_err > PLAIN_FEAT_TOL or pprob_err > PLAIN_PROB_TOL,
            "int8 kernels differ from int8 plain")
    return {"bf16_bytes": bf16_bytes, "int8_bytes": int8_bytes}


def _int8_qa(card: str, launches: dict) -> None:
    """VideoQAPredictor with weights='int8' against 'bf16' on the MSRVTT-QA
    model: answers, exact launches, peaks and times."""
    from alpro_tpu_torch.models.alpro import build_qa_model
    from alpro_tpu_torch.serving.qa import VideoQAPredictor

    qa_cfg = json.loads((REPO / "configs" / "msrvtt_qa.json").read_text())
    L = qa_cfg["num_labels"]
    model = _build_model(build_qa_model, Path(qa_cfg["visual_model_cfg"]).name, QA_FRAMES,
                         num_labels=L, cls_hidden_scale=qa_cfg["cls_hidden_scale"])
    labels = {f"ans{i}": i for i in range(L)}
    tok = HashTokenizer(model.cfg.bert.vocab_size)
    clips = _planted_224(np.random.RandomState(SEED + 14), QA_CLIPS, QA_FRAMES)
    dists = {}
    for name in ("bf16", "int8"):
        qa = VideoQAPredictor(model, tok, labels, "cuda", max_txt_len=QA_TXT_LEN, weights=name)
        for _ in range(2):
            qa.predict_batch(qa.encode_video(clips), QUESTIONS)
        feats, enc_peak = _peak_bytes(lambda: _counted(
            lambda: qa.encode_video(clips), _launches(video_calls=1), f"{name} encode_video",
            launches))
        cached = _counted(lambda: [qa.predict(feats, q, topk=L) for q in QUESTIONS],
                          _launches(text_calls=len(QUESTIONS)), f"{name} predict", launches)
        batched = _counted(lambda: qa.predict_batch(feats, QUESTIONS, topk=L),
                           _launches(text_calls=1), f"{name} predict_batch", launches)
        dists[name] = [_answer_dists(a, labels) for a in cached]
        _check_answers([_answer_dists(a, labels) for a in batched], dists[name], QA_BATCH_TOL,
                       f"{name} predict_batch vs predict")
        med = statistics.median
        print(f"[int8] QA {name}: encode_video {med(_host_ms(lambda: qa.encode_video(clips), 5)):.2f}"
              f" ms (peak {enc_peak / 2 ** 20:.1f} MiB), cached predict p50 "
              f"{med(_host_ms(lambda: qa.predict(feats, QUESTIONS[0]), 10)):.2f} ms [{card}]",
              flush=True)
    _check_answers(dists["int8"], dists["bf16"], INT8_QA_TOL, "QA int8 vs bf16")


def _attention_types(card: str, res: dict, launches: dict) -> None:
    """The joint and space-only towers (TimeSformer-B/16, 8 x 224², bf16)
    with K1 and K3 against their plain path, exact launches, the poolings'
    shapes; K1 alone at the joint tower's (2, 1569, 2304) against its twin."""
    from alpro_tpu_torch.models.timesformer import TimeSformer, TimeSformerConfig
    from alpro_tpu_torch.ops import qkv_attn

    vis = json.loads((REPO / "configs" / "timesformer_divst_8x32_224_k600.json").read_text())
    clips = torch.from_numpy(_planted_224(np.random.RandomState(SEED + 15), 2, FRAMES)).cuda()
    for at, seq in (("joint_space_time", 1 + FRAMES * PATCHES), ("space_only", 1 + PATCHES)):
        cfg = TimeSformerConfig.from_reference_cfg(vis, 224, FRAMES, attention_type=at)
        tower = _seeded_(TimeSformer(cfg, dtype=torch.bfloat16).cuda(), SEED + 16)
        want = {k: 0 for k in KERNEL_TOL}
        want.update(spatial_attn=12, ln_mlp=12)
        with torch.no_grad():
            tower(clips)
            out = _counted(lambda: tower(clips), want, f"{at} forward", launches)
            ms = statistics.median(_host_ms(lambda: tower(clips), 3))
            shapes = {p: tuple(_counted(lambda: tower(clips, pooling=p), want, f"{at} {p}",
                                        launches).shape) for p in ("spatial", "none")}
            tower.cfg = dataclasses.replace(cfg, attn_impl="plain", mlp_impl="plain")
            before = _counts()
            ref = tower(clips)
            plain_ms = statistics.median(_host_ms(lambda: tower(clips), 3))
            fail_if(_counts() != before, f"{at} plain path launched kernels")
        T = 1 if at == "space_only" else FRAMES
        fail_if(tuple(out.shape) != (2, 1 + PATCHES, 768) or shapes != {
            "spatial": (2, 1 + T, 768), "none": (2, T, 1 + PATCHES, 768)}, f"{at}: shapes "
            f"{tuple(out.shape)}, {shapes}")
        err = float((out.float() - ref.float()).abs().max()) / float(ref.float().abs().max())
        print(f"[variants] {at}: K1 at S = {seq} (12) and K3 (12) a forward; vs the plain path "
              f"max_abs / max|plain| {err:.3e} (tol {VARIANT_TOL}); poolings {shapes}; forward "
              f"{ms:.2f} ms, plain {plain_ms:.2f} ms (2 clips) [{card}]", flush=True)
        fail_if(not bool(torch.isfinite(out.float()).all()) or err > VARIANT_TOL,
                f"{at}: kernel path differs from plain by {err}")
        del tower
    H, hd, M, S = 12, 64, 2, 1 + FRAMES * PATCHES
    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    x = torch.randn((M, S, 3 * H * hd), generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = (x[..., i * H * hd:(i + 1) * H * hd].unflatten(-1, (H, hd)).transpose(1, 2)
               for i in range(3))
    res["spatial_attn"].append(_compare(
        "spatial_attn", x.shape, lambda: qkv_attn.spatial_attention_qkv(x, H),
        lambda: qkv_attn.spatial_attention_plain(x, H, hd ** -0.5), card,
        library=lambda: _sdpa(q, k, v), work=(4 * M * H * S * S * hd, 2 * x.numel() * 4 // 3),
        device=True))


def _remat_policies(card: str, launches: dict) -> None:
    """One QA finetuning step's loss and backward (``train/step.py``
    ``qa_loss``, ``--attn_impl pallas``, dropout on) at ALPRO-base width,
    the video tower at depth REMAT_DEPTH and checkpointed, BERT at 2 layers,
    under each policy against the same step without checkpointing: loss,
    gradients, B13's launches, peak bytes."""
    from alpro_tpu_torch.models.alpro import build_qa_model
    from alpro_tpu_torch.models.remat import REMAT_POLICIES
    from alpro_tpu_torch.train.step import StepContext, qa_loss, step_generator

    qa_cfg = json.loads((REPO / "configs" / "msrvtt_qa.json").read_text())
    from alpro_tpu_torch.models.alpro import init_random_
    from alpro_tpu_torch.models.bert import BertConfig
    from alpro_tpu_torch.models.timesformer import TimeSformerConfig

    vis_json = json.loads((REPO / "configs" / Path(qa_cfg["visual_model_cfg"]).name).read_text())
    fail_if(not vis_json.get("gradient_checkpointing"), "the QA video tower is not checkpointed")
    bert = BertConfig.from_json_dict(dict(
        json.loads((REPO / "configs" / "base_model.json").read_text()),
        num_hidden_layers=2, fusion_layer=1))
    vis_cfg = TimeSformerConfig.from_reference_cfg(vis_json, 224, QA_FRAMES, depth=REMAT_DEPTH)
    with torch.device("meta"):
        model = build_qa_model(bert, vis_cfg, num_labels=qa_cfg["num_labels"], img_size=224,
                               num_frm=QA_FRAMES, dtype=torch.bfloat16, attn_impl="pallas")
    model = init_random_(model.to_empty(device="cuda"),
                         torch.Generator(device="cuda").manual_seed(SEED))
    vis = model.visual_encoder.model
    B = QA_TRAIN_BATCH
    rng = np.random.RandomState(SEED + 18)
    tok = HashTokenizer(model.cfg.bert.vocab_size)(
        [QUESTIONS[i % len(QUESTIONS)] for i in range(B)], max_length=QA_TXT_LEN)
    batch = {"visual_inputs": torch.from_numpy(rng.randint(
                 0, 256, (B, QA_FRAMES, 224, 224, 3), dtype=np.uint8)).cuda(),
             "text_input_ids": torch.from_numpy(tok["input_ids"]).long().cuda(),
             "text_input_mask": torch.from_numpy(tok["attention_mask"]).long().cuda(),
             "labels": torch.from_numpy(rng.randint(0, qa_cfg["num_labels"], B)).cuda()}

    def step(policy):
        vis.cfg = dataclasses.replace(vis.cfg, gradient_checkpointing=policy is not None,
                                      remat_policy=policy or "nothing")
        model.train()
        model.zero_grad(set_to_none=True)
        g = step_generator(SEED, 0, "cuda")
        loss, _ = qa_loss(model, batch, StepContext(g, g))
        loss.backward()
        model.eval()
        return loss.item(), {n: p.grad.float().clone() for n, p in model.named_parameters()
                             if p.grad is not None}

    step(None)
    step("dots_ln")  # warm
    (ref_loss, ref), ref_peak = _peak_bytes(lambda: step(None))
    layers = model.cfg.bert.num_hidden_layers
    print(f"[remat] no checkpointing: loss {ref_loss:.6f}, peak {ref_peak / 2 ** 20:.1f} MiB "
          f"(QA step, video depth {REMAT_DEPTH}, BERT {layers} layers, B = {B}, "
          f"{QA_FRAMES} x 224², attn_impl 'pallas') [{card}]", flush=True)
    for policy in REMAT_POLICIES:
        names = policy in ("names", "dots_names", "dots_ln_names", "dots_ln_offload")
        want = {k: 0 for k in KERNEL_TOL}
        # B13: each spatial attention once, again in the recompute unless kept; BERT's
        want["masked_attn_bshd"] = REMAT_DEPTH * (1 if names else 2) + layers
        (loss, grads), peak = _peak_bytes(lambda: _counted(
            lambda: step(policy), want, f"remat {policy}", launches))
        gap = grad_gaps(grads, ref)
        same = loss == ref_loss and all(torch.equal(grads[n], g) for n, g in ref.items())
        print(f"[remat] {policy}: loss {loss:.6f} (|diff| {abs(loss - ref_loss):.3e}), whole "
              f"gradient rel L2 {gap['whole']:.3e}, worst parameter "
              f"{gap['params'][0][1] if gap['params'] else 0.0:.3e} (tol {REMAT_GRAD_TOL}; "
              f"bit-equal {same}); B13 launches {want['masked_attn_bshd']}; peak "
              f"{peak / 2 ** 20:.1f} MiB [{card}]", flush=True)
        fail_if(set(grads) != set(ref), f"remat {policy}: gradients of other parameters")
        fail_if(abs(loss - ref_loss) > REMAT_GRAD_TOL * abs(ref_loss)
                or gap["whole"] > REMAT_GRAD_TOL, f"remat {policy}: step differs")


def phase_variants(card: str, res: dict) -> dict:
    """Phase 13; returns its launches summed over every counted call."""
    t0 = time.perf_counter()
    launches: dict = {}
    _int8_retrieval(card, launches)
    torch.cuda.empty_cache()
    _int8_qa(card, launches)
    torch.cuda.empty_cache()
    _attention_types(card, res, launches)
    torch.cuda.empty_cache()
    _remat_policies(card, launches)
    torch.cuda.empty_cache()
    print(f"[variants] phase 13 took {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# ---- phase 14: torch.distributed at one process under NCCL ----
# the wrapped step (train/step.py::shard_step) against the unwrapped one:
# DIST_STEPS bit-equal steps each in turns, the wall time of all but the
# first DIST_WARM of them, then DIST_PROFILED more of each under the profiler
DIST_STEPS, DIST_WARM, DIST_PROFILED, DIST_TOPK = 10, 2, 1, 8
# phase 11's retrieval run (8 steps) again, cut after its step 4
DIST_CLI_STEPS = 4
# the sequence-parallel temporal attention at the retrieval tower's shape
SP_SHAPE, SP_HEADS, SP_TOL = (8 * PATCHES, FRAMES, 768), 12, 1e-5
# gloo with both ranks on cuda:0, B 4 each, fp32 compute and dropout 0,
# against one process on B 8, at ALPRO-base width cut to 2 video blocks and
# 4 BERT layers (2 text, 2 fusion); each process on 2 host threads
GLOO_LOSS_TOL, GLOO_DEPTHS, GLOO_THREADS = 1e-5, (2, 4, 2), 2


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _step_device_ms(step, state, batch, n: int):
    """``n`` train steps under ``torch.profiler``: (device ms a step, {kernel
    or copy name: (device ms, launches) a step})."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step(state, batch, SEED)
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.elapsed_us() > 0:
            name = kernel_name(e.name)
            ms, k = by_name.get(name, (0.0, 0))
            by_name[name] = (ms + e.time_range.elapsed_us() / 1e3 / n, k + 1)
    fail_if(not by_name, "the profiler recorded no device kernel")
    per_step = {k: (ms, c // n) for k, (ms, c) in by_name.items()}
    return sum(ms for ms, _ in per_step.values()), per_step


def _dist_steps(card: str, into: dict) -> None:
    """(a) The wrapped retrieval step at W = 1 against the unwrapped one from
    the same state and seed (ALPRO-base, bf16 compute, B 8, attn_impl
    'pallas', dropout and drop-path 0.1), DIST_STEPS steps of each in turns:
    the metrics and every parameter bit-equal after each step, B13 launched
    24 times a step by both. The
    overhead: the wall time of the steps after the first DIST_WARM (p50 of
    each, and the p50 and range of the per-step differences), the device
    time a step of DIST_PROFILED more steps of each under the profiler with
    the kernels and copies that differ most, and the flat all-reduce of the
    gradients alone (wall and CUDA-event time)."""
    from alpro_tpu_torch.core.mesh import make_mesh
    from alpro_tpu_torch.parallel.collectives import flat_all_reduce_
    from alpro_tpu_torch.train.step import shard_step

    t0 = time.perf_counter()
    mesh = make_mesh([1])
    runs = []
    for wrapped in (False, True):
        model, _, state, step, batch = _retrieval_train_setup(SEED + 40)
        runs.append(dict(model=model, state=state, batch=batch, ms=[], metrics=[],
                         step=shard_step(step, mesh) if wrapped else step))
    want = _launches(masked=24)

    def same_parameters(when: str) -> None:
        named = [dict(r["model"].named_parameters()) for r in runs]
        bad = [n for n, p in named[0].items() if not torch.equal(p, named[1][n])]
        fail_if(bool(bad), f"{when}: {len(bad)} parameters differ, first {bad[:3]}")

    for i in range(DIST_STEPS):
        for wrapped, run in enumerate(runs):
            what = "wrapped" if wrapped else "unwrapped"
            values, ms, _, got = _timed_step(run["step"], run["state"], run["batch"], want, what)
            run["ms"].append(ms)
            run["metrics"].append(values)
            if wrapped:
                for k, v in got.items():
                    into[k] = into.get(k, 0) + v
        fail_if(runs[0]["metrics"][-1] != runs[1]["metrics"][-1],
                f"step {i + 1}: wrapped {runs[1]['metrics'][-1]} != {runs[0]['metrics'][-1]}")
        same_parameters(f"step {i + 1}")
    t_steps = time.perf_counter()
    device = [_step_device_ms(r["step"], r["state"], r["batch"], DIST_PROFILED) for r in runs]
    same_parameters(f"after {DIST_STEPS} steps and {DIST_PROFILED} profiled ones")
    t_prof = time.perf_counter()
    grads = [p.detach().clone() for p in runs[1]["model"].parameters()]
    ar_ms, ar_dev = [], []
    for _ in range(7):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        start.record()
        flat_all_reduce_(grads, mesh.dp.group)
        end.record()
        torch.cuda.synchronize()
        ar_ms.append((time.perf_counter() - t1) * 1e3)
        ar_dev.append(start.elapsed_time(end))
    n_values = sum(g.numel() for g in grads)
    un, wr = (r["ms"][DIST_WARM:] for r in runs)
    diffs = [w - u for u, w in zip(un, wr)]
    (dev_un, by_un), (dev_wr, by_wr) = device
    moved = sorted(((by_wr.get(k, (0.0, 0))[0] - by_un.get(k, (0.0, 0))[0], k)
                    for k in set(by_un) | set(by_wr)), reverse=True)
    print(f"[dist] wrapped step (NCCL, W=1) vs unwrapped, {DIST_STEPS} steps in turns: losses "
          + ", ".join(f"{m['loss']:.6f}" for m in runs[1]["metrics"])
          + f" bit-equal, every parameter bit-equal after each of the {DIST_STEPS} and after "
          f"{DIST_PROFILED} profiled, B13 24 launches a step on both [{card}]",
          flush=True)
    print(f"[dist] step wall ms over steps {DIST_WARM + 1}-{DIST_STEPS}: unwrapped p50 "
          f"{statistics.median(un):.2f} ({min(un):.2f}-{max(un):.2f}), wrapped p50 "
          f"{statistics.median(wr):.2f} ({min(wr):.2f}-{max(wr):.2f}); wrapped - unwrapped per "
          f"step p50 {statistics.median(diffs):+.2f} ms (range {min(diffs):+.2f} to "
          f"{max(diffs):+.2f}); device ms a step ({DIST_PROFILED} profiled steps each): "
          f"unwrapped {dev_un:.3f}, wrapped {dev_wr:.3f} ({dev_wr - dev_un:+.3f}); most added: "
          + "; ".join(f"{k[:48]} {d:+.3f} ms ({by_wr.get(k, (0, 0))[1]}x)" for d, k in moved[:3])
          + f"; the flat all-reduce of the {n_values} fp32 gradient values alone p50 "
          f"{statistics.median(ar_ms[2:]):.3f} ms wall, {statistics.median(ar_dev[2:]):.3f} ms "
          f"between CUDA events [{card}]", flush=True)
    print(f"[dist] (a) took {time.perf_counter() - t0:.1f} s (to the profiled steps "
          f"{t_steps - t0:.1f} s, profiled {t_prof - t_steps:.1f} s)", flush=True)
    del runs, grads
    torch.cuda.empty_cache()


def _dist_index(card: str, into: dict) -> None:
    """(b) ``ShardedRetrievalIndex`` at W = 1 against ``RetrievalIndex`` on
    phase 4's model and clips: top-8 ids equal and scores bit-equal for
    ``query`` and ``query_batch``, K1-K5 launched alike; query p50 of each."""
    from alpro_tpu_torch.core.mesh import make_mesh
    from alpro_tpu_torch.models.alpro import build_retrieval_model
    from alpro_tpu_torch.serving.retrieval import RetrievalIndex
    from alpro_tpu_torch.serving.sharded import ShardedRetrievalIndex

    t0 = time.perf_counter()
    model = _build_model(build_retrieval_model, "timesformer_divst_8x32_224_k600.json", FRAMES)
    tok = HashTokenizer(model.cfg.bert.vocab_size)
    clips = np.random.RandomState(SEED).randint(
        0, 256, (N_CLIPS, FRAMES, 224, 224, 3), dtype=np.uint8)
    ids = [f"vid{i:02d}" for i in range(N_CLIPS)]
    _warm(model, (model.visual_encoder.model.cfg, model.text_encoder.bert.cfg), tok, clips)
    out = {}
    for name, make in (("plain index", lambda: RetrievalIndex(model, tok, "cuda")),
                       ("sharded", lambda: ShardedRetrievalIndex(model, tok, "cuda",
                                                                 make_mesh([1])))):
        index = make()
        _reset_counts()
        _fill(index, clips, ids)
        results = [index.query(t, topk=DIST_TOPK) for t in TEXTS]
        results.append(index.query_batch(TEXTS, topk=DIST_TOPK))
        out[name] = dict(index=index, results=results, counts=_counts())
    a, b = out["plain index"], out["sharded"]
    fail_if(b["results"] != a["results"], "sharded index: results differ from RetrievalIndex")
    fail_if(b["counts"] != a["counts"], f"sharded index: launches {b['counts']} != {a['counts']}")
    for k, v in b["counts"].items():
        into[k] = into.get(k, 0) + v
    _query_ms(a["index"], rounds=1)
    ms = {name: [] for name in out}
    for _ in range(3):  # in turns
        for name in out:
            ms[name] += _query_ms(out[name]["index"], rounds=1)
    print(f"[dist] ShardedRetrievalIndex (NCCL, W=1) vs RetrievalIndex, {N_CLIPS} clips, top-"
          f"{DIST_TOPK}: ids equal, P(match) and VTC sims bit-equal over {len(TEXTS)} queries and "
          f"a query_batch; K1-K5 launches equal {b['counts']}; query p50 sharded "
          f"{statistics.median(ms['sharded']):.2f} ms, RetrievalIndex "
          f"{statistics.median(ms['plain index']):.2f} ms over {len(ms['sharded'])} each "
          f"[{card}]; (b) took {time.perf_counter() - t0:.1f} s", flush=True)
    del out, model
    torch.cuda.empty_cache()


def _dist_cli(card: str, reference: dict, root: Path, into: dict) -> None:
    """(c) Phase 11's retrieval finetuning run (``reference``: its config
    and its kernel run's first DIST_CLI_STEPS steps) again with
    ``--mesh_shape 1`` under the group, cut after step DIST_CLI_STEPS: the
    loop stops there, the schedule, resume saves and validations being
    those of the whole run (phase 11 validates every 4 of its 8 steps,
    which over 4 steps is ``num_valid`` 1). Each step's metrics, the
    validations at step 4 and at the end (both of step 4's state) and
    ``model_step_4.pt`` bit-equal to phase 11's at step 4; the launches of 4
    steps and 2 validations."""
    from alpro_tpu_torch.cli import common, run_video_retrieval
    from alpro_tpu_torch.core.config import Config

    t0 = time.perf_counter()
    out = str(root / "mesh1")
    n_vb, n_tc = reference["per_validate"]
    want = _cli_train_launches(DIST_CLI_STEPS, 24, 2 * n_vb, 2 * n_tc)
    loop = common.run_train_loop

    def cut(cfg, step_fn, state, train_iter, num_train_steps, *args, **kwargs):
        return loop(Config(cfg, num_valid=1), step_fn, state, train_iter, DIST_CLI_STEPS,
                    *args, **kwargs)

    common.run_train_loop = cut
    try:
        run = _train_run(run_video_retrieval, dict(reference["cfg"], output_dir=out), want,
                         "retrieval --mesh_shape 1", argv=("--mesh_shape", "1"))
    finally:
        common.run_train_loop = loop
    fail_if(run["metrics"] != reference["metrics"],
            f"--mesh_shape 1: step metrics {run['metrics']} != {reference['metrics']}")
    fail_if(run["clock"].results != [reference["validate"]] * 2,
            "--mesh_shape 1: a validation differs from phase 11's at step 4")
    got, want_ckpt = (torch.load(p, map_location="cpu", weights_only=True) for p in
                      (Path(out) / "ckpt" / f"model_step_{DIST_CLI_STEPS}.pt", reference["ckpt"]))
    bad = [k for k in want_ckpt if not torch.equal(got[k], want_ckpt[k])]
    fail_if(bool(bad) or got.keys() != want_ckpt.keys(),
            f"--mesh_shape 1: checkpoint differs {bad[:3]}")
    for k, v in run["counts"].items():
        into[k] = into.get(k, 0) + v
    print(f"[dist] retrieval CLI --mesh_shape 1 under NCCL, phase 11's run cut after step "
          f"{DIST_CLI_STEPS}, vs phase 11's kernel run: {DIST_CLI_STEPS} steps' metrics, the "
          f"validations at step 4 and the end and model_step_4.pt ({len(want_ckpt)} tensors) "
          f"bit-equal; launches {run['counts']}", flush=True)
    print(_run_line("retrieval --mesh_shape 1 (NCCL, W=1)", run, CLI_TRAIN_BATCH, card),
          flush=True)
    print(f"[dist] (c) took {time.perf_counter() - t0:.1f} s", flush=True)
    del run["state"]
    torch.cuda.empty_cache()


def _dist_seq_attention(card: str) -> None:
    """(d) ``sharded_temporal_attention`` over the group at (8·196, 8, 768),
    12 heads, fp32, against the unsplit plain attention."""
    import torch.distributed as dist

    from alpro_tpu_torch.ops.attention import multi_head_attention
    from alpro_tpu_torch.parallel.seq_parallel import sharded_temporal_attention

    F = torch.nn.functional
    BN, T, D = SP_SHAPE
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(BN, T, D, device="cuda", generator=g)
    qkv_w = torch.randn(3 * D, D, device="cuda", generator=g) * D ** -0.5
    proj_w = torch.randn(D, D, device="cuda", generator=g) * D ** -0.5
    qkv_b = torch.randn(3 * D, device="cuda", generator=g) * 0.02
    proj_b = torch.randn(D, device="cuda", generator=g) * 0.02
    with torch.no_grad():
        got = sharded_temporal_attention(x, qkv_w, qkv_b, proj_w, proj_b, SP_HEADS,
                                         dist.group.WORLD)
        q, k, v = (F.linear(x, qkv_w, qkv_b).reshape(BN, T, 3, SP_HEADS, D // SP_HEADS)[:, :, i]
                   .transpose(1, 2) for i in range(3))
        ref = F.linear(multi_head_attention(q, k, v, impl="xla").transpose(1, 2)
                       .reshape(BN, T, D), proj_w, proj_b)
    err = float((got - ref).abs().max())
    print(f"[dist] sharded_temporal_attention (NCCL, W=1) at {SP_SHAPE}, {SP_HEADS} heads, fp32: "
          f"max_abs {err:.3e} against the unsplit attention (tol {SP_TOL}) [{card}]", flush=True)
    fail_if(not torch.isfinite(got).all() or err > SP_TOL, f"sp attention off by {err}")


def _gloo_setup():
    """(e)'s model, state, step and B 8 batch: phase 6's retrieval setup in
    fp32 compute with dropout and drop-path 0, cut to GLOO_DEPTHS."""
    model, _, state, step, batch = _retrieval_train_setup(SEED + 50, dtype=torch.float32,
                                                          depths=GLOO_DEPTHS)
    _set_attn_impl(model, "pallas", hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                   drop_path_rate=0.0, drop_rate=0.0)
    return model, state, step, batch


def _gloo_reference() -> dict:
    """(e)'s one-process step on B 8: its metrics."""
    model, state, step, batch = _gloo_setup()
    want = {k: float(v) for k, v in step(state, batch, SEED)[1].items()}
    del model, state, step, batch
    torch.cuda.empty_cache()
    return want


def _gloo_worker(argv) -> int:
    """A rank of (e): the wrapped step on its 4 rows of the B 8 batch."""
    import torch.distributed as dist

    from alpro_tpu_torch.core.mesh import make_mesh, shard_batch
    from alpro_tpu_torch.train.step import shard_step

    rank, init, out = int(argv[0]), argv[1], argv[2]
    torch.set_num_threads(GLOO_THREADS)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=init, world_size=2, rank=rank)
    try:
        _, state, step, batch = _gloo_setup()
        mesh = make_mesh([2])
        _, metrics = shard_step(step, mesh)(state, shard_batch(mesh, batch, "cuda"), SEED)
        Path(out).write_text(json.dumps({k: float(v) for k, v in metrics.items()}))
    finally:
        dist.destroy_process_group()
    return 0


def _gloo_start(tmp: str) -> list:
    """(e)'s two gloo processes, started: ``python3 chip_smoke.py
    --gloo-worker RANK INIT OUT``, each logging to ``tmp``."""
    init = f"file://{tmp}/rendezvous"
    procs = []
    for r in range(2):
        with open(f"{tmp}/rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"), "--gloo-worker", str(r), init,
                 f"{tmp}/rank{r}.json"], cwd=str(REPO), stdout=log, stderr=subprocess.STDOUT))
    return procs


def _gloo_check(card: str, tmp: str, procs: list, want: dict) -> None:
    """(e) Two gloo processes, both on cuda:0, the wrapped step on B 4 each
    against one process's step on B 8 (``want``; fp32 compute, dropout 0):
    the losses within GLOO_LOSS_TOL. A worker that fails fails the phase."""
    for p in procs:
        p.wait(timeout=300)
    for r, p in enumerate(procs):
        log = Path(f"{tmp}/rank{r}.log").read_text(errors="replace")
        fail_if(p.returncode != 0, f"gloo rank {r} exited {p.returncode}:\n{log[-3000:]}")
    got = [json.loads(Path(f"{tmp}/rank{r}.json").read_text()) for r in range(2)]
    gap = max(abs(g[k] - want[k]) for g in got for k in want)
    print(f"[dist] gloo with CUDA tensors, 2 processes on cuda:0 × B 4 vs 1 process × B 8 "
          f"(fp32 compute, dropout 0, depths {GLOO_DEPTHS}): loss {got[0]['loss']:.7f} vs {want['loss']:.7f}, max "
          f"|diff| over {sorted(want)} {gap:.3e} (tol {GLOO_LOSS_TOL}) [{card}]", flush=True)
    fail_if(got[0] != got[1], f"gloo ranks disagree: {got}")
    fail_if(gap > GLOO_LOSS_TOL, f"gloo 2 × B 4 differs from 1 × B 8 by {gap}")


def phase_distributed(card: str, reference: dict) -> dict:
    """Phase 14; ``reference``: phase 11's retrieval run as
    ``phase_finetune_cli`` returns it. Returns the launches of the runs
    under the process group (the wrapped steps, the sharded index, the
    ``--mesh_shape 1`` CLI run). Order: (a) and (b), timed with the card
    to themselves; then the gloo processes of (e) start and run beside (c)
    and (d), and (e) is checked."""
    import tempfile

    import torch.distributed as dist

    t0 = time.perf_counter()
    launches: dict = {}
    fail_if(dist.is_initialized(), "a process group is open before phase 14 opens one")
    port = _free_port()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    print(f"[dist] NCCL process group on tcp://127.0.0.1:{port}, world size "
          f"{dist.get_world_size()}, backend {dist.get_backend()}", flush=True)
    with tempfile.TemporaryDirectory(prefix="alpro_dist_") as tmp:
        procs = []
        try:
            try:
                _dist_steps(card, launches)
                _dist_index(card, launches)
                procs = _gloo_start(tmp)
                _dist_cli(card, reference, Path(tmp), launches)
                _dist_seq_attention(card)
                _gloo_check(card, tmp, procs, _gloo_reference())
            finally:
                dist.destroy_process_group()
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    print(f"[dist] phase 14 took {time.perf_counter() - t0:.1f} s; launches under the group "
          f"{launches}", flush=True)
    return launches


# ---- phase 15: the model's sequence-parallel layout, and the FFmpeg decoder ----
# the retrieval step on a (1, 2) mesh of two gloo processes on cuda:0, T = 16
# split 8 + 8, against one process's unsplit step: ALPRO-base width cut to
# GLOO_DEPTHS, bf16 compute, attn_impl 'pallas', the config's dropout and
# drop-path, SP_BATCH clips. The split changes only where bf16 rounds (the
# q/k/v projection over 8 frames' rows instead of 16, the scores and p·v over
# the gathered keys), as phase 6's pallas and xla paths differ only there, so
# the gradients are held to phase 6's tolerances (FT_*: whole, each parameter
# but BERT's key biases, and the temporal q/k/v weights to the q/k/v one);
# the losses, computed in fp32 from the fusion's logits, to SP_LOSS_TOL. On
# the CPU in fp32 the split is exact to 1e-6 (tests/test_torch_sp_step.py).
# Beside them, the bf16 unsplit step against the same step in fp32 compute
# (the same weights, batch and dropout draws): the error bf16 itself makes.
# Those gates sit at bf16's noise, so each sp process also runs the split
# step in fp32 compute with the video blocks checkpointed (the recompute in
# the backward pass runs on the autograd engine's device thread, where the
# step's use_mesh context is unset, and must split as the forward did),
# held to the unsplit fp32 step: the losses to SP_FP32_LOSS_TOL, the global
# gradient norm before clipping to SP_FP32_NORM_TOL (relative; clipping
# hides a gradient scaled by SP from AdamW's moment, not from the norm),
# AdamW's first moment to SP_FP32_GRAD_TOL (relative L2, whole and the
# temporal q/k/v weights) and SP_FP32_PARAM_TOL (worst parameter). A wrong
# split (frame rows, dropout rows, a missing / SP) moves these by O(1).
SP_FRAMES, SP_BATCH, SP_SEED = 16, 4, SEED + 60
SP_LOSS_TOL = 8e-3
SP_FP32_LOSS_TOL, SP_FP32_NORM_TOL, SP_FP32_GRAD_TOL, SP_FP32_PARAM_TOL = 1e-5, 1e-5, 2e-5, 1e-4
SP_B13_A_STEP = GLOO_DEPTHS[0] + GLOO_DEPTHS[1]  # video blocks + text and fusion layers
TEMPORAL_QKV = re.compile(r"\.temporal_attn\.qkv\.weight$")


def _sp_setup(sp_axis, dtype=torch.bfloat16, checkpointed: bool = False):
    """(a)'s model (``sp_axis`` set on its video tower; ``dtype`` compute;
    ``checkpointed``: its blocks under gradient checkpointing), state, step
    and batch."""
    model, _, state, step, batch = _retrieval_train_setup(
        SP_SEED, dtype=dtype, depths=GLOO_DEPTHS, frames=SP_FRAMES, batch_size=SP_BATCH)
    vis = model.visual_encoder.model
    vis.cfg = dataclasses.replace(vis.cfg, sp_axis=sp_axis, gradient_checkpointing=checkpointed)
    return model, state, step, batch


def _sp_run(step, model, state, batch) -> dict:
    """One step with the counts set to 0 just before it and read just after:
    its metrics, counts, the global gradient norm before clipping and
    AdamW's first moment by parameter name (fp32, on the host)."""
    opt, norms = step.optimizer, []
    update = opt.update

    def recorded(opt_state, params, grads):
        norms.append(float(torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.double()) for g in grads]))))
        return update(opt_state, params, grads)

    opt.update = recorded
    torch.cuda.synchronize()
    _reset_counts()
    try:
        _, metrics = step(state, batch, SEED)
        torch.cuda.synchronize()
    finally:
        opt.update = update
    counts = _counts()
    names = [n for n, _ in model.named_parameters()]
    with torch.no_grad():
        checksum = float(sum(p.double().sum() for p in model.parameters()))
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "counts": counts,
            "grad_norm": norms[0],
            "mu": {n: m.float().cpu() for n, m in zip(names, state.opt_state.mu)},
            "checksum": checksum}


def _sp_worker(argv) -> int:
    """A rank of (a): the sp step on the (1, 2) mesh in bf16, then in fp32
    with the video blocks checkpointed, their results saved."""
    import torch.distributed as dist

    from alpro_tpu_torch.core.mesh import SEQ_AXIS, make_mesh
    from alpro_tpu_torch.train.step import shard_step

    rank, init, out = int(argv[0]), argv[1], argv[2]
    torch.set_num_threads(GLOO_THREADS)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=init, world_size=2, rank=rank)
    try:
        mesh, runs = make_mesh([1, 2]), {}
        for name, dtype, checkpointed in (("bf16", torch.bfloat16, False),
                                          ("fp32_ckpt", torch.float32, True)):
            model, state, step, batch = _sp_setup(SEQ_AXIS, dtype, checkpointed)
            runs[name] = _sp_run(shard_step(step, mesh), model, state, batch)
            del model, state, step, batch
            torch.cuda.empty_cache()
        torch.save(runs, out)
    finally:
        dist.destroy_process_group()
    return 0


def _sp_start(tmp: str) -> list:
    init = f"file://{tmp}/sp_rendezvous"
    procs = []
    for r in range(2):
        with open(f"{tmp}/sp{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"), "--sp-worker", str(r), init,
                 f"{tmp}/sp{r}.pt"], cwd=str(REPO), stdout=log, stderr=subprocess.STDOUT))
    return procs


def _sp_step(card: str, into: dict) -> None:
    """(a) The two sp processes against one process's unsplit step."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="alpro_sp_") as tmp:
        procs = _sp_start(tmp)
        try:
            runs = []
            for dtype in (torch.bfloat16, torch.float32):
                model, state, step, batch = _sp_setup(None, dtype)
                runs.append(_sp_run(step, model, state, batch))
                del model, state, step, batch
                torch.cuda.empty_cache()
            want, fp32 = runs
            for p in procs:
                p.wait(timeout=600)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(procs):
            log = Path(f"{tmp}/sp{r}.log").read_text(errors="replace")
            fail_if(p.returncode != 0, f"sp rank {r} exited {p.returncode}:\n{log[-3000:]}")
        saved = [torch.load(f"{tmp}/sp{r}.pt", weights_only=False) for r in range(2)]
    got, exact = [r["bf16"] for r in saved], [r["fp32_ckpt"] for r in saved]
    b13 = _launches(masked=SP_B13_A_STEP)
    fail_if(want["counts"] != b13, f"unsplit step: launches {want['counts']} != {b13}")
    for r, g in enumerate(got):
        fail_if(g["counts"] != b13, f"sp rank {r}: launches {g['counts']} != {b13}")
        for k, v in g["counts"].items():
            into[k] = into.get(k, 0) + v
    fail_if(got[0]["metrics"] != got[1]["metrics"] or got[0]["checksum"] != got[1]["checksum"],
            f"sp ranks disagree: {got[0]['metrics']} / {got[1]['metrics']}, parameter sums "
            f"{got[0]['checksum']} / {got[1]['checksum']}")
    fail_if(fp32["counts"] != b13, f"unsplit fp32 step: launches {fp32['counts']} != {b13}")
    loss_gap = max(abs(got[0]["metrics"][k] - v) for k, v in want["metrics"].items())
    gaps, yard = grad_gaps(got[0]["mu"], want["mu"]), grad_gaps(want["mu"], fp32["mu"])
    temporal = {n: r for n, r in gaps["params"] if TEMPORAL_QKV.search(n)}
    yard_temporal = {n: r for n, r in yard["params"] if TEMPORAL_QKV.search(n)}
    fail_if(len(temporal) != GLOO_DEPTHS[0], f"temporal q/k/v gradients: {sorted(temporal)}")
    print(f"[sp] retrieval step on a (1, 2) mesh, 2 gloo processes on cuda:0, T {SP_FRAMES} "
          f"split 8 + 8, B {SP_BATCH}, bf16, pallas, depths {GLOO_DEPTHS}, vs one process "
          f"unsplit: losses {got[0]['metrics']} vs {want['metrics']}, max |diff| "
          f"{loss_gap:.3e} (tol {SP_LOSS_TOL}); AdamW mu (0.1 x clipped gradient) rel L2 "
          f"{gaps['whole']:.3e} over {gaps['values']} values (tol {FT_GRAD_TOL}), temporal "
          f"qkv " + ", ".join(f"{r:.3e}" for r in temporal.values())
          + f" (tol {FT_QKV_GRAD_TOL}), worst parameter {gaps['params'][0][0]} "
          f"{gaps['params'][0][1]:.3e} (tol {FT_PARAM_GRAD_TOL}); yardstick, the unsplit bf16 "
          f"step against fp32 compute: losses {fp32['metrics']}, rel L2 {yard['whole']:.3e}, "
          f"temporal qkv " + ", ".join(f"{r:.3e}" for r in yard_temporal.values())
          + f", worst {yard['params'][0][0]} {yard['params'][0][1]:.3e}; parameters "
          f"bit-equal across the 2 ranks; B13 {SP_B13_A_STEP} a step on each [{card}]; (a) "
          f"took {time.perf_counter() - t0:.1f} s", flush=True)
    fail_if(loss_gap > SP_LOSS_TOL, f"sp step losses differ by {loss_gap}")
    fail_if(gaps["whole"] > FT_GRAD_TOL or max(temporal.values()) > FT_QKV_GRAD_TOL
            or gaps["params"][0][1] > FT_PARAM_GRAD_TOL,
            f"sp step gradient off: whole {gaps['whole']}, temporal {temporal}, worst "
            f"{gaps['params'][0]}")
    fail_if(exact[0]["metrics"] != exact[1]["metrics"]
            or exact[0]["checksum"] != exact[1]["checksum"],
            f"fp32 sp ranks disagree: {exact[0]['metrics']} / {exact[1]['metrics']}")
    x_loss = max(abs(exact[0]["metrics"][k] - v) for k, v in fp32["metrics"].items())
    x_norm = abs(exact[0]["grad_norm"] - fp32["grad_norm"]) / fp32["grad_norm"]
    x = grad_gaps(exact[0]["mu"], fp32["mu"])
    x_temporal = [r for n, r in x["params"] if TEMPORAL_QKV.search(n)]
    print(f"[sp] the same in fp32 compute, the video blocks checkpointed, against the unsplit "
          f"fp32 step: losses {exact[0]['metrics']} vs {fp32['metrics']}, max |diff| "
          f"{x_loss:.3e} (tol {SP_FP32_LOSS_TOL}); gradient norm before clipping "
          f"{exact[0]['grad_norm']:.7f} vs {fp32['grad_norm']:.7f}, rel {x_norm:.3e} (tol "
          f"{SP_FP32_NORM_TOL}); AdamW mu rel L2 {x['whole']:.3e}, temporal qkv "
          + ", ".join(f"{r:.3e}" for r in x_temporal) + f" (tol {SP_FP32_GRAD_TOL}), worst "
          f"parameter {x['params'][0][0]} {x['params'][0][1]:.3e} (tol {SP_FP32_PARAM_TOL}); "
          f"parameters bit-equal across the 2 ranks [{card}]", flush=True)
    fail_if(x_loss > SP_FP32_LOSS_TOL or x_norm > SP_FP32_NORM_TOL
            or x["whole"] > SP_FP32_GRAD_TOL or max(x_temporal) > SP_FP32_GRAD_TOL
            or x["params"][0][1] > SP_FP32_PARAM_TOL,
            f"fp32 sp step off: loss {x_loss}, norm {x_norm}, whole {x['whole']}, temporal "
            f"{x_temporal}, worst {x['params'][0]}")


def _sp_media(card: str) -> None:
    """(b) A container through the port's FFmpeg backend against the same
    frames as ``.npy``, or a line saying the machine has no FFmpeg."""
    import shutil
    import tempfile

    from alpro_tpu_torch.media import read_video

    have = shutil.which("pkg-config") is not None and subprocess.run(
        ["pkg-config", "--exists", "libavformat"]).returncode == 0
    if not have:
        print("[sp] media: pkg-config finds no FFmpeg (libavformat) on this machine; the FFmpeg "
              "backend was not run", flush=True)
        return
    from alpro_tpu_torch.media.binding import get_decoder

    t0 = time.perf_counter()
    dec = get_decoder()  # builds libalpro_media.so on first use
    t_build = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="alpro_media_") as tmp:
        video, npy = f"{tmp}/clip.avi", f"{tmp}/clip.npy"
        fail_if(not dec.encode_test_video(video, w=320, h=240, n_frames=48, seed=3),
                "encode_test_video failed")
        info = dec.probe(video)
        np.save(npy, dec.decode_frames(video, list(range(info.num_frames))))
        for kw in (dict(num_frm=16), dict(num_frm=8, sampling="rand"),
                   dict(num_frm=4, start_time=0.4, end_time=1.6)):
            a = read_video(video, rng=np.random.default_rng(1), **kw)
            b = read_video(npy, rng=np.random.default_rng(1), **dict(kw, fps=info.fps)
                           if "start_time" in kw else kw)
            fail_if(a is None or b is None or not np.array_equal(a, b),
                    f"FFmpeg backend differs from the .npy frames at {kw}")
    print(f"[sp] media: libalpro_media.so built in {t_build:.1f} s; a {info.width}x{info.height} "
          f"x {info.num_frames}-frame video through read_video's FFmpeg backend bit-equal to its "
          f"frames as .npy (uniform 16, rand 8, a 0.4-1.6 s window) [{card}]", flush=True)


def phase_sp(card: str) -> dict:
    """Phase 15; returns the launches of (a)'s two sp processes, summed."""
    t0 = time.perf_counter()
    launches: dict = {}
    _sp_step(card, launches)
    _sp_media(card)
    print(f"[sp] phase 15 took {time.perf_counter() - t0:.1f} s; launches of the sp steps "
          f"{launches}", flush=True)
    return launches


def _gt_of(results) -> dict:
    """Ground truth of the planted retrieval set: text t{j} is video ret{j//2}."""
    return {r["txt_id"]: f"ret{int(r['txt_id'][1:]) // 2:03d}" for r in results}


def main() -> int:
    import tempfile

    if sys.argv[1:2] == ["--gloo-worker"]:
        return _gloo_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--sp-worker"]:
        return _sp_worker(sys.argv[2:])
    card = phase_device()
    phase_build()
    res = phase_kernels(card)
    launches, ret = phase_slice(card)
    qa = phase_qa(card)
    # the finetuning path's own counts (the masked attention is on no serving path)
    launches.update(phase_finetune(card))
    # the opt-in paths' own counts (their kernels are on neither default path)
    opt_in = phase_opt_in(card, ret, qa)
    launches.update({k: opt_in[k] for k in OPT_IN_KERNELS})
    launches["layernorm"] = phase_layernorm(card)
    # the last two kernels' own counts (no model path reaches them)
    launches.update(phase_last(card, res, ret))
    # the eval protocols' own counts (K1-K5 again), summed over their kernel runs
    eval_launches = phase_eval(card, ret, qa)
    del ret, qa
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="alpro_train_") as cli_root:
        # the finetuning CLIs' own counts (B13, K2-K5), summed over their kernel runs
        cli_train_launches, cli_reference = phase_finetune_cli(card, Path(cli_root))
        # the pretraining CLIs' own counts (B13 and the teacher's and banks' K2-K5)
        pretrain_launches = phase_pretrain_cli(card)
        # int8 serving, the joint and space-only towers, the remat policies (K1-K5, B13)
        variant_launches = phase_variants(card, res)
        # torch.distributed at one process: the wrapped step, the sharded index, phase 11's
        # run under the CLI's mesh
        dist_launches = phase_distributed(card, cli_reference)
    # the model's sequence-parallel layout on two processes (B13), and the FFmpeg decoder
    sp_launches = phase_sp(card)
    sources = {
        "spatial_attn": ("alpro_tpu_torch/csrc/spatial_attn.cu",
                         "alpro_tpu/ops/pallas_qkv_attn.py:99"),
        "temporal_attn": ("alpro_tpu_torch/csrc/temporal_attn.cu",
                          "alpro_tpu/ops/pallas_qkv_attn.py:545"),
        "ln_mlp": ("alpro_tpu_torch/csrc/ln_mlp.cu", "alpro_tpu/ops/pallas_ln_mlp.py:85"),
        "bert_attn": ("alpro_tpu_torch/csrc/bert_attn.cu",
                      "alpro_tpu/ops/pallas_bert_block.py:151"),
        "bert_mlp": ("alpro_tpu_torch/csrc/ln_mlp.cu",
                     "alpro_tpu/ops/pallas_bert_block.py:298"),
        "masked_attn_bshd": ("alpro_tpu_torch/csrc/masked_attn.cu",
                             "alpro_tpu/ops/pallas_attn.py:203"),
        "masked_attn_bhsd": ("alpro_tpu_torch/csrc/masked_attn.cu",
                             "alpro_tpu/ops/pallas_attn.py:78"),
        "ln_matmul": ("alpro_tpu_torch/csrc/ln_matmul.cu", "alpro_tpu/ops/pallas_ln_mlp.py:193"),
        "patchify_embed": ("alpro_tpu_torch/csrc/patchify_embed.cu",
                           "alpro_tpu/ops/pallas_preprocess.py:63"),
        "fused_spatial_block": ("alpro_tpu_torch/csrc/fused_block.cu",
                                "alpro_tpu/ops/pallas_fused_block.py:136"),
        "fused_temporal_block": ("alpro_tpu_torch/csrc/fused_block.cu",
                                 "alpro_tpu/ops/pallas_fused_block.py:369"),
        "spatial_cls_attn": ("alpro_tpu_torch/csrc/spatial_attn.cu",
                             "alpro_tpu/ops/pallas_qkv_attn.py:246"),
        "spatial_qkv_proj": ("alpro_tpu_torch/csrc/qkv_proj.cu",
                             "alpro_tpu/ops/pallas_qkv_attn.py:678"),
        "temporal_qkv_proj": ("alpro_tpu_torch/csrc/qkv_proj.cu",
                              "alpro_tpu/ops/pallas_qkv_attn.py:813"),
        "layernorm": ("alpro_tpu_torch/csrc/layernorm.cu",
                      "alpro_tpu/ops/pallas_layernorm.py:53"),
        "temporal_roll": ("alpro_tpu_torch/csrc/temporal_attn.cu",
                          "alpro_tpu/ops/pallas_temporal_attn.py:95"),
        "block_attn": ("alpro_tpu_torch/csrc/block_attn.cu",
                       "alpro_tpu/ops/pallas_block_attn.py:117"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        main_shape = next(r for r in res[name] if r["main"])
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in res[name]),
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"], "shape": main_shape["shape"],
            "device_ms": main_shape["device_ms"],
            "library_device_ms": main_shape["library_device_ms"],
            "eval_launches": eval_launches[name],
            "cli_train_launches": cli_train_launches[name],
            "pretrain_launches": pretrain_launches[name],
            "variant_launches": variant_launches.get(name, 0),
            "dist_launches": dist_launches.get(name, 0),
            "sp_launches": sp_launches.get(name, 0),
        })
    for name in ("gelu_fwd", "gelu_bwd"):  # not a TPU kernel: XLA fused the chain
        row = res[name][0]
        kernels.append({
            "name": name, "route": "cuda", "source": "alpro_tpu_torch/csrc/gelu.cu",
            "replaces": None, "launches": launches[name], "max_ulps": row["max_ulps"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "shape": row["shape"], "device_ms": row["device_ms"],
            "plain_device_ms": row["plain_device_ms"],
            "dist_launches": dist_launches.get("gelu" if name == "gelu_fwd" else "gelu_backward",
                                               0),
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
