"""Closed batch calls into ``RetrievalIndex.add_videos``: a service indexing
its catalogue. Calls of ``clips_per_call`` host uint8 clips, back to back,
cycled from a pool of ``pool_calls`` seeded batches made in set-up.

End to end: ``ingest_clips_per_s``, the clips whose features and token banks
are on the card at the window's end (after a synchronize) over the window's
seconds. ``correct``: a seeded sample of ``check_clips`` ingested clips, the
program's VTC feature and token bank against the fp32 reference's."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from perfbench.counts import model as counts
from perfbench.lib import port
from perfbench.lib.clips import planted_clips
from perfbench.lib.device import peak_bytes, release, reset_peak, sync
from perfbench.lib.runctx import Outcome, RunCtx, check
from perfbench.lib.trace import Tracer
from perfbench.lib.weights import make_weights, sub_seed
from perfbench.reference import alpro as ref


def run(ctx: RunCtx) -> Outcome:
    from alpro_tpu_torch.serving.retrieval import RetrievalIndex

    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    B, n_pool = int(tr["clips_per_call"]), int(tr["pool_calls"])
    T, size = int(cfg["num_frm"]), int(cfg["crop_img_size"])
    model, layout = port.model_with_weights(ctx)
    clip_seed = sub_seed(ctx.seed, 10)
    pool = [planted_clips(clip_seed, i * B, B, T, size, dev).cpu().numpy() for i in range(n_pool)]
    ctx.phase("clip pool")
    rng = np.random.default_rng(sub_seed(ctx.seed, 11))
    if ctx.control:
        del model
        sample = np.sort(rng.choice(n_pool * B, size=int(tr["check_clips"]), replace=False))
        got_tok, got_feat = _reference(ctx, layout, pool, sample, "fp8")
        return Outcome(setup_end=time.perf_counter(), e2e={}, attempted=0, failed=0,
                       checks=_judge(ctx, layout, pool, sample, got_tok, got_feat),
                       peak_bytes=peak_bytes(dev))
    index = RetrievalIndex(model, port.tokenizer(), dev, max_txt_len=cfg["max_txt_len"])
    ids = [str(j) for j in range(B)]
    for batch in pool[:2]:                       # the cell's one shape, warmed
        index.add_videos(batch, ids)
    sync(dev)
    index = RetrievalIndex(model, index.tokenizer, dev, max_txt_len=cfg["max_txt_len"])
    setup_end = time.perf_counter()

    reset_peak(dev)
    spans, calls, tracer = ctx.spans, 0, None
    trace_from, trace_calls = 0.4 * ctx.seconds, int(tr["trace_calls"])
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    while time.perf_counter() < deadline or (tracer is not None and not tracer.stopped):
        if ctx.trace and tracer is None and time.perf_counter() - t0 >= trace_from:
            tracer, traced_from = Tracer(spans).start(), calls
        with spans.span("add_videos"):
            index.add_videos(pool[calls % n_pool], ids)
        calls += 1
        if tracer is not None and not tracer.stopped and calls - traced_from == trace_calls:
            tracer.stop()
    sync(dev)
    t1 = time.perf_counter()
    peak = peak_bytes(dev)

    sample = np.sort(rng.choice(calls * B, size=min(int(tr["check_clips"]), calls * B),
                                replace=False))
    got_tok = torch.stack([index._token_chunks[p // B][p % B] for p in sample]).float().cpu()
    got_feat = torch.stack([index._feat_chunks[p // B][p % B] for p in sample]).float().cpu()
    del index, model
    release(dev)
    checks = _judge(ctx, layout, pool, sample, got_tok, got_feat)
    window = t1 - t0
    traced_s = tracer.stopped_at - tracer.started_at if tracer else 0.0
    return Outcome(
        setup_end=setup_end, e2e={"ingest_clips_per_s": calls * B / window},
        attempted=calls, failed=0, checks=checks, peak_bytes=peak,
        trace=tracer.run if tracer else None,
        info={"calls_traced": trace_calls, "clips_per_call": B, "frames": T, "chips": 1,
              "flop_per_clip": counts.ingest_clip(T),
              "clips_untraced": (calls - (trace_calls if tracer else 0)) * B,
              "seconds_untraced": window - traced_s - (tracer.host_s if tracer else 0.0)})


def _reference(ctx: RunCtx, layout, pool, sample, numerics: str = "fp32"):
    """The reference's token banks and features of the sampled clips."""
    B, dev = int(ctx.cell.traffic["clips_per_call"]), ctx.device
    net = ref.Net(make_weights(layout, ctx.seed, dev), numerics)
    vcfg = ref.vision_config(ctx.cell.config)
    toks, feats = [], []
    with torch.no_grad(), ref.exact_fp32():
        for lo in range(0, len(sample), 16):
            px = torch.stack([torch.from_numpy(pool[(p // B) % len(pool)][p % B])
                              for p in sample[lo:lo + 16]]).to(dev)
            tok = ref.video_tokens(net, px, vcfg)
            toks.append(tok.cpu())
            feats.append(ref.feature(net, tok, "vision_proj").cpu())
    return torch.cat(toks), torch.cat(feats)


def _judge(ctx: RunCtx, layout, pool, sample, got_tok, got_feat) -> list:
    """The mean gap over the sampled clips: of the L2-normalized feature
    (absolute), and of the token bank (relative to the reference's norm).
    The widest gap of one clip is no number here: in bf16 it swings to
    within 2.3x of the fp8 control's, so no limit holds between them."""
    want_tok, want_feat = _reference(ctx, layout, pool, sample)
    tok_norm = torch.linalg.vector_norm(want_tok.flatten(1), dim=-1)
    feat_gaps = torch.linalg.vector_norm(got_feat - want_feat, dim=-1)
    tok_gaps = torch.linalg.vector_norm((got_tok - want_tok).flatten(1), dim=-1) / tok_norm
    print(f"perfbench: widest gaps: feature {float(feat_gaps.max())!r}, token bank "
          f"{float(tok_gaps.max())!r}", file=sys.stderr)
    return [check(ctx.cell, "feat_gap_mean", feat_gaps.mean()),
            check(ctx.cell, "token_gap_mean", tok_gaps.mean())]
