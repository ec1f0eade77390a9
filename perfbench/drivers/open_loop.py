"""An open loop of text queries into ``RetrievalIndex.query``: online
text→video search over a gallery ingested in set-up.

Arrivals are a Poisson process at ``rate_qps``: one sample path, the same
in every run (``arrivals``).
Each query is a seeded caption of ``words`` words, served first-in
first-out by one serving thread with ``topk`` candidates. A query is timed
from when it was due, so a stall delays the queries behind it; one that
fails counts as missing every limit.

End to end: ``query_p50_ms``, the median latency over all queries due in
the window; their 95th percentile is read per layer (``latency_ms_p95.query``):
a tail of an open loop swings with the host's stalls (see PERF.md).
``correct``: a seeded sample of ``check_queries`` served queries, the
longest caption among them; each returned candidate's VTC similarity and
P(match), and the top-k set itself, against the fp32 reference's over its
own gallery."""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from perfbench.counts import model as counts
from perfbench.lib import port
from perfbench.lib.clips import planted_clips
from perfbench.lib.device import peak_bytes, release, reset_peak, sync
from perfbench.lib.runctx import Outcome, RunCtx, check
from perfbench.lib.text import WORDS, captions
from perfbench.lib.trace import Tracer
from perfbench.lib.weights import make_weights, sub_seed
from perfbench.reference import alpro as ref
from perfbench.reference import tokenizer as ref_tok


def arrivals(rate: float, seconds: float, order_seed: int) -> np.ndarray:
    """round(rate · seconds) arrival times in [0, seconds): a Poisson
    process's gaps as the exponential's (i + ½)/n quantiles, scaled to fill
    the window, in an order drawn from ``order_seed``. The traffic file fixes
    that seed, so every run replays one sample path of the process: the
    queue's tail then follows the program, not the draw."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps *= seconds / gaps.sum()
    np.random.default_rng(order_seed).shuffle(gaps)
    return np.cumsum(gaps) - gaps[0]


def serve(due, call, spans, between=None) -> tuple:
    """One serving thread, first in first out: query i starts at ``due[i]``
    seconds after the start or when query i - 1 ends, whichever is later,
    and ``call(i)`` serves it inside a ``query`` span. Returns (each query's
    latency from when it was due, the failures); a query that raises fails,
    and its latency is inf. ``between(i)`` runs before query i, outside its
    span and its latency's start (the tracer starts and stops there)."""
    lat, failed = [], 0
    t0 = time.perf_counter()
    for i, d in enumerate(due):
        if between is not None:
            between(i)
        wait = t0 + d - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        try:
            with spans.span("query"):
                call(i)
        except Exception as e:                    # a failed query misses the limit
            failed += 1
            lat.append(math.inf)
            print(f"perfbench: query {i} failed: {e!r}", file=sys.stderr)
            continue
        lat.append(time.perf_counter() - t0 - d)
    return lat, failed


def nearest_rank(latencies, q: float) -> float:
    """The ``q`` quantile (nearest rank) over all latencies, inf included."""
    lat = np.sort(np.asarray(latencies, dtype=np.float64))
    return float(lat[max(0, math.ceil(q * len(lat)) - 1)])


def p50(latencies) -> float:
    return nearest_rank(latencies, 0.50)


def p95(latencies) -> float:
    return nearest_rank(latencies, 0.95)


def run(ctx: RunCtx) -> Outcome:
    from alpro_tpu_torch.serving.retrieval import RetrievalIndex

    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    L, gallery, topk = int(cfg["max_txt_len"]), int(tr["gallery"]), int(tr["topk"])
    rate = float(ctx.rate or tr["rate_qps"])
    due = arrivals(rate, ctx.seconds, int(tr["order_seed"]))
    n_due = len(due)
    n_q = n_due + int(tr["warmup_queries"])
    texts = captions(np.random.SeedSequence([ctx.seed, 21]), n_q, *tr["words"])
    rng = np.random.default_rng(sub_seed(ctx.seed, 22))
    keep = set(int(i) for i in rng.choice(n_due, size=min(int(tr["check_queries"]) - 1, n_due),
                                          replace=False))
    keep.add(max(range(n_due), key=lambda i: len(texts[i].split())))
    model, layout = port.model_with_weights(ctx)
    if ctx.control:
        del model
        net = ref.Net(make_weights(layout, ctx.seed, dev), "fp8")
        with torch.no_grad(), ref.exact_fp32():
            results = _answers(ctx, net, {i: texts[i] for i in keep})
        return Outcome(setup_end=time.perf_counter(), e2e={}, attempted=0, failed=0,
                       checks=_judge(ctx, layout, texts, results, keep),
                       peak_bytes=peak_bytes(dev))
    index = RetrievalIndex(model, port.tokenizer(), dev, max_txt_len=L)
    T, size, per_call = int(cfg["num_frm"]), int(cfg["crop_img_size"]), int(tr["ingest_per_call"])
    clip_seed = sub_seed(ctx.seed, 10)
    for lo in range(0, gallery, per_call):
        n = min(per_call, gallery - lo)
        index.add_videos(planted_clips(clip_seed, lo, n, T, size, dev),
                         [str(lo + j) for j in range(n)])
    ctx.phase("gallery")
    for text in texts[-int(tr["warmup_queries"]):]:       # the cell's one shape, warmed
        index.query(text, topk=topk)
    sync(dev)
    setup_end = time.perf_counter()

    reset_peak(dev)
    spans, tracer, results = ctx.spans, None, {}
    trace_from, trace_to = int(0.4 * n_due), int(0.4 * n_due) + int(tr["trace_queries"])

    def call(i):
        res = index.query(texts[i], topk=topk)
        if i in keep:
            results[i] = res

    def between(i):
        nonlocal tracer
        if ctx.trace and i == trace_from:
            tracer = Tracer(spans).start()
        elif tracer is not None and not tracer.stopped and i == trace_to:
            tracer.stop()

    t0 = time.perf_counter()
    lat, failed = serve(due, call, spans, between)
    if tracer is not None and not tracer.stopped:
        tracer.stop()
    window_end = time.perf_counter()
    peak = peak_bytes(dev)
    del index, model
    release(dev)

    checks = _judge(ctx, layout, texts, results, keep)
    service = [b - a for a, b in spans.spans.get("query", ())]
    lat_a = np.asarray(lat)
    fifth = max(1, n_due // 5)
    svc = 1e3 * np.asarray(service or [math.nan])
    by_fifth = " ".join(f"{1e3 * p95(part):.1f}" for part in np.array_split(lat_a, 5) if len(part))
    print(f"perfbench: rate {rate} q/s: {n_due} due, p50 {1e3 * np.median(lat_a):.2f} ms, "
          f"mean latency of the first fifth {1e3 * lat_a[:fifth].mean():.2f} ms, "
          f"of the last {1e3 * lat_a[-fifth:].mean():.2f} ms; service p50 "
          f"{np.median(svc):.2f} ms, p95 {np.percentile(svc, 95):.2f}, max {svc.max():.2f}, "
          f"{int((svc > 2 * np.median(svc)).sum())} over twice the median; latency p95 by "
          f"fifth: {by_fifth}", file=sys.stderr)
    return Outcome(
        setup_end=setup_end, e2e={"query_p50_ms": 1e3 * p50(lat)},
        attempted=n_due, failed=failed, checks=checks, peak_bytes=peak,
        trace=tracer.run if tracer else None,
        # the profiler's start and stop stall the loop, and the queue carries
        # the stall on; a traced run's tail is read before the traced span
        info={"service_s": service, "latency_s": lat[:trace_from] if ctx.trace else lat,
              "queries_traced": trace_to - trace_from,
              "flop_per_query": counts.query(L, gallery, topk), "text_len": L, "topk": topk,
              "window_s": window_end - t0, "rate_qps": rate, "chips": 1})


def _gallery(ctx: RunCtx, net):
    """The gallery's (tokens, features) through the reference's tower."""
    cfg, dev, gallery = ctx.cell.config, ctx.device, int(ctx.cell.traffic["gallery"])
    vcfg, clip_seed = ref.vision_config(cfg), sub_seed(ctx.seed, 10)
    toks, feats = [], []
    for lo in range(0, gallery, 16):
        tok = ref.video_tokens(net, planted_clips(clip_seed, lo, min(16, gallery - lo),
                                                  int(cfg["num_frm"]), int(cfg["crop_img_size"]),
                                                  dev), vcfg)
        toks.append(tok)
        feats.append(ref.feature(net, tok, "vision_proj"))
    return torch.cat(toks), torch.cat(feats)


def _encode(ctx: RunCtx, net, text: str):
    cfg, dev = ctx.cell.config, ctx.device
    ids, mask = (torch.from_numpy(a).to(dev) for a in
                 ref_tok.encode([text], ref_tok.vocab(WORDS), int(cfg["max_txt_len"])))
    return ref.text_embeds(net, ids, mask, cfg["model_config"]), mask


def _answers(ctx: RunCtx, net, texts: dict) -> dict:
    """What ``query`` answers, computed by the reference: [(id, P(match),
    similarity)] over its own top-k (the control in fp8)."""
    topk, bcfg = int(ctx.cell.traffic["topk"]), ctx.cell.config["model_config"]
    toks, feats = _gallery(ctx, net)
    out = {}
    for i, text in texts.items():
        emb, mask = _encode(ctx, net, text)
        sims, rows = torch.topk((ref.feature(net, emb, "text_proj") @ feats.T)[0], topk)
        p = ref.p_match(net, ref.fusion(net, emb.expand(topk, -1, -1), mask.expand(topk, -1),
                                        toks[rows], bcfg))
        out[i] = [(str(int(r)), float(pp), float(s)) for r, pp, s in zip(rows, p, sims)]
    return out


def _judge(ctx: RunCtx, layout, texts, results, keep) -> list:
    """The fp32 reference's gallery, then over the kept queries the mean of:
    each query's mean gap of a returned similarity from the reference's; of
    a returned P(match), each measured from its query's mean P(match) on
    either side (how the candidates stand against one another, which the
    ranking reads); and how far below the reference's k-th similarity its
    lowest returned candidate lies. (The uncentred P(match) gap and a
    query's widest gaps are no numbers here: in bf16 they swing to within
    2.6-2.9x of the fp8 control's, so no limit holds between them.)"""
    topk, dev = int(ctx.cell.traffic["topk"]), ctx.device
    bcfg = ctx.cell.config["model_config"]
    net = ref.Net(make_weights(layout, ctx.seed, dev))
    sim_sum = p_sum = miss_sum = 0.0
    with torch.no_grad(), ref.exact_fp32():
        toks, feats = _gallery(ctx, net)
        for i in sorted(keep):
            got = results.get(i, [])
            rows = torch.tensor([int(vid) for vid, _, _ in got], device=dev)
            if len(got) != topk or len(set(rows.tolist())) != topk:
                sim_sum = p_sum = miss_sum = math.inf
                break
            emb, mask = _encode(ctx, net, texts[i])
            sims = (ref.feature(net, emb, "text_proj") @ feats.T)[0]
            kth = torch.topk(sims, topk).values[-1]
            p_ref = ref.p_match(net, ref.fusion(net, emb.expand(topk, -1, -1),
                                                mask.expand(topk, -1), toks[rows], bcfg))
            got_sim = torch.tensor([s for _, _, s in got], device=dev)
            got_p = torch.tensor([p for _, p, _ in got], device=dev)
            sim_sum += float((got_sim - sims[rows]).abs().mean())
            p_sum += float(((got_p - got_p.mean()) - (p_ref - p_ref.mean())).abs().mean())
            miss_sum += float((kth - sims[rows]).clamp(min=0).max())
    n = max(len(keep), 1)
    return [check(ctx.cell, "sim_gap_mean", sim_sum / n),
            check(ctx.cell, "p_match_gap_centred", p_sum / n),
            check(ctx.cell, "topk_miss_mean", miss_sum / n)]
