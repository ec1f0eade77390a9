"""Finetuning through the port's training loop (``cli/common.py::
setup_training`` and ``run_train_loop``, the CLIs' own), one process per
card.

The host batches are made in set-up: ``pool_batches`` batches of the
configuration's per-card ``train_batch_size`` uint8 clips, questions of
``words`` words padded to ``max_txt_len`` and labels over the
configuration's answers, cycled, and
staged by the loop's ``DevicePrefetcher`` at the configuration's
``prefetch_depth``. Set-up builds the train step once and drives it through
its first ``check_opt_steps`` optimizer steps (``gradient_accumulation_
steps`` micro-steps each, on batches whose rows all differ) through the same
loop; the window goes on with that same step and state.

End to end: ``train_clips_per_s``, every clip through forward and backward
in the window over the window's seconds; ``train_peak_gib``, the allocator's
peak over the window. ``correct``: the fp32 reference follows those first
steps from the same weights on the same batches, drawing the same dropout
and drop-path masks from (seed, step), and compares each micro-step's loss,
each parameter's first gradient as the optimizer got it, and each
parameter's change after the steps."""

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
from perfbench.lib.text import captions
from perfbench.lib.trace import Tracer
from perfbench.lib.weights import make_weights, sub_seed
from perfbench.reference import train as ref_train


class WindowClosed(Exception):
    """Raised by the step after the window's last micro-step."""


def make_batches(ctx: RunCtx, tokenizer) -> list:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    B, n = int(cfg["train_batch_size"]), int(tr["pool_batches"])
    T, size, L = int(cfg["num_frm"]), int(cfg["crop_img_size"]), int(cfg["max_txt_len"])
    seed, out = sub_seed(ctx.seed, 30), []
    texts = captions(np.random.SeedSequence([ctx.seed, 31]), B * n, *tr["words"])
    labels = np.random.default_rng(sub_seed(ctx.seed, 32)).integers(
        0, int(cfg["num_labels"]), size=B * n)
    for i in range(n):
        enc = tokenizer(texts[i * B:(i + 1) * B], max_length=L)
        out.append({"visual_inputs": planted_clips(seed, i * B, B, T, size, ctx.device).cpu()
                    .numpy(),
                    "text_input_ids": enc["input_ids"], "text_input_mask": enc["attention_mask"],
                    "labels": labels[i * B:(i + 1) * B].astype(np.int64)})
    return out


def feed(batches, start: int):
    i = start
    while True:
        yield dict(batches[i % len(batches)])
        i += 1


def leaf_gap(got: dict, want: dict) -> float:
    """The worst parameter's gap of norms, |‖got‖ − ‖want‖|, over the larger
    of ‖want‖ and the median parameter's ‖want‖; parameters whose reference
    norm is under a thousandth of the median's (nought to rounding) are left
    out."""
    med = float(np.median(list(want.values())))
    return max(abs(got[n] - w) / max(w, med) for n, w in want.items() if w >= 1e-3 * med)


def run(ctx: RunCtx) -> Outcome:
    from alpro_tpu_torch.cli.common import run_train_loop, setup_training
    from alpro_tpu_torch.core.config import Config
    from alpro_tpu_torch.train.step import make_qa_train_step

    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    B, accum = int(cfg["train_batch_size"]), int(cfg.get("gradient_accumulation_steps", 1))
    check_micro = int(tr["check_opt_steps"]) * accum
    loop_seed = sub_seed(ctx.seed, 33)
    run_cfg = Config(dict(cfg, seed=loop_seed, device=dev.type, output_dir=None,
                         e2e_weights_path=None))
    model, layout = port.model_with_weights(ctx)
    batches = make_batches(ctx, port.tokenizer())
    ctx.phase("batches")
    if ctx.control:
        del model
        return _control(ctx, layout, batches, loop_seed)
    step_fn, state, num_train_steps, _ = setup_training(
        run_cfg, model, make_qa_train_step, int(tr["steps_per_epoch"]))
    names = [n for n, _ in model.named_parameters()]
    b1 = float(cfg["betas"][0])
    got = {"losses": []}

    def judged_step(st, batch, seed, *extras):
        st, metrics = step_fn(st, batch, seed, *extras)
        got["losses"].append(metrics["loss"])
        if st.step == accum:       # the first update: mu = (1 - b1) · its gradient
            got["first_grad"] = [torch.linalg.vector_norm(m.float() / (1 - b1))
                                 for m in st.opt_state.mu]
        return st, metrics

    state = run_train_loop(run_cfg, judged_step, state, feed(batches, 0), check_micro)
    ctx.phase("the judged steps")
    with torch.no_grad():
        w0 = make_weights(layout, ctx.seed, dev)
        got["delta"] = {n: float(torch.linalg.vector_norm(p - w0[n]))
                        for n, p in model.named_parameters()}
        del w0
    got["losses"] = [float(x) for x in got["losses"]]
    got["first_grad"] = {n: float(x) for n, x in zip(names, got["first_grad"])}
    sync(dev)
    setup_end = time.perf_counter()

    spans, tracer = ctx.spans, None
    count = {"micro": 0, "traced_from": None}
    trace_steps = int(tr["trace_micro_steps"])
    reset_peak(dev)
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds

    def windowed_step(st, batch, seed, *extras):
        nonlocal tracer
        if ctx.trace and tracer is None and time.perf_counter() - t0 >= 0.4 * ctx.seconds:
            tracer, count["traced_from"] = Tracer(spans).start(), count["micro"]
        with spans.span("step_fn"):
            out = step_fn(st, batch, seed, *extras)
        count["micro"] += 1
        if tracer is not None and not tracer.stopped and \
                count["micro"] - count["traced_from"] == trace_steps:
            tracer.stop()
        if time.perf_counter() >= deadline and (tracer is None or tracer.stopped):
            raise WindowClosed
        return out

    try:
        run_train_loop(run_cfg, windowed_step, state, feed(batches, check_micro), 1 << 40)
    except WindowClosed:
        pass
    sync(dev)
    t1 = time.perf_counter()
    peak = peak_bytes(dev)
    window = t1 - t0
    tracer_s = tracer.host_s if tracer else 0.0
    traced_s = tracer.stopped_at - tracer.started_at if tracer else 0.0
    outside = (window - tracer_s - spans.total("step_fn", t0, t1)) / (window - tracer_s)
    del step_fn, state, model
    release(dev)

    want = ref_train.qa_steps(make_weights(layout, ctx.seed, dev), cfg,
                              [_on_device(b, dev) for b in batches[:check_micro]], loop_seed,
                              int(tr["check_opt_steps"]), math.ceil(num_train_steps / accum))
    checks = _compare(ctx, got, want)
    return Outcome(
        setup_end=setup_end,
        e2e={"train_clips_per_s": count["micro"] * B / window,
             "train_peak_gib": peak / 2 ** 30},
        attempted=count["micro"], failed=0, checks=checks, peak_bytes=peak,
        trace=tracer.run if tracer else None,
        info={"chips": 1, "outside_share": outside,
              "flop_per_clip": counts.qa_train_clip(int(cfg["num_frm"]), int(cfg["max_txt_len"]),
                                                    int(cfg["num_labels"])),
              "clips_untraced": (count["micro"] - (trace_steps if tracer else 0)) * B,
              "seconds_untraced": window - traced_s - tracer_s})


def _on_device(batch: dict, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _diagnose(got: dict, want: dict) -> None:
    """Each micro-step's loss gap, and the worst and median parameters'
    gaps, on standard error."""
    gaps = [abs(a - b) for a, b in zip(got["losses"], want["losses"])]
    print(f"perfbench: loss gaps by micro-step {gaps!r}", file=sys.stderr)
    for key in ("first_grad", "delta"):
        w = want[key]
        med = float(np.median(list(w.values())))
        g = {n: abs(got[key][n] - v) / max(v, med) for n, v in w.items() if v >= 1e-3 * med}
        worst = max(g, key=g.get)
        print(f"perfbench: {key}: worst {worst} {g[worst]!r}, median parameter's gap "
              f"{float(np.median(list(g.values())))!r}, {len(g)} of {len(w)} parameters",
              file=sys.stderr)


def _compare(ctx: RunCtx, got: dict, want: dict) -> list:
    _diagnose(got, want)
    gaps = [abs(a - b) for a, b in zip(got["losses"], want["losses"])]
    if len(got["losses"]) != len(want["losses"]):
        gaps = [math.inf]
    return [check(ctx.cell, "loss_gap", max(gaps)),
            check(ctx.cell, "loss_gap_rms", math.sqrt(sum(g * g for g in gaps) / len(gaps))),
            check(ctx.cell, "first_grad_gap", leaf_gap(got["first_grad"], want["first_grad"])),
            check(ctx.cell, "delta_gap", leaf_gap(got["delta"], want["delta"]))]


def _control(ctx: RunCtx, layout, batches, loop_seed) -> Outcome:
    """The reference in fp8 in the program's place, judged by the fp32
    reference as the program is (no window: training's readings need none)."""
    tr, dev = ctx.cell.traffic, ctx.device
    accum = int(ctx.cell.config.get("gradient_accumulation_steps", 1))
    n_opt = int(tr["check_opt_steps"])
    total = math.ceil(int(tr["steps_per_epoch"]) * ctx.cell.config["num_train_epochs"] / accum)
    on_dev = [_on_device(b, dev) for b in batches[:n_opt * accum]]
    w0 = make_weights(layout, ctx.seed, dev)
    got = ref_train.qa_steps(w0, ctx.cell.config, on_dev, loop_seed, n_opt, total, "fp8")
    want = ref_train.qa_steps(w0, ctx.cell.config, on_dev, loop_seed, n_opt, total)
    return Outcome(setup_end=time.perf_counter(), e2e={}, attempted=0, failed=0,
                   checks=_compare(ctx, got, want), peak_bytes=peak_bytes(dev))
