"""Data-parallel retrieval finetuning through the port's training loop, one
process a card (``cli/common.py::setup_training`` and ``run_train_loop``, the
CLIs' own), over the process group that the port opens from
``ALPRO_COORDINATOR`` on 127.0.0.1 (``core/distributed.py::maybe_initialize``:
NCCL on the cards).

``run`` starts one worker process a card (this file, ``python3
drivers/train_dp.py <spec.json> <rank>``) and watches them: a worker that
exits with an error, or a run past the traffic's ``timeout_s`` (+ the
window), kills every worker and fails the run; each worker also ends itself
at that timeout, and dies with the process that started it. Each worker
makes its rows of ``pool_batches`` global batches of the configuration's
``train_batch_size`` (its share: the global batch over the cards), drives
``make_retrieval_train_step`` (VTC gathered over the group, VTM's hard
negatives drawn from the gathered similarities in ``vtm_negative_blocks``
blocks) through ``check_opt_steps`` judged optimizer steps, then
``probe_micro_steps`` timed ones (set-up), from whose slowest worker's time
they agree once, by one gloo all-reduce, on the window's count of
micro-steps to fill ``--seconds``; the window then runs that count on every
worker with no word between them beyond the step's own collectives. Rank 0
alone takes the program's spans and the device trace. Each worker is bound
to its own share of the CPU cores the run may use, as one pins the process
of each card of a host. A fault of ``lib/faults.py`` planted around the run
is planted in every worker.

End to end: ``train_clips_per_s``, the clips of every card through forward
and backward in the window over the window's seconds; ``train_peak_gib``,
the fullest card's allocator peak over the window, which closes when the
last card is through. ``correct``: on each
card the fp32 reference (``reference/retrieval_dp.py``) follows the judged
steps from the same weights on the same rows, with the same draws and a
gather with gradient of its own, and compares the global loss of each
micro-step, each parameter's first gradient and change, the L2-normed video
and text features of the judged micro-steps (``feat_gap``), and
``rank_param_gap``: the largest difference of any parameter from rank 0's
after the judged steps. The worst card's reading of each is the run's. The
workers run with ``OMP_NUM_THREADS`` 1 unless it is set, as ``torchrun``
starts them."""

from __future__ import annotations

import dataclasses
import faulthandler
import json
import math
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench.counts.retrieval import retrieval_train_clip  # noqa: E402
from perfbench.drivers.train_loop import WindowClosed, feed, leaf_gap  # noqa: E402
from perfbench.lib import port  # noqa: E402
from perfbench.lib.clips import planted_clips  # noqa: E402
from perfbench.lib.device import peak_bytes, release, reset_peak, sync  # noqa: E402
from perfbench.lib.harness import Cell, Check, forbidden_modules  # noqa: E402
from perfbench.lib.program import Window  # noqa: E402
from perfbench.lib.recorder import Recorder  # noqa: E402
from perfbench.lib.runctx import Outcome, RunCtx  # noqa: E402
from perfbench.lib.spans import Spans  # noqa: E402
from perfbench.lib.text import captions  # noqa: E402
from perfbench.lib.weights import make_weights, sub_seed  # noqa: E402
from perfbench.reference.retrieval_dp import retrieval_dp_steps  # noqa: E402

CHECKS = ("loss_gap", "first_grad_gap", "delta_gap", "feat_gap", "rank_param_gap")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _die_with_parent() -> None:
    """In the worker before it runs: SIGKILL when the process that started
    it dies (Linux's PR_SET_PDEATHSIG)."""
    import ctypes

    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)


def _cores(rank: int, world: int) -> list:
    """Rank ``rank``'s contiguous share of the cores this process may use
    (none where there are fewer cores than workers)."""
    cores = sorted(os.sched_getaffinity(0))
    k = len(cores) // world
    return cores[rank * k:(rank + 1) * k]


def _planted_fault():
    """The fault of ``lib/faults.py`` planted in this process, if any: a
    patched method defined there."""
    from alpro_tpu_torch.train.optimizer import AdamW
    from alpro_tpu_torch.train.step import TrainStep

    from perfbench.lib import faults

    for name, fn in (("frozen_state", AdamW.update), ("half_batch", TrainStep.__call__)):
        if getattr(fn, "__module__", None) == faults.__name__:
            return name
    return None


def run(ctx: RunCtx) -> Outcome:
    return launch(ctx, ctx.cell.chips)


def launch(ctx: RunCtx, world: int, on_started=None) -> Outcome:
    """Run the cell on ``world`` worker processes and merge what they hand
    back. ``on_started(procs)`` is called once they are started."""
    tmp = tempfile.TemporaryDirectory(prefix="perfbench_dp_")
    timeout = float(ctx.cell.traffic["timeout_s"]) + ctx.seconds
    spec = {"cell": dataclasses.asdict(ctx.cell), "seed": ctx.seed, "seconds": ctx.seconds,
            "trace": ctx.trace, "control": ctx.control, "device": ctx.device.type,
            "t_start": ctx.t_start, "world": world, "timeout_s": timeout, "out": tmp.name,
            "fault": _planted_fault()}
    spec_path = os.path.join(tmp.name, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, ALPRO_COORDINATOR=f"127.0.0.1:{_free_port()}",
               ALPRO_NUM_PROCESSES=str(world))
    env.pop("ALPRO_DISTRIBUTED", None)
    env.setdefault("OMP_NUM_THREADS", "1")      # as torchrun sets it for its workers

    def start(rank: int):
        cores = _cores(rank, world)

        def before_exec():
            _die_with_parent()
            if cores:
                os.sched_setaffinity(0, cores)
        return subprocess.Popen([sys.executable, os.path.abspath(__file__), spec_path,
                                 str(rank)], stdout=2, preexec_fn=before_exec,
                                env=dict(env, ALPRO_PROCESS_ID=str(rank), LOCAL_RANK=str(rank)))

    procs = [start(r) for r in range(world)]
    if on_started is not None:
        on_started(procs)
    deadline = time.monotonic() + timeout + 60.0
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise RuntimeError(f"worker {bad[0][0]} exited with {bad[0][1]}; the run stops")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise RuntimeError(f"the workers ran past {timeout + 60.0:.0f} s; the run stops")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    parts = [torch.load(os.path.join(tmp.name, f"rank{r}.pt"), weights_only=False)
             for r in range(world)]
    tmp.cleanup()
    return _merge(ctx, parts)


def _merge(ctx: RunCtx, parts: list) -> Outcome:
    lead = parts[0]
    checks = [Check(name, max(p["checks"][name] for p in parts),
                    ctx.cell.limits.get(name, float("nan"))) for name in CHECKS]
    peak = max(p["peak"] for p in parts)
    e2e = {}
    if not ctx.control:
        clips = sum(p["micro"] * p["rows"] for p in parts)
        e2e = {"train_clips_per_s": clips / max(p["seconds"] for p in parts),
               "train_peak_gib": peak / 2 ** 30}
    return Outcome(setup_end=max(p["setup_end"] for p in parts), e2e=e2e,
                   attempted=lead["micro"], failed=0, checks=checks, peak_bytes=peak,
                   trace=lead["trace"], info=lead["info"])


# ---- one worker ----------------------------------------------------------------------
def make_batches(ctx: RunCtx, tokenizer, rank: int, world: int) -> list:
    """This rank's rows of the pool's global batches: rows [rank·b, (rank+1)·b)
    of each, clips and captions the same whatever the number of cards."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    B, n = int(cfg["train_batch_size"]), int(tr["pool_batches"])
    b = B // world
    T, size, L = int(cfg["num_frm"]), int(cfg["crop_img_size"]), int(cfg["max_txt_len"])
    texts = captions(np.random.SeedSequence([ctx.seed, 31]), B * n, *tr["words"])
    out = []
    for i in range(n):
        first = i * B + rank * b
        enc = tokenizer(texts[first:first + b], max_length=L)
        out.append({"visual_inputs": planted_clips(sub_seed(ctx.seed, 30), first, b, T, size,
                                                   ctx.device).cpu().numpy(),
                    "text_input_ids": enc["input_ids"], "text_input_mask": enc["attention_mask"]})
    return out


def _on_device(batch: dict, dev) -> dict:
    return {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in batch.items()}


def _rank_param_gap(params: list) -> float:
    """The largest |p − rank 0's p| over every parameter."""
    import torch.distributed as dist

    gap = 0.0
    with torch.no_grad():
        for p in params:
            lead = p.detach().clone()
            dist.broadcast(lead, 0)
            gap = max(gap, float((p.detach() - lead).abs().max()))
    return gap


def feat_gap(got: list, want: list) -> float:
    """The mean L2 distance between the program's L2-normed video and text
    features and the reference's, over every row of the judged micro-steps."""
    pairs = [(g, w) for gs, ws in zip(got, want) for g, w in zip(gs, ws)]
    if len(got) != len(want) or any(g.shape != w.shape for g, w in pairs):
        return math.inf
    return float(torch.cat([(g - w).norm(dim=1) for g, w in pairs]).mean())


def _gaps(got: dict, want: dict, loud: bool) -> dict:
    """The comparison's numbers on this card (on standard error where
    ``loud``, with each parameter's worst and median gap)."""
    gaps = [abs(a - b) for a, b in zip(got["losses"], want["losses"])]
    if len(got["losses"]) != len(want["losses"]):
        gaps = [math.inf]
    rms = math.sqrt(sum(g * g for g in gaps) / len(gaps))
    for key in ("first_grad", "delta") if loud else ():
        w = want[key]
        med = float(np.median(list(w.values())))
        g = {n: abs(got[key][n] - v) / max(v, med) for n, v in w.items() if v >= 1e-3 * med}
        worst = max(g, key=g.get)
        own = {n: abs(got[key][n] - w[n]) / w[n] for n in (worst, "itm_head.bias") if w[n] > 0}
        print(f"perfbench: {key}: worst {worst} {g[worst]!r}, median parameter's gap "
              f"{float(np.median(list(g.values())))!r}; over their own norm {own!r}",
              file=sys.stderr)
    if loud:
        print(f"perfbench: loss gaps by micro-step {gaps!r} (root-mean-square {rms!r}, not "
              f"judged); hard negatives differing from the reference's draw "
              f"{want['picks_differ']} of {want['picks_compared']} on rank 0", file=sys.stderr)
    return {"loss_gap": max(gaps),
            "first_grad_gap": leaf_gap(got["first_grad"], want["first_grad"]),
            "delta_gap": leaf_gap(got["delta"], want["delta"]),
            "feat_gap": feat_gap(got["feats"], want["feats"])}


def worker(ctx: RunCtx, rank: int, world: int) -> dict:
    import torch.distributed as dist

    from alpro_tpu_torch.cli import common
    from alpro_tpu_torch.core.config import Config
    from alpro_tpu_torch.core.distributed import maybe_initialize
    from alpro_tpu_torch.train.step import make_retrieval_train_step

    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    accum = int(cfg.get("gradient_accumulation_steps", 1))
    check_micro = int(tr["check_opt_steps"]) * accum
    loop_seed = sub_seed(ctx.seed, 33)
    run_cfg = Config(dict(cfg, seed=loop_seed, device=dev.type, output_dir=None,
                          e2e_weights_path=None, visual_weights_path=None))
    maybe_initialize(dev.type)          # the process group, from ALPRO_COORDINATOR
    host_group = dist.new_group(backend="gloo")
    model, layout = port.model_with_weights(ctx)
    batches = make_batches(ctx, port.tokenizer(), rank, world)
    rows = batches[0]["visual_inputs"].shape[0]
    ctx.phase("batches")
    if ctx.control:
        del model
        return _control(ctx, layout, batches, loop_seed, rows)
    step_fn, state, num_train_steps, _ = common.setup_training(
        run_cfg, model, lambda m, opt: make_retrieval_train_step(
            m, opt, num_local_blocks=int(cfg.get("vtm_negative_blocks", 1))),
        int(tr["steps_per_epoch"]))
    names = [n for n, _ in model.named_parameters()]
    b1 = float(cfg["betas"][0])
    got = {"losses": []}

    def judged_step(st, batch, seed, *extras):
        st, metrics = step_fn(st, batch, seed, *extras)
        got["losses"].append(metrics["loss"])
        if st.step == accum:       # the first update: mu = (1 - b1) · the summed gradient
            got["first_grad"] = [torch.linalg.vector_norm(m.float() / (1 - b1))
                                 for m in st.opt_state.mu]
        return st, metrics

    with Recorder() as rec:
        state = common.run_train_loop(run_cfg, judged_step, state, feed(batches, 0), check_micro)
    ctx.phase("the judged steps")
    with torch.no_grad():
        w0 = make_weights(layout, ctx.seed, dev)
        got["delta"] = {n: float(torch.linalg.vector_norm(p - w0[n]))
                        for n, p in model.named_parameters()}
        del w0
    got["losses"] = [float(x) for x in got["losses"]]
    got["first_grad"] = {n: float(x) for n, x in zip(names, got["first_grad"])}
    got["feats"] = rec.feats
    param_gap = _rank_param_gap(list(model.parameters()))
    probe = int(tr["probe_micro_steps"])
    sync(dev)
    t = time.perf_counter()
    state = common.run_train_loop(run_cfg, step_fn, state, feed(batches, check_micro),
                                  check_micro + probe)
    sync(dev)
    per_step = torch.tensor([(time.perf_counter() - t) / probe], dtype=torch.float64)
    dist.all_reduce(per_step, op=dist.ReduceOp.MAX, group=host_group)
    steps = max(1, round(ctx.seconds / float(per_step)))
    setup_end = time.perf_counter()

    spans = ctx.spans
    reset_peak(dev)
    window = Window(ctx, int(tr["span_micro_steps"]), int(tr["trace_micro_steps"]),
                    lead=rank == 0, steps=steps)

    def windowed_step(st, batch, seed, *extras):
        window.before()
        with spans.span("step_fn"):
            out = step_fn(st, batch, seed, *extras)
        if window.after():
            raise WindowClosed
        return out

    try:
        common.run_train_loop(run_cfg, windowed_step, state,
                              feed(batches, check_micro + probe), 1 << 40)
    except WindowClosed:
        pass
    sync(dev)
    seconds = time.perf_counter() - window.t0
    if rank == 0:
        ends = np.asarray(spans.spans["step_fn"])[:, 1] - window.t0
        tenths = np.histogram(ends, bins=10, range=(0.0, seconds))[0]
        print(f"perfbench: rank 0's micro-steps a tenth of the window {tenths.tolist()}",
              file=sys.stderr)
    peak = peak_bytes(dev)
    del step_fn, state, model
    release(dev)

    want = retrieval_dp_steps(make_weights(layout, ctx.seed, dev), cfg,
                              [_on_device(b, dev) for b in batches[:check_micro]], loop_seed,
                              int(tr["check_opt_steps"]), math.ceil(num_train_steps / accum),
                              group=dist.group.WORLD, picks=rec.picks)
    checks = dict(_gaps(got, want, rank == 0), rank_param_gap=param_gap)
    info = {"chips": world,
            "flop_per_clip": retrieval_train_clip(int(cfg["num_frm"]), int(cfg["max_txt_len"])),
            "clips_untraced": (window.micro - window.traced_steps) * rows * world,
            "seconds_untraced": seconds - window.traced_s}
    if window.program is not None:
        info["program"] = window.program
    return {"checks": checks, "micro": window.micro, "rows": rows, "seconds": seconds,
            "peak": peak, "setup_end": setup_end, "info": info,
            "trace": window.tracer.run if window.tracer else None}


def _control(ctx: RunCtx, layout, batches, loop_seed: int, rows: int) -> dict:
    """The reference in fp8 in the program's place on every card, judged by
    the fp32 reference as the program is, the fp32 side reusing the fp8
    side's hard negatives."""
    import torch.distributed as dist

    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    accum = int(cfg.get("gradient_accumulation_steps", 1))
    n_opt = int(tr["check_opt_steps"])
    total = math.ceil(int(tr["steps_per_epoch"]) * cfg["num_train_epochs"] / accum)
    on_dev = [_on_device(b, dev) for b in batches[:n_opt * accum]]
    w0 = make_weights(layout, ctx.seed, dev)
    fp8 = retrieval_dp_steps(w0, cfg, on_dev, loop_seed, n_opt, total, dist.group.WORLD,
                             numerics="fp8")
    want = retrieval_dp_steps(w0, cfg, on_dev, loop_seed, n_opt, total, dist.group.WORLD,
                              picks=fp8["picks"])
    checks = dict(_gaps(fp8, want, dist.get_rank() == 0),
                  rank_param_gap=_rank_param_gap(list(fp8["params"].values())))
    return {"checks": checks, "micro": 0, "rows": rows, "seconds": 1.0,
            "peak": peak_bytes(dev), "setup_end": time.perf_counter(), "info": {},
            "trace": None}


def main(spec_path: str, rank: int) -> int:
    with open(spec_path) as f:
        spec = json.load(f)
    faulthandler.dump_traceback_later(spec["timeout_s"], exit=True)
    dev = torch.device(spec["device"], rank) if spec["device"] == "cuda" \
        else torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    ctx = RunCtx(cell=Cell(**spec["cell"]), seed=spec["seed"], seconds=spec["seconds"],
                 trace=spec["trace"], device=dev, spans=Spans(), control=spec["control"],
                 t_start=spec["t_start"])
    if rank:
        ctx.phase = lambda name: None
    from perfbench.lib.faults import planted

    with planted(spec["fault"]):
        out = worker(ctx, rank, int(spec["world"]))
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 2
    torch.save(out, os.path.join(spec["out"], f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.barrier()      # rank 0 holds the rendezvous store: every worker leaves together
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
