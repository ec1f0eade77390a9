"""ALPRO pretraining through the port's normal path, one card: the student
and the frozen prompter teacher built as ``cli/run_pretrain.py`` builds them
(``common.build_model_from_cfg``, ``build_teacher``), both prompt banks by
``setup_prompt_banks``, ``make_pretrain_train_step`` (VTC + VTM + MLM + MPM)
through ``cli/common.py::setup_training`` and ``run_train_loop``, the tasks
mixed by ``MetaLoader`` through ``mixed_batches``.

Set-up makes a pool of ``pool_batches`` host batches per dataset of
``datasets``, each by the port's ``PretrainCollator`` (the MLM masks and the
MPM erase views) over planted clips (an image: one planted frame repeated to
the clip's frames) and seeded captions of ``words`` words. ``MetaLoader``
draws the task of each micro-step ∝ each dataset's rows over ``cards`` cards
of the configuration's batch, the loaders' lengths; their sum is
``steps_per_epoch``, which sets only the schedule. The vocabulary is
``make_test_vocab`` with the caption words, the templates' words and the
configuration's ``num_entities`` seeded pseudo-word entities, which are
written to the entity file the banks read. The student's and the teacher's
weights come from two sub-seeds of the run's seed; the teacher's
temperature is the configuration's ``assumed.teacher_temp``. Set-up builds
the banks, then drives the step through its first ``check_opt_steps``
optimizer steps through the loop; the window goes on with that step, state
and mix.

End to end: ``train_clips_per_s`` and ``train_peak_gib`` as in
``train_loop.py``. ``correct``: the fp32 reference (``reference/
pretrain.py``) follows those first steps from the same weights on the same
batches and tasks, drawing the same dropout and drop-path masks from (seed,
step), and builds both banks from the same prompts; the program's hard
negatives and the teacher's crop features and soft labels are read where
the step makes them, and so are the student's L2-normed VTC video and text
features, whose mean distance from the reference's (``feat_gap``) judges
the student's training path as the data-parallel cell's does. With random
weights every bank row is nearly the same vector, so at the teacher's
temperature of 0.07 every soft label is nearly uniform and every MPM row is
ignored (at 0.001, the clamp's floor, some half of them are kept on the
card, and under half on some batches): the teacher's part is judged by its
crop features (``teacher_feat_gap``), and ``mpm_ignored_share`` is reported
beside a limit of 1."""

from __future__ import annotations

import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

from perfbench.counts import pretrain as counts
from perfbench.drivers.train_dp import feat_gap
from perfbench.drivers.train_loop import WindowClosed, leaf_gap
from perfbench.lib import port
from perfbench.lib.clips import planted_clips
from perfbench.lib.device import peak_bytes, release, reset_peak, sync
from perfbench.lib.program import Window
from perfbench.lib.recorder import Recorder
from perfbench.lib.runctx import Outcome, RunCtx, check
from perfbench.lib.text import WORDS, captions
from perfbench.lib.weights import make_weights, sub_seed
from perfbench.reference import pretrain as ref_pretrain

_LETTERS = "abcdefghijklmnopqrstuvwxyz"


def entities(n: int) -> list:
    """``n`` distinct pseudo-words of 4-9 letters, the same in every run,
    none of them a caption word."""
    rng, out, seen = np.random.default_rng(2112), [], set(WORDS)
    while len(out) < n:
        word = "".join(rng.choice(list(_LETTERS), size=int(rng.integers(4, 10))))
        if word not in seen:
            seen.add(word)
            out.append(word)
    return out


def tokenizer(ents: list):
    from alpro_tpu_torch.cli.prompts import IMAGE_TEMPLATES, VIDEO_TEMPLATES
    from alpro_tpu_torch.data.tokenization import WordPieceTokenizer, make_test_vocab

    template_words = sorted({w.lower() for t in VIDEO_TEMPLATES + IMAGE_TEMPLATES
                             for w in t.replace("{}", " ").replace(".", " ").split()})
    return WordPieceTokenizer(make_test_vocab(list(WORDS) + template_words + ["."] + ents))


class Pool:
    """One dataset's pool of collated host batches, cycled; its length is
    the dataset's batches a card an epoch (``MetaLoader``'s weight)."""

    def __init__(self, batches: list, length: int):
        self.batches, self.length = batches, length

    def __len__(self):
        return self.length

    def __iter__(self):
        return (dict(b) for b in self.batches)


def make_pools(ctx: RunCtx, tok) -> dict:
    from alpro_tpu_torch.data.datasets import PretrainCollator

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    B, n = int(cfg["train_batch_size"]), int(tr["pool_batches"])
    T, size, L = int(cfg["num_frm"]), int(cfg["crop_img_size"]), int(cfg["max_txt_len"])
    collator = PretrainCollator(tok, L, mlm=True, mpm=True, patch_size=16,
                                seed=sub_seed(ctx.seed, 50))
    pools = {}
    for d, spec in enumerate(tr["datasets"]):
        video = spec["type"] == "video"
        texts = captions(np.random.SeedSequence([ctx.seed, 51, d]), B * n, *tr["words"])
        batches = []
        for i in range(n):
            clips = planted_clips(sub_seed(ctx.seed, 52, d), i * B, B, T if video else 1, size,
                                  ctx.device).cpu().numpy()
            if not video:      # PretrainImageDataset repeats the image to num_frm frames
                clips = np.repeat(clips, T, axis=1)
            batches.append(collator([{"caption": texts[i * B + j], "clip": clips[j],
                                      "type": spec["type"]} for j in range(B)]))
        length = int(spec["rows"]) // (int(tr["cards"]) * B)
        pools[spec["name"]] = Pool(batches, length)
    return pools


def _write_inputs(cfg: dict, ents: list, where: str) -> dict:
    """The configuration's model files and the entity file, as the CLI reads
    them."""
    paths = {}
    for key, value in (("model_config", cfg["model_config"]),
                       ("visual_model_cfg", cfg["visual_model_cfg"])):
        paths[key] = os.path.join(where, f"{key}.json")
        with open(paths[key], "w") as f:
            json.dump(value, f)
    paths["entity_file_path"] = os.path.join(where, "entities.txt")
    with open(paths["entity_file_path"], "w") as f:
        f.write("\n".join(ents) + "\n")
    return paths


def _teacher_temp(cfg: dict) -> float:
    return float(cfg["assumed"]["teacher_temp"])


def _prompts(cfg: dict, tok, ents: list, device) -> dict:
    """Each bank's prompt ids and mask, as ``setup_prompt_banks`` makes them."""
    from alpro_tpu_torch.cli.prompts import IMAGE_TEMPLATES, VIDEO_TEMPLATES, \
        build_prompt_strings

    out = {}
    for name, templates in (("video", VIDEO_TEMPLATES), ("image", IMAGE_TEMPLATES)):
        enc = tok(build_prompt_strings(ents[:int(cfg["num_entities"])], templates),
                  max_length=int(cfg["max_txt_len"]))
        out[name] = (torch.as_tensor(np.asarray(enc["input_ids"]), device=device),
                     torch.as_tensor(np.asarray(enc["attention_mask"]), device=device))
    return out


def _judged_batches(meta_iter, n: int, device) -> tuple:
    """The first ``n`` micro-steps' batches and tasks of a mix, on the device."""
    batches, types = [], []
    for _ in range(n):
        batch, (kind,) = next(meta_iter)
        batches.append({k: torch.from_numpy(v).to(device) for k, v in batch.items()
                        if isinstance(v, np.ndarray)})
        types.append(kind)
    return batches, types


def run(ctx: RunCtx) -> Outcome:
    from alpro_tpu_torch.cli import common, run_pretrain
    from alpro_tpu_torch.core.config import Config
    from alpro_tpu_torch.data.loader import MetaLoader
    from alpro_tpu_torch.train.step import make_pretrain_train_step

    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    B, accum = int(cfg["train_batch_size"]), int(cfg.get("gradient_accumulation_steps", 1))
    check_micro = int(tr["check_opt_steps"]) * accum
    loop_seed = sub_seed(ctx.seed, 43)
    ents = entities(int(cfg["num_entities"]))
    tmp = tempfile.TemporaryDirectory()
    run_cfg = Config(dict(cfg, **_write_inputs(cfg, ents, tmp.name), seed=loop_seed,
                          device=dev.type, output_dir=None, e2e_weights_path=None,
                          visual_weights_path=None, teacher_weights_path=None, n_workers=0))
    ctx.phase("the program imported")
    torch.empty(1, device=dev)
    ctx.phase("the device's context made")
    tok = tokenizer(ents)
    pools = make_pools(ctx, tok)
    meta = run_pretrain.mixed_batches(MetaLoader(pools, accum_steps=accum, seed=loop_seed))
    steps_per_epoch = sum(len(p) for p in pools.values())
    ctx.phase("batches")
    model = common.build_model_from_cfg(run_cfg, "pretrain")
    layout = port.layout(model)
    port.load_weights(model, make_weights(layout, sub_seed(ctx.seed, 40), dev))
    teacher = run_pretrain.build_teacher(run_cfg)
    t_layout = port.layout(teacher)
    t_weights = make_weights(t_layout, sub_seed(ctx.seed, 41), dev)
    t_weights["temp"].fill_(_teacher_temp(cfg))
    port.load_weights(teacher, t_weights)
    del t_weights
    ctx.phase("student and teacher built, weights made and loaded")
    if ctx.control:
        del model, teacher
        return _control(ctx, layout, t_layout, meta, _prompts(cfg, tok, ents, dev), loop_seed,
                        steps_per_epoch)
    banks = run_pretrain.setup_prompt_banks(run_cfg, teacher, tok)
    sync(dev)
    ctx.phase("prompt banks")

    def make_step(m, optimizer):
        return make_pretrain_train_step(
            m, optimizer, use_itc=bool(cfg.get("use_itc", True)),
            use_itm=bool(cfg.get("use_itm", True)), use_mlm=bool(cfg.get("use_mlm", True)),
            use_mpm=True, num_local_blocks=int(cfg.get("vtm_negative_blocks", 1)),
            teacher=teacher, banks=banks)

    step_fn, state, num_train_steps, _ = common.setup_training(run_cfg, model, make_step,
                                                               steps_per_epoch)
    names = [n for n, _ in model.named_parameters()]
    b1 = float(cfg["betas"][0])
    got = {"metrics": [], "batches": [], "types": []}

    def judged_step(st, batch, seed, *extras):
        got["batches"].append(batch)
        got["types"].append(extras[0])
        st, metrics = step_fn(st, batch, seed, *extras)
        got["metrics"].append(metrics)
        if st.step == accum:       # the first update: mu = (1 - b1) · its gradient
            got["first_grad"] = [torch.linalg.vector_norm(m.float() / (1 - b1))
                                 for m in st.opt_state.mu]
        return st, metrics

    with Recorder() as rec:
        state = common.run_train_loop(run_cfg, judged_step, state, meta, check_micro)
    ctx.phase("the judged steps")
    with torch.no_grad():
        w0 = make_weights(layout, sub_seed(ctx.seed, 40), dev)
        got["delta"] = {n: float(torch.linalg.vector_norm(p - w0[n]))
                        for n, p in model.named_parameters()}
        del w0
    got["first_grad"] = {n: float(x) for n, x in zip(names, got["first_grad"])}
    got["banks"] = {k: v.float() for k, v in banks.items()}
    got["picks"], got["labels"], got["feats"] = rec.picks, rec.labels, rec.feats
    sync(dev)
    setup_end = time.perf_counter()

    spans = ctx.spans
    reset_peak(dev)
    window = Window(ctx, int(tr["span_micro_steps"]), int(tr["trace_micro_steps"]))

    def windowed_step(st, batch, seed, *extras):
        window.before()
        with spans.span("step_fn"):
            out = step_fn(st, batch, seed, *extras)
        if window.after():
            raise WindowClosed
        return out

    try:
        common.run_train_loop(run_cfg, windowed_step, state, meta, 1 << 40)
    except WindowClosed:
        pass
    sync(dev)
    t1 = time.perf_counter()
    peak = peak_bytes(dev)
    seconds = t1 - window.t0
    del step_fn, state, model, teacher, banks
    release(dev)

    want = ref_pretrain.pretrain_steps(
        make_weights(layout, sub_seed(ctx.seed, 40), dev), _teacher_weights(ctx, t_layout),
        cfg, got["batches"], got["types"], _prompts(cfg, tok, ents, dev), loop_seed,
        int(tr["check_opt_steps"]), math.ceil(num_train_steps / accum), _teacher_temp(cfg),
        picks=got["picks"])
    checks = _compare(ctx, _program_readings(got), want)
    info = {"chips": 1, "flop_per_clip": counts.pretrain_clip(int(cfg["num_frm"]),
                                                              int(cfg["max_txt_len"])),
            "clips_untraced": (window.micro - window.traced_steps) * B,
            "seconds_untraced": seconds - window.traced_s}
    if window.program is not None:
        info["program"] = window.program
    return Outcome(
        setup_end=setup_end,
        e2e={"train_clips_per_s": window.micro * B / seconds, "train_peak_gib": peak / 2 ** 30},
        attempted=window.micro, failed=0, checks=checks, peak_bytes=peak,
        trace=window.tracer.run if window.tracer else None, info=info)


def _teacher_weights(ctx: RunCtx, t_layout) -> dict:
    w = make_weights(t_layout, sub_seed(ctx.seed, 41), ctx.device)
    w["temp"].fill_(_teacher_temp(ctx.cell.config))
    return w


def _program_readings(got: dict) -> dict:
    """The judged micro-steps' numbers on the host."""
    out = {key: [float(m[key]) for m in got["metrics"]]
           for key in ("loss", "mlm_loss", "mpm_loss")}
    out.update(first_grad=got["first_grad"], delta=got["delta"], banks=got["banks"],
               soft=[x["soft"] for x in got["labels"]],
               ignore=[x["ignore"] for x in got["labels"]],
               teacher_feat=[x["feat"] for x in got["labels"]], picks=got["picks"],
               feats=got["feats"])
    if all("mpm_kept" in m for m in got["metrics"]):
        out["mpm_kept"] = [int(m["mpm_kept"]) for m in got["metrics"]]
    return out


def teacher_feat_gap(got_feat, want_feat) -> float:
    """The mean over the judged micro-steps' erased crops of the L2 distance
    between the program's teacher feature (L2-normed) and the reference's."""
    if [g.shape for g in got_feat] != [w.shape for w in want_feat]:
        return math.inf
    return float(torch.cat([(g - w).norm(dim=1) for g, w in zip(got_feat, want_feat)]).mean())


def _diagnose(got: dict, want: dict) -> None:
    for key in ("loss", "mlm_loss", "mpm_loss"):
        gaps = [abs(a - b) for a, b in zip(got[key], want[key])]
        print(f"perfbench: {key} gaps by micro-step {gaps!r}", file=sys.stderr)
    for key in ("first_grad", "delta"):
        w = want[key]
        med = float(np.median(list(w.values())))
        g = {n: abs(got[key][n] - v) / max(v, med) for n, v in w.items() if v >= 1e-3 * med}
        worst = max(g, key=g.get)
        print(f"perfbench: {key}: worst {worst} {g[worst]!r}, median parameter's gap "
              f"{float(np.median(list(g.values())))!r}, {len(g)} of {len(w)} parameters",
              file=sys.stderr)
    for k, bank in want["banks"].items():
        gap = float((got["banks"][k] - bank).norm(dim=1).max() / bank.norm(dim=1).mean())
        print(f"perfbench: {k} bank: worst row's gap {gap!r} of the mean row norm",
              file=sys.stderr)
    ignored = [float(ig.float().mean()) for ig in got["ignore"]]
    ref_ignored = [float(ig.float().mean()) for ig in want["ignore"]]
    print(f"perfbench: ignored share by "
          f"micro-step {ignored!r} (reference {ref_ignored!r}); largest soft labels' median "
          f"{[float(s.max(dim=1).values.median()) for s in got['soft']]!r}; mpm_kept "
          f"{got.get('mpm_kept')!r}; hard negatives differing from the reference's draw "
          f"{want['picks_differ']} of {want['picks_compared']}", file=sys.stderr)


def _compare(ctx: RunCtx, got: dict, want: dict) -> list:
    _diagnose(got, want)
    gaps = [abs(a - b) for a, b in zip(got["loss"], want["loss"])]
    if len(got["loss"]) != len(want["loss"]):
        gaps = [math.inf]
    mlm = [abs(a - b) for a, b in zip(got["mlm_loss"], want["mlm_loss"])] or [math.inf]
    ignored = torch.cat([ig.flatten() for ig in got["ignore"]]).float()
    print(f"perfbench: loss_gap_rms {math.sqrt(sum(g * g for g in gaps) / len(gaps))!r} "
          f"(not judged)", file=sys.stderr)
    return [check(ctx.cell, "loss_gap", max(gaps)),
            check(ctx.cell, "mlm_loss_gap", max(mlm)),
            check(ctx.cell, "first_grad_gap", leaf_gap(got["first_grad"], want["first_grad"])),
            check(ctx.cell, "delta_gap", leaf_gap(got["delta"], want["delta"])),
            check(ctx.cell, "teacher_feat_gap", teacher_feat_gap(got["teacher_feat"],
                                                                 want["teacher_feat"])),
            check(ctx.cell, "feat_gap", feat_gap(got["feats"], want["feats"])),
            check(ctx.cell, "mpm_ignored_share", float(ignored.mean()))]


def _control(ctx: RunCtx, layout, t_layout, meta, prompts: dict, loop_seed: int,
             steps_per_epoch: int) -> Outcome:
    """The reference in fp8 in the program's place, judged by the fp32
    reference as the program is: on the mix's first micro-steps, the fp32
    side reusing the fp8 side's hard negatives as it reuses the program's."""
    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    accum = int(cfg.get("gradient_accumulation_steps", 1))
    n_opt = int(tr["check_opt_steps"])
    total = math.ceil(math.ceil(steps_per_epoch * cfg["num_train_epochs"]) / accum)
    batches, types = _judged_batches(meta, n_opt * accum, dev)
    w0 = make_weights(layout, sub_seed(ctx.seed, 40), dev)
    tw = _teacher_weights(ctx, t_layout)
    args = (w0, tw, cfg, batches, types, prompts, loop_seed, n_opt, total, _teacher_temp(cfg))
    fp8 = ref_pretrain.pretrain_steps(*args, numerics="fp8")
    want = ref_pretrain.pretrain_steps(*args, picks=fp8["picks"])
    return Outcome(setup_end=time.perf_counter(), e2e={}, attempted=0, failed=0,
                   checks=_compare(ctx, fp8, want), peak_bytes=peak_bytes(dev))
