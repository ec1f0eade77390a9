#!/usr/bin/env python3
"""Where the device time of one retrieval finetuning step goes, on one card.

    python3 profile_train.py [--iters 3] [--pretrain]

Builds the retrieval finetuning setup of ``chip_smoke.py`` phase 6
(``chip_smoke._retrieval_train_setup``: fp32 parameters with bf16 compute,
seeded random weights, dropout and drop-path at the configs' rates, B = 8
clips of 8 × 224² and 8 texts, the ``configs/msrvtt_ret.json`` AdamW) and
runs ``torch.profiler`` over ``iters`` train steps under
``attn_impl='pallas'`` and under ``'xla'``, each after two warm-up steps.
Per path it prints host ms per step (synchronised), device kernel ms, busy
ms, idle share and the top kernels by device time, then the kernel launches
per step and the masked-attention kernel's time, launches and share of the
kernel time. Exits non-zero without a CUDA device.

With ``--pretrain`` it profiles instead one pretraining step and one
prompter step at ``chip_smoke.py`` phase 12's cell (ALPRO-base,
``configs/pretrain_alpro.json``'s 4 frames of 224², ``max_txt_len`` 30 and
AdamW, 1000 entities, B = 16 synthetic clips and texts with 15% of the
tokens masked and an erased box), on the kernel path (``attn_impl='pallas'``:
B13 in the student, the eval-mode teacher's B13, K2 and K3) and on the plain
path (no kernel), as phase 12's two runs set them. Per step it prints the
median of ``iters`` synchronised steps without the profiler, then the
profile's host ms, device kernel ms, busy ms and idle share.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time

import torch

import chip_smoke as smoke
from profile_serving import _profile

# the masked-attention kernel's names: its fp32 body, and in bf16 the
# attention body it shares with K1/B6, which a train step launches for the
# masked attention only (chip_smoke's phase 6 holds K1-K5 at 0 launches)
MASKED = ("masked_attn", "attn_wgmma")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--pretrain", action="store_true",
                    help="profile the pretraining and prompter steps instead")
    args = ap.parse_args()
    iters = args.iters
    card = smoke.phase_device()
    smoke.phase_build()
    if args.pretrain:
        _profile_pretrain(iters, card)
        return 0
    model, _, state, step, batch = smoke._retrieval_train_setup(smoke.SEED + 2)
    B = batch["visual_inputs"].shape[0]
    for impl in ("pallas", "xla"):
        smoke._set_attn_impl(model, impl)
        st = _profile(f"retrieval train step B={B}, attn_impl={impl}",
                      lambda: step(state, batch, smoke.SEED), iters, card, top_n=8)
        ms, n = (sum(v[i] for k, v in st["by_name"].items() if any(s in k for s in MASKED))
                 for i in (0, 1))
        total = sum(c for _, c in st["by_name"].values())
        print(f"[profile] attn_impl={impl}: {total} kernel launches per step; masked_attn kernel "
              f"{ms:.3f} ms in {n} launches, {100 * ms / st['kernel_ms']:.1f}% of the kernel time "
              f"[{card}]", flush=True)
    return 0


def _plain(model) -> None:
    """Both towers on the plain path (no kernel), as phase 12's plain runs."""
    vis, bert = model.visual_encoder.model, model.text_encoder.bert
    vis.cfg = dataclasses.replace(vis.cfg, attn_impl="plain", temporal_attn_impl="plain",
                                  mlp_impl="plain")
    bert.cfg = dataclasses.replace(bert.cfg, attn_impl="plain", block_impl="plain")


def _pretrain_batch(vocab: int, B: int, T: int, L: int) -> dict:
    """B synthetic uint8 clips, texts of 8-30 tokens with 15% masked, each
    clip's crop (a 96 × 128 box, zeros around it) and its patch mask."""
    g = torch.Generator(device="cuda").manual_seed(smoke.SEED + 7)
    pixels = torch.randint(0, 256, (B, T, 224, 224, 3), generator=g, device="cuda",
                           dtype=torch.uint8)
    ids = torch.randint(1000, vocab, (B, L), generator=g, device="cuda")
    lengths = torch.randint(8, L + 1, (B, 1), generator=g, device="cuda")
    mask = (torch.arange(L, device="cuda")[None] < lengths).long()
    chosen = (torch.rand(B, L, generator=g, device="cuda") < 0.15) & (mask > 0)
    crop = torch.zeros_like(pixels)
    crop[:, :, 64:160, 48:176] = pixels[:, :, 64:160, 48:176]
    mpm_mask = torch.ones(B, 14, 14, device="cuda")
    mpm_mask[:, 4:10, 3:11] = 0
    return {"visual_inputs": pixels, "text_input_ids": ids * mask, "text_input_mask": mask,
            "mlm_text_input_ids": torch.where(chosen, 103, ids * mask),
            "mlm_labels": torch.where(chosen, ids, -100), "crop_visual_inputs": crop,
            "mpm_mask": mpm_mask}


def _profile_pretrain(iters: int, card: str) -> None:
    from alpro_tpu_torch.models.alpro import build_pretrain_model, build_prompter_model
    from alpro_tpu_torch.train.optimizer import build_optimizer, get_lr_schedule
    from alpro_tpu_torch.train.state import TrainState
    from alpro_tpu_torch.train.step import make_pretrain_train_step, make_prompter_train_step

    cfg = json.loads((smoke.REPO / "configs" / "pretrain_alpro.json").read_text())
    vis_json, T, B = "timesformer_divst_8x32_224_k600.json", cfg["num_frm"], 16
    E = cfg["num_entities"]
    student = smoke._train_model(build_pretrain_model, vis_json, T, "pallas", num_entities=E)
    prompter = smoke._train_model(build_prompter_model, vis_json, T, "pallas")
    teacher = smoke._train_model(build_prompter_model, vis_json, T, "pallas")
    teacher.eval().requires_grad_(False)
    g = torch.Generator(device="cuda").manual_seed(smoke.SEED + 8)
    banks = {k: torch.nn.functional.normalize(torch.randn(E, 256, generator=g, device="cuda"),
                                              dim=-1) for k in ("video", "image")}
    batch = _pretrain_batch(student.cfg.bert.vocab_size, B, T, cfg["max_txt_len"])
    steps = {}
    for name, model, make in (("pretrain", student, make_pretrain_train_step),
                              ("prompter", prompter, make_prompter_train_step)):
        opt = build_optimizer(get_lr_schedule(cfg["decay"], cfg["learning_rate"], 1000),
                              betas=tuple(cfg["betas"]), grad_norm=cfg["grad_norm"])
        state = TrainState.create(model, opt)
        kw = dict(teacher=teacher, banks=banks, num_local_blocks=1) if name == "pretrain" else {}
        step = make(model, opt, **kw)
        extras = ("video",) if name == "pretrain" else ()
        steps[name] = (lambda step=step, state=state, extras=extras:
                       step(state, batch, smoke.SEED, *extras))
    for path in ("kernels", "plain"):
        if path == "plain":
            for model in (student, prompter, teacher):
                _plain(model)
        for name, run in steps.items():
            for _ in range(2):
                run()
            times = []
            for _ in range(iters):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            st = _profile(f"{name} step B={B}, T={T}, {path}", run, iters, card, top_n=8)
            total = sum(c for _, c in st["by_name"].values())
            print(f"[profile] {name} step, {path}: unprofiled step p50 "
                  f"{statistics.median(times):.2f} ms ({', '.join(f'{t:.2f}' for t in times)}); "
                  f"profiled host {st['host_ms']:.2f} ms, kernels {st['kernel_ms']:.2f} ms, busy "
                  f"{st['busy_ms']:.2f} ms, idle {100 * st['idle']:.1f}%, {total} kernel launches "
                  f"per step [{card}]", flush=True)


if __name__ == "__main__":
    sys.exit(main())
