#!/usr/bin/env python3
"""Where the device time of one retrieval finetuning step goes, on one card.

    python3 profile_train.py [--iters 3]

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
"""

from __future__ import annotations

import argparse
import sys

import chip_smoke as smoke
from profile_serving import _profile

# the masked-attention kernel's names: its fp32 body, and in bf16 the
# attention body it shares with K1/B6, which a train step launches for the
# masked attention only (chip_smoke's phase 6 holds K1-K5 at 0 launches)
MASKED = ("masked_attn", "attn_wgmma")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=3)
    iters = ap.parse_args().iters
    card = smoke.phase_device()
    smoke.phase_build()
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


if __name__ == "__main__":
    sys.exit(main())
