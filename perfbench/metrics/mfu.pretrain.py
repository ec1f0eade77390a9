"""``mfu.pretrain`` (%): model FLOPs of the clips trained in the window
(``counts/pretrain.py::pretrain_clip``: the student's 3 × forward, the
teacher's forward of the erased crop; no recompute, no prompt bank) over the
window's seconds, as a share of the card's dense bf16 peak (989 TFLOP/s).
The traced micro-steps and the tracer's own host time are left out of both.
Layer: the train step (``train/step.py``'s pretraining loss, ``objectives/``)."""

from perfbench.lib.device import PEAK_BF16_FLOPS


def read(run, info):
    if not info.get("seconds_untraced"):
        return None
    flops = info["flop_per_clip"] * info["clips_untraced"]
    return 100.0 * flops / info["seconds_untraced"] / (info["chips"] * PEAK_BF16_FLOPS)
