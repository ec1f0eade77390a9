"""``mfu.dp`` (%): model FLOPs of the clips all the cards trained in the
window (``counts/retrieval.py::retrieval_train_clip``: 3 × the forward, no
recompute) over the window's seconds, as a share of the cards' dense bf16
peak (cards × 989 TFLOP/s). The traced micro-steps and the tracer's own
host time are left out of both. Layer: the train step."""

from perfbench.lib.device import PEAK_BF16_FLOPS


def read(run, info):
    if not info.get("seconds_untraced"):
        return None
    flops = info["flop_per_clip"] * info["clips_untraced"]
    return 100.0 * flops / info["seconds_untraced"] / (info["chips"] * PEAK_BF16_FLOPS)
