"""``mfu.train`` (%): model FLOPs (3 × the forward, the checkpointed tower's
recompute not counted; ``counts/model.py::qa_train_clip``) of the clips
trained in the window over the window's seconds, as a share of the cards'
dense bf16 peak (chips × 989 TFLOP/s). The traced micro-steps and the
tracer's own host time are left out of both, since the profiler slows the
host. Layer: the train step (``train/{step,optimizer,state}.py``,
``objectives/``, ``models/remat.py``)."""

from perfbench.lib.device import PEAK_BF16_FLOPS


def read(run, info):
    if not info.get("seconds_untraced"):
        return None
    flops = info["flop_per_clip"] * info["clips_untraced"]
    return 100.0 * flops / info["seconds_untraced"] / (info["chips"] * PEAK_BF16_FLOPS)
