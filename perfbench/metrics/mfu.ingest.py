"""``mfu.ingest`` (%): the model's FLOPs of the clips ingested in the window
(``counts/model.py::ingest_clip``) over the window's seconds, as a share of
one H100's dense bf16 peak (989 TFLOP/s at 700 W). The traced span and the
tracer's own host time are left out of both, since the profiler slows the
host. Layer: the model step (``models/{timesformer,alpro}.py`` through
``serving/inference.py``)."""

from perfbench.lib.device import PEAK_BF16_FLOPS


def read(run, info):
    if not info.get("seconds_untraced"):
        return None
    flops = info["flop_per_clip"] * info["clips_untraced"]
    return 100.0 * flops / info["seconds_untraced"] / (info["chips"] * PEAK_BF16_FLOPS)
