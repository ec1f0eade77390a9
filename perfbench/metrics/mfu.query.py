"""``mfu.query`` (%): the model FLOPs of the queries served in the window
(``counts/model.py::query``: the text half, the VTC similarity, the fusion
half over the top-k pairs) over the serving thread's seconds inside
``RetrievalIndex.query``, as a share of one H100's dense bf16 peak. Layer:
serving (``serving/retrieval.py``, ``serving/inference.py``)."""

from perfbench.lib.device import PEAK_BF16_FLOPS


def read(run, info):
    busy = sum(info.get("service_s", ()))
    if busy <= 0.0:
        return None
    return 100.0 * info["flop_per_query"] * len(info["service_s"]) / busy / PEAK_BF16_FLOPS
