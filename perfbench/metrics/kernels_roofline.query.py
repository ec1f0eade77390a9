"""``kernels_roofline.query`` (%): over the port's own kernels in the traced
queries (K4 ``bert_attn`` and K5 ``bert_mlp``, matched by name), the sum of
their least times at the queries' shapes (``counts/kernels.py::
query_bound_s``) over the sum of their device times. Layer: kernels."""

from perfbench.counts.kernels import PORT_KERNELS, query_bound_s


def read(run, info):
    if run is None:
        return None
    device = run.device_seconds(PORT_KERNELS)
    if device <= 0.0:
        return None
    bound = query_bound_s(info["text_len"], info["topk"]) * info["queries_traced"]
    return 100.0 * bound / device
