"""Multi-clip logit pooling of open-ended video QA.

The port's own copy of ``alpro_tpu/evals/qa.py::pool_clip_logits`` (the
reference's mean / max / lse ensembling of per-clip logits), on numpy.
"""

from __future__ import annotations

import numpy as np


def pool_clip_logits(logits: np.ndarray, method: str = "mean") -> np.ndarray:
    """(num_clips, B, L) per-clip logits → (B, L)."""
    if method == "mean":
        return logits.mean(axis=0)
    if method == "max":
        return logits.max(axis=0)
    if method == "lse":
        m = logits.max(axis=0, keepdims=True)
        return np.log(np.exp(logits - m).sum(axis=0)) + m[0]
    raise ValueError(f"invalid pool method {method!r}")
