"""Seeded weights in the ALPRO key space, made on the card in a few large
calls and handed alike to the program and to the reference.

Every matrix, embedding and bias is N(0, 0.02²) (BERT's initializer range),
drawn as one flat fp32 tensor from one ``torch.Generator`` on the device;
LayerNorm scales are 1 and their biases 0; ``temp`` is 0.07."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

STD = 0.02
TEMP = 0.07

Layout = List[Tuple[str, Tuple[int, ...]]]


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one use of the run's seed (``path`` names the use)."""
    return int(np.random.SeedSequence([int(seed), *path]).generate_state(1, np.uint64)[0] >> 1)


def _is_norm(name: str) -> bool:
    leaf = name.rsplit(".", 2)
    return any("norm" in part.lower() for part in leaf[-2:-1])


def make_weights(layout: Layout, seed: int, device) -> Dict[str, torch.Tensor]:
    """name → fp32 tensor on ``device`` for each (name, shape) of ``layout``."""
    normal = [(n, s) for n, s in layout if not _is_norm(n) and n != "temp"]
    total = sum(math.prod(s) for _, s in normal)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    flat = torch.empty(total, device=device).normal_(0.0, STD, generator=g)
    out, off = {}, 0
    for n, s in normal:
        k = math.prod(s)
        out[n] = flat[off:off + k].view(s)
        off += k
    for n, s in layout:
        if n == "temp":
            out[n] = torch.full(s, TEMP, device=device)
        elif _is_norm(n):
            out[n] = (torch.ones if n.endswith("weight") else torch.zeros)(s, device=device)
    return out
