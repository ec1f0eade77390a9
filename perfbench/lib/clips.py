"""Seeded uint8 clips, made on the card, as a decoder hands them over:
already sampled to the model's frames and cropped to its size.

Each clip has a feature of its own, so that the towers tell clips apart (on
i.i.d. noise every clip looks alike to them and every score is a near tie):
a base colour, a colour gradient whose direction drifts over the frames, and
±24 levels of noise (after ``chip_smoke.py::_planted_clip``)."""

from __future__ import annotations

import math

import torch

from perfbench.lib.weights import sub_seed


def planted_clips(seed: int, first: int, n: int, frames: int, size: int, device) -> torch.Tensor:
    """Clips ``first`` .. ``first + n - 1`` of the seed's sequence as
    (n, frames, size, size, 3) uint8 on ``device``: clip i is the same
    whatever block it is made in."""
    out = torch.empty((n, frames, size, size, 3), dtype=torch.uint8, device=device)
    yy, xx = torch.meshgrid(torch.arange(size, device=device, dtype=torch.float32) / size,
                            torch.arange(size, device=device, dtype=torch.float32) / size,
                            indexing="ij")
    t = torch.arange(frames, device=device, dtype=torch.float32)[:, None, None] / frames
    for i in range(n):
        g = torch.Generator(device=device).manual_seed(sub_seed(seed, 2, first + i))
        u = torch.rand(9, generator=g, device=device)
        base, slope = 48 + 160 * u[:3], -80 + 160 * u[3:6]
        angle, drift = 2 * math.pi * u[6], -0.5 + u[7]
        a = angle + drift * t                                     # (T, 1, 1)
        ramp = torch.cos(a) * xx + torch.sin(a) * yy              # (T, H, W)
        img = base + slope * ramp[..., None]
        img += torch.rand((frames, size, size, 3), generator=g, device=device) * 48 - 24
        out[i] = img.round_().clamp_(0, 255).to(torch.uint8)
    return out
