"""RandAugment with temporally consistent application, in numpy.

The port's counterpart of ``alpro_tpu/data/randaugment.py``, written without
Pillow: ``TemporalConsistentRandomAugment`` draws one op sequence per clip
and applies it to every frame, ``RandomAugment`` to one image. Each op gives
the pixels Pillow 12's gives for the same level (the JAX module calls
Pillow), computed as Pillow computes them:

  * the affine ops (``Rotate``, ``ShearX/Y``, ``TranslateX/Y``):
    ``Image.transform(AFFINE, BILINEAR)`` — each output pixel's centre mapped
    through the matrix in double, a point outside the image filled with 0,
    bilinear taps at (x - 0.5, y - 0.5) with the edge clamped and the row
    below taken as the row itself past the last row; ``Rotate``'s matrix
    about (w/2, h/2) with cos and sin rounded to 15 digits, as
    ``Image.rotate`` builds it;
  * the blends (``Color``, ``Contrast``, ``Brightness``, ``Sharpness``):
    ``Image.blend`` in float32, truncated, clipped for a factor above 1,
    against the integer luma (R·19595 + G·38470 + B·7471 + 2^15) >> 16
    (``Color``), its rounded mean (``Contrast``), black (``Brightness``) or
    the 3×3 ``SMOOTH`` filter (``Sharpness``: float32 taps k/13, +0.5, the
    border rows and columns left as they are);
  * the lookup tables of ``AutoContrast``, ``Equalize``, ``Solarize`` and
    ``Posterize``, built from each frame's histogram as ``ImageOps`` does.

Levels follow the JAX module (MAX_LEVEL 10): enhance factor = level/10·1.8 +
0.1, shear level/10·0.3, translate level/10·10 px, rotate level/10·30°,
solarize threshold level/10·256, posterize bits level/10·4.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

MAX_LEVEL = 10
TRANSLATE_CONST = 10
ROTATE_MAX_DEG = 30


def _enhance_factor(level: float) -> float:
    return (level / MAX_LEVEL) * 1.8 + 0.1


# ---- blends ----------------------------------------------------------------
def _blend(degenerate: np.ndarray, frames: np.ndarray, factor: float) -> np.ndarray:
    """``Image.blend(degenerate, frames, factor)``: in1 + α·(in2 - in1) in
    float32, truncated to uint8 (clipped to [0, 255] outside 0 ≤ α ≤ 1)."""
    a = np.float32(factor)
    in1 = degenerate.astype(np.float32)
    out = in1 + a * (frames.astype(np.float32) - in1)
    return np.clip(out, 0, 255).astype(np.uint8)


def _luma(frames: np.ndarray) -> np.ndarray:
    """``convert('L')`` of (..., 3) uint8: fixed-point ITU-R 601-2 luma."""
    f = frames.astype(np.uint32)
    return ((f[..., 0] * 19595 + f[..., 1] * 38470 + f[..., 2] * 7471 + 0x8000) >> 16
            ).astype(np.uint8)


def _color(frames, level):
    grey = np.repeat(_luma(frames)[..., None], 3, axis=-1)
    return _blend(grey, frames, _enhance_factor(level))


def _contrast(frames, level):
    luma = _luma(frames).reshape(frames.shape[0], -1).astype(np.int64)
    # ImageStat's mean: Σ j·h[j] in float over the pixel count, + 0.5, int
    means = [int(float(row.sum()) / row.size + 0.5) for row in luma]
    degenerate = np.empty_like(frames)
    degenerate[:] = np.asarray(means, np.uint8).reshape(-1, 1, 1, 1)
    return _blend(degenerate, frames, _enhance_factor(level))


def _brightness(frames, level):
    return _blend(np.zeros_like(frames), frames, _enhance_factor(level))


_K1, _K5 = np.float32(1.0 / 13), np.float32(5.0 / 13)


def _smooth(frames: np.ndarray) -> np.ndarray:
    """``filter(ImageFilter.SMOOTH)``: the 3×3 kernel [1 1 1; 1 5 1; 1 1 1]/13
    in float32 on the interior (0.5 + the rows below, centre and above, each
    row's three taps summed left to right), truncated and clipped; the first
    and last rows and columns copied."""
    f = frames.astype(np.float32)
    out = frames.copy()
    if frames.shape[1] < 3 or frames.shape[2] < 3:
        return out

    def row(r, kc):
        return (r[:, :, :-2] * _K1 + r[:, :, 1:-1] * kc) + r[:, :, 2:] * _K1

    ss = np.float32(0.5) + row(f[:, 2:], _K1)
    ss = ss + row(f[:, 1:-1], _K5)
    ss = ss + row(f[:, :-2], _K1)
    out[:, 1:-1, 1:-1] = np.clip(ss, 0, 255).astype(np.uint8)
    return out


def _sharpness(frames, level):
    return _blend(_smooth(frames), frames, _enhance_factor(level))


# ---- lookup tables -----------------------------------------------------------
def _apply_luts(frames: np.ndarray, luts) -> np.ndarray:
    """luts (T, 3, 256): each frame's band b through its own table, its
    entries clipped to [0, 255] as ``Image.point`` reads them."""
    luts = np.clip(np.asarray(luts, np.int64), 0, 255).astype(np.uint8)
    out = np.empty_like(frames)
    for t in range(frames.shape[0]):
        for b in range(3):
            out[t, ..., b] = luts[t, b][frames[t, ..., b]]
    return out


def _histograms(frames: np.ndarray) -> np.ndarray:
    """(T, 3, 256) per-frame, per-band histograms."""
    T = frames.shape[0]
    flat = frames.reshape(T, -1, 3)
    return np.stack([[np.bincount(flat[t, :, b], minlength=256) for b in range(3)]
                     for t in range(T)])


def _autocontrast_lut(h) -> list:
    nz = np.flatnonzero(h)
    lo, hi = (int(nz[0]), int(nz[-1])) if nz.size else (0, 0)
    if hi <= lo:
        return list(range(256))
    scale = 255.0 / (hi - lo)
    offset = -lo * scale
    return [min(max(int(ix * scale + offset), 0), 255) for ix in range(256)]


def _equalize_lut(h) -> list:
    histo = [int(v) for v in h if v]
    if len(histo) <= 1:
        return list(range(256))
    step = (sum(histo) - histo[-1]) // 255
    if not step:
        return list(range(256))
    lut, n = [], step // 2
    for i in range(256):
        lut.append(n // step)
        n = n + int(h[i])
    return lut


def _autocontrast(frames, level):
    hist = _histograms(frames)
    luts = [[_autocontrast_lut(h) for h in bands] for bands in hist]
    return _apply_luts(frames, luts)


def _equalize(frames, level):
    hist = _histograms(frames)
    luts = [[_equalize_lut(h) for h in bands] for bands in hist]
    return _apply_luts(frames, luts)


def _solarize(frames, level):
    threshold = int((level / MAX_LEVEL) * 256)
    return np.where(frames < threshold, frames, 255 - frames).astype(np.uint8)


def _posterize(frames, level):
    bits = max(1, int((level / MAX_LEVEL) * 4))
    return frames & np.uint8(~(2 ** (8 - bits) - 1) & 0xFF)


# ---- geometry ----------------------------------------------------------------
def _affine(frames: np.ndarray, m) -> np.ndarray:
    """``Image.transform(size, AFFINE, m, BILINEAR)`` with fill 0."""
    T, H, W, C = frames.shape
    a0, a1, a2, a3, a4, a5 = (float(v) for v in m)
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float64) + 0.5,
                         np.arange(W, dtype=np.float64) + 0.5, indexing="ij")
    xin = a0 * xx + a1 * yy + a2
    yin = a3 * xx + a4 * yy + a5
    inside = (xin >= 0.0) & (xin < W) & (yin >= 0.0) & (yin < H)
    xin, yin = xin - 0.5, yin - 0.5
    x0, y0 = np.floor(xin), np.floor(yin)
    dx, dy = (xin - x0)[..., None], (yin - y0)[..., None]
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    xa, xb = np.clip(x0, 0, W - 1), np.clip(x0 + 1, 0, W - 1)
    ya = np.clip(y0, 0, H - 1)
    below = (y0 + 1 >= 0) & (y0 + 1 < H)
    yb = np.where(below, np.clip(y0 + 1, 0, H - 1), ya)
    f = frames.astype(np.float64)
    out = np.zeros_like(frames)
    for t in range(T):
        img = f[t]
        p, q = img[ya, xa], img[ya, xb]
        v1 = p + (q - p) * dx
        p, q = img[yb, xa], img[yb, xb]
        v2 = p + (q - p) * dx
        v = v1 + (v2 - v1) * dy
        out[t] = np.where(inside[..., None], v.astype(np.uint8), 0)
    return out


def _rotate(frames, level):
    angle = (-(level / MAX_LEVEL) * ROTATE_MAX_DEG) % 360.0
    if angle == 0:
        return frames.copy()
    H, W = frames.shape[1:3]
    if angle == 180:
        return frames[:, ::-1, ::-1].copy()
    if angle in (90, 270) and W == H:
        return np.ascontiguousarray(np.rot90(frames, 1 if angle == 90 else -1, axes=(1, 2)))
    cx, cy = W / 2, H / 2
    rad = -math.radians(angle)
    a, b = round(math.cos(rad), 15), round(math.sin(rad), 15)
    d, e = round(-math.sin(rad), 15), round(math.cos(rad), 15)
    c = a * -cx + b * -cy + 0.0
    f = d * -cx + e * -cy + 0.0
    return _affine(frames, (a, b, c + cx, d, e, f + cy))


def _shear_x(frames, level):
    return _affine(frames, (1, (level / MAX_LEVEL) * 0.3, 0, 0, 1, 0))


def _shear_y(frames, level):
    return _affine(frames, (1, 0, 0, (level / MAX_LEVEL) * 0.3, 1, 0))


def _translate_x(frames, level):
    return _affine(frames, (1, 0, (level / MAX_LEVEL) * TRANSLATE_CONST, 0, 1, 0))


def _translate_y(frames, level):
    return _affine(frames, (1, 0, 0, 0, 1, (level / MAX_LEVEL) * TRANSLATE_CONST))


def _identity(frames, level):
    return frames


def _hflip(frames, level):
    return frames[:, :, ::-1]


# each op maps (T, H, W, 3) uint8 frames and a level to new frames
OPS = {
    "Identity": _identity,
    "AutoContrast": _autocontrast,
    "Equalize": _equalize,
    "Rotate": _rotate,
    "HorizontalFlip": _hflip,
    "Solarize": _solarize,
    "Posterize": _posterize,
    "Color": _color,
    "Contrast": _contrast,
    "Brightness": _brightness,
    "Sharpness": _sharpness,
    "ShearX": _shear_x,
    "ShearY": _shear_y,
    "TranslateX": _translate_x,
    "TranslateY": _translate_y,
}

DEFAULT_VIDEO_AUGS = [
    "Identity", "Contrast", "Brightness", "Sharpness", "ShearX", "ShearY",
    "TranslateX", "TranslateY", "Rotate", "HorizontalFlip",
]


class TemporalConsistentRandomAugment:
    """Draw N ops (without replacement) once per clip and apply the same
    sequence to every frame; ``p`` is the per-op skip probability (0:
    always applied). The draws are the JAX module's, from ``rng``."""

    def __init__(self, N: int = 2, M: int = 5, p: float = 0.0,
                 augs: Optional[Sequence[str]] = None,
                 rng: Optional[np.random.Generator] = None):
        self.N = N
        self.M = M
        self.p = p
        self.augs = list(augs) if augs else DEFAULT_VIDEO_AUGS
        for a in self.augs:
            if a not in OPS:
                raise ValueError(f"unknown augmentation {a!r}")
        self.rng = rng or np.random.default_rng()

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        """frames: (T, H, W, 3) uint8 → augmented (T, H, W, 3) uint8."""
        if frames.ndim != 4 or frames.shape[-1] != 3 or frames.dtype != np.uint8:
            raise ValueError(f"expected (T, H, W, 3) uint8 RGB, got {frames.shape} "
                             f"{frames.dtype}")
        names = self.rng.choice(self.augs, self.N, replace=False)
        apply = self.rng.random(self.N) > self.p
        out = frames
        for name, a in zip(names, apply):
            if a:
                out = OPS[name](out, self.M)
        return np.ascontiguousarray(out)


class RandomAugment(TemporalConsistentRandomAugment):
    """The per-image form (the CC3M image pipeline): (H, W, 3) in and out."""

    def __call__(self, img: np.ndarray) -> np.ndarray:
        return super().__call__(img[None])[0]
