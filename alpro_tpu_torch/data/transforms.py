"""Host-side video and image transforms, in numpy.

The port's counterpart of ``alpro_tpu/data/transforms.py``: the shorter-side
resize, the square crops and, for the pretraining image pipeline,
``random_resized_crop`` and ``random_hflip``. The JAX package resizes with
Pillow (``Image.BILINEAR`` for videos, ``Image.BICUBIC`` in
``random_resized_crop``); Pillow is not a dependency of the port, so both
resamples are written here in numpy, bit for bit: a separable two-pass
convolution (horizontal, then vertical) whose filter support widens by the
scale when shrinking, coefficients normalized in double and stored as
22-bit fixed point (negative bicubic taps rounded away from zero), and each
pass rounded and clipped to uint8. The normalize runs on the device inside
the model.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

IMAGE_MEAN_CLIP = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD_CLIP = (0.26862954, 0.26130258, 0.27577711)

_PRECISION_BITS = 32 - 8 - 2  # Pillow's 8-bit resample: 22 fraction bits


def _bilinear(x: np.ndarray) -> np.ndarray:
    return np.maximum(1.0 - np.abs(x), 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's cubic convolution kernel with a = -0.5."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


_FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}


def _taps(in_size: int, out_size: int, kind: str) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    ``kind`` filter over the whole input: (first input index (out,),
    fixed-point weights (out, ksize)); taps past a row's last input index
    have weight 0."""
    kernel, base_support = _FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    ss = 1.0 / filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        x = np.arange(xmax, dtype=np.float64)
        k = kernel((x + xmin - center + 0.5) * ss)
        total = np.cumsum(k)[-1] if xmax else 0.0  # summed in order, as in C
        if total != 0.0:
            k = k / total
        # (int)(±0.5 + k · 2^22), truncated toward zero
        scaled = k * (1 << _PRECISION_BITS)
        weights[xx, :xmax] = np.trunc(np.where(k < 0, scaled - 0.5, scaled + 0.5))
        first[xx] = xmin
    return first, weights


def _resample_axis(frames: np.ndarray, axis: int, out_size: int,
                   kind: str = "bilinear") -> np.ndarray:
    """One pass along ``axis`` of a uint8 array: Σ taps from the rounding
    offset 2^21, then >> 22 (a floor) clipped to [0, 255]. The sums fit in
    int32, as in Pillow."""
    in_size = frames.shape[axis]
    first, weights = _taps(in_size, out_size, kind)
    bcast = [1] * frames.ndim
    bcast[axis] = out_size
    out_shape = list(frames.shape)
    out_shape[axis] = out_size
    acc = np.full(out_shape, 1 << (_PRECISION_BITS - 1), np.int32)
    for t in range(weights.shape[1]):
        idx = np.minimum(first + t, in_size - 1)  # a zero weight past the row's end
        acc += frames.take(idx, axis=axis).astype(np.int32) * weights[:, t].reshape(bcast)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize(frames: np.ndarray, height: int, width: int, kind: str = "bilinear") -> np.ndarray:
    """(..., H, W, C) uint8 → (..., height, width, C) as Pillow's
    ``Image.resize((width, height), Image.BILINEAR or Image.BICUBIC)`` gives
    each frame: the horizontal pass first, each pass only where its size
    changes."""
    if frames.dtype != np.uint8:
        raise TypeError(f"resize takes uint8 frames, got {frames.dtype}")
    if frames.shape[-2] != width:
        frames = _resample_axis(frames, frames.ndim - 2, width, kind)
    if frames.shape[-3] != height:
        frames = _resample_axis(frames, frames.ndim - 3, height, kind)
    return frames


def resize_shorter_side(frames: np.ndarray, size: int) -> np.ndarray:
    """(T, H, W, C) uint8 → resized so min(H, W) == size (bilinear, as
    Pillow's)."""
    T, H, W, C = frames.shape
    if H < W:
        nh, nw = size, max(1, round(W * size / H))
    else:
        nh, nw = max(1, round(H * size / W)), size
    if (nh, nw) == (H, W):
        return frames
    return resize(frames, nh, nw)


def random_square_crop(
    frames: np.ndarray, size: int, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Temporally consistent random square crop (ALPRO's
    VideoRandomSquareCrop)."""
    rng = rng or np.random.default_rng()
    T, H, W, C = frames.shape
    assert H >= size and W >= size, f"crop {size} from {H}x{W}"
    top = int(rng.integers(0, H - size + 1))
    left = int(rng.integers(0, W - size + 1))
    return frames[:, top : top + size, left : left + size, :]


def center_square_crop(frames: np.ndarray, size: int) -> np.ndarray:
    T, H, W, C = frames.shape
    top = (H - size) // 2
    left = (W - size) // 2
    return frames[:, top : top + size, left : left + size, :]


def random_resized_crop(
    img: np.ndarray,
    size: int,
    rng: Optional[np.random.Generator] = None,
    scale: Tuple[float, float] = (0.2, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> np.ndarray:
    """torchvision RandomResizedCrop on one (H, W, C) uint8 image, with the
    JAX module's draws: 10 tries of area ∈ scale·HW and log-uniform aspect ∈
    ratio, else the centred fallback with the aspect clamped; then the box
    bicubic-resized to (size, size) as Pillow resizes it."""
    rng = rng or np.random.default_rng()
    H, W = img.shape[:2]
    area = H * W
    log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = np.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        w = int(round(np.sqrt(target_area * aspect)))
        h = int(round(np.sqrt(target_area / aspect)))
        if 0 < w <= W and 0 < h <= H:
            top = int(rng.integers(0, H - h + 1))
            left = int(rng.integers(0, W - w + 1))
            break
    else:  # centred fallback with the aspect clamped (torchvision's)
        in_ratio = W / H
        if in_ratio < ratio[0]:
            w, h = W, int(round(W / ratio[0]))
        elif in_ratio > ratio[1]:
            h, w = H, int(round(H * ratio[1]))
        else:
            w, h = W, H
        top, left = (H - h) // 2, (W - w) // 2
    return resize(img[top: top + h, left: left + w], size, size, "bicubic")


def random_hflip(img: np.ndarray, rng: Optional[np.random.Generator] = None,
                 p: float = 0.5) -> np.ndarray:
    """RandomHorizontalFlip of one (H, W, C) image."""
    rng = rng or np.random.default_rng()
    return img[:, ::-1] if rng.random() < p else img
