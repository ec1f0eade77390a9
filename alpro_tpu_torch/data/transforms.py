"""Host-side video transforms of the eval path, in numpy.

The port's counterpart of ``alpro_tpu/data/transforms.py``: the shorter-side
resize and the square crops. The JAX package resizes with Pillow's
``Image.BILINEAR``; Pillow is not a dependency of the port, so
``resize_shorter_side`` is that resample written in numpy, bit for bit: a
separable two-pass convolution (horizontal, then vertical) with a triangle
filter whose support widens by the scale when shrinking, coefficients
normalized in double and stored as 22-bit fixed point, and each pass rounded
and clipped to uint8. The normalize runs on the device inside the model.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

IMAGE_MEAN_CLIP = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD_CLIP = (0.26862954, 0.26130258, 0.27577711)

_PRECISION_BITS = 32 - 8 - 2  # Pillow's 8-bit resample: 22 fraction bits


def _bilinear_taps(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    bilinear filter (support 1) over the whole input: (first input index
    (out,), fixed-point weights (out, ksize)); taps past a row's last input
    index have weight 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        x = np.arange(xmax, dtype=np.float64)
        k = np.maximum(1.0 - np.abs((x + xmin - center + 0.5) / filterscale), 0.0)
        total = k.sum()
        if total != 0.0:
            k = k / total
        # (int)(0.5 + k · 2^22): k >= 0, so truncation is the floor
        weights[xx, :xmax] = (0.5 + k * (1 << _PRECISION_BITS)).astype(np.int32)
        first[xx] = xmin
    return first, weights


def _resample_axis(frames: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One pass along ``axis`` of a uint8 array: Σ taps from the rounding
    offset 2^21, then >> 22 clipped to [0, 255]. The sums fit in int32, as
    in Pillow: the weights are positive and sum to 2^22 within ksize."""
    in_size = frames.shape[axis]
    first, weights = _bilinear_taps(in_size, out_size)
    bcast = [1] * frames.ndim
    bcast[axis] = out_size
    out_shape = list(frames.shape)
    out_shape[axis] = out_size
    acc = np.full(out_shape, 1 << (_PRECISION_BITS - 1), np.int32)
    for t in range(weights.shape[1]):
        idx = np.minimum(first + t, in_size - 1)  # a zero weight past the row's end
        acc += frames.take(idx, axis=axis).astype(np.int32) * weights[:, t].reshape(bcast)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(frames: np.ndarray, height: int, width: int) -> np.ndarray:
    """(..., H, W, C) uint8 → (..., height, width, C) as Pillow's
    ``Image.resize((width, height), Image.BILINEAR)`` gives each frame: the
    horizontal pass first, each pass only where its size changes."""
    if frames.dtype != np.uint8:
        raise TypeError(f"resize_bilinear takes uint8 frames, got {frames.dtype}")
    if frames.shape[-2] != width:
        frames = _resample_axis(frames, frames.ndim - 2, width)
    if frames.shape[-3] != height:
        frames = _resample_axis(frames, frames.ndim - 3, height)
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
    return resize_bilinear(frames, nh, nw)


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
