"""Media: the video decode backends (the port's counterpart of
``alpro_tpu/media/__init__.py``).

``read_video`` samples frame indices (the reference-exact samplers, fitted
to the fixed frame count) and reads those frames: of a (T, H, W, C) uint8
clip stored as ``.npy`` (or under ``frames`` in an ``.npz``) through
``NpyVideoBackend``, resized when a size is asked for; of any other path, a
video container, through ``FFmpegVideoBackend``, the native decoder of
``media/binding.py`` (``decoder.cpp``, built at first use), which seeks,
decodes only the sampled frames and resizes them in the decoder. Unlike
the JAX package's ``auto``, no backend gives way to another: a decoder that
does not build raises, and no ``.npy`` reader (which returns None for every
container) takes its place.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from alpro_tpu_torch.data.sampling import fit_num_frames, sample_frame_indices


def _time_window(vlen: int, start_time, end_time, fps) -> tuple:
    """Timestamp → frame-index window, reference-exact: requires fps > 0 when
    either bound is given; indices clamp to vlen."""
    if start_time or end_time:
        assert fps and fps > 0, (
            "must provide video fps if specifying start and end time"
        )
        start_idx = min(int((start_time or 0) * fps), vlen)
        end_idx = min(int((end_time or vlen / fps) * fps), vlen)
        return start_idx, end_idx
    return 0, vlen


def _sample_fitted(vlen, num_frm, sampling, rng, start_time=None,
                   end_time=None, fps=-1) -> Optional[np.ndarray]:
    """Reference-exact sampling adapted to the static-shape pipeline: a
    sampler raise (short video under `uniform`/`rand`, zero `nlvl_rand`
    stride, empty time window) maps to None → resample-another-video, as the
    reference's try/except around decode does; index counts ≠ num_frm are
    evenly fitted. The fps precondition is a config error and raises outside
    the try."""
    start_idx, end_idx = _time_window(vlen, start_time, end_time, fps)
    if end_idx <= start_idx:
        return None
    try:
        idx = sample_frame_indices(
            vlen, num_frm, sampling, rng, start_idx=start_idx, end_idx=end_idx
        )
        if len(idx) == 0:
            return None
    except Exception:
        return None
    return fit_num_frames(idx, num_frm)


class NpyVideoBackend:
    """Reads (T, H, W, C) uint8 clips from .npy/.npz files."""

    def read(
        self,
        path: str,
        num_frm: int,
        sampling: str = "uniform",
        rng: Optional[np.random.Generator] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        start_time: Optional[float] = None,
        end_time: Optional[float] = None,
        fps: float = -1,
    ) -> Optional[np.ndarray]:
        try:
            if path.endswith(".npz"):
                frames = np.load(path)["frames"]
            else:
                frames = np.load(path)
        except Exception:
            return None
        vlen = frames.shape[0]
        idx = _sample_fitted(vlen, num_frm, sampling, rng,
                             start_time, end_time, fps)
        if idx is None:
            return None
        clip = frames[idx]
        if height and width and clip.shape[1:3] != (height, width):
            from alpro_tpu_torch.data.transforms import resize_shorter_side

            clip = resize_shorter_side(clip, min(height, width))
        return clip


class FFmpegVideoBackend:
    """The native FFmpeg decoder (``media/binding.py``); building it is the
    first use's work and raises when it fails."""

    def __init__(self):
        from alpro_tpu_torch.media.binding import get_decoder

        self._dec = get_decoder()

    def read(self, path, num_frm, sampling="uniform", rng=None,
             height=None, width=None, start_time=None, end_time=None,
             fps=-1):
        info = self._dec.probe(path)
        if info is None or info.num_frames <= 0:
            return None
        # timestamps against the container's own rate when none is forced
        # (decord resolves times through the container the same way)
        eff_fps = fps if (fps and fps > 0) else getattr(info, "fps", -1)
        idx = _sample_fitted(info.num_frames, num_frm, sampling, rng,
                             start_time, end_time, eff_fps)
        if idx is None:
            return None
        return self._dec.decode_frames(
            path, idx, height or 0, width or 0,
            native_size=(info.height, info.width),  # no second probe
        )


def get_video_backend(name: str = "auto"):
    """``npy``, ``ffmpeg``, or ``auto`` (the FFmpeg decoder, as in JAX, but
    a failed build raises instead of giving way to ``npy``)."""
    if name == "npy":
        return NpyVideoBackend()
    if name in ("ffmpeg", "auto"):
        return FFmpegVideoBackend()
    raise ValueError(f"unknown video backend {name!r}")


def read_video(path: str, num_frm: int, sampling: str = "uniform",
               rng=None, height=None, width=None, backend=None,
               start_time=None, end_time=None, fps=-1):
    """Sample ``num_frm`` frames of the clip at ``path``. `start_time` /
    `end_time` (seconds) + `fps` restrict sampling to the [start_idx,
    end_idx) frame window. Without a ``backend``, ``.npy``/``.npz`` paths
    go to ``NpyVideoBackend`` and every other path to
    ``FFmpegVideoBackend``. Returns None where the file cannot be read or
    sampled (the caller's retry decides)."""
    if backend is None:
        if path.endswith((".npy", ".npz")):
            backend = NpyVideoBackend()
        else:
            backend = get_video_backend("auto")
    return backend.read(path, num_frm, sampling, rng, height, width,
                        start_time=start_time, end_time=end_time, fps=fps)
