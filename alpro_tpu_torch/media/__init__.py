"""Media: the ``.npy``/``.npz`` raw-clip video backend.

The port's counterpart of ``alpro_tpu/media/__init__.py`` for the eval path:
``read_video`` samples frame indices (the reference-exact samplers, fitted
to the fixed frame count), reads those frames of a (T, H, W, C) uint8 clip
stored as ``.npy`` (or under ``frames`` in an ``.npz``) and resizes them when
a size is asked for. Decoding container formats (the FFmpeg backend,
``media/binding.py`` and ``decoder.cpp`` of the JAX package) is not ported
(ROADMAP A17): such a path raises, and no blank clip takes its place.
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


def read_video(path: str, num_frm: int, sampling: str = "uniform",
               rng=None, height=None, width=None, backend=None,
               start_time=None, end_time=None, fps=-1):
    """Sample ``num_frm`` frames of the clip at ``path``. `start_time` /
    `end_time` (seconds) + `fps` restrict sampling to the [start_idx,
    end_idx) frame window. Returns None where the file cannot be read or
    sampled (the caller's retry decides); a path that is not ``.npy`` or
    ``.npz`` raises without a ``backend``."""
    if backend is None:
        if not path.endswith((".npy", ".npz")):
            raise NotImplementedError(
                f"{path}: only .npy/.npz clips are read; decoding video "
                "containers (the FFmpeg backend) is not ported yet (ROADMAP A17)"
            )
        backend = NpyVideoBackend()
    return backend.read(path, num_frm, sampling, rng, height, width,
                        start_time=start_time, end_time=end_time, fps=fps)
