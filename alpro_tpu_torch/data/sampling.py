"""Frame-index sampling strategies (the port's copy of
``alpro_tpu/data/sampling.py``).

ALPRO's `dataset_base.py` sampler: all five strategies preserved.
`exact=True` (the default) reproduces the reference index-for-index,
including its quirks:

  * `uniform` is `np.arange(start, end, vlen/num_frm, dtype=int)` on the
    reference's numpy-1.x, which casts start/stop/STEP to int before
    generating — the float step truncates, so the call can return MORE than
    `num_frm` indices (vlen=30, num_frm=8 → step 3 → 10 indices), and raises
    when vlen < num_frm (step truncates to 0). The reference's surrounding
    try/except turns that raise into a resample-another-video.
  * `nlvl_uniform`/`nlvl_rand` use the float grid then `.astype(int)`; with a
    start/end window (DiDeMo timestamps) the count is
    ceil((end-start)·num_frm/vlen), not num_frm.
  * `nlvl_rand` perturbation draws `randint(0, stride)` per index and raises
    on a zero stride (repeated grid values), again handled by resampling.
  * `rand` raises when vlen < num_frm (`random.sample` semantics).
  * `headtail` draws num_frm//2 from EACH half (an odd num_frm yields
    num_frm-1 indices); head and tail are sorted separately, not globally.

`exact=False` is the cleaner static-shape variant: float grid truncated to
`num_frm`, clipped in-range, tolerant of short videos. `rand`/`headtail`/
`nlvl_rand` consume the provided numpy Generator for reproducibility (the
reference uses the global random/np.random state).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def sample_frame_indices(
    vlen: int,
    num_frm: int,
    strategy: str = "uniform",
    rng: Optional[np.random.Generator] = None,
    start_idx: int = 0,
    end_idx: Optional[int] = None,
    exact: bool = True,
) -> np.ndarray:
    if end_idx is None:
        end_idx = vlen
    rng = rng or np.random.default_rng()
    if exact:
        return _sample_exact(vlen, num_frm, strategy, rng, start_idx, end_idx)
    return _sample_clean(vlen, num_frm, strategy, rng, start_idx, end_idx)


def _sample_exact(vlen, num_frm, strategy, rng, start_idx, end_idx) -> np.ndarray:
    if strategy == "uniform":
        # numpy-1.x arange(dtype=int): start/stop/step all cast to int first
        step = int(vlen / num_frm)
        if step == 0:
            raise ValueError(
                f"uniform sampling: vlen {vlen} < num_frm {num_frm} "
                "(reference arange step truncates to 0)"
            )
        return np.arange(int(start_idx), int(end_idx), step)
    if strategy == "nlvl_uniform":
        return np.arange(start_idx, end_idx, vlen / num_frm).astype(int)
    if strategy == "nlvl_rand":
        idx = np.arange(start_idx, end_idx, vlen / num_frm).astype(int)
        strides = [int(idx[i] - idx[i - 1]) for i in range(1, len(idx))]
        strides.append(int(vlen - idx[-1]))
        # rng.integers raises on a zero stride exactly like the reference's
        # np.random.randint(0, 0); callers resample on the exception
        perturb = np.array([rng.integers(0, s) for s in strides], dtype=idx.dtype)
        return idx + perturb
    if strategy == "rand":
        if vlen < num_frm:
            raise ValueError(f"rand sampling: vlen {vlen} < num_frm {num_frm}")
        return np.sort(rng.choice(vlen, size=num_frm, replace=False))
    if strategy == "headtail":
        n = num_frm // 2
        half = vlen // 2
        if half < n or (vlen - half) < n:
            raise ValueError(f"headtail sampling: vlen {vlen} too short for {num_frm}")
        head = np.sort(rng.choice(half, size=n, replace=False))
        tail = np.sort(half + rng.choice(vlen - half, size=n, replace=False))
        return np.concatenate([head, tail])
    raise NotImplementedError(f"Invalid sampling strategy {strategy}")


def _sample_clean(vlen, num_frm, strategy, rng, start_idx, end_idx) -> np.ndarray:
    if strategy in ("uniform", "nlvl_uniform"):
        idx = np.arange(start_idx, end_idx, vlen / num_frm).astype(int)
    elif strategy == "nlvl_rand":
        idx = np.arange(start_idx, end_idx, vlen / num_frm).astype(int)
        strides = np.concatenate([np.diff(idx), [vlen - idx[-1]]])
        perturb = np.array(
            [rng.integers(0, max(s, 1)) for s in strides], dtype=idx.dtype
        )
        idx = idx + perturb
    elif strategy == "rand":
        idx = np.sort(rng.choice(vlen, size=min(num_frm, vlen), replace=False))
    elif strategy == "headtail":
        half = vlen // 2
        n_head = num_frm // 2
        n_tail = num_frm - n_head
        head = np.sort(rng.choice(max(half, 1), size=min(n_head, max(half, 1)), replace=False))
        tail = np.sort(
            half + rng.choice(max(vlen - half, 1), size=min(n_tail, max(vlen - half, 1)), replace=False)
        )
        idx = np.concatenate([head, tail])
    else:
        raise NotImplementedError(f"Invalid sampling strategy {strategy}")
    return np.clip(idx, 0, vlen - 1)[:num_frm]


def fit_num_frames(idx: np.ndarray, num_frm: int) -> np.ndarray:
    """Adapt a reference-exact index list to the fixed frame count the
    static-shape pipeline needs: even subsample when longer (keeping the
    first and last index), repeat-pad the last when shorter. The reference
    feeds the variable count straight to torch (dynamic shapes); the
    batched pipeline wants one shape per config."""
    idx = np.asarray(idx)
    if len(idx) == num_frm:
        return idx
    if len(idx) > num_frm:
        pos = np.round(np.linspace(0, len(idx) - 1, num_frm)).astype(int)
        return idx[pos]
    return np.concatenate([idx, np.repeat(idx[-1:], num_frm - len(idx))])
