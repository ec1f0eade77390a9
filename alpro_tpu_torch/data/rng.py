"""Thread-safe numpy RNG for the worker-pool input pipeline (the port's copy
of ``alpro_tpu/data/rng.py``).

Datasets and collators hold one logical RNG but run concurrently in
`BatchLoader` worker threads (the torch-DataLoader num_workers role). numpy
Generators are not thread-safe, so each thread gets its own Generator derived
from the base seed. The first thread to touch the RNG (the main thread in
single-threaded use) gets `default_rng(seed)`, keeping single-worker runs and
tests deterministic.
"""

from __future__ import annotations

import threading

import numpy as np


class ThreadSafeRng:
    """Delegates Generator methods to a per-thread numpy Generator."""

    def __init__(self, seed: int = 0):
        self._seed = seed
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._count = 0

    def _generator(self) -> np.random.Generator:
        rng = getattr(self._tls, "rng", None)
        if rng is None:
            with self._lock:
                idx = self._count
                self._count += 1
            rng = np.random.default_rng(
                self._seed if idx == 0 else [self._seed, idx]
            )
            self._tls.rng = rng
        return rng

    def __getattr__(self, name):
        return getattr(self._generator(), name)
