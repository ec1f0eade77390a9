"""Batching of the eval protocols: ``BatchLoader`` (the port's copy of
``alpro_tpu/data/loader.py::BatchLoader``), shuffled or in order, collated,
optionally built ahead in a thread pool. The device prefetcher, the task
mixer and the endless iterator serve training and are not ported (ROADMAP
A14, A11).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List

import numpy as np


class BatchLoader:
    def __init__(
        self,
        dataset,
        collator: Callable,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        num_shards: int = 1,
        shard_id: int = 0,
        num_workers: int = 0,
        prefetch_factor: int = 2,
    ):
        """num_shards/shard_id shard the (seed-synchronized) shuffled order
        across processes — the DistributedSampler role.

        num_workers > 0 builds batches (decode + augment + collate) in a
        thread pool, keeping up to num_workers * prefetch_factor batches in
        flight ahead of the consumer while preserving batch order — the
        reference's `DataLoader(num_workers=n)` role. Threads, not processes:
        numpy releases the GIL in its array loops, and no batch is pickled
        across process boundaries. Datasets/collators must use thread-local
        RNGs (`data/rng.py`) when num_workers > 1."""
        self.dataset = dataset
        self.collator = collator
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._epoch = 0
        self._seed = seed
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor

    def __len__(self) -> int:
        # ceil-divide like torch's DistributedSampler: every shard is padded
        # to the same size (wrap-around), so __len__ == yielded batch count
        # on every host — lockstep consumers never desync
        n = -(-len(self.dataset) // self.num_shards)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> List[np.ndarray]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self._seed + self._epoch)
            rng.shuffle(order)
        if self.num_shards > 1:
            # pad with wrapped-around indices to a multiple of num_shards
            # (DistributedSampler's padding), then stride
            total = -(-len(order) // self.num_shards) * self.num_shards
            if total > len(order):
                order = np.concatenate([order, order[: total - len(order)]])
            order = order[self.shard_id :: self.num_shards]
        n = len(order)
        self._epoch += 1
        end = n - (n % self.batch_size) if self.drop_last else n
        return [order[s : s + self.batch_size] for s in range(0, end, self.batch_size)]

    def _make(self, idx: np.ndarray) -> Dict:
        return self.collator([self.dataset[int(i)] for i in idx])

    def __iter__(self) -> Iterator[Dict]:
        batches = self._index_batches()
        if self.num_workers <= 0:
            for idx in batches:
                yield self._make(idx)
            return
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        depth = max(self.num_workers * self.prefetch_factor, 1)
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending = deque()
            it = iter(batches)
            for idx in batches[:depth]:
                pending.append(pool.submit(self._make, idx))
                next(it)
            while pending:
                batch = pending.popleft().result()
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(pool.submit(self._make, nxt))
                yield batch
