"""Batching and prefetch (the port's counterpart of ``alpro_tpu/data/loader.py``).

  * ``BatchLoader`` — shuffled or ordered epochs, collated, optionally built
    ahead in a thread pool;
  * ``InfiniteIterator`` — endless epoch cycling;
  * ``MetaLoader`` — the pretraining task mixer: (task, batch) from one of
    several loaders, the task drawn ∝ loader length;
  * ``DevicePrefetcher`` — a thread that stages batch k+1 on the device while
    step k runs, through a bounded queue; with ``stage_batch`` as its
    ``put``, each batch's arrays go to pinned host memory and are copied on
    a side CUDA stream (the reference's PrefetchLoader role).
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch


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


class InfiniteIterator:
    """Cycles ``loader``'s epochs without end (each epoch a new ``iter``)."""

    def __init__(self, loader):
        self.loader = loader
        self._it = iter(loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._it)
        except StopIteration:
            self._it = iter(self.loader)
            return next(self._it)


class MetaLoader:
    """Yields (task_name, batch): the task drawn ∝ loader length from
    ``np.random.default_rng(seed)`` and held for ``accum_steps`` calls, the
    batch from that task's ``InfiniteIterator``."""

    def __init__(self, loaders: Dict[str, object], accum_steps: int = 1, seed: int = 0):
        self.names: List[str] = list(loaders.keys())
        self.iters = {k: InfiniteIterator(v) for k, v in loaders.items()}
        weights = np.asarray([len(loaders[k]) for k in self.names], dtype=np.float64)
        if not weights.sum() > 0:
            raise ValueError(
                "every loader has zero weight (empty dataset or batch_size > "
                f"len(dataset) with drop_last?): {dict(zip(self.names, weights))}")
        self.probs = weights / weights.sum()
        self.accum_steps = accum_steps
        self.rng = np.random.default_rng(seed)
        self._pending = 0
        self._task: Optional[str] = None

    def __iter__(self):
        return self

    def __next__(self):
        if self._pending == 0:
            self._task = self.names[int(self.rng.choice(len(self.names), p=self.probs))]
            self._pending = self.accum_steps
        self._pending -= 1
        return self._task, next(self.iters[self._task])


class StagedBatch:
    """A batch of device tensors whose copy may still be running on a side
    stream; ``wait`` hands it to the consumer's current stream."""

    def __init__(self, tensors: Dict[str, torch.Tensor], event=None, device=None):
        self.tensors = tensors
        self.event = event
        self.device = device

    def wait(self) -> Dict[str, torch.Tensor]:
        """Make the current stream wait for the copy, and tell the caching
        allocator that the current stream uses the tensors (so that their
        memory is not reused while a step still reads them)."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self.event)
            for t in self.tensors.values():
                t.record_stream(stream)
        return self.tensors


def stage_batch(batch: Dict, device: torch.device,
                stream: Optional["torch.cuda.Stream"] = None) -> StagedBatch:
    """The batch's numpy arrays (other entries are dropped, as the JAX loop
    drops them) as tensors on ``device``: on the CPU ``torch.from_numpy``;
    on a card each array is copied into pinned host memory, then to the
    card with ``non_blocking=True`` on ``stream`` (a side stream), with an
    event recorded after the copies."""
    arrays = {k: v for k, v in batch.items()
              if isinstance(v, np.ndarray) and v.dtype != object}
    if device.type != "cuda":
        return StagedBatch({k: torch.from_numpy(v) for k, v in arrays.items()})
    stream = stream or torch.cuda.current_stream(device)
    with torch.cuda.stream(stream):
        tensors = {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
                   for k, v in arrays.items()}
        event = torch.cuda.Event()
        event.record(stream)
    return StagedBatch(tensors, event, device)


class DevicePrefetcher:
    """Wraps an iterator of host batches; a thread applies ``put`` (the
    staging) to batch k+1 while the consumer runs step k, and keeps at most
    ``depth`` staged batches in a queue. An error in the iterator or in
    ``put`` reaches the consumer; ``close`` stops the thread and drops what
    is staged."""

    def __init__(self, it: Iterator, put: Callable, depth: int = 2):
        self._it = iter(it)
        self._put = put
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
        self._done = object()
        self._err: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for item in self._it:
                staged = self._put(item)
                if self._closed:
                    break
                self._q.put(staged)
        except BaseException as e:  # delivered to the consumer, not swallowed
            self._err = e
        finally:
            while not self._closed:  # delivered unless closed
                try:
                    self._q.put(self._done, timeout=0.5)
                    break
                except queue_mod.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._err is not None:
                raise RuntimeError("prefetch worker failed (decode/collate/staging)") from self._err
            raise StopIteration
        return item

    def close(self):
        """Stop the worker and drop the staged batches (else the producer
        blocks on the full queue, holding ``depth`` device batches)."""
        self._closed = True
        self._drain()
        self._thread.join(timeout=30.0)
        self._drain()  # what the producer put in during the join

    def _drain(self):
        try:
            while True:
                self._q.get_nowait()
        except queue_mod.Empty:
            pass
