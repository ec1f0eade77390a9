"""Host-object synchronization across processes (counterpart of
``alpro_tpu/parallel/host_sync.py``).

The reference gathers pickled objects with ``hvd.allgather`` and merges its
eval results through temporary JSON files on a shared filesystem
(``run_video_retrieval.py:697-728``); the port pickles through the default
process group (``all_gather_object``, ``broadcast_object_list``,
``barrier``). In a one-process run each is the identity, as in JAX.
"""

from __future__ import annotations

from typing import Any, List

import torch.distributed as dist

from alpro_tpu_torch.core.distributed import process_info


def _single_process() -> bool:
    return process_info()[1] == 1


def all_gather_list(data: Any) -> List[Any]:
    """One picklable object per process → the list in rank order."""
    if _single_process():
        return [data]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, data)
    return out


def broadcast_object(data: Any, root: int = 0) -> Any:
    """The root process's picklable object, on every process."""
    if _single_process():
        return data
    box = [data if dist.get_rank() == root else None]
    dist.broadcast_object_list(box, src=root)
    return box[0]


def barrier(name: str = "barrier") -> None:
    """Wait until every process has reached the barrier (``name`` is for the
    reader; the JAX function names its sync point)."""
    if _single_process():
        return
    dist.barrier()
