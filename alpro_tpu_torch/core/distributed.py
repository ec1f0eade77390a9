"""Multi-process runtime initialization (counterpart of
``alpro_tpu/core/distributed.py``).

The port runs one process per GPU, as the reference's ``horovodrun -np N``
did, and unlike the JAX package, which runs one process per host over all
of that host's chips. Process ``rank`` drives ``cuda:LOCAL_RANK``. Start is
env-gated, with the JAX package's variables, so a one-process run never
opens a process group:

* ``ALPRO_COORDINATOR=host:port`` with ``ALPRO_NUM_PROCESSES`` and
  ``ALPRO_PROCESS_ID``: a ``tcp://host:port`` rendezvous (``LOCAL_RANK``,
  when set, names the card; else the process id modulo the cards seen);
* ``ALPRO_DISTRIBUTED=1``: ``env://``, the variables ``torchrun`` sets
  (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``).

The backend follows the device: NCCL for a CUDA device, gloo for the CPU.
Neither stands in for the other. ``train_batch_size`` stays global: each
process loads ``local_batch_size`` rows of a disjoint stripe
(``data_shards``), and the train step (``train/step.py::shard_step``)
computes the loss, gradients and metrics of the whole batch.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def backend_for(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device!r}")


def local_rank() -> int:
    """The card of this process: ``LOCAL_RANK`` when set, else the rank
    modulo the cards torch sees (0 without a card)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    rank = int(os.environ.get("ALPRO_PROCESS_ID", os.environ.get("RANK", 0)))
    return rank % n if n else 0


def maybe_initialize(device="cuda") -> bool:
    """Open the default process group when the environment asks for one.

    Idempotent: an already open group (a launcher's, or a test's) is kept.
    Returns True when a process group is open. With a CUDA ``device`` the
    process first selects ``cuda:local_rank()``, so that ``torch.device(
    'cuda')`` means its own card."""
    if dist.is_initialized():
        return True
    coord = os.environ.get("ALPRO_COORDINATOR")
    env_init = os.environ.get("ALPRO_DISTRIBUTED", "") not in ("", "0")
    if not coord and not env_init:
        return False
    backend = backend_for(device)
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    if coord:
        dist.init_process_group(backend, init_method=f"tcp://{coord}",
                                world_size=int(os.environ["ALPRO_NUM_PROCESSES"]),
                                rank=int(os.environ["ALPRO_PROCESS_ID"]))
    else:
        dist.init_process_group(backend, init_method="env://")
    return True


def process_info() -> tuple:
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_primary() -> bool:
    """True on rank 0, the process that writes the run's files (the
    reference gates its writes on rank 0, ``run_video_retrieval.py:697-728``)."""
    return process_info()[0] == 0


def sp_width(mesh_shape) -> int:
    """The ``sp`` width of a ``mesh_shape`` (1 unless it is DP SP)."""
    return int(mesh_shape[1]) if mesh_shape is not None and len(mesh_shape) == 2 else 1


def data_shards(mesh_shape=None) -> tuple:
    """(num_shards, shard_id) of this process's dataset stripe, the
    DistributedSampler role; the shared shuffle seed in ``BatchLoader`` keeps
    the stripes disjoint. Under a ``mesh_shape`` (DP, SP) the stripe is the
    dp coordinate, rank // SP: the SP processes of a coordinate share one
    stripe, which sp rank 0 alone reads (``reads_rows``)."""
    rank, world = process_info()
    sp = sp_width(mesh_shape)
    return world // sp, rank // sp


def reads_rows(mesh_shape=None) -> bool:
    """Whether this process's training loader reads its rows: every process
    but an sp rank > 0 of a ``mesh_shape`` (DP, SP), whose train step takes
    sp rank 0's batch (``BatchLoader(placeholder=True)``)."""
    return process_info()[0] % sp_width(mesh_shape) == 0


def local_batch_size(global_batch_size: int, mesh_shape=None) -> int:
    """This process's rows of the global batch, over the dp width of
    ``mesh_shape`` (default every process); ``train_batch_size`` is global,
    as in the JAX package (the reference's was per process)."""
    _, world = process_info()
    dp = world // sp_width(mesh_shape)
    if global_batch_size % dp:
        raise ValueError(f"train_batch_size {global_batch_size} must divide evenly over "
                         f"{dp} data-parallel processes")
    return global_batch_size // dp
