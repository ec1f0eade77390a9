"""The process mesh (counterpart of ``alpro_tpu/core/mesh.py``).

JAX lays a ``Mesh`` of devices and lets GSPMD place the collectives. The
port's mesh is the process groups of a 1-D ``dp`` layout or a 2-D (``dp``,
``sp``) one over the processes of the default group, one process per GPU:
rank ``r`` sits at (``r // SP``, ``r % SP``). The train step all-reduces
over ``dp`` (``train/step.py::shard_step``); ``sp`` is the group of
``parallel/seq_parallel.py``. An axis as wide as the world is the default
group itself (a one-process group included, so that a one-rank run under a
process group still runs its collectives); an axis of one process in a wider
world, or any axis without a process group, has no group, and its
collectives are the identity.

JAX's ambient mesh (``jax.set_mesh`` around the step, read by
``maybe_shard_axis``) is ``use_mesh`` here: the model reads the innermost
mesh's axis through ``active_axis``, and only there does the video tower
split its temporal attention's frames over ``sp``. ``shard_step`` enters it
around each step; param init, eval, ``validate`` and serving run outside
it, unsplit.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from alpro_tpu_torch.core.distributed import process_info, sp_width

DATA_AXIS = "dp"
SEQ_AXIS = "sp"


def axis_names_for_shape(shape) -> tuple:
    """Mesh axis names by rank: 1D → (dp,), 2D → (dp, sp)."""
    n = len(shape)
    if n == 1:
        return (DATA_AXIS,)
    if n == 2:
        return (DATA_AXIS, SEQ_AXIS)
    raise ValueError(f"unsupported mesh rank {n}; use 1 (dp) or 2 (dp, sp)")


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """One axis of the mesh as this process sees it: its width, this
    process's index along it, and the process group of the processes that
    share every other index (None: no collective to run)."""

    name: str
    size: int
    rank: int
    group: Optional[object]


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: tuple
    axis_names: tuple
    axes: tuple

    def __getitem__(self, name: str) -> MeshAxis:
        for axis in self.axes:
            if axis.name == name:
                return axis
        raise KeyError(f"mesh {self.axis_names} has no axis {name!r}")

    @property
    def dp(self) -> MeshAxis:
        return self[DATA_AXIS]

    @property
    def sp_size(self) -> int:
        """The width of ``sp`` (1 on a 1-D mesh)."""
        return sp_width(self.shape)


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("alpro_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Make ``mesh`` the one ``active_axis`` reads inside the block (None:
    no mesh)."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def active_axis(name: Optional[str]) -> Optional[MeshAxis]:
    """Axis ``name`` of the mesh of the innermost ``use_mesh``, where it
    spans more than one process; else None, and the caller runs unsplit
    (JAX's ``maybe_shard_axis`` without an ambient mesh)."""
    mesh = _ACTIVE.get()
    if not name or mesh is None or name not in mesh.axis_names:
        return None
    axis = mesh[name]
    return axis if axis.size > 1 else None


def make_mesh(shape: Optional[Sequence[int]] = None) -> Mesh:
    """The mesh of ``shape`` (default: every process on ``dp``), whose
    product must be the world size. Every process must call it, in the same
    order as its other group creations."""
    rank, world = process_info()
    shape = tuple(int(n) for n in (shape if shape is not None else (world,)))
    names = axis_names_for_shape(shape)
    if math.prod(shape) != world:
        raise ValueError(f"mesh_shape {list(shape)} holds {math.prod(shape)} processes; "
                         f"the run has {world}")
    initialized = dist.is_available() and dist.is_initialized()
    if len(shape) == 1:
        return Mesh(shape, names, (MeshAxis(DATA_AXIS, world, rank,
                                            dist.group.WORLD if initialized else None),))
    dp, sp = shape
    coords = (rank // sp, rank % sp)
    members = {
        DATA_AXIS: [[d * sp + s for d in range(dp)] for s in range(sp)],
        SEQ_AXIS: [[d * sp + s for s in range(sp)] for d in range(dp)],
    }
    axes = []
    for i, name in enumerate(names):
        size, group = shape[i], None
        if initialized and size == world:
            group = dist.group.WORLD
        elif initialized and size > 1:
            for ranks in members[name]:  # every process creates every group
                g = dist.new_group(ranks)
                if rank in ranks:
                    group = g
        axes.append(MeshAxis(name, size, coords[i], group))
    return Mesh(shape, names, tuple(axes))


def replicate(model: torch.nn.Module, opt_state=None) -> None:
    """Give every process rank 0's parameters, buffers and optimizer state
    tensors (``mu``, ``nu``, ``acc``), in place. Nothing to do without a
    process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    tensors = list(model.parameters()) + list(model.buffers())
    if opt_state is not None:
        for name in ("mu", "nu", "acc"):
            tensors += list(getattr(opt_state, name, None) or [])
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0)


def shard_batch(mesh: Mesh, batch: dict, device=None) -> dict:
    """This process's ``dp`` slice of a global host batch — rows
    [rank · b, (rank + 1) · b) of every array, b = rows / dp — moved to
    ``device``. A striped loader already yields that slice: there the
    counterpart is a move to the device alone (``data/loader.py::stage_batch``)."""
    axis = mesh.dp
    out = {}
    for key, value in batch.items():
        t = torch.as_tensor(value)
        if t.shape[0] % axis.size:
            raise ValueError(f"batch {key} of {t.shape[0]} rows does not divide over "
                             f"dp={axis.size}")
        b = t.shape[0] // axis.size
        t = t[axis.rank * b:(axis.rank + 1) * b]
        out[key] = t.to(device) if device is not None else t
    return out
