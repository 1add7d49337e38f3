"""Process mesh and runtime bootstrap — the port of the process and mesh half
of ``ddw_tpu.runtime.mesh``.

``ddw_tpu`` lays devices out as a named-axis ``jax.sharding.Mesh`` and every
collective names an axis. The port runs one process per device (one card,
or one CPU worker in tests), so a mesh here lays the *ranks* of the
``torch.distributed`` world out in a grid, and an axis name maps to the
process group of this rank's line along that axis: the ranks that differ
only in that coordinate. Ranks fill the grid in row-major order, as
``np.reshape`` fills a mesh of devices. A world of one (no process group)
gives a mesh of one rank whose collectives are the identity.

Axis groups are made with ``dist.new_group`` on the world's backend — gloo
for ranks that share a card, where NCCL refuses two ranks on one device;
NCCL for a world of one rank per card.

Axis conventions are ``ddw_tpu``'s: ``data`` (data parallelism), ``model``
(tensor), ``seq`` (sequence / ring attention), ``pipe`` (pipeline).
Multi-slice meshes (``HybridMeshSpec``, ``make_hybrid_mesh``) are not ported
(``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch.distributed as dist

from ddw_tpu_torch.runtime import dist as _dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"


def _resolve_sizes(sizes: list[int], total: int, kind: str,
                   what: str) -> list[int]:
    """Shared wildcard algebra: one -1 absorbs the remainder; the product
    must come out to ``total``."""
    wild = [k for k, s in enumerate(sizes) if s == -1]
    if len(wild) > 1:
        raise ValueError(f"at most one {kind} size may be -1")
    prod = int(np.prod([s for s in sizes if s != -1]))
    if wild:
        if total % prod:
            raise ValueError(f"{what} not divisible by fixed {kind} "
                             f"sizes {sizes}")
        sizes = list(sizes)
        sizes[wild[0]] = total // prod
        prod = total
    if prod != total:
        raise ValueError(f"{kind} sizes {sizes} multiply to {prod}, "
                         f"expected {what}")
    return sizes


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape by axis name. Size -1 means "absorb the remaining
    ranks"."""

    axes: tuple[tuple[str, int], ...] = ((DATA_AXIS, -1),)

    def resolve(self, n_devices: int) -> tuple[tuple[str, int], ...]:
        sizes = _resolve_sizes([s for _, s in self.axes], n_devices,
                               "axis", f"{n_devices} devices")
        return tuple((a, s) for (a, _), s in zip(self.axes, sizes))


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device=None) -> None:
    """Join the process group: ``runtime.dist.init_distributed`` with
    explicit values, or the environment's ``DDW_COORDINATOR`` /
    ``DDW_NUM_PROCESSES`` / ``DDW_PROCESS_ID``. A no-op for a single process
    (no coordinator anywhere). ``device`` picks the backend as
    ``init_distributed`` does: NCCL for a CUDA device, gloo otherwise."""
    _dist.init_distributed(device, coordinator_address, num_processes,
                           process_id)


def process_index() -> int:
    """This process's rank (``hvd.rank()``)."""
    return _dist.process_topology()[0]


def process_count() -> int:
    """World size in processes (``hvd.size()``)."""
    return _dist.process_topology()[1]


def is_coordinator() -> bool:
    """True on rank 0, the only writer of checkpoints and tracking logs."""
    return process_index() == 0


def local_device_count() -> int:
    """Devices this process drives: one (the port runs a process per
    device)."""
    return 1


def global_device_count() -> int:
    """Devices of the world: one per process."""
    return process_count()


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Ranks laid out on named axes. ``ranks`` is the grid of world ranks
    (shape ``shape``); :meth:`group` is this rank's process group along an
    axis, ``None`` in a world of one (the collectives' world)."""

    axis_names: tuple[str, ...]
    ranks: np.ndarray
    groups: dict

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    def group(self, axis: str):
        if axis not in self.axis_names:
            raise KeyError(f"mesh has no axis {axis!r} (axes "
                           f"{self.axis_names})")
        return self.groups[axis]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        where = np.argwhere(self.ranks == process_index())
        return int(where[0][self.axis_names.index(axis)])


def make_mesh(spec: MeshSpec | Sequence[tuple[str, int]] | None = None,
              ranks: Sequence[int] | None = None) -> Mesh:
    """Lay the world's ranks (or ``ranks``) out on named axes; default a 1-D
    ``data`` mesh over the world.

    A collective over the world: every rank calls it with the same
    arguments, since ``dist.new_group`` must be entered by all ranks for
    every group, members or not. An axis whose lines span the whole world
    reuses the world group."""
    if spec is None:
        spec = MeshSpec()
    if not isinstance(spec, MeshSpec):
        spec = MeshSpec(tuple(spec))
    world = process_count()
    ranks = list(range(world)) if ranks is None else list(ranks)
    shape = spec.resolve(len(ranks))
    names = tuple(a for a, _ in shape)
    grid = np.asarray(ranks, dtype=np.int64).reshape([s for _, s in shape])
    me = process_index()
    groups: dict = {}
    for ax, name in enumerate(names):
        lines = np.moveaxis(grid, ax, -1).reshape(-1, grid.shape[ax])
        for line in lines:
            members = [int(r) for r in line]
            if not dist.is_initialized():
                g = None
            elif len(members) == world:
                g = dist.group.WORLD
            else:
                g = dist.new_group(members)
            if me in members:
                groups[name] = g
    return Mesh(names, grid, groups)


def make_data_mesh(ranks: Sequence[int] | None = None) -> Mesh:
    """The trainers' default 1-D ``data`` mesh over the world."""
    return make_mesh(MeshSpec(((DATA_AXIS, -1),)), ranks=ranks)


def _multislice_not_ported():
    return NotImplementedError(
        "multi-slice meshes (HybridMeshSpec, make_hybrid_mesh) are not "
        "ported to ddw_tpu_torch yet (ROADMAP.md, slice 5); use make_mesh")


class HybridMeshSpec:
    """Not ported: raises, naming ``ROADMAP.md``."""

    def __init__(self, *args, **kwargs):
        raise _multislice_not_ported()


def make_hybrid_mesh(*args, **kwargs):
    """Not ported: raises, naming ``ROADMAP.md``."""
    raise _multislice_not_ported()
