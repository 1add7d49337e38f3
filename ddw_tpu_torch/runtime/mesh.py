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

Multi-slice meshes (:class:`HybridMeshSpec`, :func:`make_hybrid_mesh`): a
"slice" is a group of ranks (``ddw_tpu``'s CPU stand-in, where each process
plays one slice). Each axis is ``(name, dcn_size, ici_size)``, laid out
slice-major as ``ddw_tpu`` lays devices out; ``model`` and ``seq`` refuse to
cross slices.

``ddw_tpu``'s models name an axis inside ``shard_map`` (``lax.axis_index``,
``axis_size``). The port's models name it the same way and resolve it
against the mesh bound by :func:`bind_mesh` (the steps bind theirs around
the forward and backward): :func:`axis_group`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Sequence

import numpy as np
import torch.distributed as dist

from ddw_tpu_torch.ops.ring_reduce import group_size_rank
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
    """This process's rank in the process group (``hvd.rank()``)."""
    return _dist.group_topology()[0]


def process_count() -> int:
    """World size in processes of the process group (``hvd.size()``)."""
    return _dist.group_topology()[1]


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
    axis, ``None`` in a world of one (the collectives' world). ``rank`` is
    this process's entry of the grid; ``None`` reads it from the default
    group (:func:`process_index`). A mesh over a group that is not the
    default one (:meth:`over_group`) numbers the grid by the group's own
    ranks and carries this process's rank in it."""

    axis_names: tuple[str, ...]
    ranks: np.ndarray
    groups: dict
    rank: int | None = None

    @classmethod
    def over_group(cls, group, axis: str) -> "Mesh":
        """A 1-D mesh over every rank of ``group`` along ``axis``: the
        grid is the group's ranks ``0..size-1``, and :meth:`axis_index`
        reads this process's rank in the group, not in the default group
        (which need not exist)."""
        size, rank = group_size_rank(group)
        return cls((axis,), np.arange(size, dtype=np.int64),
                   {axis: group}, rank)

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
        me = process_index() if self.rank is None else self.rank
        where = np.argwhere(self.ranks == me)
        return int(where[0][self.axis_names.index(axis)])


def _mesh_from_grid(names: tuple[str, ...], grid: np.ndarray) -> Mesh:
    """The axis groups of a rank grid: a collective over the world, every
    rank enters ``dist.new_group`` for every line of every axis."""
    world = process_count()
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
    ranks = list(range(process_count())) if ranks is None else list(ranks)
    shape = spec.resolve(len(ranks))
    names = tuple(a for a, _ in shape)
    grid = np.asarray(ranks, dtype=np.int64).reshape([s for _, s in shape])
    return _mesh_from_grid(names, grid)


@dataclasses.dataclass(frozen=True)
class HybridMeshSpec:
    """Slice-aware mesh shape: each axis is ``(name, dcn_size, ici_size)``,
    its extent across slices times its extent within a slice, realized as
    one axis of ``dcn_size * ici_size`` ranks laid out slice-major (along
    the axis, same-slice ranks are consecutive and the slice boundary is
    the largest stride). ``model`` and ``seq`` refuse ``dcn_size != 1``:
    their collectives run inside every layer. ``-1`` is allowed once among
    the dcn sizes and once among the ici sizes."""

    axes: tuple[tuple[str, int, int], ...] = ((DATA_AXIS, -1, -1),)

    _DCN_REFUSED = (MODEL_AXIS, SEQ_AXIS)

    def resolve(self, n_slices: int,
                per_slice: int) -> tuple[tuple[str, int, int], ...]:
        dcn_sizes = _resolve_sizes([d for _, d, _ in self.axes], n_slices,
                                   "dcn", f"{n_slices} slices")
        ici_sizes = _resolve_sizes([i for _, _, i in self.axes], per_slice,
                                   "ici", f"{per_slice} devices per slice")
        # refuse after the wildcards resolve: a -1 that comes out 1 is legal
        for (name, _, _), dcn in zip(self.axes, dcn_sizes):
            if name in self._DCN_REFUSED and dcn != 1:
                raise ValueError(
                    f"axis {name!r} with dcn_size={dcn} would put per-layer "
                    f"collectives on the inter-slice network — cross-slice "
                    f"tensor/sequence parallelism is refused; keep "
                    f"{name!r} inside one slice (dcn_size=1) and span "
                    f"slices with 'data' or 'pipe'")
        return tuple((name, d, i) for (name, _, _), d, i
                     in zip(self.axes, dcn_sizes, ici_sizes))


def device_slice_index(rank: int) -> int:
    """The slice a rank belongs to: ``rank // DDW_RANKS_PER_SLICE`` when the
    environment names a slice size, else 0. A rank with no slice
    information is one slice, as ``ddw_tpu`` treats an accelerator without
    ``slice_index``: guessing slices would trade a flat layout for a
    slice-major one with no slower network to justify it."""
    per = int(os.environ.get("DDW_RANKS_PER_SLICE", "0") or 0)
    return rank // per if per > 0 else 0


def make_hybrid_mesh(
    spec: HybridMeshSpec | Sequence[tuple[str, int, int]] | None = None,
    ranks: Sequence[int] | None = None,
    slice_index_fn=None,
) -> Mesh:
    """A slice-aware :class:`Mesh` over the world's ranks (or ``ranks``).
    Ranks group into slices by ``slice_index_fn`` (default
    :func:`device_slice_index`); slices must be equal-sized. Each axis
    realizes as ``dcn_size * ici_size`` laid out slice-major, the layout of
    ``ddw_tpu.runtime.mesh.make_hybrid_mesh``. A collective over the world,
    as :func:`make_mesh`."""
    ranks = list(range(process_count())) if ranks is None else list(ranks)
    if spec is None:
        spec = HybridMeshSpec()
    if not isinstance(spec, HybridMeshSpec):
        spec = HybridMeshSpec(tuple(spec))
    fn = slice_index_fn or device_slice_index
    groups: dict[int, list[int]] = {}
    for r in ranks:
        groups.setdefault(fn(r), []).append(r)
    sizes = {len(g) for g in groups.values()}
    if len(sizes) > 1:
        raise ValueError(f"unequal slices: "
                         f"{sorted((k, len(g)) for k, g in groups.items())}")
    n_slices, per_slice = len(groups), sizes.pop()
    shape = spec.resolve(n_slices, per_slice)
    dcn_dims = tuple(d for _, d, _ in shape)
    ici_dims = tuple(i for _, _, i in shape)
    ordered = [np.asarray(groups[k], np.int64).reshape(ici_dims)
               for k in sorted(groups)]
    # [*dcn, *ici] -> interleave (d_j, i_j) -> fuse each pair: same-slice
    # ranks consecutive along every axis, the slice boundary outermost
    arr = np.stack(ordered).reshape((*dcn_dims, *ici_dims))
    k = len(shape)
    arr = np.transpose(arr, [a for j in range(k) for a in (j, k + j)])
    arr = arr.reshape([d * i for d, i in zip(dcn_dims, ici_dims)])
    return _mesh_from_grid(tuple(name for name, _, _ in shape), arr)


def make_data_mesh(ranks: Sequence[int] | None = None,
                   slice_index_fn=None) -> Mesh:
    """The trainers' default 1-D ``data`` mesh, slice-aware: slice-major
    (:func:`make_hybrid_mesh`) when the ranks span several equal slices,
    the flat mesh otherwise (one slice, or unequal slices)."""
    ranks = list(range(process_count())) if ranks is None else list(ranks)
    fn = slice_index_fn or device_slice_index
    if len({fn(r) for r in ranks}) > 1:
        try:
            return make_hybrid_mesh(((DATA_AXIS, -1, -1),), ranks=ranks,
                                    slice_index_fn=fn)
        except ValueError:
            pass  # unequal slices: the flat mesh is the honest layout
    return make_mesh(MeshSpec(((DATA_AXIS, -1),)), ranks=ranks)


# -- axis names inside a bound mesh (the shard_map role) ----------------------

_BOUND: list = []


@contextlib.contextmanager
def bind_mesh(mesh: Mesh):
    """Bind ``mesh`` for the axis names models use (``seq_axis``,
    ``expert_axis``), as ``shard_map`` binds them in ``ddw_tpu``."""
    _BOUND.append(mesh)
    try:
        yield mesh
    finally:
        _BOUND.pop()


def bound_mesh() -> Mesh | None:
    return _BOUND[-1] if _BOUND else None


def axis_group(axis):
    """``(group, size, index)`` of an axis: a name resolved against the
    bound mesh, a ``(mesh, axis)`` pair, or a process group."""
    if isinstance(axis, tuple):
        mesh, name = axis
    elif isinstance(axis, str):
        mesh, name = bound_mesh(), axis
        if mesh is None:
            raise ValueError(f"axis {axis!r} is not bound: run the model "
                             f"inside runtime.mesh.bind_mesh(mesh)")
    else:
        if axis is None:
            return axis, 1, 0
        size, rank = group_size_rank(axis)
        return axis, size, rank
    return mesh.group(name), mesh.shape[name], mesh.axis_index(name)
