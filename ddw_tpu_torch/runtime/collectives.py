"""Collective communication primitives — the port of
``ddw_tpu.runtime.collectives``.

``ddw_tpu`` traces these into the jitted step over a named mesh axis. The
port runs them eagerly between processes: where ``ddw_tpu`` takes an
``axis_name``, these take a ``group`` — ``None`` for the world, a
``torch.distributed`` process group, or ``(mesh, axis)`` for an axis of a
:class:`~ddw_tpu_torch.runtime.mesh.Mesh` — and every rank of the group
calls them in the same order. A tree is a tensor or a dict, list or tuple of
trees; dict leaves are visited in sorted key order, as ``jax.tree`` visits
them. Results are new tensors: the inputs are left as they are, as JAX's
are. Without a process group (a world of one) every collective is the
identity.

The in-tree rings exist at two levels, as in ``ddw_tpu``:
:func:`ring_all_reduce` (point-to-point sends take ``ppermute``'s place) and
:func:`ring_all_reduce_pallas` (K6, ``ddw_tpu_torch.ops.ring_reduce``: a
hand-written CUDA ring over peer-mapped memory on CUDA tensors, its plain
version on CPU tensors). ``all_reduce_sum(tree, impl="pallas")`` rings the
whole tree at once: one K6 launch per ring dtype, where ``ddw_tpu`` chains
one kernel per leaf, with the same bits.
"""

from __future__ import annotations

from typing import Any, Callable, TypeVar

import torch
import torch.distributed as dist

from ddw_tpu_torch.ops import ring_reduce as _rr

T = TypeVar("T")


def _resolve_group(group):
    """``None`` (the world), a process group, or ``(mesh, axis)`` -> a
    process group or ``None``."""
    if isinstance(group, tuple):
        mesh, axis = group
        return mesh.group(axis)
    return group


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every tensor leaf, in ``jax.tree`` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    """The tensor leaves of ``tree``, in ``jax.tree`` order."""
    leaves: list = []
    tree_map(leaves.append, tree)
    return leaves


def tree_unflatten(tree: T, leaves: list) -> T:
    """``tree``'s structure with ``leaves`` in place of its own, in
    ``jax.tree`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _sum(x: torch.Tensor, g) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=g)
    return out


def all_reduce_sum(tree: T, group=None, impl: str = "psum") -> T:
    """Sum a tree across ``group`` (allreduce-sum on every participant).

    ``impl``: ``psum`` (``dist.all_reduce``: NCCL on cards, gloo on the
    CPU), ``ring`` (:func:`ring_all_reduce`) or ``pallas`` (K6,
    :func:`ddw_tpu_torch.ops.ring_reduce.ring_all_reduce_tree_pallas`: the
    CUDA kernel on CUDA tensors, its plain version on CPU tensors). ``psum``
    and ``ring`` reduce leaf by leaf; ``pallas`` rings every leaf of a ring
    dtype together, one K6 launch per dtype group (f32 with bf16 and f16
    widened, int32) while the pack fits a comm slot, each leaf keeping its
    own framing, so the bits are those of a ring per leaf. Its leaves must
    lie on one device."""
    fns = {"psum": _sum, "ring": ring_all_reduce}
    if impl not in (*fns, "pallas"):
        raise KeyError(f"unknown allreduce impl {impl!r} (have psum, ring, "
                       f"pallas)")
    g = _resolve_group(group)
    if _rr.group_size_rank(g)[0] == 1:
        return tree
    if impl == "pallas":
        return tree_unflatten(tree, _rr.ring_all_reduce_tree_pallas(
            tree_leaves(tree), g))
    return tree_map(lambda x: fns[impl](x, g), tree)


def all_reduce_mean(tree: T, group=None) -> T:
    """Mean a tree across ``group`` (``lax.pmean``: the sum over the group
    size) — gradient and metric averaging."""
    g = _resolve_group(group)
    n, _ = _rr.group_size_rank(g)
    if n == 1:
        return tree
    return tree_map(lambda x: _sum(x, g) / n, tree)


def broadcast_from(tree: T, group=None, root: int = 0) -> T:
    """Broadcast group rank ``root``'s values to every participant.

    ``ddw_tpu``'s masked sum, kept as it is: every rank multiplies its
    values by ``rank == root`` and the group sums them. It differs from
    ``dist.broadcast`` where a rank other than ``root`` holds inf or NaN:
    ``inf * 0`` is NaN, and the NaN reaches every rank."""
    g = _resolve_group(group)
    n, me = _rr.group_size_rank(g)
    if n == 1:
        return tree

    def bcast(x):
        return _sum(x * torch.tensor(me == root, dtype=x.dtype), g)

    return tree_map(bcast, tree)


def all_gather_axis(x: torch.Tensor, group=None,
                    tiled: bool = False) -> torch.Tensor:
    """Gather ``x`` from every participant, in group-rank order: stacked on
    a new leading axis, or concatenated along axis 0 with ``tiled``."""
    g = _resolve_group(group)
    n, _ = _rr.group_size_rank(g)
    if n == 1:
        parts = [x]
    else:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=g)
    return torch.cat(parts) if tiled else torch.stack(parts)


def ring_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Explicit ring allreduce over point-to-point sends — ``ddw_tpu``'s
    ``ppermute`` ring, with its framing (chunks padded to a multiple of 1,
    not 128) and its order of additions: the arriving partial sum plus this
    rank's copy of that chunk. Reduce-scatter, then all-gather, ``n - 1``
    hops each; returns the full sum on every participant."""
    g = _resolve_group(group)
    n, me = _rr.group_size_rank(g)
    if n == 1:
        return x
    chunks = _rr.ring_chunks(x, n)  # chunk c is reduced by rank (c-1) % n
    acc = chunks[me]
    for k in range(n - 1):
        acc = _rr.ring_shift(acc, g) + chunks[(me - k - 1) % n]
    # acc on rank r is now the full sum of chunk (r + 1) % n; circulate the
    # completed chunks: gathered[k] is chunk (r - k + 1) % n.
    out = torch.empty_like(chunks)
    block = acc
    out[(me + 1) % n] = block
    for k in range(1, n):
        block = _rr.ring_shift(block, g)
        out[(me - k + 1) % n] = block
    return _rr.ring_unchunk(out, tuple(x.shape), x.numel())


def ring_all_reduce_pallas(x: torch.Tensor, group=None,
                           **kwargs) -> torch.Tensor:
    """Kernel-level ring allreduce (K6) — see
    :func:`ddw_tpu_torch.ops.ring_reduce.ring_all_reduce_pallas`."""
    return _rr.ring_all_reduce_pallas(x, _resolve_group(group), **kwargs)


def host_all_reduce(tag, value, op: str = "sum", timeout_s: float = 120.0):
    """Not ported: ``ddw_tpu``'s reduction over the elastic gang's
    rendezvous comes with the elastic runtime (``ROADMAP.md``, slice 6)."""
    raise NotImplementedError(
        "host_all_reduce runs over the elastic gang's rendezvous, which is "
        "not ported to ddw_tpu_torch yet (ROADMAP.md, slice 6: the elastic "
        "fault-tolerant runtime)")
