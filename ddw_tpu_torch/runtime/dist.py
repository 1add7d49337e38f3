"""Process-group bootstrap and the data-parallel collectives of the port (the
DP part of ``ddw_tpu.runtime.mesh`` and ``runtime.elastic``).

``ddw_tpu`` runs one SPMD program over a device mesh; the port runs one
process per card (or per CPU worker in tests) joined by ``torch.distributed``:
NCCL on CUDA, gloo on the CPU. The environment contract is ``ddw_tpu``'s:
``DDW_COORDINATOR`` (``host:port`` or ``tcp://host:port``),
``DDW_NUM_PROCESSES`` and ``DDW_PROCESS_ID``; without them a process is a
world of one and every collective is the identity.

:func:`spawn_cpu` is the test launcher: N gloo processes on this host; the
gang launcher with its exit codes, respawns and supervision is
:mod:`ddw_tpu_torch.runtime.launcher`, which starts its ranks through
:func:`init_distributed` and :func:`free_port` too.

Two topology queries: :func:`group_topology` is the process group's (what a
collective spans, the data-parallel world of a step), and
:func:`process_topology` the gang's, generation-aware — the group when one
is initialized, else an elastic gang's rendezvous
(:func:`ddw_tpu_torch.runtime.elastic.context`: its ranks train outside a
process group unless ``DDW_ELASTIC_JAX_DIST`` is set), else a world of one.
Data partitioning, checkpoint writer election and the sharded checkpoint's
commit count read :func:`process_topology`, so after an elastic shrink they
follow the N-1 world.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import socket
import tempfile
import traceback

import torch
import torch.distributed as dist


def init_distributed(device: torch.device | None = None,
                     addr: str | None = None, world: int | None = None,
                     rank: int | None = None) -> tuple[int, int]:
    """Join the process group named by the arguments or, for those not
    given, the environment, and return ``(rank, world)``; a no-op returning
    ``(0, 1)`` without a coordinator address. The backend is NCCL for a
    CUDA ``device`` (which also selects the process's card,
    ``rank % device_count``) and gloo otherwise. ``DDW_GANG_TIMEOUT_S``
    (the gang launcher exports its ``timeout_s`` there) bounds the
    rendezvous and every collective of the group; torch's default
    otherwise."""
    addr = addr or os.environ.get("DDW_COORDINATOR")
    if not addr:
        return 0, 1
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    world = world or int(os.environ.get("DDW_NUM_PROCESSES", "1"))
    rank = rank if rank is not None else int(
        os.environ.get("DDW_PROCESS_ID", "0"))
    if not 0 <= rank < world:
        raise ValueError(f"DDW_PROCESS_ID {rank} out of range for "
                         f"DDW_NUM_PROCESSES {world}")
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    init = addr if addr.startswith("tcp://") else f"tcp://{addr}"
    timeout_s = os.environ.get("DDW_GANG_TIMEOUT_S")
    kw = ({} if not timeout_s
          else {"timeout": datetime.timedelta(seconds=float(timeout_s))})
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init,
                            world_size=world, rank=rank, **kw)
    return rank, world


def group_topology() -> tuple[int, int]:
    """``(rank, world_size)`` in the process group, ``(0, 1)`` without
    one: the ranks a collective spans."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_topology() -> tuple[int, int]:
    """``(rank, world_size)`` of this process in the current generation:
    the process group's when one is initialized, else the elastic gang's
    (its rendezvous context, remapped by every shrink or grow it adopted),
    else ``(0, 1)``."""
    if not (dist.is_available() and dist.is_initialized()):
        from ddw_tpu_torch.runtime.elastic import context

        ctx = context()
        if ctx is not None and ctx.world_size > 0:
            return ctx.rank, ctx.world_size
    return group_topology()


def all_reduce_mean_(tensors: list[torch.Tensor], group=None) -> None:
    """In place: each tensor becomes its mean over ``group`` (the world by
    default; ``lax.pmean``). One collective per dtype: the tensors are
    packed into one flat buffer, summed, divided by the group size and
    unpacked."""
    _all_reduce_(tensors, group, mean=True)


def all_reduce_sum_(tensors: list[torch.Tensor], group=None) -> None:
    """In place: each tensor becomes its sum over ``group``
    (:func:`all_reduce_mean_` without the division)."""
    _all_reduce_(tensors, group, mean=False)


def _all_reduce_(tensors: list[torch.Tensor], group, mean: bool) -> None:
    from ddw_tpu_torch.ops.ring_reduce import group_size_rank

    world = group_size_rank(group)[0]
    if world == 1 or not tensors:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        if mean:
            flat /= world
        offset = 0
        for t in same:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def barrier() -> None:
    """Wait for every process of the group (no-op in a world of one)."""
    if group_topology()[1] > 1:
        dist.barrier()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _ArgsFile(str):
    """The path of a file holding a spawn's pickled arguments."""


def _worker(fn, rank: int, world: int, port: int, args, results) -> None:
    os.environ.update(DDW_COORDINATOR=f"tcp://127.0.0.1:{port}",
                      DDW_NUM_PROCESSES=str(world),
                      DDW_PROCESS_ID=str(rank))
    try:
        if isinstance(args, _ArgsFile):
            with open(args, "rb") as f:
                args = pickle.load(f)
        init_distributed()
        out = fn(*args)
        results.put((rank, "ok", out))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_cpu(fn, nprocs: int, *args, timeout_s: float = 300.0) -> list:
    """Run ``fn(*args)`` in ``nprocs`` fresh processes joined by a gloo
    group on this host; return their results in rank order. ``fn`` must be
    importable (a module-level function). Raises if any rank fails."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    # large arguments travel in a file: a start whose pickle outgrows the
    # pipe's buffer blocks until that child has booted, which would start
    # the ranks one after another (queues and the like, which only a
    # spawn's own pickler carries, stay inline)
    args_path = None
    try:
        blob = pickle.dumps(args)
    except Exception:
        blob = b""
    if len(blob) > 32 * 1024:
        fd, args_path = tempfile.mkstemp(prefix="ddw_spawn_", suffix=".pkl")
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        args = _ArgsFile(args_path)
    procs = [ctx.Process(target=_worker,
                         args=(fn, r, nprocs, port, args, results))
             for r in range(nprocs)]
    out: dict[int, object] = {}
    errors = []
    try:
        for p in procs:
            p.start()
        for _ in range(nprocs):
            rank, status, value = results.get(timeout=timeout_s)
            if status == "ok":
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
    finally:
        for p in procs:
            p.join(timeout=10 if not errors else 1)
            if p.is_alive():
                p.kill()
                p.join()
        if args_path is not None:
            os.unlink(args_path)
    if errors:
        raise RuntimeError("spawned rank failed: " + "\n".join(errors))
    return [out[r] for r in range(nprocs)]
