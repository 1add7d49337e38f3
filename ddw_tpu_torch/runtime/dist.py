"""Process-group bootstrap and the data-parallel collectives of the port (the
DP part of ``ddw_tpu.runtime.mesh`` and ``runtime.elastic``).

``ddw_tpu`` runs one SPMD program over a device mesh; the port runs one
process per card (or per CPU worker in tests) joined by ``torch.distributed``:
NCCL on CUDA, gloo on the CPU. The environment contract is ``ddw_tpu``'s:
``DDW_COORDINATOR`` (``host:port`` or ``tcp://host:port``),
``DDW_NUM_PROCESSES`` and ``DDW_PROCESS_ID``; without them a process is a
world of one and every collective is the identity.

:func:`spawn_cpu` is the test launcher: N gloo processes on this host. Gang
supervision and elastic restarts are not yet ported (``ROADMAP.md``).
"""

from __future__ import annotations

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
    ``rank % device_count``) and gloo otherwise."""
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
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init,
                            world_size=world, rank=rank)
    return rank, world


def process_topology() -> tuple[int, int]:
    """``(rank, world_size)`` of this process: the process group's when one
    is initialized, else ``(0, 1)``."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def all_reduce_mean_(tensors: list[torch.Tensor], group=None) -> None:
    """In place: each tensor becomes its mean over ``group`` (the world by
    default; ``lax.pmean``). One collective per dtype: the tensors are
    packed into one flat buffer, summed, divided by the group size and
    unpacked."""
    _, world = process_topology()
    if world > 1 and group is not None:
        world = dist.get_world_size(group)
    if world == 1 or not tensors:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat /= world
        offset = 0
        for t in same:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def barrier() -> None:
    """Wait for every process of the group (no-op in a world of one)."""
    if process_topology()[1] > 1:
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
