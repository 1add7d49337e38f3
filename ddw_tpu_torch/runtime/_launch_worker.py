"""Worker entrypoint for :class:`ddw_tpu_torch.runtime.launcher.Launcher`'s
multi-process mode — the port of ``ddw_tpu.runtime._launch_worker``.

Each spawned process: join the gang's process group through
:func:`ddw_tpu_torch.runtime.dist.init_distributed` (gloo: the ranks of a
one-card machine share the card, where NCCL refuses two ranks on one
device; gloo's all-reduce takes CUDA tensors as they are), unpickle and run
the train fn, and — rank 0 only — write the return value back for the
driver (the HorovodRunner return contract). The device is the train fn's
to pick: nothing here hides the card.

Robustness contract:

- SIGTERM is routed to the graceful-preemption flag before any work starts;
  a step loop that honors it checkpoints and raises ``Preempted``, which this
  process converts to ``EXIT_PREEMPTED`` so the supervisor restarts without
  burning the crash budget.
- A coordinator port-bind failure (the ``free_port`` probe-to-bind race)
  exits ``EXIT_COORD_BIND`` so the launcher respawns the gang on a fresh port
  instead of hanging every other rank until the gang deadline.
- ``result.pkl`` is written atomically (fsync, then ``os.replace``): a rank 0
  killed mid-write leaves either no result (``result-missing``) or a
  complete one — never a torn pickle.
- Elastic mode (``DDW_RENDEZVOUS_DIR`` set by an elastic launcher): the
  gang's topology is the explicit
  :class:`~ddw_tpu_torch.runtime.elastic.GangRendezvous`, not a process
  group (a group admits its ranks once: a respawned rank could never rejoin
  it), so the group is skipped unless ``DDW_ELASTIC_JAX_DIST=1`` re-forms it
  every generation. When a peer dies, this process's train fn raises
  :class:`~ddw_tpu_torch.runtime.elastic.ElasticRestart` at its next chain
  boundary (or parked barrier); the fn is then re-run *in this same
  process* at the bumped generation — restoring from the latest durable
  checkpoint — after the first run's objects are collected and the CUDA
  caching allocator emptied. Exceptions that land while a recovery is
  pending are treated as collateral of the dead peer, not application bugs.
"""

from __future__ import annotations

import os
import pickle
import sys
import traceback

from ddw_tpu_torch.runtime.faults import (
    EXIT_COORD_BIND,
    EXIT_PREEMPTED,
    Preempted,
    install_preemption_handler,
    maybe_fault,
)

_BIND_FAILURE_MARKERS = ("address already in use", "failed to bind",
                         "errno 98", "eaddrinuse", "bind address")


def _looks_like_bind_failure(text: str) -> bool:
    text = text.lower()
    return any(m in text for m in _BIND_FAILURE_MARKERS)


def _write_result(result_path: str, status) -> None:
    """Atomic result write: serialize fully, then publish via os.replace —
    the driver either sees the complete pickle or none at all."""
    try:
        blob = pickle.dumps(status)
    except Exception as e:  # unpicklable return value: report, don't mask
        status = ("error", f"rank-0 return value is not picklable: {e!r}")
        blob = pickle.dumps(status)
    tmp = f"{result_path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, result_path)


def _adopt(rdzv, generation: int) -> None:
    """Join the re-formed gang at ``generation``, then collect the first
    run's model, optimizer and tensors and hand the freed CUDA blocks back,
    so the fn's re-run starts from the memory the process held before."""
    import gc

    import torch

    from ddw_tpu_torch.runtime.elastic import maybe_reinit_distributed

    rdzv.advance(generation)
    rdzv.announce()
    maybe_reinit_distributed()
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
        # the cuBLAS workspaces of every thread that ran a GEMM (the main
        # thread and autograd's) are allocator blocks too; PyTorch's own
        # leak checks clear them the same way
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()


def main() -> int:
    payload_path, result_path = sys.argv[1], sys.argv[2]
    install_preemption_handler()
    maybe_fault("coord_bind")
    from ddw_tpu_torch.runtime.dist import init_distributed
    from ddw_tpu_torch.runtime.elastic import context as elastic_context
    from ddw_tpu_torch.runtime.mesh import is_coordinator

    rdzv = elastic_context()
    if rdzv is not None:
        # Elastic gang: membership/barrier/reduce live in the explicit
        # rendezvous object; the process group stays out (it cannot re-admit
        # a respawned rank) unless DDW_ELASTIC_JAX_DIST=1 re-forms it per
        # generation on the generation's coordinator port.
        from ddw_tpu_torch.runtime.elastic import maybe_reinit_distributed
        rdzv.announce()
        maybe_reinit_distributed()
    else:
        try:
            # DDW_COORDINATOR / DDW_NUM_PROCESSES / DDW_PROCESS_ID; gloo, its
            # rendezvous and collectives bounded by DDW_GANG_TIMEOUT_S
            init_distributed()
        except Exception:
            tb = traceback.format_exc()
            if (os.environ.get("DDW_PROCESS_ID", "0") == "0"
                    and _looks_like_bind_failure(tb)):
                # Coordinator lost the spawn-time port race — a distinguished
                # exit code tells the launcher "respawn on a fresh port", which
                # a generic crash must not trigger.
                sys.stderr.write(tb)
                return EXIT_COORD_BIND
            raise
    with open(payload_path, "rb") as f:
        fn_spec, args, kwargs = pickle.load(f)
    kind, blob, qualname = fn_spec
    if kind == "pickled":
        fn = pickle.loads(blob)
    else:  # "by_file": re-import the driver script under a non-__main__ name
        import importlib.util

        spec = importlib.util.spec_from_file_location("ddw_launched_main", blob)
        mod = importlib.util.module_from_spec(spec)
        sys.modules["ddw_launched_main"] = mod
        spec.loader.exec_module(mod)
        fn = mod
        for part in qualname.split("."):
            fn = getattr(fn, part)
    from ddw_tpu_torch.runtime.elastic import ElasticRestart

    while True:
        adopt = None        # the generation to re-run the fn at
        try:
            value = fn(*args, **kwargs)
            status = ("ok", value)
        except ElasticRestart as e:
            # A peer died and the launcher re-formed the gang: adopt the new
            # generation and re-run the fn IN THIS PROCESS — it restores
            # from the latest durable checkpoint exactly as a whole-world
            # restart would, but the pid, imports, loaded kernels and CUDA
            # context survive. A shrink record remaps this rank's identity
            # inside advance().
            adopt = e.generation
        except Preempted as e:
            # Graceful preemption: the step loop already checkpointed. A
            # clean, distinguished exit lets the supervisor restart outside
            # the crash budget.
            status = ("preempted", {"step": e.step})
        except Exception:
            from ddw_tpu_torch.runtime.faults import preemption_requested

            if preemption_requested():
                # SIGTERM already arrived (the launcher forwards it
                # gang-wide on the first EXIT_PREEMPTED): this exception is
                # almost certainly the collateral collective error of a
                # preempting peer — exit as preempted so the restart stays
                # outside the crash budget.
                status = ("preempted", {"step": None})
            elif rdzv is not None:
                # Collateral of a dead peer (a sync aborted under it while
                # recovery was being posted): park via the elastic path —
                # the same vote/commit-aware check as a parked barrier, so
                # a survivor never adopts a shrink record it vetoed or one
                # the driver has not committed.
                status = ("error", traceback.format_exc())
                try:
                    rdzv._check_recovery(None)
                except ElasticRestart as e2:
                    adopt = e2.generation
            else:
                status = ("error", traceback.format_exc())
        if adopt is None:
            break
        # outside the handler, so the traceback that held the first run's
        # frames is gone before the collection
        _adopt(rdzv, adopt)
    if (os.environ.get("DDW_PROCESS_ID", "0") == "0"
            if rdzv is not None else is_coordinator()):
        _write_result(result_path, status)
    if status[0] == "ok":
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        return 0
    # Error/preemption exits skip interpreter finalization (os._exit): on
    # these paths a peer is typically wedged inside a collective, and a
    # clean exit could block on it until the gang deadline instead of
    # failing fast. The result file is already durable (fsync + rename).
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(EXIT_PREEMPTED if status[0] == "preempted" else 1)


if __name__ == "__main__":
    sys.exit(main())
