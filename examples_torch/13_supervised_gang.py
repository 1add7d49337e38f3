"""Contract 13 — the supervised gang: fault injection, auto-restart,
forensics (the port's mirror of ``examples/13_supervised_gang.py``).

The reference's recovery story for a dead Horovod rank is "the job aborts;
restart it from the last checkpoint" (Spark-barrier all-or-nothing). This
example runs that story end to end, automated:

1. a 2-process gang with an injected crash (``DDW_FAULT=crash:rank=1:step=3``)
   is supervised by :class:`ddw_tpu_torch.runtime.GangSupervisor` — the gang
   is killed on the crash, relaunched with backoff, and generation 1 resumes
   from the latest durable checkpoint (resume step > 0, not step 0);
2. the same kind of fault with ``max_restarts=0`` surfaces a structured
   :class:`GangFailure` carrying per-attempt exit codes and the rank-0
   traceback.

    python examples_torch/13_supervised_gang.py --quick --device cpu

Each rank steps through a gloo all-reduce on its device (the card unless
``--device cpu``), so a dead rank leaves its peer blocked in a collective —
the case the gang kill exists for.
"""

import argparse
import os
import sys
import tempfile

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)


def supervised_worker(ckpt_dir: str, total_steps: int, device=None) -> dict:
    """Runs in every rank: resume from the newest good checkpoint, then step
    through a cross-process all-reduce, checkpointing each step — the same
    contract the trainers implement (restore + per-step fault/preempt
    hooks)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ddw_tpu_torch.checkpoint.ckpt import CheckpointManager
    from ddw_tpu_torch.runtime.faults import (Preempted, maybe_fault,
                                              preemption_requested)
    from ddw_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    mgr = CheckpointManager(ckpt_dir)
    state = {"w": np.zeros((4,), np.float32), "step": np.asarray(0, np.int32)}
    start = 0
    if mgr.latest_step() is not None:
        state, start = mgr.restore(state)
        start = int(start)
    for step in range(start, total_steps):
        maybe_fault("step", step=step, ckpt_dir=ckpt_dir)
        if preemption_requested():
            mgr.save(state, step, metadata={"preempted": True})
            mgr.wait()
            raise Preempted(step)
        total = torch.ones(1, device=dev)
        if dist.is_initialized():
            dist.all_reduce(total)
        state = {"w": state["w"] + float(total[0]),
                 "step": np.asarray(step + 1, np.int32)}
        mgr.save(state, step + 1)
    mgr.close()
    return {"final_step": int(state["step"]), "resume_step": start,
            "generation": int(os.environ.get("DDW_RESTART_GEN", "0")),
            "device": str(dev)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default=None,
                    help="'cuda' (default: the card) or 'cpu'")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--np", type=int, default=2, dest="nproc")
    args, _ = ap.parse_known_args(argv)

    from ddw_tpu_torch.runtime import GangFailure, GangSupervisor, Launcher

    # the ranks import the package from this checkout
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [os.path.abspath(REPO)] + ([os.environ["PYTHONPATH"]]
                                   if os.environ.get("PYTHONPATH") else []))
    if args.workdir:
        os.makedirs(args.workdir, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="ddw_supervised_gang_",
                               dir=args.workdir)

    print("[1] crash:rank=1:step=3 with max_restarts=2 — auto-restart")
    os.environ["DDW_FAULT"] = "crash:rank=1:step=3"
    sup = GangSupervisor(Launcher(np=args.nproc, timeout_s=300),
                         max_restarts=2, backoff_base_s=0.2, jitter=0.0)
    try:
        out = sup.run(supervised_worker, os.path.join(workdir, "ck1"),
                      args.steps, args.device)
    finally:
        del os.environ["DDW_FAULT"]
    print(f"    final_step={out['final_step']} "
          f"resume_step={out['resume_step']} generation={out['generation']} "
          f"device={out['device']} attempts={[a.kind for a in sup.attempts]}")
    assert out["final_step"] == args.steps and out["resume_step"] > 0

    print("[2] raise:rank=0:step=1 with max_restarts=0 — GangFailure "
          "forensics")
    os.environ["DDW_FAULT"] = "raise:rank=0:step=1"
    try:
        GangSupervisor(Launcher(np=args.nproc, timeout_s=300),
                       max_restarts=0).run(
            supervised_worker, os.path.join(workdir, "ck2"), args.steps,
            args.device)
        raise SystemExit("expected GangFailure")
    except GangFailure as e:
        failure = e
        captured = "FaultInjected" in (e.rank0_traceback or "")
        print(f"    exit_codes={e.exit_codes} "
              f"rank0_traceback_captured={captured}")
    finally:
        del os.environ["DDW_FAULT"]

    print("supervised gang: crash survived via restart-from-checkpoint; "
          "permanent failure surfaced with forensics")
    return {"restarted": out, "attempts": [str(a) for a in sup.attempts],
            "failure_exit_codes": failure.exit_codes,
            "rank0_traceback_captured": captured}


if __name__ == "__main__":
    main()
