"""Seeded kill / shrink / re-expand gang drill of ddw_tpu_torch — the N−1
elastic reshard story end to end, as a CLI (``tools/gang_drill.py`` for the
PyTorch port: the same drill, the same verdict, the port's runtime).

One command drills the full verdict ladder on real processes: an N-rank
elastic gang loses its last rank PERMANENTLY (``host_lost`` — exit 85,
respawn pointless), the survivors vote the two-phase shrink record and continue at N−1, then a
replacement "host" comes back and the gang re-expands to N at the next
generation boundary (``Launcher.request_grow``). The drill worker's
per-step gang reduce is a coverage vector over virtual samples partitioned
by ``ShardedLoader.shard_plan`` at the CURRENT (rank, world) — exactly the
loader-rebalance contract — so the run itself proves every sample is
covered exactly once per step at N, N−1 and back at N.

Verdict: the drill's final params must be BIT-IDENTICAL to an
uninterrupted N-rank run's (the per-step update is world-independent and
resume restores the exact stream position), and every step's coverage must
be exact. Any mismatch exits nonzero — this is a CI gate, not a report.

Usage::

    python tools/torch_gang_drill.py [--np 4] [--steps 8] [--kill-step 2]
                                     [--no-regrow] [--out DIR]

CI smoke: ``DDW_DRILL_SMOKE=1`` shrinks to a 3-rank, 5-step drill.
Prints ONE JSON line::

    {"verdict": "ok"|"mismatch", "np": ..., "events": [...],
     "drill": {...}, "reference": {...}, "bit_identical": true, ...}
"""

import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import argparse
import json
import tempfile
import threading
import time

N_SAMPLES = 8


def drill_worker(ckpt_dir: str, total_steps: int) -> dict:
    """Supervised elastic worker (the test-suite shrink-drill contract):
    checkpoint via the rank-0 writer, per-step fault hook + chain-boundary
    park hook, and a shard_plan coverage vector as the per-step gang
    reduce. World-independent updates make the final params comparable
    bit-for-bit across any kill/shrink/regrow timeline."""
    import numpy as np

    from ddw_tpu_torch.checkpoint.ckpt import CheckpointManager
    from ddw_tpu_torch.data.loader import ShardedLoader
    from ddw_tpu_torch.runtime import elastic
    from ddw_tpu_torch.runtime.faults import maybe_fault

    mgr = CheckpointManager(ckpt_dir, keep=total_steps + 2)
    state = {"w": np.zeros((N_SAMPLES,), np.float32),
             "step": np.asarray(0, np.int32)}
    start = 0
    if mgr.latest_step() is not None:
        state, start = mgr.restore(state)
        start = int(start)
    elastic.elastic_barrier("start")
    coverage_ok = True
    worlds = []
    for step in range(start, total_steps):
        maybe_fault("step", step=step, ckpt_dir=ckpt_dir)
        elastic.maybe_elastic_restart(step=step)
        rank, world = elastic.process_topology()
        worlds.append(world)
        contrib = np.zeros((N_SAMPLES + 1,), np.float64)
        contrib[0] = 1.0
        for i in ShardedLoader.shard_plan(N_SAMPLES, world)[rank]:
            contrib[i + 1] = float(i + 1)
        tot = elastic.host_all_reduce(step, contrib)
        coverage_ok = (coverage_ok and tot[0] == world
                       and bool(np.array_equal(
                           tot[1:], np.arange(1., N_SAMPLES + 1.))))
        state = {"w": state["w"] + tot[1:].astype(np.float32),
                 "step": np.asarray(step + 1, np.int32)}
        mgr.save(state, step + 1)
    mgr.close()
    ctx = elastic.context()
    return {"final_step": int(state["step"]), "resume_step": start,
            "w": [float(x) for x in state["w"]], "pid": os.getpid(),
            "egen": ctx.generation if ctx is not None else 0,
            "worlds": worlds, "coverage_ok": bool(coverage_ok)}


def _run_drill(np_, steps, kill_step, regrow, workdir):
    from ddw_tpu_torch.runtime.launcher import Launcher
    from ddw_tpu_torch.runtime.supervisor import GangSupervisor

    ckpt = os.path.join(workdir, "drill_ck")
    launcher = Launcher(np=np_, devices_per_proc=1, timeout_s=180,
                        elastic_restarts=1, min_world_size=2,
                        rendezvous_dir=os.path.join(workdir, "rdzv"))
    # the lost rank: always the last one, so survivor ranks keep their ids
    # and the regrown member reclaims the freed contiguous rank
    os.environ["DDW_FAULT"] = f"host_lost:rank={np_ - 1}:step={kill_step}"

    stop = threading.Event()

    def regrow_watcher():
        """A stand-in cluster-integration hook: the moment the shrink lands,
        the 'replacement host' comes up — the fault arm is disarmed (the
        replacement boots clean; spawn env snapshots os.environ) and the
        launcher is asked to re-expand at the next poll tick."""
        while not stop.is_set():
            if any(e.kind == "shrink" for e in launcher.elastic_events):
                os.environ.pop("DDW_FAULT", None)
                launcher.request_grow()
                return
            time.sleep(0.05)

    watcher = None
    if regrow:
        watcher = threading.Thread(target=regrow_watcher, daemon=True)
        watcher.start()
    sup = GangSupervisor(launcher, max_restarts=1, backoff_base_s=0.05,
                         jitter=0.0)
    try:
        # pass args through run() rather than functools.partial: a partial
        # hides the fn's __main__ origin from the by_file shipping path
        out = sup.run(drill_worker, ckpt, steps)
    finally:
        stop.set()
        os.environ.pop("DDW_FAULT", None)
        if watcher is not None:
            watcher.join(timeout=5)
    events = [{"kind": e.kind, "generation": e.generation,
               "dead_rank": e.dead_rank, "old_world": e.old_world,
               "new_world": e.new_world}
              for e in launcher.elastic_events]
    attempts = [{"kind": a.kind, "recovery": a.recovery,
                 "old_world_size": a.old_world_size,
                 "new_world_size": a.new_world_size}
                for a in sup.attempts]
    return out, events, attempts


def _run_reference(np_, steps, workdir):
    """Uninterrupted N-rank run from scratch — the bit-identity oracle."""
    from ddw_tpu_torch.runtime.launcher import Launcher

    ckpt = os.path.join(workdir, "ref_ck")
    launcher = Launcher(np=np_, devices_per_proc=1, timeout_s=180,
                        elastic_restarts=1,
                        rendezvous_dir=os.path.join(workdir, "rdzv_ref"))
    return launcher.run(drill_worker, ckpt, steps)


def main(argv=None) -> int:
    smoke = os.environ.get("DDW_DRILL_SMOKE", "") not in ("", "0")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--np", type=int, default=3 if smoke else 4,
                    help="gang size (the drill kills rank np-1)")
    ap.add_argument("--steps", type=int, default=5 if smoke else 8)
    ap.add_argument("--kill-step", type=int, default=2,
                    help="step at which the last rank's host is lost")
    ap.add_argument("--no-regrow", action="store_true",
                    help="stop at N-1: skip the re-expansion leg")
    ap.add_argument("--out", default=None,
                    help="work directory (default: a fresh tempdir)")
    args = ap.parse_args(argv)
    if args.np < 3:
        ap.error("--np must be >= 3 (shrink floor is min_world_size=2)")
    if not 0 < args.kill_step < args.steps:
        ap.error("--kill-step must fall inside (0, --steps)")

    workdir = args.out or tempfile.mkdtemp(prefix="gang_drill_")
    os.makedirs(workdir, exist_ok=True)
    t0 = time.time()
    drill, events, attempts = _run_drill(
        args.np, args.steps, args.kill_step, not args.no_regrow, workdir)
    reference = _run_reference(args.np, args.steps, workdir)

    kinds = [e["kind"] for e in events]
    bit_identical = drill["w"] == reference["w"]
    shape_ok = ("shrink" in kinds
                and (args.no_regrow or "grow" in kinds)
                and drill["coverage_ok"] and reference["coverage_ok"]
                and drill["final_step"] == args.steps)
    verdict = "ok" if (bit_identical and shape_ok) else "mismatch"
    print(json.dumps({
        "verdict": verdict, "mode": "smoke" if smoke else "full",
        "np": args.np, "steps": args.steps, "kill_step": args.kill_step,
        "regrow": not args.no_regrow, "elapsed_s": round(time.time() - t0, 2),
        "bit_identical": bit_identical, "events": events,
        "attempts": attempts, "drill": drill, "reference": reference,
        "workdir": workdir}))
    return 0 if verdict == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
