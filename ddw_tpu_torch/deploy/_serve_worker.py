"""Child entrypoint for a process replica — one engine, one HTTP door.

``python -m ddw_tpu_torch.deploy._serve_worker --model-dir D --port-file F ...``
boots exactly what :class:`~ddw_tpu_torch.gateway.http.Gateway` already is, in a
fresh OS process: load the LM package, build one
:class:`~ddw_tpu_torch.serve.ServingEngine`, serve it through a single-replica
gateway (``supervise=False`` — process supervision lives in the PARENT's
:class:`~ddw_tpu_torch.gateway.ReplicaSupervisor`, which restarts this whole
process). Reusing the gateway buys the child every contract the fleet
already depends on for free: ``/healthz`` while it warms up, warmup-gated
``/readyz``, ``/stats`` forensics, SIGTERM → drain-to-completion.

Startup handshake (the launcher's TOCTOU-free port discipline): the child
binds port 0, and the moment the listener is up — BEFORE warmup — writes
the bound port to ``--port-file`` atomically (tmp + fsync + rename, the
checkpoint writer's idiom), so the parent can watch ``/healthz`` through
the compile and gate readiness on ``/readyz`` like any load balancer.

Exit codes: 0 = clean drain (SIGTERM honored), ``EXIT_ENGINE_FAILED`` (13)
= the engine went terminal (``DDW_FAULT=serve:crash`` inherited through
the environment lands here — the fault spec's ``replica=N`` matches this
process's ``--replica-id``), ``EXIT_FOLLOWER_FAILED`` (14) = a clean
drain after which a tensor-parallel follower exited non-zero, anything
else = startup error (a child
asked for the card — ``--device`` unset or ``cuda`` — that finds none
exits here and never carries on on the CPU). The parent keeps the raw code
as restart forensics. ``--device cpu`` serves on the CPU (the tests);
``--threads N`` caps the child's intra-op threads (its followers' too).

``--tp N`` (folded into ``EngineCfg.tp``): the child is rank 0 of a
``N``-wide tensor-parallel replica and starts its ``N - 1`` follower
processes itself (:mod:`ddw_tpu_torch.serve.tp`), which die with it.
After a clean drain the child closes its engine, so the followers leave
and the group ends before it exits; a failed engine ends the process at
once, with no handshake over a group whose last program may never have
finished.
``ddw_tpu``'s worker also forces ``N`` fake host devices into
``XLA_FLAGS`` before JAX loads; the port has no counterpart, since its
shards are processes, not devices.

The port of ``ddw_tpu.deploy._serve_worker``: the same host logic,
importing nothing of ``ddw_tpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

EXIT_ENGINE_FAILED = 13
EXIT_FOLLOWER_FAILED = 14


def _write_atomic(path: str, text: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _dump_flight(eng, port_file: str) -> None:
    """Engine went terminal while this process is still alive enough to
    write: drop the tracer's ring as ``flight.gen<N>.json`` next to the
    port file (the replica workdir). The generation rides the port-file
    name (``port.gen<N>.json``) — no extra flag needed. A SIGKILLed child
    never reaches here; the parent's relay cache covers that path."""
    tracer = getattr(eng, "tracer", None)
    if tracer is None or not getattr(eng, "_tracing", False):
        return
    base = os.path.basename(port_file)
    gen = base[len("port."):-len(".json")] if (
        base.startswith("port.") and base.endswith(".json")) else "gen0"
    tracer.dump_flight(os.path.join(os.path.dirname(port_file) or ".",
                                    f"flight.{gen}.json"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ddw-serve-worker")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--draft-dir", default=None,
                   help="draft LM package for speculative decode "
                        "(pair with spec_k>0 in --engine-cfg)")
    p.add_argument("--port-file", required=True)
    p.add_argument("--replica-id", type=int, default=0)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--engine-cfg", default="",
                   help="JSON dict of EngineCfg overrides")
    p.add_argument("--warmup", default="[8]",
                   help="JSON list of warmup prompt lengths")
    p.add_argument("--grace-s", type=float, default=None)
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree: this child is rank 0 of a "
                        "tp-wide replica and starts its tp - 1 followers "
                        "(folded into EngineCfg.tp)")
    p.add_argument("--device", default=None,
                   help="torch device the engine serves on; unset = the "
                        "CUDA card (an error without one), 'cpu' only "
                        "when asked for")
    p.add_argument("--threads", type=int, default=0,
                   help="torch intra-op threads (0 = torch's default)")
    args = p.parse_args(argv)

    # imports AFTER argparse: a bad flag should not pay the torch import
    import torch

    from ddw_tpu_torch.gateway.http import Gateway
    from ddw_tpu_torch.serve.engine import EngineCfg, ServingEngine
    from ddw_tpu_torch.serving.lm_package import load_lm_package
    from ddw_tpu_torch.utils.device import resolve_device

    if args.threads > 0:
        torch.set_num_threads(args.threads)
    device = resolve_device(args.device)    # raises without a card
    pkg = load_lm_package(args.model_dir, device=device)
    draft = (load_lm_package(args.draft_dir, device=device)
             if args.draft_dir else None)
    overrides = json.loads(args.engine_cfg or "{}")
    if args.tp > 1:
        overrides["tp"] = args.tp
    cfg = EngineCfg(**overrides)
    eng = ServingEngine(lm=pkg, cfg=cfg, replica_id=args.replica_id,
                        draft=draft)
    eng.model_dir = args.model_dir
    eng.draft_dir = args.draft_dir
    gw = Gateway(eng, host=args.host, port=args.port,
                 grace_s=args.grace_s, supervise=False)
    # the single-replica gateway wired the engine as its slot 0; give it
    # back its fleet slot, so a DDW_FAULT=serve:*:replica=N spec and the
    # failure records name --replica-id (ddw_tpu's worker leaves it 0)
    eng.replica_id = args.replica_id
    gw.install_sigterm()                    # SIGTERM → drain-to-completion
    gw.start(warmup_prompt_lens=tuple(json.loads(args.warmup)),
             on_listening=lambda port: _write_atomic(
                 args.port_file, json.dumps({"port": port,
                                             "pid": os.getpid()})))
    # Serve until drained (SIGTERM) or the engine goes terminal. The parent
    # supervises the PROCESS: a dead engine here must become a dead process,
    # so the one recovery path (respawn) covers both.
    while gw.lifecycle.state != "stopped":
        if eng.state == "failed":
            _dump_flight(eng, args.port_file)
            gw.drain(grace_s=1.0)           # 503 stragglers, close listener
            # no close() over a group whose follower may still run the
            # program this engine abandoned, and no interpreter teardown
            # with that gloo group alive: the process ends here, and its
            # followers die with it (their parent-death signal)
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(EXIT_ENGINE_FAILED)
        time.sleep(0.05)
    # the drain only stopped the engine: closing it releases a tp replica's
    # followers and ends its group before this process exits
    eng.close()
    if any(c != 0 for c in eng.follower_exit_codes.values()):
        return EXIT_FOLLOWER_FAILED
    return 0


if __name__ == "__main__":
    sys.exit(main())
