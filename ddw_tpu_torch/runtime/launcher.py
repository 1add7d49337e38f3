"""Train-fn launcher — the HorovodRunner role; the port of
``ddw_tpu.runtime.launcher``.

The reference launches distributed training by pickling a train function to
Spark barrier-mode tasks which rendezvous via mpirun, with two modes:
``np=-1`` runs the same function locally on the driver as a smoke test and
``np=N`` gang-schedules N workers; the driver gets rank-0's return value.

In the port a rank is one process and one device: ``np=-1`` calls the fn in
this process; ``np=N`` spawns N processes of
:mod:`ddw_tpu_torch.runtime._launch_worker` on this host, joined by a gloo
process group over a local TCP coordinator
(:func:`ddw_tpu_torch.runtime.dist.init_distributed`, a port from
:func:`~ddw_tpu_torch.runtime.dist.free_port`), and returns rank-0's return
value. Each worker runs on the device its fn asks for — the trainers'
default is the card; nothing in the spawn environment hides CUDA.

The launched function must be picklable (module-level) or defined in the
driver script's ``__main__`` (shipped by file reference), and takes no
required args (bind hyperparameters with ``functools.partial`` or pass them
through :meth:`Launcher.run`).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Callable

from ddw_tpu_torch.runtime.dist import free_port as _free_port
from ddw_tpu_torch.runtime.faults import (EXIT_COORD_BIND, EXIT_HOST_LOST,
                                          EXIT_PREEMPTED)


@dataclasses.dataclass
class ElasticEvent:
    """One elastic recovery, as the launcher drove it. ``kind`` is
    ``"respawn"`` (the dead rank was restarted at the same world
    size), ``"shrink"`` (the dead rank was judged permanently lost and the
    survivors re-formed at ``new_world`` — ``respawn_pid`` is None, nothing
    was spawned), or ``"grow"`` (a healthy host rejoined: ``respawn_pid``
    is the new member, ``dead_rank`` is None). Harvested by the
    :class:`~ddw_tpu_torch.runtime.supervisor.GangSupervisor` into its
    ``AttemptReport`` forensics."""

    generation: int             # elastic generation the gang re-formed at
    dead_rank: int | None
    exit_code: int | None       # the dead rank's raw waitpid code
    exit_signal: int | None     # the signal that killed it (exit_code < 0)
    respawn_pid: int | None
    at_unix: float
    kind: str = "respawn"
    old_world: int | None = None
    new_world: int | None = None


class GangError(RuntimeError):
    """Structured gang failure — what the :class:`GangSupervisor` needs to
    decide restartability without parsing message strings.

    ``kind``: ``"crash"`` (a worker exited nonzero), ``"deadline"`` (shared
    gang deadline exceeded), ``"coord-bind"`` (the coordinator lost the
    spawn-time port race, retried ``spawn_retries`` times),
    ``"result-missing"`` (every worker exited 0 but rank 0 never wrote a
    readable result — a silent early exit), or ``"preempted"`` (a rank left
    ``EXIT_PREEMPTED`` and the rest of the gang was SIGTERM-forwarded and
    drained within the grace window). ``exit_codes`` is per-rank
    (``None`` = still running when the gang was killed); ``rank0_traceback``
    is rank 0's formatted traceback when it got far enough to report one.
    """

    def __init__(self, message: str, *, kind: str,
                 exit_codes: list[int | None],
                 rank0_traceback: str | None = None):
        super().__init__(message)
        self.kind = kind
        self.exit_codes = list(exit_codes)
        self.rank0_traceback = rank0_traceback

    @property
    def is_preemption(self) -> bool:
        """True when any rank exited ``EXIT_PREEMPTED`` (checkpointed, clean
        SIGTERM exit). Preemption dominates the collateral deaths of the
        other ranks — they die as the preempted peer leaves the collective
        (a transport error -> nonzero exit, or the gang kill -> signal), and
        the preempted rank's exit code guarantees a durable checkpoint to
        restart from."""
        return any(c == EXIT_PREEMPTED for c in self.exit_codes
                   if c is not None)


class Launcher:
    """Run a train function locally (``np=-1``) or across ``np`` processes.

    ``np=-1``: call in-process (driver smoke mode; the same code path at a
    world of one). ``np>=1``: spawn ``np`` python processes on this machine,
    one device each (``devices_per_proc`` keeps ``ddw_tpu``'s name; any
    value but 1 raises), join them in a gloo group via a local coordinator,
    run ``fn`` everywhere, return rank-0's return value. The group's
    rendezvous and collectives time out at ``timeout_s``
    (``DDW_GANG_TIMEOUT_S`` in the workers), so a collective wedged on a
    dead peer cannot outlive the gang deadline.

    Preemption propagation: the moment ANY rank exits ``EXIT_PREEMPTED`` the
    launcher forwards SIGTERM to every still-running rank and waits up to
    ``preempt_grace_s`` for them to checkpoint and leave on their own —
    peers stop dying as collective-error collateral with no chance to act on
    the preemption. ``forward_sigterm=True`` additionally routes a SIGTERM
    delivered to the DRIVER (the cluster-manager preemption of the whole
    allocation) to the gang via :meth:`broadcast_preemption`, so every rank
    sees the flag while still running, not after its peers vanished.
    """

    def __init__(self, np: int = -1, devices_per_proc: int = 1,
                 timeout_s: float = 600.0, spawn_retries: int = 3,
                 preempt_grace_s: float = 10.0,
                 forward_sigterm: bool = False,
                 elastic_restarts: int = 0,
                 rendezvous_dir: str | None = None,
                 min_world_size: int | None = None,
                 rank_hosts: list[str | None] | None = None,
                 shrink_retries: int = 1,
                 shrink_vote_timeout_s: float = 30.0,
                 probe_timeout_s: float = 5.0):
        if devices_per_proc != 1:
            raise ValueError(
                f"devices_per_proc={devices_per_proc}: in ddw_tpu_torch a "
                f"rank is one process on one device; launch np={np} ranks "
                f"with devices_per_proc=1")
        self.np = np
        self.devices_per_proc = devices_per_proc
        self.timeout_s = timeout_s
        # Bounded respawn-with-fresh-port attempts when the coordinator loses
        # the free_port probe-to-bind race (TOCTOU): the port checked free at
        # spawn time can be taken before the group's store binds it.
        self.spawn_retries = max(1, spawn_retries)
        self.last_spawn_attempts = 0  # spawns used by the last _run_multiproc
        self.preempt_grace_s = preempt_grace_s
        self.forward_sigterm = forward_sigterm
        # Elastic mode: up to elastic_restarts single-rank respawns per gang
        # launch. The gang's cross-rank topology becomes the EXPLICIT
        # GangRendezvous object (runtime/elastic.py) instead of a process
        # group — a group admits its ranks once, so a respawned rank could
        # never rejoin it; workers therefore skip the group and sync over
        # the rendezvous control plane.
        self.elastic_restarts = max(0, elastic_restarts)
        self.rendezvous_dir = rendezvous_dir
        # Shrink mode: when a
        # rank is judged PERMANENTLY lost (EXIT_HOST_LOST, respawn budget
        # exhausted, or its host fails the transport probe), re-form the
        # gang at world-1 instead of falling back to whole-world restart —
        # down to min_world_size, below which whole-world remains the
        # fallback. None disables shrinking entirely.
        if min_world_size is not None:
            if np != -1 and not (1 <= min_world_size <= np):
                raise ValueError(
                    f"min_world_size={min_world_size} outside [1, np={np}]")
        self.min_world_size = min_world_size
        # Optional per-rank host list for the permanent-loss probe: a dead
        # rank whose host no longer answers deploy.transport.probe() earns
        # the permanent verdict even with respawn budget left. Entries are
        # transport_for() host strings; None/"local" slots always probe OK.
        self.rank_hosts = list(rank_hosts) if rank_hosts else None
        self.shrink_retries = max(0, shrink_retries)
        self.shrink_vote_timeout_s = shrink_vote_timeout_s
        self.probe_timeout_s = probe_timeout_s
        self.elastic_events: list[ElasticEvent] = []  # last _run_multiproc
        self.last_rendezvous_dir: str | None = None
        self._grow_requested = False
        self._procs: list = []        # live gang (broadcast target)
        self._procs_lock = threading.Lock()

    def broadcast_preemption(self) -> int:
        """Send SIGTERM to every still-running rank of the live gang (the
        workers' installed handler turns it into the graceful-preemption
        flag). Thread-safe; callable from a driver signal handler or a
        cluster-integration hook. Returns how many ranks were signalled."""
        n = 0
        with self._procs_lock:
            for p in self._procs:
                if p.poll() is None:
                    try:
                        p.send_signal(signal.SIGTERM)
                        n += 1
                    except OSError:
                        pass  # exited between poll and signal
        return n

    def request_grow(self) -> None:
        """Ask the live gang to re-expand by one rank at the next healthy
        poll tick (only meaningful after a shrink freed a slot). The new
        member joins at the next generation boundary through the same
        record/adopt machinery as a shrink — thread-safe, callable from a
        cluster-integration hook when a replacement host comes up."""
        self._grow_requested = True

    def run(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Any:
        if self.np == -1:
            return fn(*args, **kwargs)
        return self._run_multiproc(fn, args, kwargs)

    def _run_multiproc(self, fn, args, kwargs, extra_env: dict | None = None) -> Any:
        # Functions defined in a script's __main__ can't unpickle inside the worker
        # (whose __main__ is the worker module) — the problem HorovodRunner solves
        # with cloudpickle. We ship a (file, qualname) reference instead and the
        # worker re-imports the script under a non-__main__ name.
        if getattr(fn, "__module__", None) == "__main__":
            import __main__ as main_mod

            src = getattr(main_mod, "__file__", None)
            if src is None:
                raise ValueError("cannot ship a __main__ function from an interactive session; "
                                 "define the train fn in an importable module")
            fn_spec = ("by_file", os.path.abspath(src), fn.__qualname__)
        else:
            fn_spec = ("pickled", pickle.dumps(fn), None)
        self.elastic_events = []
        self._grow_requested = False
        with tempfile.TemporaryDirectory(prefix="ddw_launch_") as tmp:
            payload = os.path.join(tmp, "payload.pkl")
            result = os.path.join(tmp, "result.pkl")
            with open(payload, "wb") as f:
                pickle.dump((fn_spec, args, kwargs), f)
            for attempt in range(self.spawn_retries):
                self.last_spawn_attempts = attempt + 1
                if os.path.exists(result):  # stale result from a lost spawn
                    os.remove(result)
                try:
                    return self._run_gang(payload, result, attempt, extra_env)
                except GangError as e:
                    # Coordinator lost the probe-to-bind port race: the whole
                    # gang is dead anyway — respawn it on a fresh port instead
                    # of surfacing (or worse, hanging the caller until the
                    # gang deadline while ranks wait on a dead coordinator).
                    if e.kind == "coord-bind" and attempt + 1 < self.spawn_retries:
                        continue
                    raise

    def _spawn_rank(self, rank: int, payload: str, result: str, port: int,
                    attempt: int, extra_env: dict | None,
                    rdzv_dir: str | None, elastic_gen: int = 0,
                    world: int | None = None):
        env = dict(os.environ)
        # no device is forced: the fn picks its own (the card by default)
        env["DDW_COORDINATOR"] = f"127.0.0.1:{port}"
        # `world` is the CURRENT gang size (spawns into a shrunken or grown
        # world carry the re-negotiated size, not the launch-time np).
        env["DDW_NUM_PROCESSES"] = str(self.np if world is None else world)
        env["DDW_PROCESS_ID"] = str(rank)
        env["DDW_SPAWN_ATTEMPT"] = str(attempt)
        env["DDW_GANG_TIMEOUT_S"] = str(self.timeout_s)
        if rdzv_dir is not None:
            env["DDW_RENDEZVOUS_DIR"] = rdzv_dir
            env["DDW_ELASTIC_GEN"] = str(elastic_gen)
        if extra_env:
            env.update({k: str(v) for k, v in extra_env.items()})
        return subprocess.Popen(
            [sys.executable, "-m", "ddw_tpu_torch.runtime._launch_worker",
             payload, result],
            env=env,
            stdout=None if rank == 0 else subprocess.DEVNULL,
            stderr=None,
        )

    def _probe_slot(self, slot: int) -> bool:
        """Is the dead rank's HOST still reachable? Unreachable upgrades the
        loss verdict to permanent even with respawn budget left. Slots map
        to launch-time ``rank_hosts`` entries; without a host list every
        slot is local and trivially reachable."""
        if not self.rank_hosts or slot >= len(self.rank_hosts):
            return True
        host = self.rank_hosts[slot]
        if host in (None, "", "local", "localhost"):
            return True
        try:
            from ddw_tpu_torch.deploy.transport import transport_for
            return bool(transport_for(host).probe(
                timeout_s=self.probe_timeout_s))
        except Exception:
            return False

    def _drive_shrink(self, rdzv_dir: str, ranks: list, slot: int,
                      code: int | None, elastic_gen: int
                      ) -> tuple[bool, int]:
        """Propose evicting ``slot`` and re-forming the survivors at
        world−1: post a shrink record with a contiguous rank assignment and
        a fresh coordinator port, wait for every survivor's vote, and
        commit on unanimous ack (two-phase: survivors adopt nothing until
        the commit marker lands, so an abandoned proposal strands no one).
        A veto pins the proposal; retry at a bumped generation up to
        ``shrink_retries`` times. Returns ``(adopted, elastic_gen)`` —
        not-adopted falls back to whole-world restart."""
        from ddw_tpu_torch.runtime.elastic import GangRendezvous

        dead_rank = ranks[slot]
        survivors = sorted(r for i, r in enumerate(ranks)
                           if r is not None and i != slot)
        assignment = {str(r): j for j, r in enumerate(survivors)}
        new_world = len(survivors)
        rdzv = GangRendezvous(rdzv_dir, new_world + 1, -1)
        for _ in range(self.shrink_retries + 1):
            elastic_gen += 1
            rdzv.post_shrink(
                elastic_gen, dead_rank=dead_rank, assignment=assignment,
                world_size=new_world, exit_code=code,
                coordinator=f"127.0.0.1:{_free_port()}")
            votes = rdzv.wait_votes(elastic_gen, survivors,
                                    timeout_s=self.shrink_vote_timeout_s)
            if votes is None:
                # a survivor that cannot vote cannot adopt either
                return False, elastic_gen
            if all(votes.get(r) == "ack" for r in survivors):
                rdzv.commit_recovery(elastic_gen)
                for i, r in enumerate(ranks):
                    if r is not None and i != slot:
                        ranks[i] = assignment[str(r)]
                ranks[slot] = None
                return True, elastic_gen
            # veto: the next iteration re-proposes at a bumped generation
            # (the veto arm is one-shot per proposal; a survivor that
            # vetoes every proposal exhausts the retries -> whole-world)
        return False, elastic_gen

    def _run_gang(self, payload: str, result: str, attempt: int,
                  extra_env: dict | None) -> Any:
        port = _free_port()
        rdzv_dir = None
        if self.elastic_restarts > 0 or self.min_world_size is not None:
            # A fresh control directory per gang launch: a whole-world
            # restart must not inherit the previous world's recovery ledger.
            if self.rendezvous_dir:
                os.makedirs(self.rendezvous_dir, exist_ok=True)
            rdzv_dir = tempfile.mkdtemp(
                prefix="rdzv_",
                dir=self.rendezvous_dir or os.path.dirname(payload))
            self.last_rendezvous_dir = rdzv_dir
        procs = [self._spawn_rank(rank, payload, result, port, attempt,
                                  extra_env, rdzv_dir)
                 for rank in range(self.np)]
        with self._procs_lock:
            self._procs = procs
        prev_handler = None
        if self.forward_sigterm and \
                threading.current_thread() is threading.main_thread():
            # Cluster-manager preemption arrives at the DRIVER: forward it to
            # the gang so every rank checkpoints gracefully instead of dying
            # as collateral when the first peer leaves a collective.
            prev_handler = signal.signal(
                signal.SIGTERM,
                lambda _sig, _frame: self.broadcast_preemption())
        try:
            # Failure detection: poll the whole gang and kill
            # everyone the moment ANY rank dies abnormally — a crashed rank
            # must not leave the others hanging in a collective until the
            # deadline (the Spark-barrier all-or-nothing semantics the
            # reference relies on).
            # One shared deadline for the whole gang (not np * timeout).
            # EXCEPTION: a rank that exited EXIT_PREEMPTED checkpointed and
            # left deliberately — instead of killing its peers, forward the
            # SIGTERM to them and give them preempt_grace_s to checkpoint
            # and exit on their own (ranks wedged inside a collective are
            # killed when the grace runs out).
            deadline = time.monotonic() + self.timeout_s
            grace_end: float | None = None
            elastic_used = 0
            elastic_gen = 0
            # Membership is SLOT-based: slot i holds the process spawned
            # into launch-time rank i; ranks[i] is its CURRENT rank in the
            # re-negotiated world (shrinks renumber survivors contiguously)
            # and None marks an evicted slot — its exit code stays in
            # `codes` for forensics but no longer gates the gang.
            ranks: list[int | None] = list(range(self.np))
            codes: list[int | None] = [None] * self.np

            def _active(i: int) -> bool:
                return ranks[i] is not None

            while any(codes[i] is None for i in range(self.np)
                      if _active(i)):
                for i, p in enumerate(procs):
                    if _active(i) and codes[i] is None:
                        codes[i] = p.poll()
                abnormal = [i for i, c in enumerate(codes)
                            if _active(i) and c not in (None, 0,
                                                        EXIT_PREEMPTED)]
                if abnormal:
                    # The verdict ladder for a single dead rank (peers all
                    # running, not a coordinator port race): TRANSIENT loss
                    # -> respawn only that rank (budget permitting);
                    # PERMANENT loss (EXIT_HOST_LOST, budget exhausted, or
                    # its host fails the transport probe) -> shrink the
                    # gang to world-1, down to min_world_size. Any other
                    # shape — a second death, no shrink headroom, a vote
                    # that never completes — falls through to the gang
                    # kill, and the supervisor's whole-world restart takes
                    # over.
                    handled = False
                    if (rdzv_dir is not None and len(abnormal) == 1
                            and codes[abnormal[0]] != EXIT_COORD_BIND
                            and all(codes[i] is None for i in range(self.np)
                                    if _active(i) and i != abnormal[0])):
                        slot = abnormal[0]
                        code = codes[slot]
                        world = sum(1 for x in ranks if x is not None)
                        permanent = (code == EXIT_HOST_LOST
                                     or elastic_used >= self.elastic_restarts
                                     or not self._probe_slot(slot))
                        if not permanent:
                            r = ranks[slot]
                            elastic_used += 1
                            elastic_gen += 1
                            from ddw_tpu_torch.runtime.elastic import GangRendezvous

                            GangRendezvous(rdzv_dir, world, -1).post_recovery(
                                elastic_gen, dead_rank=r, exit_code=code)
                            p = self._spawn_rank(r, payload, result, port,
                                                 attempt, extra_env, rdzv_dir,
                                                 elastic_gen=elastic_gen,
                                                 world=world)
                            procs[slot] = p
                            codes[slot] = None
                            with self._procs_lock:
                                self._procs = procs
                            self.elastic_events.append(ElasticEvent(
                                generation=elastic_gen, dead_rank=r,
                                exit_code=code,
                                exit_signal=-code if (code or 0) < 0
                                else None,
                                respawn_pid=p.pid, at_unix=time.time()))
                            handled = True
                        elif (self.min_world_size is not None
                              and world - 1 >= self.min_world_size):
                            r = ranks[slot]
                            adopted, elastic_gen = self._drive_shrink(
                                rdzv_dir, ranks, slot, code, elastic_gen)
                            if adopted:
                                self.elastic_events.append(ElasticEvent(
                                    generation=elastic_gen, dead_rank=r,
                                    exit_code=code,
                                    exit_signal=-code if (code or 0) < 0
                                    else None,
                                    respawn_pid=None, at_unix=time.time(),
                                    kind="shrink", old_world=world,
                                    new_world=world - 1))
                                handled = True
                        if handled:
                            # the re-formed gang earns a fresh deadline —
                            # the recovery consumed wall-clock the healthy
                            # steps were budgeted for
                            deadline = time.monotonic() + self.timeout_s
                            continue
                    for p in procs:
                        if p.poll() is None:
                            p.kill()
                    codes = [p.wait() for p in procs]
                    suffix, tb = self._rank0_error(result)
                    kind = ("coord-bind" if EXIT_COORD_BIND in codes
                            else "crash")
                    raise GangError(
                        f"worker crashed (exit codes {codes}); gang killed"
                        + suffix,
                        kind=kind, exit_codes=codes, rank0_traceback=tb)
                if any(codes[i] == EXIT_PREEMPTED for i in range(self.np)
                       if _active(i)):
                    if grace_end is None:
                        grace_end = min(deadline,
                                        time.monotonic()
                                        + self.preempt_grace_s)
                        self.broadcast_preemption()
                    if time.monotonic() > grace_end:
                        for p in procs:
                            if p.poll() is None:
                                p.kill()
                        codes = [p.wait() for p in procs]
                        break
                elif (self._grow_requested and rdzv_dir is not None
                        and any(r is None for r in ranks)
                        and all(codes[i] is None for i in range(self.np)
                                if _active(i))):
                    # Re-expansion (N-1 -> N): a healthy host rejoined. The
                    # new member takes the next contiguous rank; incumbents
                    # adopt the grow record at their next chain boundary.
                    self._grow_requested = False
                    world = sum(1 for x in ranks if x is not None)
                    new_rank = world
                    elastic_gen += 1
                    from ddw_tpu_torch.runtime.elastic import GangRendezvous

                    GangRendezvous(rdzv_dir, world, -1).post_grow(
                        elastic_gen,
                        current_ranks=[x for x in ranks if x is not None],
                        world_size=world + 1,
                        coordinator=f"127.0.0.1:{_free_port()}")
                    slot = ranks.index(None)
                    p = self._spawn_rank(new_rank, payload, result, port,
                                         attempt, extra_env, rdzv_dir,
                                         elastic_gen=elastic_gen,
                                         world=world + 1)
                    procs[slot] = p
                    ranks[slot] = new_rank
                    codes[slot] = None
                    with self._procs_lock:
                        self._procs = procs
                    self.elastic_events.append(ElasticEvent(
                        generation=elastic_gen, dead_rank=None,
                        exit_code=None, exit_signal=None,
                        respawn_pid=p.pid, at_unix=time.time(),
                        kind="grow", old_world=world, new_world=world + 1))
                    deadline = time.monotonic() + self.timeout_s
                if time.monotonic() > deadline:
                    raise GangError(
                        f"gang deadline ({self.timeout_s}s) exceeded; "
                        f"exit codes so far {codes}; killing all workers",
                        kind="deadline", exit_codes=codes)
                if any(codes[i] is None for i in range(self.np)
                       if _active(i)):
                    time.sleep(0.05)
            if any(codes[i] == EXIT_PREEMPTED for i in range(self.np)
                   if _active(i)):
                raise GangError(
                    f"gang preempted (exit codes {codes}); SIGTERM was "
                    f"forwarded to all ranks",
                    kind="preempted", exit_codes=codes)
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
            with self._procs_lock:
                self._procs = []
            for p in procs:
                if p.poll() is None:
                    p.kill()
        # Reaching here means every worker exited 0.
        try:
            with open(result, "rb") as f:
                status, value = pickle.load(f)
        except Exception as e:
            # exit 0 across the gang with no readable result: rank 0 skipped
            # its contract (silent early exit / torn write) — surface it
            # instead of crashing on the unpickle or returning garbage.
            raise GangError(
                f"all workers exited 0 but the rank-0 result at {result} is "
                f"missing or unreadable ({e!r})",
                kind="result-missing", exit_codes=[0] * self.np) from e
        if status == "error":
            raise RuntimeError(f"rank-0 worker raised: {value}")
        return value

    @staticmethod
    def _rank0_error(result_path: str) -> tuple[str, str | None]:
        """Root cause for the crash message: if rank 0 got far enough to write
        an error result before exiting nonzero, surface its traceback instead
        of leaving only exit codes. Returns ``(message_suffix, traceback)``."""
        try:
            with open(result_path, "rb") as f:
                status, value = pickle.load(f)
            if status == "error":
                return f"; rank-0 worker raised: {value}", str(value)
        except Exception:
            pass
        return "", None
