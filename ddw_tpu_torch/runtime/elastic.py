"""Elastic gang recovery — the port of ``ddw_tpu.runtime.elastic``: the
re-rendezvous as a first-class topology object.

A whole-world restart (:class:`~ddw_tpu_torch.runtime.supervisor.
GangSupervisor`) throws away N-1 healthy processes' warm state (imports,
loaded kernels, CUDA context, loader position) when one rank dies. A
``torch.distributed`` group, like ``jax.distributed``'s coordination
service, admits a fixed set of ranks once: a respawned rank cannot rejoin
the group it fell out of. This module makes the rendezvous/reduce topology
an **explicit object** instead:

- :class:`GangRendezvous` owns membership (who is in the gang, at which
  *elastic generation*), the re-rendezvous **barrier** ranks park on at
  chain boundaries, and a deterministic host-level **all-reduce** (float64,
  folded in rank order) over a shared-filesystem control plane. Device
  compute stays in each process; only the *topology* lives here, so a
  generation bump re-forms the gang without touching any process's CUDA
  state.
- When the :class:`~ddw_tpu_torch.runtime.launcher.Launcher` (elastic mode)
  observes a single dead rank it respawns **only that rank** and posts a
  recovery record. Surviving ranks discover it at their next chain
  boundary (:func:`maybe_elastic_restart`) or while parked in a
  barrier/reduce, raise :class:`ElasticRestart`, and the worker entrypoint
  re-runs the train fn *in the same process*, restoring from the latest
  durable checkpoint.
- Whole-world restart remains the **fallback**: if re-rendezvous itself
  fails the launcher kills the gang and raises ``GangError``; the
  supervisor's restart-from-checkpoint loop engages unchanged.

The control directory's files, their JSON keys and the atomic writes are
``ddw_tpu``'s byte for byte, so a ``ddw_tpu`` rendezvous and this one on the
same directory read each other's records.

Recovery records come in three kinds. ``respawn`` re-forms the gang
at the *same* world size after the dead rank is restarted. ``shrink``
re-forms it at N−1: the driver judges a member permanently lost (respawn
budget exhausted, host unreachable via the ``deploy/transport`` probe, or an
explicit ``host_lost`` fault), proposes a **contiguous rank assignment** for
the survivors plus a fresh coordinator port, and every survivor votes
(ack/veto) before adopting — a veto pins the proposal and the driver retries
at a bumped generation or falls back to whole-world restart. ``grow`` is the
inverse: a healthy host rejoins at the next generation boundary and the gang
re-expands N−1→N through the same record/adopt machinery (no vote — growth
never strands anyone's state). :meth:`GangRendezvous.advance` applies the
record's assignment, so membership (``rank``/``world_size`` and therefore
every ``range(self.world_size)`` barrier/reduce scan) is generation-aware:
a post-shrink reduce never waits on an evicted rank's part file.

Layout of the control directory (``DDW_RENDEZVOUS_DIR``)::

    member_g<gen>_r<rank>.json   # membership: pid + start time, per generation
    recover_g<gen>.json          # driver-posted recovery record -> generation g
    vote_g<gen>_r<rank>.json     # survivor ack/veto of a shrink record
    commit_g<gen>                # driver's commit of a unanimously-acked shrink
    arrive_g<gen>_<tag>_r<rank>  # barrier arrival markers
    reduce_g<gen>_<tag>_r<rank>.json  # host all-reduce contributions

Every file is written atomically (tmp + ``os.replace``) so readers never
observe a torn record. Each rank deletes its *own* stale markers one
barrier behind the current one — a rank can be at most one barrier ahead of
any peer, so the window it keeps is exactly what a slow peer may still
read.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from ddw_tpu_torch.runtime.dist import process_topology

__all__ = ["GangRendezvous", "ElasticRestart", "elastic_enabled", "context",
           "reset_context", "maybe_elastic_restart", "elastic_barrier",
           "host_all_reduce", "process_topology", "maybe_reinit_distributed"]


class ElasticRestart(Exception):
    """A recovery record newer than this rank's generation exists: park,
    then re-run the train fn at ``generation`` (restoring from the latest
    durable checkpoint). Raised by the chain-boundary hook, by a parked
    barrier, or by a host all-reduce that was aborted by a recovery; the
    worker entrypoint (:mod:`ddw_tpu_torch.runtime._launch_worker`) catches
    it and re-enters the fn in the same process."""

    def __init__(self, generation: int, record: dict | None = None,
                 step: int | None = None):
        self.generation = generation
        self.record = dict(record or {})
        self.step = step
        super().__init__(
            f"elastic re-rendezvous requested: generation {generation} "
            f"(dead rank {self.record.get('dead_rank')}, parked at step "
            f"{step})")


def _atomic_write_json(path: str, payload: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class GangRendezvous:
    """The explicit gang topology: membership, barrier, host reduce.

    One instance per rank (and one driver-side instance in the launcher).
    ``generation`` is the *elastic* generation — 0 at gang launch, bumped by
    every single-rank recovery; it is independent of the supervisor's
    whole-world ``DDW_RESTART_GEN`` (a whole-world restart gets a fresh
    control directory and starts back at elastic generation 0).
    """

    def __init__(self, root: str, world_size: int, rank: int,
                 generation: int = 0, poll_s: float = 0.02):
        self.root = root
        self.world_size = int(world_size)
        self.rank = int(rank)
        self.generation = int(generation)
        self.poll_s = poll_s
        self._votes: dict[int, str] = {}     # generation -> "ack" | "veto"
        self._vote_ordinal = 0               # per-process count of votes cast
        os.makedirs(root, exist_ok=True)

    # -- membership ----------------------------------------------------------
    def announce(self) -> None:
        """Record this rank's membership for the current generation (pid +
        start time) — the forensic evidence that elastic recovery kept the
        survivors' processes alive (their pid is identical across
        generations) while the dead rank's changed."""
        _atomic_write_json(
            os.path.join(self.root,
                         f"member_g{self.generation}_r{self.rank}.json"),
            {"pid": os.getpid(), "rank": self.rank,
             "generation": self.generation, "started_unix": time.time()})

    def member(self, generation: int, rank: int) -> dict | None:
        path = os.path.join(self.root, f"member_g{generation}_r{rank}.json")
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # -- recovery ledger -----------------------------------------------------
    def post_recovery(self, generation: int, dead_rank: int | None,
                      exit_code: int | None = None,
                      reason: str = "rank-death", kind: str = "respawn",
                      assignment: dict | None = None,
                      world_size: int | None = None,
                      coordinator: str | None = None) -> dict:
        """Driver side: publish 'the gang re-forms at ``generation``'.
        Idempotent per generation (one recovery record per bump).

        ``kind`` is ``respawn`` (same world, dead rank restarted),
        ``shrink`` (``assignment`` maps each survivor's *current* rank to
        its new contiguous rank and ``world_size`` names the reduced size),
        or ``grow`` (identity assignment, world grows by one). Shrink/grow
        records also carry a fresh ``coordinator`` address so gangs running
        a real process group can re-form it per generation (a group admits
        its ranks once, so a re-formed world needs a fresh port)."""
        record = {"generation": int(generation),
                  "dead_rank": None if dead_rank is None else int(dead_rank),
                  "exit_code": exit_code, "reason": reason, "kind": kind,
                  "world_size": int(self.world_size if world_size is None
                                    else world_size),
                  "posted_unix": time.time()}
        if assignment is not None:
            record["assignment"] = {str(k): int(v)
                                    for k, v in assignment.items()}
        if coordinator is not None:
            record["coordinator"] = coordinator
        _atomic_write_json(
            os.path.join(self.root, f"recover_g{generation}.json"), record)
        return record

    def post_shrink(self, generation: int, dead_rank: int,
                    assignment: dict, world_size: int,
                    exit_code: int | None = None,
                    coordinator: str | None = None,
                    reason: str = "host-lost") -> dict:
        """Driver side: propose re-forming the gang WITHOUT ``dead_rank`` at
        the reduced ``world_size``. Survivors vote (:meth:`wait_votes`)
        before the driver commits the eviction."""
        return self.post_recovery(generation, dead_rank, exit_code=exit_code,
                                  reason=reason, kind="shrink",
                                  assignment=assignment,
                                  world_size=world_size,
                                  coordinator=coordinator)

    def post_grow(self, generation: int, current_ranks: list[int],
                  world_size: int, coordinator: str | None = None,
                  reason: str = "regrow") -> dict:
        """Driver side: re-expand the gang to ``world_size`` (a new rank is
        being spawned at ``world_size - 1``). Identity assignment for the
        incumbents; no vote — growth never strands anyone's state."""
        return self.post_recovery(
            generation, None, reason=reason, kind="grow",
            assignment={str(r): int(r) for r in current_ranks},
            world_size=world_size, coordinator=coordinator)

    def commit_recovery(self, generation: int) -> None:
        """Driver side: commit a voted shrink record. Survivors adopt a
        shrink only after this marker lands (two-phase), so a proposal the
        driver abandons — veto, vote timeout — strands nobody halfway into
        a world that never forms."""
        _atomic_write_json(
            os.path.join(self.root, f"commit_g{generation}"),
            {"generation": int(generation), "committed_unix": time.time()})

    def recovery_committed(self, generation: int) -> bool:
        return os.path.exists(
            os.path.join(self.root, f"commit_g{generation}"))

    def record_for(self, generation: int) -> dict | None:
        """The recovery record that created ``generation``, or None (gen 0
        has no record — it is the spawn-time world)."""
        path = os.path.join(self.root, f"recover_g{generation}.json")
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def coordinator_for(self, generation: int) -> str | None:
        """Coordinator address for ``generation``: the record's fresh port,
        or the spawn-time ``DDW_COORDINATOR`` for generation 0 / records
        that did not rotate the port."""
        rec = self.record_for(generation)
        if rec is not None and rec.get("coordinator"):
            return rec["coordinator"]
        return os.environ.get("DDW_COORDINATOR") or None

    # -- shrink voting -------------------------------------------------------
    def _cast_vote(self, record: dict) -> str:
        """Survivor side: ack or veto a shrink record, exactly once per
        generation (memoized + durable vote file). The ``shrink_veto``
        fault arm hooks the ``shrink_vote`` site with ``step`` equal to the
        per-process vote ordinal, so ``shrink_veto:rank=0`` vetoes only the
        first proposal this process ever votes on (the retry then acks)."""
        gen = int(record["generation"])
        if gen in self._votes:
            return self._votes[gen]
        ordinal = self._vote_ordinal
        self._vote_ordinal += 1
        vote = "ack"
        try:
            from ddw_tpu_torch.runtime.faults import ShrinkVeto, maybe_fault
            try:
                maybe_fault("shrink_vote", step=ordinal)
            except ShrinkVeto:
                vote = "veto"
        except ImportError:     # pragma: no cover - faults always present
            pass
        _atomic_write_json(
            os.path.join(self.root, f"vote_g{gen}_r{self.rank}.json"),
            {"vote": vote, "rank": self.rank, "pid": os.getpid(),
             "ordinal": ordinal, "voted_unix": time.time()})
        self._votes[gen] = vote
        return vote

    def read_votes(self, generation: int) -> dict[int, str]:
        """Driver side: rank -> "ack"/"veto" votes cast so far for the
        shrink record at ``generation`` (keyed by pre-shrink ranks)."""
        votes: dict[int, str] = {}
        prefix = f"vote_g{generation}_r"
        try:
            names = os.listdir(self.root)
        except OSError:
            return votes
        for name in names:
            if not (name.startswith(prefix) and name.endswith(".json")):
                continue
            try:
                rank = int(name[len(prefix):-len(".json")])
                with open(os.path.join(self.root, name)) as f:
                    votes[rank] = json.load(f).get("vote", "ack")
            except (OSError, ValueError):
                continue
        return votes

    def wait_votes(self, generation: int, ranks: list[int],
                   timeout_s: float = 30.0) -> dict[int, str] | None:
        """Driver side: park until every survivor in ``ranks`` voted on the
        shrink record at ``generation`` (or any veto arrives — a single
        veto decides immediately). None on timeout: a survivor that cannot
        vote cannot adopt either, so the driver falls back to whole-world
        restart."""
        deadline = time.monotonic() + timeout_s
        want = set(int(r) for r in ranks)
        while True:
            votes = self.read_votes(generation)
            if any(v == "veto" for r, v in votes.items() if r in want):
                return votes
            if want.issubset(votes.keys()):
                return votes
            if time.monotonic() > deadline:
                return None
            time.sleep(self.poll_s)

    def recovery_pending(self) -> dict | None:
        """The newest recovery record addressing a generation beyond this
        rank's, or None. One directory scan — cheap at chain granularity."""
        newest = None
        try:
            names = os.listdir(self.root)
        except OSError:
            return None
        for name in names:
            if not (name.startswith("recover_g")
                    and name.endswith(".json")):
                continue
            try:
                gen = int(name[len("recover_g"):-len(".json")])
            except ValueError:
                continue
            if gen > self.generation and (newest is None
                                          or gen > newest):
                newest = gen
        if newest is None:
            return None
        try:
            with open(os.path.join(self.root,
                                   f"recover_g{newest}.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None     # racing the atomic publish: next check sees it

    def current_generation(self) -> int:
        """Newest generation named by any recovery record (>= own)."""
        gen = self.generation
        rec = self.recovery_pending()
        if rec is not None:
            gen = max(gen, int(rec["generation"]))
        return gen

    def advance(self, generation: int) -> None:
        """Adopt a new generation (after catching :class:`ElasticRestart`).
        Mirrors it into ``DDW_ELASTIC_GEN`` so env-keyed machinery
        (fault-injection ``egen`` matching) sees the survivor's true
        generation, not its spawn-time one. A shrink/grow record's rank
        ``assignment`` and ``world_size`` are applied here — membership is
        generation-aware, so every subsequent ``range(self.world_size)``
        barrier/reduce scan covers exactly the re-formed gang and never
        waits on an evicted rank's part file. The remapped rank/world are
        mirrored into ``DDW_PROCESS_ID``/``DDW_NUM_PROCESSES`` so the
        result-writer gate, checkpoint writer election and fault matching
        all follow the survivor's new identity."""
        rec = self.record_for(int(generation))
        if rec is not None and rec.get("assignment") is not None:
            new_rank = rec["assignment"].get(str(self.rank))
            if new_rank is None:
                raise RuntimeError(
                    f"rank {self.rank} was evicted by the recovery record "
                    f"at generation {generation}; it cannot adopt it")
            self.rank = int(new_rank)
            self.world_size = int(rec.get("world_size", self.world_size))
            os.environ["DDW_PROCESS_ID"] = str(self.rank)
            os.environ["DDW_NUM_PROCESSES"] = str(self.world_size)
        self.generation = int(generation)
        os.environ["DDW_ELASTIC_GEN"] = str(generation)

    def _check_recovery(self, step: int | None = None) -> None:
        rec = self.recovery_pending()
        if rec is None:
            return
        if rec.get("kind") == "shrink" and rec.get("assignment") is not None:
            gen = int(rec["generation"])
            if rec["assignment"].get(str(self.rank)) is None:
                # Evicted by this record (a zombie the driver gave up on):
                # adopting would be wrong, parking forever is worse. Raise;
                # advance() refuses and the worker exits via its error path.
                raise ElasticRestart(gen, rec, step=step)
            if self._cast_vote(rec) == "veto":
                return      # pinned: keep parking until a retry supersedes it
            if not self.recovery_committed(gen):
                return      # voted ack; adopt only once the driver commits
        raise ElasticRestart(int(rec["generation"]), rec, step=step)

    # -- barrier -------------------------------------------------------------
    def barrier(self, tag, timeout_s: float = 120.0) -> None:
        """Park until every rank of this generation arrives at ``tag`` (a
        step number or a label like ``"start"``). A recovery record
        addressing a newer generation aborts the park with
        :class:`ElasticRestart` — this is exactly where survivors sit while
        the dead rank is respawned. Raises TimeoutError when the gang never
        forms (the caller should exit and let the launcher fall back to
        whole-world restart)."""
        me = os.path.join(
            self.root, f"arrive_g{self.generation}_{tag}_r{self.rank}")
        _atomic_write_json(me, {"pid": os.getpid()})
        deadline = time.monotonic() + timeout_s
        step = tag if isinstance(tag, int) else None
        while True:
            present = sum(
                1 for r in range(self.world_size)
                if os.path.exists(os.path.join(
                    self.root, f"arrive_g{self.generation}_{tag}_r{r}")))
            if present == self.world_size:
                break
            self._check_recovery(step)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"elastic barrier {tag!r} (gen {self.generation}): only "
                    f"{present}/{self.world_size} ranks arrived within "
                    f"{timeout_s}s")
            time.sleep(self.poll_s)
        self._gc_markers(tag)

    def _gc_markers(self, tag) -> None:
        """Drop this rank's OWN markers from earlier integer steps (keep the
        immediately preceding one: a peer can be at most one barrier behind,
        so older markers are unreadable by anyone)."""
        if not isinstance(tag, int):
            return
        prefix = f"_g{self.generation}_"
        for kind in ("arrive", "reduce"):
            try:
                names = os.listdir(self.root)
            except OSError:
                return
            for name in names:
                if not name.startswith(kind + prefix):
                    continue
                rest = name[len(kind + prefix):]
                stem = rest.split("_r")[0]
                if not rest.endswith(f"_r{self.rank}"
                                     + (".json" if kind == "reduce" else "")):
                    continue
                try:
                    s = int(stem)
                except ValueError:
                    continue
                if s < tag - 1:
                    try:
                        os.remove(os.path.join(self.root, name))
                    except OSError:
                        pass

    # -- host-level all-reduce (the MapReduce `reduce` primitive) ------------
    def all_reduce(self, tag, value, op: str = "sum",
                   timeout_s: float = 120.0) -> np.ndarray:
        """Deterministic cross-rank reduction over the control plane: each
        rank publishes its contribution, waits for all peers of the same
        generation, and folds them in rank order (bit-identical on every
        rank). This is the gang's *data* barrier in elastic mode — metrics,
        small gradients, agreement values — and it parks/aborts exactly
        like :meth:`barrier`, so a dead peer never wedges the gang the way
        an in-flight collective would."""
        arr = np.asarray(value, np.float64)
        me = os.path.join(
            self.root,
            f"reduce_g{self.generation}_{tag}_r{self.rank}.json")
        _atomic_write_json(me, {"shape": list(arr.shape),
                                "data": arr.reshape(-1).tolist()})
        deadline = time.monotonic() + timeout_s
        step = tag if isinstance(tag, int) else None
        parts: dict[int, np.ndarray] = {}
        while len(parts) < self.world_size:
            for r in range(self.world_size):
                if r in parts:
                    continue
                path = os.path.join(
                    self.root, f"reduce_g{self.generation}_{tag}_r{r}.json")
                try:
                    with open(path) as f:
                        rec = json.load(f)
                except (OSError, ValueError):
                    continue
                parts[r] = np.asarray(rec["data"], np.float64).reshape(
                    rec["shape"])
            if len(parts) < self.world_size:
                self._check_recovery(step)
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"elastic all_reduce {tag!r} (gen {self.generation})"
                        f": only {len(parts)}/{self.world_size} "
                        f"contributions within {timeout_s}s")
                time.sleep(self.poll_s)
        out = parts[0].copy()
        for r in range(1, self.world_size):
            out = out + parts[r]    # fixed rank order: deterministic
        if op == "mean":
            out = out / self.world_size
        elif op != "sum":
            raise ValueError(f"unknown reduce op {op!r} (have sum, mean)")
        self._gc_markers(tag)
        return out.astype(np.asarray(value).dtype
                          if np.asarray(value).dtype.kind == "f"
                          else np.float64)


# ---------------------------------------------------------------------------
# Process-level context: the worker's own rendezvous, built from the env.
# ---------------------------------------------------------------------------

_ctx: GangRendezvous | None = None


def elastic_enabled() -> bool:
    """True inside an elastic gang (the launcher exported the control dir)."""
    return bool(os.environ.get("DDW_RENDEZVOUS_DIR"))


def context() -> GangRendezvous | None:
    """This process's rendezvous (lazily built from ``DDW_RENDEZVOUS_DIR`` /
    ``DDW_NUM_PROCESSES`` / ``DDW_PROCESS_ID`` / ``DDW_ELASTIC_GEN``), or
    None outside elastic mode. A respawned rank starts at the generation the
    driver stamped into its env; survivors advance theirs in-process."""
    global _ctx
    root = os.environ.get("DDW_RENDEZVOUS_DIR")
    if not root:
        return None
    if _ctx is None or _ctx.root != root:
        _ctx = GangRendezvous(
            root,
            world_size=int(os.environ.get("DDW_NUM_PROCESSES", "1")),
            rank=int(os.environ.get("DDW_PROCESS_ID", "0")),
            generation=int(os.environ.get("DDW_ELASTIC_GEN", "0") or 0))
    return _ctx


def reset_context() -> None:
    global _ctx
    _ctx = None


def maybe_elastic_restart(step: int | None = None) -> None:
    """The trainers' chain-boundary hook (free no-op outside elastic mode):
    if a recovery record addresses a newer generation, raise
    :class:`ElasticRestart` so the surviving rank parks HERE — at a chain
    boundary, before it enters another cross-rank operation with a dead
    peer — and re-runs its train fn from the latest durable checkpoint."""
    if "DDW_RENDEZVOUS_DIR" not in os.environ:     # fast path
        return
    ctx = context()
    if ctx is not None:
        ctx._check_recovery(step)


def elastic_barrier(tag, timeout_s: float = 120.0) -> None:
    """Module-level convenience over :meth:`GangRendezvous.barrier`; no-op
    outside elastic mode. Train fns call ``elastic_barrier("start")`` after
    restoring so the whole (re-formed) gang resumes in lockstep."""
    ctx = context()
    if ctx is not None:
        ctx.barrier(tag, timeout_s=timeout_s)


def host_all_reduce(tag, value, op: str = "sum", timeout_s: float = 120.0):
    """Module-level convenience over :meth:`GangRendezvous.all_reduce`.
    Outside elastic mode this degenerates to the identity (world of one) —
    the same fn body runs under ``np=-1`` smoke mode unchanged."""
    ctx = context()
    if ctx is None:
        arr = np.asarray(value, np.float64)
        return arr if op in ("sum", "mean") else None
    return ctx.all_reduce(tag, value, op=op, timeout_s=timeout_s)


def maybe_reinit_distributed() -> bool:
    """Re-form the ``torch.distributed`` group for the current elastic
    generation on the generation's coordinator (a shrink or grow record's
    fresh port, else the spawn-time ``DDW_COORDINATOR``): destroy the group
    this process is in, then join a new one at the generation's rank and
    world. Opt-in via ``DDW_ELASTIC_JAX_DIST=1`` (``ddw_tpu``'s variable,
    where it re-forms ``jax.distributed``): elastic workers normally stay
    outside a process group (host-level topology only, each rank training
    on its partition), while a gang that wants collectives re-forms the
    group every generation. Returns True when a (re)init happened.
    Best-effort: on failure the gang still has its host-level topology and
    the whole-world fallback. The preemption handler is installed again
    after the join, as ``ddw_tpu`` does after ``jax.distributed``'s."""
    if os.environ.get("DDW_ELASTIC_JAX_DIST", "") not in ("1", "true"):
        return False
    ctx = context()
    if ctx is None or ctx.world_size < 2:
        return False
    coord = ctx.coordinator_for(ctx.generation)
    if not coord:
        return False
    import torch.distributed as dist

    from ddw_tpu_torch.runtime.dist import init_distributed
    try:
        if dist.is_initialized():
            dist.destroy_process_group()
    except Exception:
        pass        # a group broken by the dead peer: nothing to tear down
    try:
        init_distributed(addr=coord, world=ctx.world_size, rank=ctx.rank)
    except Exception:
        return False
    try:
        from ddw_tpu_torch.runtime.faults import install_preemption_handler
        install_preemption_handler()
    except Exception:
        pass
    return True
