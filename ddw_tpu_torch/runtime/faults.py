"""Deterministic fault injection + graceful-preemption primitives — the
port of ``ddw_tpu.runtime.faults``, whole (host logic, no device code).

Every spec string parses to the same fields as in ``ddw_tpu``, and the
exit codes are the same numbers, so a drill written for one package drives
the other. Every scope is wired in this package: the gang scope in the fit
loops of both trainers (the ``step`` site), the checkpoint writers
(``ckpt_async``), the launch worker (``coord_bind``, the exit codes the
:class:`~ddw_tpu_torch.runtime.launcher.Launcher` classifies) and the
elastic shrink vote (``shrink_vote``); the serve, deploy and autoscale
scopes in :mod:`ddw_tpu_torch.serve.engine`, :mod:`ddw_tpu_torch.deploy`
and :mod:`ddw_tpu_torch.autoscale`.

The gang's failure modes (worker crash, stall, silent exit, torn checkpoint,
preemption, coordinator-port collision) are rare and timing-dependent in
production but must be *reproducible in CI on CPU* for the recovery machinery
(``ddw_tpu``'s gang supervisor, checkpoint quarantine) to stay tested.
This module turns each of them into an env-var knob:

    DDW_FAULT=<kind>[:key=value]*

Kinds (and the hook site each fires at):

========== ============ ==========================================================
kind        site         effect when the spec matches
========== ============ ==========================================================
crash       step         ``os._exit(EXIT_FAULT_CRASH)`` — a hard SIGKILL-like death
kill        step         ``SIGKILL`` to this process — a true signal death (exit
                         code ``-9``): the "one rank dies mid-epoch" arm the
                         elastic drills key on, with signal forensics intact
raise       step         raise :class:`FaultInjected` — the worker writes an error
                         result and exits nonzero (exercises the rank-0-traceback
                         surfacing path)
stall       step         sleep forever — exercises the gang deadline
exit0_early step         ``os._exit(0)`` before writing a result — a "successful"
                         exit that leaves the driver with no result.pkl
preempt     step         deliver SIGTERM to this process (the cluster-manager
                         preemption analog); the installed handler sets the flag
                         the trainers' step loops check
ckpt_torn   step         drop a torn (partial, non-atomic) step dir into the
                         checkpoint directory, then crash — exercises quarantine
ckpt_async_torn
            ckpt_async   fires INSIDE the background checkpoint writer thread:
                         publishes a torn step dir for the step being written
                         (as a filesystem that lost the atomic discipline
                         would), then dies mid-write — exercises async-write
                         quarantine across restart generations
bind_fail   coord_bind   ``os._exit(EXIT_COORD_BIND)`` before the coordinator
                         binds — the port-collision (TOCTOU) analog
host_lost   step         ``os._exit(EXIT_HOST_LOST)`` — the permanent-loss
                         verdict: the rank dies AND its respawn always fails
                         (``egen`` defaults to ``*`` for this kind only, so a
                         respawned incarnation dies again at the same step).
                         The launcher treats the exit code as "host gone for
                         good", skips the respawn budget, and goes straight
                         to the shrink ladder (see ``min_world_size``)
shrink_veto shrink_vote  raise :class:`ShrinkVeto` inside a survivor's vote on
                         a shrink record: the vote is recorded as ``veto``,
                         the proposal is pinned, and the driver retries at a
                         bumped generation or falls back to whole-world
                         restart. ``step`` matches the per-process vote
                         ordinal and defaults to 0 — veto the first proposal,
                         ack the retry; ``step=*`` vetoes every proposal (the
                         abort arm)
========== ============ ==========================================================

Match keys (all optional): ``rank=N`` (default: any rank; read from
``DDW_PROCESS_ID``), ``step=N`` (default: first check of the site),
``gen=N|*`` (restart generation, from ``DDW_RESTART_GEN``; default 0 so a
fault fires in the first generation only and the restarted gang runs clean),
``egen=N|*`` (ELASTIC generation, from ``DDW_ELASTIC_GEN``; default 0 so the
single rank an elastic recovery respawned runs clean — ``egen=*`` makes the
fault chase every respawn, the deterministic "re-rendezvous keeps failing"
drill that forces the whole-world fallback), ``attempt=N|*`` (spawn attempt
within one generation, from ``DDW_SPAWN_ATTEMPT``; default 0 so a bind
failure clears on the launcher's respawn). ``*`` means "any".

Several specs can be chained with ``;`` —
``DDW_FAULT=host_lost:rank=2:step=3;shrink_veto:rank=0`` — and each hook
site fires the first chained spec that matches it, so one drill can combine
a permanent rank death with a shrink-vote veto. ``rank`` always matches the
process's *spawn-time* rank for faults that fire before a shrink is adopted
(the shrink remap updates ``DDW_PROCESS_ID`` only at adoption).

Example: ``DDW_FAULT=crash:rank=1:step=3`` kills rank 1 at global step 3 of
the first generation; every other process/step/generation is untouched. With
no ``DDW_FAULT`` set, :func:`maybe_fault` is a near-free no-op — the hooks are
safe to leave in production step loops.

Serve scope
-----------

The serving stack (:mod:`ddw_tpu_torch.serve`, :mod:`ddw_tpu_torch.gateway`) has its own
failure geometry: replicas are *threads in one process*, so a "crash" must
kill an engine loop, not the interpreter, and the match keys are per-replica
rather than per-rank. A ``serve:``-prefixed spec targets those hooks and is
invisible to the gang sites (and vice versa):

    DDW_FAULT=serve:<kind>[:site=prefill|decode|admit|batch|*][:replica=N|*]
                           [:after=N][:gen=N|*]

The ``batch`` site fires at the batch lane's admission boundary (an engine
about to backfill queued ``lm_batch``/``image_batch`` work into idle
capacity) — the drill point for killing a replica mid-job and asserting the
host-side job ledger resumes with no duplicated or lost items.

Serve kinds: ``crash`` (raise :class:`ServeCrash` — the engine loop dies,
transitions the replica to its terminal FAILED state and fails every pending
future with a structured ``ReplicaFailed``), ``raise`` (raise
:class:`FaultInjected` — one recoverable loop error; the replica degrades and
its consecutive-error budget decides), ``stall`` (the hook blocks while the
spec stays configured — exercises last-tick-age stall detection and the
circuit breaker; clearing ``DDW_FAULT`` resumes the tick cleanly, so a test
can hold an engine mid-decode and release it, while the engine's stop/fail
signal aborts hard so a force-failed thread always stays joinable).

Defaults mirror the gang scope's single-shot-drill safety: ``replica=0``
(one of N replicas dies, the siblings keep serving), ``site=*`` (first hook
reached), ``after=0`` (the first matching check fires), ``gen=0`` (the
supervisor-restarted replica runs clean). The ``after=N`` key counts
invocations of the matching site *within one replica generation*, so
"die mid-stream on the 5th decode tick" is deterministic on CPU.

Deploy scope
------------

Rollouts (:mod:`ddw_tpu_torch.deploy`) get their own arms — a ``deploy:`` spec
is invisible to both the gang and the serve sites:

    DDW_FAULT=deploy:degrade_canary[:replica=N|*][:ttft_ms=F][:errors=K]
    DDW_FAULT=deploy:crash_mid_roll[:after=N]

========= ========== ========================================================
kind       site       effect when the spec matches
========= ========== ========================================================
degrade_   judge      the canary judge's measurement of the new-checkpoint
canary                replica is degraded exactly as a bad checkpoint would
                      degrade it: ``ttft_ms`` of real latency is injected
                      into each judge probe against the canary (the probe IS
                      a request to that replica) and ``errors`` synthetic
                      probe failures are charged against it — driving the
                      reject verdict deterministically with zero client
                      impact
crash_     mid_roll   raise :class:`DeployCrash` at the journal boundary
mid_roll              BEFORE rolling the ``after``-th replica — the control
                      thread dies without finalizing the rollout journal,
                      the in-process stand-in for a gateway SIGKILL
                      mid-rollout (the reconciler drills key on it)
========= ========== ========================================================

``replica`` defaults to ``*`` (any — the judge passes the canary's index);
``ttft_ms`` defaults to 250; ``errors`` to 0; ``after`` to 0 (crash before
the first replica rolls).

Autoscale scope
---------------

The autoscaler (:mod:`ddw_tpu_torch.autoscale`) gets its own arms — an
``autoscale:`` spec is invisible to the gang, serve, and deploy sites:

    DDW_FAULT=autoscale:spawn_fail[:after=N]
    DDW_FAULT=autoscale:stall_drain
    DDW_FAULT=autoscale:flap
    DDW_FAULT=autoscale:crash_mid_scale[:after=N]

=============== ========= ===================================================
kind             site      effect when the spec matches
=============== ========= ===================================================
spawn_fail       spawn     raise :class:`FaultInjected` where the controller
                           spawns a surge child — the scale-out must abort
                           with the journal finalized and ZERO capacity
                           consumed (the cold replica was never admitted)
stall_drain      drain     block while the spec stays configured (clearing
                           ``DDW_FAULT`` resumes; the controller's abort
                           signal raises) — holds a scale-in's drain wait
                           open so the drain deadline fires and the victim
                           is re-admitted instead of killed with work aboard
flap             decide    RETURNED for the controller to apply: synthetic
                           pressure alternating out/in every decide tick —
                           the hysteresis band + per-direction cooldowns
                           must absorb it into a bounded number of real
                           scale events
crash_mid_scale  mid_scale raise :class:`AutoscaleCrash` at the journal
                           boundary after ``after`` journaled steps — the
                           reconciler at ``Gateway.start()`` drills on the
                           unfinalized scale journal it leaves behind
=============== ========= ===================================================
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time

# Worker exit codes with supervisor/launcher meaning. Chosen in the 64..113
# user range so they can't collide with shell/signal conventions.
EXIT_FAULT_CRASH = 77   # injected hard crash (deterministic stand-in for SIGKILL)
EXIT_PREEMPTED = 83     # graceful preemption: checkpointed, then clean exit
EXIT_COORD_BIND = 84    # coordinator could not bind its port (spawn-time race)
EXIT_HOST_LOST = 85     # permanent host loss: respawn is futile, shrink instead

KINDS = ("crash", "kill", "raise", "stall", "exit0_early", "preempt",
         "ckpt_torn", "ckpt_async_torn", "bind_fail", "host_lost",
         "shrink_veto")

_SITE_BY_KIND = {k: ("coord_bind" if k == "bind_fail"
                     else "ckpt_async" if k == "ckpt_async_torn"
                     else "shrink_vote" if k == "shrink_veto"
                     else "step")
                 for k in KINDS}


class FaultInjected(RuntimeError):
    """Raised by the ``raise`` fault kind — an injected application error."""


class ShrinkVeto(RuntimeError):
    """Raised by the ``shrink_veto`` kind inside a survivor's vote on a
    shrink record (``ddw_tpu``'s ``GangRendezvous._cast_vote``
    catches it and records the veto) — the deterministic "one survivor
    refuses the new topology" arm that pins the driver's retry/abort path."""


class ServeCrash(RuntimeError):
    """Raised by the ``serve:crash`` kind (and by an aborted ``serve:stall``)
    — the serving-engine analog of a hard rank death: the engine loop must
    die, fail its pending futures, and leave the replica FAILED."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Parsed ``DDW_FAULT`` value. ``None`` fields match anything."""

    kind: str
    rank: int | None = None
    step: int | None = None
    gen: int | None = 0
    egen: int | None = 0
    attempt: int | None = 0

    @property
    def site(self) -> str:
        return _SITE_BY_KIND[self.kind]

    def matches(self, site: str, step: int | None = None,
                rank: int | None = None, gen: int | None = None,
                attempt: int | None = None,
                egen: int | None = None) -> bool:
        """Pure matching logic (env-independent — unit-testable)."""
        if site != self.site:
            return False
        if self.rank is not None and rank != self.rank:
            return False
        if self.gen is not None and gen != self.gen:
            return False
        if self.egen is not None and (egen or 0) != self.egen:
            return False
        if self.attempt is not None and attempt != self.attempt:
            return False
        if self.step is not None and step != self.step:
            return False
        return True


def parse_fault(spec: str) -> FaultSpec | None:
    """Parse a ``DDW_FAULT`` value; empty/None -> None. Malformed specs raise
    (a typo'd fault that silently never fires would "pass" every CI run).
    A ``serve:``-scoped spec parses as None here — it targets the serving
    hooks (:func:`parse_serve_fault`), not the gang sites — but still
    validates, so a typo'd serve spec fails loudly at the first gang hook
    too."""
    if not spec:
        return None
    if spec.startswith("serve:"):
        parse_serve_fault(spec)     # validate, then ignore at gang sites
        return None
    if spec.startswith("deploy:"):
        parse_deploy_fault(spec)    # validate, then ignore at gang sites
        return None
    if spec.startswith("autoscale:"):
        parse_autoscale_fault(spec)  # validate, then ignore at gang sites
        return None
    parts = spec.split(":")
    kind = parts[0].strip()
    if kind not in KINDS:
        raise ValueError(f"unknown DDW_FAULT kind {kind!r}; expected one of "
                         f"{KINDS}")
    fields: dict[str, int | None] = {}
    for part in parts[1:]:
        if not part:
            continue
        key, _, val = part.partition("=")
        key = key.strip()
        if key not in ("rank", "step", "gen", "egen", "attempt"):
            raise ValueError(f"unknown DDW_FAULT key {key!r} in {spec!r}")
        val = val.strip()
        fields[key] = None if val == "*" else int(val)
    # Per-kind defaults: host_lost means "the respawn always fails too", so
    # it chases every elastic generation unless pinned; shrink_veto means
    # "reject ONCE" (vote ordinal 0), so the driver's retry gets an ack.
    egen_default = None if kind == "host_lost" else 0
    step_default = 0 if kind == "shrink_veto" else None
    return FaultSpec(kind=kind, rank=fields.get("rank"),
                     step=fields["step"] if "step" in fields
                     else step_default,
                     gen=fields.get("gen", 0),
                     egen=fields["egen"] if "egen" in fields
                     else egen_default,
                     attempt=fields.get("attempt", 0))


def _env_int(name: str, default: int = 0) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _fault_parts() -> list[str]:
    """The ``;``-chained raw spec strings in ``DDW_FAULT`` (possibly one)."""
    raw = os.environ.get("DDW_FAULT", "")
    return [p.strip() for p in raw.split(";") if p.strip()]


def active_faults() -> list[FaultSpec]:
    """Every gang-scope fault currently configured (``;``-chained specs all
    parse; scoped serve/deploy/autoscale entries validate but drop out)."""
    specs = []
    for part in _fault_parts():
        spec = parse_fault(part)
        if spec is not None:
            specs.append(spec)
    return specs


def active_fault() -> FaultSpec | None:
    """The first currently configured gang-scope fault, re-read from the env
    on every call (tests monkeypatch ``DDW_FAULT`` mid-process)."""
    specs = active_faults()
    return specs[0] if specs else None


def maybe_fault(site: str, step: int | None = None,
                ckpt_dir: str | None = None) -> None:
    """Hook call: fire the first configured fault whose spec matches this
    site / step / rank / generation / spawn attempt. No-op without
    ``DDW_FAULT``."""
    if "DDW_FAULT" not in os.environ:  # fast path for production step loops
        return
    for spec in active_faults():
        if spec.matches(
                site, step=step,
                rank=_env_int("DDW_PROCESS_ID", 0),
                gen=_env_int("DDW_RESTART_GEN", 0),
                egen=_env_int("DDW_ELASTIC_GEN", 0),
                attempt=_env_int("DDW_SPAWN_ATTEMPT", 0)):
            _fire(spec, step, ckpt_dir)
            return


def _fire(spec: FaultSpec, step: int | None, ckpt_dir: str | None) -> None:
    where = f"rank {_env_int('DDW_PROCESS_ID', 0)}, step {step}, " \
            f"gen {_env_int('DDW_RESTART_GEN', 0)}"
    if spec.kind == "crash":
        os._exit(EXIT_FAULT_CRASH)
    if spec.kind == "kill":
        # A true signal death (waitpid code -SIGKILL): the launcher's
        # forensics record the signal, and no atexit/finally runs — the
        # closest CPU-reproducible stand-in for a preempted/OOM-killed host.
        os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(60.0)    # pending-signal window; never survives it
    if spec.kind == "raise":
        raise FaultInjected(f"injected fault ({where})")
    if spec.kind == "stall":
        while True:  # hold the gang hostage until the deadline kill
            time.sleep(0.5)
    if spec.kind == "exit0_early":
        os._exit(0)
    if spec.kind == "preempt":
        # The cluster-manager SIGTERM, delivered to ourselves: the installed
        # handler sets the flag; the step loop notices and checkpoints.
        # Install first so an in-process (np=-1) test doesn't die to the
        # default SIGTERM disposition.
        install_preemption_handler()
        os.kill(os.getpid(), signal.SIGTERM)
        return
    if spec.kind == "ckpt_torn":
        if ckpt_dir:
            _write_torn_step_dir(ckpt_dir, (step or 0) + 1000)
        os._exit(EXIT_FAULT_CRASH)
    if spec.kind == "ckpt_async_torn":
        # Fires on the BACKGROUND WRITER THREAD (the ckpt_async site lives
        # inside the async checkpoint writers): publish a torn dir for the
        # very step being written — what a non-atomic filesystem could leave
        # after losing the rename/fsync discipline — then die mid-write.
        # latest_step()/latest_complete_step() must quarantine it on restart.
        if ckpt_dir:
            _write_torn_step_dir(ckpt_dir, step or 0)
        os._exit(EXIT_FAULT_CRASH)
    if spec.kind == "bind_fail":
        os._exit(EXIT_COORD_BIND)
    if spec.kind == "host_lost":
        # The permanent-loss verdict, deterministically: the distinguished
        # exit code tells the launcher respawning is futile (a real lost
        # host earns the same verdict via the transport probe / exhausted
        # respawn budget), so it goes straight to shrink-or-whole-world.
        os._exit(EXIT_HOST_LOST)
    if spec.kind == "shrink_veto":
        raise ShrinkVeto(f"injected shrink veto ({where})")


def _write_torn_step_dir(ckpt_dir: str, step: int) -> str:
    """A partial step dir as a non-atomic writer killed mid-write would leave:
    truncated state bytes, no metadata sidecar. ``latest_step``/``restore``
    must quarantine it and fall back to the previous good step."""
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "state.msgpack"), "wb") as f:
        f.write(b"torn")
    return d


# ---------------------------------------------------------------------------
# Serve scope: per-replica fault injection for the online serving stack.
# ---------------------------------------------------------------------------

SERVE_KINDS = ("crash", "raise", "stall")
SERVE_SITES = ("prefill", "decode", "admit", "batch")


@dataclasses.dataclass(frozen=True)
class ServeFaultSpec:
    """Parsed ``DDW_FAULT=serve:...`` value. ``None`` fields match anything;
    defaults make a bare ``serve:crash`` a safe single-replica drill (replica
    0, first hook reached, first generation only)."""

    kind: str
    site: str | None = None       # None = any serve site
    replica: int | None = 0
    after: int = 0                # fire on the Nth matching check (per gen)
    gen: int | None = 0

    def matches(self, site: str, replica: int, n: int, gen: int) -> bool:
        """Pure matching logic. ``n`` is the engine's own invocation count
        for this site within its current generation (0-based)."""
        if self.site is not None and site != self.site:
            return False
        if self.replica is not None and replica != self.replica:
            return False
        if self.gen is not None and gen != self.gen:
            return False
        return n >= self.after


def parse_serve_fault(spec: str) -> ServeFaultSpec | None:
    """Parse a ``serve:``-scoped ``DDW_FAULT`` value; non-serve specs (and
    empty) -> None. Malformed serve specs raise, same rule as
    :func:`parse_fault`."""
    if not spec or not spec.startswith("serve:"):
        return None
    parts = spec.split(":")[1:]
    if not parts or parts[0].strip() not in SERVE_KINDS:
        raise ValueError(f"unknown DDW_FAULT serve kind "
                         f"{parts[0].strip() if parts else ''!r}; expected "
                         f"one of {SERVE_KINDS}")
    kind = parts[0].strip()
    fields: dict[str, object] = {}
    for part in parts[1:]:
        if not part:
            continue
        key, _, val = part.partition("=")
        key, val = key.strip(), val.strip()
        if key == "site":
            if val != "*" and val not in SERVE_SITES:
                raise ValueError(f"unknown DDW_FAULT serve site {val!r}; "
                                 f"expected one of {SERVE_SITES} or '*'")
            fields["site"] = None if val == "*" else val
        elif key in ("replica", "gen"):
            fields[key] = None if val == "*" else int(val)
        elif key == "after":
            fields[key] = int(val)
        else:
            raise ValueError(f"unknown DDW_FAULT serve key {key!r} in "
                             f"{spec!r}")
    return ServeFaultSpec(kind=kind, **fields)


def active_serve_fault() -> ServeFaultSpec | None:
    """The currently configured serve fault, re-read from the env on every
    call (tests monkeypatch ``DDW_FAULT`` mid-process)."""
    for part in _fault_parts():
        spec = parse_serve_fault(part)
        if spec is not None:
            return spec
    return None


def maybe_serve_fault(site: str, replica: int, n: int, gen: int,
                      should_abort=None) -> None:
    """Serving-engine hook: fire the configured ``serve:`` fault iff its
    spec matches this site / replica / invocation count / generation.
    No-op without ``DDW_FAULT``. ``should_abort`` (a nullary bool callable —
    the engine's stop-or-fail signal) lets an injected stall end without
    leaking an unjoinable thread: the stall raises :class:`ServeCrash` the
    moment the engine is told to die."""
    if "DDW_FAULT" not in os.environ:   # fast path for the serving hot loop
        return
    spec = active_serve_fault()
    if spec is None or not spec.matches(site, replica=replica, n=n, gen=gen):
        return
    where = f"replica {replica}, site {site}, n {n}, gen {gen}"
    if spec.kind == "crash":
        raise ServeCrash(f"injected serve crash ({where})")
    if spec.kind == "raise":
        raise FaultInjected(f"injected serve fault ({where})")
    if spec.kind == "stall":
        # stall WHILE CONFIGURED: clearing/changing DDW_FAULT resumes the
        # tick cleanly (a test can hold an engine mid-decode and release
        # it); the engine's stop/fail signal instead aborts hard — the
        # supervisor's force_fail path, where the thread must die joinable
        while should_abort is None or not should_abort():
            if active_serve_fault() != spec:
                return
            time.sleep(0.01)
        raise ServeCrash(f"injected serve stall aborted ({where})")


# ---------------------------------------------------------------------------
# Deploy scope: deterministic arms for the rollout subsystem (ddw_tpu_torch.deploy).
# ---------------------------------------------------------------------------

DEPLOY_KINDS = ("degrade_canary", "crash_mid_roll")
DEPLOY_SITES = ("judge", "mid_roll")


class DeployCrash(RuntimeError):
    """Raised by ``deploy:crash_mid_roll`` — the rollout control thread dies
    at a journal boundary WITHOUT finalizing the journal, the in-process
    stand-in for a gateway SIGKILL mid-rollout. The reconciler
    (``Gateway.start``) must converge the half-rolled fleet on restart."""


@dataclasses.dataclass(frozen=True)
class DeployFaultSpec:
    """Parsed ``DDW_FAULT=deploy:...`` value. ``None`` fields match anything;
    a bare ``deploy:degrade_canary`` degrades whichever replica the judge is
    measuring, and a bare ``deploy:crash_mid_roll`` dies before the first
    replica rolls."""

    kind: str
    replica: int | None = None    # degrade target (None = any; the judge
    #                               passes the canary's index)
    after: int = 0                # mid_roll: journaled steps completed
    #                               before the crash; judge: Nth probe
    ttft_ms: float = 250.0        # degrade: latency injected per judge probe
    errors: int = 0               # degrade: synthetic probe failures charged

    @property
    def site(self) -> str:
        return "judge" if self.kind == "degrade_canary" else "mid_roll"

    def matches(self, site: str, replica: int = 0, n: int = 0) -> bool:
        """Pure matching logic. ``n`` is the caller's invocation count for
        the site (journaled steps for ``mid_roll``, probes for ``judge``)."""
        if site != self.site:
            return False
        if self.replica is not None and replica != self.replica:
            return False
        return n >= self.after


def parse_deploy_fault(spec: str) -> DeployFaultSpec | None:
    """Parse a ``deploy:``-scoped ``DDW_FAULT`` value; non-deploy specs (and
    empty) -> None. Malformed deploy specs raise, same rule as
    :func:`parse_fault`."""
    if not spec or not spec.startswith("deploy:"):
        return None
    parts = spec.split(":")[1:]
    if not parts or parts[0].strip() not in DEPLOY_KINDS:
        raise ValueError(f"unknown DDW_FAULT deploy kind "
                         f"{parts[0].strip() if parts else ''!r}; expected "
                         f"one of {DEPLOY_KINDS}")
    kind = parts[0].strip()
    fields: dict[str, object] = {}
    for part in parts[1:]:
        if not part:
            continue
        key, _, val = part.partition("=")
        key, val = key.strip(), val.strip()
        if key == "replica":
            fields[key] = None if val == "*" else int(val)
        elif key in ("after", "errors"):
            fields[key] = int(val)
        elif key == "ttft_ms":
            fields[key] = float(val)
        else:
            raise ValueError(f"unknown DDW_FAULT deploy key {key!r} in "
                             f"{spec!r}")
    return DeployFaultSpec(kind=kind, **fields)


def active_deploy_fault() -> DeployFaultSpec | None:
    """The currently configured deploy fault, re-read from the env on every
    call (tests monkeypatch ``DDW_FAULT`` mid-process)."""
    for part in _fault_parts():
        spec = parse_deploy_fault(part)
        if spec is not None:
            return spec
    return None


def maybe_deploy_fault(site: str, replica: int = 0,
                       n: int = 0) -> DeployFaultSpec | None:
    """Rollout hook: at ``mid_roll`` a matching ``crash_mid_roll`` raises
    :class:`DeployCrash`; at ``judge`` a matching ``degrade_canary`` is
    RETURNED for the caller to apply (the judge injects ``ttft_ms`` into its
    canary probe and charges ``errors`` against the canary — the
    perturbation happens where the measurement happens, so no client request
    is ever touched). No-op (None) without ``DDW_FAULT``."""
    if "DDW_FAULT" not in os.environ:   # fast path
        return None
    spec = active_deploy_fault()
    if spec is None or not spec.matches(site, replica=replica, n=n):
        return None
    if spec.kind == "crash_mid_roll":
        raise DeployCrash(f"injected mid-roll crash (step {n}): journal "
                          f"left unfinalized")
    return spec


# ---------------------------------------------------------------------------
# Autoscale scope: deterministic arms for the fleet autoscaler
# (ddw_tpu_torch.autoscale) — spawn failure, stuck drain, oscillating pressure,
# and the mid-scale gateway death the scale journal exists for.
# ---------------------------------------------------------------------------

AUTOSCALE_KINDS = ("spawn_fail", "stall_drain", "flap", "crash_mid_scale")
AUTOSCALE_SITES = ("spawn", "drain", "decide", "mid_scale")

_AUTOSCALE_SITE_BY_KIND = {"spawn_fail": "spawn", "stall_drain": "drain",
                           "flap": "decide", "crash_mid_scale": "mid_scale"}


class AutoscaleCrash(RuntimeError):
    """Raised by ``autoscale:crash_mid_scale`` — the scale event's control
    flow dies at a journal boundary WITHOUT finalizing the scale journal,
    the in-process stand-in for a gateway SIGKILL mid-scale. The autoscale
    reconciler (``Gateway.start``) must converge the fleet on restart."""


@dataclasses.dataclass(frozen=True)
class AutoscaleFaultSpec:
    """Parsed ``DDW_FAULT=autoscale:...`` value. A bare spec fires on the
    first matching site check (``after=0``)."""

    kind: str
    after: int = 0                # fire on the Nth matching check

    @property
    def site(self) -> str:
        return _AUTOSCALE_SITE_BY_KIND[self.kind]

    def matches(self, site: str, n: int = 0) -> bool:
        """Pure matching logic. ``n`` is the caller's invocation count for
        the site (journaled steps for ``mid_scale``, decide ticks for
        ``decide``, spawn attempts for ``spawn``)."""
        return site == self.site and n >= self.after


def parse_autoscale_fault(spec: str) -> AutoscaleFaultSpec | None:
    """Parse an ``autoscale:``-scoped ``DDW_FAULT`` value; non-autoscale
    specs (and empty) -> None. Malformed specs raise, same rule as
    :func:`parse_fault`."""
    if not spec or not spec.startswith("autoscale:"):
        return None
    parts = spec.split(":")[1:]
    if not parts or parts[0].strip() not in AUTOSCALE_KINDS:
        raise ValueError(f"unknown DDW_FAULT autoscale kind "
                         f"{parts[0].strip() if parts else ''!r}; expected "
                         f"one of {AUTOSCALE_KINDS}")
    kind = parts[0].strip()
    fields: dict[str, int] = {}
    for part in parts[1:]:
        if not part:
            continue
        key, _, val = part.partition("=")
        key, val = key.strip(), val.strip()
        if key == "after":
            fields[key] = int(val)
        else:
            raise ValueError(f"unknown DDW_FAULT autoscale key {key!r} in "
                             f"{spec!r}")
    return AutoscaleFaultSpec(kind=kind, **fields)


def active_autoscale_fault() -> AutoscaleFaultSpec | None:
    """The currently configured autoscale fault, re-read from the env on
    every call (tests monkeypatch ``DDW_FAULT`` mid-process)."""
    for part in _fault_parts():
        spec = parse_autoscale_fault(part)
        if spec is not None:
            return spec
    return None


def maybe_autoscale_fault(site: str, n: int = 0,
                          should_abort=None) -> AutoscaleFaultSpec | None:
    """Autoscaler hook: at ``spawn`` a matching ``spawn_fail`` raises
    :class:`FaultInjected`; at ``mid_scale`` a matching ``crash_mid_scale``
    raises :class:`AutoscaleCrash`; at ``drain`` a matching ``stall_drain``
    BLOCKS while the spec stays configured (clearing ``DDW_FAULT`` resumes
    the drain wait cleanly; ``should_abort`` — the controller's stop signal
    — raises so the wait always stays joinable); at ``decide`` a matching
    ``flap`` is RETURNED for the controller to apply as synthetic
    alternating pressure. No-op (None) without ``DDW_FAULT``."""
    if "DDW_FAULT" not in os.environ:   # fast path for the reconcile tick
        return None
    spec = active_autoscale_fault()
    if spec is None or not spec.matches(site, n=n):
        return None
    if spec.kind == "spawn_fail":
        raise FaultInjected(f"injected autoscale spawn failure (attempt {n})")
    if spec.kind == "crash_mid_scale":
        raise AutoscaleCrash(f"injected mid-scale crash (step {n}): scale "
                             f"journal left unfinalized")
    if spec.kind == "stall_drain":
        while should_abort is None or not should_abort():
            if active_autoscale_fault() != spec:
                return None     # fault cleared: the drain wait resumes
            time.sleep(0.01)
        raise AutoscaleCrash(f"injected drain stall aborted (n {n})")
    return spec                 # flap: the controller applies it


# ---------------------------------------------------------------------------
# Graceful preemption: SIGTERM -> flag -> checkpoint-and-clean-exit.
# ---------------------------------------------------------------------------

_preempt_flag = threading.Event()


class Preempted(Exception):
    """Raised by a step loop after it checkpointed in response to SIGTERM.

    In-process (np=-1) runs see it directly; gang workers
    (:mod:`ddw_tpu_torch.runtime._launch_worker`) convert it to
    ``EXIT_PREEMPTED``, which the
    :class:`~ddw_tpu_torch.runtime.supervisor.GangSupervisor` treats as
    restartable without consuming the crash-restart budget.
    """

    def __init__(self, step: int | None = None):
        self.step = step
        super().__init__(f"preempted at step {step}")


def install_preemption_handler(signum: int = signal.SIGTERM) -> None:
    """Route ``signum`` (default SIGTERM — what cluster managers send before
    reclaiming a node) to the preemption flag instead of immediate death.
    Main-thread only (a CPython signal constraint); idempotent."""
    signal.signal(signum, lambda _sig, _frame: _preempt_flag.set())


def preemption_requested() -> bool:
    """Checked by the trainers once per step: True after SIGTERM arrived."""
    return _preempt_flag.is_set()


def request_preemption() -> None:
    """Set the flag directly (signal-free path for tests/embedding hosts)."""
    _preempt_flag.set()


def reset_preemption() -> None:
    _preempt_flag.clear()
