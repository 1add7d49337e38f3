"""An engine replica living in its own OS process.

:class:`ProcessReplica` presents the same duck-typed EngineReplica surface
:class:`~ddw_tpu_torch.serve.ServingEngine` does — ``submit_generate`` /
``submit_predict`` / batch-lane submits returning futures, ``health()`` /
``load()`` for routing, ``restart`` / ``clone_fresh`` / ``force_fail`` /
``recycle`` for supervision — but the engine behind it runs in a child
process (:mod:`ddw_tpu_torch.deploy._serve_worker`), reached over a keep-alive
:class:`~ddw_tpu_torch.gateway.client.GatewayClient`. :class:`ReplicaSet` routes
to it like any in-thread engine; :class:`ReplicaSupervisor` restarts it
through the same backoff / half-open / shadow-probe path. What process
isolation buys over threads: a segfaulting or wedged device computation takes
down ONE replica's process, not the fleet; weight hot-swaps get a truly
fresh interpreter; and ``kill -9`` is a recovery primitive that always
works (an in-thread replica wedged inside device work can only be
abandoned, never reclaimed).

Lifecycle mapping (thread replica → process replica):

==================  =====================================================
``start()``         spawn the child (non-blocking; it warms up there)
``warmup()``        await the port-file handshake, then ``/readyz`` —
                    the child gates its own readiness on warmup, so this
                    IS warmup gating, observed from outside
``force_fail()``    SIGKILL — the stall path's unconditional hammer
``recycle()``       SIGTERM (child drains in flight work, exits 0), then
                    respawn — on the staged checkpoint when one is pending
``restart()``       kill whatever remains, respawn, generation += 1
``stop()``          SIGTERM, bounded wait, SIGKILL
==================  =====================================================

Failure detection is two-pronged: a watcher thread blocks in ``wait()``
on the child and fires ``on_failure`` the moment it dies (exit code kept
as forensics), and ``health()`` converts an unreachable-or-silent child
into a growing ``last_tick_age_s`` so the supervisor's stall detector
fires for a wedged-but-alive process exactly as for a wedged thread.

The port of ``ddw_tpu.deploy.process_replica``: the same host logic,
importing nothing of ``ddw_tpu``. Two things differ. The child's device is
the ``device`` argument (``--device``; ``None`` = the CUDA card, and a
child that finds none exits with its startup error — it never carries on
on the CPU), where ``ddw_tpu`` pinned platforms through JAX environment
variables; each child on the card owns its own CUDA context. And a sampled
request's generator is consumed HERE: the parent draws the per-step seeds
the in-thread engine would draw and relays them as ``step_seeds``, so a
seed gives the same tokens in-thread and through the process hop.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from ddw_tpu_torch.gateway.client import (GatewayClient, GatewayDeadline,
                                          GatewayError, GatewayOverloaded,
                                          GatewayUnavailable)
from ddw_tpu_torch.serve.admission import (DeadlineExceeded, Overloaded,
                                           Rejected, ReplicaFailed,
                                           Unavailable)
from ddw_tpu_torch.deploy.transport import transport_for
from ddw_tpu_torch.serve.engine import (GenerateResult, PredictResult,
                                        draw_step_seeds)
from ddw_tpu_torch.serve.metrics import EngineMetrics

__all__ = ["ProcessReplica"]

_HEALTH_CACHE_S = 0.2       # /stats polls under this age are coalesced

_UNSET = object()           # "keep the current draft" for set_checkpoint


def _wire_seeds(rng, num_steps: int, temperature: float):
    """The per-step seeds for the wire (``step_seeds``): drawn from the
    caller's generator here, in the parent, exactly as the in-thread
    engine would draw them (:func:`~ddw_tpu_torch.serve.engine.
    draw_step_seeds`), so the child samples the same tokens. ``None`` for
    greedy requests, which draw nothing."""
    if rng is None or temperature <= 0.0:
        return None
    return [int(k) for k in draw_step_seeds(rng, num_steps)]


def _error_to_exc(err: dict) -> Rejected:
    """Rebuild the structured refusal a child serialized (``to_dict``
    inverted) so pump retry classification survives the process hop."""
    kind = err.get("error")
    if kind == "overloaded":
        return Overloaded(err.get("kind", "interactive"),
                          err.get("capacity", 0), err.get("depth", 0),
                          err.get("retry_after_ms"))
    if kind == "quota_exceeded":
        from ddw_tpu_torch.serve.tenancy import QuotaExceeded
        return QuotaExceeded(err.get("tenant", "default"),
                             err.get("resource", "tokens"),
                             err.get("used", 0), err.get("quota", 0),
                             err.get("requested", 0),
                             err.get("retry_after_ms", 0.0))
    if kind == "deadline_exceeded":
        return DeadlineExceeded(err.get("kind", "interactive"),
                                err.get("waited_ms", 0.0),
                                err.get("timeout_ms", 0.0))
    if kind == "unavailable":
        return Unavailable(err.get("reason", "child"),
                           err.get("retry_after_ms"))
    return ReplicaFailed(err.get("kind", "child_error"),
                         replica=err.get("replica", 0),
                         generation=err.get("generation", 0),
                         phase=err.get("phase", "submitted"),
                         emitted=err.get("emitted", 0),
                         forensics=err.get("forensics"))


class ProcessReplica:
    """One ServingEngine in a child process, behind the EngineReplica
    duck type. ``engine_cfg`` is a plain dict of
    :class:`~ddw_tpu_torch.serve.EngineCfg` overrides (it crosses the process
    boundary as JSON)."""

    def __init__(self, model_dir: str, replica_id: int = 0,
                 engine_cfg: dict | None = None, host: str = "127.0.0.1",
                 workdir: str | None = None, grace_s: float = 10.0,
                 spawn_timeout_s: float = 180.0,
                 request_timeout_s: float = 120.0, max_workers: int = 16,
                 warmup_lens=(8,), draft_dir: str | None = None,
                 tp: int = 1, spawn_host: str | None = None,
                 transport=None, staging_root: str | None = None,
                 device: str | None = None):
        self.model_dir = model_dir
        self.draft_dir = draft_dir
        self.replica_id = replica_id
        self.generation = 0
        self.engine_cfg = dict(engine_cfg or {})
        # tensor parallelism: the child spans a tp-wide mesh slice. The
        # degree may arrive as the explicit kwarg or ride the engine_cfg
        # dict (it's an EngineCfg field); the kwarg wins when both are set.
        self.tp = int(tp if tp != 1 else self.engine_cfg.get("tp", 1))
        if self.tp > 1:
            raise NotImplementedError(
                f"tp {self.tp}: tensor-parallel serving is not yet ported "
                f"to ddw_tpu_torch; see ROADMAP.md item 12b")
        # the child's torch device: None = the CUDA card (the child exits
        # with its startup error without one), "cpu" only when asked for
        self.device = device
        self.warmup_lens = tuple(warmup_lens)
        self.host = host
        # spawn placement: the machine the child runs ON (the pluggable
        # transport seam — docs/serving.md "remote-host transport
        # contract"). Default stays this box with plain Popen semantics.
        self.spawn_host = spawn_host
        self.staging_root = staging_root
        if transport is None:
            transport = transport_for(spawn_host, staging_root=staging_root)
        elif isinstance(transport, str):
            transport = transport_for(
                None if transport == "local" else transport,
                staging_root=staging_root)
        self.transport = transport
        if getattr(transport, "remote", False):
            # remote child: it binds all interfaces on its own machine,
            # the parent connects to the spawn host
            self._bind_host = "0.0.0.0"
            if spawn_host and self.host in ("127.0.0.1", "localhost"):
                self.host = spawn_host
        else:
            self._bind_host = host
        self.grace_s = grace_s
        self.spawn_timeout_s = spawn_timeout_s
        self.request_timeout_s = request_timeout_s
        self.failure: ReplicaFailed | None = None
        self.on_failure = None               # set by ReplicaSet._wire
        self.metrics = EngineMetrics()       # parent-side placeholder; the
        #                                      child keeps the real numbers
        #                                      (its /stats), merged empty
        self.last_exit_code: int | None = None
        self._pending_checkpoint: str | None = None
        self._pending_draft: object = _UNSET
        self._workdir = workdir or tempfile.mkdtemp(
            prefix=f"ddw-replica{replica_id}-")
        self._proc: subprocess.Popen | None = None
        self._client: GatewayClient | None = None
        self._port: int | None = None
        self.max_workers = max_workers
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max_workers,
            thread_name_prefix=f"ddw-preplica{replica_id}")
        self._lock = threading.Lock()
        self._draining = threading.Event()
        self._stopping = threading.Event()   # expected exits: no on_failure
        self._ready = False
        self._service_ms = 50.0              # decaying estimate, parent-side
        self._health_cache: dict | None = None
        self._health_at = 0.0
        self._last_alive = time.monotonic()  # last proof the child answered
        # parent-side flight cache: the child's last trace events, kept
        # across the HTTP relay so a SIGKILLed child (which can dump
        # nothing itself) still leaves flight.<gen>.json behind
        self._trace_cache: list[dict] = []
        self._trace_seq = 0
        # telemetry relay: the child's sample seqs restart at 1 on respawn,
        # so the parent re-sequences every relayed sample onto its OWN
        # monotone counter (_telem_pseq survives respawns — the fleet
        # store's watermark never goes backwards for this slot) and keeps
        # a child-side watermark (_telem_child_seq, reset per spawn)
        self._telem_cache: list[dict] = []
        self._telem_pseq = 0
        self._telem_child_seq = 0

    # -- spawn plumbing ------------------------------------------------------
    def _port_file(self) -> str:
        return os.path.join(self._workdir,
                            f"port.gen{self.generation}.json")

    def _spawn(self) -> None:
        """Launch the child (non-blocking — it warms up while we return).
        The launcher's env discipline: inherited environ (``DDW_FAULT``
        rides along so ``serve:*:replica=N`` specs land in the child); the
        device travels as ``--device``, never through the environment."""
        env = dict(os.environ)
        port_file = self._port_file()
        try:
            os.unlink(port_file)
        except FileNotFoundError:
            pass
        # checkpoint staging: the weights must exist on the SPAWN host
        # before the child boots there. The transport returns the path
        # valid on that machine (identity on a local/shared filesystem,
        # a digest-keyed staged copy otherwise — idempotent per digest,
        # so respawns and same-checkpoint siblings reuse the copy).
        staged_model = self.transport.stage(self.model_dir)
        staged_draft = (self.transport.stage(self.draft_dir)
                        if self.draft_dir else None)
        cmd = [sys.executable, "-m", "ddw_tpu_torch.deploy._serve_worker",
               "--model-dir", staged_model,
               "--port-file", port_file,
               "--replica-id", str(self.replica_id),
               "--host", self._bind_host,
               "--grace-s", str(self.grace_s),
               "--warmup", json.dumps(list(self.warmup_lens))]
        if staged_draft:
            cmd += ["--draft-dir", staged_draft]
        if self.engine_cfg:
            cmd += ["--engine-cfg", json.dumps(self.engine_cfg)]
        if self.device is not None:
            cmd += ["--device", str(self.device)]
        # the child's intra-op threads: this process's (tests pin 1)
        cmd += ["--threads", str(torch.get_num_threads())]
        self._ready = False
        self._port = None
        if self._client is not None:
            self._client.close()
            self._client = None
        self._stopping.clear()
        self._draining.clear()
        self._last_alive = time.monotonic()
        self._health_cache, self._health_at = None, 0.0
        self._trace_cache, self._trace_seq = [], 0   # new child, new ring
        self._telem_child_seq = 0    # fresh child hub counts from 1 again
        self.log_path = os.path.join(self._workdir,
                                     f"child.gen{self.generation}.log")
        self._proc = self.transport.popen(cmd, env=env,
                                          log_path=self.log_path)
        threading.Thread(target=self._watch, args=(self._proc,),
                         name=f"ddw-preplica{self.replica_id}-watch",
                         daemon=True).start()

    def _watch(self, proc: subprocess.Popen) -> None:
        """Block on the child; an UNEXPECTED death becomes the one-shot
        ``on_failure`` that wakes the supervisor immediately (no poll lag),
        exactly like an in-thread engine loop crash."""
        code = proc.wait()
        with self._lock:
            if proc is not self._proc:        # superseded by a respawn
                return
            self.last_exit_code = code
            if self._stopping.is_set():
                return
            kind = ("engine_failed" if code == 13 else
                    "killed" if code < 0 else f"exit_{code}")
            forensics = {"exit_code": code, "pid": proc.pid}
            if self._trace_cache:
                # the flight recorder, parent-side: a reaped child dumped
                # nothing — attach the relayed ring's tail instead
                forensics["flight"] = list(self._trace_cache[-64:])
            failure = ReplicaFailed(
                kind, replica=self.replica_id, generation=self.generation,
                phase="process", forensics=forensics)
            self.failure = failure
            cb = self.on_failure
        if code < 0:
            self._dump_flight_cache()
        if cb is not None:
            try:
                cb(failure, [])     # nothing to salvage: in-flight HTTP
            except Exception:       # calls fail their own futures
                pass

    def _await_port(self, timeout_s: float) -> int:
        deadline = time.monotonic() + timeout_s
        port_file = self._port_file()
        while time.monotonic() < deadline:
            proc = self._proc
            if proc is None or proc.poll() is not None:
                raise RuntimeError(
                    f"replica {self.replica_id} child died during startup "
                    f"(exit {proc.poll() if proc else None})")
            try:
                # through the transport: a remote child's port file lives
                # on the spawn host, not this one
                return int(json.loads(
                    self.transport.read_file(port_file))["port"])
            except (OSError, ValueError, KeyError):
                time.sleep(0.02)
        raise RuntimeError(f"replica {self.replica_id} child never wrote "
                           f"its port file (waited {timeout_s:.0f}s)")

    def _ensure_client(self) -> GatewayClient:
        cli = self._client
        if cli is None:
            self._port = self._await_port(self.spawn_timeout_s)
            # max_retries=0: backpressure policy lives ABOVE this replica
            # (ReplicaSet spill, pump requeue) — the transport must report
            # a 429 as Overloaded, not eat it in a local sleep
            cli = GatewayClient(self.host, self._port,
                                timeout_s=self.request_timeout_s,
                                max_retries=0)
            self._client = cli
        return cli

    # -- EngineReplica lifecycle --------------------------------------------
    def start(self) -> "ProcessReplica":
        if self._proc is None or self._proc.poll() is not None:
            # A stopped replica is restartable: a NEW gateway life over the
            # same replica objects (the rollout reconciler's restart path)
            # calls start() after a previous life's drain shut the pool.
            if getattr(self._pool, "_shutdown", False):
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=self.max_workers,
                    thread_name_prefix=f"ddw-preplica{self.replica_id}")
            self.failure = None
            self._draining.clear()
            self._spawn()
        return self

    def warmup(self, prompt_lens=(8,)) -> None:
        """Wait out the child's own warmup: its ``/readyz`` flips only
        after the engine compiled every bucketed program — readiness
        gating by construction, observed through the load-balancer API."""
        cli = self._ensure_client()
        if not cli.wait_ready(self.spawn_timeout_s):
            raise RuntimeError(
                f"replica {self.replica_id} child (pid "
                f"{self._proc.pid if self._proc else '?'}) not ready after "
                f"{self.spawn_timeout_s:.0f}s")
        self._ready = True
        self._last_alive = time.monotonic()

    def stop(self) -> None:
        self._stopping.set()
        proc = self._proc
        if proc is not None and proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=self.grace_s + 5.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        if self._client is not None:
            self._client.close()
            self._client = None
        self._pool.shutdown(wait=False, cancel_futures=True)

    # -- supervision hooks ---------------------------------------------------
    def force_fail(self, kind: str = "stalled", reason: str = "") -> None:
        """The supervisor's stall hammer: SIGKILL, which — unlike the
        in-thread path — reclaims a replica wedged ANYWHERE, device work
        included."""
        proc = self._proc
        with self._lock:
            self._stopping.set()    # the watcher must not double-report
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        self._dump_flight_cache()   # the child can't — it just got SIGKILL
        with self._lock:
            self.last_exit_code = proc.poll() if proc else None
            forensics = {"reason": reason,
                         "exit_code": self.last_exit_code}
            if self._trace_cache:
                forensics["flight"] = list(self._trace_cache[-64:])
            self.failure = ReplicaFailed(
                kind, replica=self.replica_id, generation=self.generation,
                phase="process", forensics=forensics)
            failure, cb = self.failure, self.on_failure
        if cb is not None:
            try:
                cb(failure, [])
            except Exception:
                pass

    def restart(self) -> None:
        """Respawn — on the staged checkpoint when a deploy set one.
        Raises ``RuntimeError`` if the spawn itself fails, which sends the
        supervisor down its clone_fresh path."""
        proc = self._proc
        self._stopping.set()
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        self._apply_pending_checkpoint()
        self.failure = None
        self.generation += 1
        try:
            self._spawn()
        except OSError as e:
            raise RuntimeError(
                f"replica {self.replica_id} respawn failed: {e}") from e

    def clone_fresh(self) -> "ProcessReplica":
        """A replacement with this replica's identity and NEXT generation
        (the supervisor swaps it in via ``ReplicaSet.replace``)."""
        self._apply_pending_checkpoint()
        eng = ProcessReplica(self.model_dir, replica_id=self.replica_id,
                             engine_cfg=self.engine_cfg, host=self.host,
                             grace_s=self.grace_s,
                             spawn_timeout_s=self.spawn_timeout_s,
                             request_timeout_s=self.request_timeout_s,
                             warmup_lens=self.warmup_lens,
                             draft_dir=self.draft_dir, tp=self.tp,
                             spawn_host=self.spawn_host,
                             transport=self.transport,
                             staging_root=self.staging_root,
                             device=self.device)
        eng.generation = self.generation + 1
        eng.on_failure = self.on_failure
        return eng

    def recycle(self, drain_timeout_s: float = 30.0) -> bool:
        """Drain-then-restart, the rolling-deploy primitive: stop taking
        work, SIGTERM the child (its gateway drains in-flight requests to
        completion and exits 0), then respawn — on the staged checkpoint
        when one is pending. False = the drain did not complete in budget
        (caller escalates to force_fail, same contract as the in-thread
        engine)."""
        self._draining.set()
        proc = self._proc
        self._stopping.set()
        if proc is not None and proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=drain_timeout_s + self.grace_s)
            except subprocess.TimeoutExpired:
                return False
            if proc.returncode != 0:
                return False        # the drain crashed, not completed
        self.last_exit_code = proc.returncode if proc else None
        self._apply_pending_checkpoint()
        self.failure = None
        self.generation += 1
        self._spawn()
        return True

    # -- checkpoint hot-swap --------------------------------------------------
    @property
    def checkpoint_id(self) -> str | None:
        h = self.health()
        return h.get("checkpoint")

    def set_checkpoint(self, model_dir: str | None,
                       draft_dir=_UNSET) -> None:
        """Stage a weight swap: the NEXT restart/recycle spawns the child
        on this package (same contract as the in-thread engine).
        ``draft_dir`` stages the speculative-decode draft alongside it —
        omitted keeps the current draft, ``None`` drops it."""
        self._pending_checkpoint = model_dir
        self._pending_draft = _UNSET if model_dir is None else draft_dir

    def _apply_pending_checkpoint(self) -> None:
        model_dir, self._pending_checkpoint = self._pending_checkpoint, None
        draft_dir, self._pending_draft = self._pending_draft, _UNSET
        if model_dir is not None:
            self.model_dir = model_dir
            if draft_dir is not _UNSET:
                self.draft_dir = draft_dir

    # -- health / load -------------------------------------------------------
    def _poll_child(self) -> dict | None:
        """One cached /stats poll; None when the child can't answer."""
        now = time.monotonic()
        with self._lock:
            if (self._health_cache is not None
                    and now - self._health_at < _HEALTH_CACHE_S):
                return self._health_cache
        cli = self._client
        if cli is None or not self._ready:
            return None
        try:
            stats = cli.stats()
            h = (stats.get("replica_health") or [{}])[0]
        except Exception:
            return None
        with self._lock:
            self._health_cache, self._health_at = h, now
            self._last_alive = now
        return h

    def health(self) -> dict:
        proc = self._proc
        if self.failure is not None or proc is None \
                or (proc.poll() is not None and not self._stopping.is_set()):
            return {"state": "failed", "replica": self.replica_id,
                    "generation": self.generation, "running": False,
                    "last_tick_age_s": time.monotonic() - self._last_alive,
                    "consecutive_errors": 0, "queue_depth": 0,
                    "interactive_depth": 0, "batch_depth": 0,
                    "busy_slots": 0, "reserve_occupancy_pct": 0.0,
                    "draining": False, "checkpoint": None,
                    "process": {"pid": proc.pid if proc else None,
                                "exit_code": self.last_exit_code}}
        h = self._poll_child()
        if h is None:
            # starting (compile in flight) or wedged: a fresh heartbeat
            # while the handshake is young, a growing one after — the
            # supervisor's stall clock runs off this number
            age = 0.0 if not self._ready \
                else time.monotonic() - self._last_alive
            return {"state": "alive", "replica": self.replica_id,
                    "generation": self.generation, "running": True,
                    "last_tick_age_s": age, "consecutive_errors": 0,
                    "queue_depth": 0, "interactive_depth": 0,
                    "batch_depth": 0, "busy_slots": 0,
                    "reserve_occupancy_pct": 0.0,
                    "draining": self._draining.is_set(),
                    "checkpoint": None, "starting": not self._ready,
                    "process": {"pid": proc.pid}}
        h = dict(h)
        # parent-side identity wins: the fleet slot + respawn count, not
        # the child's own view (a child is always its replica 0, gen 0)
        h["replica"] = self.replica_id
        h["generation"] = self.generation
        h["last_tick_age_s"] = max(float(h.get("last_tick_age_s", 0.0)),
                                   time.monotonic() - self._last_alive
                                   - _HEALTH_CACHE_S)
        h["draining"] = h.get("draining", False) or self._draining.is_set()
        h["process"] = {"pid": proc.pid}
        h.pop("circuit", None)      # the PARENT's breaker owns this slot
        h.pop("restarts", None)
        h.pop("outstanding", None)
        return h

    def load(self) -> dict:
        h = self._health_cache if (self._health_cache is not None) else {}
        return {"depth": int(h.get("interactive_depth",
                                   h.get("queue_depth", 0))),
                "busy": int(h.get("busy_slots", 0)),
                "batch_depth": int(h.get("batch_depth", 0)),
                "service_ms": self._service_ms,
                "prefill_token_ms": float(
                    h.get("prefill_token_ms", 0.0) or 0.0),
                "free_block_frac": float(
                    h.get("free_block_frac", 1.0))}

    @property
    def role(self) -> str:
        """The child engine's serving role, known to the parent without a
        round trip — it rides the spawn's ``--engine-cfg`` JSON."""
        return str(self.engine_cfg.get("role", "both") or "both")

    @property
    def state(self) -> str:
        return self.health()["state"]

    # -- shadow probe ---------------------------------------------------------
    def probe(self, timeout_s: float = 30.0) -> None:
        """The supervisor's readmission gate: one real request against the
        child, off the routed path (the breaker is still open). Raises on
        any failure."""
        cli = self._ensure_client()
        res = cli.generate([1, 2, 3, 4], 1, temperature=0.0,
                           timeout_s=timeout_s)
        if not res.get("tokens"):
            raise RuntimeError(f"replica {self.replica_id} probe returned "
                               f"no tokens: {res}")

    # -- fleet prefix-index feed ----------------------------------------------
    def prefix_events(self, since: int = 0) -> dict:
        """The fleet prefix index's per-replica feed, relayed from the
        child in one HTTP delta fetch (``GET /v1/prefix/events`` on the
        child's own gateway). An unreachable, dead, or still-compiling
        child answers a no-op delta — the index just stays stale for this
        slot until the next poll. A respawned child's sequence restarts at
        zero, which trips the feed's reset protocol and replaces whatever
        the index believed about this slot."""
        cli = self._client
        if cli is None or not self._ready or self.failure is not None:
            return {"seq": int(since), "reset": False, "events": []}
        try:
            return cli._json_call(
                "GET", f"/v1/prefix/events?since={int(since)}&replica=0")
        except Exception:
            return {"seq": int(since), "reset": False, "events": []}

    # -- KV migration relay ---------------------------------------------------
    def kv_export(self, prompt, skip_hashes=()):
        """Relay of :meth:`~ddw_tpu_torch.serve.ServingEngine.kv_export`
        (``POST /v1/kv/export`` on the child's own gateway). Raises on an
        unreachable child — the router's handoff fallback owns the retry
        story; a silent ``None`` here would masquerade as "nothing
        cached"."""
        cli = self._ensure_client()
        out = cli._json_call("POST", "/v1/kv/export", {
            "replica": 0,
            "prompt": [int(t) for t in np.asarray(prompt).reshape(-1)],
            "skip": [str(h) for h in skip_hashes]})
        return out.get("wire")

    def kv_import(self, wire) -> dict:
        """Relay of :meth:`~ddw_tpu_torch.serve.ServingEngine.kv_import`
        (``POST /v1/kv/import``); the child rejects a malformed wire
        before touching its pool, which surfaces here as a
        :class:`~ddw_tpu_torch.gateway.client.GatewayError`."""
        cli = self._ensure_client()
        return cli._json_call("POST", "/v1/kv/import",
                              {"replica": 0, "wire": wire})

    # -- adapter staging relay ------------------------------------------------
    def load_adapter(self, adapter_id: str, adapter=None, *,
                     path: str | None = None, alpha: float = 16.0,
                     rank: int | None = None,
                     digest: str | None = None) -> dict:
        """Relay of :meth:`~ddw_tpu_torch.serve.ServingEngine.load_adapter`
        (``POST /admin/adapters`` on the child's own gateway). Adapters
        cross the process boundary as FILES only — the same shared-disk
        contract checkpoints use — so ``adapter`` arrays are refused
        here. Raises on any child-side failure (the parent gateway's
        staged load rolls back on it)."""
        if adapter is not None:
            raise ValueError("a process replica stages adapters by path "
                             "only (save_adapter to shared disk first)")
        if not path:
            raise ValueError("load_adapter on a process replica needs "
                             "path=")
        cli = self._ensure_client()
        out = cli.adapters(op="load", adapter_id=adapter_id, path=path,
                           alpha=alpha, rank=rank, digest=digest)
        if out.get("status") != "loaded":
            raise RuntimeError(f"child adapter load failed: {out}")
        return {"adapter_id": adapter_id, "slot": None,
                "digest": out.get("digest")}

    def unload_adapter(self, adapter_id: str) -> dict:
        cli = self._ensure_client()
        out = cli.adapters(op="unload", adapter_id=adapter_id)
        if out.get("status") != "unloaded":
            raise RuntimeError(f"child adapter unload failed: {out}")
        return out

    def adapter_view(self) -> dict:
        """The child engine's adapter-pool view (empty when the child has
        no pool or is unreachable) — feeds the parent's fleet view."""
        cli = self._client
        if cli is None or not self._ready or self.failure is not None:
            return {}
        try:
            view = cli.adapters(op="list")
        except Exception:
            return {}
        reps = view.get("replicas") or {}
        return reps.get("0", {})

    # -- trace relay (the fleet's merged Perfetto view) -----------------------
    def trace_events(self, since: int = 0) -> dict:
        """The child engine's trace ring, relayed in one HTTP fetch
        (``GET /v1/trace?replica=0`` on the child's own gateway) — the
        same duck-type as :meth:`~ddw_tpu_torch.serve.ServingEngine.
        trace_events`, so the parent gateway's ``/v1/trace`` merge sees
        process replicas like in-thread ones. Every relay refreshes the
        parent-side flight cache; a dead or unreachable child answers its
        CACHED tail (``since=0`` only) so the merged trace still shows a
        killed replica's last moments."""
        cli = self._client
        if cli is None or not self._ready or self.failure is not None \
                or self._proc is None or self._proc.poll() is not None:
            with self._lock:
                cached = list(self._trace_cache) if since == 0 else []
            return {"replica": self.replica_id,
                    "generation": self.generation, "dropped": 0,
                    "cached": True, "events": cached}
        try:
            d = cli.trace(replica=0, since=int(since))
        except Exception:
            with self._lock:
                cached = list(self._trace_cache) if since == 0 else []
            return {"replica": self.replica_id,
                    "generation": self.generation, "dropped": 0,
                    "cached": True, "events": cached}
        d["replica"] = self.replica_id       # parent-side identity wins
        d["generation"] = self.generation
        evs = d.get("events", [])
        if evs:
            with self._lock:
                fresh = [e for e in evs
                         if e.get("seq", 0) > self._trace_seq]
                if fresh:
                    self._trace_cache.extend(fresh)
                    self._trace_seq = max(e.get("seq", 0) for e in fresh)
                    del self._trace_cache[:-256]
        return d

    # -- telemetry relay (the fleet's merged windowed series) -----------------
    def telemetry_events(self, since: int = 0) -> dict:
        """The child engine's telemetry ring, relayed in one HTTP fetch
        (``GET /v1/telemetry?replica=0`` on the child's own gateway) —
        the same duck-type as :meth:`~ddw_tpu_torch.serve.ServingEngine.
        telemetry_events`, so the parent gateway's fleet merge sees
        process replicas like in-thread ones. Relayed samples are
        RE-SEQUENCED onto the parent's own monotone counter: a respawned
        child's hub restarts at seq 1, but this slot's feed never goes
        backwards, so the fleet store's watermark protocol just works.
        A dead or unreachable child answers the cached tail — its series
        freezes mid-window instead of vanishing."""
        cli = self._client
        alive = (cli is not None and self._ready and self.failure is None
                 and self._proc is not None and self._proc.poll() is None)
        if alive:
            try:
                d = cli.telemetry(replica=0, since=self._telem_child_seq)
            except Exception:
                alive = False
            else:
                samples = d.get("samples", [])
                with self._lock:
                    if samples:
                        self._telem_child_seq = max(
                            self._telem_child_seq,
                            int(d.get("last_seq", 0) or 0),
                            max(s.get("seq", 0) for s in samples))
                        for s in samples:
                            self._telem_pseq += 1
                            s = dict(s)
                            s["seq"] = self._telem_pseq
                            self._telem_cache.append(s)
                        del self._telem_cache[:-4096]
        with self._lock:
            out = [s for s in self._telem_cache
                   if s.get("seq", 0) > int(since)]
            last = self._telem_pseq
        return {"source": f"replica{self.replica_id}",
                "replica": self.replica_id, "generation": self.generation,
                "dropped": 0, "cached": not alive, "samples": out,
                "last_seq": last if out else int(since)}

    def _dump_flight_cache(self) -> None:
        """Write the parent-side trace cache as ``flight.gen<N>.json`` in
        the workdir — the flight recorder for children that died without
        the chance to dump their own (SIGKILL). Best-effort."""
        with self._lock:
            events = list(self._trace_cache)
        if not events:
            return
        path = os.path.join(self._workdir,
                            f"flight.gen{self.generation}.json")
        try:
            with open(path, "w") as f:
                json.dump({"process": f"replica{self.replica_id}",
                           "source": "parent_cache", "dropped": 0,
                           "events": events}, f)
        except OSError:
            pass

    # -- submission -----------------------------------------------------------
    def _admission_gate(self, kind: str) -> None:
        """Synchronous refusals, matching the in-thread engine's contract:
        a failed replica raises ReplicaFailed AT SUBMIT (the ReplicaSet
        records it and walks on), a draining or still-compiling one
        raises Overloaded (spill to a sibling, don't punish the breaker)."""
        if self.failure is not None:
            raise ReplicaFailed(self.failure.kind, replica=self.replica_id,
                                generation=self.generation, phase="queued",
                                forensics=self.failure.forensics)
        proc = self._proc
        if proc is None or proc.poll() is not None:
            raise ReplicaFailed("process_dead", replica=self.replica_id,
                                generation=self.generation, phase="queued")
        if self._draining.is_set():
            raise Overloaded(kind, 0, 0, retry_after_ms=250.0)
        if not self._ready:
            raise Overloaded(kind, 0, 0, retry_after_ms=500.0)

    def _note_service(self, total_ms: float) -> None:
        self._service_ms += 0.2 * (total_ms - self._service_ms)

    def _map_exc(self, e: Exception) -> Rejected:
        if isinstance(e, GatewayOverloaded):
            return _error_to_exc(e.body)
        if isinstance(e, GatewayDeadline):
            return _error_to_exc(e.body)
        if isinstance(e, GatewayUnavailable):
            body = e.body if isinstance(e.body, dict) else {}
            if body.get("error") in ("replica_failed", "unavailable"):
                exc = _error_to_exc(body)
                if isinstance(exc, ReplicaFailed):
                    exc.replica = self.replica_id
                    exc.generation = self.generation
                return exc
            return Unavailable(body.get("state", "child_unavailable"))
        if isinstance(e, GatewayError) \
                and isinstance(getattr(e, "body", None), dict) \
                and e.body.get("error") == "unknown_adapter":
            # the child refused the adapter id — a client error, not a
            # replica death: surface the same exception the in-thread
            # engine raises so the gateway's 400 mapping fires
            from ddw_tpu_torch.serve.adapters import UnknownAdapter
            return UnknownAdapter(e.body.get("adapter_id", "?"),
                                  tuple(e.body.get("loaded", ())))
        if isinstance(e, (OSError, GatewayError)):
            return ReplicaFailed(
                "transport", replica=self.replica_id,
                generation=self.generation, phase="submitted",
                forensics={"exc": repr(e)})
        return ReplicaFailed("child_error", replica=self.replica_id,
                             generation=self.generation,
                             forensics={"exc": repr(e)})

    def submit_generate(self, prompt, num_steps: int,
                        temperature: float = 0.0, rng=None,
                        timeout_s: float = 0.0, on_token=None,
                        trace_id: str | None = None,
                        parent_span: str | None = None,
                        tenant: str | None = None,
                        adapter_id: str | None = None
                        ) -> concurrent.futures.Future:
        self._admission_gate("interactive")
        cli = self._ensure_client()
        step_seeds = _wire_seeds(rng, num_steps, temperature)
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]

        def call():
            t0 = time.monotonic()
            try:
                res = cli.generate(prompt, num_steps,
                                   temperature=temperature,
                                   step_seeds=step_seeds,
                                   timeout_s=timeout_s or None,
                                   stream=on_token is not None,
                                   on_token=on_token,
                                   trace_id=trace_id,
                                   parent_span=parent_span,
                                   tenant=tenant,
                                   adapter_id=adapter_id)
            except Exception as e:
                raise self._map_exc(e) from e
            self._note_service(res.get("total_ms",
                                       (time.monotonic() - t0) * 1e3))
            return GenerateResult(
                tokens=np.asarray(res["tokens"], dtype=np.int32),
                queue_ms=float(res.get("queue_ms", 0.0)),
                ttft_ms=float(res.get("ttft_ms", 0.0)),
                total_ms=float(res.get("total_ms", 0.0)),
                tokens_per_sec=float(res.get("tokens_per_sec", 0.0)))

        return self._pool.submit(call)

    def submit_predict(self, item, timeout_s: float = 0.0
                       ) -> concurrent.futures.Future:
        self._admission_gate("image")
        cli = self._ensure_client()
        payload = np.asarray(item).tolist()

        def call():
            t0 = time.monotonic()
            try:
                res = cli.predict(payload, timeout_s=timeout_s or None,
                                  return_logits=True)
            except Exception as e:
                raise self._map_exc(e) from e
            self._note_service(res.get("total_ms",
                                       (time.monotonic() - t0) * 1e3))
            return PredictResult(
                logits=np.asarray(res.get("logits", []), dtype=np.float32),
                label=res.get("label", ""),
                index=int(res.get("index", -1)),
                queue_ms=float(res.get("queue_ms", 0.0)),
                total_ms=float(res.get("total_ms", 0.0)))

        return self._pool.submit(call)

    # -- batch lane -----------------------------------------------------------
    def submit_batch_item(self, prompt, num_steps: int,
                          temperature: float = 0.0, rng=None,
                          timeout_s: float = 0.0
                          ) -> concurrent.futures.Future:
        futs = self.submit_batch_items(
            [np.asarray(prompt).reshape(-1)], [0], kind="generate",
            num_steps=num_steps, temperature=temperature,
            step_seeds=([_wire_seeds(rng, num_steps, temperature)]
                        if rng is not None and temperature > 0.0
                        else None),
            timeout_s=timeout_s)
        return futs[0]

    def submit_batch_predict(self, item, timeout_s: float = 0.0
                             ) -> concurrent.futures.Future:
        futs = self.submit_batch_items([np.asarray(item)], [0],
                                       kind="predict", timeout_s=timeout_s)
        return futs[0]

    def submit_batch_items(self, items, indices, kind: str = "generate",
                           num_steps: int | None = None,
                           temperature: float = 0.0,
                           seed: int | None = None, step_seeds=None,
                           timeout_s: float = 0.0
                           ) -> list[concurrent.futures.Future]:
        """Grouped batch-lane submission: the WHOLE group crosses the wire
        in one ``POST /v1/batch/items`` and fans back out into one future
        per item, each resolving to the engine-result type or raising the
        item's own structured refusal — so a single refused item requeues
        alone while its groupmates land."""
        self._admission_gate("lm_batch" if kind == "generate"
                             else "image_batch")
        cli = self._ensure_client()
        items = [np.asarray(x).tolist() for x in items]
        indices = [int(i) for i in indices]
        futs: list[concurrent.futures.Future] = [
            concurrent.futures.Future() for _ in items]
        for f in futs:
            f.set_running_or_notify_cancel()

        def call():
            try:
                body: dict = {"kind": kind, "items": items,
                              "indices": indices,
                              "temperature": temperature}
                if num_steps is not None:
                    body["num_steps"] = num_steps
                if seed is not None:
                    body["seed"] = seed
                if step_seeds is not None:
                    body["step_seeds"] = step_seeds
                if timeout_s:
                    body["timeout_s"] = timeout_s
                rows = cli._json_call("POST", "/v1/batch/items",
                                      body)["rows"]
            except Exception as e:
                exc = self._map_exc(e)
                for f in futs:
                    f.set_exception(exc)
                return
            by_index = {r["index"]: r for r in rows}
            for pos, idx in enumerate(indices):
                row = by_index.get(idx)
                if row is None:
                    futs[pos].set_exception(ReplicaFailed(
                        "row_missing", replica=self.replica_id,
                        generation=self.generation))
                elif not row.get("ok"):
                    futs[pos].set_exception(_error_to_exc(
                        row.get("error", {})))
                elif kind == "generate":
                    futs[pos].set_result(GenerateResult(
                        tokens=np.asarray(row["row"]["tokens"],
                                          dtype=np.int32),
                        queue_ms=0.0, ttft_ms=0.0, total_ms=0.0,
                        tokens_per_sec=0.0))
                else:
                    futs[pos].set_result(PredictResult(
                        logits=np.asarray(row["row"].get("logits", []),
                                          dtype=np.float32),
                        label=row["row"].get("label", ""),
                        index=int(row["row"].get("class_index", -1)),
                        queue_ms=0.0, total_ms=0.0))

        self._pool.submit(call)
        return futs
