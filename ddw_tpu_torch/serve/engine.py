"""Online serving engine — the port of ``ddw_tpu.serve.engine``: request
queue, dynamic batching, continuous batching over a KV pool.

An in-process engine that admits concurrent image and LM requests and keeps
the card busy:

- **LM**: continuous batching over a paged
  :class:`~ddw_tpu_torch.serve.blocks.BlockPool` (the default — fixed-size
  KV blocks, per-stream block tables, prefix reuse with copy-on-write;
  admission counts free BLOCKS) or the contiguous
  :class:`~ddw_tpu_torch.serve.slots.SlotPool` baseline
  (``EngineCfg(paged=False)``). New requests prefill the moment capacity
  exists (bucketed prompt/suffix lengths, grouped per bucket); every tick
  advances all active streams ``steps_per_tick`` tokens; finished
  sequences leave without stalling their neighbours. Greedy outputs are
  the tokens of sequential ``generate`` for any admission interleaving.
- **image**: dynamic batching — requests coalesce until ``max_batch`` are
  waiting or the oldest has waited ``max_wait_ms``, the batch pads to a
  power-of-two bucket, and the packaged model's forward serves it (with
  ``dw_impl="pallas"`` every stride-1 depthwise layer launches K1).
- **admission** (:mod:`ddw_tpu_torch.serve.admission`): bounded queues
  refuse over-capacity submissions with ``Overloaded``; deadline-expired
  requests are shed before any device work.
- **lanes**: a throughput-SLO batch lane (``submit_batch_item``,
  ``submit_batch_predict``) backfills idle blocks behind an
  interactive-reserve watermark; interactive traffic wins admission and
  batch streams are preempted first.
- **metrics** (:mod:`ddw_tpu_torch.serve.metrics`): queue time, TTFT,
  tokens/s and latency tails, exported into a tracker run.

Failure containment is ``ddw_tpu``'s: a recoverable error in one tick fails
the requests that tick touched with a structured
:class:`~ddw_tpu_torch.serve.admission.ReplicaFailed`, resets the pool and
leaves the engine ``degraded``; ``max_consecutive_errors`` in a row (or
:meth:`ServingEngine.force_fail`) make it ``failed``, every future resolving
with ``ReplicaFailed`` (never a hang) and later submissions refused.
:meth:`~ServingEngine.restart`, :meth:`~ServingEngine.recycle` and
:meth:`~ServingEngine.clone_fresh` bring it back.

The loop is a background thread: it enters ``torch.no_grad()`` itself
(grad mode is thread-local), and its device work runs on that thread's
current stream. Not yet ported, each refused at construction or call with
an error naming ``ROADMAP.md``: the speculative tick (``spec_k``,
``draft=``), adapters, tenants, tracing and telemetry, tensor parallelism,
the disaggregation roles, ``DDW_FAULT`` serve faults, ``submit_batch``
(bulk jobs) and the system monitor.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import threading
import time
import traceback
import warnings

import numpy as np
import torch

from ddw_tpu_torch.serve.admission import (AdmissionController,
                                           DeadlineExceeded, Overloaded,
                                           ReplicaFailed)
from ddw_tpu_torch.serve.blocks import BlockPool, OutOfBlocks
from ddw_tpu_torch.serve.bucketing import (batch_bucket, bucket_len,
                                           pad_to_bucket)
from ddw_tpu_torch.serve.metrics import EngineMetrics, RequestRecord
from ddw_tpu_torch.serve.slots import SlotPool

__all__ = ["EngineCfg", "ServingEngine", "GenerateResult", "PredictResult",
           "Overloaded", "DeadlineExceeded", "ReplicaFailed"]

# Replica health states (ServingEngine.state / health()["state"])
ALIVE = "alive"          # loop running, last operation clean
DEGRADED = "degraded"    # loop running, but the consecutive-error count > 0
FAILED = "failed"        # terminal: loop dead, futures failed, submissions
#                          refused — restart()/clone_fresh() to recover
STOPPED = "stopped"      # clean stop()

_UNSET = object()        # set_checkpoint(draft_dir=...) sentinel


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to ddw_tpu_torch; "
                               f"see ROADMAP.md for the slice that brings it")


class ServeCrash(RuntimeError):
    """A terminal engine-loop failure (the error budget spent, or a
    forced failure): the loop dies and the replica turns ``failed``."""


@dataclasses.dataclass
class EngineCfg:
    """Batching / admission policy knobs (every field of ``ddw_tpu``'s,
    with its default; the fields of unported features are refused by
    :class:`ServingEngine` when set)."""

    n_slots: int = 8            # concurrent LM sequences on device
    steps_per_tick: int = 4     # decode chain length per tick
    max_batch: int = 8          # image dynamic-batch cap
    max_wait_ms: float = 2.0    # image batch formation window
    queue_depth: int = 64       # bounded admission queue per request kind
    default_timeout_s: float = 30.0
    min_bucket: int = 8         # smallest prompt-length bucket
    donate: bool = True         # ddw_tpu donates the pool cache through
    #                             decode ticks; the port updates it in place
    max_consecutive_errors: int = 3   # recoverable loop errors in a row
    #                                   before the replica turns FAILED
    # paged KV cache (serve/blocks.py BlockPool) — the default pool;
    # paged=False serves through the contiguous slot pool (the baseline)
    paged: bool = True
    kv_block_size: int = 16     # tokens per KV block; shrunk (with a
    #                             warning) to the largest divisor of the
    #                             attention tile not above it
    kv_cache_blocks: int = 0    # usable blocks; 0 = EQUAL KV MEMORY to the
    #                             slot baseline (n_slots * cap / block_size)
    max_resident: int = 0       # decode-batch rows; 0 = 2 * n_slots
    decode_buckets: bool = True  # shrink each decode tick to the smallest
    #                             pow2 row bucket covering live rows
    block_overcommit: float = 1.0  # >1 oversubscribes the block budget and
    #                             relies on mid-decode preemption
    # dual-lane scheduler: a throughput-SLO batch lane backfills idle
    # blocks BEHIND an interactive reserve
    batch_queue_depth: int = 256   # bounded batch-lane queue per kind
    interactive_reserve_blocks: int = -1  # KV blocks held back from batch
    #                             admission; -1 = auto (n_blocks // 4)
    batch_rows_headroom: int = 1   # resident ROWS a fresh batch admission
    #                             must leave free for interactive arrivals
    spec_k: int = 0             # speculative tick (not ported: refused)
    trace: bool = False         # request tracing (not ported: refused)
    trace_capacity: int = 8192
    telemetry: bool = False     # live telemetry (not ported: refused)
    telemetry_interval_s: float = 0.25
    telemetry_capacity: int = 4096
    tp: int = 1                 # tensor parallelism (not ported: refused)
    adapter_slots: int = 0      # LoRA adapter pool (not ported: refused)
    adapter_rank: int = 8
    adapter_targets: tuple = ()
    tenants: tuple = ()         # per-tenant QoS (not ported: refused)
    role: str = "both"          # prefill/decode disaggregation (only
    #                             "both" is ported)

    def __post_init__(self):
        if self.role not in ("prefill", "decode", "both"):
            raise ValueError(
                f"role must be 'prefill', 'decode', or 'both', got "
                f"{self.role!r}")
        if self.role != "both" and not self.paged:
            raise ValueError(
                f"role {self.role!r} requires the paged pool "
                f"(paged=True): KV block migration is defined over the "
                f"BlockPool's chain-hashed blocks only")
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {self.tp}")
        if self.tp > 1 and not self.paged:
            raise ValueError(
                f"tp {self.tp} requires the paged pool (paged=True): only "
                f"the BlockPool programs compile under a mesh — the "
                f"contiguous slot pool is single-device")
        if self.adapter_slots < 0:
            raise ValueError(f"adapter_slots must be >= 0, got "
                             f"{self.adapter_slots}")
        if self.adapter_slots and not self.paged:
            raise ValueError(
                f"adapter_slots {self.adapter_slots} requires the paged "
                f"pool (paged=True): per-row adapter gathers are defined "
                f"over the BlockPool programs only")
        if self.adapter_slots and self.adapter_rank < 1:
            raise ValueError(f"adapter_rank must be >= 1 with adapters "
                             f"on, got {self.adapter_rank}")


@dataclasses.dataclass
class GenerateResult:
    """Completed LM request: tokens + its own SLO numbers."""

    tokens: np.ndarray          # [num_steps] int32
    queue_ms: float
    ttft_ms: float
    total_ms: float
    tokens_per_sec: float


@dataclasses.dataclass
class PredictResult:
    """Completed image request."""

    logits: np.ndarray          # [num_classes] f32
    label: str
    index: int
    queue_ms: float
    total_ms: float


class _Times:
    __slots__ = ("submitted", "admitted", "first_output", "done")

    def __init__(self, submitted: float):
        self.submitted = submitted
        self.admitted = self.first_output = self.done = submitted


class _LMRequest:
    __slots__ = ("prompt", "num_steps", "temperature", "keys", "deadline",
                 "future", "times", "tokens", "emitted", "on_token",
                 "claimed", "lane", "trace_id", "ticks", "tenant")

    def __init__(self, prompt, num_steps, temperature, keys, deadline, now,
                 on_token=None, lane="interactive", trace_id=None,
                 tenant=None):
        self.prompt = prompt
        self.num_steps = num_steps
        self.temperature = temperature
        self.keys = keys            # [num_steps] int64 step seeds or None
        self.deadline = deadline
        self.future = concurrent.futures.Future()
        self.times = _Times(now)
        self.tokens: list[int] = []
        self.emitted = 0
        self.on_token = on_token    # (index, token) -> None, engine thread
        self.claimed = False        # future transitioned to RUNNING (set
        #                             once; a preempted-and-requeued request
        #                             must not re-claim)
        self.lane = lane            # "interactive" | "batch"
        self.trace_id = trace_id    # joins the request's jsonl row
        self.ticks = 0              # decode ticks this request rode
        self.tenant = tenant        # attribution label; None = untagged

    def effective_prompt(self) -> np.ndarray:
        """The prompt a (re-)prefill must run: the original tokens plus
        everything already picked EXCEPT the newest pick — that one is
        re-derived from the prefill logits with its original step key, so a
        preempted stream resumes token for token without re-emitting
        (vLLM-style recompute preemption)."""
        if not self.emitted:
            return self.prompt
        return np.concatenate([
            self.prompt,
            np.asarray(self.tokens[:self.emitted - 1], np.int32)])

    def pick_key(self) -> int:
        """Sample key for the prefill-time pick: step 0 for a fresh
        request, the resumed step's own key after a preemption."""
        if self.keys is None:
            return 0
        return int(self.keys[max(self.emitted - 1, 0)])

    def emit(self, start: int) -> None:
        """Stream tokens[start:] to the callback; a broken callback stops
        its own stream but never the engine loop or the future."""
        if self.on_token is None:
            return
        try:
            for i in range(start, len(self.tokens[:self.num_steps])):
                self.on_token(i, self.tokens[i])
        except Exception:
            self.on_token = None


class _ImageRequest:
    __slots__ = ("image", "deadline", "future", "times", "claimed", "lane")

    def __init__(self, image, deadline, now, lane="interactive"):
        self.image = image
        self.deadline = deadline
        self.future = concurrent.futures.Future()
        self.times = _Times(now)
        self.claimed = False
        self.lane = lane


def _handle(obj):
    return obj.engine_handle() if hasattr(obj, "engine_handle") else obj


class ServingEngine:
    """In-process online inference engine over packaged models.

    ``lm`` / ``image`` accept a packaged model (anything with an
    ``engine_handle()``: :class:`~ddw_tpu_torch.serving.lm_package.
    LMPackagedModel`, :class:`~ddw_tpu_torch.serving.package.PackagedModel`)
    or the handle itself; at least one is required. The engine runs where
    the packages live (the card unless they were loaded with
    ``device="cpu"``). With ``run`` set, per-request rows stream to the
    run's ``serving/serve_requests.jsonl`` and SLO metrics land in the
    tracker on :meth:`stop`.
    """

    def __init__(self, lm=None, image=None, cfg: EngineCfg | None = None,
                 run=None, monitor_interval_s: float = 0.0,
                 replica_id: int = 0, draft=None, mesh=None):
        if lm is None and image is None:
            raise ValueError("engine needs an lm and/or image model")
        self.cfg = cfg or EngineCfg()
        self._refuse_unported(draft, mesh, monitor_interval_s)
        self.run = run
        self.metrics = EngineMetrics()
        per_kind = {"lm_batch": self.cfg.batch_queue_depth,
                    "image_batch": self.cfg.batch_queue_depth}
        self._ctrl = AdmissionController(self.cfg.queue_depth,
                                         per_kind=per_kind)
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._service_ms = 0.0      # decaying per-request service estimate
        self._per_token_ms = 0.0    # decaying per-generated-token estimate
        #                             (the paged pool's retry_after_ms hint)
        self._prefill_token_ms = 0.0  # decaying per-PREFILLED-token estimate

        # failure containment (ReplicaFailed semantics in the module doc)
        self.replica_id = replica_id
        self.generation = 0         # bumped by every restart()
        self.on_failure = None      # (ReplicaFailed, [(kind, req), ...]) ->
        #                             None; salvageable queued requests are
        #                             handed over instead of failed
        self._failure: ReplicaFailed | None = None
        self._fail_lock = threading.Lock()
        self._consecutive_errors = 0
        self._draining = threading.Event()   # recycle(): admission paused,
        #                                      in-slot work runs to completion
        self._stopped = False
        self._last_tick = time.monotonic()
        self._inflight_admit: list = []      # claimed reqs mid-device-work
        self._pool_ops: list = []            # (fn, future) control ops the
        #                                      loop runs between ticks

        self.model_dir: str | None = None    # package dir behind _lm
        self._pending_checkpoint: str | None = None   # applied at restart()
        self._init_lm(lm)
        self._pool_stats_seen: dict[str, int] = {}

        self._image = _handle(image)
        if self._image is not None:
            self._image_apply = self._image.apply

    def _refuse_unported(self, draft, mesh, monitor_interval_s) -> None:
        """Every feature of ``ddw_tpu``'s engine this port lacks raises
        here, at construction, naming ``ROADMAP.md`` — never ignored."""
        c = self.cfg
        if c.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {c.spec_k}")
        if c.spec_k > 0 or draft is not None:
            raise _not_ported("the engine's speculative tick (spec_k > 0, "
                              "draft=)")
        if c.adapter_slots > 0:
            raise _not_ported("the LoRA adapter pool (adapter_slots > 0)")
        if c.tenants:
            raise _not_ported("per-tenant QoS (EngineCfg.tenants)")
        if c.trace:
            raise _not_ported("request tracing (EngineCfg.trace)")
        if c.telemetry:
            raise _not_ported("live telemetry (EngineCfg.telemetry)")
        if c.tp > 1 or mesh is not None:
            raise _not_ported("tensor-parallel serving (tp > 1, mesh=)")
        if c.role != "both":
            raise _not_ported(f"the disaggregated {c.role!r} role "
                              f"(the gateway's prefill/decode split)")
        if monitor_interval_s > 0:
            raise _not_ported("the system monitor (utils/sysmon, "
                              "monitor_interval_s > 0)")
        fault = os.environ.get("DDW_FAULT", "")
        if any(spec.strip().startswith("serve:")
               for spec in fault.split(";")):
            raise _not_ported(f"serving fault injection (DDW_FAULT="
                              f"{fault!r}, runtime/faults)")

    @property
    def device(self) -> torch.device:
        h = self._lm if self._lm is not None else self._image
        return h.device

    def _init_lm(self, lm) -> None:
        """Build (or rebuild) the LM handle + KV pool. Called at
        construction and by :meth:`restart` when a staged checkpoint
        (:meth:`set_checkpoint`) replaces the weights."""
        self._lm = _handle(lm)
        if self._lm is None:
            self.pool = None
            return
        if self.cfg.paged:
            self.pool = self._build_block_pool(self._lm)
            n = self.pool.max_resident
        else:
            self.pool = SlotPool(self._lm.model, self.cfg.n_slots,
                                 steps_per_tick=self.cfg.steps_per_tick)
            n = self.cfg.n_slots
        self._n_rows = n
        self._slot_req: dict[int, _LMRequest] = {}
        self._cur = np.zeros((n,), np.int32)
        self._temps = np.zeros((n,), np.float32)

    def _build_block_pool(self, handle) -> BlockPool:
        """One paged pool over ``handle`` with the engine's geometry knobs
        (block size shrinks to the model's own tile divisor; block count
        defaults to equal-KV-memory with the slot baseline)."""
        model = handle.model
        tile = min(256, model.max_len)
        cap = -(-model.max_len // tile) * tile
        block_size = self.cfg.kv_block_size
        if block_size < 1 or tile % block_size:
            block_size = max(
                d for d in range(1, min(max(block_size, 1), tile) + 1)
                if tile % d == 0)
            warnings.warn(
                f"kv_block_size {self.cfg.kv_block_size} does not "
                f"divide the attention tile {tile} (= min(256, "
                f"max_len {model.max_len})); using {block_size}",
                RuntimeWarning, stacklevel=3)
        n_blocks = self.cfg.kv_cache_blocks or (
            self.cfg.n_slots * cap // block_size)
        n = self.cfg.max_resident or 2 * self.cfg.n_slots
        reserve = self.cfg.interactive_reserve_blocks
        if reserve < 0:
            reserve = n_blocks // 4   # auto: a quarter of the pool
        return BlockPool(
            model, n_blocks=n_blocks, block_size=block_size, max_resident=n,
            steps_per_tick=self.cfg.steps_per_tick,
            overcommit=self.cfg.block_overcommit,
            interactive_reserve=reserve,
            decode_buckets=self.cfg.decode_buckets)

    # -- checkpoint hot-swap --------------------------------------------------
    @property
    def checkpoint_id(self) -> str | None:
        """Content digest of the serving LM package, when known."""
        digest = getattr(self._lm, "content_digest", None)
        return digest or None

    def set_checkpoint(self, model_dir: str | None,
                       draft_dir: object = _UNSET) -> None:
        """Stage a weight swap of the target: the NEXT :meth:`restart` (so
        also :meth:`recycle`) loads the LM package at ``model_dir`` onto
        the engine's device and rebuilds the pool over it; in-slot work
        keeps decoding against the current weights until then. ``None``
        clears a staged swap. A draft swap (``draft_dir``) belongs to the
        speculative tick, which is not ported."""
        if draft_dir is not _UNSET:
            raise _not_ported("a speculative draft swap (draft_dir=)")
        self._pending_checkpoint = model_dir

    def _apply_pending_checkpoint(self) -> None:
        model_dir, self._pending_checkpoint = self._pending_checkpoint, None
        if model_dir is None:
            return
        from ddw_tpu_torch.serving.lm_package import LMPackagedModel

        self._init_lm(LMPackagedModel(model_dir, device=self.device))
        self.model_dir = model_dir

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ServingEngine":
        if self._thread is None:
            self._stop.clear()
            self._stopped = False
            self._last_tick = time.monotonic()
            if self.run is not None:
                # per-request rows stream to disk as they complete, so a
                # crashed server still leaves its forensics
                self.metrics.stream_to(os.path.join(
                    self.run.artifact_dir("serving"), "serve_requests.jsonl"))
            self._thread = threading.Thread(target=self._loop,
                                            name="ddw-serve", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=60.0)
            self._thread = None
        self._stopped = True
        self._fail_pending(RuntimeError("engine stopped"))
        if self.run is not None:
            self.metrics.log_to(self.run)
        self.metrics.close_stream()

    def __enter__(self) -> "ServingEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- health / failure containment (any thread) --------------------------
    @property
    def state(self) -> str:
        """``alive`` | ``degraded`` | ``failed`` | ``stopped``."""
        if self._failure is not None:
            return FAILED
        if self._stopped:
            return STOPPED
        return DEGRADED if self._consecutive_errors > 0 else ALIVE

    @property
    def failure(self) -> ReplicaFailed | None:
        """The terminal failure record, when :attr:`state` is ``failed``."""
        return self._failure

    def health(self) -> dict:
        """The view a circuit breaker and supervisor act on: FSM state, how
        stale the loop's heartbeat is, the consecutive-error count and the
        current load."""
        running = self._thread is not None and self._thread.is_alive()
        return {
            "state": self.state,
            "replica": self.replica_id,
            "generation": self.generation,
            "running": running,
            "last_tick_age_s": (time.monotonic() - self._last_tick
                                if running else 0.0),
            "consecutive_errors": self._consecutive_errors,
            "queue_depth": self._ctrl.depth(),
            "interactive_depth": (self._ctrl.depth("lm")
                                  + self._ctrl.depth("image")),
            "batch_depth": (self._ctrl.depth("lm_batch")
                            + self._ctrl.depth("image_batch")),
            "busy_slots": len(self._slot_req) if self.pool is not None else 0,
            "reserve_occupancy_pct": (
                round(self.pool.reserve_occupancy_pct, 2)
                if isinstance(self.pool, BlockPool) else 0.0),
            "draining": self._draining.is_set(),
            "checkpoint": self.checkpoint_id,
            "role": self.cfg.role,
            "free_block_frac": self._free_block_frac(),
            "prefill_token_ms": self._prefill_token_ms,
            "prefix_cache": (self.pool.prefix_summary()
                             if isinstance(self.pool, BlockPool)
                             else {"seq": 0, "keys": 0}),
            "trace": None,
            "telemetry": None,
            "adapters": None,
            "tenancy": None,
        }

    def _free_block_frac(self) -> float:
        if not isinstance(self.pool, BlockPool):
            return 1.0
        avail = self.pool.free_blocks_effective - self.pool._committed
        return max(0.0, min(1.0, avail / max(self.pool.n_blocks, 1)))

    # -- KV block migration ---------------------------------------------------
    def kv_export(self, prompt, skip_hashes=()) -> dict | None:
        """Export ``prompt``'s registered full-block chain in the versioned
        wire format (:meth:`BlockPool.export_blocks`), serialized with the
        engine loop. ``None`` when nothing is registered."""
        if not isinstance(self.pool, BlockPool):
            raise ValueError("KV migration requires the paged pool "
                             "(EngineCfg(paged=True))")
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim == 2 and prompt.shape[0] == 1:
            prompt = prompt[0]
        skip = tuple(skip_hashes)
        return self._run_pool_op(
            lambda: self.pool.export_blocks(prompt, skip_hashes=skip))

    def kv_import(self, wire: dict) -> dict:
        """Land a migration payload (``ddw_tpu``'s or a port engine's) into
        this engine's prefix cache (all-or-nothing —
        :class:`~ddw_tpu_torch.serve.blocks.KVWireError` on any defect).
        Counts ``kv_blocks_migrated`` / ``kv_bytes_migrated``."""
        if not isinstance(self.pool, BlockPool):
            raise ValueError("KV migration requires the paged pool "
                             "(EngineCfg(paged=True))")
        res = self._run_pool_op(lambda: self.pool.import_blocks(wire))
        if res.get("imported"):
            self.metrics.count("kv_blocks_migrated", res["imported"])
            self.metrics.count("kv_bytes_migrated", res["bytes"])
        return res

    def _run_pool_op(self, fn, timeout_s: float = 30.0):
        """Run ``fn`` serialized with the engine loop: inline when the
        loop is not running (or we ARE the loop thread), else as a control
        op the loop drains between ticks. Exceptions propagate to the
        caller."""
        if self._failure is not None:
            raise self._refusal()
        t = self._thread
        if (t is None or not t.is_alive()
                or threading.current_thread() is t):
            return fn()
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._cv:
            self._pool_ops.append((fn, fut))
            self._cv.notify_all()
        return fut.result(timeout=timeout_s)

    def _drain_pool_ops(self) -> bool:
        """Engine loop: run queued control ops; their exceptions resolve
        the submitter's future, outside the error budget."""
        with self._cv:
            if not self._pool_ops:
                return False
            ops, self._pool_ops = self._pool_ops, []
        for fn, fut in ops:
            try:
                fut.set_result(fn())
            except BaseException as e:
                fut.set_exception(e)
        return True

    def force_fail(self, kind: str = "stalled", reason: str = "") -> None:
        """Declare this replica dead from outside the engine thread (a
        supervisor's stall path): stops admission, fails every pending
        future with :class:`ReplicaFailed` (salvaging queued work through
        ``on_failure``) and signals the loop to die."""
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        self._enter_failed(kind, ServeCrash(
            reason or f"replica {self.replica_id} forced failed ({kind})"))

    def restart(self, join_timeout_s: float = 10.0) -> "ServingEngine":
        """Bring a ``failed`` (or stopped) replica back in place: the dead
        thread is joined, the pool re-initialized, the generation bumped,
        the loop restarted. Raises if the old thread is still running —
        use :meth:`clone_fresh` then."""
        if self._thread is not None:
            self._thread.join(timeout=join_timeout_s)
            if self._thread.is_alive():
                raise RuntimeError(
                    f"replica {self.replica_id} thread still running after "
                    f"{join_timeout_s}s — wedged in device work; replace it "
                    f"via clone_fresh() instead of restarting in place")
            self._thread = None
        with self._fail_lock:
            self._failure = None
        self._consecutive_errors = 0
        self.generation += 1
        self._inflight_admit = []
        if self._pending_checkpoint is not None:
            self._apply_pending_checkpoint()
            self._pool_stats_seen = {}
        elif self.pool is not None:
            self._slot_req.clear()
            self._cur[:] = 0
            self._temps[:] = 0.0
            self.pool.reset()
            self._sync_pool_stats()
        self._stopped = False
        self._draining.clear()
        return self.start()

    def drain_slots(self, timeout_s: float = 30.0) -> bool:
        """Pause admission and let every in-slot request run to completion
        (queued requests stay queued for the next generation; preempted
        streams count as busy and keep re-admitting). False when the slots
        did not empty in time."""
        self._draining.set()
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            busy = ((len(self._slot_req) if self.pool is not None else 0)
                    + len(self._inflight_admit)
                    + self._ctrl.count_claimed("lm")
                    + self._ctrl.count_claimed("lm_batch"))
            if busy == 0 and self._failure is None:
                return True
            if self._failure is not None:
                return False
            time.sleep(0.01)
        return False

    def resume_admission(self) -> None:
        self._draining.clear()
        with self._cv:
            self._cv.notify_all()

    def recycle(self, drain_timeout_s: float = 30.0) -> bool:
        """Graceful in-place restart: drain the slots, quiesce the loop
        without failing queued futures, :meth:`restart`. False (still
        draining) when the slots would not empty."""
        if not self.drain_slots(drain_timeout_s):
            return False
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=drain_timeout_s)
            if self._thread.is_alive():
                return False
        self.restart()
        return True

    def clone_fresh(self) -> "ServingEngine":
        """A replacement replica over the same handles and config, carrying
        the replica identity, the next generation and the failover hook."""
        eng = ServingEngine(lm=self._lm, image=self._image, cfg=self.cfg,
                            replica_id=self.replica_id)
        eng.generation = self.generation + 1
        eng.on_failure = self.on_failure
        eng.model_dir = self.model_dir
        return eng

    def _refusal(self) -> ReplicaFailed:
        f = self._failure
        return ReplicaFailed(f.kind, replica=self.replica_id,
                             generation=self.generation, phase="submitted",
                             forensics=f.forensics)

    # -- submission (any thread) -------------------------------------------
    def submit_generate(self, prompt, num_steps: int,
                        temperature: float = 0.0,
                        rng: torch.Generator | None = None,
                        timeout_s: float | None = None,
                        on_token=None, trace_id: str | None = None,
                        tenant: str | None = None,
                        adapter_id: str | None = None
                        ) -> concurrent.futures.Future:
        """Queue one LM continuation; returns a future resolving to a
        :class:`GenerateResult` (or raising ``Overloaded`` here /
        ``DeadlineExceeded`` on the future). ``prompt`` is 1-D ``[P]`` or
        ``[1, P]`` int tokens; greedy at ``temperature == 0``, else sampled
        with per-step keys drawn from ``rng`` (a ``torch.Generator``).

        ``on_token(index, token)`` runs on the engine thread the moment
        each token's tick fetches (keep it non-blocking). The future
        supports ``cancel()`` while queued; once admitted it runs to
        completion. ``tenant`` attributes the request in the metrics
        (quotas are not ported); ``trace_id`` lands in its jsonl row."""
        req = self._make_lm_request(prompt, num_steps, temperature, rng,
                                    timeout_s, on_token, "interactive",
                                    trace_id=trace_id, tenant=tenant,
                                    adapter_id=adapter_id)
        self._offer("lm", req)
        return req.future

    def _make_lm_request(self, prompt, num_steps, temperature, rng,
                         timeout_s, on_token, lane, trace_id=None,
                         tenant=None, adapter_id=None) -> "_LMRequest":
        if self._lm is None:
            raise ValueError("engine was built without an LM model")
        if adapter_id is not None:
            raise _not_ported("per-request LoRA adapters (adapter_id=)")
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim == 2 and prompt.shape[0] == 1:
            prompt = prompt[0]
        if prompt.ndim != 1 or prompt.size < 1:
            raise ValueError(f"prompt must be [P] or [1, P] tokens, got "
                             f"shape {prompt.shape}")
        from ddw_tpu_torch.serving.lm_package import check_token_ids

        check_token_ids(prompt, self._lm.cfg.vocab_size)
        if num_steps < 1:
            raise ValueError(f"num_steps must be >= 1, got {num_steps}")
        if prompt.size + num_steps > self._lm.cfg.max_len:
            raise ValueError(
                f"prompt {prompt.size} + steps {num_steps} exceeds max_len "
                f"{self._lm.cfg.max_len}")
        if isinstance(self.pool, BlockPool):
            need = self.pool.blocks_for(
                self.pool.total_positions(prompt.size, num_steps))
            ceiling = self.pool.n_blocks
            if lane == "batch":
                # a batch item must fit BEHIND the reserve watermark
                ceiling -= self.pool.interactive_reserve
            if need > ceiling:
                # would wedge the queue head forever
                raise ValueError(
                    f"request needs {need} KV blocks but the {lane} lane "
                    f"only ever has {ceiling}")
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if temperature > 0.0 and rng is None:
            raise ValueError("sampling (temperature > 0) requires rng")
        keys = None
        if temperature > 0.0:
            # the per-step key schedule (jax.random.split's role): token i
            # is sampled with a generator seeded by keys[i]
            keys = torch.randint(0, 1 << 62, (num_steps,),
                                 generator=rng,
                                 device=rng.device).cpu().numpy()
        now = time.monotonic()
        timeout = self.cfg.default_timeout_s if timeout_s is None else timeout_s
        return _LMRequest(prompt, num_steps, float(temperature), keys,
                          now + timeout if timeout else None, now,
                          on_token=on_token, lane=lane, trace_id=trace_id,
                          tenant=tenant)

    def generate(self, prompt, num_steps: int, **kw) -> GenerateResult:
        """Synchronous :meth:`submit_generate`."""
        return self.submit_generate(prompt, num_steps, **kw).result()

    def submit_batch_item(self, prompt, num_steps: int,
                          temperature: float = 0.0, rng=None,
                          timeout_s: float | None = 0.0,
                          tenant: str | None = None,
                          adapter_id: str | None = None
                          ) -> concurrent.futures.Future:
        """Queue ONE batch-lane LM continuation: same tokens as
        :meth:`submit_generate` (the lane changes WHEN a stream runs, never
        what it computes), but it admits only behind an empty interactive
        queue and the block reserve, is preempted first, and carries no
        default deadline. Requires the paged pool."""
        if self._lm is not None and not isinstance(self.pool, BlockPool):
            raise ValueError("the batch lane requires the paged pool "
                             "(EngineCfg(paged=True))")
        req = self._make_lm_request(prompt, num_steps, temperature, rng,
                                    timeout_s, None, "batch",
                                    tenant=tenant, adapter_id=adapter_id)
        self._offer("lm_batch", req)
        return req.future

    def submit_batch_predict(self, item, timeout_s: float | None = 0.0
                             ) -> concurrent.futures.Future:
        """Queue one batch-lane image prediction: served only when no
        interactive image request is waiting; no default deadline."""
        if self._image is None:
            raise ValueError("engine was built without an image model")
        image = self._image.decode_one(item)
        now = time.monotonic()
        timeout = (self.cfg.default_timeout_s if timeout_s is None
                   else timeout_s)
        req = _ImageRequest(np.asarray(image, np.float32),
                            now + timeout if timeout else None, now,
                            lane="batch")
        self._offer("image_batch", req)
        return req.future

    def submit_batch(self, items, kind: str = "generate", **kw):
        """Bulk jobs (``serve/lanes.py``'s ``BatchJob``) are not ported;
        feed :meth:`submit_batch_item` / :meth:`submit_batch_predict`."""
        raise _not_ported("bulk batch jobs (submit_batch, serve/lanes.py "
                          "BatchJob)")

    def submit_predict(self, item, timeout_s: float | None = None
                       ) -> concurrent.futures.Future:
        """Queue one image prediction (JPEG bytes, file path, or decoded
        ``[H, W, 3]`` float array); the future resolves to a
        :class:`PredictResult`."""
        if self._image is None:
            raise ValueError("engine was built without an image model")
        image = self._image.decode_one(item)
        now = time.monotonic()
        timeout = self.cfg.default_timeout_s if timeout_s is None else timeout_s
        req = _ImageRequest(np.asarray(image, np.float32),
                            now + timeout if timeout else None, now)
        self._offer("image", req)
        return req.future

    def predict(self, items, timeout_s: float | None = None
                ) -> list[PredictResult]:
        futures = [self.submit_predict(x, timeout_s=timeout_s) for x in items]
        return [f.result() for f in futures]

    @torch.no_grad()
    def warmup(self, prompt_lens=(8,)) -> None:
        """Run every program shape the given traffic needs once (prefill per
        bucket x group size, the decode chain at every row bucket, the image
        batch buckets — which builds the depthwise kernel), so no live
        request pays a build or a first-call cost. Call before submitting:
        it drives the device from the caller's thread."""
        if self.pool is not None:
            buckets = [bucket_len(n, self._lm.cfg.max_len,
                                  self.cfg.min_bucket) for n in prompt_lens]
            if isinstance(self.pool, BlockPool):
                self.pool.warmup(buckets, max_group=self.pool.max_resident)
            else:
                self.pool.warmup(buckets)
        if self._image is not None:
            h = self._image
            sizes, g = [], 1
            while g < self.cfg.max_batch:
                sizes.append(g)
                g *= 2
            sizes.append(self.cfg.max_batch)
            for g in sizes:
                self._image_apply(
                    np.zeros((g, h.height, h.width, 3), np.float32))

    def snapshot(self) -> dict[str, float]:
        return self.metrics.snapshot()

    # -- internals ----------------------------------------------------------
    def _offer(self, kind: str, req) -> None:
        if self._failure is not None:   # a failed replica refuses instantly
            raise self._refusal()
        if self._draining.is_set():
            # recycling: an honest load refusal (not a failure)
            self.metrics.count_overloaded()
            self._count_tenant_shed(req)
            raise Overloaded(kind, self._ctrl.capacity_for(kind),
                             self._ctrl.depth(kind),
                             retry_after_ms=self._service_ms or 100.0)
        try:
            self._ctrl.offer(kind, req,
                             retry_after_ms=self._retry_hint_ms(kind))
        except Overloaded:
            self.metrics.count_overloaded()
            self._count_tenant_shed(req)
            raise
        with self._cv:
            self._cv.notify_all()

    def _count_tenant_shed(self, req) -> None:
        tenant = getattr(req, "tenant", None)
        if tenant is not None:
            self.metrics.count_labeled("tenant_sheds", "tenant", tenant)

    def _retry_hint_ms(self, kind: str) -> float | None:
        """``Overloaded.retry_after_ms``: on the paged pool the projected
        block-release time (the earliest resident stream's remaining steps
        at the measured per-token rate, plus the queue ahead); the slot
        pool keeps the coarser depth * service estimate."""
        depth_ms = (self._service_ms * (self._ctrl.depth(kind) + 1)
                    if self._service_ms else None)
        if (kind not in ("lm", "lm_batch")
                or not isinstance(self.pool, BlockPool)):
            return depth_ms
        remaining = self.pool.min_remaining_steps()
        if remaining is None or not self._per_token_ms:
            return depth_ms
        return (remaining * self._per_token_ms
                + (self._service_ms * self._ctrl.depth(kind)))

    def _fail_pending(self, exc: Exception) -> None:
        with self._cv:
            ops, self._pool_ops = self._pool_ops, []
        for _, fut in ops:
            if not fut.done():
                fut.set_exception(exc)
        for kind in ("lm", "lm_batch", "image", "image_batch"):
            drained, expired = self._ctrl.take(
                kind, self._ctrl.depth(kind) + 1)
            for req in drained + expired:
                self._fail_req(req, exc)
        if self.pool is not None:
            for req in self._slot_req.values():
                self._fail_req(req, exc)
            self._slot_req.clear()

    def _shed(self, req, kind: str) -> None:
        if req.future.cancelled():      # cancelled first: nothing to tell
            self.metrics.count_cancelled()
            return
        self.metrics.count_deadline()
        tenant = getattr(req, "tenant", None)
        if tenant is not None:
            self.metrics.count_labeled("tenant_sheds", "tenant", tenant)
        waited = (time.monotonic() - req.times.submitted) * 1e3
        timeout = ((req.deadline - req.times.submitted) * 1e3
                   if req.deadline is not None else float("inf"))
        self._fail_req(req, DeadlineExceeded(kind, waited, timeout))

    def _claim(self, req) -> bool:
        """Transition a dequeued request to running; False means the caller
        cancelled it while queued — dropped here, before any device work,
        and counted. A preempted-and-requeued request passes through."""
        if getattr(req, "claimed", False):
            return True
        if req.future.set_running_or_notify_cancel():
            req.claimed = True
            return True
        self.metrics.count_cancelled()
        return False

    def _loop(self) -> None:
        try:
            with torch.no_grad():       # grad mode is per thread
                while not self._stop.is_set():
                    worked = False
                    for kind in ("lm", "lm_batch", "image", "image_batch"):
                        for req in self._ctrl.shed_expired(kind):
                            self._shed(req, kind)
                            worked = True
                    if self.pool is not None:
                        worked |= self._drain_pool_ops()
                        worked |= self._guarded(self._admit_lm)
                        worked |= self._guarded(self._decode_tick)
                    if self._image is not None:
                        worked |= self._guarded(self._image_tick)
                        worked |= self._guarded(self._image_batch_tick)
                    self._last_tick = time.monotonic()   # the heartbeat
                    if not worked:
                        with self._cv:
                            if not self._stop.is_set():
                                self._cv.wait(timeout=max(
                                    self.cfg.max_wait_ms, 1.0) / 1e3)
        except BaseException as e:  # an engine bug must not hang clients:
            self._enter_failed(     # terminal FAILED, every future resolves
                getattr(e, "serve_kind", None)
                or ("crash" if isinstance(e, ServeCrash) else "error"), e)

    def _guarded(self, tick) -> bool:
        """One tick with the recoverable-error contract: an exception fails
        the requests that tick touched, resets the pool and degrades the
        replica; only the consecutive-error budget (or a ServeCrash) turns
        terminal. Clean device work resets the count."""
        try:
            worked = tick()
        except ServeCrash:
            raise
        except Exception as e:
            self._note_loop_error(e)
            return True
        if worked:
            self._consecutive_errors = 0
        self._inflight_admit = []
        return worked

    def _note_loop_error(self, exc: Exception) -> None:
        self.metrics.count("loop_errors")
        self._consecutive_errors += 1
        fail = ReplicaFailed(
            "error", replica=self.replica_id, generation=self.generation,
            phase="in_slot", forensics=self._forensics(exc))
        # the extent of a mid-tick failure is unknowable from outside the
        # dispatch — fail everything the device owns and reset the pool;
        # queued work is untouched and keeps serving
        for req in self._inflight_admit:
            self._fail_req(req, ReplicaFailed(
                "error", replica=self.replica_id,
                generation=self.generation, phase="admitted",
                emitted=getattr(req, "emitted", 0),
                forensics=fail.forensics))
        self._inflight_admit = []
        if self.pool is not None:
            for slot, req in list(self._slot_req.items()):
                self._fail_req(req, ReplicaFailed(
                    "error", replica=self.replica_id,
                    generation=self.generation, phase="in_slot",
                    emitted=req.emitted, forensics=fail.forensics))
            self._slot_req.clear()
            self._cur[:] = 0
            self._temps[:] = 0.0
            self.pool.reset()
            self._sync_pool_stats()
        if self._consecutive_errors >= self.cfg.max_consecutive_errors:
            crash = ServeCrash(
                f"replica {self.replica_id} exhausted its error budget "
                f"({self._consecutive_errors} consecutive)")
            crash.serve_kind = "errors"
            raise crash from exc

    @staticmethod
    def _fail_req(req, exc: Exception) -> None:
        if not req.future.done():
            try:
                req.future.set_exception(exc)
            except concurrent.futures.InvalidStateError:
                pass                    # lost a race with cancel()

    def _forensics(self, exc: BaseException) -> dict:
        """The GangFailure-style record that rides every ReplicaFailed."""
        return {
            "error": repr(exc),
            "traceback": traceback.format_exc(limit=12),
            "consecutive_errors": self._consecutive_errors,
            "last_tick_age_s": round(time.monotonic() - self._last_tick, 3),
            "busy_slots": len(self._slot_req) if self.pool is not None else 0,
            "queue_depth": self._ctrl.depth(),
        }

    def _enter_failed(self, kind: str, exc: BaseException) -> None:
        """Terminal transition (engine or supervisor thread): records the
        failure, fails every in-slot/in-flight future with forensics, and
        hands queued nothing-emitted requests to ``on_failure`` for sibling
        failover (failing them here without a hook). Idempotent."""
        with self._fail_lock:
            if self._failure is not None:
                return
            failure = ReplicaFailed(
                kind, replica=self.replica_id, generation=self.generation,
                phase="terminal", forensics=self._forensics(exc))
            self._failure = failure
        for req in self._inflight_admit:
            self._fail_req(req, ReplicaFailed(
                kind, replica=self.replica_id, generation=self.generation,
                phase="admitted", emitted=getattr(req, "emitted", 0),
                forensics=failure.forensics))
        self._inflight_admit = []
        if self.pool is not None:
            for req in self._slot_req.values():
                self._fail_req(req, ReplicaFailed(
                    kind, replica=self.replica_id,
                    generation=self.generation, phase="in_slot",
                    emitted=req.emitted, forensics=failure.forensics))
            self._slot_req.clear()
        salvage = []
        for kind_ in ("lm", "lm_batch", "image", "image_batch"):
            drained, expired = self._ctrl.take(
                kind_, self._ctrl.depth(kind_) + 1)
            for req in expired:
                self._shed(req, kind_)
            for req in drained:
                if req.future.cancelled():
                    self.metrics.count_cancelled()
                elif req.future.done():
                    pass
                else:
                    salvage.append((kind_, req))
        handed_off = False
        if self.on_failure is not None:
            try:
                self.on_failure(failure, salvage)
                handed_off = True
            except Exception:
                pass                    # fall through: fail them here
        if not handed_off:
            for kind_, req in salvage:
                self._fail_req(req, ReplicaFailed(
                    kind, replica=self.replica_id,
                    generation=self.generation, phase="queued",
                    forensics=failure.forensics))

    # LM: continuous batching ------------------------------------------------
    def _sync_pool_stats(self) -> None:
        """Mirror the paged pool's monotonic stats into the engine metrics
        (delta-based, so a pool reset() never rolls a counter back) and
        push the live block gauges."""
        pool = self.pool
        if not isinstance(pool, BlockPool):
            return
        for key, val in pool.stats.items():
            seen = self._pool_stats_seen.get(key, 0)
            delta = val - seen if val >= seen else val   # reset() rebase
            if delta > 0:
                self.metrics.count(key, delta)
            self._pool_stats_seen[key] = val
        gauges = pool.gauges()
        gauges["batch_backlog"] = float(self._ctrl.depth("lm_batch")
                                        + self._ctrl.depth("image_batch"))
        self.metrics.set_gauges(gauges)

    def _preempt_batch_for_interactive(self) -> bool:
        """An interactive head under block or row pressure evicts the
        youngest resident BATCH stream by recompute; its request re-queues
        at the batch queue head and resumes token for token. False when no
        batch stream is resident."""
        row = self.pool.preempt_youngest(lane="batch")
        if row is None:
            return False
        req = self._slot_req.pop(row)
        self._cur[row] = 0
        self._temps[row] = 0.0
        self._ctrl.requeue_front("lm_batch", req)
        return True

    def _pop_lane_paged(self, kind: str, lane: str, picked: list,
                        drain_only: bool) -> bool:
        """Head-first pop loop for one lane's queue into ``picked``.
        Interactive runs first and may preempt batch residents to fit its
        head; a FRESH batch head also needs an empty interactive queue, the
        reserve-aware block budget and ``batch_rows_headroom`` spare rows;
        a claimed (preempted) batch head re-admits on the plain row bound."""
        pool = self.pool
        worked = False
        batch = lane == "batch"
        while True:
            head = self._ctrl.peek(kind)
            if head is None:
                break
            if drain_only and not getattr(head, "claimed", False):
                break
            if batch and not head.claimed and self._ctrl.depth("lm") > 0:
                break               # interactive always wins admission
            min_rows = (1 if not batch or head.claimed
                        else 1 + max(self.cfg.batch_rows_headroom, 0))
            eff = head.effective_prompt()
            # a resumed stream re-derives its newest pick from the prefill
            # logits, so its remaining picks = num_steps - (emitted - 1)
            ns = head.num_steps - max(head.emitted - 1, 0)
            if (pool.free_slots < min_rows
                    or not pool.can_admit(len(eff), ns, lane=lane)):
                if not batch and self._preempt_batch_for_interactive():
                    worked = True
                    continue        # re-check the head against freed space
                break
            got, expired = self._ctrl.take(kind, 1)
            for r in expired:
                self._shed(r, kind)
                worked = True
            if not got:
                continue
            req = got[0]
            if req is not head:
                # take() skipped expired requests: recompute the budget for
                # the request actually popped; give back what no longer fits
                if drain_only and not getattr(req, "claimed", False):
                    self._ctrl.requeue_front(kind, req)
                    break
                eff = req.effective_prompt()
                ns = req.num_steps - max(req.emitted - 1, 0)
                if not pool.can_admit(len(eff), ns, lane=lane):
                    self._ctrl.requeue_front(kind, req)
                    break
            if not self._claim(req):
                worked = True
                continue
            try:
                row, hit = pool.admit(eff, ns, lane=lane)
            except OutOfBlocks:
                # overcommitted budget met a physically empty pool — admit()
                # unwound cleanly; head-of-line waits for releases
                self._ctrl.requeue_front(kind, req)
                break
            picked.append((req, eff, row, hit))
        return worked

    def _admit_lm_paged(self, drain_only: bool = False) -> bool:
        """Admission on free BLOCKS: pop queued requests head-first while
        the block budget accepts them, then prefill each request's uncovered
        SUFFIX in per-bucket groups (prefix-hit tokens never touch the
        device). Interactive first, then batch backfill; one prefill serves
        both lanes. ``drain_only`` admits only already-claimed (preempted)
        requests."""
        pool = self.pool
        worked = False
        picked: list = []            # (req, eff_prompt, row, hit)
        worked |= self._pop_lane_paged("lm", "interactive", picked,
                                       drain_only)
        worked |= self._pop_lane_paged("lm_batch", "batch", picked,
                                       drain_only)
        if not picked:
            self._sync_pool_stats()
            return worked
        self._inflight_admit = [req for req, *_ in picked]
        groups: dict[int, list] = {}
        now = time.monotonic()
        for item in picked:
            req, eff, row, hit = item
            if req.emitted == 0:
                req.times.admitted = now
            bucket = bucket_len(len(eff) - hit, self._lm.cfg.max_len,
                                self.cfg.min_bucket)
            groups.setdefault(bucket, []).append(item)
        for bucket, items in groups.items():
            g = batch_bucket(len(items), pool.max_resident)
            rows: list = [None] * g
            prompts = np.zeros((g, bucket), np.int32)
            true_lens = np.ones((g,), np.int32)   # dummy rows: length 1
            temps = np.zeros((g,), np.float32)
            keys = np.zeros((g,), np.int64)
            for i, (req, eff, row, hit) in enumerate(items):
                suffix = eff[hit:]
                prompts[i] = pad_to_bucket(suffix[None, :], bucket)[0]
                true_lens[i] = suffix.size
                temps[i] = req.temperature
                keys[i] = req.pick_key()
                rows[i] = row
            t_pf = time.monotonic()
            toks = pool.prefill(rows, prompts, true_lens, temps, keys)
            first = time.monotonic()
            self.metrics.count("prefills")
            n_real = int(sum(int(t) for t in true_lens[:len(items)]))
            if n_real:
                per = (first - t_pf) * 1e3 / n_real
                self._prefill_token_ms = (
                    0.8 * self._prefill_token_ms + 0.2 * per
                    if self._prefill_token_ms else per)
            for i, (req, eff, row, hit) in enumerate(items):
                pool.register(row, eff)
                pool.note_prefilled(row)
                tok0 = int(toks[i])
                if req.emitted == 0:
                    req.times.first_output = first
                    req.tokens.append(tok0)
                    req.emitted = 1
                    req.emit(0)
                # else: a resumed stream — tok0 re-derives its newest pick
                if req.emitted >= req.num_steps:
                    pool.release(row)
                    self._finish_lm(req)
                else:
                    self._slot_req[row] = req
                    self._cur[row] = tok0
                    self._temps[row] = req.temperature
        self._inflight_admit = []
        self._sync_pool_stats()
        return True

    def _admit_lm(self) -> bool:
        draining = self._draining.is_set()
        if isinstance(self.pool, BlockPool):
            return self._admit_lm_paged(drain_only=draining)
        if draining:
            return False        # draining: finish slots, admit nothing
        free = self.pool.free_slots
        if free == 0:
            return False
        admitted, expired = self._ctrl.take("lm", free)
        for req in expired:
            self._shed(req, "lm")
        n_taken = len(admitted)
        admitted = [r for r in admitted if self._claim(r)]
        self._inflight_admit = list(admitted)
        if not admitted:
            return bool(expired) or n_taken > 0
        # group by length bucket: one prefill per group
        groups: dict[int, list[_LMRequest]] = {}
        now = time.monotonic()
        for req in admitted:
            req.times.admitted = now
            bucket = bucket_len(req.prompt.size, self._lm.cfg.max_len,
                                self.cfg.min_bucket)
            groups.setdefault(bucket, []).append(req)
        for bucket, reqs in groups.items():
            g = batch_bucket(len(reqs), self.cfg.n_slots)
            prompts = np.zeros((g, bucket), np.int32)
            true_lens = np.ones((g,), np.int32)   # dummy rows: length 1
            temps = np.zeros((g,), np.float32)
            keys = np.zeros((g,), np.int64)
            for i, req in enumerate(reqs):
                prompts[i] = pad_to_bucket(req.prompt[None, :], bucket)[0]
                true_lens[i] = req.prompt.size
                temps[i] = req.temperature
                keys[i] = req.pick_key()
            cache_g, toks = self.pool.prefill(prompts, true_lens, temps,
                                              keys)
            first = time.monotonic()              # fetched: the TTFT barrier
            self.metrics.count("prefills")
            for i, req in enumerate(reqs):
                slot = self.pool.acquire()
                self.pool.insert(slot, cache_g, req.prompt.size, row=i)
                req.times.first_output = first
                tok0 = int(toks[i])
                req.tokens.append(tok0)
                req.emitted = 1
                req.emit(0)
                if req.emitted >= req.num_steps:
                    self.pool.release(slot)
                    self._finish_lm(req)
                else:
                    self._slot_req[slot] = req
                    self._cur[slot] = tok0
                    self._temps[slot] = req.temperature
        self._inflight_admit = []
        return True

    def _decode_tick(self) -> bool:
        if not self._slot_req:
            return False
        k = self.cfg.steps_per_tick
        if isinstance(self.pool, BlockPool):
            # on-demand block allocation for this tick; exhaustion (only
            # with block_overcommit > 1) preempts by recompute — batch
            # streams first, then the youngest interactive — and requests
            # go back to their lane's queue head with tokens intact
            for row in self.pool.prepare_tick(k):
                req = self._slot_req.pop(row)
                self._cur[row] = 0
                self._temps[row] = 0.0
                self._ctrl.requeue_front(
                    "lm_batch" if req.lane == "batch" else "lm", req)
            if not self._slot_req:
                self._sync_pool_stats()
                return True
        keys = np.zeros((self._n_rows, k), np.int64)
        for slot, req in self._slot_req.items():
            if req.keys is not None:
                rows = req.keys[req.emitted:req.emitted + k]
                keys[slot, :len(rows)] = rows
        toks = self.pool.decode(self._cur, self._temps, keys)  # [S, k]
        self.metrics.count("decode_ticks")
        finished = []
        for slot, req in self._slot_req.items():
            take = min(k, req.num_steps - req.emitted)
            start = req.emitted
            req.tokens.extend(int(t) for t in toks[slot, :take])
            req.emitted += take
            req.ticks += 1
            req.emit(start)
            if req.emitted >= req.num_steps:
                finished.append(slot)
        self._cur = toks[:, -1].astype(np.int32).copy()
        for slot in finished:
            req = self._slot_req.pop(slot)
            self.pool.release(slot)
            self._temps[slot] = 0.0
            self._cur[slot] = 0
            self._finish_lm(req)
        self._sync_pool_stats()
        return True

    def _finish_lm(self, req: _LMRequest) -> None:
        req.times.done = time.monotonic()
        t = req.times
        gen_s = max(t.done - t.first_output, 1e-9)
        rec = RequestRecord("lm", t.submitted, t.admitted, t.first_output,
                            t.done, tokens=req.num_steps, lane=req.lane,
                            trace_id=req.trace_id or "")
        self.metrics.record(rec)
        if req.tenant is not None:
            self.metrics.count_labeled("tenant_requests", "tenant",
                                       req.tenant)
            self.metrics.count_labeled("tenant_tokens", "tenant",
                                       req.tenant, req.num_steps)
        self._update_service(rec.total_ms)
        per_tok = rec.total_ms / max(req.num_steps, 1)
        self._per_token_ms = (0.8 * self._per_token_ms + 0.2 * per_tok
                              if self._per_token_ms else per_tok)
        req.future.set_result(GenerateResult(
            tokens=np.asarray(req.tokens[:req.num_steps], np.int32),
            queue_ms=rec.queue_ms, ttft_ms=rec.ttft_ms,
            total_ms=rec.total_ms,
            tokens_per_sec=(req.num_steps - 1) / gen_s if req.num_steps > 1
            else req.num_steps / max(t.done - t.submitted, 1e-9)))

    # image: dynamic batching -------------------------------------------------
    def _image_tick(self) -> bool:
        if self._draining.is_set():
            return False        # draining: admit no new batch
        depth = self._ctrl.depth("image")
        if depth == 0:
            return False
        if depth < self.cfg.max_batch:
            # flush only once the oldest request has waited out the window
            waited = self._ctrl.oldest_wait_s("image")
            if waited is None or waited * 1e3 < self.cfg.max_wait_ms:
                return False
        return self._serve_image_batch("image")

    def _image_batch_tick(self) -> bool:
        """Backfill lane for image scoring: forms a batch only when NO
        interactive image request is waiting, with no formation window."""
        if self._draining.is_set():
            return False
        if self._ctrl.depth("image_batch") == 0:
            return False
        if self._ctrl.depth("image") > 0:
            return False        # interactive always wins the dispatch
        worked = self._serve_image_batch("image_batch")
        if not isinstance(self.pool, BlockPool):
            self.metrics.set_gauges({"batch_backlog": float(
                self._ctrl.depth("image_batch"))})
        return worked

    def _serve_image_batch(self, kind: str) -> bool:
        admitted, expired = self._ctrl.take(kind, self.cfg.max_batch)
        for req in expired:
            self._shed(req, kind)
        n_taken = len(admitted)
        admitted = [r for r in admitted if self._claim(r)]
        self._inflight_admit = list(admitted)
        if not admitted:
            return bool(expired) or n_taken > 0
        now = time.monotonic()
        for req in admitted:
            req.times.admitted = now
        imgs = np.stack([r.image for r in admitted])
        bucket = batch_bucket(len(imgs), self.cfg.max_batch)
        if bucket > len(imgs):
            imgs = np.concatenate(
                [imgs, np.zeros((bucket - len(imgs), *imgs.shape[1:]),
                                np.float32)])
        logits = np.asarray(self._image_apply(imgs))
        self.metrics.count("image_batches")
        done = time.monotonic()
        classes = self._image.classes
        for i, req in enumerate(admitted):
            req.times.first_output = req.times.done = done
            rec = RequestRecord("image", req.times.submitted,
                                req.times.admitted, done, done,
                                lane=req.lane)
            self.metrics.record(rec)
            self._update_service(rec.total_ms)
            idx = int(np.argmax(logits[i]))
            req.future.set_result(PredictResult(
                logits=logits[i], label=classes[idx] if classes else str(idx),
                index=idx, queue_ms=rec.queue_ms, total_ms=rec.total_ms))
        self._inflight_admit = []
        return True

    def _update_service(self, ms: float) -> None:
        self._service_ms = (0.8 * self._service_ms + 0.2 * ms
                            if self._service_ms else ms)
