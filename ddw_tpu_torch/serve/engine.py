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
- **speculative tick** (``spec_k > 0`` with ``draft=``): a draft model's
  own paged pool, whose rows mirror the target's, proposes ``spec_k``
  tokens per stream per tick; the target verifies all ``spec_k + 1``
  positions in one multi-token pass; drafts are accepted while they match
  the target's own picks under the original per-step seeds, so every
  emitted token is the token spec-off decode would have picked (greedy and
  seeded). The effective width steps down and back up with an acceptance
  EWMA.
- **adapters** (``adapter_slots > 0``,
  :class:`~ddw_tpu_torch.serve.adapters.AdapterPool`): ``load_adapter`` /
  ``unload_adapter``; a request's ``adapter_id`` pins its adapter until it
  resolves, its rows carry the adapter's slot through every forward, and
  its prefix chain is salted by the adapter's digest.
- **tenants** (:mod:`ddw_tpu_torch.serve.tenancy`): quotas charged at
  submission (``QuotaExceeded``) and released on every completion path;
  weighted fair share within priority tiers on the batch lane.
- **image**: dynamic batching — requests coalesce until ``max_batch`` are
  waiting or the oldest has waited ``max_wait_ms``, the batch pads to a
  power-of-two bucket, and the packaged model's forward serves it (with
  ``dw_impl="pallas"`` every stride-1 depthwise layer launches K1).
- **admission** (:mod:`ddw_tpu_torch.serve.admission`): bounded queues
  refuse over-capacity submissions with ``Overloaded``; deadline-expired
  requests are shed before any device work.
- **lanes** (:mod:`ddw_tpu_torch.serve.lanes`): a throughput-SLO batch lane
  (``submit_batch`` bulk jobs, ``submit_batch_item`` /
  ``submit_batch_predict`` per item) backfills idle blocks behind an
  interactive-reserve watermark; interactive traffic wins admission and
  batch streams are preempted first.
- **observability** (:mod:`ddw_tpu_torch.obs`): ``trace=True`` records a
  span per admission, prefill, tick and preemption into a drop-oldest ring
  (``trace_events``; its tail rides every ``ReplicaFailed``);
  ``telemetry=True`` samples counters and gauges on a thread
  (``telemetry_events``) and observes each interactive request's latency.
  Both off, the hot path touches neither.
- **metrics** (:mod:`ddw_tpu_torch.serve.metrics`): queue time, TTFT,
  tokens/s and latency tails, exported into a tracker run, with
  ``monitor_interval_s`` sampling utilization beside them.

Failure containment is ``ddw_tpu``'s: a recoverable error in one tick fails
the requests that tick touched with a structured
:class:`~ddw_tpu_torch.serve.admission.ReplicaFailed`, resets the pool and
leaves the engine ``degraded``; ``max_consecutive_errors`` in a row (or
:meth:`ServingEngine.force_fail`) make it ``failed``, every future resolving
with ``ReplicaFailed`` (never a hang) and later submissions refused.
:meth:`~ServingEngine.restart`, :meth:`~ServingEngine.recycle` and
:meth:`~ServingEngine.clone_fresh` bring it back.

Disaggregation (``EngineCfg.role``): a ``prefill`` replica never decodes —
each request finishes at its first token, its blocks left registered for
:meth:`~ServingEngine.kv_export`; a ``decode`` replica admits like the
colocated ``both`` (imported blocks prefix-hit). ``DDW_FAULT=serve:*``
(:mod:`ddw_tpu_torch.runtime.faults`) fires at the ``admit``, ``batch``,
``prefill`` and ``decode`` hook sites ``ddw_tpu`` has, with per-site
counts that restart every generation.

The loop is a background thread: it enters ``torch.no_grad()`` itself
(grad mode is thread-local), and its device work runs on that thread's
current stream.

Tensor parallelism (``EngineCfg(tp=N)`` or ``mesh=``): one replica spans
``N`` rank processes (:mod:`ddw_tpu_torch.serve.tp`). This process is rank
0 and schedules; parameters shard by ``LM_TP_RULES``, the KV block pools
on their heads axis, and every device program of the paged pools is one
dispatch the other ranks follow; the logits are gathered, so every rank
picks the same tokens, and the replica serves the tokens a ``tp=1``
engine serves. ``tp=N`` without a mesh builds a replica-private group and
starts ``N - 1`` follower processes (:class:`~ddw_tpu_torch.serve.tp.
TPGroup`); an explicit mesh adopts its ``model`` axis, and its other ranks
construct the same engine, which then follows (:meth:`ServingEngine.
follow`). The image lane stays on rank 0, unsharded. Adapter pools serve
under ``tp > 1`` too: their stacks shard like the weights they adapt, and a
slot write is one more dispatch.
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

from ddw_tpu_torch.models.spec_decode import match_length
from ddw_tpu_torch.obs.telemetry import TelemetryHub
from ddw_tpu_torch.obs.trace import Tracer
from ddw_tpu_torch.runtime.faults import ServeCrash, maybe_serve_fault
from ddw_tpu_torch.runtime.mesh import MODEL_AXIS
from ddw_tpu_torch.serve.adapters import (AdapterError, AdapterPool,
                                          UnknownAdapter,
                                          load_adapter as load_adapter_file)
from ddw_tpu_torch.serve.admission import (AdmissionController,
                                           DeadlineExceeded, Overloaded,
                                           ReplicaFailed)
from ddw_tpu_torch.serve.blocks import BlockPool, OutOfBlocks
from ddw_tpu_torch.serve.bucketing import (batch_bucket, bucket_len,
                                           pad_to_bucket)
from ddw_tpu_torch.serve.metrics import EngineMetrics, RequestRecord
from ddw_tpu_torch.serve.slots import SlotPool
from ddw_tpu_torch.serve.tenancy import (QuotaExceeded, TenancyController,
                                         TenantAwareAdmission, TenantSpec)

__all__ = ["EngineCfg", "ServingEngine", "GenerateResult", "PredictResult",
           "Overloaded", "DeadlineExceeded", "ReplicaFailed", "ServeCrash",
           "draw_step_seeds"]

# Replica health states (ServingEngine.state / health()["state"])
ALIVE = "alive"          # loop running, last operation clean
DEGRADED = "degraded"    # loop running, but the consecutive-error count > 0
FAILED = "failed"        # terminal: loop dead, futures failed, submissions
#                          refused — restart()/clone_fresh() to recover
STOPPED = "stopped"      # clean stop()

_UNSET = object()        # set_checkpoint(draft_dir=...) sentinel: "leave
#                          the currently staged/serving draft alone"


def draw_step_seeds(rng: torch.Generator, num_steps: int) -> np.ndarray:
    """The per-step key schedule of a sampled request (``jax.random.
    split``'s role): ``num_steps`` int64 seeds drawn from ``rng``; token
    ``i`` is sampled with a generator seeded by seed ``i``. A process
    replica draws them in the parent and relays them, so a seed samples
    the same tokens on either side of the hop."""
    return torch.randint(0, 1 << 62, (num_steps,), generator=rng,
                         device=rng.device).cpu().numpy()


@dataclasses.dataclass
class EngineCfg:
    """Batching / admission policy knobs (every field of ``ddw_tpu``'s,
    with its default)."""

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
    # speculative decoding: a draft model proposes spec_k tokens per stream
    # per tick and the target verifies all k+1 positions in ONE multi-token
    # pass; outputs equal spec_k=0's. Requires paged=True and draft=.
    spec_k: int = 0             # draft tokens proposed per tick; 0 = off
    # request tracing (obs/trace): spans through admission, prefill, every
    # tick, preemption and pool pressure; False leaves the hot path free
    # of tracer calls
    trace: bool = False
    trace_capacity: int = 8192  # flight-recorder ring bound (drop-oldest)
    # live telemetry (obs/telemetry): a sampler thread snapshots counters
    # and gauges every telemetry_interval_s, and each completed
    # interactive request records its latencies; False leaves the hot
    # path free of hub calls
    telemetry: bool = False
    telemetry_interval_s: float = 0.25
    telemetry_capacity: int = 4096  # sample ring bound (drop-oldest)
    # tensor parallelism: one replica spans tp rank processes — params
    # shard per LM_TP_RULES, the KV block pool on the heads axis, and the
    # tokens are tp=1's (greedy and seeded). Requires paged=True; the head
    # count must divide by tp.
    tp: int = 1
    # heterogeneous LoRA adapters (serve/adapters AdapterPool): slot 0 is
    # the null adapter, so tenant-less traffic gives adapter_slots=0's
    # tokens. Requires paged=True.
    adapter_slots: int = 0      # loadable adapter slots beyond the null
    #                             slot; 0 = adapters off
    adapter_rank: int = 8       # pool-wide rank ceiling; smaller-rank
    #                             adapters zero-pad up
    adapter_targets: tuple = ()  # projections adapters may touch; () =
    #                             every LM_LORA_TARGETS projection
    # per-tenant QoS (serve/tenancy): TenantSpec entries (objects or their
    # to_dict forms); empty = one implicit tenant, plain admission
    tenants: tuple = ()
    # prefill/decode disaggregation: a "prefill" replica never decodes —
    # every request finishes at its first token, its blocks left
    # registered for kv_export (the gateway's handoff submits
    # num_steps=1, then migrates them); a "decode" replica admits as
    # "both" does (imported blocks prefix-hit, so it prefills at most the
    # uncovered tail). "both" is the colocated default.
    role: str = "both"

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
                 "claimed", "lane", "trace_id", "parent_span", "last_span",
                 "ticks", "tenant", "adapter_id", "adapter_slot", "salt",
                 "quota_blocks", "quota_tokens", "released")

    def __init__(self, prompt, num_steps, temperature, keys, deadline, now,
                 on_token=None, lane="interactive", trace_id=None,
                 parent_span=None, tenant=None, adapter_id=None,
                 adapter_slot=0, salt=b""):
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
        self.trace_id = trace_id    # end-to-end trace id (None = untraced)
        self.parent_span = parent_span  # a caller's span, when any
        self.last_span = parent_span    # newest span in this request's
        #                             chain — the next span's parent
        self.ticks = 0              # decode ticks this request rode
        self.tenant = tenant        # attribution label; None = untagged
        self.adapter_id = adapter_id    # LoRA adapter, None = base model
        self.adapter_slot = adapter_slot  # pinned pool slot (0 = null)
        self.salt = salt            # prefix-cache salt (adapter digest)
        self.quota_blocks = 0       # tenancy charge held by this request
        self.quota_tokens = 0       # (released exactly once at resolution)
        self.released = False       # pin + quota given back (idempotence)

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
    or the handle itself; at least one is required. ``draft`` (same
    duck-type as ``lm``) is the speculative-decoding draft model — required
    when ``cfg.spec_k > 0``, ignored otherwise. The engine runs where the
    packages live (the card unless they were loaded with ``device="cpu"``).
    With ``run`` set, per-request rows stream to the run's
    ``serving/serve_requests.jsonl``, SLO metrics land in the tracker on
    :meth:`stop`, and ``monitor_interval_s > 0`` samples utilization into it
    while the engine is live.
    """

    def __init__(self, lm=None, image=None, cfg: EngineCfg | None = None,
                 run=None, monitor_interval_s: float = 0.0,
                 replica_id: int = 0, draft=None, mesh=None):
        if lm is None and image is None:
            raise ValueError("engine needs an lm and/or image model")
        self.cfg = cfg or EngineCfg()
        self.mesh = self._resolve_mesh(mesh)
        self._tp_degree = (int(self.mesh.shape[MODEL_AXIS])
                           if self.mesh is not None else self.cfg.tp)
        self._tp_group = None       # the replica-private group this engine
        #                             built (tp > 1 without a mesh)
        self._follower = False      # an explicit mesh's rank other than 0
        if self.mesh is not None:
            from ddw_tpu_torch.ops.ring_reduce import group_size_rank

            self._follower = group_size_rank(
                self.mesh.group(MODEL_AXIS))[1] != 0
        self._closed = False
        self.run = run
        self.metrics = EngineMetrics()
        # the tracer object always exists (drains and summaries stay cheap
        # on an empty ring) but the HOT PATH branches on the plain bool
        self.tracer = Tracer(capacity=self.cfg.trace_capacity,
                             process=f"replica{replica_id}")
        self._tracing = bool(self.cfg.trace)
        # the hub exists only when enabled; the hot path branches on the
        # plain bool
        self.telem = (TelemetryHub(capacity=self.cfg.telemetry_capacity,
                                   interval_s=self.cfg.telemetry_interval_s,
                                   source=f"replica{replica_id}")
                      if self.cfg.telemetry else None)
        self._telemetry = bool(self.cfg.telemetry)
        if self.telem is not None:
            self.telem.add_collector(self._telemetry_collector)
        per_kind = {"lm_batch": self.cfg.batch_queue_depth,
                    "image_batch": self.cfg.batch_queue_depth}
        specs = tuple(TenantSpec.from_dict(t) if isinstance(t, dict) else t
                      for t in (self.cfg.tenants or ()))
        self.tenancy = TenancyController(specs=specs) if specs else None
        if self.tenancy is not None:
            self._ctrl = TenantAwareAdmission(
                self.cfg.queue_depth, self.tenancy, per_kind=per_kind)
        else:
            self._ctrl = AdmissionController(self.cfg.queue_depth,
                                             per_kind=per_kind)
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._monitor = None
        self._monitor_interval_s = monitor_interval_s
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
        self._fault_n: dict[str, int] = {}   # per-site hook counts (per gen)
        self._inflight_admit: list = []      # claimed reqs mid-device-work
        self._pool_ops: list = []            # (fn, future) control ops the
        #                                      loop runs between ticks

        self.model_dir: str | None = None    # package dir behind _lm
        self.draft_dir: str | None = None    # package dir behind _draft
        self._pending_checkpoint: str | None = None   # applied at restart()
        self._pending_draft: object = _UNSET          # staged draft swap
        self._init_lm(lm, draft=draft)
        self._pool_stats_seen: dict[str, int] = {}

        self._image = _handle(image)
        if self._image is not None:
            self._image_apply = self._image.apply

    def _resolve_mesh(self, mesh):
        """Reconcile ``EngineCfg.tp`` with an explicit mesh, with
        ``ddw_tpu``'s rules and messages: an explicit mesh with ``tp`` left
        at 1 is adopted (its ``model`` axis IS the degree), a degenerate
        one of size 1 keeps the ``tp=1`` path, and conflicts fail here, at
        construction. ``tp > 1`` without a mesh returns None: the engine
        builds its replica-private group after the head checks
        (:meth:`_init_lm`). ``ddw_tpu`` refuses ``tp`` above the local
        device count; the port runs a rank process per shard, ranks sharing
        cards, so what it can place is one rank per CPU core
        (``os.cpu_count()``), and ``tp`` above that is refused with the
        same message."""
        tp = self.cfg.tp
        if mesh is not None:
            if MODEL_AXIS not in mesh.shape:
                raise ValueError(
                    f"serving mesh must carry a '{MODEL_AXIS}' axis, got "
                    f"axes {tuple(mesh.shape)}")
            size = int(mesh.shape[MODEL_AXIS])
            if tp > 1 and size != tp:
                raise ValueError(
                    f"EngineCfg(tp={tp}) conflicts with the mesh's "
                    f"'{MODEL_AXIS}' axis size {size}")
            if size == 1 and tp == 1:
                return None        # degenerate slice: keep the tp=1 path
            return mesh
        ndev = os.cpu_count() or 1
        if tp > ndev:
            raise ValueError(
                f"tp {tp} exceeds the local device count {ndev}: a "
                f"tensor-parallel replica runs a rank process per shard on "
                f"this host, at most one per CPU core")
        return None

    @property
    def device(self) -> torch.device:
        h = self._lm if self._lm is not None else self._image
        return h.device

    @property
    def tp_degree(self) -> int:
        """Model-axis width this replica's programs shard over (1 = the
        single-device path)."""
        return self._tp_degree

    @property
    def follower_pids(self) -> list[int]:
        """The follower processes this engine started (tp > 1 without a
        mesh); empty otherwise."""
        return self._tp_group.pids if self._tp_group is not None else []

    @property
    def follower_exit_codes(self) -> dict[int, int | None]:
        """Each follower's exit code by rank (None while it runs), for the
        followers :attr:`follower_pids` lists."""
        return (self._tp_group.exit_codes if self._tp_group is not None
                else {})

    @property
    def role(self) -> str:
        """``prefill`` | ``decode`` | ``both`` — the disaggregation role
        the gateway routes by (duck-typed: :class:`~ddw_tpu_torch.deploy.
        ProcessReplica` relays the same property)."""
        return self.cfg.role

    def _init_lm(self, lm, draft=_UNSET, adapters=None) -> None:
        """Build (or rebuild) the LM handle + KV pool(s). Called at
        construction and by :meth:`restart` when a staged checkpoint
        (:meth:`set_checkpoint`) replaces the weights, or a broken
        tensor-parallel group is replaced. ``draft`` left unset keeps the
        current draft handle; ``adapters`` (the current adapter pool) keeps
        its adapters resident in the rebuilt pool."""
        self._lm = _handle(lm)
        if draft is _UNSET:
            draft = getattr(self, "_draft", None)
        else:
            draft = _handle(draft)
        self._draft = draft
        for old in (getattr(self, "_draft_pool", None),
                    getattr(self, "pool", None)):
            if isinstance(old, BlockPool) and old.tp_degree > 1 \
                    and old.cache is not None:
                old.close()     # the followers drop the replaced pool
        self._draft_pool: BlockPool | None = None
        self.adapters: AdapterPool | None = None
        if self._lm is None or self._follower:
            self.pool = None    # a follower's pools are rank 0's to build
            return
        spec = self.cfg.spec_k > 0
        if self.cfg.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {self.cfg.spec_k}")
        if spec and not self.cfg.paged:
            raise ValueError("speculative decoding (spec_k > 0) requires "
                             "the paged pool (EngineCfg(paged=True))")
        if spec and draft is None:
            raise ValueError("spec_k > 0 requires a draft model "
                             "(ServingEngine(draft=...))")
        if spec and draft.cfg.vocab_size != self._lm.cfg.vocab_size:
            raise ValueError(
                f"draft vocab_size {draft.cfg.vocab_size} != target "
                f"vocab_size {self._lm.cfg.vocab_size} — draft proposals "
                f"must be target tokens")
        if spec and draft.device != self._lm.device:
            raise ValueError(f"draft on {draft.device} but target on "
                             f"{self._lm.device}: both pools must live on "
                             f"one device")
        tp = self.tp_degree
        if tp > 1:
            # the attention head axis is the tensor-parallel shard axis: a
            # head count the group cannot split fails here, before any
            # follower starts
            roles = [("target", self._lm)] + ([("draft", draft)]
                                              if spec else [])
            for role, h in roles:
                heads = h.model.num_heads
                if heads % tp:
                    raise ValueError(
                        f"tp {tp} does not divide the {role} model's "
                        f"num_heads {heads}: attention heads are the "
                        f"tensor-parallel shard axis")
            if self.mesh is None:
                from ddw_tpu_torch.serve.tp import TPGroup

                self._tp_group = TPGroup(tp, self._lm.device)
                self.mesh = self._tp_group.mesh
        if self.cfg.paged:
            # the adapter pool is built BEFORE the block pool, which takes
            # its stacks into every forward. The DRAFT pool never gets one:
            # proposals are verified by the adapted target, so the
            # verify-based commit keeps output identity with an
            # adapter-free draft.
            if self.cfg.adapter_slots > 0:
                self.adapters = adapters or AdapterPool(
                    self._lm.model, self.cfg.adapter_slots,
                    self.cfg.adapter_rank,
                    targets=(tuple(self.cfg.adapter_targets)
                             if self.cfg.adapter_targets else None))
            self.pool = self._build_block_pool(
                self._lm, self.cfg.steps_per_tick, adapters=self.adapters)
            n = self.pool.max_resident
            if spec:
                # the draft's OWN paged pool: rows mirror the target pool
                # one for one (identical admit/release order over identical
                # LIFO free lists), but it never registers prefixes
                self._draft_pool = self._build_block_pool(
                    draft, max(self.cfg.spec_k, 1))
        else:
            self.pool = SlotPool(self._lm.model, self.cfg.n_slots,
                                 steps_per_tick=self.cfg.steps_per_tick)
            n = self.cfg.n_slots
        self._n_rows = n
        # spec_k auto-tuning: the EFFECTIVE draft width, stepped by a
        # bounded EWMA controller over live acceptance (reset with the
        # pools on every handle rebuild)
        self._spec_k_eff = self.cfg.spec_k
        self._spec_accept_ewma = 1.0
        self._slot_req: dict[int, _LMRequest] = {}
        self._cur = np.zeros((n,), np.int32)
        self._prev = np.zeros((n,), np.int32)   # H[-2] per row — the
        #                             draft's lagged entry token (the draft
        #                             pool has processed H[:-2])
        self._temps = np.zeros((n,), np.float32)

    def _build_block_pool(self, handle, steps_per_tick: int,
                          adapters: AdapterPool | None = None) -> BlockPool:
        """One paged pool over ``handle`` with the engine's geometry knobs
        (block size shrinks to the model's own tile divisor; block count
        defaults to equal-KV-memory scaled by the model's own capacity)."""
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
            steps_per_tick=steps_per_tick,
            overcommit=self.cfg.block_overcommit,
            interactive_reserve=reserve,
            decode_buckets=self.cfg.decode_buckets, mesh=self.mesh,
            adapters=adapters)

    # -- checkpoint hot-swap --------------------------------------------------
    @property
    def checkpoint_id(self) -> str | None:
        """Content digest of the serving LM package, when known."""
        digest = getattr(self._lm, "content_digest", None)
        return digest or None

    def set_checkpoint(self, model_dir: str | None,
                       draft_dir: object = _UNSET) -> None:
        """Stage a weight swap: the NEXT :meth:`restart` (so also
        :meth:`recycle`) loads the LM package at ``model_dir`` onto the
        engine's device and rebuilds the pool over it; in-slot work keeps
        decoding against the current weights until then. ``None`` clears a
        staged swap.

        ``draft_dir`` (keyword) stages the speculative DRAFT package
        alongside: a path swaps the draft at the same restart, ``None``
        drops it (restart then fails fast if ``spec_k > 0`` still demands
        one), and leaving it unset keeps the currently serving draft."""
        self._pending_checkpoint = model_dir
        if model_dir is None:
            self._pending_draft = _UNSET
        if draft_dir is not _UNSET:
            self._pending_draft = draft_dir

    def _apply_pending_checkpoint(self) -> None:
        """Inside restart(): swap the staged package(s) in. Raises on a bad
        package."""
        model_dir, self._pending_checkpoint = self._pending_checkpoint, None
        draft_dir, self._pending_draft = self._pending_draft, _UNSET
        if model_dir is None:
            return
        from ddw_tpu_torch.serving.lm_package import LMPackagedModel

        pkg = LMPackagedModel(model_dir, device=self.device)
        if draft_dir is _UNSET:
            self._init_lm(pkg)          # keeps the current draft handle
        else:
            dpkg = (LMPackagedModel(draft_dir, device=self.device)
                    if draft_dir is not None else None)
            self._init_lm(pkg, draft=dpkg)
            self.draft_dir = draft_dir
        self.model_dir = model_dir

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ServingEngine":
        if self._follower:
            # an explicit mesh's other rank: its thread follows rank 0
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self.follow, name="ddw-tp-follow", daemon=True)
                self._thread.start()
            return self
        if self._closed:
            raise RuntimeError("engine closed")
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
            if self.telem is not None:
                self.telem.start()
            if self.run is not None and self._monitor_interval_s > 0:
                from ddw_tpu_torch.utils.sysmon import SystemMonitor

                self._monitor = SystemMonitor(
                    self.run, interval_s=self._monitor_interval_s,
                    device=self.device).start()
        return self

    def follow(self) -> int:
        """On an explicit mesh's rank other than 0: run the programs rank
        0 dispatches until rank 0 closes the replica (:func:`ddw_tpu_torch.
        serve.tp.follow`); 0 on ``close``, 1 when rank 0 is gone."""
        if not self._follower:
            raise RuntimeError("only a rank other than 0 of the mesh's "
                               "model axis follows")
        from ddw_tpu_torch.serve.tp import follow

        return follow(self.mesh, self.device)

    def close(self) -> None:
        """:meth:`stop`, then release the other ranks: the pools are
        dropped on every rank, the followers this engine started exit, and
        an explicit mesh's other ranks return from :meth:`follow`. A
        closed engine does not restart. Idempotent; at ``tp=1`` the same as
        :meth:`stop`."""
        if self._follower:
            if self._thread is not None:
                self._thread.join(timeout=60.0)
            return
        self.stop()
        if self._closed or self.tp_degree == 1:
            self._closed = True
            return
        self._closed = True
        from ddw_tpu_torch.serve import tp as _tp

        try:
            for pool in (self._draft_pool, self.pool):
                if isinstance(pool, BlockPool) and pool.cache is not None:
                    pool.close()
            if self._tp_group is None:
                _tp.check_group(self.mesh.group(MODEL_AXIS))
                _tp.send_header(self.mesh.group(MODEL_AXIS), ("close",))
        except (ServeCrash, RuntimeError):
            pass                # a broken group: nothing left to release
        if self._tp_group is not None:
            self._tp_group.close()

    def stop(self) -> None:
        if self._follower:
            self._stopped = True
            return
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=60.0)
            self._thread = None
        self._stopped = True
        self._fail_pending(RuntimeError("engine stopped"))
        if self.telem is not None:
            self.telem.stop()
        if self._monitor is not None:
            self._monitor.stop()
            self._monitor = None
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
            "trace": (self.tracer.summary() if self._tracing else None),
            "telemetry": (self.telem.summary() if self._telemetry else None),
            "adapters": (self.adapters.view()
                         if self.adapters is not None else None),
            "tenancy": (self.tenancy.view()
                        if self.tenancy is not None else None),
        }

    def load(self) -> dict:
        """What admission-aware routing needs: queued + on-device work and
        the decaying per-request service estimate (ms). ``depth`` counts
        the INTERACTIVE lanes only (batch backlog yields to interactive
        arrivals, so it does not project interactive wait); it rides
        separately as ``batch_depth``. ``free_block_frac`` is the
        disaggregation splitter's decode-placement signal."""
        return {"depth": self._ctrl.depth("lm") + self._ctrl.depth("image"),
                "busy": len(self._slot_req) if self.pool is not None else 0,
                "batch_depth": (self._ctrl.depth("lm_batch")
                                + self._ctrl.depth("image_batch")),
                "service_ms": self._service_ms,
                "prefill_token_ms": self._prefill_token_ms,
                "free_block_frac": self._free_block_frac()}

    def _free_block_frac(self) -> float:
        if not isinstance(self.pool, BlockPool):
            return 1.0
        avail = self.pool.free_blocks_effective - self.pool._committed
        return max(0.0, min(1.0, avail / max(self.pool.n_blocks, 1)))

    def trace_events(self, since: int = 0) -> dict:
        """Drain the trace ring past ``since`` (a ``seq`` watermark)."""
        return {"replica": self.replica_id, "generation": self.generation,
                "dropped": self.tracer.spans_dropped,
                "events": self.tracer.drain(since)}

    def telemetry_events(self, since: int = 0) -> dict:
        """Drain the telemetry ring past ``since`` (a ``seq`` watermark) —
        the feed :class:`~ddw_tpu_torch.obs.telemetry.FleetTelemetry`
        merges into aligned windows. A telemetry-off engine reports an
        empty, never-advancing feed."""
        if self.telem is None:
            return {"source": f"replica{self.replica_id}",
                    "replica": self.replica_id,
                    "generation": self.generation,
                    "dropped": 0, "samples": [], "last_seq": int(since)}
        d = self.telem.drain(since)
        d["replica"] = self.replica_id
        d["generation"] = self.generation
        return d

    def _telemetry_collector(self) -> dict:
        """One sampler tick's worth of engine state for the hub: every
        accumulated counter, the admission-lane depths, and the pool and
        backlog gauges. Runs on the hub's sampler thread and reads host
        state only (never a device tensor)."""
        out = {f"serve.{k}": ("counter", v)
               for k, v in self.metrics.counters_view().items()}
        out["serve.queue_depth"] = ("gauge", float(self._ctrl.depth()))
        out["serve.interactive_depth"] = (
            "gauge", float(self._ctrl.depth("lm") + self._ctrl.depth("image")))
        out["serve.batch_depth"] = (
            "gauge", float(self._ctrl.depth("lm_batch")
                           + self._ctrl.depth("image_batch")))
        out["serve.busy_slots"] = (
            "gauge", float(len(self._slot_req) if self.pool is not None
                           else 0))
        for name, v in self.metrics.gauges_view().items():
            out[f"serve.{name}"] = ("gauge", float(v))
        return out

    def prefix_events(self, since: int = 0) -> dict:
        """Fleet prefix-index feed: the paged pool's register/evict event
        log past ``since`` (:meth:`BlockPool.prefix_events` — a snapshot
        with ``reset`` when ``since`` fell out of the retained window).
        Engines without a paged pool report an empty, never-advancing
        log."""
        if isinstance(self.pool, BlockPool):
            return self.pool.prefix_events(since)
        return {"seq": 0, "reset": False, "events": []}

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

    # -- LoRA adapter admin ---------------------------------------------------
    def load_adapter(self, adapter_id: str, adapter=None, *,
                     path: str | None = None, alpha: float = 16.0,
                     rank: int | None = None,
                     digest: str | None = None) -> dict:
        """Land (or re-land — same-digest loads are idempotent) a LoRA
        adapter in the pool, serialized with the engine loop like every
        pool mutation. ``adapter`` is an in-memory ``{block: {target:
        {lora_a, lora_b}}}`` tree; ``path`` loads a ``.npz`` package saved
        by :func:`ddw_tpu_torch.serve.adapters.save_adapter` (or by
        ``ddw_tpu``'s) instead, its header supplying alpha/rank/digest.
        Raises ``AdapterPoolFull`` when every slot is pinned,
        ``AdapterDigestMismatch`` on an id collision."""
        if self.adapters is None:
            raise ValueError("engine was built without an adapter pool "
                             "(EngineCfg(adapter_slots > 0))")
        if (adapter is None) == (path is None):
            raise ValueError("exactly one of adapter= or path= is required")
        if path is not None:
            adapter, header = load_adapter_file(path)
            alpha = float(header.get("alpha", alpha))
            rank = header.get("rank", rank)
            digest = header.get("digest", digest)
        slot = self._run_pool_op(lambda: self.adapters.load(
            adapter_id, adapter, alpha=alpha, rank=rank, digest=digest))
        self._sync_adapter_counters()
        return {"adapter_id": adapter_id, "slot": slot,
                "digest": self.adapters.digest_of(adapter_id)}

    def unload_adapter(self, adapter_id: str) -> dict:
        """Explicitly evict a loaded adapter (refuses while pinned — a
        decoding stream must never lose its weights)."""
        if self.adapters is None:
            raise ValueError("engine was built without an adapter pool "
                             "(EngineCfg(adapter_slots > 0))")
        self._run_pool_op(lambda: self.adapters.unload(adapter_id))
        self._sync_adapter_counters()
        return {"adapter_id": adapter_id, "unloaded": True}

    def adapter_view(self) -> dict:
        """The pool's registry view (slots, digests, pins, LRU order) —
        ``{}`` when adapters are off."""
        return self.adapters.view() if self.adapters is not None else {}

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
        use :meth:`clone_fresh` then. A tensor-parallel replica whose group
        failed gets new followers and its pools rebuilt over them."""
        if self._closed:
            raise RuntimeError("engine closed: build a new one")
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
        self._fault_n = {}
        self._inflight_admit = []
        group = self._tp_group
        if group is not None and group.broken:
            # a follower died, or a dispatch left the ranks out of step:
            # new followers, and the pools rebuilt over them (on the
            # staged checkpoint when one is pending)
            group.close()
            self._tp_group, self.mesh = None, None
            self.pool = self._draft_pool = None
            if self._pending_checkpoint is None:
                # as a tp=1 restart does, the adapters stay resident: the
                # new followers receive their blocks with the weights
                self._init_lm(self._lm, adapters=self.adapters)
            self._pool_stats_seen = {}
        if self._pending_checkpoint is not None:
            self._apply_pending_checkpoint()
            self._pool_stats_seen = {}
        elif self.pool is not None:
            self._slot_req.clear()
            self._cur[:] = 0
            self._prev[:] = 0
            self._temps[:] = 0.0
            self.pool.reset()
            if self._draft_pool is not None:
                self._draft_pool.reset()
            self._sync_pool_stats()
        self._stopped = False
        self._draining.clear()
        if self._tracing:
            self.tracer.instant("restart", "serve", tid="engine",
                                args={"generation": self.generation})
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
        the replica identity, the next generation and the failover hook. A
        tensor-parallel clone keeps the degree: over the same explicit
        mesh, or over followers of its own when this engine started its
        own (this engine's followers are closed)."""
        owned = self._tp_group
        eng = ServingEngine(lm=self._lm, image=self._image, cfg=self.cfg,
                            replica_id=self.replica_id, draft=self._draft,
                            mesh=None if owned is not None else self.mesh)
        eng.generation = self.generation + 1
        eng.on_failure = self.on_failure
        eng.model_dir = self.model_dir
        eng.draft_dir = self.draft_dir
        if owned is not None:
            # the clone started followers of its own; this engine's go (a
            # thread wedged in one of their collectives gets its error)
            owned.close(grace_s=1.0)
        return eng

    def adopt(self, kind: str, req) -> None:
        """Take over a salvaged request from a failed sibling — the
        original future rides along untouched, so the caller holding it
        never learns its first replica died. Only requests that emitted
        nothing are adoptable (re-running a partially streamed request
        would duplicate tokens). Raises ``Overloaded``/``ReplicaFailed``
        like any submission."""
        if getattr(req, "emitted", 0):
            raise ValueError("cannot adopt a request that already emitted "
                             "tokens")
        if kind in ("lm", "lm_batch") and self._lm is None:
            raise ValueError("engine was built without an LM model")
        if kind in ("image", "image_batch") and self._image is None:
            raise ValueError("engine was built without an image model")
        if kind == "lm_batch" and not isinstance(self.pool, BlockPool):
            raise ValueError("the batch lane requires the paged pool")
        self._offer(kind, req)
        self.metrics.count("failovers")

    def _refusal(self) -> ReplicaFailed:
        f = self._failure
        return ReplicaFailed(f.kind, replica=self.replica_id,
                             generation=self.generation, phase="submitted",
                             forensics=f.forensics)

    # -- submission (any thread) -------------------------------------------
    def submit_generate(self, prompt, num_steps: int,
                        temperature: float = 0.0,
                        rng=None,
                        timeout_s: float | None = None,
                        on_token=None, trace_id: str | None = None,
                        parent_span: str | None = None,
                        tenant: str | None = None,
                        adapter_id: str | None = None
                        ) -> concurrent.futures.Future:
        """Queue one LM continuation; returns a future resolving to a
        :class:`GenerateResult` (or raising ``Overloaded`` here /
        ``DeadlineExceeded`` on the future). ``prompt`` is 1-D ``[P]`` or
        ``[1, P]`` int tokens; greedy at ``temperature == 0``, else sampled
        with per-step keys drawn from ``rng`` (a ``torch.Generator``), or
        with ``rng`` given as the ``num_steps`` already-drawn int seeds
        (:func:`draw_step_seeds`; what a process replica relays).

        ``on_token(index, token)`` runs on the engine thread the moment
        each token's tick fetches (keep it non-blocking). The future
        supports ``cancel()`` while queued; once admitted it runs to
        completion.

        ``trace_id`` / ``parent_span`` thread end-to-end tracing through
        (recorded on the engine's spans when tracing is on, and in the
        request's jsonl row). ``tenant`` attributes the request (quotas and
        fair share when ``EngineCfg.tenants`` is set — ``QuotaExceeded``
        here when its budget is spent); ``adapter_id`` names a loaded LoRA
        adapter (``UnknownAdapter``, a ``ValueError``, when absent), which
        stays pinned until the request resolves."""
        req = self._make_lm_request(prompt, num_steps, temperature, rng,
                                    timeout_s, on_token, "interactive",
                                    trace_id=trace_id,
                                    parent_span=parent_span,
                                    tenant=tenant, adapter_id=adapter_id)
        try:
            self._offer("lm", req)
        except BaseException:
            self._release_req_resources(req)
            raise
        return req.future

    def _make_lm_request(self, prompt, num_steps, temperature, rng,
                         timeout_s, on_token, lane, trace_id=None,
                         parent_span=None, tenant=None,
                         adapter_id=None) -> "_LMRequest":
        if self._lm is None:
            raise ValueError("engine was built without an LM model")
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
        need = 0
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
        if self._draft_pool is not None:
            if (prompt.size + num_steps + self.cfg.spec_k
                    > self._draft.cfg.max_len):
                raise ValueError(
                    f"prompt {prompt.size} + steps {num_steps} + spec_k "
                    f"{self.cfg.spec_k} exceeds the draft model's max_len "
                    f"{self._draft.cfg.max_len}")
            dpool = self._draft_pool
            dp, dns = self._draft_admit_shape(prompt.size, num_steps)
            dneed = dpool.blocks_for(dpool.total_positions(dp, dns))
            dceil = dpool.n_blocks
            if lane == "batch":
                dceil -= dpool.interactive_reserve
            if dneed > dceil:
                raise ValueError(
                    f"request needs {dneed} draft KV blocks but the "
                    f"{lane} lane only ever has {dceil}")
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if temperature > 0.0 and rng is None:
            raise ValueError("sampling (temperature > 0) requires rng")
        keys = None
        if temperature > 0.0:
            if isinstance(rng, torch.Generator):
                keys = draw_step_seeds(rng, num_steps)
            else:
                keys = np.asarray(rng, np.int64).reshape(-1)
                if keys.size != num_steps:
                    raise ValueError(
                        f"rng as step seeds needs {num_steps} of them, got "
                        f"{keys.size}")
        now = time.monotonic()
        timeout = self.cfg.default_timeout_s if timeout_s is None else timeout_s
        # resources are acquired LAST, after every validation that can
        # refuse the request: pin the adapter (UnknownAdapter), then charge
        # the tenant quota (QuotaExceeded; the pin is returned on that
        # path). Both are held until the request RESOLVES and released
        # exactly once by _release_req_resources.
        adapter_slot, salt = 0, b""
        if adapter_id is not None:
            if self.adapters is None:
                raise UnknownAdapter(adapter_id, ())
            adapter_slot = self.adapters.pin(adapter_id)
            salt = self.adapters.salt_of(adapter_id)
        quota_blocks = quota_tokens = 0
        resolved = tenant
        if self.tenancy is not None:
            try:
                resolved = self.tenancy.charge(
                    tenant, need, num_steps,
                    retry_after_ms=self._retry_hint_ms(
                        "lm_batch" if lane == "batch" else "lm"))
                quota_blocks, quota_tokens = need, num_steps
            except QuotaExceeded as e:
                if adapter_id is not None:
                    self.adapters.unpin(adapter_id)
                self.metrics.count_labeled("tenant_sheds", "tenant",
                                           e.tenant)
                self.tenancy.note_shed(e.tenant)
                raise
        req = _LMRequest(prompt, num_steps, float(temperature), keys,
                         now + timeout if timeout else None, now,
                         on_token=on_token, lane=lane, trace_id=trace_id,
                         parent_span=parent_span, tenant=resolved,
                         adapter_id=adapter_id, adapter_slot=adapter_slot,
                         salt=salt)
        req.quota_blocks, req.quota_tokens = quota_blocks, quota_tokens
        return req

    def generate(self, prompt, num_steps: int, **kw) -> GenerateResult:
        """Synchronous :meth:`submit_generate`."""
        return self.submit_generate(prompt, num_steps, **kw).result()

    def submit_batch_item(self, prompt, num_steps: int,
                          temperature: float = 0.0, rng=None,
                          timeout_s: float | None = 0.0,
                          tenant: str | None = None,
                          adapter_id: str | None = None
                          ) -> concurrent.futures.Future:
        """Queue ONE batch-lane LM continuation — the per-item primitive a
        :class:`~ddw_tpu_torch.serve.lanes.BatchJob` pump feeds. Same
        tokens as :meth:`submit_generate` (the lane changes WHEN a stream
        runs, never what it computes), but it admits only behind an empty
        interactive queue and the block reserve, is preempted first, and
        carries no default deadline. Requires the paged pool."""
        if self._lm is not None and not isinstance(self.pool, BlockPool):
            raise ValueError("the batch lane requires the paged pool "
                             "(EngineCfg(paged=True))")
        req = self._make_lm_request(prompt, num_steps, temperature, rng,
                                    timeout_s, None, "batch",
                                    tenant=tenant, adapter_id=adapter_id)
        try:
            self._offer("lm_batch", req)
        except BaseException:
            self._release_req_resources(req)
            raise
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
        """Submit a bulk job as one :class:`~ddw_tpu_torch.serve.lanes.
        BatchJob` (returned immediately): per-item futures are pumped
        through the batch lane with a bounded in-flight window, per-item
        progress, and retry on replica failure — see
        :mod:`ddw_tpu_torch.serve.lanes`."""
        from ddw_tpu_torch.serve.lanes import start_batch_job

        return start_batch_job(self, items, kind=kind, **kw)

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
        bucket x group size, the decode chain at every row bucket, the spec
        draft and verify passes, the image batch buckets — which builds the
        depthwise kernel), so no live request pays a build or a first-call
        cost. Call before submitting: it drives the device from the
        caller's thread."""
        if self.pool is not None:
            buckets = [bucket_len(n, self._lm.cfg.max_len,
                                  self.cfg.min_bucket) for n in prompt_lens]
            if isinstance(self.pool, BlockPool):
                self.pool.warmup(buckets, max_group=self.pool.max_resident)
                if self._draft_pool is not None:
                    self._warmup_spec(prompt_lens)
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

    def _warmup_spec(self, prompt_lens) -> None:
        """The speculative program shapes: the draft pool's prefill
        buckets (it prefills ``len(eff) - 1`` tokens, so the shifted
        buckets too), the lagged draft chain, and the target's multi-token
        verify pass — each across the resident-bucket ladder."""
        dpool = self._draft_pool
        dlens = {max(n - 1, 1) for n in prompt_lens} | set(prompt_lens)
        dbuckets = sorted({bucket_len(n, self._draft.cfg.max_len,
                                      self.cfg.min_bucket) for n in dlens})
        for bucket in dbuckets:
            g = 1
            while True:
                dpool.prefill([None] * g, np.zeros((g, bucket), np.int32),
                              np.ones((g,), np.int32),
                              np.zeros((g,), np.float32),
                              np.zeros((g,), np.int64))
                if g >= dpool.max_resident:
                    break
                g = min(g * 2, dpool.max_resident)
        dpool.warmup_spec(self.cfg.spec_k, "draft")
        self.pool.warmup_spec(self.cfg.spec_k, "verify")

    def snapshot(self) -> dict[str, float]:
        return self.metrics.snapshot()

    # -- internals ----------------------------------------------------------
    def _offer(self, kind: str, req) -> None:
        if self._follower:
            raise RuntimeError("this rank follows rank 0 of the mesh's "
                               "model axis; submit there")
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
            if self.tenancy is not None:
                self.tenancy.note_shed(tenant)

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
                self._release_req_resources(req)
                self._fail_req(req, exc)
        if self.pool is not None:
            for req in self._slot_req.values():
                self._release_req_resources(req)
                self._fail_req(req, exc)
            self._slot_req.clear()

    def _release_req_resources(self, req) -> None:
        """Give back everything a request holds OUTSIDE the block pool —
        its adapter pin and its tenant quota charge — exactly once
        (``released`` flips; every resolution path calls this). Image
        requests carry neither and pass through untouched."""
        if getattr(req, "released", True):
            return
        req.released = True
        if req.adapter_id is not None and self.adapters is not None:
            try:
                self.adapters.unpin(req.adapter_id)
            except AdapterError:
                pass        # pool rebuilt under us (checkpoint swap)
        if self.tenancy is not None and (req.quota_blocks
                                         or req.quota_tokens):
            self.tenancy.release(req.tenant, req.quota_blocks,
                                 req.quota_tokens)
            req.quota_blocks = req.quota_tokens = 0

    def _shed(self, req, kind: str) -> None:
        self._release_req_resources(req)
        if req.future.cancelled():      # cancelled first: nothing to tell
            self.metrics.count_cancelled()
            return
        self.metrics.count_deadline()
        tenant = getattr(req, "tenant", None)
        if tenant is not None:
            self.metrics.count_labeled("tenant_sheds", "tenant", tenant)
            if self.tenancy is not None:
                self.tenancy.note_shed(tenant)
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
        self._release_req_resources(req)
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
            self._release_req_resources(req)
            self._fail_req(req, ReplicaFailed(
                "error", replica=self.replica_id,
                generation=self.generation, phase="admitted",
                emitted=getattr(req, "emitted", 0),
                forensics=fail.forensics))
        self._inflight_admit = []
        if self.pool is not None:
            for slot, req in list(self._slot_req.items()):
                self._release_req_resources(req)
                self._fail_req(req, ReplicaFailed(
                    "error", replica=self.replica_id,
                    generation=self.generation, phase="in_slot",
                    emitted=req.emitted, forensics=fail.forensics))
            self._slot_req.clear()
            self._cur[:] = 0
            self._prev[:] = 0
            self._temps[:] = 0.0
            self.pool.reset()
            if self._draft_pool is not None:
                self._draft_pool.reset()
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
        out = {
            "error": repr(exc),
            "traceback": traceback.format_exc(limit=12),
            "consecutive_errors": self._consecutive_errors,
            "last_tick_age_s": round(time.monotonic() - self._last_tick, 3),
            "busy_slots": len(self._slot_req) if self.pool is not None else 0,
            "queue_depth": self._ctrl.depth(),
        }
        if self._tracing:
            # the flight recorder: the ring's tail rides the failure, so
            # "what was the engine doing" survives the engine
            out["flight"] = self.tracer.tail(64)
            out["spans_dropped"] = self.tracer.spans_dropped
        return out

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
            self._release_req_resources(req)
            self._fail_req(req, ReplicaFailed(
                kind, replica=self.replica_id, generation=self.generation,
                phase="admitted", emitted=getattr(req, "emitted", 0),
                forensics=failure.forensics))
        self._inflight_admit = []
        if self.pool is not None:
            for req in self._slot_req.values():
                self._release_req_resources(req)
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
                self._release_req_resources(req)
                if req.future.cancelled():
                    self.metrics.count_cancelled()
                elif req.future.done():
                    pass
                elif getattr(req, "adapter_id", None) is not None:
                    # adapter slot + salt are REPLICA-LOCAL (a sibling may
                    # not hold this adapter at all): not salvageable
                    self._fail_req(req, ReplicaFailed(
                        kind, replica=self.replica_id,
                        generation=self.generation, phase="queued",
                        forensics=failure.forensics))
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

    def _fault(self, site: str) -> None:
        """Deterministic ``DDW_FAULT=serve:*`` hook (near-free when unset);
        the per-site invocation count resets each restart generation."""
        n = self._fault_n.get(site, 0)
        self._fault_n[site] = n + 1
        maybe_serve_fault(site, replica=self.replica_id, n=n,
                          gen=self.generation,
                          should_abort=self._stop.is_set)

    # -- tracing helpers (every call site guards on self._tracing) -----------
    def _trace_req(self, req, name: str, t0: float, t1: float,
                   **args) -> None:
        """One span in a request's causal chain (queue → prefill → decode),
        parented on the previous one; the request's deadline rides in the
        args so an SLO miss is readable off the trace alone."""
        if req.deadline is not None:
            args["deadline_ms"] = round((req.deadline - t1) * 1e3, 1)
        req.last_span = self.tracer.record_span(
            name, "serve", t0, t1, trace=req.trace_id,
            parent=req.last_span, tid="engine", args=args)

    def _trace_preempt(self, req, row: int, reason: str) -> None:
        self.tracer.instant(
            "preempt", "serve", trace=req.trace_id, parent=req.last_span,
            tid="engine", args={"row": row, "lane": req.lane,
                                "emitted": req.emitted, "reason": reason})

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
                if self._tracing and key in ("cow_copies",
                                             "prefix_hit_tokens"):
                    self.tracer.instant(f"pool.{key}", "pool", tid="pool",
                                        args={"n": delta})
            self._pool_stats_seen[key] = val
        self._sync_adapter_counters()
        gauges = pool.gauges()
        if self._tracing:
            free = gauges.get("blocks_free", 0.0)
            total = gauges.get("blocks_total", 0.0)
            if total and free / total < 0.1:
                self.tracer.instant(
                    "pool.alloc_pressure", "pool", tid="pool",
                    args={"free": int(free), "total": int(total)})
        gauges["batch_backlog"] = float(self._ctrl.depth("lm_batch")
                                        + self._ctrl.depth("image_batch"))
        if self._draft_pool is not None:
            gauges["spec_k_effective"] = float(self._spec_k_eff)
        self.metrics.set_gauges(gauges)

    def _sync_adapter_counters(self) -> None:
        """Mirror the adapter pool's monotonic counters into the engine
        metrics (same delta discipline as the block-pool stats)."""
        ad = self.adapters
        if ad is None:
            return
        for key, val in (("adapter_loads", ad.loads),
                         ("adapter_evictions", ad.evictions),
                         ("adapter_pins", ad.pin_events)):
            seen = self._pool_stats_seen.get(key, 0)
            delta = val - seen if val >= seen else val
            if delta > 0:
                self.metrics.count(key, delta)
            self._pool_stats_seen[key] = val

    def _vacate_row(self, row: int) -> _LMRequest:
        """Forget a preempted row's host state; returns its request."""
        req = self._slot_req.pop(row)
        self._cur[row] = 0
        self._prev[row] = 0
        self._temps[row] = 0.0
        return req

    def _preempt_batch_for_interactive(self) -> bool:
        """An interactive head under block or row pressure evicts the
        youngest resident BATCH stream by recompute; its request re-queues
        at the batch queue head and resumes token for token. False when no
        batch stream is resident."""
        row = self.pool.preempt_youngest(lane="batch")
        if row is None:
            return False
        if self._draft_pool is not None:
            self._draft_pool.release(row, preempted=True)
        req = self._vacate_row(row)
        if self._tracing:
            self._trace_preempt(req, row, "interactive_pressure")
        self._ctrl.requeue_front("lm_batch", req)
        return True

    def _pop_lane_paged(self, kind: str, lane: str, picked: list,
                        drain_only: bool) -> bool:
        """Head-first pop loop for one lane's queue into ``picked``.
        Interactive runs first and may preempt batch residents to fit its
        head; a FRESH batch head also needs an empty interactive queue, the
        reserve-aware block budget and ``batch_rows_headroom`` spare rows;
        a claimed (preempted) batch head re-admits on the plain row bound.
        With a draft pool, a head must fit both pools, and the draft row
        mirrors the target row."""
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
                    or not pool.can_admit(len(eff), ns, lane=lane)
                    or not self._draft_can_admit(len(eff), ns, lane)):
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
                if (not pool.can_admit(len(eff), ns, lane=lane)
                        or not self._draft_can_admit(len(eff), ns, lane)):
                    self._ctrl.requeue_front(kind, req)
                    break
            if not self._claim(req):
                worked = True
                continue
            try:
                row, hit = pool.admit(eff, ns, lane=lane,
                                      adapter_slot=req.adapter_slot,
                                      salt=req.salt)
            except OutOfBlocks:
                # overcommitted budget met a physically empty pool — admit()
                # unwound cleanly; head-of-line waits for releases
                self._ctrl.requeue_front(kind, req)
                break
            except BaseException:
                # a failed device dispatch (the CoW copy): every request
                # claimed so far must resolve with the failure
                self._inflight_admit = [r for r, *_ in picked] + [req]
                raise
            if self._draft_pool is not None:
                dp, dns = self._draft_admit_shape(len(eff), ns)
                try:
                    drow, _ = self._draft_pool.admit(eff[:dp], dns,
                                                     lane=lane)
                except OutOfBlocks:
                    pool.release(row)   # clean unwind: mirror preserved
                    self._ctrl.requeue_front(kind, req)
                    break
                except BaseException:
                    self._inflight_admit = [r for r, *_ in picked] + [req]
                    raise
                if drow != row:
                    raise AssertionError(
                        f"draft row {drow} diverged from target row {row}")
            picked.append((req, eff, row, hit))
        return worked

    def _draft_admit_shape(self, p: int, ns: int) -> tuple[int, int]:
        """Draft-pool admission geometry for an effective prompt of length
        ``p``: the draft lags the target one position (it has processed
        ``H[:-2]``), so it prefills ``eff[:-1]`` and needs positions for
        ``ns + spec_k + 1`` lag-pair + draft writes per stream. The
        ``p == 1`` edge prefills nothing — the lone prompt token's K/V is
        written by the first lagged S=2 draft step itself (the row is
        admitted over the full prompt and its write pointer rewound to 0
        via :meth:`BlockPool.set_filled`)."""
        k = self.cfg.spec_k
        if p >= 2:
            return p - 1, ns + k + 1
        return p, ns + k

    def _draft_can_admit(self, p: int, ns: int, lane: str) -> bool:
        if self._draft_pool is None:
            return True
        dp, dns = self._draft_admit_shape(p, ns)
        return self._draft_pool.can_admit(dp, dns, lane=lane)

    def _admit_lm_paged(self, drain_only: bool = False) -> bool:
        """Admission on free BLOCKS: pop queued requests head-first while
        the block budget accepts them, then prefill each request's uncovered
        SUFFIX in per-bucket groups (prefix-hit tokens never touch the
        device). Interactive first, then batch backfill; one prefill serves
        both lanes. ``drain_only`` admits only already-claimed (preempted)
        requests."""
        pool = self.pool
        worked = False
        if self._ctrl.depth("lm") > 0 and pool.free_slots > 0:
            self._fault("admit")     # admission boundary: nothing claimed
            #                          yet, queued work stays salvageable
        if self._ctrl.depth("lm_batch") > 0 and pool.free_slots > 0:
            self._fault("batch")     # batch admission boundary — the
            #                          mid-job chaos drill's kill site
        picked: list = []            # (req, eff_prompt, row, hit)
        worked |= self._pop_lane_paged("lm", "interactive", picked,
                                       drain_only)
        worked |= self._pop_lane_paged("lm_batch", "batch", picked,
                                       drain_only)
        if not picked:
            self._sync_pool_stats()
            return worked
        self._inflight_admit = [req for req, *_ in picked]
        if self._draft_pool is not None:
            self._prefill_draft(picked)
        groups: dict[int, list] = {}
        now = time.monotonic()
        for item in picked:
            req, eff, row, hit = item
            if req.emitted == 0:
                req.times.admitted = now
                if self._tracing:
                    self._trace_req(req, "queue", req.times.submitted, now,
                                    lane=req.lane, row=row,
                                    prefix_hit_tokens=int(hit))
            bucket = bucket_len(len(eff) - hit, self._lm.cfg.max_len,
                                self.cfg.min_bucket)
            groups.setdefault(bucket, []).append(item)
        for bucket, items in groups.items():
            self._fault("prefill")   # device-work boundary: this group is
            #                          claimed — a fault here fails it
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
            if self._tracing:
                self.tracer.record_span(
                    "prefill_group", "serve", t_pf, first, tid="engine",
                    args={"bucket": bucket, "n": len(items),
                          "suffix_lens": [int(t) for t in
                                          true_lens[:len(items)]]})
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
                if self._tracing:
                    self._trace_req(req, "prefill", t_pf, first,
                                    bucket=bucket,
                                    suffix_len=int(eff.size - hit),
                                    prefix_hit_tokens=int(hit),
                                    resumed=req.emitted > 0)
                if req.emitted == 0:
                    req.times.first_output = first
                    req.tokens.append(tok0)
                    req.emitted = 1
                    req.emit(0)
                # else: a resumed stream — tok0 re-derives its newest pick
                if req.emitted >= req.num_steps or \
                        self.cfg.role == "prefill":
                    # a prefill-role replica NEVER decodes: the request
                    # finishes at its first token (blocks stay registered
                    # for kv_export; the handoff path submits num_steps=1,
                    # so nothing is truncated on the gateway path)
                    pool.release(row)
                    if self._draft_pool is not None:
                        self._draft_pool.release(row)
                    self._finish_lm(req)
                else:
                    self._slot_req[row] = req
                    self._cur[row] = tok0
                    if self._draft_pool is not None:
                        # H = eff + [tok0]: the draft's lagged entry pair
                        # next tick is [eff[-1], tok0]
                        self._prev[row] = int(eff[-1])
                    self._temps[row] = req.temperature
        self._inflight_admit = []
        self._sync_pool_stats()
        return True

    def _prefill_draft(self, picked: list) -> None:
        """Mirror admissions into the draft pool: prefill each stream's
        ``eff[:-1]`` (grouped by suffix bucket like the target prefill —
        the draft never prefix-hits, so the whole shifted prompt is the
        suffix) and pin the lag invariant ``filled = len(eff) - 1``. The
        picked first tokens are discarded — only the K/V matters."""
        dpool = self._draft_pool
        dgroups: dict[int, list] = {}
        for req, eff, row, hit in picked:
            if len(eff) < 2:
                dpool.set_filled(row, 0)    # P == 1: nothing to prefill
                continue
            bucket = bucket_len(len(eff) - 1, self._draft.cfg.max_len,
                                self.cfg.min_bucket)
            dgroups.setdefault(bucket, []).append((eff, row))
        for bucket, items in dgroups.items():
            g = batch_bucket(len(items), dpool.max_resident)
            rows: list = [None] * g
            prompts = np.zeros((g, bucket), np.int32)
            true_lens = np.ones((g,), np.int32)
            for i, (eff, row) in enumerate(items):
                prompts[i] = pad_to_bucket(eff[None, :-1], bucket)[0]
                true_lens[i] = eff.size - 1
                rows[i] = row
            dpool.prefill(rows, prompts, true_lens,
                          np.zeros((g,), np.float32),
                          np.zeros((g,), np.int64))
            for _, row in items:
                dpool.note_prefilled(row)

    def _admit_lm(self) -> bool:
        draining = self._draining.is_set()
        if isinstance(self.pool, BlockPool):
            return self._admit_lm_paged(drain_only=draining)
        if draining:
            return False        # draining: finish slots, admit nothing
        free = self.pool.free_slots
        if free == 0:
            return False
        if self._ctrl.depth("lm") > 0:
            self._fault("admit")     # admission boundary: nothing claimed
            #                          yet, queued work stays salvageable
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
            if self._tracing:
                self._trace_req(req, "queue", req.times.submitted, now,
                                lane=req.lane)
            bucket = bucket_len(req.prompt.size, self._lm.cfg.max_len,
                                self.cfg.min_bucket)
            groups.setdefault(bucket, []).append(req)
        for bucket, reqs in groups.items():
            self._fault("prefill")   # device-work boundary: this group is
            #                          claimed — a fault here fails it
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
            t_pf = time.monotonic()
            cache_g, toks = self.pool.prefill(prompts, true_lens, temps,
                                              keys)
            first = time.monotonic()              # fetched: the TTFT barrier
            self.metrics.count("prefills")
            if self._tracing:
                self.tracer.record_span(
                    "prefill_group", "serve", t_pf, first, tid="engine",
                    args={"bucket": bucket, "n": len(reqs)})
            for i, req in enumerate(reqs):
                slot = self.pool.acquire()
                self.pool.insert(slot, cache_g, req.prompt.size, row=i)
                if self._tracing:
                    self._trace_req(req, "prefill", t_pf, first,
                                    bucket=bucket,
                                    suffix_len=int(req.prompt.size))
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
        if self._draft_pool is not None:
            return self._spec_tick()
        if not self._slot_req:
            return False
        self._fault("decode")
        t_tick = time.monotonic() if self._tracing else 0.0
        k = self.cfg.steps_per_tick
        if isinstance(self.pool, BlockPool):
            # on-demand block allocation for this tick; exhaustion (only
            # with block_overcommit > 1) preempts by recompute — batch
            # streams first, then the youngest interactive — and requests
            # go back to their lane's queue head with tokens intact
            for row in self.pool.prepare_tick(k):
                req = self._vacate_row(row)
                if self._tracing:
                    self._trace_preempt(req, row, "blocks")
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
        rows_live = len(self._slot_req)
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
        if self._tracing:
            self.tracer.record_span(
                "tick", "serve", t_tick, time.monotonic(), tid="engine",
                args={"rows": rows_live, "steps": k,
                      "bucket": int(getattr(self.pool,
                                            "last_decode_bucket", 0))})
        self._sync_pool_stats()
        return True

    def _spec_prepare(self, k1: int) -> list[int]:
        """Joint tick allocation across the TARGET and DRAFT pools: both
        write up to ``k1 = spec_k + 1`` positions this tick, and a victim
        must vacate BOTH (the row mirror), so the engine drives
        :meth:`BlockPool.extend_row` itself instead of each pool's own
        :meth:`prepare_tick`. Victim policy is identical (batch before
        interactive, youngest first) via :meth:`BlockPool.stream_order`;
        exhaustion is only reachable with ``block_overcommit > 1``.
        Returns the preempted rows for requeue."""
        pool, dpool = self.pool, self._draft_pool
        order = {row: pool.stream_order(row) for row in self._slot_req}
        victims: list[int] = []
        vset: set[int] = set()
        for row in sorted(order, key=order.get):
            if row in vset:
                continue
            while True:
                try:
                    pool.extend_row(row, k1)
                    dpool.extend_row(row, k1)
                    break
                except OutOfBlocks:
                    victim = max((r for r in order if r not in vset),
                                 key=order.get)
                    pool.release(victim, preempted=True)
                    dpool.release(victim, preempted=True)
                    victims.append(victim)
                    vset.add(victim)
                    if victim == row:
                        break
        return victims

    def _spec_tick(self) -> bool:
        """One speculative decode tick (``spec_k > 0``): the draft pool
        proposes k tokens per live stream (one lagged S=2 step + k-1 single
        steps), the target pool verifies all k+1 positions in ONE
        multi-token pass, and drafts are accepted while they match the
        target's own picks under the ORIGINAL per-step seeds — so every
        emitted token is by induction exactly what spec-off decode would
        have picked, for greedy and seeded sampling alike. Both pools then
        advance by only the accepted positions (:meth:`BlockPool.
        commit_spec` rolls the rejected writes back and frees their
        blocks). Streaming sees each accepted token exactly once."""
        if not self._slot_req:
            return False
        self._fault("decode")
        t_tick = time.monotonic() if self._tracing else 0.0
        # the auto-tuned EFFECTIVE width: admission always budgets the
        # configured worst case (_draft_admit_shape), so any k <= spec_k
        # is admission-safe
        k = self._spec_k_eff
        pool, dpool = self.pool, self._draft_pool
        for row in self._spec_prepare(k + 1):
            req = self._vacate_row(row)
            if self._tracing:
                self._trace_preempt(req, row, "blocks")
            self._ctrl.requeue_front(
                "lm_batch" if req.lane == "batch" else "lm", req)
        if not self._slot_req:
            self._sync_pool_stats()
            return True
        vkeys = np.zeros((self._n_rows, k + 1), np.int64)
        for row, req in self._slot_req.items():
            if req.keys is not None:
                ks = req.keys[req.emitted:req.emitted + k + 1]
                vkeys[row, :len(ks)] = ks
        # draft proposal j is the candidate for step emitted+j, so it
        # samples with THAT step's seed — a self-draft then reproduces the
        # target's own picks and acceptance is exactly 1
        drafts = dpool.spec_draft(self._prev, self._cur, self._temps,
                                  vkeys[:, :k])
        vtoks = np.concatenate(
            [self._cur[:, None], drafts.astype(np.int32)], axis=1)
        picks = pool.spec_verify(vtoks, self._temps, vkeys)
        self.metrics.count("decode_ticks")
        finished = []
        rows_live = len(self._slot_req)
        t_proposed = t_accepted = t_bonus = 0
        for row, req in self._slot_req.items():
            m = match_length(drafts[row], picks[row])
            # m accepted drafts + the target's own pick for position m
            # (the "bonus" — a free correction/extension either way)
            remaining = req.num_steps - req.emitted
            take = min(m + 1, remaining)
            start = req.emitted
            req.tokens.extend(int(t) for t in picks[row, :take])
            req.emitted += take
            req.ticks += 1
            req.emit(start)
            # proposals past the request's horizon were never candidates —
            # they are clipped, not rejected (a matching self-draft keeps
            # acceptance at exactly 1.0 through its final short tick)
            usable = min(k, remaining)
            accepted = min(m, take)
            self.metrics.count("spec_proposed", usable)
            self.metrics.count("spec_accepted", accepted)
            self.metrics.count("spec_rejected", usable - accepted)
            t_proposed += usable
            t_accepted += accepted
            if take == m + 1:
                self.metrics.count("spec_bonus")
                t_bonus += 1
            pool.commit_spec(row, take)
            dpool.commit_spec(row, take)
            if req.emitted >= req.num_steps:
                finished.append(row)
            else:
                # picked history grew by take: H' = H + picks[:take]
                self._prev[row] = (int(picks[row, take - 2])
                                   if take >= 2 else self._cur[row])
                self._cur[row] = int(picks[row, take - 1])
        for row in finished:
            req = self._slot_req.pop(row)
            pool.release(row)
            dpool.release(row)
            self._temps[row] = 0.0
            self._cur[row] = 0
            self._prev[row] = 0
            self._finish_lm(req)
        if t_proposed:
            # bounded EWMA controller over live acceptance: sustained
            # rejections (< 0.5) step the effective width down toward 1,
            # sustained acceptance (> 0.8) steps it back up toward spec_k —
            # one step per tick
            rate = t_accepted / t_proposed
            self._spec_accept_ewma = (0.8 * self._spec_accept_ewma
                                      + 0.2 * rate)
            if self._spec_accept_ewma < 0.5 and self._spec_k_eff > 1:
                self._spec_k_eff -= 1
            elif (self._spec_accept_ewma > 0.8
                  and self._spec_k_eff < self.cfg.spec_k):
                self._spec_k_eff += 1
        if self._tracing:
            self.tracer.record_span(
                "spec_tick", "serve", t_tick, time.monotonic(),
                tid="engine",
                args={"rows": rows_live, "proposed": t_proposed,
                      "accepted": t_accepted, "bonus": t_bonus,
                      "spec_k_effective": k})
        self._sync_pool_stats()
        return True

    def _finish_lm(self, req: _LMRequest) -> None:
        self._release_req_resources(req)
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
            if self.tenancy is not None:
                self.tenancy.note_completed(req.tenant, req.num_steps)
        if self._telemetry and req.lane != "batch":
            self.telem.observe("serve.ttft_ms", rec.ttft_ms)
            self.telem.observe("serve.queue_ms", rec.queue_ms)
            self.telem.observe("serve.total_ms", rec.total_ms)
            if req.tenant is not None:
                # the tenant-attributed SLO feed tenant_objectives() reads
                self.telem.observe(
                    f"serve.tenant.{req.tenant}.ttft_ms", rec.ttft_ms)
        if self._tracing:
            self._trace_req(req, "decode", t.first_output, t.done,
                            tokens=req.num_steps, ticks=req.ticks,
                            lane=req.lane)
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
        self._fault("admit")
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
        self._fault("batch")    # batch admission boundary (chaos drills)
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
            if self._telemetry and req.lane != "batch":
                self.telem.observe("serve.ttft_ms", rec.ttft_ms)
                self.telem.observe("serve.queue_ms", rec.queue_ms)
                self.telem.observe("serve.total_ms", rec.total_ms)
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
