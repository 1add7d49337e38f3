"""SLO metrics for the serving engine — the port of
``ddw_tpu.serve.metrics`` (host logic, copied): queue time, TTFT, latency
tails.

Training runs are first-class tracked artifacts (``tracking.Run`` holds the
loss curves); this
module gives serving runs the same standing. The engine records one
:class:`RequestRecord` per completed request and counters for every shed;
:meth:`EngineMetrics.snapshot` reduces them to the numbers an SLO is
written against — p50/p95/p99 of queue time, time-to-first-token and total
latency, aggregate tokens/sec — and :meth:`EngineMetrics.log_to` exports
them through a tracker run (metrics + a ``serve_requests.jsonl`` artifact
with the raw per-request rows, so tails can be re-sliced after the fact).

Percentiles interpolate (``np.percentile``) — with few samples, indexing
``int(0.99 * n)`` lands on the max and overstates tail fidelity (the same
rule ``tools/serving_curve.py`` applies to its p90s).

Two consumers beyond the tracker share this module:

- the HTTP gateway's ``/metrics`` endpoint renders the same accumulators in
  Prometheus text exposition format (:func:`render_prometheus` — counters,
  gauges, and latency histograms over a fixed ms bucket ladder), merged
  across every replica of a ``ReplicaSet`` so a scraper sees fleet totals;
- :meth:`EngineMetrics.stream_to` appends one ``serve_requests.jsonl`` line
  per completed request (flushed immediately), so a crashed or SIGKILLed
  server still leaves its request forensics on disk instead of losing them
  with the ``stop()`` that never ran.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
import time

import numpy as np

from ddw_tpu_torch.obs.telemetry import bucket_index, bucket_quantile

QUANTILES = (50, 95, 99)

# Prometheus histogram ladder (ms) — geometric-ish 1-2.5-5 decades wide
# enough for CPU smoke and chip serving alike; le="+Inf" is implicit.
LATENCY_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 5000.0, 10000.0)


@dataclasses.dataclass
class RequestRecord:
    """One completed request, host-clock timeline in monotonic seconds."""

    kind: str                  # "lm" | "image"
    submitted: float
    admitted: float            # dequeued and bound to device work
    first_output: float        # first token (LM) / batch completion (image)
    done: float
    tokens: int = 0            # generated tokens (LM); 0 for image
    lane: str = "interactive"  # "interactive" | "batch" — latency tails
    #                            are computed over interactive records only
    #                            (batch has a throughput SLO, not a latency
    #                            one; folding its queue time into the tails
    #                            would poison the interactive pin)
    trace_id: str = ""         # joins this row to its spans in the obs
    #                            trace (docs/observability.md, "joined
    #                            schema"); "" when tracing was off

    @property
    def queue_ms(self) -> float:
        return (self.admitted - self.submitted) * 1e3

    @property
    def ttft_ms(self) -> float:
        return (self.first_output - self.submitted) * 1e3

    @property
    def total_ms(self) -> float:
        return (self.done - self.submitted) * 1e3

    def to_dict(self) -> dict:
        return {"kind": self.kind, "lane": self.lane,
                "queue_ms": round(self.queue_ms, 3),
                "ttft_ms": round(self.ttft_ms, 3),
                "total_ms": round(self.total_ms, 3), "tokens": self.tokens,
                "trace_id": self.trace_id}


class EngineMetrics:
    """Thread-safe accumulator: the engine loop records, any thread reads.

    Memory is BOUNDED for week-long runs: raw :class:`RequestRecord` rows
    live in a drop-oldest deque of ``max_records`` (evictions counted in
    ``records_evicted``, never silent), while totals (``completed``,
    ``tokens_out``, ...) and the fixed-ladder latency histograms
    accumulate exactly forever. While nothing has been evicted,
    percentiles interpolate over the raw rows (``np.percentile``); after
    the first eviction they fall back to histogram interpolation over the
    whole run's ladder counts — tests pin the fallback p99 within one
    ladder bucket of the exact value.
    """

    def __init__(self, clock=time.monotonic, max_records: int | None = 4096):
        self._clock = clock
        self._lock = threading.Lock()
        self._records: collections.deque = collections.deque(
            maxlen=max_records)
        self.completed = 0         # requests finished (both lanes)
        self.tokens_out = 0        # generated LM tokens (both lanes)
        self.batch_items = 0       # batch-lane requests finished
        self.batch_tokens_out = 0  # generated LM tokens, batch lane
        self.records_evicted = 0   # raw rows dropped from the bounded deque
        # accumulated fixed-ladder histograms, one per latency family per
        # lane class — exact count/sum/max ride along so means and the
        # Prometheus exposition stay exact under eviction
        self._hists = {(name, lane): [0] * (len(LATENCY_BUCKETS_MS) + 1)
                       for name in _HISTOGRAMS
                       for lane in ("interactive", "batch")}
        self._hist_sum = {k: 0.0 for k in self._hists}
        self._hist_max = {k: 0.0 for k in self._hists}
        self.shed_overloaded = 0
        self.shed_deadline = 0
        self.cancelled = 0         # dropped via Future.cancel() while queued
        self.decode_ticks = 0      # chained decode dispatches
        self.prefills = 0
        self.image_batches = 0
        self.loop_errors = 0       # recoverable engine-loop errors survived
        self.failovers = 0         # sibling requests adopted after a
        #                            replica death (counted at the adopter)
        # paged-KV accumulators (ddw_tpu.serve.blocks.BlockPool)
        self.preemptions = 0       # streams evicted mid-decode for blocks
        self.batch_preemptions = 0  # the subset that were BATCH-lane
        #                            streams (evicted first, by contract)
        self.cow_copies = 0        # copy-on-write block clones
        self.prefix_hit_blocks = 0   # prompt blocks served from the cache
        self.prefix_miss_blocks = 0  # prompt blocks that had to prefill
        self.prefix_hit_tokens = 0   # prompt tokens whose prefill was skipped
        self.decode_rows_skipped = 0  # resident rows a bucketed decode tick
        #                            did NOT dispatch (pow2 live-row bucket)
        # speculative decoding (ddw_tpu.serve.engine._spec_tick): with
        # spec_k > 0 every decode tick is one draft+verify dispatch pair,
        # so tokens-per-tick derives as (accepted + bonus) / decode_ticks
        self.spec_proposed = 0     # draft tokens proposed (spec_k / stream
        #                            / tick)
        self.spec_accepted = 0     # proposals that matched the target's
        #                            own pick and were emitted
        self.spec_rejected = 0     # proposals rolled back (KV freed)
        self.spec_bonus = 0        # target-pick tokens emitted by verify
        #                            passes — the free k+1-th token on full
        #                            acceptance, the correction otherwise
        # fleet prefix cache (ddw_tpu.gateway.prefix_index)
        self.routed_cache_hit = 0    # requests routed to a prefix holder
        self.routed_wait_override = 0  # holder skipped: projected wait made
        #                            a cold prefill elsewhere cheaper
        self.warm_replays = 0        # hot prefixes replayed into a recycled
        #                            replica before readmission
        self.export_errors = 0     # serve_requests.jsonl write failures —
        #                            the stream re-arms on the next record,
        #                            so this counts rows at risk, not a
        #                            permanently dead exporter
        # tensor-parallel serving (EngineCfg.tp > 1; both stay 0 at tp=1)
        self.tp_dispatches = 0     # sharded device dispatches (prefill /
        #                            decode chain / spec draft / verify)
        self.tp_dispatch_us = 0    # accumulated wall-µs of those dispatches
        #                            through the result barrier — ÷
        #                            tp_dispatches = per-dispatch collective
        #                            cost (the spec×TP amortization number)
        # rollout lifecycle (ddw_tpu.deploy; incremented on the fleet-level
        # metrics a ReplicaSet owns, so they survive replica replacement)
        self.canary_promoted = 0   # canary verdicts that continued the roll
        self.canary_rejected = 0   # canary verdicts that restaged old weights
        self.surge_spawns = 0      # spawn-before-drain replacements landed
        self.journal_resumes = 0   # rollouts resumed from a journal after a
        #                            gateway restart (reconciler path)
        # fleet autoscaling (ddw_tpu.autoscale; fleet-level like the rollout
        # counters — membership changes must never reset them)
        self.scale_outs = 0        # replicas added by the autoscaler
        self.scale_ins = 0         # replicas drained and retired by it
        self.autoscale_blocked = 0  # decisions deferred because a rollout
        #                            held the deploy lock (counted, not raced)
        # prefill/decode disaggregation (docs/serving.md "Disaggregated
        # prefill/decode"): block migration counts land on the IMPORTING
        # engine (so a prefix-warm receiver that skipped payload blocks
        # shows a smaller delta); the handoff pair lands on the fleet
        # metrics the gateway's ReplicaSet owns
        self.kv_blocks_migrated = 0  # KV blocks landed via kv_import
        self.kv_bytes_migrated = 0   # payload bytes of those blocks
        self.handoffs = 0            # prefill→decode migrations completed
        self.handoff_ms = 0          # accumulated wall-ms of the handoff
        #                            stage (1-step prefill + export +
        #                            import) — ÷ handoffs = per-handoff cost
        # multi-tenant serving (ddw_tpu.serve.tenancy / .adapters). The
        # aggregates below are plain counters; the per-tenant breakdown
        # lives in _labeled cells keyed (family, label, value) and renders
        # as ddw_serve_<family>_total{<label>="<value>"} beside the
        # unlabeled fleet total. count_labeled() bumps BOTH in one call so
        # the aggregate is always the sum of its cells.
        self.tenant_requests = 0   # requests completed, attributed by tenant
        self.tenant_tokens = 0     # generated tokens, attributed by tenant
        self.tenant_sheds = 0      # sheds (overload/deadline/quota) by tenant
        self.adapter_loads = 0     # LoRA adapters landed in the pool
        self.adapter_evictions = 0  # idle adapters LRU-evicted from slots
        self.adapter_pins = 0      # adapter pin events (request → slot)
        self._labeled: dict[tuple[str, str, str], float] = {}
        self._gauges: dict[str, float] = {}  # live block-pool state, pushed
        #                            by the engine loop (free/used blocks...)
        self._first_admit: float | None = None
        self._last_done: float | None = None
        self._sink = None          # incremental serve_requests.jsonl stream
        self._sink_path: str | None = None  # re-arm target after an error

    # -- recording (engine side) -------------------------------------------
    def record(self, rec: RequestRecord) -> None:
        with self._lock:
            if (self._records.maxlen is not None
                    and len(self._records) == self._records.maxlen):
                self.records_evicted += 1
            self._records.append(rec)
            self.completed += 1
            self.tokens_out += rec.tokens
            lane = "batch" if rec.lane == "batch" else "interactive"
            if lane == "batch":
                self.batch_items += 1
                self.batch_tokens_out += rec.tokens
            for name in _HISTOGRAMS:
                v = getattr(rec, name)
                key = (name, lane)
                self._hists[key][bucket_index(v, LATENCY_BUCKETS_MS)] += 1
                self._hist_sum[key] += v
                if v > self._hist_max[key]:
                    self._hist_max[key] = v
            if self._first_admit is None or rec.admitted < self._first_admit:
                self._first_admit = rec.admitted
            if self._last_done is None or rec.done > self._last_done:
                self._last_done = rec.done
            if self._sink is None and self._sink_path is not None:
                # a previous write failed: re-arm on this record (append
                # mode — rows written before the error are kept) instead
                # of silently dropping every row for the rest of the run
                try:
                    self._sink = open(self._sink_path, "a")
                except OSError:
                    self.export_errors += 1
            if self._sink is not None:
                try:
                    self._sink.write(json.dumps(rec.to_dict()) + "\n")
                    self._sink.flush()
                except OSError:
                    self.export_errors += 1
                    try:
                        self._sink.close()
                    except OSError:
                        pass
                    self._sink = None   # disk hiccup; keep serving and
                    #                     retry on the next record

    def count_overloaded(self) -> None:
        with self._lock:
            self.shed_overloaded += 1

    def count_deadline(self) -> None:
        with self._lock:
            self.shed_deadline += 1

    def count_cancelled(self) -> None:
        with self._lock:
            self.cancelled += 1

    # -- incremental on-disk stream ----------------------------------------
    def stream_to(self, path: str) -> None:
        """Append every subsequent :meth:`record` to ``path`` as one flushed
        JSONL line — request forensics survive a crash or SIGKILL that never
        reaches :meth:`log_to`. Rows already recorded are written out first
        so the file is complete from whenever streaming starts."""
        with self._lock:
            if self._sink is not None:
                return
            try:
                sink = open(path, "w")
                for rec in self._records:
                    sink.write(json.dumps(rec.to_dict()) + "\n")
                sink.flush()
            except OSError:
                return              # non-writable ranks keep the path only
            self._sink = sink
            self._sink_path = path  # re-arm target after a mid-run error

    def close_stream(self) -> None:
        with self._lock:
            self._sink_path = None  # intentional close must not re-arm
            if self._sink is not None:
                try:
                    self._sink.close()
                except OSError:
                    pass
                self._sink = None

    def count(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def count_labeled(self, field: str, label: str, value: str,
                      n: int = 1) -> None:
        """Bump a labeled cell AND its unlabeled aggregate in one call —
        ``count_labeled("tenant_sheds", "tenant", "acme")`` keeps
        ``tenant_sheds`` equal to the sum over its cells by construction.
        ``field`` must be a :data:`_COUNTER_HELP` counter."""
        with self._lock:
            setattr(self, field, getattr(self, field) + n)
            key = (field, label, str(value))
            self._labeled[key] = self._labeled.get(key, 0.0) + n

    def labeled_view(self) -> dict[tuple[str, str, str], float]:
        """Every labeled cell in one read: ``{(family, label, value): n}`` —
        the per-tenant attribution feed (load_gen cross-checks its offline
        recount against this via ``/stats``)."""
        with self._lock:
            return dict(self._labeled)

    def set_gauges(self, gauges: dict[str, float]) -> None:
        """Replace the live gauge set (block-pool free/used/resident state,
        pushed by the engine loop each tick). Gauges render as
        ``serve.<name>`` in :meth:`snapshot` and ``ddw_serve_<name>`` in
        the Prometheus exposition; :func:`merge_metrics` SUMS them across
        replicas (they are all counts, so fleet totals are meaningful —
        ratios like fragmentation are derived at render time)."""
        with self._lock:
            self._gauges = dict(gauges)

    # -- reading -----------------------------------------------------------
    def snapshot(self) -> dict[str, float]:
        """Flat ``serve.*`` metric dict — the SLO view. Keys are stable;
        latency keys appear only once at least one request completed."""
        with self._lock:
            recs = list(self._records)
            evicted = self.records_evicted
            out: dict[str, float] = {
                "serve.completed": float(self.completed),
                "serve.records_evicted": float(evicted),
                "serve.shed_overloaded": float(self.shed_overloaded),
                "serve.shed_deadline": float(self.shed_deadline),
                "serve.cancelled": float(self.cancelled),
                "serve.decode_ticks": float(self.decode_ticks),
                "serve.prefills": float(self.prefills),
                "serve.image_batches": float(self.image_batches),
                "serve.loop_errors": float(self.loop_errors),
                "serve.failovers": float(self.failovers),
                "serve.preemptions": float(self.preemptions),
                "serve.batch_preemptions": float(self.batch_preemptions),
                "serve.cow_copies": float(self.cow_copies),
                "serve.prefix_hit_blocks": float(self.prefix_hit_blocks),
                "serve.prefix_miss_blocks": float(self.prefix_miss_blocks),
                "serve.prefix_hit_tokens": float(self.prefix_hit_tokens),
                "serve.decode_rows_skipped": float(self.decode_rows_skipped),
                "serve.spec_proposed": float(self.spec_proposed),
                "serve.spec_accepted": float(self.spec_accepted),
                "serve.spec_rejected": float(self.spec_rejected),
                "serve.spec_bonus": float(self.spec_bonus),
                "serve.routed_cache_hit": float(self.routed_cache_hit),
                "serve.routed_wait_override": float(
                    self.routed_wait_override),
                "serve.warm_replays": float(self.warm_replays),
                "serve.export_errors": float(self.export_errors),
                "serve.tp_dispatches": float(self.tp_dispatches),
                "serve.tp_dispatch_us": float(self.tp_dispatch_us),
                "serve.canary_promoted": float(self.canary_promoted),
                "serve.canary_rejected": float(self.canary_rejected),
                "serve.surge_spawns": float(self.surge_spawns),
                "serve.journal_resumes": float(self.journal_resumes),
                "serve.scale_outs": float(self.scale_outs),
                "serve.scale_ins": float(self.scale_ins),
                "serve.autoscale_blocked": float(self.autoscale_blocked),
                "serve.kv_blocks_migrated": float(self.kv_blocks_migrated),
                "serve.kv_bytes_migrated": float(self.kv_bytes_migrated),
                "serve.handoffs": float(self.handoffs),
                "serve.handoff_ms": float(self.handoff_ms),
                "serve.tenant_requests": float(self.tenant_requests),
                "serve.tenant_tokens": float(self.tenant_tokens),
                "serve.tenant_sheds": float(self.tenant_sheds),
                "serve.adapter_loads": float(self.adapter_loads),
                "serve.adapter_evictions": float(self.adapter_evictions),
                "serve.adapter_pins": float(self.adapter_pins),
            }
            for (fam, label, value), v in sorted(self._labeled.items()):
                out[f'serve.{fam}{{{label}="{value}"}}'] = float(v)
            looked = self.prefix_hit_blocks + self.prefix_miss_blocks
            out["serve.prefix_hit_rate"] = (
                self.prefix_hit_blocks / looked if looked else 0.0)
            out["serve.spec_acceptance_rate"] = (
                self.spec_accepted / self.spec_proposed
                if self.spec_proposed else 0.0)
            out["serve.spec_tokens_per_tick"] = (
                (self.spec_accepted + self.spec_bonus) / self.decode_ticks
                if self.spec_proposed and self.decode_ticks else 0.0)
            out["serve.tp_dispatch_cost_us"] = (
                self.tp_dispatch_us / self.tp_dispatches
                if self.tp_dispatches else 0.0)
            for name, val in self._gauges.items():
                out[f"serve.{name}"] = float(val)
            cap = self._gauges.get("block_tokens_capacity", 0.0)
            if cap:
                # internal fragmentation of the blocks in use: capacity
                # reserved minus tokens actually resident (prefix sharing
                # can push this negative — clamp; that IS the sharing win)
                out["serve.block_fragmentation_pct"] = max(
                    0.0, 100.0 * (1.0 - self._gauges.get(
                        "block_tokens_used", 0.0) / cap))
            reserve = self._gauges.get("interactive_reserve_blocks", 0.0)
            if reserve:
                # derived from the summable gauge pair so the fleet-merged
                # view stays meaningful (ratios never merge directly)
                out["serve.reserve_occupancy_pct"] = 100.0 * (
                    1.0 - self._gauges.get("reserve_free_blocks", 0.0)
                    / reserve)
            first, last = self._first_admit, self._last_done
            tokens = self.tokens_out
            n_done = self.completed
            ihists = {name: (list(self._hists[(name, "interactive")]),
                             self._hist_sum[(name, "interactive")])
                      for name in _HISTOGRAMS}
        if not n_done:
            return out
        # latency tails are an INTERACTIVE SLO (see RequestRecord.lane)
        irecs = [r for r in recs if r.lane != "batch"]
        brecs = [r for r in recs if r.lane == "batch"]
        if evicted == 0:
            if irecs:
                for name, vals in (("queue_ms", [r.queue_ms for r in irecs]),
                                   ("ttft_ms", [r.ttft_ms for r in irecs]),
                                   ("total_ms", [r.total_ms for r in irecs])):
                    arr = np.asarray(vals, np.float64)
                    for q in QUANTILES:
                        out[f"serve.{name}_p{q}"] = float(
                            np.percentile(arr, q))
                    out[f"serve.{name}_mean"] = float(arr.mean())
        else:
            # rows were evicted: the retained deque is only a suffix of
            # the run — tails come from the accumulated whole-run ladder
            # (p99 pinned within one bucket of exact), means stay exact
            for name, (counts, total_sum) in ihists.items():
                total = sum(counts)
                if not total:
                    continue
                for q in QUANTILES:
                    out[f"serve.{name}_p{q}"] = bucket_quantile(
                        counts, q, LATENCY_BUCKETS_MS)
                out[f"serve.{name}_mean"] = total_sum / total
        out["serve.tokens_out"] = float(tokens)
        if tokens and last is not None and last > first:
            # aggregate decode throughput over the busy window — the number
            # the continuous-batching claim is judged by. Includes BOTH
            # lanes: device tokens are device tokens.
            out["serve.tokens_per_sec"] = tokens / (last - first)
        out["serve.batch_items"] = float(self.batch_items)
        if self.batch_items:
            out["serve.batch_tokens_out"] = float(self.batch_tokens_out)
        if brecs:
            # items/sec spans the RETAINED batch rows' busy window — under
            # eviction this is the recent window, which is what a live
            # throughput SLO wants anyway
            b0 = min(r.admitted for r in brecs)
            b1 = max(r.done for r in brecs)
            if b1 > b0:
                out["serve.batch_items_per_sec"] = len(brecs) / (b1 - b0)
        return out

    def counters_view(self) -> dict[str, float]:
        """Every counter in one cheap read (no percentile math) — the
        telemetry sampler's feed; names match :data:`_COUNTER_HELP`."""
        with self._lock:
            return {name: float(getattr(self, name))
                    for name, _ in _COUNTER_HELP}

    def gauges_view(self) -> dict[str, float]:
        """The live gauge set as last pushed by the engine loop."""
        with self._lock:
            return dict(self._gauges)

    def records(self) -> list[RequestRecord]:
        with self._lock:
            return list(self._records)

    def prometheus(self) -> str:
        """This engine's accumulators in Prometheus text exposition format
        (:func:`render_prometheus` merges several for a replica fleet)."""
        return render_prometheus([self])

    # -- export ------------------------------------------------------------
    def log_to(self, run, step: int = 0) -> None:
        """Write the snapshot as run metrics and the raw per-request rows as
        a ``serve_requests.jsonl`` artifact (rank-0 discipline is the Run's).
        With :meth:`stream_to` active the artifact is already on disk row by
        row — only the metrics snapshot is written here."""
        run.log_metrics(self.snapshot(), step=step)
        with self._lock:
            streaming = self._sink is not None
        if streaming:
            return
        rows = self.records()
        art = run.artifact_dir("serving")
        path = os.path.join(art, "serve_requests.jsonl")
        try:
            with open(path, "w") as f:
                for r in rows:
                    f.write(json.dumps(r.to_dict()) + "\n")
        except OSError:
            pass  # non-writable ranks get a path but no directory


# -- Prometheus text exposition ---------------------------------------------

_COUNTER_HELP = (
    ("completed", "Requests completed successfully."),
    ("shed_overloaded", "Submissions refused at the door (queue full)."),
    ("shed_deadline", "Queued requests shed after their deadline passed."),
    ("cancelled", "Queued requests dropped via Future.cancel()."),
    ("prefills", "Grouped LM prefill dispatches."),
    ("decode_ticks", "Chained slot-decode dispatches."),
    ("image_batches", "Dynamic-batched image apply dispatches."),
    ("loop_errors", "Recoverable engine-loop errors survived."),
    ("failovers", "Requests adopted from a failed sibling replica."),
    ("preemptions", "Streams evicted mid-decode for blocks (recomputed)."),
    ("batch_preemptions", "Batch-lane streams preempted for interactive "
     "pressure (evicted before any interactive stream)."),
    ("cow_copies", "Copy-on-write KV block clones."),
    ("prefix_hit_blocks", "Prompt KV blocks served from the prefix cache."),
    ("prefix_miss_blocks", "Prompt KV blocks that had to prefill."),
    ("prefix_hit_tokens", "Prompt tokens whose prefill compute was skipped."),
    ("decode_rows_skipped", "Resident rows bucketed decode ticks did not "
     "dispatch (pow2 live-row bucket)."),
    ("spec_proposed", "Draft tokens proposed by speculative decode ticks."),
    ("spec_accepted", "Draft proposals accepted (matched the target's own "
     "pick) and emitted."),
    ("spec_rejected", "Draft proposals rejected — their KV writes rolled "
     "back and blocks freed."),
    ("spec_bonus", "Target-pick tokens emitted by verify passes (the free "
     "k+1-th token on full acceptance, the correction otherwise)."),
    ("routed_cache_hit", "Requests routed to the replica holding their "
     "longest cached prefix."),
    ("routed_wait_override", "Prefix-holder routes overridden because "
     "projected wait made a cold prefill elsewhere cheaper."),
    ("warm_replays", "Hot prefixes replayed into a recycled replica before "
     "readmission."),
    ("export_errors", "serve_requests.jsonl rows whose write failed (the "
     "stream re-arms on the next record)."),
    ("tp_dispatches", "Tensor-parallel sharded device dispatches (prefill, "
     "decode chains, spec draft/verify; 0 at tp=1)."),
    ("tp_dispatch_us", "Accumulated wall-microseconds of tensor-parallel "
     "dispatches through the result barrier (collectives included)."),
    ("tokens_out", "Generated LM tokens (both lanes)."),
    ("batch_items", "Batch-lane items completed."),
    ("batch_tokens_out", "Generated LM tokens on the batch lane."),
    ("records_evicted", "Raw request rows dropped from the bounded record "
     "deque (totals and histograms keep accumulating exactly)."),
    ("canary_promoted", "Canary deploy verdicts that promoted the new "
     "checkpoint fleet-wide."),
    ("canary_rejected", "Canary deploy verdicts that restaged the old "
     "checkpoint on the canary."),
    ("surge_spawns", "Surge-deploy replacements landed (new generation "
     "spawned and warmed before the old one drained)."),
    ("journal_resumes", "Rollouts resumed from a durable deploy journal "
     "after a gateway restart."),
    ("scale_outs", "Replicas added to the fleet by the autoscaler (admitted "
     "only after warm shadow-probe)."),
    ("scale_ins", "Replicas drained to completion and retired by the "
     "autoscaler."),
    ("autoscale_blocked", "Autoscale decisions deferred because a rollout "
     "held the deploy lock (mutual exclusion, counted not raced)."),
    ("kv_blocks_migrated", "KV blocks landed from another replica via the "
     "migration wire format (counted at the importer)."),
    ("kv_bytes_migrated", "Payload bytes of the KV blocks landed via "
     "migration (counted at the importer)."),
    ("handoffs", "Prefill-to-decode request handoffs completed by the "
     "gateway's migration plane."),
    ("handoff_ms", "Accumulated wall-ms of the handoff stage (1-step "
     "prefill + block export + import); divide by handoffs for the "
     "per-handoff cost."),
    ("tenant_requests", "Requests completed, attributed per tenant (the "
     "unlabeled series is the fleet total; tenant=... cells break it "
     "down)."),
    ("tenant_tokens", "Generated LM tokens attributed per tenant."),
    ("tenant_sheds", "Requests shed (overload, deadline, or quota) "
     "attributed to the tenant that lost them."),
    ("adapter_loads", "LoRA adapters landed in the serving adapter pool."),
    ("adapter_evictions", "Idle LoRA adapters LRU-evicted from pool slots."),
    ("adapter_pins", "Adapter pin events (a request bound an adapter slot "
     "for its decode lifetime)."),
)
_HISTOGRAMS = ("queue_ms", "ttft_ms", "total_ms")


def _histogram_lines(name: str, counts: list[int],
                     total_sum: float) -> list[str]:
    """Exposition lines from ACCUMULATED ladder counts (+Inf last) —
    exact over the whole run regardless of raw-record eviction."""
    full = f"ddw_serve_{name}"
    lines = [f"# HELP {full} Request {name.replace('_', ' ')} histogram.",
             f"# TYPE {full} histogram"]
    acc = 0
    for i, le in enumerate(LATENCY_BUCKETS_MS):
        acc += counts[i]
        lines.append(f'{full}_bucket{{le="{le:g}"}} {acc}')
    total = acc + counts[-1]
    lines.append(f'{full}_bucket{{le="+Inf"}} {total}')
    lines.append(f"{full}_sum {total_sum:g}")
    lines.append(f"{full}_count {total}")
    return lines


def merge_metrics(metrics_list) -> "EngineMetrics":
    """Fold several engines' accumulators into one read-only view — the
    fleet aggregation a :class:`ddw_tpu.gateway.ReplicaSet` snapshot and
    the gateway ``/metrics`` endpoint are built on. Counters sum, records
    concatenate (so percentiles are over the union), and the busy window
    spans first admission to last completion across every replica."""
    out = EngineMetrics(max_records=None)   # a merged VIEW never evicts —
    #                                         per-replica deques already bound
    for m in metrics_list:
        with m._lock:
            out._records.extend(m._records)
            for name, _ in _COUNTER_HELP:
                setattr(out, name, getattr(out, name) + getattr(m, name))
            for key, counts in m._hists.items():
                dst = out._hists[key]
                for i, c in enumerate(counts):
                    dst[i] += c
                out._hist_sum[key] += m._hist_sum[key]
                if m._hist_max[key] > out._hist_max[key]:
                    out._hist_max[key] = m._hist_max[key]
            for name, val in m._gauges.items():
                out._gauges[name] = out._gauges.get(name, 0.0) + val
            for key, val in m._labeled.items():
                out._labeled[key] = out._labeled.get(key, 0.0) + val
            if m._first_admit is not None:
                out._first_admit = (m._first_admit if out._first_admit is None
                                    else min(out._first_admit, m._first_admit))
            if m._last_done is not None:
                out._last_done = (m._last_done if out._last_done is None
                                  else max(out._last_done, m._last_done))
    return out


def render_prometheus(metrics_list, extra_gauges: dict[str, float] | None
                      = None) -> str:
    """Render one or more :class:`EngineMetrics` as Prometheus text
    exposition (version 0.0.4), MERGED — counters sum, histogram buckets
    accumulate over every replica's records, and the throughput gauge spans
    the union busy window. ``extra_gauges`` lets the caller (the gateway)
    add fleet-level gauges like outstanding requests per replica."""
    recs: list[RequestRecord] = []
    counters = {name: 0.0 for name, _ in _COUNTER_HELP}
    hists = {name: [0] * (len(LATENCY_BUCKETS_MS) + 1)
             for name in _HISTOGRAMS}
    hist_sums = {name: 0.0 for name in _HISTOGRAMS}
    pool_gauges: dict[str, float] = {}
    labeled: dict[tuple[str, str, str], float] = {}
    first, last = None, None
    for m in metrics_list:
        with m._lock:
            recs.extend(m._records)
            for name, _ in _COUNTER_HELP:
                counters[name] += float(getattr(m, name))
            for key, val in m._labeled.items():
                labeled[key] = labeled.get(key, 0.0) + val
            for (name, lane), counts in m._hists.items():
                dst = hists[name]
                for i, c in enumerate(counts):
                    dst[i] += c
                hist_sums[name] += m._hist_sum[(name, lane)]
            for name, val in m._gauges.items():
                pool_gauges[name] = pool_gauges.get(name, 0.0) + val
            if m._first_admit is not None:
                first = (m._first_admit if first is None
                         else min(first, m._first_admit))
            if m._last_done is not None:
                last = (m._last_done if last is None
                        else max(last, m._last_done))
    tokens = counters["tokens_out"]
    brecs = [r for r in recs if r.lane == "batch"]

    lines: list[str] = []
    for name, help_ in _COUNTER_HELP:
        full = f"ddw_serve_{name}_total"
        lines += [f"# HELP {full} {help_}", f"# TYPE {full} counter",
                  f"{full} {counters[name]:g}"]
        # per-label breakdown cells ride under the same family (the
        # unlabeled series above is their fleet-summed total)
        for (fam, label, value), val in sorted(labeled.items()):
            if fam == name:
                lines.append(f'{full}{{{label}="{value}"}} {val:g}')
    tps = (tokens / (last - first)
           if tokens and last is not None and last > first else 0.0)
    lines += ["# HELP ddw_serve_tokens_per_sec Aggregate decode throughput "
              "over the busy window.",
              "# TYPE ddw_serve_tokens_per_sec gauge",
              f"ddw_serve_tokens_per_sec {tps:g}"]
    bips = 0.0
    if brecs:
        b0 = min(r.admitted for r in brecs)
        b1 = max(r.done for r in brecs)
        if b1 > b0:
            bips = len(brecs) / (b1 - b0)
    lines += ["# HELP ddw_serve_batch_items_per_sec Batch-lane item "
              "throughput over its busy window.",
              "# TYPE ddw_serve_batch_items_per_sec gauge",
              f"ddw_serve_batch_items_per_sec {bips:g}"]
    # block-pool gauges (fleet-summed) + derived ratios
    looked = counters["prefix_hit_blocks"] + counters["prefix_miss_blocks"]
    pool_gauges["prefix_hit_rate"] = (
        counters["prefix_hit_blocks"] / looked if looked else 0.0)
    pool_gauges["spec_acceptance_rate"] = (
        counters["spec_accepted"] / counters["spec_proposed"]
        if counters["spec_proposed"] else 0.0)
    pool_gauges["spec_tokens_per_tick"] = (
        (counters["spec_accepted"] + counters["spec_bonus"])
        / counters["decode_ticks"]
        if counters["spec_proposed"] and counters["decode_ticks"] else 0.0)
    pool_gauges["tp_dispatch_cost_us"] = (
        counters["tp_dispatch_us"] / counters["tp_dispatches"]
        if counters["tp_dispatches"] else 0.0)
    cap = pool_gauges.get("block_tokens_capacity", 0.0)
    if cap:
        pool_gauges["block_fragmentation_pct"] = max(
            0.0, 100.0 * (1.0 - pool_gauges.get("block_tokens_used", 0.0)
                          / cap))
    reserve = pool_gauges.get("interactive_reserve_blocks", 0.0)
    if reserve:
        pool_gauges["reserve_occupancy_pct"] = 100.0 * (
            1.0 - pool_gauges.get("reserve_free_blocks", 0.0) / reserve)
    for name in sorted(pool_gauges):
        full = f"ddw_serve_{name}"
        lines += [f"# TYPE {full} gauge", f"{full} {pool_gauges[name]:g}"]
    typed: set[str] = set()     # one TYPE line per family, labels or not
    for key, val in (extra_gauges or {}).items():
        base = key.split("{")[0]
        if base not in typed:
            typed.add(base)
            lines.append(f"# TYPE {base} gauge")
        lines.append(f"{key} {val:g}")
    for name in _HISTOGRAMS:
        lines += _histogram_lines(name, hists[name], hist_sums[name])
    return "\n".join(lines) + "\n"
