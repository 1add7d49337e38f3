"""Dual-lane scheduler — batch backfill jobs under live interactive traffic;
the port of ``ddw_tpu.serve.lanes`` (host logic, copied).

The serving engine knows two lanes. The INTERACTIVE lane is everything
``submit_generate`` / ``submit_predict`` always were: a latency SLO,
bounded queues, deadlines. The BATCH lane is for bulk work — score a whole
table, generate over a corpus — whose SLO is throughput: finish the job,
never delay a live user. The contract, enforced engine-side
(:meth:`~ddw_tpu_torch.serve.engine.ServingEngine._admit_lm_paged`,
:meth:`~ddw_tpu_torch.serve.blocks.BlockPool.prepare_tick`):

- batch items are admitted only when the interactive queue is EMPTY and
  the paged pool has free blocks beyond the **interactive reserve**
  watermark (``EngineCfg.interactive_reserve_blocks``) — backfill fills
  idle capacity, never the headroom a live arrival would need;
- on any pressure (an interactive head that cannot fit, a mid-tick block
  shortage) batch streams are preempted FIRST — before any interactive
  stream — via the existing bit-identical recompute path, and re-queue at
  their lane's head with completed tokens intact;
- the lane changes only WHEN a stream runs, never what it computes: batch
  outputs are bit-identical to the direct offline ``generate``/``score``
  path.

This module is the HOST side of that lane: :class:`BatchJob` turns one
bulk submission into a pumped window of per-item engine futures with
per-item progress, exactly-once result recording, and retry-on-refusal —
the properties that make a job *resumable*. The pump lives above the
engine (or above a whole replica set), so a
replica death costs nothing durable: queued items with nothing emitted
ride the existing salvage → ``adopt`` failover path with their futures
intact; anything the dead replica actually touched fails with a
retryable :class:`~ddw_tpu_torch.serve.admission.ReplicaFailed` and the pump
resubmits it after backoff — results already recorded are keyed by item
index and written once, so a resumed job never duplicates or loses an
item. :class:`JobLedger` is the id → job registry the gateway's
``/v1/batch`` endpoints (submit / poll / NDJSON results / cancel) serve
from.

Per-item determinism for sampled jobs: item ``i`` samples from
:func:`item_generator` ``(seed, i)`` — a CPU ``torch.Generator`` seeded by
``np.random.SeedSequence([seed, i])``, a pure function of (seed, index), so
any retry, any replica, and the direct offline call with the same generator
all sample identically. (``ddw_tpu`` derives ``jax.random.fold_in(
PRNGKey(seed), i)``, which torch cannot reproduce: the port's sampled
streams are self-consistent, not equal to ``ddw_tpu``'s.)
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time

import numpy as np
import torch

from ddw_tpu_torch.serve.admission import (Overloaded, Rejected,
                                           ReplicaFailed, Unavailable)

__all__ = ["BatchJob", "JobLedger", "start_batch_job", "item_generator",
           "LANE_INTERACTIVE", "LANE_BATCH", "BATCH_KINDS"]

LANE_INTERACTIVE = "interactive"
LANE_BATCH = "batch"
# the batch lane's admission-queue kinds engine-side
BATCH_KINDS = ("lm_batch", "image_batch")

JOB_RUNNING = "running"
JOB_DONE = "done"
JOB_CANCELLED = "cancelled"

# refusals the pump absorbs by backoff + resubmit: transient capacity or a
# replica death. Anything else (a ValueError, a deadline) is a permanent
# per-item failure — retrying an invalid prompt forever helps nobody.
_RETRYABLE = (Overloaded, ReplicaFailed, Unavailable)

_job_counter = itertools.count()
_job_lock = threading.Lock()


def item_generator(seed: int, index: int) -> torch.Generator:
    """The sampling generator of a sampled batch job's item ``index``: a
    CPU ``torch.Generator`` seeded with the first 63-bit word of
    ``np.random.SeedSequence([seed, index])`` — a pure function of (seed,
    index). Pass ``item_generator(seed, i)`` as ``rng`` to a direct
    ``submit_generate`` to reproduce item ``i`` exactly."""
    word = np.random.SeedSequence([int(seed), int(index)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(word) >> 1)


def _new_job_id() -> str:
    with _job_lock:
        n = next(_job_counter)
    return f"job-{n}-{os.urandom(3).hex()}"


class BatchJob:
    """One bulk job: a window-bounded pump of per-item futures with
    exactly-once result recording.

    The pump is event-driven — no polling thread. Item completions chain
    the next submission through future done-callbacks; retryable refusals
    arm a single shared ``threading.Timer`` (exponential backoff, capped)
    that re-feeds the window, which is what lets a job ride out a replica
    restart: every in-flight item fails fast with ``ReplicaFailed``, the
    timer backs off while the engine is down, and resubmission resumes
    the moment admission reopens (or a replica-set sibling answers
    first). ``results`` is keyed by item index and written
    once — re-running an item that failed mid-flight cannot duplicate a
    row, and completed rows survive preemption, restart, and ``cancel``.
    """

    def __init__(self, kind: str, n_items: int, submit_fn, row_fn,
                 window: int, max_item_retries: int = 64,
                 retry_base_s: float = 0.05, retry_max_s: float = 2.0,
                 clock=time.monotonic, job_id: str | None = None,
                 submit_many_fn=None, group_size: int = 1,
                 completed: dict | None = None):
        if n_items < 1:
            raise ValueError(f"a batch job needs >= 1 item, got {n_items}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.job_id = job_id or _new_job_id()
        self.kind = kind
        self.total = n_items
        self.window = window
        self.max_item_retries = max_item_retries
        self.retry_base_s = retry_base_s
        self.retry_max_s = retry_max_s
        self._submit_fn = submit_fn       # (index) -> Future
        self._submit_many_fn = submit_many_fn   # (indices) -> [Future]
        self.group_size = max(1, int(group_size))
        self._row_fn = row_fn             # (index, result) -> row dict
        self._clock = clock
        self._lock = threading.Lock()
        self._state = JOB_RUNNING
        # durable-ledger hooks (None = in-memory job): on_row(idx, row)
        # fires exactly once per newly-recorded row; on_state(state) on
        # terminal transitions the ledger should remember
        self.on_row = None
        self.on_state = None
        completed = completed or {}
        self._pending: collections.deque[int] = collections.deque(
            i for i in range(n_items) if i not in completed)
        self._inflight: dict[int, object] = {}     # index -> Future
        self._retries: dict[int, int] = {}
        # exactly-once, by index; a resumed job pre-seeds the rows its
        # previous life already landed — they are never re-run
        self._results: dict[int, dict] = dict(completed)
        self._failures: dict[int, dict] = {}       # permanent, by index
        self._requeues = 0
        self._timer: threading.Timer | None = None
        self._terminal = threading.Event()
        self._t0 = clock()
        self._t_last = self._t0

    # -- pump ----------------------------------------------------------------
    def _start(self) -> "BatchJob":
        self._maybe_finish()    # a resumed job may have nothing left to do
        self._feed()
        return self

    def _feed(self) -> None:
        """Fill the in-flight window from the pending deque. Runs on the
        submitter's thread, a completion callback, or the backoff timer —
        never holds the lock across a submission (submit can run engine
        validation and queue locks). With a grouped submitter
        (``submit_many_fn`` + ``group_size > 1``) the window fills a
        GROUP at a time — one wire exchange per group on a process
        replica."""
        grouped = self._submit_many_fn is not None and self.group_size > 1
        while True:
            with self._lock:
                if self._state != JOB_RUNNING:
                    return
                room = self.window - len(self._inflight)
                if not self._pending or room < 1:
                    return
                n = (min(room, self.group_size, len(self._pending))
                     if grouped else 1)
                idxs = [self._pending.popleft() for _ in range(n)]
            if grouped:
                if self._feed_group(idxs):
                    continue
                return
            idx = idxs[0]
            try:
                fut = self._submit_fn(idx)
            except _RETRYABLE as e:
                # the door is shut (queue full / replica down): put the
                # item back at the FRONT and back off — if one submission
                # bounced, the rest of the window would too
                self._requeue(idx, e)
                return
            except Exception as e:
                self._fail_item(idx, e)
                self._maybe_finish()
                continue
            with self._lock:
                if self._state != JOB_RUNNING:
                    fut.cancel()
                    return
                self._inflight[idx] = fut
            fut.add_done_callback(
                lambda f, i=idx: self._on_item_done(i, f))

    def _feed_group(self, idxs: list[int]) -> bool:
        """Submit one group; True = keep feeding, False = backed off."""
        try:
            futs = self._submit_many_fn(idxs)
        except _RETRYABLE as e:
            for idx in reversed(idxs):      # FRONT, original order kept
                self._requeue(idx, e, schedule=False)
            self._schedule_feed(min(
                self.retry_base_s * (2 ** min(
                    self._retries.get(idxs[0], 1) - 1, 6)),
                self.retry_max_s))
            return False
        except Exception as e:
            for idx in idxs:
                self._fail_item(idx, e)
            self._maybe_finish()
            return True
        with self._lock:
            if self._state != JOB_RUNNING:
                for f in futs:
                    f.cancel()
                return False
            for idx, fut in zip(idxs, futs):
                self._inflight[idx] = fut
        for idx, fut in zip(idxs, futs):
            fut.add_done_callback(
                lambda f, i=idx: self._on_item_done(i, f))
        return True

    def _on_item_done(self, idx: int, fut) -> None:
        with self._lock:
            self._inflight.pop(idx, None)
        if fut.cancelled():
            pass                      # our own cancel() path
        else:
            exc = fut.exception()
            if exc is None:
                self._record(idx, fut.result())
            elif (isinstance(exc, _RETRYABLE)
                  and self._retries.get(idx, 0) < self.max_item_retries):
                self._requeue(idx, exc)
            else:
                self._fail_item(idx, exc)
        self._maybe_finish()
        self._feed()

    def _record(self, idx: int, result) -> None:
        row = self._row_fn(idx, result)
        with self._lock:
            new = idx not in self._results
            if new:                           # exactly-once by index
                self._results[idx] = row
                self._t_last = self._clock()
        if new and self.on_row is not None:
            try:
                self.on_row(idx, row)         # durable append (fsync'd);
            except OSError:                   # a full disk must not kill
                pass                          # the in-memory job

    def _fail_item(self, idx: int, exc: Exception) -> None:
        err = (exc.to_dict() if isinstance(exc, Rejected)
               else {"error": type(exc).__name__, "message": str(exc)})
        with self._lock:
            if idx not in self._results and idx not in self._failures:
                self._failures[idx] = {"index": idx, **err}

    def _requeue(self, idx: int, exc: Exception,
                 schedule: bool = True) -> None:
        with self._lock:
            if self._state != JOB_RUNNING:
                return
            n = self._retries.get(idx, 0) + 1
            self._retries[idx] = n
            self._requeues += 1
            self._pending.appendleft(idx)
            delay = min(self.retry_base_s * (2 ** min(n - 1, 6)),
                        self.retry_max_s)
        if schedule:
            self._schedule_feed(delay)

    def _schedule_feed(self, delay: float) -> None:
        with self._lock:
            if self._timer is not None or self._state != JOB_RUNNING:
                return            # one armed timer re-feeds the whole window
            t = threading.Timer(delay, self._timer_fire)
            t.daemon = True
            self._timer = t
        t.start()

    def _timer_fire(self) -> None:
        with self._lock:
            self._timer = None
        self._feed()
        self._maybe_finish()

    def _maybe_finish(self) -> None:
        with self._lock:
            if self._state != JOB_RUNNING:
                return
            if (self._pending or self._inflight
                    or len(self._results) + len(self._failures)
                    < self.total):
                return
            self._state = JOB_DONE
        self._terminal.set()
        if self.on_state is not None:
            try:
                self.on_state(JOB_DONE)
            except OSError:
                pass

    # -- caller API ----------------------------------------------------------
    @property
    def state(self) -> str:
        return self._state

    @property
    def done(self) -> bool:
        return self._terminal.is_set()

    def progress(self) -> dict:
        """The poll view: counts by disposition plus the throughput the
        batch SLO is judged by (completed items over the job's busy
        window)."""
        with self._lock:
            ndone = len(self._results)
            nfail = len(self._failures)
            elapsed = max(self._t_last - self._t0, 0.0)
            return {
                "job_id": self.job_id,
                "kind": self.kind,
                "state": self._state,
                "total": self.total,
                "completed": ndone,
                "failed": nfail,
                "inflight": len(self._inflight),
                "pending": len(self._pending),
                "requeues": self._requeues,
                "items_per_sec": (round(ndone / elapsed, 3)
                                  if ndone and elapsed > 0 else 0.0),
                "failures": sorted(self._failures.values(),
                                   key=lambda r: r["index"])[:8],
            }

    def wait(self, timeout_s: float | None = None) -> dict:
        """Block until the job is terminal (done or cancelled); raises
        ``TimeoutError`` otherwise. Returns :meth:`progress`."""
        if not self._terminal.wait(timeout=timeout_s):
            raise TimeoutError(
                f"batch job {self.job_id} not terminal after {timeout_s}s: "
                f"{self.progress()}")
        return self.progress()

    def result_rows(self) -> list[dict]:
        """Completed rows sorted by item index — the NDJSON body of the
        gateway's ``/v1/batch/<id>/results``. Available any time; a
        running (or cancelled) job returns what has completed so far."""
        with self._lock:
            return [self._results[i] for i in sorted(self._results)]

    def cancel(self, durable: bool = True) -> None:
        """Stop the pump: pending items are dropped, queued in-flight
        futures are cancelled (engine-side they are discarded before any
        device work), completed rows are KEPT. Idempotent.

        ``durable=False`` (the gateway's DRAIN path) stops this process's
        pump without recording the cancellation in a durable ledger — the
        job's meta stays ``running`` on disk, so a restarted gateway
        RESUMES it. A user-initiated cancel is durable: the job stays
        cancelled across restarts."""
        with self._lock:
            if self._state != JOB_RUNNING:
                return
            self._state = JOB_CANCELLED
            self._pending.clear()
            timer, self._timer = self._timer, None
            futs = list(self._inflight.values())
        if timer is not None:
            timer.cancel()
        for f in futs:
            f.cancel()           # queued -> dropped; admitted -> completes
        self._terminal.set()
        if durable and self.on_state is not None:
            try:
                self.on_state(JOB_CANCELLED)
            except OSError:
                pass


def _write_json_atomic(path: str, obj: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class JobLedger:
    """id → :class:`BatchJob` registry — the gateway's resumable view of
    every bulk job in flight. The ledger (and each job's pump) lives
    HOST-side, above the engines: an engine ``restart()``/``recycle()``
    never touches it, which is what makes a job survive one. Terminal
    jobs are pruned oldest-first past ``max_jobs`` so a long-lived
    gateway does not accumulate result sets forever.

    With ``ledger_dir`` the ledger is DURABLE — jobs survive the GATEWAY
    process dying, not just a replica. Per job, on disk::

        <ledger_dir>/<job_id>/meta.json     spec + state (atomic rewrite)
        <ledger_dir>/<job_id>/rows.jsonl    completed rows, appended +
                                            fsync'd as each item lands

    ``rows.jsonl`` is the exactly-once set made durable: a restarted
    gateway's :meth:`resume` re-pumps every ``running`` job with its
    completed rows pre-seeded, so no finished item is ever recomputed and
    no item is lost — a kill -9 between the append and the next item
    costs at most the re-run of rows whose append never landed."""

    def __init__(self, max_jobs: int = 256,
                 ledger_dir: str | None = None):
        self.max_jobs = max_jobs
        self.dir = ledger_dir
        if self.dir:
            os.makedirs(self.dir, exist_ok=True)
        self._jobs: collections.OrderedDict[str, BatchJob] = \
            collections.OrderedDict()
        self._lock = threading.Lock()

    def add(self, job: BatchJob, spec: dict | None = None) -> BatchJob:
        if self.dir:
            try:
                self._attach_durable(job, spec)
            except OSError:
                pass                 # a read-only disk degrades to the
            #                          in-memory ledger, not a dead job
        with self._lock:
            self._jobs[job.job_id] = job
            # prune terminal jobs oldest-first; live jobs are never evicted
            while len(self._jobs) > self.max_jobs:
                victim = next((jid for jid, j in self._jobs.items()
                               if j.done), None)
                if victim is None:
                    break
                del self._jobs[victim]
        return job

    def _attach_durable(self, job: BatchJob, spec: dict | None) -> None:
        d = os.path.join(self.dir, job.job_id)
        os.makedirs(d, exist_ok=True)
        meta_path = os.path.join(d, "meta.json")
        meta = {"job_id": job.job_id, "kind": job.kind,
                "total": job.total, "state": JOB_RUNNING, "spec": spec}
        try:
            _write_json_atomic(meta_path, meta)
        except TypeError:            # a spec that can't cross to JSON
            meta["spec"] = None      # (array prompts do; exotic items
            _write_json_atomic(meta_path, meta)   # don't) → not resumable,
        #                                           rows still durable
        rows_f = open(os.path.join(d, "rows.jsonl"), "a")
        io_lock = threading.Lock()

        def on_row(idx: int, row: dict) -> None:
            with io_lock:
                rows_f.write(json.dumps(row) + "\n")
                rows_f.flush()
                os.fsync(rows_f.fileno())

        def on_state(state: str) -> None:
            meta["state"] = state
            _write_json_atomic(meta_path, meta)
            if state != JOB_RUNNING:
                with io_lock:
                    rows_f.close()

        job.on_row = on_row
        job.on_state = on_state

    def resume(self, target) -> list[BatchJob]:
        """Restart every durable job a previous gateway life left
        ``running`` — completed rows pre-seeded, only the remainder
        pumped. Called by ``Gateway.start()`` after warmup (the fleet
        must be able to take the resubmissions)."""
        if not self.dir:
            return []
        out: list[BatchJob] = []
        for name in sorted(os.listdir(self.dir)):
            meta_path = os.path.join(self.dir, name, "meta.json")
            try:
                with open(meta_path) as f:
                    meta = json.load(f)
            except (FileNotFoundError, NotADirectoryError, ValueError):
                continue
            job_id = meta.get("job_id", name)
            spec = meta.get("spec")
            if (meta.get("state") != JOB_RUNNING or not spec
                    or self.get(job_id) is not None):
                continue
            completed: dict[int, dict] = {}
            try:
                with open(os.path.join(self.dir, name, "rows.jsonl")) as f:
                    for line in f:
                        try:
                            row = json.loads(line)
                            completed[int(row["index"])] = row
                        except (ValueError, KeyError, TypeError):
                            pass     # a torn final append: re-run that item
            except FileNotFoundError:
                pass
            out.append(start_batch_job(
                target, spec["items"], kind=spec.get("kind", "generate"),
                num_steps=spec.get("num_steps"),
                temperature=spec.get("temperature", 0.0),
                seed=spec.get("seed"),
                timeout_s=spec.get("timeout_s", 0.0),
                window=spec.get("window", 0),
                group_size=spec.get("group_size", 0),
                job_id=job_id, completed=completed, ledger=self))
        return out

    def get(self, job_id: str) -> BatchJob | None:
        with self._lock:
            return self._jobs.get(job_id)

    def jobs(self) -> list[BatchJob]:
        with self._lock:
            return list(self._jobs.values())

    def summary(self) -> dict:
        """Fleet-level job accounting for ``/stats`` and ``/readyz``."""
        with self._lock:
            jobs = list(self._jobs.values())
        states = collections.Counter(j.state for j in jobs)
        return {
            "jobs": len(jobs),
            "running": states.get(JOB_RUNNING, 0),
            "done": states.get(JOB_DONE, 0),
            "cancelled": states.get(JOB_CANCELLED, 0),
            "items_pending": sum(j.progress()["pending"] +
                                 j.progress()["inflight"]
                                 for j in jobs if j.state == JOB_RUNNING),
        }

    def shutdown(self) -> None:
        """Cancel every live job (gateway drain: stop the pumps before the
        replicas stop, so nothing resubmits into a closing fleet). The
        cancellations are NON-durable: on disk the jobs stay ``running``,
        so the next gateway life resumes them — a restart is not a
        user's cancel."""
        for job in self.jobs():
            job.cancel(durable=False)


def _default_window(target, kind: str) -> int:
    """In-flight items per job: ~2x the fleet's concurrent capacity keeps
    every idle row/batch slot fed without flooding the bounded batch
    queue (the pump re-feeds the moment an item completes)."""
    engines = getattr(target, "replicas", None) or [target]
    if kind == "generate":
        caps = [getattr(getattr(e, "pool", None), "max_resident", 0)
                for e in engines]
    else:
        caps = [getattr(getattr(e, "cfg", None), "max_batch", 0)
                for e in engines]
    total = sum(c for c in caps if c)
    return max(2 * total, 8) if total else 16


def start_batch_job(target, items, kind: str = "generate",
                    num_steps: int | None = None, temperature: float = 0.0,
                    seed: int | None = None, timeout_s: float = 0.0,
                    window: int = 0, max_item_retries: int = 64,
                    retry_base_s: float = 0.05, retry_max_s: float = 2.0,
                    ledger: JobLedger | None = None,
                    group_size: int = 0, job_id: str | None = None,
                    completed: dict | None = None) -> BatchJob:
    """Build and start a :class:`BatchJob` over ``target`` — a
    :class:`~ddw_tpu_torch.serve.engine.ServingEngine` or a replica set
    (anything with ``submit_batch_item`` / ``submit_batch_predict``).

    ``kind="generate"``: each item is a token prompt; ``num_steps`` is
    required; ``seed`` (with ``temperature > 0``) gives item ``i`` the
    generator :func:`item_generator` ``(seed, i)`` — the same derivation a
    direct offline call must use to reproduce the job bit-for-bit.
    ``kind="predict"``: each item is an image (bytes/path/array).
    ``timeout_s=0`` (default) means NO per-item deadline — the batch SLO
    is throughput, and a deadline on backfill work converts yielding
    into failure.

    ``group_size`` controls per-replica submission batching: groups of
    items cross to ONE replica per wire exchange through the target's
    ``submit_batch_items`` (one HTTP POST for a whole group on a
    process-replica fleet). 0 = auto — grouped
    (8) only when an engine in the fleet actually takes groups; in-thread
    fleets keep per-item routing, where spreading beats batching.
    ``job_id`` + ``completed`` are the resume path (see
    :meth:`JobLedger.resume`): rows already landed are pre-seeded and
    never re-run."""
    items = list(items)
    if kind == "generate":
        if num_steps is None:
            raise ValueError("kind='generate' requires num_steps")
        if temperature > 0.0 and seed is None:
            raise ValueError("sampled batch jobs require seed (per-item "
                             "generators derive from (seed, i))")
        sampled = temperature > 0.0 and seed is not None

        def submit(i):
            rng = item_generator(seed, i) if sampled else None
            return target.submit_batch_item(
                items[i], num_steps, temperature=temperature, rng=rng,
                timeout_s=timeout_s)

        def row_of(i, res):
            return {"index": i, "tokens": [int(t) for t in res.tokens]}
    elif kind == "predict":
        def submit(i):
            return target.submit_batch_predict(items[i],
                                               timeout_s=timeout_s)

        def row_of(i, res):
            return {"index": i, "label": res.label,
                    "class_index": int(res.index)}
    else:
        raise ValueError(f"unknown batch kind {kind!r} "
                         f"(expected 'generate' or 'predict')")
    submit_many = None
    if hasattr(target, "submit_batch_items"):
        if not group_size:
            engines = getattr(target, "replicas", None) or [target]
            group_size = (8 if any(hasattr(e, "submit_batch_items")
                                   for e in engines) else 1)

        def submit_many(idxs):
            return target.submit_batch_items(
                [items[i] for i in idxs], idxs, kind=kind,
                num_steps=num_steps, temperature=temperature, seed=seed,
                timeout_s=timeout_s)
    job = BatchJob(kind, len(items), submit, row_of,
                   window=window or _default_window(target, kind),
                   max_item_retries=max_item_retries,
                   retry_base_s=retry_base_s, retry_max_s=retry_max_s,
                   job_id=job_id, submit_many_fn=submit_many,
                   group_size=group_size, completed=completed)
    if ledger is not None:
        spec = {"kind": kind,
                "items": [x.tolist() if hasattr(x, "tolist") else x
                          for x in items],
                "num_steps": num_steps, "temperature": temperature,
                "seed": seed, "timeout_s": timeout_s, "window": window,
                "group_size": group_size}
        ledger.add(job, spec=spec)
    return job._start()
