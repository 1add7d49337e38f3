"""HTTP front door for the serving engine — stdlib, JSON, streaming (the
port of ``ddw_tpu.gateway.http``: the same routes, JSON bodies, NDJSON
stream lines, status codes and ``Retry-After``, so either package's
:class:`~ddw_tpu_torch.gateway.client.GatewayClient` drives either gateway).

Randomness is this package's own: a request's ``seed`` seeds a CPU
``torch.Generator`` that draws the per-step sampling seeds, a batch item's
generator is :func:`~ddw_tpu_torch.serve.lanes.item_generator` ``(seed,
index)``, and a parent process relays already-drawn per-step seeds as
``step_seeds`` (``ddw_tpu``'s JAX ``key_data`` is refused with a 400).
Greedy tokens equal ``ddw_tpu``'s; sampled tokens are reproducible inside
this package — in-thread, over HTTP, through a process replica and after
failover.

The serving engine ends at a Python futures API in the caller's process; the
ROADMAP's open serving item names what's missing: "a thin HTTP transport in
front of the in-process engine". This module is that transport — a
``ThreadingHTTPServer`` (one thread per connection, stdlib only: the
container rule is no new dependencies) whose handlers translate between
HTTP and the engine's structured types. No serving policy lives here:
admission, batching, deadlines, and metrics stay in :mod:`ddw_tpu_torch.serve`;
routing and fleet aggregation in :class:`~ddw_tpu_torch.gateway.ReplicaSet`;
readiness/drain in :class:`~ddw_tpu_torch.gateway.ServerLifecycle`. The gateway
only maps.

API (JSON request/response; errors are the engine's own ``to_dict()``
forms, never free-text parsing):

====================  ======================================================
``POST /v1/generate`` ``{"prompt": [ints], "num_steps": N, "temperature":
                      t?, "seed": s? | "step_seeds": [N ints]?,
                      "timeout_s": d?, "stream": false?}``
                      → ``{"tokens": [...], queue_ms, ttft_ms, total_ms,
                      tokens_per_sec}``. With ``"stream": true`` the reply
                      is chunked NDJSON: one ``{"index": i, "token": t}``
                      line per token the moment its decode tick fetches
                      (the engine's ``on_token`` hook), then a final
                      ``{"done": true, ...}`` line with the SLO numbers.
``POST /v1/predict``  ``{"image": [[[floats]]], "timeout_s": d?,
                      "return_logits": false?}`` → ``{label, index,
                      queue_ms, total_ms}``
``POST /v1/batch``    ``{"kind": "generate"|"predict", "items": [...],
                      "num_steps": N?, "temperature": t?, "seed": s?,
                      "window": w?}`` → ``{"job_id", "kind", "total"}``.
                      Submits a batch-LANE job: items backfill idle
                      capacity behind the interactive reserve and are
                      preempted first under interactive pressure (see
                      docs/serving.md). The job is tracked host-side in
                      the gateway's :class:`~ddw_tpu_torch.serve.lanes.
                      JobLedger` — it survives replica restarts.
``GET /v1/batch/<id>``            poll: the job's ``progress()`` dict.
``GET /v1/batch/<id>/results``    completed rows, NDJSON, index order.
``DELETE /v1/batch/<id>``         cancel (completed rows are kept).
``GET /healthz``      process liveness — 200 from listener-up onward.
``GET /readyz``       load-balancer readiness — 200 only between warmup
                      completion and drain start, else 503.
``GET /metrics``      Prometheus text exposition, merged across replicas.
``GET /stats``        the fleet SLO snapshot as JSON (includes the fleet
                      ``prefix_index`` summary: keys, holders, hot list).
``GET /v1/prefix/events``  one replica's prefix-cache register/evict delta
                      feed (``?since=N&replica=R``) — the relay a parent
                      gateway's fleet index polls to follow a process
                      replica's child pool.
====================  ======================================================

Status-code mapping (docs/serving.md has the full table): ``Overloaded`` →
**429** with a ``Retry-After`` header and the structured body (capacity,
depth, ``retry_after_ms``); ``DeadlineExceeded`` → **504**; validation
errors → **400**; ``ReplicaFailed``/``Unavailable`` (the replica died, or
every circuit is open) → **503** + ``Retry-After`` (retryable: a sibling
or the supervisor's restart may serve it); not-ready or draining → **503**
+ ``Retry-After``; anything else → **500**. A rejection that happens after
streaming began arrives as a final NDJSON ``{"error": ...}`` line instead
(the status line already went out — HTTP has no second chance).

Transport hardening: connections are **HTTP/1.1 keep-alive** (the client
reuses them — a chaos drill's reconnect storm must not re-handshake per
request), bounded by ``max_connections``: past the cap the server answers
a minimal 503 + ``Retry-After`` and closes, instead of letting unbounded
accept threads pile up — the connection analog of the engine's bounded
admission queues.
"""

from __future__ import annotations

import copy
import json
import math
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ddw_tpu_torch.gateway.lifecycle import ServerLifecycle
from ddw_tpu_torch.gateway.replica import ReplicaSet
from ddw_tpu_torch.gateway.supervisor import ReplicaSupervisor
from ddw_tpu_torch.obs.slo import SLOMonitor
from ddw_tpu_torch.obs.telemetry import FleetTelemetry, TelemetryHub
from ddw_tpu_torch.obs.trace import Tracer, gen_id
from ddw_tpu_torch.serve.admission import (DeadlineExceeded, Overloaded,
                                           Rejected, ReplicaFailed,
                                           Unavailable)
from ddw_tpu_torch.serve.adapters import UnknownAdapter
from ddw_tpu_torch.serve.lanes import JobLedger, item_generator
from ddw_tpu_torch.serve.tenancy import QuotaExceeded

__all__ = ["Gateway"]


class _GatewayHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    # the stdlib default accept backlog (5) drops/retries SYNs under a
    # connection burst — the engine's admission control is the bounded
    # queue here, not the kernel's
    request_queue_size = 128
    # keep-alive makes connections long-lived, so bound how many may be
    # open at once; past the cap we answer a fast 503 (a structured refusal
    # the client's backoff understands) rather than piling up threads
    max_connections = 256

    def __init__(self, addr, gateway: "Gateway"):
        self.gateway = gateway
        self._conn_lock = threading.Lock()
        self.active_connections = 0
        super().__init__(addr, _Handler)

    def process_request_thread(self, request, client_address):
        with self._conn_lock:
            over = self.active_connections >= self.max_connections
            if not over:
                self.active_connections += 1
        if over:
            body = b'{"error":"unavailable","reason":"connections"}\n'
            try:
                request.sendall(
                    b"HTTP/1.1 503 Service Unavailable\r\n"
                    b"Content-Type: application/json\r\n"
                    b"Content-Length: " + str(len(body)).encode() + b"\r\n"
                    b"Retry-After: 1\r\nConnection: close\r\n\r\n" + body)
            except OSError:
                pass
            self.shutdown_request(request)
            return
        try:
            super().process_request_thread(request, client_address)
        finally:
            with self._conn_lock:
                self.active_connections -= 1


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"   # required for chunked streaming
    server_version = "ddw-gateway"

    def log_message(self, *args) -> None:
        pass                        # request logs are the engine's jsonl

    # -- plumbing ------------------------------------------------------------
    def _send_json(self, status: int, obj: dict,
                   extra_headers: dict | None = None) -> None:
        data = (json.dumps(obj) + "\n").encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _send_rejected(self, e: Rejected) -> None:
        body = e.to_dict()
        if isinstance(e, QuotaExceeded):
            # per-tenant refusal: same 429 backoff contract as engine
            # overload, but the body names the tenant and the exhausted
            # resource so the caller (and the drill's offline recount)
            # can attribute the shed
            ms = body.get("retry_after_ms")
            secs = max(1, math.ceil(ms / 1e3)) if ms else 1
            self._send_json(429, body, {"Retry-After": str(secs)})
        elif isinstance(e, Overloaded):
            ms = body.get("retry_after_ms")
            # delay-seconds is an integer per RFC 9110; the exact ms hint
            # rides in the body for clients that can honor it precisely
            secs = max(1, math.ceil(ms / 1e3)) if ms else 1
            self._send_json(429, body, {"Retry-After": str(secs)})
        elif isinstance(e, DeadlineExceeded):
            self._send_json(504, body)
        elif isinstance(e, (ReplicaFailed, Unavailable)):
            # the replica died under it / every circuit is open: retryable —
            # a sibling or the supervisor's restart may serve the retry
            ms = getattr(e, "retry_after_ms", None)
            secs = max(1, math.ceil(ms / 1e3)) if ms else 1
            self._send_json(503, body, {"Retry-After": str(secs)})
        else:
            self._send_json(500, body)

    def _read_body(self) -> dict | None:
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
            return body
        except (ValueError, json.JSONDecodeError) as e:
            self._send_json(400, {"error": "invalid_request",
                                  "message": f"malformed JSON body: {e}"})
            return None

    # chunked writing (Transfer-Encoding: chunked framing by hand —
    # BaseHTTPRequestHandler gives us the socket, not the framing)
    def _start_stream(self) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

    def _write_chunk(self, obj: dict) -> None:
        data = (json.dumps(obj) + "\n").encode()
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def _end_stream(self) -> None:
        self.wfile.write(b"0\r\n\r\n")

    # -- GET: health / metrics ----------------------------------------------
    def do_GET(self) -> None:  # noqa: N802 (stdlib handler contract)
        gw = self.server.gateway
        try:
            if self.path == "/healthz":
                self._send_json(200, {"status": "alive",
                                      "state": gw.lifecycle.state})
            elif self.path == "/readyz":
                ready, body = gw.lifecycle.readiness()
                try:
                    body["lanes"] = gw.lane_stats()
                except Exception:
                    pass     # readiness must answer even if a replica's
                #              health probe is mid-death
                dep = gw.deploy_view()
                body["deploying"] = dep["deploying"]
                body["fleet_generation"] = dep["fleet_generation"]
                # the abort asymmetry made visible: True whenever live
                # replica digests disagree (half-rolled fleet, kept-new
                # winners after an abort) — the same signal the startup
                # reconciler keys on
                live = {c for c in dep.get("checkpoints", ()) if c}
                body["mixed_checkpoints"] = len(live) > 1
                # SLO degradation detail: a burning objective flips the
                # "degraded" flag and names itself, but the gateway stays
                # ready (200) — load balancers weight it down, they don't
                # eject it; only replica loss flips readiness itself
                if gw.slo_monitor is not None:
                    deg = gw.slo_monitor.degraded()
                    if deg:
                        body["degraded"] = True
                        body["slo_degraded"] = deg
                a = gw.autoscale_view()
                if a is not None:
                    last = a["last_decision"] or {}
                    body["autoscale"] = {
                        "enabled": a["enabled"], "desired": a["desired"],
                        "actual": a["actual"],
                        "last_action": last.get("action"),
                        "last_reason": last.get("reason"),
                        "cooldown_remaining_s": a["cooldown_remaining_s"]}
                if ready:
                    self._send_json(200, body)
                else:
                    self._send_json(503, body, {"Retry-After": "1"})
            elif self.path == "/metrics":
                text = (gw.replica_set.prometheus()
                        + gw.slo_prometheus()).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(text)))
                self.end_headers()
                self.wfile.write(text)
            elif self.path == "/stats":
                out = {"state": gw.lifecycle.state,
                       "inflight": gw.lifecycle.inflight,
                       "connections": (gw._httpd.active_connections
                                       if gw._httpd else 0),
                       **gw.replica_set.snapshot(),
                       "replica_health": gw.replica_set.fleet_health(),
                       "lanes": gw.lane_stats(),
                       "deploy": gw.deploy_view()}
                try:
                    out["prefix_index"] = \
                        gw.replica_set.prefix_index.summary()
                except Exception:
                    pass     # plain engine sets without an index still
                #              answer /stats
                try:
                    adp = gw.adapters_view()
                    if adp["registry"] or adp["replicas"] or adp["ops"]:
                        out["adapters"] = adp
                except Exception:
                    pass     # fakes without adapter pools still answer
                if gw.supervisor is not None:
                    out["supervisor"] = gw.supervisor.report()
                a = gw.autoscale_view()
                if a is not None:
                    out["autoscale"] = a
                ts = gw.trace_summary()
                if ts is not None:
                    out["trace"] = ts
                tm = gw.telemetry_summary()
                if tm is not None:
                    out["telemetry"] = tm
                if gw.slo_monitor is not None:
                    out["slo"] = gw.slo_monitor.status()
                self._send_json(200, out)
            elif self.path.startswith("/v1/telemetry"):
                self._telemetry_get(gw)
            elif self.path.startswith("/v1/trace"):
                self._trace_get(gw)
            elif self.path.startswith("/v1/prefix/events"):
                self._prefix_events(gw)
            elif self.path.startswith("/v1/batch/"):
                self._batch_get(gw)
            else:
                self._send_json(404, {"error": "not_found",
                                      "path": self.path})
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True

    # -- POST: the data plane -------------------------------------------------
    def do_POST(self) -> None:  # noqa: N802
        gw = self.server.gateway
        if self.path == "/admin/deploy":
            self._admin_deploy(gw)
            return
        if self.path == "/admin/autoscale":
            self._admin_autoscale(gw)
            return
        if self.path == "/admin/adapters":
            self._admin_adapters(gw)
            return
        if self.path in ("/v1/kv/export", "/v1/kv/import"):
            # migration plane, not client data plane: ungated by the
            # lifecycle ledger (a draining gateway may still donate its
            # KV blocks), POST because prompts are token arrays far too
            # long for a query string
            self._kv_migrate(gw)
            return
        if self.path not in ("/v1/generate", "/v1/predict", "/v1/batch",
                             "/v1/batch/items"):
            self._send_json(404, {"error": "not_found", "path": self.path})
            return
        # admission into the lifecycle ledger FIRST: a draining or not-yet-
        # warm gateway refuses before reading a byte of payload semantics
        if not gw.lifecycle.try_begin_request():
            self._send_json(503, {"error": "unavailable",
                                  "state": gw.lifecycle.state},
                            {"Retry-After": "1"})
            return
        try:
            body = self._read_body()
            if body is None:
                return
            if self.path == "/v1/generate":
                self._generate(gw, body)
            elif self.path == "/v1/batch":
                self._batch_submit(gw, body)
            elif self.path == "/v1/batch/items":
                self._batch_items(gw, body)
            else:
                self._predict(gw, body)
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True   # client went away; slot finishes
        finally:
            gw.lifecycle.end_request()

    def _generate(self, gw: "Gateway", body: dict) -> None:
        # trace identity: honor an incoming x-ddw-trace-id (the caller —
        # a client or a parent gateway — owns the id), mint one only when
        # this gateway traces; the id rides the response either way so
        # jsonl forensics and traces stay joinable
        tracer = gw.tracer
        trace_id = self.headers.get("x-ddw-trace-id") or None
        hspan = None
        t_http = 0.0
        if tracer is not None:
            trace_id = trace_id or gen_id()
            hspan = tracer._next_span_id()
            t_http = time.monotonic()
        try:
            prompt = np.asarray(body["prompt"], np.int32)
            num_steps = int(body["num_steps"])
            timeout_s = body.get("timeout_s")
            kw = {"temperature": float(body.get("temperature", 0.0)),
                  "timeout_s": None if timeout_s is None
                  else float(timeout_s)}
            if body.get("tenant") is not None:
                kw["tenant"] = str(body["tenant"])
            if body.get("adapter_id") is not None:
                kw["adapter_id"] = str(body["adapter_id"])
            if trace_id is not None:
                kw["trace_id"] = trace_id
                if hspan is not None:
                    kw["parent_span"] = hspan
                else:
                    # relayed hop: a parent gateway's route span id rides
                    # x-ddw-parent-span so the child engine chain parents
                    # onto the fleet-level route decision
                    parent_hdr = self.headers.get("x-ddw-parent-span")
                    if parent_hdr:
                        kw["parent_span"] = parent_hdr
            if body.get("key_data") is not None:
                raise ValueError("key_data (a JAX PRNG key) is not taken "
                                 "here: send seed or step_seeds")
            if body.get("seed") is not None:
                kw["rng"] = torch.Generator().manual_seed(int(body["seed"]))
            elif body.get("step_seeds") is not None:
                # the per-step seeds a parent-process proxy drew from the
                # caller's generator (the ProcessReplica transport): the
                # seeds the in-thread engine would draw, so sampling stays
                # identical across the process hop
                kw["rng"] = [int(k) for k in body["step_seeds"]]
        except (KeyError, TypeError, ValueError) as e:
            self._send_json(400, {"error": "invalid_request",
                                  "message": f"bad field: {e}"})
            return
        stream = bool(body.get("stream", False))
        toks_q: queue.SimpleQueue | None = None
        if stream:
            toks_q = queue.SimpleQueue()
            kw["on_token"] = lambda i, t: toks_q.put((i, t))
        def _finish_http(status: int) -> None:
            if hspan is not None:
                tracer.record_span(
                    "http", "gateway", t_http, time.monotonic(),
                    trace=trace_id, tid="http", span=hspan,
                    args={"path": "/v1/generate", "num_steps": num_steps,
                          "status": status, "stream": stream})

        try:
            fut = gw.replica_set.submit_generate(prompt, num_steps, **kw)
        except Rejected as e:       # Overloaded / Unavailable / Quota / dead
            self._send_rejected(e)
            _finish_http(0)
            return
        except UnknownAdapter as e:
            # structured 400: names the missing adapter and what IS
            # resident, so a client can distinguish a typo from a
            # not-yet-staged adapter
            self._send_json(400, {"error": "unknown_adapter",
                                  "adapter_id": e.adapter_id,
                                  "loaded": sorted(e.loaded)})
            _finish_http(400)
            return
        except ValueError as e:
            self._send_json(400, {"error": "invalid_request",
                                  "message": str(e)})
            _finish_http(400)
            return
        if not stream:
            try:
                res = fut.result()
            except Rejected as e:
                self._send_rejected(e)
                _finish_http(0)
                return
            except UnknownAdapter as e:
                # a process replica's refusal arrives via the future
                self._send_json(400, {"error": "unknown_adapter",
                                      "adapter_id": e.adapter_id,
                                      "loaded": sorted(e.loaded)})
                _finish_http(400)
                return
            except Exception as e:
                self._send_json(500, {"error": "internal",
                                      "message": repr(e)})
                _finish_http(500)
                return
            out = {
                "tokens": [int(t) for t in res.tokens],
                "queue_ms": res.queue_ms, "ttft_ms": res.ttft_ms,
                "total_ms": res.total_ms,
                "tokens_per_sec": res.tokens_per_sec}
            hdrs = None
            if trace_id is not None:
                out["trace_id"] = trace_id
                hdrs = {"x-ddw-trace-id": trace_id}
            self._send_json(200, out, hdrs)
            _finish_http(200)
            return
        self._stream_generate(fut, toks_q, trace_id=trace_id)
        _finish_http(200)

    def _stream_generate(self, fut, toks_q: queue.SimpleQueue,
                         trace_id: str | None = None) -> None:
        """Relay the engine's on_token stream as chunked NDJSON. Headers are
        deferred until the first token (or terminal error), so a request
        shed before any device work still gets its proper status code."""
        started = False

        def relay_available(block: bool) -> None:
            nonlocal started
            timeout = 0.05 if block else 0.0
            while True:
                try:
                    i, t = toks_q.get(timeout=timeout)
                except queue.Empty:
                    return
                if not started:
                    started = True
                    self._start_stream()
                self._write_chunk({"index": i, "token": int(t)})
                timeout = 0.0    # drain the rest of the burst non-blocking

        while not fut.done():
            relay_available(block=True)
        relay_available(block=False)       # the tail emitted before done
        try:
            res = fut.result()
            final = {"done": True, "num_tokens": len(res.tokens),
                     "queue_ms": res.queue_ms, "ttft_ms": res.ttft_ms,
                     "total_ms": res.total_ms,
                     "tokens_per_sec": res.tokens_per_sec}
            if trace_id is not None:
                final["trace_id"] = trace_id
            if not started:                # num_steps >= 1 makes this rare,
                started = True             # but a zero-token reply is still
                self._start_stream()       # a well-formed stream
        except Rejected as e:
            if not started:
                self._send_rejected(e)     # clean 429/504 — nothing sent yet
                return
            final = e.to_dict()
        except Exception as e:
            if not started:
                self._send_json(500, {"error": "internal",
                                      "message": repr(e)})
                return
            final = {"error": "internal", "message": repr(e)}
        self._write_chunk(final)
        self._end_stream()
        self.close_connection = True

    def _predict(self, gw: "Gateway", body: dict) -> None:
        try:
            image = np.asarray(body["image"], np.float32)
            timeout_s = body.get("timeout_s")
            timeout_s = None if timeout_s is None else float(timeout_s)
        except (KeyError, TypeError, ValueError) as e:
            self._send_json(400, {"error": "invalid_request",
                                  "message": f"bad field: {e}"})
            return
        try:
            fut = gw.replica_set.submit_predict(image, timeout_s=timeout_s)
        except Rejected as e:       # Overloaded / Unavailable / ReplicaFailed
            self._send_rejected(e)
            return
        except ValueError as e:
            self._send_json(400, {"error": "invalid_request",
                                  "message": str(e)})
            return
        try:
            res = fut.result()
        except Rejected as e:
            self._send_rejected(e)
            return
        except Exception as e:
            self._send_json(500, {"error": "internal", "message": repr(e)})
            return
        out = {"label": res.label, "index": res.index,
               "queue_ms": res.queue_ms, "total_ms": res.total_ms}
        if body.get("return_logits"):
            out["logits"] = [float(x) for x in res.logits]
        self._send_json(200, out)

    # -- batch lane (job submit / poll / results / cancel) --------------------
    def _batch_submit(self, gw: "Gateway", body: dict) -> None:
        try:
            kind = str(body.get("kind", "generate"))
            raw = body["items"]
            if not isinstance(raw, list) or not raw:
                raise ValueError("items must be a non-empty list")
            if kind == "generate":
                items = [np.asarray(x, np.int32) for x in raw]
            else:
                items = [np.asarray(x, np.float32) for x in raw]
            kw = {"kind": kind,
                  "temperature": float(body.get("temperature", 0.0)),
                  "window": int(body.get("window", 0)),
                  "timeout_s": float(body.get("timeout_s", 0.0))}
            if body.get("num_steps") is not None:
                kw["num_steps"] = int(body["num_steps"])
            if body.get("seed") is not None:
                kw["seed"] = int(body["seed"])
            if body.get("group_size") is not None:
                kw["group_size"] = int(body["group_size"])
        except (KeyError, TypeError, ValueError) as e:
            self._send_json(400, {"error": "invalid_request",
                                  "message": f"bad field: {e}"})
            return
        try:
            job = gw.replica_set.submit_batch(items, ledger=gw.jobs, **kw)
        except Rejected as e:
            self._send_rejected(e)
            return
        except ValueError as e:
            self._send_json(400, {"error": "invalid_request",
                                  "message": str(e)})
            return
        self._send_json(200, {"job_id": job.job_id, "kind": job.kind,
                              "total": job.total})

    def _batch_items(self, gw: "Gateway", body: dict) -> None:
        """One POST, N batch-lane items — the per-replica grouped
        submission a parent-process pump uses to cut per-item HTTP
        overhead. All items are submitted first (the engine pipelines the
        group), then awaited; each row answers individually (``ok`` +
        result, or the structured refusal), so one refused item never
        poisons its groupmates."""
        try:
            kind = str(body.get("kind", "generate"))
            raw = body["items"]
            indices = [int(i) for i in body.get("indices",
                                                range(len(raw)))]
            if not isinstance(raw, list) or not raw:
                raise ValueError("items must be a non-empty list")
            if len(indices) != len(raw):
                raise ValueError("indices must match items 1:1")
            temperature = float(body.get("temperature", 0.0))
            timeout_s = float(body.get("timeout_s", 0.0))
            num_steps = (int(body["num_steps"])
                         if body.get("num_steps") is not None else None)
            seed = (int(body["seed"])
                    if body.get("seed") is not None else None)
            if body.get("key_data") is not None:
                raise ValueError("key_data (JAX PRNG keys) is not taken "
                                 "here: send seed or step_seeds")
            step_seeds = body.get("step_seeds")   # drawn seeds, one list
            #                                       per item
            if step_seeds is not None and len(step_seeds) != len(raw):
                raise ValueError("step_seeds must match items 1:1")
            if kind == "generate":
                items = [np.asarray(x, np.int32) for x in raw]
            else:
                items = [np.asarray(x, np.float32) for x in raw]
        except (KeyError, TypeError, ValueError) as e:
            self._send_json(400, {"error": "invalid_request",
                                  "message": f"bad field: {e}"})
            return
        seeded = (kind == "generate" and temperature > 0.0
                  and seed is not None and step_seeds is None)
        futs: list = []
        for pos, (item, idx) in enumerate(zip(items, indices)):
            try:
                if kind == "generate":
                    if step_seeds is not None:
                        rng = [int(k) for k in step_seeds[pos]]
                    else:
                        rng = item_generator(seed, idx) if seeded else None
                    fut = gw.replica_set.submit_batch_item(
                        item, num_steps, temperature=temperature, rng=rng,
                        timeout_s=timeout_s)
                else:
                    fut = gw.replica_set.submit_batch_predict(
                        item, timeout_s=timeout_s)
            except Rejected as e:
                futs.append((idx, None, e.to_dict()))
                continue
            except ValueError as e:
                futs.append((idx, None, {"error": "invalid_request",
                                         "message": str(e)}))
                continue
            futs.append((idx, fut, None))
        rows = []
        for idx, fut, err in futs:
            if fut is None:
                rows.append({"index": idx, "ok": False, "error": err})
                continue
            try:
                res = fut.result()
            except Rejected as e:
                rows.append({"index": idx, "ok": False,
                             "error": e.to_dict()})
                continue
            except Exception as e:
                rows.append({"index": idx, "ok": False,
                             "error": {"error": "internal",
                                       "message": repr(e)}})
                continue
            if kind == "generate":
                row = {"tokens": [int(t) for t in res.tokens]}
            else:
                row = {"label": res.label, "class_index": int(res.index)}
            rows.append({"index": idx, "ok": True, "row": row})
        self._send_json(200, {"rows": rows})

    def _trace_get(self, gw: "Gateway") -> None:
        """``GET /v1/trace`` — the fleet's merged trace (gateway ring +
        every replica's drained ring; process replicas relay their child's
        over HTTP). ``?format=chrome`` renders Perfetto-loadable Chrome
        trace JSON directly. ``?replica=R&since=N`` is the single-replica
        relay form a PARENT gateway polls on a child's own gateway —
        mirrors ``/v1/prefix/events``."""
        import urllib.parse
        q = urllib.parse.parse_qs(urllib.parse.urlparse(self.path).query)
        if "replica" in q:
            try:
                since = int(q.get("since", ["0"])[0])
                r = int(q["replica"][0])
            except ValueError:
                self._send_json(400, {"error": "invalid_request",
                                      "message": "since/replica must be "
                                                 "ints"})
                return
            replicas = gw.replica_set.replicas
            if not 0 <= r < len(replicas):
                self._send_json(404, {"error": "not_found", "replica": r})
                return
            fetch = getattr(replicas[r], "trace_events", None)
            if fetch is None:
                self._send_json(200, {"replica": r, "dropped": 0,
                                      "events": []})
                return
            self._send_json(200, fetch(since))
            return
        dump = gw.trace_dump()
        if q.get("format", [""])[0] == "chrome":
            from ddw_tpu_torch.obs.trace import chrome_trace
            self._send_json(200, chrome_trace(dump["events"]))
            return
        self._send_json(200, dump)

    def _telemetry_get(self, gw: "Gateway") -> None:
        """``GET /v1/telemetry`` — the fleet's merged windowed time-series
        plus SLO status. ``?replica=R&since=N`` is the single-replica relay
        form a PARENT gateway polls on a child's own gateway (a process
        replica's child serves its engine's feed here regardless of the
        child gateway's own telemetry flag) — mirrors ``/v1/trace``."""
        import urllib.parse
        q = urllib.parse.parse_qs(urllib.parse.urlparse(self.path).query)
        if "replica" in q:
            try:
                since = int(q.get("since", ["0"])[0])
                r = int(q["replica"][0])
            except ValueError:
                self._send_json(400, {"error": "invalid_request",
                                      "message": "since/replica must be "
                                                 "ints"})
                return
            replicas = gw.replica_set.replicas
            if not 0 <= r < len(replicas):
                self._send_json(404, {"error": "not_found", "replica": r})
                return
            fetch = getattr(replicas[r], "telemetry_events", None)
            if fetch is None:
                self._send_json(200, {"source": f"replica{r}", "replica": r,
                                      "dropped": 0, "samples": [],
                                      "last_seq": since})
                return
            self._send_json(200, fetch(since))
            return
        if not gw._telemetry:
            self._send_json(404, {"error": "not_found",
                                  "message": "gateway telemetry disabled "
                                             "(Gateway(telemetry=True))"})
            return
        self._send_json(200, gw.telemetry_view())

    def _prefix_events(self, gw: "Gateway") -> None:
        """``GET /v1/prefix/events?since=N&replica=R`` — one replica's
        prefix-cache register/evict delta feed (:meth:`~ddw_tpu_torch.serve.
        ServingEngine.prefix_events`). This is how a parent gateway's
        fleet index follows a :class:`~ddw_tpu_torch.deploy.ProcessReplica`
        child: the child's own single-replica gateway serves this path,
        the parent polls it with the last sequence number it applied."""
        import urllib.parse
        q = urllib.parse.parse_qs(urllib.parse.urlparse(self.path).query)
        try:
            since = int(q.get("since", ["0"])[0])
            r = int(q.get("replica", ["0"])[0])
        except ValueError:
            self._send_json(400, {"error": "invalid_request",
                                  "message": "since/replica must be ints"})
            return
        replicas = gw.replica_set.replicas
        if not 0 <= r < len(replicas):
            self._send_json(404, {"error": "not_found", "replica": r})
            return
        fetch = getattr(replicas[r], "prefix_events", None)
        if fetch is None:
            self._send_json(200, {"seq": since, "reset": False,
                                  "events": []})
            return
        self._send_json(200, fetch(since))

    def _kv_migrate(self, gw: "Gateway") -> None:
        """``POST /v1/kv/export`` / ``POST /v1/kv/import`` — the KV
        migration plane's relay surface. A parent gateway's disaggregated
        router calls these against a :class:`~ddw_tpu_torch.deploy.
        ProcessReplica` child's own gateway: export answers
        ``{"wire": ...}`` with the prompt's registered blocks on the
        versioned wire (``null`` when nothing is cached), import lands a
        wire into the replica's pool and answers the import summary.
        A malformed wire is a **400** (:class:`~ddw_tpu_torch.serve.blocks.
        KVWireError` rejects before any pool mutation); pool exhaustion
        surfaces as the structured refusal it is."""
        body = self._read_body()
        if body is None:
            return
        try:
            r = int(body.get("replica", 0))
        except (TypeError, ValueError):
            self._send_json(400, {"error": "invalid_request",
                                  "message": "replica must be an int"})
            return
        replicas = gw.replica_set.replicas
        if not 0 <= r < len(replicas):
            self._send_json(404, {"error": "not_found", "replica": r})
            return
        eng = replicas[r]
        try:
            if self.path == "/v1/kv/export":
                fn = getattr(eng, "kv_export", None)
                if fn is None:      # non-paged/fake replica: nothing to
                    self._send_json(200, {"wire": None})    # export
                    return
                prompt = np.asarray(body.get("prompt", ()), np.int32)
                skip = [str(h) for h in body.get("skip", ())]
                self._send_json(200, {"wire": fn(prompt, skip_hashes=skip)})
            else:
                fn = getattr(eng, "kv_import", None)
                if fn is None:
                    self._send_json(200, {"imported": 0, "skipped": 0,
                                          "bytes": 0})
                    return
                self._send_json(200, fn(body.get("wire")))
        except Rejected as e:
            self._send_rejected(e)
        except (TypeError, ValueError) as e:
            self._send_json(400, {"error": "invalid_request",
                                  "message": str(e)})
        except Exception as e:
            self._send_json(500, {"error": "internal",
                                  "message": str(e)})

    def _admin_deploy(self, gw: "Gateway") -> None:
        """Kick a weight rollout across this gateway's fleet — the
        ``tools/rolling_deploy.py`` control plane. ``strategy`` picks
        rolling (default) / canary / surge; canary takes
        ``canary_fraction`` (traffic share the held canary receives) and
        ``judge_window_s`` (how long the judge compares it to the fleet).
        The rollout runs on its own thread; progress — including the
        canary verdict timeline — is read back from ``/stats``."""
        body = self._read_body()
        if body is None:
            return
        model_dir = body.get("model_dir")
        if not model_dir or not isinstance(model_dir, str):
            self._send_json(400, {"error": "invalid_request",
                                  "message": "model_dir (str) is required"})
            return
        # "draft_dir" absent = leave the spec-decode draft alone;
        # present (a path, or null to drop it) = stage it with the target
        kw = {}
        if "draft_dir" in body:
            draft_dir = body["draft_dir"]
            if draft_dir is not None and not isinstance(draft_dir, str):
                self._send_json(400, {"error": "invalid_request",
                                      "message": "draft_dir must be a "
                                                 "string or null"})
                return
            kw["draft_dir"] = draft_dir
        strategy = body.get("strategy", "rolling")
        if strategy not in ("rolling", "canary", "surge"):
            self._send_json(400, {"error": "invalid_request",
                                  "message": "strategy must be one of "
                                             "rolling|canary|surge"})
            return
        kw["strategy"] = strategy
        for key, lo, hi in (("canary_fraction", 0.0, 1.0),
                            ("judge_window_s", 0.0, None)):
            if key not in body:
                continue
            v = body[key]
            if (not isinstance(v, (int, float)) or isinstance(v, bool)
                    or v < lo or (hi is not None and v > hi)
                    or (key == "judge_window_s" and v <= 0)):
                self._send_json(400, {"error": "invalid_request",
                                      "message": f"{key} out of range"})
                return
            kw[key] = float(v)
        try:
            started = gw.start_deploy(model_dir,
                                      rollback=bool(body.get("rollback",
                                                             True)), **kw)
        except Exception as e:
            self._send_json(500, {"error": "internal", "message": repr(e)})
            return
        if not started:
            self._send_json(409, {"error": "deploy_in_progress",
                                  **gw.deploy_view()})
            return
        self._send_json(200, gw.deploy_view())

    def _admin_adapters(self, gw: "Gateway") -> None:
        """Operate the fleet's LoRA adapter pool: ``op="load"`` stages the
        adapter file at ``path`` onto EVERY replica (each load shadow-
        probed with one off-path generate; any failure rolls the whole
        stage back), ``op="unload"`` drops it fleet-wide, ``op="list"``
        returns residency. Same 409-under-lock discipline as
        ``/admin/deploy`` — adapter churn and weight rollouts never
        interleave — and every op lands in the adapter journal."""
        body = self._read_body()
        if body is None:
            return
        op = body.get("op", "list")
        if op not in ("load", "unload", "list"):
            self._send_json(400, {"error": "invalid_request",
                                  "message": "op must be one of "
                                             "load|unload|list"})
            return
        if op == "list":
            self._send_json(200, gw.adapters_view())
            return
        adapter_id = body.get("adapter_id")
        if not adapter_id or not isinstance(adapter_id, str):
            self._send_json(400, {"error": "invalid_request",
                                  "message": "adapter_id (str) is "
                                             "required"})
            return
        kw = {}
        if op == "load":
            path = body.get("path")
            if not path or not isinstance(path, str):
                self._send_json(400, {"error": "invalid_request",
                                      "message": "path (str) is required "
                                                 "for op=load"})
                return
            kw["path"] = path
            if body.get("alpha") is not None:
                kw["alpha"] = float(body["alpha"])
            if body.get("rank") is not None:
                kw["rank"] = int(body["rank"])
            if body.get("digest") is not None:
                kw["digest"] = str(body["digest"])
        with gw._deploy_lock:
            busy = bool(gw.deploy_status.get("deploying"))
        if busy:
            self._send_json(409, {"error": "deploy_in_progress",
                                  **gw.deploy_view()})
            return
        try:
            out = gw.admin_adapters(op, adapter_id, **kw)
        except ValueError as e:
            self._send_json(400, {"error": "invalid_request",
                                  "message": str(e)})
            return
        except Exception as e:
            self._send_json(500, {"error": "internal", "message": repr(e)})
            return
        status = out.get("status")
        if status in ("loaded", "unloaded"):
            self._send_json(200, out)
        elif status == "pinned":
            self._send_json(409, {"error": "adapter_busy", **out})
        else:                       # rolled_back / partial
            self._send_json(500, {"error": "stage_failed", **out})

    def _admin_autoscale(self, gw: "Gateway") -> None:
        """Operate the autoscaler: enable/disable the loop and move the
        policy's min/max bounds. Same 409-under-lock semantics as
        ``/admin/deploy`` — while a rollout (or a scale event) holds the
        deploy lock, reconfiguration is refused, not raced."""
        body = self._read_body()
        if body is None:
            return
        ctrl = gw.autoscaler
        if ctrl is None:
            self._send_json(404, {"error": "not_found",
                                  "message": "autoscaler disabled "
                                             "(Gateway(autoscale=True))"})
            return
        cfg = {}
        if "enabled" in body:
            if not isinstance(body["enabled"], bool):
                self._send_json(400, {"error": "invalid_request",
                                      "message": "enabled must be a bool"})
                return
            cfg["enabled"] = body["enabled"]
        for key in ("min_replicas", "max_replicas"):
            if key not in body:
                continue
            v = body[key]
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                self._send_json(400, {"error": "invalid_request",
                                      "message": f"{key} must be a "
                                                 f"positive int"})
                return
            cfg[key] = v
        with gw._deploy_lock:
            busy = bool(gw.deploy_status.get("deploying"))
        if busy:
            self._send_json(409, {"error": "deploy_in_progress",
                                  **gw.deploy_view()})
            return
        try:
            out = ctrl.configure(**cfg)
        except ValueError as e:
            self._send_json(400, {"error": "invalid_request",
                                  "message": str(e)})
            return
        self._send_json(200, out)

    def _batch_job(self, gw: "Gateway"):
        """Resolve ``/v1/batch/<id>[/results]`` → (job, tail) or None after
        answering 404."""
        parts = self.path.split("/")          # '', 'v1', 'batch', id[, tail]
        job_id = parts[3] if len(parts) > 3 else ""
        tail = parts[4] if len(parts) > 4 else ""
        job = gw.jobs.get(job_id)
        if job is None:
            self._send_json(404, {"error": "not_found", "job_id": job_id})
            return None
        return job, tail

    def _batch_get(self, gw: "Gateway") -> None:
        hit = self._batch_job(gw)
        if hit is None:
            return
        job, tail = hit
        if tail == "results":
            # completed rows so far, index order, one JSON object per line
            data = "".join(json.dumps(r) + "\n"
                           for r in job.result_rows()).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        elif tail == "":
            self._send_json(200, job.progress())
        else:
            self._send_json(404, {"error": "not_found", "path": self.path})

    def do_DELETE(self) -> None:  # noqa: N802
        gw = self.server.gateway
        try:
            if not self.path.startswith("/v1/batch/"):
                self._send_json(404, {"error": "not_found",
                                      "path": self.path})
                return
            hit = self._batch_job(gw)
            if hit is None:
                return
            job, tail = hit
            if tail:
                self._send_json(404, {"error": "not_found",
                                      "path": self.path})
                return
            job.cancel()
            self._send_json(200, job.progress())
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True


class Gateway:
    """One serving process: HTTP listener + replica fleet + lifecycle.

    ``replicas`` is a :class:`ReplicaSet`, one engine, or a list of engines.
    ``grace_s`` defaults to the runtime layer's ``preempt_grace_s``
    (:func:`ddw_tpu_torch.gateway.lifecycle.runtime_grace_s`). ``port=0`` binds an
    ephemeral port (read it back from :attr:`port` — the TOCTOU-free
    pattern, same reason the Launcher respawns on fresh ports).

    ``supervise=True`` (default) runs a :class:`~ddw_tpu_torch.gateway.
    ReplicaSupervisor` over the fleet for the gateway's lifetime: failed
    replicas restart within budget and rejoin warm; ``supervisor_kw``
    forwards its knobs (``max_restarts``, ``stall_timeout_s``, ...).
    """

    def __init__(self, replicas, host: str = "127.0.0.1", port: int = 0,
                 grace_s: float | None = None, supervise: bool = True,
                 supervisor_kw: dict | None = None,
                 job_ledger_dir: str | None = None, trace: bool = False,
                 trace_capacity: int = 8192, telemetry: bool = False,
                 telemetry_interval_s: float = 0.25,
                 telemetry_capacity: int = 4096, slos=None,
                 slo_kw: dict | None = None,
                 degradation_dir: str | None = None,
                 deploy_journal_dir: str | None = None,
                 autoscale: bool = False,
                 autoscale_kw: dict | None = None,
                 autoscale_journal_dir: str | None = None):
        self.replica_set = (replicas if isinstance(replicas, ReplicaSet)
                            else ReplicaSet(replicas))
        # end-to-end tracing (docs/observability.md): the gateway mints
        # trace ids, records http + routing spans, and /v1/trace merges
        # its ring with every replica's into one Perfetto file
        self.tracer = (Tracer(capacity=trace_capacity, process="gateway")
                       if trace else None)
        self.replica_set.tracer = self.tracer
        self.lifecycle = ServerLifecycle(grace_s)
        self.lifecycle.health_fn = self.replica_set.fleet_health
        self._host, self._want_port = host, port
        self._httpd: _GatewayHTTPServer | None = None
        self._http_thread: threading.Thread | None = None
        self._drain_lock = threading.Lock()
        self.drained_clean: bool | None = None   # last drain's verdict
        self._supervise = supervise
        self._supervisor_kw = dict(supervisor_kw or {})
        self.supervisor: ReplicaSupervisor | None = None
        # batch-lane job registry: host-side, above the replicas, so jobs
        # survive engine restarts/recycles (the pump resubmits; results
        # recorded here are never lost). With ``job_ledger_dir`` the ledger
        # is DURABLE: specs and completed rows persist to disk and a
        # restarted gateway resumes every unfinished job mid-flight.
        self.jobs = JobLedger(ledger_dir=job_ledger_dir)
        # live telemetry plane (docs/observability.md): the gateway samples
        # its own routing state into a hub, polls every replica's feed, and
        # merges the fleet into aligned windows the SLO monitor evaluates
        self._telemetry = bool(telemetry)
        self.telem = (TelemetryHub(capacity=telemetry_capacity,
                                   interval_s=telemetry_interval_s,
                                   source="gateway")
                      if telemetry else None)
        self.fleet_telemetry = FleetTelemetry() if telemetry else None
        self.replica_set.telemetry = self.fleet_telemetry
        self._telemetry_interval_s = float(telemetry_interval_s)
        self._telemetry_thread: threading.Thread | None = None
        self._telemetry_stop = threading.Event()
        self.slo_monitor: SLOMonitor | None = None
        if telemetry:
            self.telem.add_collector(self._telemetry_collector)
            if slos:
                self.slo_monitor = SLOMonitor(
                    slos, tracer=self.tracer, dump_dir=degradation_dir,
                    flight_fn=self._flight_tail, **(slo_kw or {}))
        # rollout state, surfaced through /stats and /readyz; the
        # DeployController thread (start_deploy) mutates it under the lock.
        # With ``deploy_journal_dir`` every rollout journals its plan +
        # per-step progress there (fsync'd), and start() runs a reconciler
        # that converges whatever a dead gateway left half-rolled.
        self._deploy_lock = threading.Lock()
        self._deploy_thread: threading.Thread | None = None
        self._deploy_journal_dir = deploy_journal_dir
        self.deploy_status: dict = {"deploying": False, "status": "idle",
                                    "fleet_generation": 0, "steps": []}
        # adapter-op journal (the /admin/adapters side of the deploy
        # discipline): every staged load/unload lands here with its
        # per-replica step record; with ``deploy_journal_dir`` each entry
        # is also appended to adapters.jsonl for post-crash forensics
        self._adapter_ops: list[dict] = []
        # traffic-driven autoscaling (docs/serving.md): a reconciler loop
        # over the telemetry plane's windows, sharing the deploy lock so a
        # rollout and a scale event can never interleave. Constructed in
        # start() (it wants the supervisor); ``autoscale_kw`` forwards the
        # controller/policy knobs; ``autoscale_journal_dir`` makes every
        # scale event crash-recoverable the same way deploys are.
        self._autoscale = bool(autoscale)
        self._autoscale_kw = dict(autoscale_kw or {})
        self._autoscale_journal_dir = autoscale_journal_dir
        self.autoscaler = None

    # -- lifecycle -----------------------------------------------------------
    def start(self, warmup_prompt_lens=(8,), on_listening=None) -> "Gateway":
        """Bring the listener up FIRST (``/healthz`` answers while the
        replicas warm up), then warm every replica's program lattice, then flip
        ``/readyz`` — readiness is gated on warmup by construction.
        ``on_listening(port)`` fires the moment the socket is bound (before
        warmup) — the process-replica child uses it to hand its port to the
        parent so health is observable through the compile."""
        if self._httpd is not None:
            return self
        self.replica_set.start()
        self._httpd = _GatewayHTTPServer((self._host, self._want_port), self)
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="ddw-gateway-http",
            daemon=True)
        self._http_thread.start()
        if on_listening is not None:
            on_listening(self.port)
        if warmup_prompt_lens:
            self.replica_set.warmup(warmup_prompt_lens)
        if self._supervise and self.supervisor is None:
            kw = dict(warmup_prompt_lens=warmup_prompt_lens or (),
                      lifecycle=self.lifecycle)
            kw.update(self._supervisor_kw)
            self.supervisor = ReplicaSupervisor(self.replica_set,
                                                **kw).start()
        self.jobs.resume(self.replica_set)   # durable ledger: restart any
        #                                      job a dead gateway left behind
        self._reconcile_deploy()             # rollout journal: converge a
        #                                      half-rolled fleet the same way
        if self._autoscale and self.autoscaler is None:
            from ddw_tpu_torch.autoscale.controller import AutoscaleController
            kw = dict(
                merged_fn=(self.fleet_telemetry.merged
                           if self.fleet_telemetry is not None else None),
                slo_status_fn=(self.slo_monitor.status
                               if self.slo_monitor is not None else None),
                lifecycle=self.lifecycle)
            kw.update(self._autoscale_kw)   # tests inject their own inputs
            self.autoscaler = AutoscaleController(
                self.replica_set, supervisor=self.supervisor,
                journal_dir=self._autoscale_journal_dir,
                deploy_lock=self._deploy_lock,
                deploy_status=self.deploy_status, **kw)
            self.autoscaler.reconcile()      # scale journal: finalize what
            #                                  a dead gateway left mid-scale
            self.autoscaler.start()
        if self._telemetry and self._telemetry_thread is None:
            self.telem.start()
            self._telemetry_stop.clear()
            self._telemetry_thread = threading.Thread(
                target=self._telemetry_loop, name="ddw-gateway-telemetry",
                daemon=True)
            self._telemetry_thread.start()
        self.lifecycle.mark_ready()
        return self

    # -- weight rollouts ------------------------------------------------------
    def deploy_view(self) -> dict:
        """The /stats deploy block: rollout state + per-replica checkpoint
        ids (what a load balancer or drill needs to observe a rollout).
        Nested values (steps, the canary verdict forensics, per-replica
        end states) are deep-copied so readers never alias the
        controller's live dicts."""
        with self._deploy_lock:
            out = copy.deepcopy(self.deploy_status)
        out["checkpoints"] = [h.get("checkpoint")
                              for h in self.replica_set.fleet_health()]
        return out

    def start_deploy(self, model_dir: str, rollback: bool = True,
                     **kw) -> bool:
        """Launch a weight rollout across the fleet on a control thread
        (the ``POST /admin/deploy`` implementation; ``kw`` carries
        ``strategy`` / ``canary_fraction`` / ``judge_window_s`` /
        ``draft_dir`` through to the controller). Returns False when a
        rollout is already in flight. Requires the supervisor (its recycle
        path IS the per-replica roll).

        The whole check → validate → construct → dispatch sequence holds
        ONE lock: the guard flag and the strategy dispatch used to be two
        critical sections, so two concurrent POSTs could both pass the
        guard — and a constructor that raised (bad strategy) left
        ``deploying`` stuck True with no controller behind it. Now exactly
        one caller wins, and a failed construction restores the idle
        state before re-raising."""
        from ddw_tpu_torch.deploy.controller import DeployController
        from ddw_tpu_torch.deploy.journal import RolloutJournal

        if self.supervisor is None:
            raise RuntimeError("rolling deploy needs supervise=True "
                               "(the supervisor owns the recycle path)")
        with self._deploy_lock:
            if self.deploy_status.get("deploying"):
                return False
            prev = dict(self.deploy_status)
            self.deploy_status.update(deploying=True, status="starting",
                                      target_dir=model_dir, steps=[])
            self.deploy_status.pop("canary", None)
            self.deploy_status.pop("replica_end_state", None)
            self.deploy_status.pop("resumed", None)
            try:
                journal = (RolloutJournal(self._deploy_journal_dir)
                           if self._deploy_journal_dir else None)
                ctrl = DeployController(self.replica_set, self.supervisor,
                                        model_dir, rollback=rollback,
                                        status=self.deploy_status,
                                        status_lock=self._deploy_lock,
                                        tracer=self.tracer,
                                        journal=journal, **kw)
                self._deploy_thread = threading.Thread(
                    target=ctrl.run, name="ddw-deploy", daemon=True)
                self._deploy_thread.start()
            except BaseException:
                self.deploy_status.clear()
                self.deploy_status.update(prev)
                raise
        return True

    def _reconcile_deploy(self) -> None:
        """Startup reconciler (the journal's read side): an unfinished
        rollout journal — or a mixed-digest fleet with no journal — from a
        previous gateway life converges on a deploy thread, exactly as a
        fresh ``start_deploy`` would run it. Best-effort: reconciliation
        must never block or kill startup."""
        if not self._deploy_journal_dir or self.supervisor is None:
            return
        from ddw_tpu_torch.deploy.controller import resume_rollout

        try:
            ctrl = resume_rollout(self.replica_set, self.supervisor,
                                  self._deploy_journal_dir,
                                  status=self.deploy_status,
                                  status_lock=self._deploy_lock,
                                  tracer=self.tracer)
        except Exception:
            return
        if ctrl is None:
            return
        with self._deploy_lock:
            if self.deploy_status.get("deploying"):
                return
            self.deploy_status.update(deploying=True, status="resuming",
                                      steps=[])
            self._deploy_thread = threading.Thread(
                target=ctrl.run, name="ddw-deploy", daemon=True)
            self._deploy_thread.start()

    # -- adapter staging ------------------------------------------------------
    def adapters_view(self) -> dict:
        """The /stats adapters block: the gateway's digest registry (the
        routing salt source), each replica's residency view, and the op
        journal tail."""
        per: dict[str, dict] = {}
        for i, eng in enumerate(list(self.replica_set.replicas)):
            fn = getattr(eng, "adapter_view", None)
            if fn is None:
                continue
            try:
                v = fn()
                if v:               # {} = this replica has no adapter pool
                    per[str(i)] = v
            except Exception:
                per[str(i)] = {"error": "unreachable"}
        with self._deploy_lock:
            ops = copy.deepcopy(self._adapter_ops[-16:])
        return {"registry": dict(self.replica_set.adapter_digests),
                "replicas": per, "ops": ops}

    def _journal_adapter_op(self, entry: dict) -> None:
        with self._deploy_lock:
            self._adapter_ops.append(entry)
            del self._adapter_ops[:-64]
        if not self._deploy_journal_dir:
            return
        try:
            os.makedirs(self._deploy_journal_dir, exist_ok=True)
            with open(os.path.join(self._deploy_journal_dir,
                                   "adapters.jsonl"), "a") as f:
                f.write(json.dumps(entry) + "\n")
                f.flush()
        except OSError:
            pass                    # forensics, not correctness

    def admin_adapters(self, op: str, adapter_id: str,
                       path: str | None = None, alpha: float = 16.0,
                       rank: int | None = None,
                       digest: str | None = None) -> dict:
        """Stage (``op="load"``) or drop (``op="unload"``) a LoRA adapter
        across the fleet — the ``POST /admin/adapters`` implementation.

        Loads are STAGED like weight rollouts: replica by replica, each
        load followed by a shadow probe (one real 1-step generate under
        the adapter, off the routed path); the first failure unloads the
        adapter from every replica that took it and the entry records
        ``rolled_back`` — the fleet never ends half-resident. The adapter
        rides a FILE (``save_adapter``'s npz), the same shared-disk
        contract checkpoints use, so process replicas stage it the same
        way in-thread ones do. On success the adapter's digest lands in
        the ReplicaSet registry, which is what turns on adapter-salted
        prefix routing for it."""
        entry: dict = {"op": op, "adapter_id": adapter_id,
                       "t": time.time(), "steps": []}
        replicas = list(self.replica_set.replicas)
        if op == "load":
            entry["path"] = path
            staged: list[int] = []
            out_digest = None
            for i, eng in enumerate(replicas):
                step: dict = {"replica": i}
                entry["steps"].append(step)
                fn = getattr(eng, "load_adapter", None)
                if fn is None:
                    step.update(status="unsupported")
                else:
                    try:
                        info = fn(adapter_id, path=path, alpha=alpha,
                                  rank=rank, digest=digest)
                        step.update(status="loaded",
                                    slot=info.get("slot"),
                                    digest=info.get("digest"))
                        staged.append(i)
                        out_digest = info.get("digest") or out_digest
                        self._probe_adapter(eng, adapter_id)
                        step["probe"] = "ok"
                    except Exception as e:
                        step.update(status="failed", error=repr(e))
                if step.get("probe") != "ok":
                    # roll the stage back: every replica that took the
                    # adapter drops it, so routing state stays uniform
                    for j in staged:
                        try:
                            replicas[j].unload_adapter(adapter_id)
                        except Exception:
                            pass
                    entry["status"] = "rolled_back"
                    self._journal_adapter_op(entry)
                    return entry
            entry["status"] = "loaded"
            entry["digest"] = out_digest
            if out_digest:
                self.replica_set.adapter_digests[adapter_id] = out_digest
            self._journal_adapter_op(entry)
            return entry
        if op != "unload":
            raise ValueError(f"unknown adapter op {op!r}")
        pinned = failed = False
        for i, eng in enumerate(replicas):
            step = {"replica": i}
            entry["steps"].append(step)
            fn = getattr(eng, "unload_adapter", None)
            if fn is None:
                step.update(status="unsupported")
                continue
            try:
                fn(adapter_id)
                step.update(status="unloaded")
            except Exception as e:
                msg = repr(e)
                step.update(status=("pinned" if "pinned" in msg
                                    else "failed"), error=msg)
                pinned = pinned or step["status"] == "pinned"
                failed = True
        entry["status"] = ("pinned" if pinned
                           else "partial" if failed else "unloaded")
        if not failed:
            self.replica_set.adapter_digests.pop(adapter_id, None)
        self._journal_adapter_op(entry)
        return entry

    @staticmethod
    def _probe_adapter(eng, adapter_id: str, timeout_s: float = 30.0):
        """Shadow probe for a staged load: one real 1-step generate under
        the adapter, off the routed path (mirrors ProcessReplica.probe).
        Raises on any failure — the caller rolls the stage back."""
        fut = eng.submit_generate(np.asarray([1, 2, 3, 4], np.int32), 1,
                                  temperature=0.0, adapter_id=adapter_id)
        res = fut.result(timeout=timeout_s)
        if not len(res.tokens):
            raise RuntimeError(f"adapter probe for {adapter_id!r} "
                               f"returned no tokens")

    def autoscale_view(self) -> dict | None:
        """The /stats autoscale block (None when autoscaling is off):
        enabled flag, desired vs actual, last decision + reason,
        per-direction cooldown remaining, policy knobs, event counters."""
        ctrl = self.autoscaler
        return ctrl.view() if ctrl is not None else None

    # -- tracing --------------------------------------------------------------
    def trace_summary(self) -> dict | None:
        """The /stats trace block: gateway-ring summary + per-replica ring
        summaries, with fleet-total ``spans_dropped`` (truncation is never
        silent). None when this gateway does not trace."""
        if self.tracer is None:
            return None
        out = {"gateway": self.tracer.summary(), "replicas": [],
               "spans_dropped": self.tracer.spans_dropped}
        for i, eng in enumerate(self.replica_set.replicas):
            fetch = getattr(eng, "trace_summary", None)
            if fetch is None:
                h = (eng.health() if hasattr(eng, "health") else {})
                s = h.get("trace")
            else:
                s = fetch()
            if s:
                out["replicas"].append({"replica": i, **s})
                out["spans_dropped"] += int(s.get("dropped", 0) or 0)
        return out

    def trace_dump(self) -> dict:
        """Merged fleet trace — the gateway's ring plus every replica's
        drained ring (a :class:`~ddw_tpu_torch.deploy.ProcessReplica` relays its
        child's over HTTP), events in timestamp order on the shared
        epoch-anchored timeline."""
        events: list[dict] = []
        dropped = 0
        sources: list[str] = []
        if self.tracer is not None:
            events.extend(self.tracer.drain())
            dropped += self.tracer.spans_dropped
            sources.append(self.tracer.process)
        for i, eng in enumerate(self.replica_set.replicas):
            fetch = getattr(eng, "trace_events", None)
            if fetch is None:
                continue
            try:
                d = fetch(0)
            except Exception:
                continue    # a mid-death replica must not break the dump
            evs = d.get("events", [])
            if evs:
                events.extend(evs)
                sources.append(f"replica{i}")
            dropped += int(d.get("dropped", 0) or 0)
        events.sort(key=lambda e: e.get("ts", 0.0))
        return {"events": events, "dropped": dropped, "sources": sources}

    def lane_stats(self) -> dict:
        """Per-lane fleet view for ``/stats`` and ``/readyz``: queue depths
        summed across replicas, the worst reserve occupancy (one saturated
        replica is the one a new interactive arrival might land on), and
        the job ledger's accounting."""
        interactive = batch = 0
        occupancy = 0.0
        for h in self.replica_set.fleet_health():
            interactive += int(h.get("interactive_depth", 0) or 0)
            batch += int(h.get("batch_depth", 0) or 0)
            occupancy = max(occupancy,
                            float(h.get("reserve_occupancy_pct", 0.0) or 0.0))
        return {"interactive_depth": interactive, "batch_depth": batch,
                "reserve_occupancy_pct": round(occupancy, 2),
                **self.jobs.summary()}

    # -- telemetry / SLOs -----------------------------------------------------
    def _telemetry_collector(self) -> dict:
        """The gateway's own signals, sampled each hub tick: connection and
        in-flight load, routing state (outstanding work, open breakers, the
        best replica's projected wait — what :meth:`ReplicaSet._score`
        ranks on), and the retry/failover counters."""
        rs = self.replica_set
        out = {
            "gateway.connections": ("gauge", float(
                self._httpd.active_connections if self._httpd else 0)),
            "gateway.inflight": ("gauge", float(self.lifecycle.inflight)),
            "gateway.outstanding": ("gauge", float(sum(rs._outstanding))),
            "gateway.breaker_open": ("gauge", float(sum(
                1 for b in rs.breakers if b.state != "closed"))),
            "gateway.retried_429": ("counter", float(rs.retried_429)),
            "gateway.replica_failures": ("counter",
                                         float(rs.replica_failures)),
            "gateway.failed_over": ("counter", float(rs.failed_over)),
        }
        try:
            scored = rs._scored(weighted=False)
            if scored:
                out["gateway.projected_wait_ms"] = ("gauge",
                                                    float(scored[0][0]))
        except Exception:
            pass    # a mid-death replica must not kill the sampler tick
        return out

    def _flight_tail(self) -> list:
        """Last trace events across the fleet — the flight-recorder tail a
        degradation dump freezes alongside the offending windows."""
        if self.tracer is None:
            return []
        try:
            return self.trace_dump()["events"][-64:]
        except Exception:
            return []

    def _telemetry_loop(self) -> None:
        while not self._telemetry_stop.wait(self._telemetry_interval_s):
            try:
                self._telemetry_tick()
            except Exception:
                pass    # the plane observes the fleet; it never takes it down

    def _telemetry_tick(self) -> None:
        """One merge cycle: ingest the gateway hub's fresh samples plus
        every replica's drained feed into the fleet store (seq-watermarked,
        like the trace relay), hand the fresh samples to the SLO monitor's
        budget accounting, then evaluate burn rates over the merged
        windows."""
        fleet = self.fleet_telemetry
        fresh_by_src = {}
        fresh = fleet.ingest("gateway",
                             self.telem.drain(fleet.watermark("gateway")))
        if fresh:
            fresh_by_src["gateway"] = fresh
        for i, eng in enumerate(self.replica_set.replicas):
            fetch = getattr(eng, "telemetry_events", None)
            if fetch is None:
                continue
            src = f"replica{i}"
            try:
                feed = fetch(fleet.watermark(src))
            except Exception:
                continue    # a mid-death replica freezes, it doesn't break
            fresh = fleet.ingest(src, feed)
            if fresh:
                fresh_by_src[src] = fresh
        if self.slo_monitor is not None:
            for src, samples in fresh_by_src.items():
                self.slo_monitor.ingest(src, samples)
            self.slo_monitor.evaluate(fleet.feeds())

    def telemetry_summary(self) -> dict | None:
        """The /stats telemetry block: gateway-hub summary + per-source
        sample counts in the fleet store, with fleet-total
        ``samples_dropped`` (truncation is never silent). None when this
        gateway does not sample."""
        if not self._telemetry:
            return None
        out = {"gateway": self.telem.summary(),
               "sources": self.fleet_telemetry.sources(),
               "samples_dropped": self.telem.samples_dropped}
        for i, eng in enumerate(self.replica_set.replicas):
            fetch = getattr(eng, "health", None)
            if fetch is None:
                continue
            try:
                s = fetch().get("telemetry")
            except Exception:
                continue
            if s:
                out["samples_dropped"] += int(s.get("dropped", 0) or 0)
        return out

    def telemetry_view(self) -> dict:
        """The bare ``GET /v1/telemetry`` body: the fleet's merged windowed
        aggregates plus the SLO monitor's status (objectives, states, error
        budgets, recent transitions)."""
        merged = self.fleet_telemetry.merged()
        out = {"now": merged["now"], "sources": merged["sources"],
               "windows": merged["windows"]}
        if self.slo_monitor is not None:
            out["slo"] = self.slo_monitor.status()
        return out

    def slo_prometheus(self) -> str:
        """Prometheus exposition lines appended to ``/metrics`` when the
        telemetry plane is on: per-objective alert state (0 ok / 1 warning
        / 2 page), budget consumption, attainment, and the hub's dropped-
        sample counter. Empty string otherwise — the base exposition is
        untouched for a telemetry-off gateway."""
        if not self._telemetry:
            return ""
        lines = [
            "# HELP ddw_telemetry_samples_dropped Telemetry samples lost "
            "to ring overflow (gateway hub).",
            "# TYPE ddw_telemetry_samples_dropped counter",
            f"ddw_telemetry_samples_dropped {self.telem.samples_dropped}",
        ]
        if self.slo_monitor is not None:
            from ddw_tpu_torch.obs.slo import _LEVEL
            st = self.slo_monitor.status()
            lines += ["# HELP ddw_slo_state Alert FSM level per objective "
                      "(0 ok, 1 warning, 2 page).",
                      "# TYPE ddw_slo_state gauge"]
            for name, obj in st["objectives"].items():
                lines.append(f'ddw_slo_state{{objective="{name}"}} '
                             f'{_LEVEL[obj["state"]]}')
            lines += ["# HELP ddw_slo_budget_consumed_pct Error budget "
                      "consumed per objective (cumulative, percent).",
                      "# TYPE ddw_slo_budget_consumed_pct gauge"]
            for name, obj in st["objectives"].items():
                lines.append(
                    f'ddw_slo_budget_consumed_pct{{objective="{name}"}} '
                    f'{obj["budget"]["budget_consumed_pct"]}')
            lines += ["# HELP ddw_slo_attainment Fraction of events that "
                      "met the objective (cumulative).",
                      "# TYPE ddw_slo_attainment gauge"]
            for name, obj in st["objectives"].items():
                lines.append(f'ddw_slo_attainment{{objective="{name}"}} '
                             f'{obj["budget"]["attainment"]}')
        return "\n".join(lines) + "\n"

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("gateway not started")
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def drain(self, grace_s: float | None = None) -> bool:
        """Graceful shutdown: stop admission (new requests 503), wait out
        in-flight responses up to the grace window, stop the engines, close
        the listener. Returns True when every in-flight request finished
        inside the window. Idempotent — a second caller blocks until the
        first drain completes, then reports its verdict."""
        with self._drain_lock:
            if not self.lifecycle.begin_drain():
                return bool(self.drained_clean)
            self.jobs.shutdown()   # stop the batch pumps first — nothing
            #                        may resubmit into a closing fleet
            clean = self.lifecycle.await_drained(
                grace_s if grace_s is not None else self.lifecycle.grace_s)
            if self.autoscaler is not None:
                self.autoscaler.stop()   # no scale events during teardown
                self.autoscaler = None
            if self.supervisor is not None:
                self.supervisor.stop()   # no resurrections during teardown
                self.supervisor = None
            if self._telemetry_thread is not None:
                self._telemetry_stop.set()
                self._telemetry_thread.join(timeout=5.0)
                self._telemetry_thread = None
            if self.telem is not None:
                self.telem.stop()
            self.replica_set.stop()   # stragglers' futures fail loudly here
            if self._httpd is not None:
                self._httpd.shutdown()
                if self._http_thread is not None:
                    self._http_thread.join(timeout=10.0)
                self._httpd.server_close()
                self._httpd = None
            self.lifecycle.restore_sigterm()
            self.lifecycle.mark_stopped()
            self.drained_clean = clean
            return clean

    def stop(self) -> bool:
        return self.drain()

    def install_sigterm(self) -> None:
        """SIGTERM → drain, the serving analog of the training gang's
        graceful preemption (main thread only)."""
        self.lifecycle.install_sigterm(self.drain)

    def __enter__(self) -> "Gateway":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.drain()
