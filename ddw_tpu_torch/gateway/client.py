"""Python client for the HTTP gateway — retries that honor backpressure.

The gateway's 429 reply is not an error so much as a scheduling hint: the
body carries the engine's own ``retry_after_ms`` estimate (queue depth x
the decaying per-request service time) and the header carries the RFC
``Retry-After`` seconds. A client that retries immediately converts
backpressure into a thundering herd; this one sleeps exactly what the
server asked (the precise ms from the body when present, the coarser
header otherwise, capped exponential backoff when neither is given) and
gives up after ``max_retries`` with the structured refusal intact.

Stdlib only (``http.client``), deliberately: it runs inside the test suite
and ``tools/load_gen.py``, and is the reference for what any real client
(another language, a sidecar) must implement — the protocol is plain
enough that this file IS the spec: JSON bodies, NDJSON streaming lines,
and the status table in :mod:`ddw_tpu_torch.gateway.http`.

Retryable: 429 (engine queue full) and 503 (gateway starting, draining, a
replica died mid-request, or every circuit is open — a fleet peer or the
supervisor's restarted replica may answer; the balancer decides). Not
retryable: 504 (the request's own deadline died — retrying re-spends it),
400, 500.

Connections are HTTP/1.1 keep-alive and REUSED: completed unary exchanges
return their connection to a small per-client pool, so a retry storm (the
chaos drill: one replica dies, every client backs off and re-asks) does
not re-handshake per attempt and the gateway's ``max_connections`` guard
is not eaten by churn. Streaming responses close their connection (the
server ends the chunked stream with ``Connection: close``). A pooled
connection the server quietly closed between requests is detected on use
and replayed once on a fresh one. One client per thread is the intended
shape (the pool makes sharing safe, not fast).

The port of ``ddw_tpu.gateway.client``: the same host logic,
importing nothing of ``ddw_tpu``.
"""

from __future__ import annotations

import http.client
import json
import threading
import time

__all__ = ["GatewayClient", "GatewayError", "GatewayOverloaded",
           "GatewayUnavailable", "GatewayDeadline"]


class GatewayError(RuntimeError):
    """Non-2xx reply, structured body preserved."""

    def __init__(self, status: int, body: dict):
        self.status = status
        self.body = body
        super().__init__(f"gateway returned {status}: {body}")


class GatewayOverloaded(GatewayError):
    """429 survived every retry — the fleet really is full."""


class GatewayUnavailable(GatewayError):
    """503 survived every retry — not ready, or draining for good."""


class GatewayDeadline(GatewayError):
    """504 — the request's deadline passed while it was queued."""


_RETRYABLE = (429, 503)


class GatewayClient:
    """Thin blocking client; one connection per request (the gateway is
    thread-per-connection — holding sockets open across calls buys nothing
    a benchmark would notice and costs drain determinism)."""

    def __init__(self, host: str, port: int, timeout_s: float = 60.0,
                 max_retries: int = 4, backoff_s: float = 0.05,
                 max_backoff_s: float = 2.0, pool_size: int = 4):
        self.host, self.port = host, port
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.pool_size = pool_size
        self.retries = 0            # total backoff sleeps taken (telemetry)
        self.reused = 0             # keep-alive connections reused
        self._pool: list[http.client.HTTPConnection] = []
        self._pool_lock = threading.Lock()

    # -- transport -----------------------------------------------------------
    def _connect(self) -> http.client.HTTPConnection:
        return http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout_s)

    def _acquire(self) -> tuple[http.client.HTTPConnection, bool]:
        """A pooled keep-alive connection when one is idle, else fresh.
        The bool says "pooled" — a stale pooled socket gets one replay."""
        with self._pool_lock:
            if self._pool:
                self.reused += 1
                return self._pool.pop(), True
        return self._connect(), False

    def _done(self, conn: http.client.HTTPConnection, resp) -> None:
        """Return a fully-read connection to the pool (keep-alive) or close
        it (server said close / stream / pool full)."""
        reusable = (resp is not None and not resp.will_close
                    and resp.isclosed())
        if reusable:
            with self._pool_lock:
                if len(self._pool) < self.pool_size:
                    self._pool.append(conn)
                    return
        conn.close()

    def close(self) -> None:
        with self._pool_lock:
            pool, self._pool = self._pool, []
        for conn in pool:
            conn.close()

    def _retry_delay(self, resp_headers, body: dict, attempt: int) -> float:
        ms = body.get("retry_after_ms") if isinstance(body, dict) else None
        if ms:
            return float(ms) / 1e3
        ra = resp_headers.get("Retry-After")
        if ra:
            try:
                return float(ra)
            except ValueError:
                pass
        return min(self.backoff_s * (2 ** attempt), self.max_backoff_s)

    def _request(self, method: str, path: str, body: dict | None = None,
                 retry: bool = True, headers: dict | None = None):
        """One exchange with retry-on-backpressure. Returns
        ``(status, headers, response, connection)``; the caller reads the
        body and closes the connection."""
        payload = json.dumps(body).encode() if body is not None else None
        hdrs = {"Content-Type": "application/json"}
        if headers:
            hdrs.update(headers)
        attempt = 0
        while True:
            conn, pooled = self._acquire()
            try:
                conn.request(method, path, body=payload, headers=hdrs)
                resp = conn.getresponse()
            except (OSError, http.client.BadStatusLine,
                    http.client.CannotSendRequest) as e:
                conn.close()
                if pooled:      # the server closed the idle keep-alive
                    continue    # socket between requests; replay fresh once
                raise e
            except Exception:
                conn.close()
                raise
            try:
                if retry and resp.status in _RETRYABLE \
                        and attempt < self.max_retries:
                    parsed = json.loads(resp.read() or b"{}")
                    delay = self._retry_delay(resp.headers, parsed, attempt)
                    self._done(conn, resp)
                    self.retries += 1
                    attempt += 1
                    time.sleep(delay)
                    continue
                return resp.status, resp.headers, resp, conn
            except Exception:
                conn.close()
                raise

    def _json_call(self, method: str, path: str, body: dict | None = None,
                   headers: dict | None = None) -> dict:
        status, _headers, resp, conn = self._request(method, path, body,
                                                     headers=headers)
        try:
            parsed = json.loads(resp.read() or b"{}")
            self._done(conn, resp)
        except Exception:
            conn.close()
            raise
        if status == 429:
            raise GatewayOverloaded(status, parsed)
        if status == 503:
            raise GatewayUnavailable(status, parsed)
        if status == 504:
            raise GatewayDeadline(status, parsed)
        if status != 200:
            raise GatewayError(status, parsed)
        return parsed

    # -- data plane ----------------------------------------------------------
    def generate(self, prompt, num_steps: int, temperature: float = 0.0,
                 seed: int | None = None, timeout_s: float | None = None,
                 stream: bool = False, on_token=None,
                 step_seeds=None, trace_id: str | None = None,
                 parent_span: str | None = None,
                 tenant: str | None = None,
                 adapter_id: str | None = None) -> dict:
        """One LM continuation. Returns the final reply dict (``tokens``
        plus the SLO numbers). ``stream=True`` reads the chunked NDJSON
        reply line by line, invoking ``on_token(index, token)`` as each
        arrives — the tokens list in the return value is assembled from
        the stream and identical to the non-streaming reply.
        ``step_seeds`` carries the ``num_steps`` per-step sampling seeds a
        caller already drew from its own generator (a process replica
        relaying an in-thread submission), so sampling is identical across
        the HTTP hop. ``trace_id`` rides the
        ``x-ddw-trace-id`` header — the server honors it (or mints one
        when tracing) and echoes it back in the reply. ``tenant`` names
        the quota/fair-share account this request bills to;
        ``adapter_id`` selects a hot-loaded LoRA adapter (absent = base
        model). A quota refusal comes back as the same 429 backoff shape
        as engine overload — the body names the tenant and resource."""
        body = {"prompt": [int(t) for t in prompt], "num_steps": num_steps,
                "temperature": temperature}
        if tenant is not None:
            body["tenant"] = tenant
        if adapter_id is not None:
            body["adapter_id"] = adapter_id
        if seed is not None:
            body["seed"] = seed
        if step_seeds is not None:
            body["step_seeds"] = [int(k) for k in step_seeds]
        if timeout_s is not None:
            body["timeout_s"] = timeout_s
        hdrs = {"x-ddw-trace-id": trace_id} if trace_id else None
        if parent_span:
            hdrs = dict(hdrs or {})
            hdrs["x-ddw-parent-span"] = parent_span
        if not stream:
            return self._json_call("POST", "/v1/generate", body,
                                   headers=hdrs)
        body["stream"] = True
        status, _headers, resp, conn = self._request(
            "POST", "/v1/generate", body, headers=hdrs)
        try:
            if status != 200:       # refused before the stream began
                parsed = json.loads(resp.read() or b"{}")
                if status == 429:
                    raise GatewayOverloaded(status, parsed)
                if status == 503:
                    raise GatewayUnavailable(status, parsed)
                if status == 504:
                    raise GatewayDeadline(status, parsed)
                raise GatewayError(status, parsed)
            tokens: list[int] = []
            final: dict = {}
            while True:
                line = resp.readline()   # http.client de-chunks for us
                if not line:
                    break
                row = json.loads(line)
                if "token" in row:
                    tokens.append(int(row["token"]))
                    if on_token is not None:
                        on_token(int(row["index"]), int(row["token"]))
                else:
                    final = row
                    break
            if "error" in final:     # mid-stream rejection rides the body
                raise GatewayError(200, final)
            final["tokens"] = tokens
            return final
        finally:
            conn.close()

    def predict(self, image, timeout_s: float | None = None,
                return_logits: bool = False) -> dict:
        body: dict = {"image": np_tolist(image)}
        if timeout_s is not None:
            body["timeout_s"] = timeout_s
        if return_logits:
            body["return_logits"] = True
        return self._json_call("POST", "/v1/predict", body)

    # -- batch lane ----------------------------------------------------------
    def submit_batch(self, items, kind: str = "generate",
                     num_steps: int | None = None, temperature: float = 0.0,
                     seed: int | None = None, window: int = 0) -> dict:
        """Submit a batch-lane job; returns ``{"job_id", "kind", "total"}``.
        The 429/503 backoff of :meth:`_request` applies to the submission
        itself; item-level retry lives server-side in the job's pump."""
        body: dict = {"kind": kind,
                      "items": [np_tolist(x) for x in items],
                      "temperature": temperature, "window": window}
        if num_steps is not None:
            body["num_steps"] = num_steps
        if seed is not None:
            body["seed"] = seed
        return self._json_call("POST", "/v1/batch", body)

    def batch_items(self, items, indices=None, kind: str = "generate",
                    num_steps: int | None = None, temperature: float = 0.0,
                    seed: int | None = None,
                    timeout_s: float | None = None) -> list[dict]:
        """Synchronous grouped submission (``POST /v1/batch/items``): the
        whole group runs on the ONE engine behind this gateway and the
        reply carries a per-row verdict — ``{"index", "ok": True, "row"}``
        or ``{"index", "ok": False, "error"}`` — so one refused item does
        not poison its groupmates. This is the wire form of the batch
        pump's per-replica grouping; ``indices`` are the caller's item
        indices (for rng folding and result placement), defaulting to
        ``0..n-1``."""
        body: dict = {"kind": kind,
                      "items": [np_tolist(x) for x in items],
                      "temperature": temperature}
        if indices is not None:
            body["indices"] = [int(i) for i in indices]
        if num_steps is not None:
            body["num_steps"] = num_steps
        if seed is not None:
            body["seed"] = seed
        if timeout_s is not None:
            body["timeout_s"] = timeout_s
        return self._json_call("POST", "/v1/batch/items", body)["rows"]

    def batch_status(self, job_id: str) -> dict:
        return self._json_call("GET", f"/v1/batch/{job_id}")

    def batch_cancel(self, job_id: str) -> dict:
        return self._json_call("DELETE", f"/v1/batch/{job_id}")

    def batch_results(self, job_id: str) -> list[dict]:
        """Completed rows (NDJSON body parsed), sorted by item index."""
        status, _h, resp, conn = self._request(
            "GET", f"/v1/batch/{job_id}/results")
        try:
            data = resp.read()
            self._done(conn, resp)
        except Exception:
            conn.close()
            raise
        if status != 200:
            raise GatewayError(status, json.loads(data or b"{}"))
        return [json.loads(line) for line in data.splitlines() if line]

    def batch_wait(self, job_id: str, timeout_s: float = 600.0,
                   poll_s: float = 0.25) -> dict:
        """Poll :meth:`batch_status` until the job is terminal; returns the
        final progress dict, raises ``TimeoutError`` otherwise."""
        deadline = time.monotonic() + timeout_s
        while True:
            st = self.batch_status(job_id)
            if st["state"] in ("done", "cancelled"):
                return st
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"batch job {job_id} not terminal after {timeout_s}s: "
                    f"{st}")
            time.sleep(poll_s)

    # -- control plane -------------------------------------------------------
    def healthz(self) -> dict:
        return self._json_call("GET", "/healthz")

    def deploy(self, model_dir: str, rollback: bool = True,
               strategy: str | None = None,
               canary_fraction: float | None = None,
               judge_window_s: float | None = None) -> dict:
        """Kick off a weight rollout (``POST /admin/deploy``). ``strategy``
        picks ``rolling`` (default) / ``canary`` / ``surge``;
        ``canary_fraction`` and ``judge_window_s`` tune the canary hold.
        Returns the initial deploy view; 409 (a rollout is already in
        flight) surfaces as :class:`GatewayError` with the live view in
        the body. Poll :meth:`stats` (the ``deploy`` block) for progress."""
        body: dict = {"model_dir": model_dir, "rollback": rollback}
        if strategy is not None:
            body["strategy"] = strategy
        if canary_fraction is not None:
            body["canary_fraction"] = canary_fraction
        if judge_window_s is not None:
            body["judge_window_s"] = judge_window_s
        return self._json_call("POST", "/admin/deploy", body)

    def adapters(self, op: str = "list", adapter_id: str | None = None,
                 path: str | None = None, alpha: float | None = None,
                 rank: int | None = None,
                 digest: str | None = None) -> dict:
        """Operate the fleet's LoRA adapter pool (``POST /admin/adapters``).
        ``op="load"`` stages the adapter at ``path`` onto every replica
        (shadow-probed, rolled back on any failure), ``op="unload"`` drops
        it fleet-wide, ``op="list"`` returns the per-replica residency
        view. 409 (a deploy holds the lock) surfaces as
        :class:`GatewayError` with the live deploy view in the body."""
        body: dict = {"op": op}
        if adapter_id is not None:
            body["adapter_id"] = adapter_id
        if path is not None:
            body["path"] = path
        if alpha is not None:
            body["alpha"] = alpha
        if rank is not None:
            body["rank"] = rank
        if digest is not None:
            body["digest"] = digest
        return self._json_call("POST", "/admin/adapters", body)

    def readyz(self) -> tuple[int, dict]:
        status, _h, resp, conn = self._request("GET", "/readyz",
                                               retry=False)
        try:
            body = json.loads(resp.read() or b"{}")
            self._done(conn, resp)
            return status, body
        except Exception:
            conn.close()
            raise

    def stats(self) -> dict:
        return self._json_call("GET", "/stats")

    def trace(self, replica: int | None = None, since: int = 0,
              chrome: bool = False) -> dict:
        """Fetch ``GET /v1/trace``: the merged fleet trace (default), the
        Perfetto-loadable Chrome form (``chrome=True``), or one replica's
        incremental relay feed (``replica=R, since=N`` — what a parent
        gateway polls on a child's gateway)."""
        if replica is not None:
            return self._json_call(
                "GET", f"/v1/trace?replica={replica}&since={since}")
        path = "/v1/trace?format=chrome" if chrome else "/v1/trace"
        return self._json_call("GET", path)

    def telemetry(self, replica: int | None = None, since: int = 0) -> dict:
        """Fetch ``GET /v1/telemetry``: the fleet's merged windowed
        aggregates + SLO status (default), or one replica's incremental
        sample feed (``replica=R, since=N`` — what a parent gateway's
        fleet store polls on a child's gateway)."""
        if replica is not None:
            return self._json_call(
                "GET", f"/v1/telemetry?replica={replica}&since={since}")
        return self._json_call("GET", "/v1/telemetry")

    def metrics_text(self) -> str:
        status, _h, resp, conn = self._request("GET", "/metrics")
        try:
            data = resp.read().decode()
            self._done(conn, resp)
        except Exception:
            conn.close()
            raise
        if status != 200:
            raise GatewayError(status, {"body": data})
        return data

    def wait_ready(self, timeout_s: float = 30.0) -> bool:
        """Poll ``/readyz`` until 200 (True) or the timeout (False) —
        what a load balancer health check does, for tests and tools."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                status, _ = self.readyz()
                if status == 200:
                    return True
            except OSError:
                pass                 # listener not even up yet
            time.sleep(0.02)
        return False


def np_tolist(image):
    """Accept a numpy array or nested lists for the predict payload."""
    return image.tolist() if hasattr(image, "tolist") else image
