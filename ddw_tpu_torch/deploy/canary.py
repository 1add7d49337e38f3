"""CanaryJudge — compares a canary replica's SLO tails to the rest of the
fleet and returns a promote/reject verdict.

A canary deploy (:class:`~ddw_tpu_torch.deploy.DeployController` with
``strategy="canary"``) rolls ONE replica to the new checkpoint and holds it
at a traffic fraction (weighted routing in
:class:`~ddw_tpu_torch.gateway.ReplicaSet`). This judge then spends the judgment
window measuring that replica against the rest-of-fleet baseline through
two channels:

- **Active probes** — each tick the judge issues one identical tiny request
  directly against the canary and against a rotating baseline replica
  (``probe()`` for process replicas — one real request through the child's
  own HTTP door — or ``submit_generate`` for in-thread engines, the same
  surfaces the supervisor's shadow probe uses) and records the measured
  wall-clock latency. Probes work even at ``canary_fraction=0`` (a *dark*
  canary taking no client traffic at all) and cost one tiny generate per
  tick per side.
- **The per-replica telemetry relay** — when replicas expose
  ``telemetry_events`` (process replicas relaying their child's engine
  samples), the judge drains each feed and folds the windowed
  ``serve.ttft_ms`` / ``serve.total_ms`` dist observations into per-side
  tail estimates over the shared histogram ladder
  (:data:`~ddw_tpu_torch.obs.telemetry.DIST_BUCKETS`). These reflect REAL client
  traffic, so when both sides have enough relayed samples they are compared
  with the same ratio rule as the probes.

Verdict math (each evaluation tick, once both sides hold ``min_samples``):

- ``reject`` if the canary accumulated more probe/availability errors than
  the baseline (availability breaks beat latency math);
- ``reject`` if canary p99 > ``reject_ratio`` * max(baseline p99,
  ``min_floor_ms``) on either channel — the floor keeps a 2 ms vs 5 ms
  difference on an idle fleet from rejecting a healthy checkpoint;
- otherwise ``promote`` when the window closes.

``DDW_FAULT=deploy:degrade_canary`` hooks the canary-probe site: the spec's
``ttft_ms`` is injected as real latency into each judge probe against the
canary (the probe IS a request to that replica) and ``errors`` synthetic
probe failures are charged — a deterministic reject with zero client
impact, because the perturbation lives where the measurement lives.

The verdict dict doubles as the structured forensics surfaced in
``deploy_view`` (and tailed by ``tools/rolling_deploy.py``): per-side
sample counts, probe percentiles, relay tails per source, error counts,
and a timestamped verdict timeline.

The port of ``ddw_tpu.deploy.canary``: the same host logic,
importing nothing of ``ddw_tpu``.
"""

from __future__ import annotations

import time

from ddw_tpu_torch.obs.telemetry import (DIST_BUCKETS, bucket_counts,
                                         bucket_quantile)
from ddw_tpu_torch.runtime.faults import maybe_deploy_fault

__all__ = ["CanaryJudge"]

_RELAY_NAMES = ("serve.ttft_ms", "serve.total_ms")


def _p(values, q: float) -> float:
    """Tail estimate over the shared dist ladder (consistent with every
    other percentile the telemetry plane reports). ``q`` is a fraction
    (0.99); bucket_quantile wants percent."""
    if not values:
        return 0.0
    return bucket_quantile(bucket_counts(values, DIST_BUCKETS), q * 100.0,
                           DIST_BUCKETS)


class CanaryJudge:
    """Judge one canary replica against the rest of the fleet over a
    judgment window. ``run()`` blocks for at most ``window_s`` (less on an
    early reject) and returns the verdict dict."""

    def __init__(self, replica_set, canary: int, window_s: float = 5.0,
                 probe_interval_s: float = 0.25, reject_ratio: float = 2.0,
                 min_floor_ms: float = 50.0, min_samples: int = 3,
                 probe_prompt=(1, 2, 3, 4), probe_steps: int = 1,
                 probe_timeout_s: float = 30.0, publish=None):
        self.rs = replica_set
        self.canary = canary
        self.window_s = window_s
        self.probe_interval_s = probe_interval_s
        self.reject_ratio = reject_ratio
        self.min_floor_ms = min_floor_ms
        self.min_samples = min_samples
        self.probe_prompt = list(probe_prompt)
        self.probe_steps = probe_steps
        self.probe_timeout_s = probe_timeout_s
        self.publish = publish      # callback(dict): live view for /stats
        self._t0 = 0.0
        self._timeline: list[dict] = []
        # measurement state
        self._probe_ms = {"canary": [], "baseline": []}
        self._errors = {"canary": 0, "baseline": 0}
        self._probe_n = 0
        self._err_injected = 0
        self._relay_since: dict[int, int] = {}
        self._relay: dict[str, dict[str, list[float]]] = {}
        self._baseline_rr = 0

    # -- measurement ---------------------------------------------------------
    def _mark(self, event: str, detail: str = "") -> None:
        self._timeline.append(
            {"t": round(time.monotonic() - self._t0, 3),
             "event": event, **({"detail": detail} if detail else {})})

    def _probe(self, i: int, side: str) -> None:
        eng = self.rs.replicas[i]
        spec = None
        if side == "canary":
            spec = maybe_deploy_fault("judge", replica=i, n=self._probe_n)
        if (spec is not None and spec.errors
                and self._err_injected < spec.errors):
            self._err_injected += 1
            self._errors[side] += 1
            self._mark("probe_error", f"replica {i}: injected")
            return
        t0 = time.monotonic()
        try:
            if hasattr(eng, "probe"):
                eng.probe(timeout_s=self.probe_timeout_s)
            else:
                eng.submit_generate(
                    self.probe_prompt, self.probe_steps, temperature=0.0,
                    timeout_s=self.probe_timeout_s).result(
                        self.probe_timeout_s)
        except Exception as e:
            self._errors[side] += 1
            self._mark("probe_error", f"replica {i}: {e!r}"[:120])
            return
        if spec is not None and spec.ttft_ms > 0:
            # injected latency ON the canary's probe path — measured below
            # exactly as a slow checkpoint's real latency would be
            time.sleep(spec.ttft_ms / 1e3)
        self._probe_ms[side].append((time.monotonic() - t0) * 1e3)

    def _baseline_indices(self) -> list[int]:
        return [i for i in range(len(self.rs.replicas)) if i != self.canary]

    def _drain_relay(self) -> None:
        for i in range(len(self.rs.replicas)):
            eng = self.rs.replicas[i]
            if not hasattr(eng, "telemetry_events"):
                continue
            try:
                events = eng.telemetry_events(self._relay_since.get(i, 0))
            except Exception:
                continue
            if isinstance(events, dict):    # the relay duck-type wraps the
                events = events.get("samples", ())  # samples in an envelope

            src = f"replica{i}"
            for s in events:
                self._relay_since[i] = max(self._relay_since.get(i, 0),
                                           int(s.get("seq", 0)))
                if s.get("kind") != "dist" or s.get("name") not in \
                        _RELAY_NAMES:
                    continue
                self._relay.setdefault(src, {}).setdefault(
                    s["name"], []).append(float(s["value"]))

    def _relay_side(self, name: str, side: str) -> list[float]:
        srcs = ([f"replica{self.canary}"] if side == "canary" else
                [f"replica{i}" for i in self._baseline_indices()])
        out: list[float] = []
        for src in srcs:
            out.extend(self._relay.get(src, {}).get(name, ()))
        return out

    # -- verdict -------------------------------------------------------------
    def _worse(self, canary_ms: float, baseline_ms: float) -> bool:
        return canary_ms > self.reject_ratio * max(baseline_ms,
                                                   self.min_floor_ms)

    def _evaluate(self) -> str | None:
        """Reject reason, or None (keep judging)."""
        if self._errors["canary"] > self._errors["baseline"]:
            return "canary_errors"
        c, b = self._probe_ms["canary"], self._probe_ms["baseline"]
        if (len(c) >= self.min_samples and len(b) >= self.min_samples
                and self._worse(_p(c, 0.99), _p(b, 0.99))):
            return "canary_probe_p99"
        for name in _RELAY_NAMES:
            rc = self._relay_side(name, "canary")
            rb = self._relay_side(name, "baseline")
            if (len(rc) >= self.min_samples and len(rb) >= self.min_samples
                    and self._worse(_p(rc, 0.99), _p(rb, 0.99))):
                return f"relay_{name.split('.', 1)[1]}_p99"
        return None

    def view(self, verdict: str = "judging", reason: str = "") -> dict:
        c, b = self._probe_ms["canary"], self._probe_ms["baseline"]
        relay_tails = {
            src: {name: round(_p(vals, 0.99), 3)
                  for name, vals in by_name.items()}
            for src, by_name in self._relay.items()}
        return {
            "verdict": verdict, "reason": reason,
            "window_s": self.window_s, "replica": self.canary,
            "samples": {"canary": len(c), "baseline": len(b)},
            "canary": {"p50_ms": round(_p(c, 0.50), 3),
                       "p99_ms": round(_p(c, 0.99), 3),
                       "errors": self._errors["canary"]},
            "baseline": {"p50_ms": round(_p(b, 0.50), 3),
                         "p99_ms": round(_p(b, 0.99), 3),
                         "errors": self._errors["baseline"],
                         "replicas": self._baseline_indices()},
            "relay_tails": relay_tails,
            "timeline": list(self._timeline),
        }

    def run(self) -> dict:
        """Judge until the window closes (promote) or a reject condition
        lands (early). Returns the verdict dict (also the forensics)."""
        self._t0 = time.monotonic()
        deadline = self._t0 + self.window_s
        self._mark("window_open",
                   f"canary replica {self.canary}, {self.window_s:g}s")
        verdict, reason = "promote", "window_elapsed"
        while True:
            self._probe(self.canary, "canary")
            baseline = self._baseline_indices()
            if baseline:
                self._probe(baseline[self._baseline_rr % len(baseline)],
                            "baseline")
                self._baseline_rr += 1
            self._probe_n += 1
            self._drain_relay()
            why = self._evaluate()
            if why is not None:
                verdict, reason = "reject", why
                break
            if self.publish is not None:
                self.publish(self.view())
            if time.monotonic() >= deadline:
                break
            time.sleep(max(0.0, min(self.probe_interval_s,
                                    deadline - time.monotonic())))
        self._mark("verdict", f"{verdict} ({reason})")
        out = self.view(verdict, reason)
        if self.publish is not None:
            self.publish(out)
        return out
