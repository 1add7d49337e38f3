"""Observability — the port of ``ddw_tpu.obs``: tracing, the flight
recorder, and the live telemetry plane.

One :class:`~ddw_tpu_torch.obs.trace.Tracer` per component (a serving
engine, a trainer) appends finished spans into a bounded drop-oldest ring;
exporters render them as a Perfetto-loadable Chrome trace or NDJSON. A
:class:`~ddw_tpu_torch.obs.telemetry.TelemetryHub` samples counters,
gauges and latency observations into windowed time series, which the
:class:`~ddw_tpu_torch.obs.slo.SLOMonitor` evaluates into error budgets,
burn-rate alerts and degradation forensics dumps.
"""

from ddw_tpu_torch.obs.slo import (  # noqa: F401
    SLOMonitor,
    SLOObjective,
)
from ddw_tpu_torch.obs.telemetry import (  # noqa: F401
    FleetTelemetry,
    TelemetryHub,
    merge_feeds,
    signal_registry,
    tee_run,
)
from ddw_tpu_torch.obs.trace import (  # noqa: F401
    Tracer,
    chrome_trace,
    gen_id,
    load_events,
    to_ndjson,
)

__all__ = ["Tracer", "chrome_trace", "gen_id", "load_events", "to_ndjson",
           "TelemetryHub", "FleetTelemetry", "merge_feeds",
           "signal_registry", "tee_run", "SLOMonitor", "SLOObjective"]
