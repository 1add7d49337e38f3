"""95th percentile of client submit to first token over the window's
requests, failures counted with their whole wait. In the closed loop the
engine's rows are all taken, and a window holds some tens of requests: a
tail to watch, not to bound."""


def read(run):
    return run.e2e.get("ttft_p95_ms")
