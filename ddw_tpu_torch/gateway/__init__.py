"""HTTP serving gateway — the network front door over engine replicas.

Layering (docs/serving.md "The HTTP gateway"):

- :mod:`~ddw_tpu_torch.gateway.http` — ``Gateway``: stdlib ThreadingHTTPServer
  JSON API with chunked per-token streaming, keep-alive with a bounded
  connection guard, 429/503/504 mapping from the engine's structured
  refusals;
- :mod:`~ddw_tpu_torch.gateway.replica` — ``ReplicaSet``: admission- and
  cache-aware routing across N engine replicas behind per-replica circuit
  breakers, one sideways retry on a full queue, failover of a dead
  replica's queued work, fleet-merged metrics;
- :mod:`~ddw_tpu_torch.gateway.prefix_index` — ``PrefixIndex``: fleet-wide
  content-hash map of which replica holds which prompt prefix warm, fed
  by the pools' register/evict event logs; drives cache-aware routing and
  the supervisor's warm replay after recycle/deploy;
- :mod:`~ddw_tpu_torch.gateway.supervisor` — ``ReplicaSupervisor``: bounded
  auto-restart of failed/stalled replicas with warmup-gated rejoin;
- :mod:`~ddw_tpu_torch.gateway.lifecycle` — ``ServerLifecycle``: readiness gated
  on warmup (and on having live replicas), SIGTERM drain within the
  runtime layer's grace window;
- :mod:`~ddw_tpu_torch.gateway.client` — ``GatewayClient``: reference client
  whose backoff honors ``Retry-After`` and reuses keep-alive connections.

The port of ``ddw_tpu.gateway``: the same host logic,
importing nothing of ``ddw_tpu``.
"""

from ddw_tpu_torch.gateway.client import (  # noqa: F401
    GatewayClient,
    GatewayDeadline,
    GatewayError,
    GatewayOverloaded,
    GatewayUnavailable,
)
from ddw_tpu_torch.gateway.http import Gateway  # noqa: F401
from ddw_tpu_torch.gateway.lifecycle import (  # noqa: F401
    DRAINING,
    READY,
    STARTING,
    STOPPED,
    ServerLifecycle,
    runtime_grace_s,
)
from ddw_tpu_torch.gateway.prefix_index import (  # noqa: F401
    PrefixIndex,
    chain_hash_hexes,
)
from ddw_tpu_torch.gateway.replica import (  # noqa: F401
    CIRCUIT_CLOSED,
    CIRCUIT_HALF_OPEN,
    CIRCUIT_OPEN,
    CircuitBreaker,
    ReplicaSet,
)
from ddw_tpu_torch.gateway.supervisor import (  # noqa: F401
    ReplicaAttempt,
    ReplicaSupervisor,
)
