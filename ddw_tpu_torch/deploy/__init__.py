"""Process-isolated serving fleet + zero-downtime weight rollouts.

Five pieces, layered on the gateway's existing replica contracts:

- :class:`ProcessReplica` — an :class:`~ddw_tpu_torch.serve.ServingEngine` living
  in its own OS process (``_serve_worker`` child), driven over a keep-alive
  HTTP client but presenting the SAME duck-typed EngineReplica surface the
  in-thread engine does, so :class:`~ddw_tpu_torch.gateway.ReplicaSet` routes to
  both transparently and :class:`~ddw_tpu_torch.gateway.ReplicaSupervisor`
  restarts both through the one backoff/half-open/shadow-probe path.
- :mod:`~ddw_tpu_torch.deploy._serve_worker` — the child entrypoint (one engine,
  one single-replica gateway, port-file handshake, SIGTERM → drain).
- :class:`DeployController` — strategy-aware weight rollout under live
  traffic: ``rolling`` (drain → restart on the new checkpoint →
  warmup-gate → shadow-probe rejoin → advance, abort-and-rollback on a
  failed step), ``canary`` (roll one replica, hold it at a traffic
  fraction, judge it, promote or reject), ``surge`` (spawn the new
  generation before draining the old — capacity never dips).
- :class:`CanaryJudge` — compares the canary's SLO tails + error counters
  to the rest-of-fleet baseline (active probes + the per-replica
  telemetry relay) and returns the promote/reject verdict forensics.
- :class:`RolloutJournal` — the fsync'd per-step rollout record (JobLedger
  discipline) that :func:`resume_rollout` replays on gateway restart so a
  half-rolled fleet always converges to one digest.

The port of ``ddw_tpu.deploy``: the same host logic,
importing nothing of ``ddw_tpu``.
"""

from ddw_tpu_torch.deploy.canary import CanaryJudge
from ddw_tpu_torch.deploy.controller import (DeployController, DeployStep,
                                             resume_rollout)
from ddw_tpu_torch.deploy.journal import RolloutJournal
from ddw_tpu_torch.deploy.process_replica import ProcessReplica

__all__ = ["DeployController", "DeployStep", "ProcessReplica",
           "CanaryJudge", "RolloutJournal", "resume_rollout"]
