"""Traffic-driven fleet autoscaling: a reconciler loop closed over the
telemetry plane.

:mod:`~ddw_tpu_torch.autoscale.policy` is the pure math — the 10s/60s telemetry
windows (SLO burn, queue depth, TTFT, block-pool occupancy) reduced to ONE
desired replica count with hysteresis, per-direction cooldowns, and
min/max bounds. :mod:`~ddw_tpu_torch.autoscale.controller` is the actuator the
gateway runs: surge-style scale-out (warm + shadow-probe before
admission), drain-first scale-in, fsync'd scale journals, and mutual
exclusion with rolling deploys through the gateway's deploy lock. Remote
children ride :mod:`ddw_tpu_torch.deploy.transport`.

The port of ``ddw_tpu.autoscale``: the same host logic,
importing nothing of ``ddw_tpu``.
"""

from ddw_tpu_torch.autoscale.controller import AutoscaleController
from ddw_tpu_torch.autoscale.policy import (PolicyInputs, ScaleDecision,
                                            ScalePolicy, inputs_from_windows,
                                            max_burn)

__all__ = ["AutoscaleController", "PolicyInputs", "ScaleDecision",
           "ScalePolicy", "inputs_from_windows", "max_burn"]
