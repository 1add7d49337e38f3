"""Online serving engine — continuous-batching inference (the port of
``ddw_tpu.serve``)."""

from ddw_tpu_torch.serve.admission import (  # noqa: F401
    AdmissionController,
    DeadlineExceeded,
    Overloaded,
    Rejected,
    ReplicaFailed,
    Unavailable,
)
from ddw_tpu_torch.serve.bucketing import (  # noqa: F401
    batch_bucket,
    bucket_len,
    length_buckets,
    pad_to_bucket,
)
from ddw_tpu_torch.serve.engine import (  # noqa: F401
    ALIVE,
    DEGRADED,
    FAILED,
    EngineCfg,
    GenerateResult,
    PredictResult,
    ServingEngine,
)
from ddw_tpu_torch.serve.lanes import (  # noqa: F401
    BatchJob,
    JobLedger,
    start_batch_job,
)
from ddw_tpu_torch.serve.metrics import (  # noqa: F401
    LATENCY_BUCKETS_MS,
    EngineMetrics,
    RequestRecord,
    render_prometheus,
)
from ddw_tpu_torch.serve.adapters import (  # noqa: F401
    AdapterDigestMismatch,
    AdapterError,
    AdapterPool,
    AdapterPoolFull,
    UnknownAdapter,
    load_adapter,
    save_adapter,
)
from ddw_tpu_torch.serve.blocks import BlockPool  # noqa: F401
from ddw_tpu_torch.serve.slots import SlotPool  # noqa: F401
from ddw_tpu_torch.serve.tenancy import (  # noqa: F401
    QuotaExceeded,
    TenancyController,
    TenantAwareAdmission,
    TenantSpec,
    tenant_objectives,
)
