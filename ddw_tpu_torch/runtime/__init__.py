from ddw_tpu_torch.runtime.mesh import (  # noqa: F401
    HybridMeshSpec,
    Mesh,
    bind_mesh,
    device_slice_index,
    MeshSpec,
    make_data_mesh,
    make_hybrid_mesh,
    make_mesh,
    initialize_distributed,
    process_index,
    process_count,
    is_coordinator,
    local_device_count,
    global_device_count,
)
from ddw_tpu_torch.runtime.collectives import (  # noqa: F401
    all_reduce_mean,
    all_reduce_sum,
    broadcast_from,
    all_gather_axis,
    host_all_reduce,
    ring_all_reduce,
)
from ddw_tpu_torch.runtime.launcher import (  # noqa: F401
    ElasticEvent,
    GangError,
    Launcher,
)
from ddw_tpu_torch.runtime.elastic import (  # noqa: F401
    ElasticRestart,
    GangRendezvous,
    elastic_barrier,
    elastic_enabled,
    maybe_elastic_restart,
)
from ddw_tpu_torch.runtime.faults import (  # noqa: F401
    FaultInjected,
    Preempted,
    install_preemption_handler,
    maybe_fault,
    preemption_requested,
    request_preemption,
    reset_preemption,
)
from ddw_tpu_torch.runtime.supervisor import (  # noqa: F401
    AttemptReport,
    GangFailure,
    GangSupervisor,
    restart_generation,
)
