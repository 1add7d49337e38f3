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
