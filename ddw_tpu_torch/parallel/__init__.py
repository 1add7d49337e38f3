from ddw_tpu_torch.parallel.ring_attention import ring_attention  # noqa: F401
from ddw_tpu_torch.parallel.zero import (  # noqa: F401
    make_fsdp_train_chain,
    make_fsdp_train_step,
    make_zero_train_chain,
    make_zero_train_step,
)
from ddw_tpu_torch.parallel.sharding import (  # noqa: F401
    PartitionRules,
    VIT_TP_RULES,
    shardings_for_params,
    make_sharded_train_step,
)
