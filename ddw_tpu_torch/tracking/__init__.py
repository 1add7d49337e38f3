from ddw_tpu_torch.tracking.tracker import Tracker, Run  # noqa: F401
from ddw_tpu_torch.tracking.registry import ModelRegistry  # noqa: F401
